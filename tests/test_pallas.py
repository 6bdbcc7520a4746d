"""LSTM recurrence kernel (:mod:`sbr_rs_tpu.ops.pallas_lstm`) against the
``lax.scan`` tower, in the Pallas interpreter on CPU; and the choice of
tower."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbr_rs_tpu.models import lstm
from sbr_rs_tpu.models.towers import init_lstm, lstm_apply
from sbr_rs_tpu.ops import pallas_lstm
from sbr_rs_tpu.ops.pallas_lstm import lstm_apply_pallas

kernel = functools.partial(lstm_apply_pallas, interpret=True)


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize(
    "shape",
    # (B, T, D); D=8 and D=27 run at the padded widths 16 and 32
    [(4, 5, 32), (24, 17, 32), (9, 3, 16), (5, 4, 8), (3, 6, 27)],
)
def test_lstm_pallas_forward_matches_scan(coupled, shape):
    params = init_lstm(jax.random.PRNGKey(0), shape[2], coupled)
    x = jax.random.normal(jax.random.PRNGKey(1), shape)
    want = lstm_apply(params, x, coupled=coupled)
    got = kernel(params, x, coupled=coupled)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("coupled", [False, True])
def test_lstm_pallas_grad_matches_scan(coupled):
    _check_grad(coupled, 16)


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("d", [8, 27])
def test_lstm_pallas_grad_padded_widths(coupled, d):
    # D=8 and D=27 run at the padded widths 16 and 32
    _check_grad(coupled, d)


def _check_grad(coupled, d):
    params = init_lstm(jax.random.PRNGKey(0), d, coupled)
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 7, d))

    def loss_scan(p, xx):
        return jnp.sum(lstm_apply(p, xx, coupled=coupled) ** 2)

    def loss_pallas(p, xx):
        return jnp.sum(kernel(p, xx, coupled=coupled) ** 2)

    want = jax.grad(loss_scan, argnums=(0, 1))(params, x)
    got = jax.grad(loss_pallas, argnums=(0, 1))(params, x)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("d,dp", [(8, 16), (16, 16), (17, 32), (32, 32), (127, 128)])
def test_padded_width(d, dp):
    assert pallas_lstm.padded_width(d) == dp
    assert pallas_lstm.kernel_pays(d) is (dp <= pallas_lstm.MAX_KERNEL_WIDTH)


@pytest.mark.parametrize("d", [33, 127])
def test_wide_hidden_refused(d):
    """Above the widest width the kernel runs, it refuses instead of
    running the slow (or, at 128, uncompilable) configuration."""
    params = init_lstm(jax.random.PRNGKey(0), d, False)
    with pytest.raises(ValueError, match="lax.scan"):
        kernel(params, jnp.zeros((2, 3, d)), coupled=False)


@pytest.mark.parametrize(
    "backend,dim,on_mesh,want",
    [
        ("gpu", 32, False, True),
        ("gpu", 8, False, True),
        ("gpu", 128, False, False),  # the kernel runs only at small widths
        ("cpu", 32, False, False),
        ("gpu", 32, True, False),  # a mesh runs the scan tower
        ("gpu", 8, True, False),
    ],
)
def test_kernel_choice(monkeypatch, backend, dim, on_mesh, want):
    from sbr_rs_tpu.parallel import make_mesh

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    hp = lstm.Hyperparameters(50, 8).embedding_dim(dim)
    if on_mesh:
        hp = hp.mesh(make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    model = hp.build()
    assert model._pallas_enabled() is want
    tower = model._tower_fn()
    assert (tower.func is lstm_apply_pallas) is want


@pytest.mark.gpu
@pytest.mark.parametrize("coupled", [False, True])
def test_kernel_compiled_for_gpu_matches_scan(coupled):
    """The kernels as Triton compiles them for the card (no interpreter),
    forward and gradient, against the scan at full float32."""
    params = init_lstm(jax.random.PRNGKey(0), 32, coupled)
    x = jax.random.normal(jax.random.PRNGKey(1), (256, 32, 32))
    starts = (jax.random.uniform(jax.random.PRNGKey(2), (256, 32)) < 0.1).astype(jnp.float32)

    def loss(f):
        return lambda p, xx: jnp.sum(f(p, xx, coupled=coupled, starts=starts) ** 2)

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss(lstm_apply), argnums=(0, 1)))(params, x)
        got = jax.jit(jax.grad(loss(lstm_apply_pallas), argnums=(0, 1)))(params, x)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        scale = float(np.max(np.abs(np.asarray(w))))
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4 * scale)
