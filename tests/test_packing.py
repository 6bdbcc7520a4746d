"""Packed-batch correctness: packing preserves window contents, and towers
with `starts` resets produce exactly the per-window states of unpacked runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbr_rs_tpu import data as D
from sbr_rs_tpu.models import Loss, Optimizer, ewma, lstm
from sbr_rs_tpu.models.towers import ewma_apply, init_ewma, init_lstm, lstm_apply


def _padded(seed=0, n_users=40, n_items=60, T=16):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, 40, n_users)
    users = np.repeat(np.arange(n_users), lengths)
    inter = D.Interactions.from_arrays(
        users,
        rng.integers(0, n_items, len(users)),
        np.concatenate([np.arange(l) for l in lengths]),
        n_users,
        n_items,
    ).to_compressed()
    return D.extract_padded_windows(inter, T), T


def test_pack_preserves_contents_and_counts():
    padded, T = _padded()
    packed = D.pack_streams(padded, T)
    assert packed.num_examples == padded.num_examples
    assert len(packed) <= len(padded)
    assert packed.starts is not None
    # Per-row: number of window starts == number of windows packed there;
    # mask is the union of the packed windows' supervised spans.
    assert packed.starts.sum() == float(len(padded))
    np.testing.assert_array_equal(packed.mask.sum(1), packed.lengths)

    # Every (input, target) supervised pair appears exactly as often as in
    # the padded layout (stream layout: input = stream[t], target =
    # stream[t+1] at supervised positions).
    def stream_pairs(w):
        m = w.mask > 0
        return sorted(
            zip(w.stream[:, :-1][m].tolist(), w.stream[:, 1:][m].tolist())
        )

    def padded_pairs(w):
        m = w.mask > 0
        return sorted(zip(w.inputs[m].tolist(), w.targets[m].tolist()))

    assert stream_pairs(packed) == padded_pairs(padded)
    # No row overflows the T+1 slot capacity.
    assert packed.stream.shape[1] == T + 1
    assert packed.mask.shape[1] == T


def test_to_streams_matches_padded_pairs():
    padded, T = _padded(seed=3)
    sw = D.to_streams(padded)
    assert sw.stream.shape == (len(padded), T + 1)
    assert sw.num_examples == padded.num_examples
    m = sw.mask > 0
    np.testing.assert_array_equal(sw.stream[:, :-1][m], padded.inputs[padded.mask > 0])
    np.testing.assert_array_equal(sw.stream[:, 1:][m], padded.targets[padded.mask > 0])


@pytest.mark.parametrize("tower", ["ewma", "lstm_normal", "lstm_coupled"])
def test_starts_resets_match_unpacked(tower):
    """Running two windows packed in one row == running them separately."""
    d = 16
    key = jax.random.PRNGKey(0)
    if tower == "ewma":
        params = init_ewma(key, d)
        params["alpha"] = jnp.asarray(np.random.default_rng(0).normal(size=d), jnp.float32)
        apply = lambda p, x, s=None: ewma_apply(p, x, starts=s)
    else:
        coupled = tower == "lstm_coupled"
        params = init_lstm(key, d, coupled)
        apply = lambda p, x, s=None: lstm_apply(p, x, coupled=coupled, starts=s)

    rng = np.random.default_rng(1)
    w1 = jnp.asarray(rng.normal(size=(1, 5, d)), jnp.float32)
    w2 = jnp.asarray(rng.normal(size=(1, 7, d)), jnp.float32)

    sep1 = apply(params, w1)
    sep2 = apply(params, w2)

    packed_x = jnp.concatenate([w1, w2], axis=1)  # [1, 12, d]
    starts = np.zeros((1, 12), np.float32)
    starts[0, 0] = 1.0
    starts[0, 5] = 1.0
    got = apply(params, packed_x, jnp.asarray(starts))

    np.testing.assert_allclose(np.asarray(got[:, :5]), np.asarray(sep1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got[:, 5:]), np.asarray(sep2), atol=1e-6)


def test_packed_fit_runs_and_learns():
    padded, T = _padded()
    rng = np.random.default_rng(0)
    users = np.repeat(np.arange(50), 12)
    items = (np.tile(np.arange(12), 50) + rng.integers(0, 5, 600)) % 30
    inter = D.Interactions.from_arrays(users, items, np.tile(np.arange(12), 50), 50, 30)
    mat = inter.to_compressed()
    for family in (ewma, lstm):
        model = (
            family.Hyperparameters(30, 8)
            .learning_rate(0.1)
            .loss(Loss.HINGE)
            .optimizer(Optimizer.ADAGRAD)
            .num_epochs(2)
            .batch_size(16)
            .packed(True)
            .from_seed(0)
            .build()
        )
        loss = model.fit(mat)
        assert np.isfinite(loss)


def test_pallas_packed_matches_scan():
    import functools

    from sbr_rs_tpu.ops import pallas_lstm

    lstm_apply_pallas = functools.partial(pallas_lstm.lstm_apply_pallas, interpret=True)

    d = 16
    params = init_lstm(jax.random.PRNGKey(0), d, False)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 10, d))
    starts = np.zeros((4, 10), np.float32)
    starts[:, 0] = 1.0
    starts[1, 4] = 1.0
    starts[2, 7] = 1.0
    starts = jnp.asarray(starts)
    want = lstm_apply(params, x, coupled=False, starts=starts)
    got = lstm_apply_pallas(params, x, coupled=False, starts=starts)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)

    def loss_scan(p):
        return jnp.sum(lstm_apply(p, x, coupled=False, starts=starts) ** 2)

    def loss_pallas(p):
        return jnp.sum(lstm_apply_pallas(p, x, coupled=False, starts=starts) ** 2)

    want_g = jax.grad(loss_scan)(params)
    got_g = jax.grad(loss_pallas)(params)
    for g, w in zip(jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


def test_pack_skips_zero_length_windows():
    """Windows with zero supervised steps must not be packed (regression:
    a start marker was written past a full bin's edge)."""
    T = 4
    padded = D.pad_windows([np.array([1, 2, 3, 4, 5]), np.array([7])], T)
    assert list(padded.lengths) == [4, 0]
    packed = D.pack_streams(padded, T)
    assert packed.num_examples == 4
    assert float(packed.starts.sum()) == 1.0  # only the real window starts
    # The 5-item window fills the whole T+1 = 5 slot stream.
    np.testing.assert_array_equal(packed.stream, [[1, 2, 3, 4, 5]])


def test_ewma_zero_starts_matches_none():
    """All-zero starts must behave like starts=None (window begins at t=0)."""
    import jax
    import jax.numpy as jnp

    from sbr_rs_tpu.models.towers import ewma_apply, init_ewma

    params = init_ewma(jax.random.PRNGKey(0), 8)
    params["alpha"] = jnp.asarray(np.random.default_rng(0).normal(size=8), jnp.float32)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 6, 8)), jnp.float32)
    a = ewma_apply(params, x)
    b = ewma_apply(params, x, starts=jnp.zeros((2, 6), jnp.float32))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
