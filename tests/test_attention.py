"""Causal self-attention tower + model tests.

The attention model is an extension (no reference counterpart);
these tests pin the contracts it must share with the recurrent towers:
causality (state at t sees only items <= t), packed-window equivalence
(block-diagonal masking + position restarts == separate rows), and the
standard model surface (fit improves, serving, checkpoint round-trip).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sbr_rs_tpu as sbr
from sbr_rs_tpu import data as D
from sbr_rs_tpu.models import Loss, Optimizer, attention
from sbr_rs_tpu.models.towers import attention_apply, init_attention


def _toy_interactions(num_users=60, num_items=40, seq_len=12, seed=0):
    rng = np.random.default_rng(seed)
    users, items, ts = [], [], []
    for u in range(num_users):
        start = rng.integers(0, num_items)
        step = 1 + (u % 3)
        for t in range(seq_len):
            users.append(u)
            items.append((start + t * step) % num_items)
            ts.append(t)
    return D.Interactions.from_arrays(np.array(users), np.array(items), np.array(ts))


def _tower_params(dim=8, max_len=16, num_layers=2, num_heads=2, seed=0):
    return init_attention(
        jax.random.PRNGKey(seed), dim, max_len, num_layers=num_layers, num_heads=num_heads
    )


def test_matches_numpy_reference():
    """Golden check: the tower's output equals an independent numpy
    implementation of the same formula (pre-LN blocks, scaled causal
    softmax attention, relu FFN, final LN) on small shapes."""
    dim, heads = 8, 2
    params = _tower_params(dim=dim, max_len=16, num_layers=2, num_heads=heads, seed=9)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(10), (2, 5, dim)), np.float64)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)

    def ln(q, v):
        mu = v.mean(-1, keepdims=True)
        var = ((v - mu) ** 2).mean(-1, keepdims=True)
        return (v - mu) / np.sqrt(var + 1e-6) * q["scale"] + q["bias"]

    b_, t_, d = x.shape
    hd = d // heads
    h = x + p["pos"][np.arange(t_)]
    for layer in p["layers"]:
        a_in = ln(layer["ln1"], h)
        qkv = (a_in @ layer["w_qkv"]).reshape(b_, t_, 3, heads, hd)
        out = np.zeros_like(h)
        for b in range(b_):
            for hh in range(heads):
                q, k, v = (qkv[b, :, i, hh] for i in range(3))
                logits = q @ k.T / np.sqrt(hd)
                logits[np.triu_indices(t_, 1)] = -1e9
                w = np.exp(logits - logits.max(-1, keepdims=True))
                w /= w.sum(-1, keepdims=True)
                out[b, :, hh * hd : (hh + 1) * hd] = w @ v
        h = h + (out.reshape(b_ * t_, d) @ layer["w_o"]).reshape(b_, t_, d)
        f = np.maximum(ln(layer["ln2"], h) @ layer["w_f1"] + layer["b_f1"], 0.0)
        h = h + (f @ layer["w_f2"] + layer["b_f2"])
    want = ln(p["ln_f"], h)

    got = attention_apply(params, jnp.asarray(x, jnp.float32), num_heads=heads)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)


def test_causality():
    """Hidden state at position t must not depend on inputs after t."""
    params = _tower_params()
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (2, 10, 8))
    h = attention_apply(params, x, num_heads=2)
    x2 = x.at[:, 7:, :].set(jax.random.normal(jax.random.PRNGKey(2), (2, 3, 8)))
    h2 = attention_apply(params, x2, num_heads=2)
    np.testing.assert_allclose(h[:, :7], h2[:, :7], rtol=1e-6, atol=1e-6)
    assert not np.allclose(h[:, 7:], h2[:, 7:])


def test_packed_matches_separate():
    """Two windows packed into one row (starts marking the boundary) must
    produce the same states as the windows in separate rows: no attention
    leaks across the boundary and positions restart."""
    params = _tower_params(max_len=16)
    key = jax.random.PRNGKey(3)
    w1 = jax.random.normal(key, (1, 4, 8))
    w2 = jax.random.normal(jax.random.PRNGKey(4), (1, 6, 8))

    sep1 = attention_apply(params, w1, num_heads=2)
    sep2 = attention_apply(params, w2, num_heads=2)

    packed_x = jnp.concatenate([w1, w2], axis=1)  # [1, 10, 8]
    starts = jnp.zeros((1, 10)).at[0, 0].set(1.0).at[0, 4].set(1.0)
    packed = attention_apply(params, packed_x, num_heads=2, starts=starts)

    np.testing.assert_allclose(packed[:, :4], sep1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(packed[:, 4:], sep2, rtol=1e-5, atol=1e-6)


def test_unpacked_equals_trivially_packed():
    """starts=None must equal a one-window-per-row starts marking."""
    params = _tower_params()
    x = jax.random.normal(jax.random.PRNGKey(5), (3, 9, 8))
    plain = attention_apply(params, x, num_heads=2)
    starts = jnp.zeros((3, 9)).at[:, 0].set(1.0)
    marked = attention_apply(params, x, num_heads=2, starts=starts)
    np.testing.assert_allclose(plain, marked, rtol=1e-6, atol=1e-6)


def test_dropout_semantics():
    """dropout is a no-op without an rng (the serving path), deterministic
    given a key, different across keys, and identity at rate 0."""
    params = _tower_params()
    x = jax.random.normal(jax.random.PRNGKey(6), (2, 7, 8))
    base = attention_apply(params, x, num_heads=2)

    # rate > 0 but no rng: identity (inference through the same partial).
    np.testing.assert_array_equal(
        np.asarray(attention_apply(params, x, num_heads=2, dropout=0.5)),
        np.asarray(base),
    )
    # rate 0 with an rng: identity.
    np.testing.assert_array_equal(
        np.asarray(
            attention_apply(
                params, x, num_heads=2, dropout=0.0, rng=jax.random.PRNGKey(0)
            )
        ),
        np.asarray(base),
    )
    d1 = attention_apply(params, x, num_heads=2, dropout=0.3, rng=jax.random.PRNGKey(1))
    d1b = attention_apply(params, x, num_heads=2, dropout=0.3, rng=jax.random.PRNGKey(1))
    d2 = attention_apply(params, x, num_heads=2, dropout=0.3, rng=jax.random.PRNGKey(2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d1b))
    assert not np.allclose(d1, base)
    assert not np.allclose(d1, d2)


def test_dropout_fit_trains_and_serves_deterministically():
    """A dropout fit runs (rng threaded through the engine), and the served
    representations afterwards are deterministic (no rng on that path)."""
    inter = _toy_interactions().to_compressed()
    model = (
        attention.Hyperparameters(inter.num_items, 8)
        .embedding_dim(16)
        .dropout(0.2)
        .learning_rate(0.05)
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAM)
        .num_epochs(2)
        .batch_size(16)
        .from_seed(5)
        .build()
    )
    out = model.fit(inter)
    assert np.isfinite(out)
    r1 = model.user_representation([1, 2, 3]).user_embedding
    r2 = model.user_representation([1, 2, 3]).user_embedding
    np.testing.assert_array_equal(r1, r2)


@pytest.mark.parametrize("loss", [Loss.BPR, Loss.HINGE, Loss.WARP])
def test_attention_fit_runs_all_losses(loss):
    inter = _toy_interactions().to_compressed()
    model = (
        attention.Hyperparameters(inter.num_items, 8)
        .embedding_dim(16)
        .learning_rate(0.05)
        .loss(loss)
        .optimizer(Optimizer.ADAM)
        .num_epochs(2)
        .batch_size(16)
        .from_seed(0)
        .build()
    )
    out = model.fit(inter)
    assert np.isfinite(out)


def test_attention_learns_and_serves():
    """On the learnable cyclic-walk data the model must beat random MRR by a
    wide margin, and the serving surface must work end to end."""
    inter = _toy_interactions()
    comp = inter.to_compressed()
    model = (
        attention.Hyperparameters(inter.num_items, 8)
        .embedding_dim(16)
        .learning_rate(0.05)
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAM)
        .num_epochs(12)
        .batch_size(16)
        .from_seed(2)
        .build()
    )
    model.fit(comp)
    mrr = sbr.evaluation.mrr_score(model, comp)
    assert mrr > 5.0 / inter.num_items  # random is ~1/num_items

    rec = model.recommend([1, 2, 3], k=5)
    assert len(rec) == 5
    user = model.user_representation([1, 2, 3])
    scores = model.predict(user)
    assert scores.shape == (inter.num_items,)
    assert np.isfinite(scores).all()


def test_attention_packed_fit_matches_unpacked_loss():
    """Packed and unpacked fits see the same windows; with identical seeds
    the first-epoch losses must be close (not identical — batch grouping
    differs — but the packed path must be sane)."""
    inter = _toy_interactions().to_compressed()

    def build(packed):
        return (
            attention.Hyperparameters(inter.num_items, 8)
            .embedding_dim(16)
            .learning_rate(0.05)
            .loss(Loss.HINGE)
            .optimizer(Optimizer.ADAM)
            .num_epochs(2)
            .batch_size(16)
            .from_seed(7)
            .packed(packed)
            .build()
        )

    lp = build(True).fit(inter)
    lu = build(False).fit(inter)
    assert np.isfinite(lp) and np.isfinite(lu)
    assert abs(lp - lu) < 0.5 * max(lp, lu)


def test_checkpoint_roundtrip(tmp_path):
    inter = _toy_interactions().to_compressed()
    model = (
        attention.Hyperparameters(inter.num_items, 8)
        .embedding_dim(16)
        .num_layers(1)
        .num_heads(2)
        .learning_rate(0.05)
        .num_epochs(1)
        .batch_size(16)
        .from_seed(3)
        .build()
    )
    model.fit(inter)
    from sbr_rs_tpu.utils.checkpoint import load_model, save_model

    path = str(tmp_path / "ckpt")
    save_model(model, path)
    loaded = load_model(path)
    assert isinstance(loaded, attention.ImplicitAttentionModel)
    assert loaded.hyper._num_layers == 1 and loaded.hyper._num_heads == 2
    u1 = model.user_representation([1, 2, 3])
    u2 = loaded.user_representation([1, 2, 3])
    np.testing.assert_allclose(u1.user_embedding, u2.user_embedding, rtol=1e-6)
    np.testing.assert_allclose(
        model.predict(u1), loaded.predict(u2), rtol=1e-6, atol=1e-6
    )


def test_hyperparameter_dict_roundtrip_and_random():
    hp = attention.Hyperparameters(100, 16).num_layers(3).num_heads(4).embedding_dim(32)
    d = hp.to_dict()
    assert d["model_type"] == "attention"
    hp2 = attention.Hyperparameters.from_dict(d)
    assert hp2.to_dict() == d

    for seed in range(5):
        r = attention.Hyperparameters.random(100, seed)
        assert r._item_embedding_dim % r._num_heads == 0
        r.build()  # must construct


def test_heads_must_divide_dim():
    with pytest.raises(ValueError):
        attention.Hyperparameters(10, 8).embedding_dim(15).num_heads(2).build()
