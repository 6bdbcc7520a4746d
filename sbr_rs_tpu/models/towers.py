"""Sequence towers: the recurrent encoders mapping input-item embeddings to
per-timestep user states.

Batched replacements for the reference's per-timestep unrolled graphs:

* LSTM (``src/models/lstm.rs:293-298`` building wyrm's ``nn::lstm`` cells,
  Normal and Coupled variants ``src/models/lstm.rs:28-35``) — here a
  ``lax.scan`` over a fused-gate cell. The input projection for *all*
  timesteps is hoisted out of the scan into one large matrix product
  (:mod:`sbr_rs_tpu.ops.pallas_lstm` runs the recurrence itself as one
  GPU kernel at small widths).
* EWMA (``src/models/ewma.rs:302-313``): ``u_1 = i_1``,
  ``u_t = sigmoid(alpha) * u_{t-1} + (1 - sigmoid(alpha)) * i_t`` with a
  learnable per-dimension ``alpha`` initialized to zeros
  (``src/models/ewma.rs:175-178``). This is a linear recurrence, so it runs
  as a ``lax.associative_scan`` — O(log T) depth instead of O(T).

Towers are pure functions over parameter pytrees; each returns the hidden
state *after* consuming the input at each timestep, ``[B, T, D]`` — the
state the reference scores targets against
(``src/models/lstm.rs:300-311``).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def _glorot(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[1]
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return std * jax.random.normal(key, shape, dtype=dtype)


def init_lstm(key: jax.Array, dim: int, coupled: bool) -> Dict[str, jnp.ndarray]:
    """LSTM cell parameters with fused gate matrices.

    Gate order: ``[i, f, g, o]`` (normal) / ``[i, g, o]`` (coupled — the
    forget gate is tied to ``1 - i``, reference ``src/models/lstm.rs:28-35``).
    Each gate's ``[dim, dim]`` block is Glorot-initialized with per-gate
    fan (wyrm's ``nn::lstm`` allocates each gate matrix separately), then
    laid out fused as ``[dim, gates*dim]`` for one matrix product.
    """
    gates = 3 if coupled else 4
    k_x, k_h = jax.random.split(key)
    w_x = jnp.concatenate(
        [_glorot(k, (dim, dim)) for k in jax.random.split(k_x, gates)], axis=1
    )
    w_h = jnp.concatenate(
        [_glorot(k, (dim, dim)) for k in jax.random.split(k_h, gates)], axis=1
    )
    b = jnp.zeros((gates * dim,), dtype=jnp.float32)
    return {"w_x": w_x, "w_h": w_h, "b": b}


def lstm_apply(
    params: Dict[str, jnp.ndarray],
    x: jnp.ndarray,
    *,
    coupled: bool,
    starts: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Run the LSTM over ``x [B, T, D]`` returning hidden states ``[B, T, D]``.

    ``starts [B, T]`` (optional, packed batches): 1.0 where a new window
    begins — the carry is reset there, so packed rows behave exactly like
    separate sequences.
    """
    b_, t_, d = x.shape
    # Hoist the input projection out of the scan: one [B*T, D] @ [D, G*D]
    # matrix product instead of T small ones.
    xz = (x.reshape(b_ * t_, d) @ params["w_x"]).reshape(b_, t_, -1) + params["b"]
    xz = xz.swapaxes(0, 1)  # [T, B, G*D]
    w_h = params["w_h"]
    keep = None if starts is None else (1.0 - starts).swapaxes(0, 1)[..., None]  # [T, B, 1]

    def cell(carry, xs):
        h, c = carry
        if starts is None:
            xz_t = xs
        else:
            xz_t, keep_t = xs
            h = h * keep_t
            c = c * keep_t
        z = xz_t + h @ w_h
        if coupled:
            i, g, o = jnp.split(z, 3, axis=-1)
            i = jax.nn.sigmoid(i)
            c_new = (1.0 - i) * c + i * jnp.tanh(g)
        else:
            i, f, g, o = jnp.split(z, 4, axis=-1)
            i = jax.nn.sigmoid(i)
            f = jax.nn.sigmoid(f)
            c_new = f * c + i * jnp.tanh(g)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        return (h_new, c_new), h_new

    # Carries in f32: the cell computes in f32 (xz promotes) regardless of
    # the input's storage dtype (e.g. bf16 item tables).
    init = (
        jnp.zeros((b_, d), dtype=jnp.float32),
        jnp.zeros((b_, d), dtype=jnp.float32),
    )
    xs = xz if starts is None else (xz, keep)
    _, hidden = jax.lax.scan(cell, init, xs)
    return hidden.swapaxes(0, 1)  # [B, T, D]


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


def init_gru(key: jax.Array, dim: int) -> Dict[str, jnp.ndarray]:
    """GRU cell parameters with fused gate matrices, gate order ``[r, z, n]``
    (reset, update, candidate — the GRU4Rec cell; no counterpart in the
    reference, whose towers are LSTM and EWMA). Same conventions as
    :func:`init_lstm`: per-gate Glorot blocks fused to ``[dim, 3*dim]`` for
    one matrix product, a single x-side bias."""
    k_x, k_h = jax.random.split(key)
    w_x = jnp.concatenate(
        [_glorot(k, (dim, dim)) for k in jax.random.split(k_x, 3)], axis=1
    )
    w_h = jnp.concatenate(
        [_glorot(k, (dim, dim)) for k in jax.random.split(k_h, 3)], axis=1
    )
    b = jnp.zeros((3 * dim,), dtype=jnp.float32)
    return {"w_x": w_x, "w_h": w_h, "b": b}


def gru_apply(
    params: Dict[str, jnp.ndarray],
    x: jnp.ndarray,
    *,
    starts: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Run the GRU over ``x [B, T, D]`` returning hidden states ``[B, T, D]``.

    ``r = sigmoid(x W_xr + h W_hr + b_r)``; ``z`` likewise;
    ``n = tanh(x W_xn + b_n + r * (h W_hn))``;
    ``h' = (1 - z) * n + z * h`` with ``h_0 = 0``.

    ``starts [B, T]`` (packed batches): 1.0 where a new window begins —
    the carry resets there, the same contract as :func:`lstm_apply`.
    """
    b_, t_, d = x.shape
    xz = (x.reshape(b_ * t_, d) @ params["w_x"]).reshape(b_, t_, -1) + params["b"]
    xz = xz.swapaxes(0, 1)  # [T, B, 3D]
    w_h = params["w_h"]
    keep = None if starts is None else (1.0 - starts).swapaxes(0, 1)[..., None]

    def cell(h, xs):
        if starts is None:
            xz_t = xs
        else:
            xz_t, keep_t = xs
            h = h * keep_t
        hz = h @ w_h  # [B, 3D]
        xr, xu, xn = jnp.split(xz_t, 3, axis=-1)
        hr, hu, hn = jnp.split(hz, 3, axis=-1)
        r = jax.nn.sigmoid(xr + hr)
        z = jax.nn.sigmoid(xu + hu)
        n = jnp.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    init = jnp.zeros((b_, d), dtype=jnp.float32)
    xs = xz if starts is None else (xz, keep)
    _, hidden = jax.lax.scan(cell, init, xs)
    return hidden.swapaxes(0, 1)  # [B, T, D]


# ---------------------------------------------------------------------------
# Causal self-attention (SASRec-style transformer encoder)
# ---------------------------------------------------------------------------


def init_attention(
    key: jax.Array,
    dim: int,
    max_len: int,
    num_layers: int = 2,
    num_heads: int = 1,
) -> Dict:
    """Parameters for the causal self-attention tower.

    No counterpart in the reference (its towers are LSTM and EWMA) — this is
    a deliberate extension: every op in the tower is a large batched
    matrix product (QKV/output projections, attention scores, FFN), the
    shape accelerators run fastest, where the LSTM serializes a length-T
    scan.

    Layout: learned positional table ``[max_len, D]`` plus per-layer pre-LN
    blocks ``{ln1, w_qkv [D, 3D], w_o [D, D], ln2, w_f1/b_f1, w_f2/b_f2}``
    and a final layer norm. Deterministic (no dropout), matching the rest of
    the framework.
    """
    if dim % num_heads:
        raise ValueError(f"num_heads={num_heads} must divide dim={dim}")
    k_pos, k_layers = jax.random.split(key)
    pos = (dim**-0.5) * jax.random.normal(k_pos, (max_len, dim), dtype=jnp.float32)

    def _layer(k):
        k_qkv, k_o, k_f1, k_f2 = jax.random.split(k, 4)
        return {
            "ln1": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
            "w_qkv": _glorot(k_qkv, (dim, 3 * dim)),
            "w_o": _glorot(k_o, (dim, dim)),
            "ln2": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
            "w_f1": _glorot(k_f1, (dim, dim)),
            "b_f1": jnp.zeros((dim,)),
            "w_f2": _glorot(k_f2, (dim, dim)),
            "b_f2": jnp.zeros((dim,)),
        }

    return {
        "pos": pos,
        "layers": [_layer(k) for k in jax.random.split(k_layers, num_layers)],
        "ln_f": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
    }


def _layer_norm(p: Dict, x: jnp.ndarray) -> jnp.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def attention_apply(
    params: Dict,
    x: jnp.ndarray,
    *,
    num_heads: int,
    dropout: float = 0.0,
    starts: "jnp.ndarray | None" = None,
    rng: "jax.Array | None" = None,
) -> jnp.ndarray:
    """Run the causal transformer encoder over ``x [B, T, D]`` → ``[B, T, D]``.

    Positions are window-relative and attention is block-diagonal across
    packed windows: with ``starts [B, T]`` marking window beginnings,
    position ``t`` attends only to ``j <= t`` in the SAME window and its
    positional index restarts at each window start — so packed rows behave
    exactly like separate sequences (the same contract the recurrent towers
    honor by resetting their carries).

    Causality gives this tower the recurrent towers' semantics: the state at
    ``t`` depends only on items ``<= t``, so next-item training targets and
    the serving last-state readout work unchanged.

    ``dropout``/``rng``: inverted dropout on the embedded input and on each
    residual branch (the SASRec placement — its decisive regularizer on
    sparse recommendation data). Active only when BOTH ``dropout > 0`` and a
    key is given; the serving path passes no key, so inference is always
    deterministic. The training engine derives the key by ``fold_in`` from
    the step key, leaving every existing RNG stream untouched.
    """
    b_, t_, d = x.shape
    x = x.astype(jnp.float32)
    t_idx = jnp.arange(t_)
    causal = t_idx[None, :] <= t_idx[:, None]  # [T, T]
    max_len = params["pos"].shape[0]
    if starts is None:
        # Positions are just 0..T-1 — a slice+broadcast, not a [B,T]-index
        # table gather (row gathers are the step's dominant cost class).
        if t_ <= max_len:
            h = x + params["pos"][:t_][None]
        else:  # beyond the table: clamp tail positions, same as packed
            idx = jnp.clip(t_idx, 0, max_len - 1)
            h = x + jnp.take(params["pos"], idx, axis=0)[None]
        mask = jnp.broadcast_to(causal, (b_, 1, t_, t_))
    else:
        s = starts.at[:, 0].set(1.0)  # row position 0 always begins a window
        win_id = jnp.cumsum(s, axis=1)  # [B, T]
        start_pos = jax.lax.cummax(jnp.where(s > 0, t_idx, 0), axis=1)
        pos_idx = jnp.clip(t_idx - start_pos, 0, max_len - 1)
        h = x + jnp.take(params["pos"], pos_idx, axis=0)
        same_win = win_id[:, :, None] == win_id[:, None, :]
        mask = (same_win & causal)[:, None]  # [B, 1, T, T]

    use_dropout = dropout > 0.0 and rng is not None
    if use_dropout:
        keep = 1.0 - dropout
        drop_keys = iter(jax.random.split(rng, 1 + 2 * len(params["layers"])))

        def drop(v):
            m = jax.random.bernoulli(next(drop_keys), keep, v.shape)
            return jnp.where(m, v / keep, 0.0)

        h = drop(h)

    hd = d // num_heads
    scale = hd**-0.5
    neg = jnp.float32(-1e9)
    for layer in params["layers"]:
        a_in = _layer_norm(layer["ln1"], h)
        qkv = (a_in.reshape(b_ * t_, d) @ layer["w_qkv"]).reshape(
            b_, t_, 3, num_heads, hd
        )
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, H, hd]
        logits = jnp.einsum("bihd,bjhd->bhij", q, k) * scale
        logits = jnp.where(mask, logits, neg)
        attn = jax.nn.softmax(logits, axis=-1)
        ctx = jnp.einsum("bhij,bjhd->bihd", attn, v).reshape(b_ * t_, d)
        branch = (ctx @ layer["w_o"]).reshape(b_, t_, d)
        h = h + (drop(branch) if use_dropout else branch)
        f_in = _layer_norm(layer["ln2"], h)
        f = jax.nn.relu(
            (f_in.reshape(b_ * t_, d) @ layer["w_f1"]) + layer["b_f1"]
        )
        branch = ((f @ layer["w_f2"]) + layer["b_f2"]).reshape(b_, t_, d)
        h = h + (drop(branch) if use_dropout else branch)

    return _layer_norm(params["ln_f"], h)


# ---------------------------------------------------------------------------
# EWMA
# ---------------------------------------------------------------------------


def init_ewma(key: jax.Array, dim: int, alpha_init: float = 0.0) -> Dict[str, jnp.ndarray]:
    """EWMA parameters: per-dimension decay logits, zero-initialized
    (sigmoid(0) = 0.5; reference ``src/models/ewma.rs:175-178``).
    ``alpha_init`` is a tuning lever (0.0 = the reference's init exactly).

    The reference also allocates ``fc1``/``fc2`` dense layers that are never
    used in its graph (``src/models/ewma.rs:179-188``) — deliberately not
    reproduced here (dead parameters, see SURVEY.md §2.1).
    """
    del key
    return {"alpha": jnp.full((dim,), alpha_init, dtype=jnp.float32)}


def ewma_apply(
    params: Dict[str, jnp.ndarray],
    x: jnp.ndarray,
    *,
    starts: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Run the EWMA recurrence over ``x [B, T, D]`` via associative scan.

    ``u_t = a * u_{t-1} + (1 - a) * x_t`` with ``u_0 = x_0`` is expressed as
    the affine-map composition ``(A, B) : u -> A*u + B`` with
    ``(A_0, B_0) = (0, x_0)`` and ``(A_t, B_t) = (a, (1-a)*x_t)``, which is
    associative: ``(A2,B2) ∘ (A1,B1) = (A1*A2, A2*B1 + B2)``.

    ``starts [B, T]`` (packed batches): positions where a new window begins
    restart the recurrence — exactly the ``u_start = x_start`` rule applied
    mid-row, so the affine map there is ``(0, x_t)``.
    """
    a = jax.nn.sigmoid(params["alpha"]).astype(x.dtype)  # [D]
    b_, t_, d = x.shape
    if starts is None:
        coeff = jnp.broadcast_to(a, (b_, t_, d))
        coeff = coeff.at[:, 0, :].set(0.0)
        shift = (1.0 - a) * x
        shift = shift.at[:, 0, :].set(x[:, 0, :])
    else:
        keep = (1.0 - starts)[..., None]  # [B, T, 1]
        coeff = a * keep
        shift = jnp.where(keep > 0, (1.0 - a) * x, x)
        # Row position 0 always begins a window (there is nothing to carry
        # from), whether or not the caller marked it — same convention as
        # the LSTM's zero-initialized carry.
        coeff = coeff.at[:, 0, :].set(0.0)
        shift = shift.at[:, 0, :].set(x[:, 0, :])

    # Two-level BLOCKED affine scan instead of lax.associative_scan: the
    # tree scan slices the scanned axis at every level, and those strided
    # slices each cost a copy. Here every operation is an elementwise fused multiply-add on a
    # contiguous reshape: an unrolled inner scan within blocks of K
    # timesteps, a short serial compose over block totals, one broadcast
    # combine. Because the affine map at every window start is (0, x_t),
    # the composed A from position 0 is identically 0 and the state is just
    # the composed shift.
    k = 16
    nb = -(-t_ // k)
    pad = nb * k - t_
    if pad:
        # identity affine maps on the padding tail
        coeff = jnp.pad(coeff, ((0, 0), (0, pad), (0, 0)), constant_values=1.0)
        shift = jnp.pad(shift, ((0, 0), (0, pad), (0, 0)))
    ab = coeff.reshape(b_, nb, k, d)
    sb = shift.reshape(b_, nb, k, d)

    acc_a, acc_s = ab[:, :, 0], sb[:, :, 0]
    inner_a, inner_s = [acc_a], [acc_s]
    for j in range(1, k):
        acc_a, acc_s = acc_a * ab[:, :, j], sb[:, :, j] + ab[:, :, j] * acc_s
        inner_a.append(acc_a)
        inner_s.append(acc_s)
    inner_a = jnp.stack(inner_a, axis=2)  # [B, nb, k, D]
    inner_s = jnp.stack(inner_s, axis=2)

    # Exclusive compose of block totals: state entering block i.
    pre = [jnp.zeros((b_, d), coeff.dtype)]
    for i in range(1, nb):
        pre.append(acc_a[:, i - 1] * pre[-1] + acc_s[:, i - 1])
    pre_s = jnp.stack(pre, axis=1)  # [B, nb, D]

    u = inner_s + inner_a * pre_s[:, :, None, :]
    return u.reshape(b_, nb * k, d)[:, :t_]
