"""Fused LSTM recurrence as a Pallas kernel on the Triton route (GPU).

The training hot loop is the LSTM recurrence (reference: wyrm's unrolled
cell chain, ``src/models/lstm.rs:293-298``; here ``lax.scan`` in
:mod:`sbr_rs_tpu.models.towers`). On a GPU, XLA compiles the scan into a
device while-loop whose every iteration launches several small kernels
around a ``[B, D] @ [D, G*D]`` product, so at training widths launch
latency, not the card, sets the pace. These kernels run the whole
recurrence, forward and backward, inside one kernel launch each:

* the input projection ``x @ w_x + b`` (and its gradients) stay OUTSIDE,
  as single large matrix products over all timesteps;
* each program owns one batch tile and walks the time axis with an
  in-kernel ``fori_loop``; the ``[Bt, D]`` hidden/cell carries (forward)
  and adjoint carries (backward) stay on chip, and ``xz[t]`` is loaded
  per step;
* the gate pre-activations are laid out ``[T, B, 4*Dp]`` with four gate
  slots of ``Dp`` columns each (the Coupled variant leaves its fourth slot
  zero), so each step is ONE ``[Bt, Dp] @ [Dp, 4*Dp]`` product split into
  gates: Triton wants power-of-two blocks and ``pl.dot`` wants every
  dimension >= 16, so the hidden width is padded to
  ``Dp = max(16, next_pow2(D))`` with zero weights. The padding is exact:
  a padded unit has zero pre-activation, so its cell and hidden state stay
  0 (``c' = sigmoid(0) * 0 + sigmoid(0) * tanh(0)``), and its adjoints
  stay 0;
* the backward recomputes gate pre-activations from ``(xz[t], h[t-1])``
  instead of storing ``[B, T, G*D]`` residuals, writes the gate adjoints
  ``dz[t]`` and reads them back whole for ``dh[t-1] = dz[t] @ W_h^T`` and
  the program's partial ``dW_h += h[t-1]^T dz[t]``, carried through the
  time loop (the order the scan's transpose sums in); the partials of the
  batch tiles are summed outside. The ``[Dp, 4*Dp]`` weights and that
  accumulator sit in registers, which is why the kernel pays only at small
  widths (:func:`kernel_pays`);
* packed batches (:func:`sbr_rs_tpu.data.pack_windows`) are supported via a
  ``keep = 1 - starts`` stream that zeroes the carries (forward) and the
  adjoint carries (backward) across window boundaries.

In-kernel products run in IEEE float32 (``precision=HIGHEST``): they are
latency-bound at these widths, so TF32 would buy nothing and would cost
the kernel its agreement with the float32 reference.

Both LSTM variants are supported (Normal [i,f,g,o] and Coupled [i,g,o] with
forget = 1 - input, reference ``src/models/lstm.rs:28-35``). The public
entry point is differentiable via ``jax.custom_vjp``. ``interpret=True``
runs both kernels in the Pallas interpreter (CPU tests); equivalence with
the ``lax.scan`` tower is pinned in ``tests/test_pallas.py``.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

_HIGHEST = jax.lax.Precision.HIGHEST

# Batch rows per program. 16 is the smallest tile ``pl.dot`` takes; the
# recurrence is latency-bound, so more, smaller programs spread it over
# more SMs.
BLOCK_B = 16


# Widest padded hidden width the kernel runs: on an H100 it beats the scan
# tower up to 32 and loses beyond, where the [Dp, 4*Dp] weights and the
# dW_h accumulator outgrow the registers (7.7x slower at 64; the backward
# does not fit a block's shared memory at 128). PERF.md has the numbers.
MAX_KERNEL_WIDTH = 32


def padded_width(d: int) -> int:
    """Hidden width the kernels run at: the next power of two, >= 16."""
    return max(16, pl.next_power_of_2(d))


def kernel_pays(d: int) -> bool:
    """Whether the kernel runs (and is the faster tower) at hidden width
    ``d``."""
    return padded_width(d) <= MAX_KERNEL_WIDTH


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dot(a, b):
    return jnp.dot(a, b, precision=_HIGHEST, preferred_element_type=jnp.float32)


def _dot_t(a, b):
    """``a @ b.T``."""
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        precision=_HIGHEST, preferred_element_type=jnp.float32,
    )


def _dot_tn(a, b):
    """``a.T @ b``."""
    return jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())),
        precision=_HIGHEST, preferred_element_type=jnp.float32,
    )


def _gates(xz_ref, wh_ref, t, h, coupled):
    """Gate activations at step ``t`` from the carried ``h``: (i, f, g, o),
    with f None for the Coupled variant (forget = 1 - input)."""
    z = jnp.split(xz_ref[t, :, :] + _dot(h, wh_ref[...]), 4, axis=-1)
    if coupled:
        return jax.nn.sigmoid(z[0]), None, jnp.tanh(z[1]), jax.nn.sigmoid(z[2])
    return (
        jax.nn.sigmoid(z[0]), jax.nn.sigmoid(z[1]), jnp.tanh(z[2]),
        jax.nn.sigmoid(z[3]),
    )


def _fwd_kernel(xz_ref, wh_ref, keep_ref, hidden_ref, cell_ref, *, coupled):
    seq_len, bt = xz_ref.shape[0], xz_ref.shape[1]
    dp = wh_ref.shape[0]

    def step(t, carry):
        h, c = carry
        keep = keep_ref[t, :][:, None]  # [Bt, 1]; 0 where a window begins
        h = h * keep
        c = c * keep
        i, f, g, o = _gates(xz_ref, wh_ref, t, h, coupled)
        c_new = ((1.0 - i) if coupled else f) * c + i * g
        h_new = o * jnp.tanh(c_new)
        hidden_ref[t, :, :] = h_new
        cell_ref[t, :, :] = c_new
        return h_new, c_new

    zeros = jnp.zeros((bt, dp), jnp.float32)
    jax.lax.fori_loop(0, seq_len, step, (zeros, zeros))


def _bwd_kernel(
    xz_ref, wh_ref, hidden_ref, cell_ref, g_ref, keep_ref, dz_ref, dwh_ref,
    *, coupled, interpret,
):
    """Reverse-time adjoint: visits t = T-1 .. 0."""
    seq_len, bt = xz_ref.shape[0], xz_ref.shape[1]
    dp = wh_ref.shape[0]

    def step(tt, carry):
        dh, dc, dwh = carry
        t = seq_len - 1 - tt
        tp = jnp.maximum(t - 1, 0)
        # The carry survives into step t only when t > 0 AND no window
        # starts at t.
        factor = keep_ref[t, :][:, None] * (t > 0).astype(jnp.float32)
        h_prev = hidden_ref[tp, :, :] * factor
        c_prev = cell_ref[tp, :, :] * factor
        i, f, g, o = _gates(xz_ref, wh_ref, t, h_prev, coupled)
        tc = jnp.tanh(cell_ref[t, :, :])
        dh_total = g_ref[t, :, :] + dh
        dz_o = dh_total * tc * o * (1.0 - o)
        dc_total = dc + dh_total * o * (1.0 - tc * tc)
        dz_g = dc_total * i * (1.0 - g * g)
        if coupled:
            dz = [dc_total * (g - c_prev) * i * (1.0 - i), dz_g, dz_o, zeros]
            dc_prev = dc_total * (1.0 - i)
        else:
            dz_f = dc_total * c_prev * f * (1.0 - f)
            dz = [dc_total * g * i * (1.0 - i), dz_f, dz_g, dz_o]
            dc_prev = dc_total * f
        for j, dz_j in enumerate(dz):
            dz_ref[t, :, pl.ds(j * dp, dp)] = dz_j
        if not interpret:
            # The slots were stored by other threads than the ones that
            # read the whole row back.
            pltr.debug_barrier()
        dz_t = dz_ref[t, :, :]  # [Bt, 4*Dp]
        dwh = dwh + _dot_tn(h_prev, dz_t)
        return _dot_t(dz_t, wh_ref[...]) * factor, dc_prev * factor, dwh

    zeros = jnp.zeros((bt, dp), jnp.float32)
    dwh0 = jnp.zeros(wh_ref.shape, jnp.float32)
    _, _, dwh = jax.lax.fori_loop(0, seq_len, step, (zeros, zeros, dwh0))
    dwh_ref[...] = dwh


def _call(kernel, args, out_shapes, specs, out_specs, nb, interpret):
    return pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=specs,
        out_specs=out_specs,
        out_shape=out_shapes,
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
    )(*args)


def _specs(t, bt, dp):
    """BlockSpecs of the [T, B, 4*Dp] / [T, B, Dp] / [T, B] operands and the
    [Dp, 4*Dp] weights."""
    gated = pl.BlockSpec((t, bt, 4 * dp), lambda i: (0, i, 0))
    seq = pl.BlockSpec((t, bt, dp), lambda i: (0, i, 0))
    keep = pl.BlockSpec((t, bt), lambda i: (0, i))
    weights = pl.BlockSpec((dp, 4 * dp), lambda i: (0, 0))
    return gated, seq, keep, weights


@functools.partial(jax.jit, static_argnames=("coupled", "interpret"))
def _fwd(xz, w_h, keep, *, coupled: bool, interpret: bool):
    """xz: [T, Bp, 4*Dp] padded time-major inputs; w_h: [Dp, 4*Dp];
    keep: [T, Bp]. Returns (hidden, cell), both [T, Bp, Dp]."""
    t, b, _ = xz.shape
    dp = w_h.shape[0]
    gated, seq, keep_spec, weights = _specs(t, BLOCK_B, dp)
    out = jax.ShapeDtypeStruct((t, b, dp), jnp.float32)
    return _call(
        functools.partial(_fwd_kernel, coupled=coupled),
        (xz, w_h, keep), [out, out], [gated, weights, keep_spec], [seq, seq],
        b // BLOCK_B, interpret,
    )


@functools.partial(jax.jit, static_argnames=("coupled", "interpret"))
def _bwd(xz, w_h, hidden, cell, g_out, keep, *, coupled: bool, interpret: bool):
    """All sequence args padded time-major. Returns dz [T, Bp, 4*Dp] and
    dW_h [Dp, 4*Dp]."""
    t, b, _ = xz.shape
    dp = w_h.shape[0]
    nb = b // BLOCK_B
    gated, seq, keep_spec, weights = _specs(t, BLOCK_B, dp)
    dz, dwh = _call(
        functools.partial(_bwd_kernel, coupled=coupled, interpret=interpret),
        (xz, w_h, hidden, cell, g_out, keep),
        [
            jax.ShapeDtypeStruct(xz.shape, jnp.float32),
            jax.ShapeDtypeStruct((nb, dp, 4 * dp), jnp.float32),
        ],
        [gated, weights, seq, seq, seq, keep_spec],
        [gated, pl.BlockSpec((None, dp, 4 * dp), lambda i: (i, 0, 0))],
        nb, interpret,
    )
    return dz, dwh.sum(axis=0)


def _to_slots(w, g, d, dp):
    """``[..., G*D]`` -> ``[..., 4*Dp]``: four gate slots of ``Dp`` columns,
    zero-padded per gate (and a zero fourth slot when G == 3)."""
    w = w.reshape(*w.shape[:-1], g, d)
    w = jnp.pad(w, [(0, 0)] * (w.ndim - 2) + [(0, 4 - g), (0, dp - d)])
    return w.reshape(*w.shape[:-2], 4 * dp)


def _from_slots(w, g, d):
    """Inverse of :func:`_to_slots` on the last axis."""
    dp = w.shape[-1] // 4
    w = w.reshape(*w.shape[:-1], 4, dp)[..., :g, :d]
    return w.reshape(*w.shape[:-2], g * d)


def lstm_apply_pallas(
    params: Dict[str, jnp.ndarray],
    x: jnp.ndarray,
    *,
    coupled: bool,
    starts: "jnp.ndarray | None" = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Drop-in replacement for :func:`sbr_rs_tpu.models.towers.lstm_apply`
    (same ``[B, T, D] -> [B, T, D]`` contract, including packed-batch
    ``starts``) with the recurrence, forward and VJP, as fused kernels.
    ``interpret=True`` runs them in the Pallas interpreter."""

    b0, t0, d0 = x.shape
    if not kernel_pays(d0):
        raise ValueError(
            f"the LSTM kernel runs hidden widths up to {MAX_KERNEL_WIDTH}, "
            f"not {d0}; use the lax.scan tower"
        )
    if starts is None:
        keep = jnp.ones((t0, b0), jnp.float32)
    else:
        keep = (1.0 - starts).swapaxes(0, 1).astype(jnp.float32)

    # `keep` is an EXPLICIT primal of the custom_vjp (zero cotangent), never
    # a closure: a closed-over traced value would be captured by the
    # backward's closure and leak into the transpose trace; shard_map
    # traces the backward separately and rejects it (UnexpectedTracerError).
    @jax.custom_vjp
    def _apply(params, x, keep):
        hidden, _ = _run_fwd(params, x, keep)
        return hidden

    def _run_fwd(params, x, keep):
        b, t, d = x.shape
        g = params["w_x"].shape[1] // d
        dp = padded_width(d)
        bp = _round_up(b, BLOCK_B)
        xz = (x.reshape(b * t, d) @ params["w_x"]).reshape(b, t, -1) + params["b"]
        xz = _to_slots(xz.swapaxes(0, 1), g, d, dp)  # [T, B, 4*Dp]
        xz = jnp.pad(xz.astype(jnp.float32), ((0, 0), (0, bp - b), (0, 0)))
        keep_p = jnp.pad(keep, ((0, 0), (0, bp - b)))
        w_h = jnp.pad(_to_slots(params["w_h"], g, d, dp), ((0, dp - d), (0, 0)))
        hidden, cell = _fwd(xz, w_h, keep_p, coupled=coupled, interpret=interpret)
        return hidden[:, :b, :d].swapaxes(0, 1), (xz, w_h, keep_p, hidden, cell)

    def _fwd_rule(params, x, keep):
        hidden, res = _run_fwd(params, x, keep)
        return hidden, (params, x, keep, *res)

    def _bwd_rule(res, g_out):
        params, x, keep, xz, w_h, keep_p, hidden, cell = res
        b, t, d = x.shape
        g = params["w_x"].shape[1] // d
        bp, dp = xz.shape[1], w_h.shape[0]
        g_tm = jnp.pad(
            g_out.swapaxes(0, 1).astype(jnp.float32),
            ((0, 0), (0, bp - b), (0, dp - d)),
        )
        dz, dwh = _bwd(xz, w_h, hidden, cell, g_tm, keep_p, coupled=coupled,
                       interpret=interpret)
        dz = _from_slots(dz[:, :b], g, d)  # [T, B, G*D]
        dxz2 = dz.swapaxes(0, 1).reshape(b * t, -1)
        dparams = {
            "w_x": x.reshape(b * t, d).T @ dxz2,
            "w_h": _from_slots(dwh[:d], g, d),
            "b": dxz2.sum(axis=0),
        }
        dx = (dxz2 @ params["w_x"].T).reshape(b, t, d)
        return dparams, dx.astype(x.dtype), jnp.zeros_like(keep)

    _apply.defvjp(_fwd_rule, _bwd_rule)
    return _apply(params, x, keep)
