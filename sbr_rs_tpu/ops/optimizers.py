"""Sparse-aware Adagrad / Adam.

The reference trains via wyrm's ``optim::{Adagrad, Adam}`` with sparse
row-gradients flowing into the shared embedding tables
(``src/models/lstm.rs:234-248``, ``src/models/sequence_model.rs:163-169``):
only rows touched by a step are updated, and the L2 penalty is applied to
touched rows only.

A batched port of that semantic must avoid dense full-table updates —
on a 10M-row table a dense Adagrad step would move GBs of device memory
per step for a handful of touched rows. Instead each step:

1. collects the flat row indices touched by the batch (inputs, positives,
   negative candidates) together with an occurrence-validity mask,
2. deduplicates them with a sort + segment-sum (static shapes, fully
   parallel),
3. gathers optimizer state for the unique rows, computes the update, and
   scatters parameters/state back with ``mode='drop'`` for padding.

Memory traffic is therefore proportional to *touched rows*, not table size.
Dense (small) parameters — LSTM cell weights, the EWMA ``alpha`` — use the
ordinary dense update, which matches the reference where those parameters
participate in every step's graph.

Update rules:

* Adagrad:  ``acc += g²;  w -= lr * g / sqrt(acc + eps)``
* Adam (lazy on sparse rows): standard Adam moments with global-step bias
  correction; moments of untouched rows are not decayed, mirroring wyrm's
  sparse-row behavior.
* L2: ``g += l2 * w`` on touched rows before the update (wyrm's
  ``l2_penalty`` semantics).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..models import Optimizer

_ADAGRAD_EPS = 1e-10
_ADAM_B1 = 0.9
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8


class DedupedRows(NamedTuple):
    """Result of :func:`dedupe_rows`: a static-shape description of the
    unique rows touched by a step.

    ``order`` sorts the original occurrences; ``seg_id[i]`` is the segment
    (unique row) of sorted occurrence ``i``; ``row_ids`` holds each
    segment's row id, with invalid/unused segments set to ``num_rows``
    (so scatters with ``mode='drop'`` skip them).
    """

    order: jnp.ndarray  # [M] int32 — argsort of masked indices
    seg_id: jnp.ndarray  # [M] int32 — segment id per sorted occurrence
    row_ids: jnp.ndarray  # [M] int — unique row per segment (num_rows = invalid)
    valid: jnp.ndarray  # [M] bool — segment is a real (in-range) row


def dedupe_rows(indices: jnp.ndarray, occurrence_valid: jnp.ndarray, num_rows: int) -> DedupedRows:
    """Deduplicate touched row indices with static shapes.

    ``indices``: flat int row ids, one per occurrence. ``occurrence_valid``:
    bool per occurrence (padding / masked timesteps are invalid). Invalid
    occurrences are remapped to ``num_rows`` so they sort last and form a
    single dropped segment.
    """
    m = indices.shape[0]
    masked = jnp.where(occurrence_valid, indices, num_rows)
    order = jnp.argsort(masked)
    s = masked[order]
    starts = jnp.concatenate([jnp.ones((1,), dtype=bool), s[1:] != s[:-1]])
    seg_id = jnp.cumsum(starts) - 1
    row_ids = jax.ops.segment_max(s, seg_id, num_segments=m, indices_are_sorted=True)
    valid = (row_ids >= 0) & (row_ids < num_rows)
    row_ids = jnp.where(valid, row_ids, num_rows)
    return DedupedRows(order=order, seg_id=seg_id, row_ids=row_ids, valid=valid)


def segment_sum_grads(row_grads: jnp.ndarray, dd: DedupedRows) -> jnp.ndarray:
    """Sum per-occurrence gradients into per-unique-row gradients ([M, ...])."""
    return jax.ops.segment_sum(
        row_grads[dd.order], dd.seg_id, num_segments=dd.order.shape[0],
        indices_are_sorted=True,
    )


def _blocked_cumsum(x: jnp.ndarray, block: int = 128) -> jnp.ndarray:
    """Inclusive cumsum along axis 0 with two-level blocking.

    XLA may lower a plain cumsum along the major axis to a SERIAL
    per-element loop. Splitting into
    ``block``-sized chunks scans ``block`` elements serially inside each
    chunk (vectorized across chunks) plus one short scan over chunk totals:
    serial length drops from N to ``block + N/block``.
    """
    m = x.shape[0]
    nb = -(-m // block)
    pad = nb * block - m
    xp = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    blocks = xp.reshape((nb, block) + x.shape[1:])
    inner = jnp.cumsum(blocks, axis=1, dtype=x.dtype)
    offsets = jnp.cumsum(inner[:, -1], axis=0, dtype=x.dtype)
    offsets = jnp.concatenate([jnp.zeros_like(offsets[:1]), offsets[:-1]])
    out = inner + offsets[:, None]
    return out.reshape((nb * block,) + x.shape[1:])[:m]


def _blocked_cummax_int(x: jnp.ndarray, block: int = 128) -> jnp.ndarray:
    """Inclusive cummax along axis 0 for 1-D int arrays, blocked like
    :func:`_blocked_cumsum`."""
    m = x.shape[0]
    nb = -(-m // block)
    pad = nb * block - m
    imin = jnp.iinfo(x.dtype).min
    xp = jnp.pad(x, (0, pad), constant_values=imin)
    blocks = xp.reshape(nb, block)
    inner = jax.lax.cummax(blocks, axis=1)
    offsets = jax.lax.cummax(inner[:, -1], axis=0)
    offsets = jnp.concatenate([jnp.full((1,), imin, x.dtype), offsets[:-1]])
    out = jnp.maximum(inner, offsets[:, None])
    return out.reshape(nb * block)[:m]


def dedupe_and_sum(
    indices: jnp.ndarray,
    occurrence_valid: jnp.ndarray,
    row_grads: jnp.ndarray,
    bias_occ: jnp.ndarray,
    num_rows: int,
) -> Tuple[DedupedRows, jnp.ndarray, jnp.ndarray]:
    """Fused :func:`dedupe_rows` + :func:`segment_sum_grads` + per-row bias
    validity, built from CUMULATIVE scans instead of segment reductions.

    ``segment_sum``/``segment_max`` lower to scatters; over SORTED
    occurrences the same results come from a cumsum, a cummax, and
    one sorted gather, all parallel ops. Each unique row's slot is its
    LAST occurrence position in the sorted order (occurrence space, not
    compacted segment space): ``summed[p] = cum[p] - cum[start_of_run - 1]``
    with the run start found by a scalar cummax over start positions.

    Returns ``(dd, summed, bias_valid)`` shaped like the unfused pipeline
    (``dd.seg_id`` is not meaningful in this layout and set to zeros).
    """
    m = indices.shape[0]
    masked = jnp.where(occurrence_valid, indices, num_rows)
    order = jnp.argsort(masked)
    s = masked[order]
    gs = row_grads[order]  # [m, C]
    bs = bias_occ[order].astype(jnp.float32)

    pos = jnp.arange(m, dtype=jnp.int32)
    starts = jnp.concatenate([jnp.ones((1,), dtype=bool), s[1:] != s[:-1]])
    ends = jnp.concatenate([s[1:] != s[:-1], jnp.ones((1,), dtype=bool)])
    # Position of the current run's first occurrence: scalar cummax.
    start_pos = _blocked_cummax_int(jnp.where(starts, pos, jnp.int32(-1)))
    prev = start_pos - 1  # last position BEFORE this run (-1: none)

    # Run sums as cumsum DIFFERENCES: parallel, at the cost of per-run
    # exactness — a run's sum inherits rounding from the prefix before it
    # (~ulp(prefix magnitude) per entry, the same class as scatter-order
    # association noise; the golden engine test bounds it).
    cum = _blocked_cumsum(gs.astype(jnp.float32))
    base = jnp.take(
        cum, jnp.maximum(prev, 0), axis=0, indices_are_sorted=True
    ) * (prev >= 0).astype(jnp.float32)[:, None]
    summed = cum - base  # run-sum at END positions

    bcum = _blocked_cumsum(bs)
    bbase = jnp.take(bcum, jnp.maximum(prev, 0), indices_are_sorted=True) * (
        prev >= 0
    ).astype(jnp.float32)
    bias_valid = (bcum - bbase) > 0.0

    live = ends & (s < num_rows)
    row_ids = jnp.where(live, s, num_rows)
    return (
        DedupedRows(order=order, seg_id=jnp.zeros_like(pos), row_ids=row_ids, valid=live),
        summed,
        bias_valid,
    )


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_state(kind: Optimizer, param: jnp.ndarray):
    if kind == Optimizer.ADAGRAD:
        return {"acc": jnp.zeros_like(param)}
    elif kind == Optimizer.ADAM:
        return {"m": jnp.zeros_like(param), "v": jnp.zeros_like(param)}
    raise ValueError(f"Unknown optimizer: {kind}")


# ---------------------------------------------------------------------------
# Dense update (small parameters: cell weights, alpha)
# ---------------------------------------------------------------------------


def dense_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    param: jnp.ndarray,
    state: dict,
    grad: jnp.ndarray,
    step: jnp.ndarray,
) -> Tuple[jnp.ndarray, dict]:
    g = grad + l2 * param
    if kind == Optimizer.ADAGRAD:
        acc = state["acc"] + g * g
        new_param = param - lr * g / jnp.sqrt(acc + _ADAGRAD_EPS)
        return new_param, {"acc": acc}
    else:  # Adam
        m = _ADAM_B1 * state["m"] + (1.0 - _ADAM_B1) * g
        v = _ADAM_B2 * state["v"] + (1.0 - _ADAM_B2) * (g * g)
        t = step.astype(jnp.float32) + 1.0
        m_hat = m / (1.0 - _ADAM_B1**t)
        v_hat = v / (1.0 - _ADAM_B2**t)
        new_param = param - lr * m_hat / (jnp.sqrt(v_hat) + _ADAM_EPS)
        return new_param, {"m": m, "v": v}


# ---------------------------------------------------------------------------
# Dense-table update with touched-row semantics (small catalogs)
# ---------------------------------------------------------------------------


def dense_row_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    table: jnp.ndarray,
    state: dict,
    grad: jnp.ndarray,
    touched: jnp.ndarray,
    step: jnp.ndarray,
    bias_touched: "jnp.ndarray | None" = None,
) -> Tuple[jnp.ndarray, dict]:
    """Full-table update that preserves the sparse (touched-rows-only)
    semantics: L2 decay and Adam moment decay apply only to rows the batch
    touched. For small catalogs this beats the sort+segment sparse path —
    the whole table is cheaper to stream than a sort of the occurrences.

    ``grad``: dense cotangent (scatter-add of row grads, zeros elsewhere).
    ``touched``: bool [num_rows]. Math runs in f32; results are written back
    in the table's/state's storage dtype (bf16 tables supported).

    ``bias_touched`` (fused ``[N, D+1]`` tables only): rows whose LAST
    column (the bias) received a gradient. The reference keeps biases as a
    separate parameter that input-only occurrences never touch
    (``src/models/lstm.rs:272-291`` — inputs index only the embedding
    table), so the bias column of a row touched only as an input must see
    no L2, no accumulator/moment update, and no step.
    """
    dt, st = table.dtype, {k: v.dtype for k, v in state.items()}
    if table.ndim == 1:
        t_mask = touched
    elif bias_touched is not None:
        # Per-column touch mask: embedding columns follow the row, the bias
        # column follows bias_touched.
        t_mask = jnp.concatenate(
            [
                jnp.broadcast_to(touched[:, None], (table.shape[0], table.shape[1] - 1)),
                bias_touched[:, None],
            ],
            axis=1,
        )
    else:
        t_mask = touched[:, None]
    g = grad + l2 * table.astype(jnp.float32) * t_mask
    if kind == Optimizer.ADAGRAD:
        acc = state["acc"].astype(jnp.float32) + g * g  # untouched entries add 0
        new_table = table - (lr * g / jnp.sqrt(acc + _ADAGRAD_EPS)).astype(dt)
        return new_table, {"acc": acc.astype(st["acc"])}
    else:  # lazy Adam: moments of untouched entries are not decayed
        m_new = _ADAM_B1 * state["m"].astype(jnp.float32) + (1.0 - _ADAM_B1) * g
        v_new = _ADAM_B2 * state["v"].astype(jnp.float32) + (1.0 - _ADAM_B2) * (g * g)
        m = jnp.where(t_mask, m_new, state["m"].astype(jnp.float32))
        v = jnp.where(t_mask, v_new, state["v"].astype(jnp.float32))
        t = step.astype(jnp.float32) + 1.0
        m_hat = m / (1.0 - _ADAM_B1**t)
        v_hat = v / (1.0 - _ADAM_B2**t)
        new_table = table - jnp.where(
            t_mask, lr * m_hat / (jnp.sqrt(v_hat) + _ADAM_EPS), 0.0
        ).astype(dt)
        return new_table, {"m": m.astype(st["m"]), "v": v.astype(st["v"])}


# ---------------------------------------------------------------------------
# Sparse update (embedding tables / bias vectors)
# ---------------------------------------------------------------------------


def sparse_update(
    kind: Optimizer,
    lr: float,
    l2: float,
    table: jnp.ndarray,
    state: dict,
    dd: DedupedRows,
    summed_grads: jnp.ndarray,
    step: jnp.ndarray,
    bias_valid: "jnp.ndarray | None" = None,
) -> Tuple[jnp.ndarray, dict]:
    """Apply an optimizer step to the unique touched rows of ``table``.

    ``summed_grads``: per-unique-row gradient from :func:`segment_sum_grads`,
    shape ``[M, ...]`` matching ``table[row]`` trailing dims.

    ``bias_valid`` (fused tables): per-unique-row bool — the row's LAST
    (bias) column received a gradient. Rows valid but not bias-valid get no
    L2/state/step on that column (see :func:`dense_row_update`).
    """
    was_1d = table.ndim == 1
    if was_1d:
        table2 = table[:, None]
        sg = summed_grads[:, None]
        state2 = {k: v[:, None] for k, v in state.items()}
    else:
        table2 = table
        sg = summed_grads
        state2 = state

    # Row math in f32; scatter deltas are cast to the storage dtype (bf16
    # tables supported for HBM-bound catalogs).
    dt = table2.dtype
    valid = dd.valid
    vcol = valid[:, None].astype(jnp.float32)
    # NOTE: no unique_indices/indices_are_sorted hints on these gathers.
    # dedupe_and_sum's fused layout interleaves the num_rows sentinel at
    # every non-run-end position (e.g. [N, 2, N, 5]), so row_ids are
    # neither sorted nor unique — asserting the hints is implementation-
    # defined in XLA and steers the SPMD partitioner's gather strategy on
    # sharded tables.
    w_rows = jnp.take(table2, dd.row_ids, axis=0, mode="clip").astype(jnp.float32)
    if bias_valid is None:
        mcol = vcol
    else:
        # Column-wise validity: bias column only where the bias saw a grad.
        mcol = jnp.concatenate(
            [
                jnp.broadcast_to(vcol, (vcol.shape[0], w_rows.shape[1] - 1)),
                (valid & bias_valid)[:, None].astype(jnp.float32),
            ],
            axis=1,
        )
    g = sg + l2 * w_rows * mcol

    if kind == Optimizer.ADAGRAD:
        acc_rows = jnp.take(state2["acc"], dd.row_ids, axis=0, mode="clip").astype(jnp.float32)
        acc_new = acc_rows + g * g
        upd = lr * g / jnp.sqrt(acc_new + _ADAGRAD_EPS)
        new_table2 = table2.at[dd.row_ids].add((-upd * mcol).astype(dt), mode="drop")
        new_acc = state2["acc"].at[dd.row_ids].add(
            (g * g * mcol).astype(state2["acc"].dtype), mode="drop"
        )
        new_state2 = {"acc": new_acc}
    else:  # lazy Adam
        m_rows = jnp.take(state2["m"], dd.row_ids, axis=0, mode="clip").astype(jnp.float32)
        v_rows = jnp.take(state2["v"], dd.row_ids, axis=0, mode="clip").astype(jnp.float32)
        m_new = _ADAM_B1 * m_rows + (1.0 - _ADAM_B1) * g
        v_new = _ADAM_B2 * v_rows + (1.0 - _ADAM_B2) * (g * g)
        t = step.astype(jnp.float32) + 1.0
        m_hat = m_new / (1.0 - _ADAM_B1**t)
        v_hat = v_new / (1.0 - _ADAM_B2**t)
        upd = lr * m_hat / (jnp.sqrt(v_hat) + _ADAM_EPS)
        new_table2 = table2.at[dd.row_ids].add((-upd * mcol).astype(dt), mode="drop")
        # Deduped rows are unique, so set == overwrite with the new moment;
        # entries outside the column mask keep their old moments (no decay),
        # matching wyrm's untouched-parameter behavior.
        new_m = state2["m"].at[dd.row_ids].add(
            ((m_new - m_rows) * mcol).astype(state2["m"].dtype), mode="drop"
        )
        new_v = state2["v"].at[dd.row_ids].add(
            ((v_new - v_rows) * mcol).astype(state2["v"].dtype), mode="drop"
        )
        new_state2 = {"m": new_m, "v": new_v}

    if was_1d:
        new_table = new_table2[:, 0]
        new_state = {k: v[:, 0] for k, v in new_state2.items()}
        return new_table, new_state
    return new_table2, new_state2
