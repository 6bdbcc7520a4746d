"""Negative sampling: the WARP adaptive-selection rule.

Reference ``src/models/sequence_model.rs:47-68``: draw up to 5 uniform
negatives; accept the FIRST whose hinge margin is violated
(``1 - pos + neg > 0``); if none violates, keep the LAST draw (which then
contributes zero hinge loss — no gradient). The reference runs this as a
serial rejection loop with a dot product per draw; here all K candidate
scores are computed at once and the same rule is applied as a vectorized
argmax — identical selection distribution, parallel FLOPs.
"""

from __future__ import annotations

import jax.numpy as jnp

WARP_CANDIDATES = 5  # reference draws at most 5 (src/models/sequence_model.rs:58)


def warp_select(pos_scores: jnp.ndarray, cand_scores: jnp.ndarray) -> jnp.ndarray:
    """Index of the accepted candidate per position.

    ``pos_scores [...]``, ``cand_scores [..., K]`` → int32 ``[...]`` in
    ``[0, K)``: the first k with ``1 - pos + cand_k > 0``, else ``K - 1``.
    """
    k = cand_scores.shape[-1]
    viol = (1.0 - pos_scores[..., None] + cand_scores) > 0.0
    first = jnp.argmax(viol, axis=-1)
    return jnp.where(viol.any(axis=-1), first, k - 1).astype(jnp.int32)


def warp_select_onehot(
    pos_scores: jnp.ndarray, cand_scores: jnp.ndarray
) -> jnp.ndarray:
    """One-hot (float32, ``[..., K]``) of :func:`warp_select`'s choice.

    Same acceptance rule expressed without an argmax reduction or an
    index-vs-iota comparison: the first violator is "violates AND no prior
    violations" (an exclusive cumsum along K), falling back to the last
    draw when nothing violates. Everything is elementwise/cumsum — it fuses
    into the surrounding elementwise work, where the argmax+compare
    formulation costs reduction ops and layout copies.
    """
    k = cand_scores.shape[-1]
    viol = (1.0 - pos_scores[..., None] + cand_scores) > 0.0
    vi = viol.astype(jnp.float32)
    prior = jnp.cumsum(vi, axis=-1) - vi  # violations strictly before k
    first = vi * (prior == 0.0)
    none = 1.0 - jnp.max(vi, axis=-1, keepdims=True)
    last = jnp.zeros((k,), jnp.float32).at[-1].set(1.0)  # constant, folded
    return first + none * last
