"""Catalog scoring for serving and evaluation.

Serving and MRR evaluation score the catalog against a batch of user
representations (the batched replacement for the reference's per-item
``simd_dot`` loops, ``src/models/sequence_model.rs:213-232`` and
``src/evaluation.rs:12-48``). The streamed exact top-k
(``models/base.py:_build_topk_fn``) does so a chunk at a time and keeps
only group maxima for its phase 1.

Every scoring dot runs in full float32. At XLA's default a float32 matrix
product may run in TF32 on a GPU (about three decimal digits), which
breaks the exact top-k and the ties-count-against ranks: on an H100, TF32
scores reordered top-10 lists and moved eval ranks by up to 90.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SCORE_PRECISION = jax.lax.Precision.HIGHEST


def score_rows(reps: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """``[U, N]`` scores ``reps @ emb.T + bias`` of fused ``[N, D+1]``
    ``[embedding | bias]`` rows."""
    return jnp.dot(reps, rows[:, :-1].T, precision=SCORE_PRECISION) + rows[:, -1]


def score_groupmax(
    chunk_rows: jnp.ndarray,
    reps_aug: jnp.ndarray,
    lo,
    n: int,
    group: int,
) -> jnp.ndarray:
    """``[C / group, U]`` group maxima of a chunk's scores.

    ``chunk_rows`` is a ``[C, Cc]`` slab of the fused ``[embedding | bias]``
    table (rows past the catalog end are clip-duplicates, masked here by
    global id), ``reps_aug`` is ``[U, Cc]`` bias-augmented float32
    representations (a trailing 1 dots the bias in), ``lo`` the chunk's
    first global row id (traced ok), ``n`` the catalog size. Scores are
    one float32 contraction of whole fused rows, laid out ``[C, U]`` so
    that contiguous groups of rows reduce along the leading axis. Phase 2
    re-scores only the groups selected here, so maxima at a lower
    precision could drop a group that holds a true top-k item.
    """
    c = chunk_rows.shape[0]
    u = reps_aug.shape[0]
    st = jax.lax.dot_general(
        chunk_rows.astype(jnp.float32),
        reps_aug.astype(jnp.float32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=SCORE_PRECISION,
        preferred_element_type=jnp.float32,
    )  # [C, U]
    ids = lo + jnp.arange(c)
    st = jnp.where((ids < n)[:, None], st, -jnp.inf)
    return jnp.max(st.reshape(c // group, group, u), axis=1)
