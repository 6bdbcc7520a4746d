"""Evaluation: mean reciprocal rank over full-catalog scoring.

Reference: ``src/evaluation.rs:12-48`` — for every test user with >= 2
interactions, build a representation from all-but-the-last item, score the
*entire catalog*, mask already-seen items to ``f32::MIN``, and rank the held
-out item counting ties against the model (``prediction >= test_score``
includes the item itself, so rank >= 1); MRR is the mean of ``1/rank``.

The reference parallelizes with rayon threads, each scoring the catalog one
SIMD dot at a time. Here users are batched and the catalog is scored as a
``[U, D] @ [D, I]`` matrix product, streamed in item chunks so that
arbitrarily large (sharded) catalogs never materialize ``[U, I]`` at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .data import CompressedInteractions
from .errors import InvalidPredictionValue
from .models.base import ImplicitSequenceModel
from .ops.scoring import SCORE_PRECISION, score_rows

_NEG_MIN = float(np.finfo(np.float32).min)

_USER_BATCH = 512
_ITEM_CHUNK = 65536


def _count_slab(table, reps, prefix, test_items, targets, base, chunk, num_chunks):
    """Per-user counts of items scoring ``>=`` the target among the rows
    ``[base, base + len(table))`` that ``table`` holds, streamed in chunks of
    ``chunk`` rows by a ``fori_loop`` on device, and whether the held-out
    item counted itself."""
    u = reps.shape[0]
    n_rows = table.shape[0]

    def body(c, carry):
        counts, self_hits = carry
        # The FINAL chunk's start is clamped so the slice fits,
        # overlapping the previous chunk; ``col_lo`` excludes the
        # already-counted overlap columns.
        lo = jnp.minimum(c * chunk, n_rows - chunk)
        col_lo = c * chunk - lo
        # Slice INSIDE the compiled program — an eager slice would copy
        # the chunk out of the (potentially huge) table per user batch;
        # no catalog-sized pad/copy is ever built.
        table_chunk = jax.lax.dynamic_slice_in_dim(table, lo, chunk, axis=0)
        # scores for this slab of the catalog: [U, C]
        # Full float32 (see scoring.SCORE_PRECISION): ranks count exact
        # `>=` comparisons against the target.
        scores = score_rows(reps, table_chunk)
        rows = jnp.arange(u)[:, None]
        # Mask seen items that fall in this chunk. Indices from other
        # chunks must be remapped out-of-bounds *positively* before the
        # drop-mode scatter — negative indices wrap NumPy-style instead
        # of dropping. (Re-masking a seen item that also sits in the
        # overlap region is harmless: overlap columns are excluded from
        # the count anyway.)
        prefix_local = prefix - base - lo
        prefix_local = jnp.where(prefix_local < 0, chunk, prefix_local)
        scores = scores.at[rows, prefix_local].set(_NEG_MIN, mode="drop")
        # Each real item is counted by exactly ONE chunk window.
        col_ok = jnp.arange(chunk) >= col_lo
        cnt = jnp.sum(
            ((scores >= targets[:, None]) & col_ok[None, :]).astype(jnp.int32),
            axis=1,
        )
        # The held-out item's own comparison must use the *chunk's*
        # score (the separately-computed target can differ by float
        # rounding); track whether it self-counted so the caller can
        # replace that contribution with the reference's unconditional
        # self-tie (rank includes the item itself,
        # `src/evaluation.rs:37-41`).
        test_local = test_items - base - lo
        in_window = (test_local >= col_lo) & (test_local < chunk)
        self_score = scores[jnp.arange(u), jnp.clip(test_local, 0, chunk - 1)]
        sh = (in_window & (self_score >= targets)).astype(jnp.int32)
        return counts + cnt, self_hits + sh

    return jax.lax.fori_loop(
        0,
        num_chunks,
        body,
        (jnp.zeros((u,), jnp.int32), jnp.zeros((u,), jnp.int32)),
    )


@functools.lru_cache(maxsize=None)
def _make_catalog_counter(chunk: int, num_chunks: int, mesh=None):
    """One compiled program per (chunk, catalog) shape that targets + counts
    the WHOLE catalog: the chunk loop runs as a ``fori_loop`` on device, so
    a user batch costs ONE dispatch instead of ``1 + num_chunks`` (153
    chunks per 512 users at 10M items).

    Over a row-sharded table (``mesh`` with a model axis) every shard
    counts its own slab under ``jax.shard_map`` and one ``psum`` adds the
    counts: a chunk slice of the sharded table would otherwise make XLA
    gather the whole table onto every device. The slabs are equal: a model
    refuses a mesh whose model axis does not divide its catalog."""
    from .parallel.mesh import MODEL_AXIS

    ns = mesh.shape.get(MODEL_AXIS, 1) if mesh is not None else 1

    def count_catalog(table, reps, prefix, test_items, test_in_prefix):
        # Masked score of each user's held-out item (MIN if it was already
        # seen, matching the mask-then-read order of
        # ``src/evaluation.rs:30-34``).
        rows_t = jnp.take(table, test_items, axis=0)
        raw = jnp.einsum(
            "ud,ud->u", reps, rows_t[:, :-1], precision=SCORE_PRECISION
        ) + rows_t[:, -1]
        targets = jnp.where(test_in_prefix, _NEG_MIN, raw)

        if ns == 1:
            counts, self_hits = _count_slab(
                table, reps, prefix, test_items, targets, 0, chunk, num_chunks
            )
            return counts, self_hits, targets

        n_loc = table.shape[0] // ns
        c_loc = min(chunk, n_loc)
        P = jax.sharding.PartitionSpec

        def shard_count(table_loc, reps, prefix, test_items, targets):
            base = jax.lax.axis_index(MODEL_AXIS) * n_loc
            counts, self_hits = _count_slab(
                table_loc, reps, prefix, test_items, targets, base, c_loc,
                -(-n_loc // c_loc),
            )
            return (
                jax.lax.psum(counts, MODEL_AXIS),
                jax.lax.psum(self_hits, MODEL_AXIS),
            )

        counts, self_hits = jax.shard_map(
            shard_count,
            mesh=mesh,
            in_specs=(P(MODEL_AXIS, None), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )(table, reps, prefix, test_items, targets)
        return counts, self_hits, targets

    if mesh is not None:
        # Replicated outputs: multi-controller runs fetch them with
        # np.asarray on every process.
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        return jax.jit(count_catalog, out_shardings=repl)
    return jax.jit(count_catalog)


def mrr_score(model, test: CompressedInteractions) -> float:
    """Compute MRR of next-item predictions (reference ``src/evaluation.rs:12``)."""
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    return float(np.mean(1.0 / ranks.astype(np.float64)))


def hit_rate_score(model, test: CompressedInteractions, k: int = 10) -> float:
    """Fraction of held-out items ranked in the top ``k`` (hit rate @ k).

    Same protocol as :func:`mrr_score` (full-catalog scoring, seen-item
    masking, ties count against — no reference counterpart, which only
    reports MRR): a "hit" is ``rank <= k`` for the user's single held-out
    next item, so this is also recall@k for the next-item task.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    return float(np.mean(ranks <= k))


def ndcg_score(model, test: CompressedInteractions, k: int = 10) -> float:
    """NDCG @ ``k`` for the single held-out next item.

    Same protocol as :func:`mrr_score` (full-catalog scoring, seen-item
    masking, ties count against — no reference counterpart): with one
    relevant item the ideal DCG is 1, so the score is the mean of
    ``1 / log2(1 + rank)`` for ranks within ``k`` and 0 otherwise. Shares
    the streamed-rank pass with the other metrics (``_ranks``)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ranks = _ranks(model, test)
    if ranks.size == 0:
        return float("nan")
    r = ranks.astype(np.float64)
    return float(np.mean(np.where(r <= k, 1.0 / np.log2(1.0 + r), 0.0)))


def _ranks(model, test: CompressedInteractions) -> np.ndarray:
    """Rank of each qualifying test user's held-out item (1 = top)."""
    if isinstance(model, ImplicitSequenceModel):
        return _ranks_batched(model, test)
    return _ranks_generic(model, test)


def _ranks_batched(model: ImplicitSequenceModel, test: CompressedInteractions) -> np.ndarray:
    num_items = test.num_items
    users = [u for u in test.iter_users() if len(u) >= 2]
    if not users:
        return np.zeros((0,), dtype=np.int64)

    prefixes = [u.item_ids[:-1] for u in users]
    test_items_all = np.array([u.item_ids[-1] for u in users], dtype=np.int32)

    table = model._params["item_table"]

    item_chunk = min(_ITEM_CHUNK, num_items)
    num_chunks = -(-num_items // item_chunk)

    # Pad prefix lists to a common length, in fixed buckets to bound the
    # number of compiled shapes. Pad value num_items → dropped by scatter.
    max_prefix = max(len(p) for p in prefixes)
    p_pad = 1
    while p_pad < max_prefix:
        p_pad *= 2

    mesh = model.hyper._mesh

    # One compiled shape per call: every user batch is padded to the same
    # width (the final partial batch used to cost one extra compile of the
    # whole chunk counter per distinct remainder). Small test sets bucket to
    # the next power of two so repeated calls reuse programs too.
    if len(users) >= _USER_BATCH:
        u_pad = _USER_BATCH
    else:
        u_pad = 1
        while u_pad < len(users):
            u_pad *= 2

    count_catalog = _make_catalog_counter(item_chunk, num_chunks, mesh)

    all_ranks = []
    for start in range(0, len(users), _USER_BATCH):
        batch_prefixes = prefixes[start : start + _USER_BATCH]
        test_items = test_items_all[start : start + _USER_BATCH]
        u = len(batch_prefixes)
        if u < u_pad:
            # Padding users: empty history (scored as item-0 history), item 0
            # held out; their reciprocal ranks are dropped below.
            batch_prefixes = batch_prefixes + [[]] * (u_pad - u)
            test_items = np.concatenate(
                [test_items, np.zeros(u_pad - u, dtype=test_items.dtype)]
            )

        prefix_arr = np.full((u_pad, p_pad), num_items, dtype=np.int32)
        test_in_prefix = np.zeros((u_pad,), dtype=bool)
        for i, p in enumerate(batch_prefixes[:u]):
            # Distinct seen ids (the scatter masks a repeated item at the
            # same position anyway).
            q = np.unique(np.asarray(p, dtype=np.int32))
            prefix_arr[i, : len(q)] = q
            test_in_prefix[i] = test_items[i] in p

        reps = model._representations(batch_prefixes)
        if not np.all(np.isfinite(reps)):
            raise InvalidPredictionValue()

        from .models.base import _replicated_put

        reps_j = _replicated_put(mesh, reps.astype(np.float32))
        counts, self_hits, targets = count_catalog(
            table,
            reps_j,
            _replicated_put(mesh, prefix_arr),
            _replicated_put(mesh, test_items),
            _replicated_put(mesh, test_in_prefix),
        )
        # A non-finite target (out-of-range test item — jnp.take fills OOB
        # gathers with NaN — or a corrupted/overflowed table) would fake a
        # near-perfect rank; surface it like the generic path does
        # (reference raises on non-finite predictions,
        # src/models/sequence_model.rs:225-229). The legitimate masked
        # value is float32-min — finite.
        if not np.isfinite(np.asarray(targets)).all():
            raise InvalidPredictionValue(
                "Non-finite target scores during MRR evaluation (out-of-range "
                "test items or non-finite parameters)."
            )

        # rank = 1 (the item itself, ties-count-against) + other items >= it.
        ranks = 1 + np.asarray(counts) - np.asarray(self_hits)
        all_ranks.append(ranks[:u].astype(np.int64))  # drop padding users

    return np.concatenate(all_ranks)


def _ranks_generic(model, test: CompressedInteractions) -> np.ndarray:
    """Fallback for any object implementing the OnlineRankingModel protocol
    (``user_representation`` + ``predict``), mirroring the reference's
    per-user loop exactly."""
    item_ids = np.arange(test.num_items)
    ranks = []
    for user in test.iter_users():
        if len(user) < 2:
            continue
        train_items = user.item_ids[:-1]
        test_item = int(user.item_ids[-1])
        rep = model.user_representation(train_items)
        predictions = np.array(model.predict(rep, item_ids), dtype=np.float32)
        predictions[train_items] = _NEG_MIN
        test_score = predictions[test_item]
        ranks.append(int(np.sum(predictions >= test_score)))
    return np.asarray(ranks, dtype=np.int64)
