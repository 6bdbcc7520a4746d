"""Streamed catalog scoring against float64 NumPy references: the phase-1
group maxima of the serving top-k (:func:`sbr_rs_tpu.ops.scoring.
score_groupmax`) and the streamed MRR rank counter
(``evaluation._make_catalog_counter``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sbr_rs_tpu import evaluation
from sbr_rs_tpu.ops.scoring import score_groupmax

_NEG_MIN = np.finfo(np.float32).min


def _mk(c, cc, u, n, dtype="float32", seed=0, lo=0):
    """A chunk of ``c`` fused-table rows starting at global row ``lo``,
    clip-gathered as the serving path builds it (rows past the catalog end
    duplicate the last row), and ``u`` bias-augmented representations."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, cc)).astype(np.float32)
    ids = np.minimum(lo + np.arange(c), n - 1)
    chunk = jnp.asarray(table[ids]).astype(dtype)
    reps = jnp.asarray(rng.normal(size=(u, cc)).astype(np.float32))
    return chunk, reps


def _groupmax64(chunk, reps, lo, n, group):
    """float64 reference: per-group maxima of [C, U] scores, rows past the
    catalog end at -inf."""
    rows = np.asarray(jnp.asarray(chunk, jnp.float32), np.float64)
    st = rows @ np.asarray(reps, np.float64).T
    ids = lo + np.arange(rows.shape[0])
    st = np.where((ids < n)[:, None], st, -np.inf)
    return st.reshape(rows.shape[0] // group, group, -1).max(axis=1)


def _close(got, want):
    got = np.asarray(got, np.float64)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("u", [1, 7, 512, 520])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [32, 128])
def test_groupmax_matches_xla(u, dtype, group):
    c, cc, n = 2048, 33, 3000  # lo + c > n exercises the catalog-end mask
    lo = 1024
    chunk, reps = _mk(c, cc, u, n, dtype=dtype, lo=lo)
    got = score_groupmax(chunk, reps, lo, n, group)
    assert got.shape == (c // group, u)
    _close(got, _groupmax64(chunk, reps, lo, n, group))


@pytest.mark.parametrize("group", [8, 16, 64, 128])
def test_groupmax_multiblock(group):
    # A chunk of many groups and a wide user batch; the sub-128 widths
    # feed the serving path's subgroup refinement.
    c, cc, u, n = 4096, 128, 1024, 100_000
    chunk, reps = _mk(c, cc, u, n)
    _close(score_groupmax(chunk, reps, 0, n, group), _groupmax64(chunk, reps, 0, n, group))


def test_groupmax_unsupported_shapes():
    # Output rows follow the group width; a group that does not divide
    # the chunk cannot be laid out and is refused.
    chunk, reps = _mk(2048, 33, 8, 100_000)
    for group in (8, 16, 128, 2048):
        assert score_groupmax(chunk, reps, 0, 100_000, group).shape == (2048 // group, 8)
    with pytest.raises(TypeError):
        score_groupmax(chunk, reps, 0, 100_000, 48)


@pytest.mark.parametrize("group", [32, 128])
def test_groupmax_ragged_mid_catalog(group):
    # A mid-catalog chunk (lo + c < n): nothing may be masked, every group
    # is finite and equals the reference.
    c, cc, u, n = 3072, 33, 16, 100_000
    lo = 4096
    chunk, reps = _mk(c, cc, u, n, seed=23, lo=lo)
    got = score_groupmax(chunk, reps, lo, n, group)
    assert np.all(np.isfinite(np.asarray(got)))
    _close(got, _groupmax64(chunk, reps, lo, n, group))


def _counter_case(n, chunk, u, seed, tie=False):
    """Run the streamed rank counter over an ``n``-item table in chunks of
    ``chunk`` and return (ranks, float64 reference ranks). Users carry
    prefixes with duplicates; every fifth user's held-out item is in its
    own prefix (target = the mask value)."""
    rng = np.random.default_rng(seed)
    d = 32
    table = rng.normal(size=(n, d + 1)).astype(np.float32)
    reps = rng.normal(size=(u, d)).astype(np.float32)
    test = rng.integers(0, n, u).astype(np.int32)
    prefixes = [rng.integers(0, n, int(rng.integers(1, 6))) for _ in range(u)]
    for i in range(0, u, 5):
        prefixes[i] = np.append(prefixes[i], test[i])
    if tie:  # an exact copy of each held-out row elsewhere: a tie at the target
        for i in range(u):
            dup = (int(test[i]) + n // 2) % n
            table[dup] = table[test[i]]
            prefixes[i] = prefixes[i][prefixes[i] != dup]
    p = max(len(q) for q in prefixes)
    prefix = np.full((u, p), n, np.int32)
    in_prefix = np.zeros(u, bool)
    for i, q in enumerate(prefixes):
        q = np.unique(q)
        prefix[i, : len(q)] = q
        in_prefix[i] = test[i] in q
    count = evaluation._make_catalog_counter(chunk, -(-n // chunk))
    counts, self_hits, _ = count(
        jnp.asarray(table), jnp.asarray(reps), jnp.asarray(prefix),
        jnp.asarray(test), jnp.asarray(in_prefix),
    )
    ranks = 1 + np.asarray(counts) - np.asarray(self_hits)

    s = table[:, :-1].astype(np.float64) @ reps.T.astype(np.float64) + table[:, -1:]
    s = s.T  # [U, N]
    want = np.zeros(u, np.int64)
    for i in range(u):
        row = s[i].copy()
        row[prefix[i][prefix[i] < n]] = _NEG_MIN
        want[i] = np.sum(row >= row[test[i]])
    return ranks, want


def test_count_ge_ragged_mid_catalog():
    # Chunks that do not divide the catalog: the last chunk is clamped and
    # overlaps its predecessor, whose columns must not count twice.
    got, want = _counter_case(n=2500, chunk=1024, u=8, seed=29)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("u", [5, 512])
def test_groupmax_whole_catalog_ragged(group, u):
    # The catalog's last chunk: c rows from lo, of which only n - lo are
    # real. Groups entirely past the catalog end come back -inf; the
    # straddling group keeps its real rows' maximum.
    c, cc, n = 2048, 65, 5000
    lo = 4096
    chunk, reps = _mk(c, cc, u, n, seed=11, lo=lo)
    got = np.asarray(score_groupmax(chunk, reps, lo, n, group))
    _close(got, _groupmax64(chunk, reps, lo, n, group))
    real = -(-(n - lo) // group)
    assert np.all(np.isfinite(got[:real])) and np.all(np.isneginf(got[real:]))


@pytest.mark.parametrize("sub,group", [(32, 128), (64, 128), (8, 32)])
@pytest.mark.parametrize("u", [5, 512])
def test_submax_groupmax_matches_xla(sub, group, u):
    # Two-level selection: subgroup maxima, and the group maxima derived
    # from them by the serving path's reshape, must equal both the direct
    # group maxima (exactly) and the float64 reference.
    c, cc, n = 4096, 65, 5000
    lo = 2048
    chunk, reps = _mk(c, cc, u, n, seed=17, lo=lo)
    smax = score_groupmax(chunk, reps, lo, n, sub)
    _close(smax, _groupmax64(chunk, reps, lo, n, sub))
    derived = jnp.max(smax.reshape(c // group, group // sub, u), axis=1)
    np.testing.assert_array_equal(
        np.asarray(derived), np.asarray(score_groupmax(chunk, reps, lo, n, group))
    )


@pytest.mark.parametrize("u", [3, 512])
def test_count_ge_whole_catalog_ragged(u):
    # Whole catalog in chunks, the final one clamped.
    got, want = _counter_case(n=4500, chunk=2048, u=u, seed=13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("u", [1, 5, 512])
def test_count_ge_matches_xla(u):
    # A single chunk covering the catalog, and the streamed chunks of it.
    one, want = _counter_case(n=3500, chunk=3500, u=u, seed=3)
    many, want2 = _counter_case(n=3500, chunk=512, u=u, seed=3)
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(many, want2)


def test_count_ge_ties_count():
    # Exact ties at the target count against the item (>=, the
    # reference's ties-against rule): each held-out row has a copy.
    got, want = _counter_case(n=2048, chunk=512, u=8, seed=5, tie=True)
    np.testing.assert_array_equal(got, want)
    in_prefix = np.zeros(8, bool)
    in_prefix[::5] = True
    assert np.all(want[~in_prefix] >= 2)


@pytest.mark.parametrize("sub,group", [(32, 128)])
def test_submax_groupmax_bf16_compute(sub, group):
    # A bfloat16 table: rows upcast to float32 before the dot, so the
    # maxima equal the float64 reference of the bf16-rounded rows and
    # differ from those of the float32 rows.
    c, cc, u, n = 4096, 65, 16, 5000
    chunk32, reps = _mk(c, cc, u, n, seed=31)
    chunk16 = chunk32.astype(jnp.bfloat16)
    got = score_groupmax(chunk16, reps, 0, n, sub)
    _close(got, _groupmax64(chunk16, reps, 0, n, sub))
    assert not np.allclose(np.asarray(got), np.asarray(score_groupmax(chunk32, reps, 0, n, sub)),
                           rtol=1e-6)
