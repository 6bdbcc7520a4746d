"""MRR evaluation tests: exact semantics + batched/generic agreement."""

import numpy as np
import pytest

import sbr_rs_tpu as sbr
from sbr_rs_tpu import data as D
from sbr_rs_tpu import evaluation
from sbr_rs_tpu.models import ImplicitUser, ewma


class _StubModel:
    """Deterministic model for pinning MRR semantics via the generic path:
    score(item) = -item_id (item 0 always ranks first)."""

    def user_representation(self, item_ids):
        return ImplicitUser(user_embedding=np.zeros(2, np.float32))

    def predict(self, user, item_ids):
        return -np.asarray(item_ids, dtype=np.float32)


def test_generic_mrr_semantics():
    """Users each with history [3, 2] and test item varying; catalog size 5,
    scores = [0,-1,-2,-3,-4]; seen items masked to MIN.

    user A: history=[1], test=0 -> masked {1}; 0 is top -> rank 1
    user B: history=[0], test=2 -> masked {0}; remaining order 1,2,3,4 ->
            rank of 2 = 2
    """
    inter = D.Interactions.from_arrays(
        np.array([0, 0, 1, 1]),
        np.array([1, 0, 0, 2]),
        np.array([0, 1, 0, 1]),
        num_users=2,
        num_items=5,
    )
    mrr = evaluation.mrr_score(_StubModel(), inter.to_compressed())
    assert abs(mrr - (1.0 + 0.5) / 2) < 1e-6


def test_test_item_in_history_gets_catalog_rank():
    """If the held-out item was already seen, it is masked to MIN and rank
    ~= catalog size (reference masks before reading the test score,
    `src/evaluation.rs:30-34`)."""
    inter = D.Interactions.from_arrays(
        np.array([0, 0, 0]),
        np.array([1, 2, 1]),  # test item 1 already in history
        np.array([0, 1, 2]),
        num_users=1,
        num_items=4,
    )
    mrr = evaluation.mrr_score(_StubModel(), inter.to_compressed())
    assert abs(mrr - 1.0 / 4.0) < 1e-6


def _toy(num_users=40, num_items=30, seq_len=10, seed=0):
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(num_users), seq_len)
    items = rng.integers(0, num_items, num_users * seq_len)
    ts = np.tile(np.arange(seq_len), num_users)
    return D.Interactions.from_arrays(users, items, ts, num_users, num_items)


def _seen_heavy(num_users=40, num_items=5000):
    """Random histories where every fifth held-out item is already in the
    prefix and every third prefix repeats an item."""
    rng = np.random.default_rng(0)
    users, items, ts = [], [], []
    for u in range(num_users):
        h = rng.integers(0, num_items, int(rng.integers(3, 10))).tolist()
        if u % 5 == 0:
            h[-1] = h[0]  # held-out item in the prefix
        if u % 3 == 0 and len(h) > 2:
            h[1] = h[0]  # duplicate seen item
        users += [u] * len(h)
        items += h
        ts += list(range(len(h)))
    return D.Interactions.from_arrays(
        np.asarray(users), np.asarray(items), np.asarray(ts), num_users, num_items
    )


@pytest.mark.parametrize(
    "make,item_chunk",
    [
        (_toy, None),
        # streamed: 3 chunks of 2048 with a clamped tail, duplicate seen
        # items and held-out items that were already seen
        (_seen_heavy, 2048),
    ],
)
def test_batched_matches_generic(monkeypatch, make, item_chunk):
    """The chunked/batched fast path must agree with the reference-shaped
    per-user loop on a real fitted model."""
    inter = make().to_compressed()
    model = (
        ewma.Hyperparameters(inter.num_items, 8)
        .num_epochs(1)
        .from_seed(0)
        .build()
    )
    model.fit(inter)
    if item_chunk is not None:
        monkeypatch.setattr(evaluation, "_ITEM_CHUNK", item_chunk)
    fast = evaluation._ranks_batched(model, inter)
    slow = evaluation._ranks_generic(model, inter)
    # Rank-level agreement is stricter than the old MRR-level check; a
    # float-rounding rank difference on a near-tie would still show as
    # <1e-4 in MRR but fails here.
    np.testing.assert_array_equal(fast, slow)


def test_batched_chunking_invariance(monkeypatch):
    """Chunked catalog streaming must not change the result."""
    inter = _toy().to_compressed()
    model = (
        ewma.Hyperparameters(inter.num_items, 8)
        .num_epochs(1)
        .from_seed(0)
        .build()
    )
    model.fit(inter)
    full = evaluation._ranks_batched(model, inter)
    monkeypatch.setattr(evaluation, "_ITEM_CHUNK", 7)
    monkeypatch.setattr(evaluation, "_USER_BATCH", 13)
    chunked = evaluation._ranks_batched(model, inter)
    np.testing.assert_array_equal(full, chunked)


def test_users_with_single_item_skipped():
    inter = D.Interactions.from_arrays(
        np.array([0, 1, 1, 1]),
        np.array([1, 0, 2, 3]),
        np.array([0, 0, 1, 2]),
        num_users=2,
        num_items=5,
    )
    # user 0 has a single interaction -> excluded from MRR
    mrr = evaluation.mrr_score(_StubModel(), inter.to_compressed())
    # user 1: history [0, 2], test 3; masked {0, 2} -> order 1,3,4 -> rank 2...
    # scores: 1 -> -1, 3 -> -3, 4 -> -4 ; test score -3; >= -3: items 1, 3 -> rank 2
    assert abs(mrr - 0.5) < 1e-6


def test_single_compile_across_partial_batches(monkeypatch):
    """The final partial user batch must NOT cost an extra compile of the
    chunk counter: every batch is padded to one width (VERDICT r1 item 9)."""
    from sbr_rs_tpu import evaluation as E

    monkeypatch.setattr(E, "_USER_BATCH", 16)
    rng = np.random.default_rng(0)
    num_users, num_items = 40, 30  # 16 + 16 + partial 8 -> all padded to 16
    lengths = rng.integers(2, 8, num_users)
    inter = D.Interactions.from_arrays(
        np.repeat(np.arange(num_users), lengths),
        rng.integers(0, num_items, int(lengths.sum())),
        np.concatenate([np.arange(l) for l in lengths]),
        num_users,
        num_items,
    ).to_compressed()

    from sbr_rs_tpu.models import ewma

    model = (
        ewma.Hyperparameters(num_items, 8).embedding_dim(16).num_epochs(1)
        .batch_size(8).from_seed(0).build()
    )
    model.fit(inter)

    chunk = min(E._ITEM_CHUNK, num_items)
    counter = E._make_catalog_counter(chunk, -(-num_items // chunk), None)
    before = counter._cache_size()
    mrr = E.mrr_score(model, inter)
    assert np.isfinite(mrr)
    added = counter._cache_size() - before
    assert added == 1, f"expected ONE catalog-counter compile, got {added}"


def test_hit_rate_semantics():
    """Same fixture as test_generic_mrr_semantics: ranks are [1, 2], so
    hit_rate@1 = 0.5 and hit_rate@2 = 1.0."""
    inter = D.Interactions.from_arrays(
        np.array([0, 0, 1, 1]),
        np.array([1, 0, 0, 2]),
        np.array([0, 1, 0, 1]),
        num_users=2,
        num_items=5,
    )
    comp = inter.to_compressed()
    assert abs(evaluation.hit_rate_score(_StubModel(), comp, k=1) - 0.5) < 1e-6
    assert abs(evaluation.hit_rate_score(_StubModel(), comp, k=2) - 1.0) < 1e-6


def test_hit_rate_batched_matches_generic():
    inter = _toy().to_compressed()
    model = (
        ewma.Hyperparameters(inter.num_items, 8)
        .num_epochs(1)
        .from_seed(0)
        .build()
    )
    model.fit(inter)
    for k in (1, 5, inter.num_items):
        fast = evaluation.hit_rate_score(model, inter, k=k)

        class _Wrap:
            user_representation = model.user_representation
            predict = model.predict

        slow = evaluation.hit_rate_score(_Wrap(), inter, k=k)
        assert abs(fast - slow) < 1e-9, k
    # every held-out item is somewhere in the catalog
    assert evaluation.hit_rate_score(model, inter, k=inter.num_items) == 1.0


def test_hit_rate_k_validation():
    import pytest

    with pytest.raises(ValueError):
        evaluation.hit_rate_score(_StubModel(), _toy().to_compressed(), k=0)


def test_ndcg_semantics():
    """Same fixture as test_generic_mrr_semantics: ranks are [1, 2], so
    ndcg@1 = (1 + 0)/2 and ndcg@2 = (1 + 1/log2(3))/2."""
    inter = D.Interactions.from_arrays(
        np.array([0, 0, 1, 1]),
        np.array([1, 0, 0, 2]),
        np.array([0, 1, 0, 1]),
        num_users=2,
        num_items=5,
    )
    comp = inter.to_compressed()
    assert abs(evaluation.ndcg_score(_StubModel(), comp, k=1) - 0.5) < 1e-9
    want = (1.0 + 1.0 / np.log2(3.0)) / 2.0
    assert abs(evaluation.ndcg_score(_StubModel(), comp, k=2) - want) < 1e-9
    import pytest

    with pytest.raises(ValueError):
        evaluation.ndcg_score(_StubModel(), comp, k=0)


def test_ndcg_batched_matches_generic():
    inter = _toy().to_compressed()
    model = (
        ewma.Hyperparameters(inter.num_items, 8)
        .num_epochs(1)
        .from_seed(0)
        .build()
    )
    model.fit(inter)
    for k in (1, 5, inter.num_items):
        fast = evaluation.ndcg_score(model, inter, k=k)

        class _Wrap:
            user_representation = model.user_representation
            predict = model.predict

        slow = evaluation.ndcg_score(_Wrap(), inter, k=k)
        assert abs(fast - slow) < 1e-9, k
