"""Serving-path benchmarks: encode, batched top-k, single-query latency.

The reference's serving path builds a fresh autodiff graph per request and
scores the catalog one SIMD dot at a time (``src/models/sequence_model.rs:
180-233``); here encoding is one batched tower program and ranking is a
catalog matmul + device top-k. Measures on an ML-100K-trained LSTM-32:

* batched user encoding (users/s, batch 4096)
* batched recommend: encode + full-catalog score + seen-mask + top-10,
  end to end (users/s, batch 4096)
* single-user recommend latency (median)
* warm full-catalog MRR evaluation wall

Large-catalog targets (``items10m``, ``items20m_bf16``) measure the
streamed chunked top-k at the catalog scales the TRAINING path handles
(BASELINE config[3]): the serving program scores [U, D] @ [D, chunk] slabs
with a running top-k merge — a dense [U, N] score matrix would be ~160 GB
at U=4096, N=10M. Serving throughput does not depend on the table's
training state, so these skip the fit.

Usage: python benches/serving.py [ml100k items10m items20m_bf16 ...]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu as sbr
from sbr_rs_tpu.models import Loss, Optimizer, lstm


def bench_large(num_items: int, name: str, dim: int = 127, dtype: str = "float32") -> None:
    """Batched recommend at a huge catalog: encode + streamed chunked
    top-10 over ``num_items`` rows. dim=127 makes the fused [N, D+1] row
    128 floats."""
    import time as _time

    model = (
        lstm.Hyperparameters(num_items, 32)
        .embedding_dim(dim)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .table_dtype(dtype)
        .from_seed(42)
        .build()
    )
    rng = np.random.default_rng(7)
    u = 4096
    histories = [
        rng.integers(0, num_items, rng.integers(2, 32)).tolist() for _ in range(u)
    ]
    model.recommend_batch(histories, k=10)  # warm/compile
    best = float("inf")
    for _ in range(3):
        t0 = _time.perf_counter()
        recs = model.recommend_batch(histories, k=10)
        best = min(best, _time.perf_counter() - t0)
    assert len(recs) == u and len(set(recs[0])) == 10

    # Approximate mode (lax.approx_max_k PartialReduce): throughput and
    # MEASURED recall@10 against the exact results.
    model.recommend_batch(histories, k=10, approximate=True)  # warm
    best_apx = float("inf")
    for _ in range(3):
        t0 = _time.perf_counter()
        recs_apx = model.recommend_batch(histories, k=10, approximate=True)
        best_apx = min(best_apx, _time.perf_counter() - t0)
    recall = sum(
        len(set(a) & set(e)) for a, e in zip(recs_apx, recs)
    ) / (10.0 * u)

    print(
        json.dumps(
            {
                "config": name,
                "recommend_batch_users_per_sec": round(u / best, 1),
                "approx_users_per_sec": round(u / best_apx, 1),
                "approx_recall_at_10": round(recall, 4),
                "batch_users": u,
                "catalog_items": num_items,
                "table_dtype": dtype,
            }
        ),
        flush=True,
    )


def main() -> None:
    data, source = sbr.datasets.movielens_100k()
    print(source)
    rng = np.random.default_rng(42)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()

    model = (
        lstm.Hyperparameters(data.num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(10)
        .batch_size(256)
        .packed(True)
        .from_seed(42)
        .build()
    )
    model.fit(train_mat)

    u = 4096
    histories = [
        rng.integers(0, data.num_items, rng.integers(2, 32)).tolist()
        for _ in range(u)
    ]

    def best_of(fn, n=3):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    model.user_representations(histories)  # warm/compile
    t = best_of(lambda: model.user_representations(histories))
    encode_ups = u / t

    model.recommend_batch(histories, k=10)  # warm/compile
    t = best_of(lambda: model.recommend_batch(histories, k=10))
    recommend_ups = u / t

    model.recommend(histories[0], k=10)  # warm
    lat = [best_of(lambda: model.recommend(histories[0], k=10), n=1) for _ in range(30)]
    single_ms = statistics.median(lat) * 1e3

    sbr.evaluation.mrr_score(model, test_mat)  # warm
    eval_s = best_of(lambda: sbr.evaluation.mrr_score(model, test_mat))

    print(
        json.dumps(
            {
                "encode_users_per_sec": round(encode_ups),
                "recommend_batch_users_per_sec": round(recommend_ups),
                "recommend_single_ms_median": round(single_ms, 2),
                "mrr_eval_warm_s": round(eval_s, 3),
                "catalog_items": data.num_items,
            }
        )
    )


TARGETS = {
    "ml100k": main,
    "items10m": lambda: bench_large(10_000_000, "serving_10m_items_lstm127"),
    "items20m_bf16": lambda: bench_large(
        20_000_000, "serving_20m_items_lstm127_bf16", dtype="bfloat16"
    ),
}


if __name__ == "__main__":
    from sbr_rs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for t in sys.argv[1:] or ["ml100k"]:
        TARGETS[t]()
        # Release the previous target's device buffers AND compiled
        # programs before the next one allocates.
        import gc

        import jax as _jax

        _jax.clear_caches()
        gc.collect()
