"""Criterion-equivalent microbenchmarks: LSTM and EWMA ``fit`` wall time.

Mirrors the reference's bench config exactly (``benches/benchmark.rs:26-70``):
a 10,000-interaction random sample of Movielens 100K, dim=32,
max_seq_len=128, Hinge, Adagrad, lr=0.16, l2=4e-4, 3 epochs, sample_size=10
timed iterations (plus warm-up, which also absorbs XLA compilation, the
analogue of criterion's warm-up phase).

Usage::

    python benches/benchmark.py [lstm] [ewma] [attention] [gru]

``attention`` (no reference counterpart) runs the same config on the
causal-transformer tower for a same-workload comparison.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu as sbr
from sbr_rs_tpu.models import Loss, Optimizer, attention, ewma, gru, lstm

SAMPLE_SIZE = 10
FAMILIES = {
    "lstm": lstm.Hyperparameters,
    "ewma": ewma.Hyperparameters,
    "attention": attention.Hyperparameters,
    "gru": gru.Hyperparameters,
}


def load_movielens_sample(sample_size: int = 10_000):
    data, source = sbr.datasets.movielens_100k()
    print(source)
    idx = np.random.default_rng(0).choice(len(data), size=sample_size, replace=False)
    return sbr.data.Interactions(
        data.num_users,
        data.num_items,
        data.user_ids[idx],
        data.item_ids[idx],
        data.timestamps[idx],
    ).to_compressed()


def build(family: str, num_items: int):
    hp_cls = FAMILIES[family]
    return (
        hp_cls(num_items, 128)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(3)
        .from_seed(0)
        .build()
    )


def bench(family: str) -> None:
    data = load_movielens_sample()
    model = build(family, data.num_items)
    model.fit(data)  # warm-up + compile
    times = []
    for _ in range(SAMPLE_SIZE):
        t0 = time.perf_counter()
        model.fit(data)
        times.append(time.perf_counter() - t0)
    mean = statistics.mean(times)
    std = statistics.stdev(times) if len(times) > 1 else 0.0
    print(
        f"{family}: mean={mean * 1e3:.1f}ms std={std * 1e3:.1f}ms "
        f"min={min(times) * 1e3:.1f}ms max={max(times) * 1e3:.1f}ms "
        f"(n={SAMPLE_SIZE})"
    )


if __name__ == "__main__":
    from sbr_rs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    targets = sys.argv[1:] or ["lstm", "ewma"]
    for family in targets:
        bench(family)
