"""Quickstart: fit an LSTM ranking model on Movielens 100K and evaluate MRR.

Mirrors the reference's README example (``src/lib.rs:22-58``): load the
dataset, user-based split, fit an LSTM with WARP loss, score test MRR —
plus the serving path (encode a history, score candidates).

Runs on the ML-100K CSV when one is supplied (the path argument,
``$SBR_TPU_ML100K`` or the cache file) and otherwise on seeded data of
ML-100K's shape; the first output line says which.

Usage: python examples/quickstart.py [path/to/ml-100k.csv]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu as sbr
from sbr_rs_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    data, source = sbr.datasets.movielens_100k(sys.argv[1] if len(sys.argv) > 1 else None)
    print(source)
    enable_compile_cache()
    print(f"Loaded {len(data)} interactions: {data.num_users} users x {data.num_items} items")

    rng = np.random.default_rng(42)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()

    model = (
        sbr.models.lstm.Hyperparameters(data.num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .lstm_variant(sbr.models.lstm.LSTMVariant.NORMAL)
        .loss(sbr.models.Loss.WARP)
        .optimizer(sbr.models.Optimizer.ADAGRAD)
        .num_epochs(int(os.environ.get("SBR_QUICKSTART_EPOCHS", "10")))
        .batch_size(32)
        .from_seed(42)
        .build()
    )

    start = time.perf_counter()
    loss = model.fit(train_mat)
    print(f"Fit in {time.perf_counter() - start:.2f}s: mean loss {loss:.4f}")
    print(model.history.summary())

    mrr = sbr.evaluation.mrr_score(model, test_mat)
    print(f"Test MRR: {mrr:.4f}")

    # Serving: encode a user's history, score candidate items.
    history = test_mat.get_user(next(u.user_id for u in test_mat.iter_users() if len(u) >= 2))
    rep = model.user_representation(history.item_ids[:-1])
    candidates = [int(history.item_ids[-1]), 0, 1, 2]
    scores = model.predict(rep, candidates)
    for item, score in zip(candidates, scores):
        print(f"  item {item:5d}: {score:8.4f}")


if __name__ == "__main__":
    main()
