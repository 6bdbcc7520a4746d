"""Large-scale benchmark configs (BASELINE.json configs[2..4]).

The reference has nothing at this scale — these measure the capabilities
layered on top of its semantics:

* ``ml1m``   — ML-1M-shaped synthetic data (6040 users x 3706 items x ~1M
  interactions), coupled-gate LSTM dim=128, Hinge, Adam, packed
  variable-length sequences (BASELINE config[2]).
* ``items2m`` / ``items10m`` — synthetic long-tail catalogs with an LSTM
  of dim 256 (``items10m``: 127), WARP, sparse (touched-rows-only)
  optimizer updates (BASELINE config[3]).

The sharded-table path over several cards is exercised by
``python chip_smoke.py --cards 4``.

Usage: python benches/large_scale.py [ml1m items2m items10m ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _examples_per_sec(model, mat):
    model.fit(mat)  # warm-up + compile
    t0 = time.perf_counter()
    model.fit(mat)
    wall = time.perf_counter() - t0
    return model.history.total_examples / wall, wall


def bench_ml1m():
    import sbr_rs_tpu as sbr
    from sbr_rs_tpu.models import Loss, Optimizer, lstm

    data = sbr.datasets.synthetic_interactions(6040, 3706, 165, rng=0)
    mat = data.to_compressed()
    model = (
        lstm.Hyperparameters(data.num_items, 128)
        .embedding_dim(128)
        .learning_rate(0.05)
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAM)
        .lstm_variant(lstm.LSTMVariant.COUPLED)
        .num_epochs(1)
        .batch_size(256)
        .packed(True)
        .from_seed(0)
        .build()
    )
    eps, wall = _examples_per_sec(model, mat)
    # "ml1m_shaped": ML-1M's user/item/interaction counts on synthetic
    # power-law data — the real dataset is unreachable without egress.
    return {"config": "ml1m_shaped_synthetic_packed_coupled_lstm128", "examples_per_sec": round(eps), "wall_s": round(wall, 2)}


def bench_items(num_items: int, name: str, dim: int = 256, dtype: str = "float32"):
    import sbr_rs_tpu as sbr
    from sbr_rs_tpu.models import Loss, Optimizer, lstm

    data = sbr.datasets.synthetic_interactions(20_000, num_items, 50, rng=0)
    mat = data.to_compressed()
    model = (
        lstm.Hyperparameters(num_items, 64)
        .embedding_dim(dim)
        .learning_rate(0.1)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(1)
        .batch_size(256)
        .packed(True)
        .sparse_updates(True)
        .table_dtype(dtype)
        .from_seed(0)
        .build()
    )
    eps, wall = _examples_per_sec(model, mat)

    # Full-catalog MRR at this scale: 512 users x num_items streamed-chunk
    # scoring. The chunk counter slices the table in place (no O(catalog)
    # copy per call).
    import sbr_rs_tpu.evaluation as evaluation

    test = sbr.datasets.synthetic_interactions(512, num_items, 20, rng=1).to_compressed()
    evaluation.mrr_score(model, test)  # warm/compile
    t0 = time.perf_counter()
    mrr = evaluation.mrr_score(model, test)
    eval_wall = time.perf_counter() - t0

    # Wide-batch eval: 4096 users, streamed 512 at a time.
    test_wide = sbr.datasets.synthetic_interactions(
        4096, num_items, 20, rng=2
    ).to_compressed()
    evaluation.mrr_score(model, test_wide)  # warm/compile
    t0 = time.perf_counter()
    evaluation.mrr_score(model, test_wide)
    eval_wide_wall = time.perf_counter() - t0

    return {
        "config": name,
        "examples_per_sec": round(eps),
        "wall_s": round(wall, 2),
        "mrr_eval_wall_s": round(eval_wall, 2),
        "mrr_eval_users": 512,
        "mrr_eval_wide_wall_s": round(eval_wide_wall, 2),
        "mrr_eval_wide_users": 4096,
        "mrr_eval_wide_us_per_user": round(eval_wide_wall / 4096 * 1e6, 1),
        "mrr": round(float(mrr), 5),
    }


BENCHES = {
    "ml1m": bench_ml1m,
    "items2m": lambda: bench_items(2_000_000, "synthetic_2m_items_lstm256_warp"),
    # D=127 makes the fused [N, D+1] row 128 floats (~10.2 GB with Adagrad
    # state at 10M rows).
    "items10m": lambda: bench_items(10_000_000, "synthetic_10m_items_lstm127_warp", dim=127),
    "items10m_256": lambda: bench_items(10_000_000, "synthetic_10m_items_lstm256_warp", dim=256),
    # bf16 table+state halves the memory: 20M x 128-float rows ≈ 10.2 GB.
    "items20m_bf16": lambda: bench_items(
        20_000_000, "synthetic_20m_items_lstm127_warp_bf16", dim=127, dtype="bfloat16"
    ),
}


if __name__ == "__main__":
    from sbr_rs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    targets = sys.argv[1:] or ["ml1m", "items2m"]
    for t in targets:
        print(json.dumps(BENCHES[t]()), flush=True)
