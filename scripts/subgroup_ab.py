"""A/B the serving subgroup refinement on the card.

Phase 2 of the streamed exact top-k gathers random rows; the subgroup
refinement (models/base.py) keeps the phase-1 merge at group width 128
but picks the final kk candidate units at SUBGROUP width, cutting
phase-2 rows by group/sub. This script measures recommend_batch
wall at the serving-bench shape for sub in {128 (single-level baseline),
64, 32, 16} and verifies the returned id lists against the baseline.

Usage: python scripts/subgroup_ab.py [num_items] [dtype] [merge_budget_gb]

The optional third arg raises _MERGE_BUFFER_BYTES so bigger catalogs
(20M: maxima stack 5.1 GB) take the single-pass merge + refinement path
instead of the running merge — OOM here is a measurement, not a bug.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sbr_rs_tpu.models import lstm
from sbr_rs_tpu.models.base import ImplicitSequenceModel


def main() -> None:
    num_items = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    dtype = sys.argv[2] if len(sys.argv) > 2 else "float32"
    if len(sys.argv) > 3:
        ImplicitSequenceModel._MERGE_BUFFER_BYTES = (
            int(float(sys.argv[3])) << 30
        )

    model = (
        lstm.Hyperparameters(num_items, 32)
        .embedding_dim(127)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .table_dtype(dtype)
        .from_seed(42)
        .build()
    )
    rng = np.random.default_rng(7)
    u = 4096
    histories = [
        rng.integers(0, num_items, rng.integers(2, 32)).tolist()
        for _ in range(u)
    ]

    # Allow sub=32/16 at 10M (stack 5.2/10.3 GB): the f32 table is 5.1 GB,
    # so 16 risks OOM — measured, not assumed.
    ImplicitSequenceModel._SUBMAX_BUFFER_BYTES = 11 << 30

    baseline_ids = None
    for sub in (128, 64, 32, 16):
        os.environ["SBR_SERVE_SUBGROUP"] = str(sub)
        ImplicitSequenceModel._TOPK_FN_CACHE.clear()
        try:
            recs = model.recommend_batch(histories, k=10)  # warm/compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                recs = model.recommend_batch(histories, k=10)
                best = min(best, time.perf_counter() - t0)
        except Exception as e:  # OOM at small sub is a measurement
            print(f"sub={sub}: FAILED {type(e).__name__}: {str(e)[:200]}")
            continue
        if baseline_ids is None:
            baseline_ids = recs
            match = u
        else:
            match = sum(a == b for a, b in zip(recs, baseline_ids))
        print(
            f"sub={sub}: {best:.3f} s, {u / best:,.0f} users/s, "
            f"id-lists == baseline: {match}/{u}"
        )


if __name__ == "__main__":
    main()
