"""Measure the extension gates' noise: >=3 runs per platform per seed.

The GRU/attention extension bars rested on ONE measurement per platform
per seed. This script re-runs each gate config N times per seed on the
CURRENT backend and reports per-seed values and run-to-run spread; run it
once on CPU and once on the accelerator, then set the floors with >= 2x
the observed cross-platform drift of margin.

Run-to-run spread on one platform is expected ~0 (the whole fit is one
deterministic compiled program per seed); the row demonstrating that is
still evidence — it pins the noise to CROSS-PLATFORM/compile drift, not
sampling.

Usage:
    python scripts/gate_noise.py [--runs 3] [--gates gru,attention]
    # CPU: JAX_PLATFORMS=cpu handled by forcing in-process when
    #      --platform cpu is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--gates", type=str, default="gru,attention")
    ap.add_argument("--platform", type=str, default=None,
                    help="cpu forces the CPU backend in-process")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import sbr_rs_tpu as sbr
    from sbr_rs_tpu.models import Loss, Optimizer, attention, gru

    data = sbr.datasets.download_movielens_100k()
    rng = np.random.default_rng(42)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat, test_mat = train.to_compressed(), test.to_compressed()

    def gru_model(seed):
        return (
            gru.Hyperparameters(data.num_items, 128)
            .embedding_dim(32).learning_rate(0.01).l2_penalty(0.03)
            .loss(Loss.WARP).optimizer(Optimizer.ADAM).num_epochs(40)
            .batch_size(16).lr_schedule("cosine").from_seed(seed).build()
        )

    def attention_model(seed):
        return (
            attention.Hyperparameters(data.num_items, 32)
            .embedding_dim(32).num_layers(1).num_heads(1)
            .learning_rate(0.003).l2_penalty(3e-4)
            .loss(Loss.WARP).optimizer(Optimizer.ADAM).num_epochs(20)
            .batch_size(64).lr_schedule("cosine").from_seed(seed).build()
        )

    builders = {"gru": gru_model, "attention": attention_model}
    backend = jax.default_backend()
    out = {"backend": backend, "runs_per_seed": args.runs, "gates": {}}
    for gate in args.gates.split(","):
        per_seed = {}
        for seed in (42, 123, 7):
            vals = []
            for _ in range(args.runs):
                t0 = time.perf_counter()
                m = builders[gate](seed)
                m.fit(train_mat)
                vals.append(
                    round(float(sbr.evaluation.mrr_score(m, test_mat)), 6)
                )
                print(
                    f"{gate} s{seed}: {vals[-1]} "
                    f"({time.perf_counter()-t0:.0f}s)",
                    flush=True,
                )
            per_seed[str(seed)] = {
                "values": vals,
                "spread": round(max(vals) - min(vals), 6),
            }
        out["gates"][gate] = per_seed
    path = args.out or f"gate_noise_{backend}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
