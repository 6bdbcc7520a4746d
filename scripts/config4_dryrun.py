"""BASELINE config[4] structural dryrun: a 100M-item catalog, row-sharded.

Config[4] asks for "LSTM embedding_dim=256, 100M-item synthetic catalog,
WARP with full sharded-catalog negative scoring across N>=2 hosts". This
runs the SAME program shape at full catalog scale on the virtual 8-device
CPU mesh of one host (``python chip_smoke.py --cards 4`` runs the 100M-item
row-sharded path on four GPUs):

* 100,000,000-item fused [N, 32] f32 table (+ f32 Adagrad accumulator)
  row-sharded over ``model=8`` — ~26 GB of parameter+state, materialized
  and updated THROUGH the sharded program (the CPU backend upcasts bf16
  to f32 internally, so bf16 at this scale OOMs a 125 GB host; dim 256
  at 100M rows belongs on several cards);
* one full WARP fit step: on-device negative sampling over the 100M id
  space, gather -> LSTM -> WARP select -> masked loss -> sort/dedupe ->
  sparse Adagrad scatter, all under the mesh.

Cross-PROCESS execution of the same sharded program is separately proven
by tests/test_multiprocess.py::test_two_process_row_sharded_table.

Writes CONFIG4_r{N}.json. Takes ~10-30 min on one CPU core (the 12.7B
random inits dominate).

Usage: python scripts/config4_dryrun.py [OUT.json]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main() -> None:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "CONFIG4_r02.json"

    from sbr_rs_tpu.data import Interactions
    from sbr_rs_tpu.models import Loss, Optimizer, lstm
    from sbr_rs_tpu.parallel import make_mesh

    num_items = 100_000_000
    num_users, seq_len = 64, 10
    rng = np.random.default_rng(0)
    inter = Interactions.from_arrays(
        np.repeat(np.arange(num_users), seq_len),
        rng.integers(0, num_items, num_users * seq_len),
        np.tile(np.arange(seq_len), num_users),
        num_users,
        num_items,
    ).to_compressed()

    mesh = make_mesh(data=1, model=8)
    t0 = time.perf_counter()
    model = (
        lstm.Hyperparameters(num_items, 10)
        .embedding_dim(31)
        .learning_rate(0.1)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(1)
        .batch_size(64)
        .sparse_updates(True)
        .mesh(mesh)
        .from_seed(0)
        .build()
    )
    init_s = time.perf_counter() - t0
    print(f"init (100M x 32 f32 sharded table): {init_s:.0f}s", flush=True)

    t0 = time.perf_counter()
    loss = model.fit(inter)
    fit_s = time.perf_counter() - t0
    assert np.isfinite(loss), f"non-finite loss: {loss}"

    result = {
        "config": "config4_structural_100m_items_lstm31_warp_model8",
        "num_items": num_items,
        "table_plus_state_gb": round(num_items * 32 * 4 * 2 / 1e9, 1),
        "mesh": {"data": 1, "model": 8},
        "loss": float(loss),
        "init_s": round(init_s, 1),
        "fit_s": round(fit_s, 1),
        "note": (
            "Virtual 8-device CPU mesh on one host; program shape and "
            "scale are config[4]'s, "
            "cross-process execution proven by tests/test_multiprocess.py."
        ),
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
