"""Run a data-parallel sharded fit under 1 or more `jax.distributed`
processes and print the per-epoch losses as one JSON line.

Used by tests/test_multiprocess.py to assert that REAL 2-process training
(gloo CPU collectives, 4 virtual devices per process -> one 8-device global
mesh) reproduces the single-process 8-device trajectory exactly. The
reference's only concurrency test is a
2-thread fit (``src/models/lstm.rs:474-496``); this is its multi-host
equivalent.

Usage: python scripts/multiprocess_fit.py NUM_PROCESSES PROCESS_ID PORT [MODEL_AXIS] [EPOCHS]

MODEL_AXIS > 1 row-shards the item table over the model mesh axis — the
shape of BASELINE config[4] (sharded-catalog WARP training across hosts):
table gathers/scatters and the loss psum then cross the process boundary.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    num_processes = int(sys.argv[1])
    process_id = int(sys.argv[2])
    port = int(sys.argv[3])
    model_axis = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    num_epochs = int(sys.argv[5]) if len(sys.argv) > 5 else 3
    devices_per_process = 8 // num_processes

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_process} "
        + os.environ.get("XLA_FLAGS", "")
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    if num_processes > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

        from sbr_rs_tpu.parallel import distributed

        distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=num_processes,
            process_id=process_id,
        )
        assert jax.process_count() == num_processes
        mesh = distributed.global_mesh(model=model_axis)
    else:
        from sbr_rs_tpu.parallel import make_mesh

        mesh = make_mesh(data=8 // model_axis, model=model_axis)

    import numpy as np

    from sbr_rs_tpu.data import Interactions
    from sbr_rs_tpu.evaluation import mrr_score
    from sbr_rs_tpu.models import Loss, Optimizer, lstm

    num_users, num_items, seq_len = 64, 128, 12
    rng = np.random.default_rng(0)
    inter = Interactions.from_arrays(
        np.repeat(np.arange(num_users), seq_len),
        rng.integers(0, num_items, num_users * seq_len),
        np.tile(np.arange(seq_len), num_users),
        num_users,
        num_items,
    ).to_compressed()

    import time

    t_ready = time.perf_counter()
    model = (
        lstm.Hyperparameters(num_items, 8)
        .embedding_dim(16)
        .learning_rate(0.1)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(num_epochs)
        .batch_size(16)
        .from_seed(42)
        .mesh(mesh)
        .build()
    )
    loss = model.fit(inter)  # includes compile
    t_first_fit = time.perf_counter()
    losses = [float(x) for x in model._last_epoch_losses]
    # Serving + eval across the SAME process boundary (round 5): inputs
    # upload as fully-replicated global arrays and outputs are pinned
    # replicated, so recommend_batch / mrr_score run under multi-
    # controller meshes too — every process computes identical results.
    histories = [[1, 2, 3], [100, 127], [5] * 4]
    recs = model.recommend_batch(histories, k=5)
    mrr = float(mrr_score(model, inter))
    # Steady-state wall: the number that predicts real multi-host scaling
    # (one-off interpreter/distributed-init/compile costs excluded).
    warm = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        model.fit(inter)
        warm = min(warm, time.perf_counter() - t0)
    if process_id == 0:
        print(
            json.dumps(
                {
                    "num_processes": num_processes,
                    "num_epochs": num_epochs,
                    "global_devices": jax.device_count(),
                    "model_axis": model_axis,
                    "loss": float(loss),
                    "epoch_losses": losses,
                    "first_fit_s": t_first_fit - t_ready,
                    "warm_fit_s": warm,
                    "recommend_lists": recs,
                    "mrr": mrr,
                }
            )
        )


if __name__ == "__main__":
    main()
