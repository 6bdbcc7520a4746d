"""Hyperparameter probe for the attention model on ML-100K.

Runs a grid of configs under the reference gate protocol (user-based 0.2
split, data seed 42) and prints test MRR per config. CPU by default
(forces the backend like tests/conftest.py); set SBR_TUNE_PLATFORM=gpu to
run on the card.

Usage: python scripts/attention_tune.py [--quick]
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

platform = os.environ.get("SBR_TUNE_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = platform
import jax  # noqa: E402

jax.config.update("jax_platforms", platform)

import numpy as np  # noqa: E402

import sbr_rs_tpu as sbr  # noqa: E402
from sbr_rs_tpu.models import Loss, Optimizer, attention  # noqa: E402


def run(train, test, *, seq_len, dim, layers, heads, lr, l2, epochs, batch,
        loss, opt, schedule, seed, dropout=0.0):
    hp = (
        attention.Hyperparameters(train.num_items, seq_len)
        .embedding_dim(dim)
        .num_layers(layers)
        .num_heads(heads)
        .dropout(dropout)
        .learning_rate(lr)
        .l2_penalty(l2)
        .loss(loss)
        .optimizer(opt)
        .num_epochs(epochs)
        .batch_size(batch)
        .from_seed(seed)
    )
    if schedule:
        hp = hp.lr_schedule(schedule)
    model = hp.build()
    t0 = time.time()
    model.fit(train)
    mrr = sbr.evaluation.mrr_score(model, test)
    return float(mrr), time.time() - t0


def main():
    quick = "--quick" in sys.argv
    data = sbr.datasets.download_movielens_100k()
    train, test = sbr.data.user_based_split(data, np.random.default_rng(42), 0.2)
    train, test = train.to_compressed(), test.to_compressed()

    grid = []
    if "--stage4" in sys.argv:
        # Dropout (SASRec's decisive regularizer) around the stage-3 winner.
        for dropout in (0.1, 0.2, 0.3, 0.5):
            for layers in (1, 2):
                for epochs in (20, 40):
                    grid.append(dict(
                        seq_len=32, dim=32, layers=layers, heads=1,
                        lr=0.003, l2=3e-4, epochs=epochs, batch=64,
                        loss=Loss.WARP, opt=Optimizer.ADAM,
                        schedule="cosine", seed=42, dropout=dropout,
                    ))
    elif "--stage3" in sys.argv:
        # Capacity/regularization sweep at the stage-1 winner's optimizer
        # setting (WARP, Adam, lr 3e-3, cosine, 20 epochs, T=32).
        for dim in (32, 64):
            for heads in (1, 2):
                for batch in (32, 64):
                    for l2 in (1e-4, 3e-4, 1e-3):
                        grid.append(dict(
                            seq_len=32, dim=dim, layers=1, heads=heads,
                            lr=0.003, l2=l2, epochs=20, batch=batch,
                            loss=Loss.WARP, opt=Optimizer.ADAM,
                            schedule="cosine", seed=42,
                        ))
    elif "--stage2" in sys.argv:
        # Refinement around the stage-1 winner (WARP, 1 layer, lr 3e-3,
        # l2 1e-4, cosine): lower lr, longer training, longer windows,
        # warmup, batch size.
        for seq_len in (32, 64, 128):
            for lr in (0.001, 0.002, 0.003):
                for epochs in (20, 40):
                    for schedule in ("cosine", "warmup_cosine"):
                        grid.append(dict(
                            seq_len=seq_len, dim=32, layers=1, heads=1,
                            lr=lr, l2=1e-4, epochs=epochs, batch=64,
                            loss=Loss.WARP, opt=Optimizer.ADAM,
                            schedule=schedule, seed=42,
                        ))
    else:
        for loss, opt in ((Loss.HINGE, Optimizer.ADAM), (Loss.WARP, Optimizer.ADAM)):
            for lr in (0.003, 0.01, 0.03):
                for l2 in (0.0, 1e-4, 1e-3):
                    for layers in (1, 2):
                        grid.append(dict(
                            seq_len=32, dim=32, layers=layers, heads=1, lr=lr,
                            l2=l2, epochs=20, batch=64, loss=loss, opt=opt,
                            schedule="cosine", seed=42,
                        ))
    if quick:
        grid = grid[:4]

    results = []
    for cfg in grid:
        try:
            mrr, wall = run(train, test, **cfg)
        except sbr.errors.SbrError as exc:
            # Diverging corners must not abort an hours-long sweep.
            print(f"config failed ({exc!r}); continuing", flush=True)
            continue
        results.append((mrr, cfg))
        print(
            f"mrr={mrr:.4f} wall={wall:.0f}s "
            f"loss={cfg['loss'].value} lr={cfg['lr']} l2={cfg['l2']} "
            f"layers={cfg['layers']} epochs={cfg['epochs']}",
            flush=True,
        )

    results.sort(key=lambda r: -r[0])
    print("\nTOP 5:")
    for mrr, cfg in results[:5]:
        c = {k: (v.value if hasattr(v, "value") else v) for k, v in cfg.items()}
        print(f"  {mrr:.4f}  {c}")


if __name__ == "__main__":
    main()
