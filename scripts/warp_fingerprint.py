"""Bit-exactness fingerprint of WARP fits (CPU).

Runs short deterministic WARP fits on both towers and prints a SHA256 of
the final parameter bytes plus the loss. Used to verify that engine
refactors which must not change numerics (e.g. sharing the primal tower
forward with the WARP selection pass) are bit-identical: run before the
change, save the output, run after, diff.
"""

from __future__ import annotations

import hashlib
import os
import sys

# Hard-set (not setdefault): the fingerprint is defined on the CPU
# backend, whatever accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from sbr_rs_tpu import data as D
from sbr_rs_tpu.models import Loss, Optimizer, ewma, lstm


def toy(num_users=80, num_items=50, seq_len=14, seed=3):
    rng = np.random.default_rng(seed)
    users, items, ts = [], [], []
    for u in range(num_users):
        start = rng.integers(0, num_items)
        step = 1 + (u % 4)
        for t in range(seq_len):
            users.append(u)
            items.append((start + t * step) % num_items)
            ts.append(t)
    return D.Interactions.from_arrays(
        np.array(users), np.array(items), np.array(ts)
    ).to_compressed()


def fingerprint(model, inter):
    loss = model.fit(inter)
    h = hashlib.sha256()
    leaves = jax.tree_util.tree_leaves(model._params)
    for leaf in leaves:
        h.update(np.asarray(leaf).tobytes())
    return loss, h.hexdigest()


def main():
    inter = toy()
    for name, hp in [
        (
            "lstm_warp_adagrad",
            lstm.Hyperparameters(inter.num_items, 8)
            .embedding_dim(16)
            .learning_rate(0.1)
            .l2_penalty(1e-4)
            .loss(Loss.WARP)
            .optimizer(Optimizer.ADAGRAD)
            .num_epochs(3)
            .batch_size(16)
            .from_seed(7),
        ),
        (
            "ewma_warp_adam",
            ewma.Hyperparameters(inter.num_items, 8)
            .embedding_dim(16)
            .learning_rate(0.05)
            .l2_penalty(1e-3)
            .loss(Loss.WARP)
            .optimizer(Optimizer.ADAM)
            .num_epochs(3)
            .batch_size(16)
            .from_seed(7),
        ),
        (
            "lstm_bpr_adagrad",
            lstm.Hyperparameters(inter.num_items, 8)
            .embedding_dim(16)
            .learning_rate(0.1)
            .loss(Loss.BPR)
            .optimizer(Optimizer.ADAGRAD)
            .num_epochs(2)
            .batch_size(16)
            .from_seed(7),
        ),
    ]:
        loss, digest = fingerprint(hp.build(), inter)
        print(f"{name}: loss={loss!r} params_sha256={digest}")


if __name__ == "__main__":
    main()
