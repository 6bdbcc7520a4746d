"""Random hyperparameter search for the LSTM model on Movielens 100K.

Counterpart of the reference's hyperopt example
(``examples/lstm_hyperopt.rs:82-130``): each trial draws random
hyperparameters (``Hyperparameters.random``, reference
``src/models/lstm.rs:141-172``), fits, scores train/test MRR, and appends
the result to ``lstm_results.json`` kept sorted by test MRR (best last).

Usage::

    python examples/lstm_hyperopt.py [--trials N] [--out lstm_results.json]
                                     [--model lstm|ewma|attention|gru]

``--model`` extends the driver to every model family (each
``Hyperparameters.random`` draws the same common ranges; attention adds
depth/heads).

Runs on the ML-100K CSV when one is supplied (``$SBR_TPU_ML100K`` or the
cache file) and otherwise on seeded data of ML-100K's shape.

Search-space note: unlike the reference, ``random()`` does NOT sample
``parallelism`` — the knob is a documented no-op here (Hogwild has no
analogue in synchronous SPMD training), so sampling it would only add a
noise column. ``num_threads`` collapses to the constant 1 on a
single-device host (it is the realized data-parallel mesh degree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu as sbr
from sbr_rs_tpu.models import attention, ewma, gru, lstm

MODEL_FAMILIES = {"lstm": lstm, "ewma": ewma, "attention": attention, "gru": gru}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--trials", type=int, default=1000)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--model", choices=sorted(MODEL_FAMILIES), default="lstm"
    )
    args = parser.parse_args()
    family = MODEL_FAMILIES[args.model]
    if args.out is None:
        args.out = f"{args.model}_results.json"

    data, source = sbr.datasets.movielens_100k()
    print(source)
    from sbr_rs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(args.seed)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()
    # Mirrors the reference's startup line, which also prints the TOTAL
    # (pre-split) interaction count (`examples/lstm_hyperopt.rs:93-98`).
    print(f"Train {train_mat.num_users} {train_mat.num_items} {len(data)}")

    out = Path(args.out)
    for _ in range(args.trials):
        results = json.loads(out.read_text()) if out.exists() else []

        hyper = family.Hyperparameters.random(data.num_items, rng)
        print(f"Running {json.dumps(hyper.to_dict(), indent=2)}")

        start = time.perf_counter()
        try:
            model = hyper.build()
            model.fit(train_mat)
            result = {
                "train_mrr": sbr.evaluation.mrr_score(model, train_mat),
                "test_mrr": sbr.evaluation.mrr_score(model, test_mat),
                "elapsed_s": time.perf_counter() - start,
                "hyperparameters": hyper.to_dict(),
            }
        except sbr.errors.SbrError as exc:
            # Random-search corners diverge (lr up to ~3.2): record and move
            # on rather than aborting a 1000-trial run.
            print(f"Trial failed ({exc!r}); continuing")
            continue
        print(json.dumps(result, indent=2))

        if not np.isnan(result["test_mrr"]):
            results.append(result)
            results.sort(key=lambda r: r["test_mrr"])

        if results:
            print(f"Best result: {json.dumps(results[-1], indent=2)}")

        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(results, indent=2))
        os.replace(tmp, out)


if __name__ == "__main__":
    main()
