"""Model checkpointing.

The reference's checkpoint story is serde/bincode serialization of the
whole model — hyperparameters, parameter arrays, and the RNG state
(``src/models/lstm.rs:38,204,386``; ``Cargo.toml:18``). The equivalent
here saves a directory with:

* ``state.npz`` — the parameter pytree and the JAX PRNG key (the only
  RNG the training loop consumes — epoch shuffles and negative sampling
  both run on device from it), as a NumPy archive with one entry per
  leaf, named by its key path (``params/tower/w_h``);
* ``config.json`` — hyperparameters + model type + a content hash of
  ``state.npz``, written LAST as the commit marker: a crash between
  the two writes leaves a config whose hash does not match the new state,
  which ``load_model`` rejects — never a silently inconsistent pair that
  loads (shape checks alone cannot catch a stale config whose dims happen
  to coincide).

Round-trips restore training exactly.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_STATE = "state.npz"


def _leaf_name(path) -> str:
    return "/".join(
        str(k.key) if isinstance(k, jax.tree_util.DictKey) else str(k.idx)
        for k in path
    )


def _flatten(state) -> dict:
    """Leaf arrays by name. NumPy archives keep only NumPy's own dtypes, so
    each leaf is stored as raw bytes of its width beside a ``_dtypes`` entry
    naming its dtype (bfloat16 tables included)."""
    arrays, dtypes = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        a = np.asarray(leaf)
        name = _leaf_name(path)
        dtypes[name] = a.dtype.name
        arrays[name] = a.view(f"u{a.dtype.itemsize}")
    arrays["_dtypes"] = np.asarray(json.dumps(dtypes))
    return arrays


def _unflatten(archive) -> dict:
    dtypes = json.loads(str(archive["_dtypes"]))
    return {
        name: archive[name].view(jnp.dtype(dtype)) for name, dtype in dtypes.items()
    }


def save_model(model, path: str) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)

    buf = io.BytesIO()
    np.savez(buf, **_flatten({"params": model._params, "key": model._key}))
    blob = buf.getvalue()
    tmp_state = p / (_STATE + ".tmp")
    tmp_state.write_bytes(blob)
    os.replace(tmp_state, p / _STATE)

    # Config last: it is the checkpoint's commit marker, and it carries the
    # state blob's hash so a crash between the two replaces (new state, old
    # config) can never load as a silently mismatched pair.
    config = model.hyper.to_dict()
    config["state_sha256"] = hashlib.sha256(blob).hexdigest()
    tmp_cfg = p / "config.json.tmp"
    tmp_cfg.write_text(json.dumps(config, indent=2))
    os.replace(tmp_cfg, p / "config.json")


def load_model(path: str):
    from ..models import attention, ewma, gru, lstm

    p = Path(path)
    config = json.loads((p / "config.json").read_text())
    config.pop("np_rng_state", None)  # legacy field, no longer used
    blob = (p / _STATE).read_bytes()
    want_hash = config.pop("state_sha256", None)
    if want_hash is not None and hashlib.sha256(blob).hexdigest() != want_hash:
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: {_STATE} does "
            "not match the hash recorded in config.json — the directory "
            "holds files from different saves."
        )
    model_type = config["model_type"]
    if model_type == "lstm":
        hyper = lstm.Hyperparameters.from_dict(config)
    elif model_type == "ewma":
        hyper = ewma.Hyperparameters.from_dict(config)
    elif model_type == "attention":
        hyper = attention.Hyperparameters.from_dict(config)
    elif model_type == "gru":
        hyper = gru.Hyperparameters.from_dict(config)
    else:
        raise ValueError(f"Unknown model_type: {model_type}")

    model = hyper.build()
    with np.load(io.BytesIO(blob)) as archive:
        arrays = _unflatten(archive)

    table = arrays["params/item_table"]
    want = (config["num_items"], config["item_embedding_dim"] + 1)
    if tuple(table.shape) != want:
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: item_table shape "
            f"{tuple(table.shape)} but config expects {want} — the "
            "checkpoint directory holds files from different saves."
        )

    model._params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(arrays["params/" + _leaf_name(path)]),
        model._params,
    )
    model._key = jnp.asarray(arrays["key"])
    return model
