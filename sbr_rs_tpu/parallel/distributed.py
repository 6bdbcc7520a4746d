"""Multi-host initialization and pod-slice mesh construction.

The reference's only "distribution" is rayon threads over shared memory
(``src/models/sequence_model.rs:100-102``); this framework scales across
hosts with ``jax.distributed`` + a global device mesh instead (SURVEY.md
§5.8):

* ``data`` axis — batch parallelism, laid out so that it spans hosts last:
  the gradient ``psum`` runs over the fast intra-host links first.
* ``model`` axis — item-table row sharding, kept *within* a host so
  embedding gathers/scatters stay on the intra-host links (NVLink).

Single-host usage never needs this module; ``make_mesh()`` over local
devices is enough. Multi-host jobs call :func:`initialize` once per process
before any JAX calls, then :func:`global_mesh`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import jax

from .mesh import DATA_AXIS, MODEL_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize JAX multi-host runtime (no-op when single-process).

    Arguments default to the standard env vars / cluster autodetection of
    ``jax.distributed.initialize``. Failures surface immediately — the
    reference has no failure detection (SURVEY.md §5.3); here a bad
    coordinator or mismatched world size raises at startup rather than
    hanging in the first collective.
    """
    if coordinator_address is None and os.environ.get("COORDINATOR_ADDRESS"):
        coordinator_address = os.environ["COORDINATOR_ADDRESS"]
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(model: int = 1) -> jax.sharding.Mesh:
    """A ``(data, model)`` mesh over ALL devices (across hosts), with the
    ``model`` axis packed into the innermost (fastest, intra-host) device
    dimension so table gathers stay on the intra-host links."""
    devices = np.asarray(jax.devices())
    n = len(devices)
    if n % model:
        raise ValueError(f"model={model} does not divide {n} global devices")
    arr = devices.reshape(n // model, model)
    return jax.sharding.Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def is_primary() -> bool:
    """True on the process that should write checkpoints / logs."""
    return jax.process_index() == 0
