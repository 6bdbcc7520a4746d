"""Device-mesh parallelism: mesh construction, parameter/batch shardings.

The reference's only parallelism is shared-memory rayon threads with
Hogwild or synchronized optimizer handles
(``src/models/sequence_model.rs:91-102``). The equivalents here are
SPMD over a ``jax.sharding.Mesh`` with a ``data`` axis (batch parallelism)
and a ``model`` axis (row-sharded item embedding table) — XLA inserts the
all-gather/psum collectives for sharded gathers, scatters, and catalog
matmuls.
"""

from .mesh import make_mesh
from .sharding import batch_sharding, shard_model_params

__all__ = ["make_mesh", "shard_model_params", "batch_sharding"]
