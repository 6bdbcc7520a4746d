"""Parameter and batch sharding rules.

Rule set (the device-mesh replacement for the reference's shared-memory
``HogwildParameter`` storage, ``src/models/lstm.rs:175-181``):

* ``item_table`` (the fused embedding+bias table, and its optimizer-state
  leaves) — row-sharded over the ``model`` mesh axis: each shard owns a
  contiguous slab of the catalog. Lookups/scatter-updates become sharded
  gathers/scatters; XLA SPMD inserts the collectives.
* tower parameters, ``alpha``, scalar step counts — replicated.
* batches — sharded over the ``data`` axis.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, MODEL_AXIS

_SHARDED_ROW_LEAVES = ("item_table",)


def _leaf_spec(path, leaf) -> P:
    names = {
        p.key for p in path if isinstance(p, jax.tree_util.DictKey)
    }
    ndim = getattr(leaf, "ndim", 0)
    if names & set(_SHARDED_ROW_LEAVES) and ndim >= 1:
        return P(MODEL_AXIS, *([None] * (ndim - 1)))
    return P()


def param_specs(tree):
    """PartitionSpec pytree for a params/opt-state tree."""
    return jax.tree_util.tree_map_with_path(lambda p, x: _leaf_spec(p, x), tree)


def shard_model_params(tree, mesh: jax.sharding.Mesh):
    """Place a params/opt-state pytree onto the mesh per the rule set."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(x, NamedSharding(mesh, _leaf_spec(p, x))), tree
    )


def batch_sharding(mesh: jax.sharding.Mesh, ndim: int = 2) -> NamedSharding:
    """Batch arrays shard over the data axis, replicated elsewhere."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))
