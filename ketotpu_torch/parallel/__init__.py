"""Multi-device checks of the port.

* ``mesh``: :func:`make_mesh`, a tuple of devices, one per shard, and the
  query-data-parallel checks (:func:`shard_fast_check`,
  :func:`shard_general_check`): the graph replicated, the query batch
  split over the devices, no collectives;
* ``graphshard``: the (namespace, object) partition, the sharded tables,
  and both tiers' sharded programs with their kernels (``csrc/shard.cu``);
* ``meshengine``: :class:`MeshCheckEngine`, the serving engine over them.

The JAX package's ``peerlink`` is not ported.
"""

from ketotpu_torch.engine.fastpath import FastResult
from ketotpu_torch.parallel.graphshard import (
    build_sharded_snapshot,
    sharded_check,
    sharded_general_check,
)
from ketotpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_fast_check,
    shard_general_check,
)
from ketotpu_torch.parallel.meshengine import MeshCheckEngine

__all__ = [
    "FastResult",
    "Mesh",
    "MeshCheckEngine",
    "build_sharded_snapshot",
    "make_mesh",
    "shard_fast_check",
    "shard_general_check",
    "sharded_check",
    "sharded_general_check",
]
