"""The graph-sharded mesh (K10) of the port.

* ``mesh``: :func:`make_mesh`, a tuple of devices, one per shard;
* ``graphshard``: the (namespace, object) partition, the sharded tables,
  and both tiers' sharded programs with their kernels (``csrc/shard.cu``);
* ``meshengine``: :class:`MeshCheckEngine`, the serving engine over them.

The query-data-parallel checks of the JAX package's ``parallel/mesh.py``
(``shard_fast_check``, ``shard_general_check``) and its ``peerlink`` are
not ported.
"""

from ketotpu_torch.parallel.graphshard import (
    build_sharded_snapshot,
    sharded_check,
    sharded_general_check,
)
from ketotpu_torch.parallel.mesh import Mesh, make_mesh
from ketotpu_torch.parallel.meshengine import MeshCheckEngine

__all__ = [
    "Mesh",
    "MeshCheckEngine",
    "build_sharded_snapshot",
    "make_mesh",
    "sharded_check",
    "sharded_general_check",
]
