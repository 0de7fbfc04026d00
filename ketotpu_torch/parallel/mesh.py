"""The device mesh of the graph-sharded engine.

The port of the JAX package's ``parallel/mesh.py`` ``make_mesh``.  JAX runs
every shard from one process through ``jax.shard_map`` over a ``Mesh``;
the port does the same: a :class:`Mesh` is the tuple of ``torch.device``
each shard lives on, and the collectives between shards are copies
(``parallel/graphshard.py``).  A device may repeat: ``["cpu"] * 4`` runs a
four-shard mesh in one CPU process (the tests' counterpart of the JAX
suite's virtual 8-device CPU platform), ``["cuda:0"] * 4`` four shards on
one card.  The query-data-parallel checks of the JAX module
(``shard_fast_check``, ``shard_general_check``) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh(NamedTuple):
    """A 1-D mesh: one device per shard, and the axis name."""

    devices: Tuple[torch.device, ...]
    axis: str

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "data",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    CUDA cards, none without them).  Like the JAX function it takes fewer
    devices than asked for when fewer exist; the caller checks."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis)
