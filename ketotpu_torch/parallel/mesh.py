"""The device mesh, and the query-data-parallel batch checks.

The port of the JAX package's ``parallel/mesh.py``.  JAX runs every shard
from one process through ``jax.shard_map`` over a ``Mesh``; the port does
the same: a :class:`Mesh` is the tuple of ``torch.device`` each shard lives
on.  A device may repeat: ``["cpu"] * 4`` runs a four-shard mesh in one CPU
process (the tests' counterpart of the JAX suite's virtual 8-device CPU
platform), ``["cuda:0"] * 4`` four shards on one card.

:func:`shard_fast_check` (the pure-OR BFS) and :func:`shard_general_check`
(the AND/NOT program) split the query batch into contiguous slices, one
per device of the mesh, against a replicated graph: checks are
independent, so no collective runs.  The graph is copied once per
distinct device (slices on one card share its copy, which changes no
result); each slice is enqueued under its card's context on that card's
current stream, every slice before any host sync, and the outputs are
gathered onto the first device once, at the end.  They launch the tier-1
kernels (``engine/fastpath.py``) and the K7 program's
(``engine/algebra.py``); they add no kernel of their own.  The
graph-sharded checks, where each device holds a slice of the graph, are
``parallel/graphshard.py``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import algebra as alg
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine.device import upload


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


def _on(dev: torch.device):
    """Launch context of one shard: its card is the current device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def replicate(g, devices) -> Dict[torch.device, kernels.DeviceTables]:
    """The check tables ``g`` (``Snapshot.check_arrays()`` as numpy arrays,
    or tensors) once on each distinct device of ``devices``.  Tensors
    already on a device are used as they are; the copies of a
    :class:`kernels.DeviceTables` to other devices are kept on it, so
    later calls reuse them (the tables are read-only once built)."""
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = _replica(g, dev)
    return out


def _replica(g, dev: torch.device) -> kernels.DeviceTables:
    if not all(isinstance(v, torch.Tensor) for v in g.values()):
        return upload({k: np.asarray(v) for k, v in g.items()}, dev)
    if not isinstance(g, kernels.DeviceTables):
        return kernels.DeviceTables({k: v.to(dev) for k, v in g.items()})
    if all(v.device == dev for v in g.values()):
        return g
    if g._replicas is None:
        g._replicas = {}
    if dev not in g._replicas:
        g._replicas[dev] = kernels.DeviceTables({k: v.to(dev) for k, v in g.items()})
    return g._replicas[dev]


def _slices(mesh: Mesh, axis: str, block: np.ndarray):
    """The int32 block's column slices, one per device, on that device
    (all copied before any kernel is enqueued)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    n = mesh.size
    q = block.shape[1]
    if q % n:
        raise ValueError(f"batch {q} not divisible by mesh size {n}")
    w = q // n
    return [torch.from_numpy(np.ascontiguousarray(block[:, s * w:(s + 1) * w],
                                                  np.int32)).to(dev)
            for s, dev in enumerate(mesh.devices)]


def shard_fast_check(g, queries: Sequence[np.ndarray], mesh: Mesh, *,
                     axis: str = "data", frontier: int = 2048, arena: int = 8192,
                     max_depth: int = 5, max_width: int = 100,
                     active=None) -> fp.FastResult:
    """Query-data-parallel BFS fast path: graph replicated, batch sharded.

    ``queries``: the five encoded id columns (ns, obj, rel, subj, depth),
    ``active`` bool[Q] (default all).  Each device runs ``max_depth``
    whole steps (:func:`fastpath.step_impl` at the fixed ``frontier`` /
    ``arena``) on its contiguous slice.  The batch length must divide by
    the mesh size.  Returns found and over (bool[Q], on the first device,
    in slice order); the dirty bits are dropped, as JAX drops them."""
    return _shard_fast(fp._OPS, g, queries, mesh, axis=axis, frontier=frontier,
                       arena=arena, max_depth=max_depth, max_width=max_width,
                       active=active)


def _shard_fast(ops: fp._Ops, g, queries, mesh: Mesh, *, axis: str,
                frontier: int, arena: int, max_depth: int, max_width: int,
                active=None) -> fp.FastResult:
    cols = [np.asarray(a, np.int32) for a in queries]
    q = cols[0].shape[0]
    act = np.ones(q, bool) if active is None else np.asarray(active, bool)
    qps = _slices(mesh, axis, np.stack([*cols, act.astype(np.int32)]))
    tables = replicate(g, mesh.devices)
    bits = []
    for dev, qp in zip(mesh.devices, qps):
        with _on(dev):
            s = fp.step_state(qp, frontier=frontier, ops=ops)
            for _ in range(max_depth):
                s = fp.step_impl(tables[dev], s, frontier=frontier, arena=arena,
                                 max_width=max_width, ops=ops)
            bits.append((s.q_found, s.q_over))
    dev0 = mesh.devices[0]
    found = torch.cat([f.to(dev0) for f, _ in bits]) != 0
    over = torch.cat([o.to(dev0) for _, o in bits]) != 0
    return fp.FastResult(found=found, over=over)


def shard_general_check(g, qpack, mesh: Mesh, *, axis: str = "data", sizes,
                        fast_b: int, fast_sched, max_width: int = 100,
                        vcap: int = 4096):
    """Query-data-parallel AND/NOT checks: the K7 program
    (:func:`algebra.run_general_packed`) on each device's column slice of
    ``qpack`` (int32[6, Q]: ns, obj, rel, subj, depth, active), graph
    replicated, no collectives; ``sizes`` / ``fast_sched`` are per-device
    shapes.  Returns (codes uint8[Q], occ int32[n_devices, L]) on the
    first device: one occupancy row per device."""
    return _shard_general(alg._OPS, g, qpack, mesh, axis=axis, sizes=sizes,
                          fast_b=fast_b, fast_sched=fast_sched,
                          max_width=max_width, vcap=vcap)


def _shard_general(ops: alg._GenOps, g, qpack, mesh: Mesh, *, axis: str, sizes,
                   fast_b: int, fast_sched, max_width: int, vcap: int):
    block = qpack.cpu().numpy() if isinstance(qpack, torch.Tensor) else qpack
    qps = _slices(mesh, axis, np.asarray(block))
    tables = replicate(g, mesh.devices)
    res = []
    for dev, qp in zip(mesh.devices, qps):
        with _on(dev):
            res.append(alg._run_general(
                ops, tables[dev], qp, tuple(sizes), int(fast_b),
                tuple(fast_sched), max_width, vcap)[0])
    dev0 = mesh.devices[0]
    codes = torch.cat([r.codes().to(dev0) for r in res])
    occ = torch.stack([r.occ().to(dev0) for r in res])
    return codes, occ
