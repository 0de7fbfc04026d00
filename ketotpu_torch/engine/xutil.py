"""Arena allocation: per-task child counts -> flat child slots (K4).

The batched replacement for goroutine fan-out in the reference
(`internal/check/checkgroup/concurrent_checkgroup.go:66-138`), as in the
JAX package's ``engine/xutil.py``.  :func:`arena_assign` launches the
CUDA kernel of ``csrc/arena.cu`` on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ketotpu_torch import kernels

Tensor = torch.Tensor


def arena_assign(counts: Tensor, arena_size: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Flatten per-task child counts into arena slots.

    ``counts``: int32[T] children requested per task (0 for inactive tasks).

    Returns ``(offsets, total, parent, ordinal)`` where ``offsets[t]`` is the
    exclusive prefix sum (the arena base of task t's children), ``total`` the
    0-d total, and for each arena slot ``j < arena_size``: ``parent[j]`` =
    the task index owning the slot and ``ordinal[j]`` its child ordinal;
    slots >= total get parent == -1 and ordinal 0.
    """
    if counts.device.type == "cpu":
        return _arena_assign_plain(counts, arena_size)
    return _arena_assign_cuda(counts, arena_size)


def _arena_assign_plain(counts: Tensor, arena_size: int):
    counts = counts.to(torch.int32)
    dev = counts.device
    n = counts.shape[0]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total = counts.sum(dtype=torch.int32)
    j = torch.arange(arena_size, dtype=torch.int32, device=dev)
    # parent[j] = last t with offsets[t] <= j among counts > 0 rows: scatter
    # each task index at its range start and forward-fill with a running
    # max.  Starts at or past the arena go to a sink slot (JAX drops them).
    t = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.where((counts > 0) & (offsets < arena_size), offsets, arena_size)
    mark = torch.full((arena_size + 1,), -1, dtype=torch.int32, device=dev)
    mark = mark.scatter_reduce(0, start.to(torch.int64), t, "amax")[:arena_size]
    parent = torch.cummax(mark, 0).values
    parent = torch.where(j < total, parent, -1)
    safe = parent.clamp(0, n - 1).to(torch.int64)
    ordinal = torch.where(parent >= 0, j - offsets[safe], 0).to(torch.int32)
    return offsets, total, parent, ordinal


def _arena_assign_cuda(counts: Tensor, arena_size: int):
    kernels.require(counts, torch.int32, "counts")
    n = counts.shape[0]
    dev = counts.device
    offsets = torch.empty(n, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    parent = torch.empty(arena_size, dtype=torch.int32, device=dev)
    ordinal = torch.empty(arena_size, dtype=torch.int32, device=dev)
    block_sums = torch.empty(-(-max(n, 1) // 4096), dtype=torch.int32, device=dev)
    kernels.launch(
        "arena", "arena_assign", kernels.ptr(counts), n, arena_size,
        kernels.ptr(offsets), kernels.ptr(total), kernels.ptr(parent),
        kernels.ptr(ordinal), kernels.ptr(block_sums), kernels.stream(),
    )
    kernels.LAUNCHES["arena_assign"] += 1
    return offsets, total[0], parent, ordinal
