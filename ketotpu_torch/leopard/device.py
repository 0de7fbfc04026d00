"""Tier 0 on the card: the Leopard pair columns and their binary search (K6).

The port of the JAX package's ``leopard/device.py``.  The closure index's
sorted packed ``(set << 32 | element)`` int64 keys ship to the engine's
device as two sorted int32 columns (set, element) plus the hop column,
padded to a power-of-two bucket with a sentinel that sorts after every
real id, and a batch of membership verdicts is one lexicographic binary
search per query over the two columns.

:func:`probe` launches the CUDA kernel of ``csrc/leopard.cu`` on CUDA
tensors and runs its plain PyTorch version, :func:`_probe_plain`, on CPU
tensors.  The search itself is a device function (``csrc/leopard.cuh``)
that the fused wave's tier-0 kernel (``csrc/wave.cu``) shares.

The search runs ``bit_length(cap)`` steps, one more than a power-of-two
capacity needs, as the JAX program does.  When the pair count fills its
bucket exactly (no padding), a query above the last pair drives the low
bound to ``cap`` and the midpoint to ``cap``: JAX clamps that gather to
``cap - 1``, and so do both versions here (the result is then a miss,
exactly as in JAX).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels

Tensor = torch.Tensor

#: pair-column pad sentinel: sorts after every real id (set and element ids
#: are non-negative int32 below it) and never equals one
_PAIR_PAD = np.iinfo(np.int32).max


def _pair_bucket(n: int, floor: int = 1024) -> int:
    """Power-of-two pad size of the shipped pair columns."""
    b = floor
    while b < n:
        b <<= 1
    return b


def probe_steps(cap: int) -> int:
    """Search steps over ``cap`` slots: ``bit_length(cap)``, at least 1."""
    return max(int(cap).bit_length(), 1)


def ship_pairs(index, device) -> Optional[Dict[str, Tensor]]:
    """The closure pair columns on ``device``: ``sets``, ``elts``, ``hops``,
    int32[cap] each, padded to :func:`_pair_bucket`; None for an empty
    index.  The packed int64 keys split into two int32 columns with the
    same lexicographic order (the packing is the order of its halves)."""
    if index is None or len(index.elt_packed) == 0:
        return None
    n = len(index.elt_packed)
    cap = _pair_bucket(n)
    sets = np.full(cap, _PAIR_PAD, np.int32)
    elts = np.full(cap, _PAIR_PAD, np.int32)
    sets[:n] = (index.elt_packed >> 32).astype(np.int32)
    elts[:n] = (index.elt_packed & 0x7FFFFFFF).astype(np.int32)
    hops = np.zeros(cap, np.int32)
    hops[:n] = index.elt_hop
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in (("sets", sets), ("elts", elts), ("hops", hops))
    }


def probe(sets: Tensor, elts: Tensor, hops: Tensor, q_set: Tensor,
          q_elt: Tensor) -> Tuple[Tensor, Tensor]:
    """(hit, hop) per query, int32[n] each: ``hit`` is 1 where the pair
    (q_set, q_elt) is in the sorted columns, ``hop`` its hop count there
    and 0 elsewhere.  A query set id of -1 never matches."""
    if sets.device.type == "cpu":
        return _probe_plain(sets, elts, hops, q_set, q_elt)
    dev = sets.device
    cap = sets.shape[0]
    n = q_set.shape[0]
    kernels.require(sets, torch.int32, "sets", shape=(cap,))
    kernels.require(elts, torch.int32, "elts", shape=(cap,), device=dev)
    kernels.require(hops, torch.int32, "hops", shape=(cap,), device=dev)
    kernels.require(q_set, torch.int32, "q_set", shape=(n,), device=dev)
    kernels.require(q_elt, torch.int32, "q_elt", shape=(n,), device=dev)
    hit = torch.empty(n, dtype=torch.int32, device=dev)
    hop = torch.empty(n, dtype=torch.int32, device=dev)
    kernels.launch(
        "leopard", "leo_probe", kernels.ptr(sets), kernels.ptr(elts),
        kernels.ptr(hops), cap, probe_steps(cap), kernels.ptr(q_set),
        kernels.ptr(q_elt), n, kernels.ptr(hit), kernels.ptr(hop),
        kernels.stream(),
    )
    kernels.LAUNCHES["leo_probe"] += 1
    return hit, hop


def search(sets: Tensor, elts: Tensor, q_set: Tensor, q_elt: Tensor) -> Tensor:
    """The clamped slot each query's search ends on (int64), the unrolled
    lexicographic binary search of the JAX ``probe_in_program``."""
    cap = sets.shape[0]
    lo = torch.zeros(q_set.shape, dtype=torch.int32, device=q_set.device)
    hi = torch.full(q_set.shape, cap, dtype=torch.int32, device=q_set.device)
    for _ in range(probe_steps(cap)):
        mid = (lo + hi) >> 1
        mc = mid.clamp(max=cap - 1).to(torch.int64)  # JAX's clamped gather
        ms, me = sets[mc], elts[mc]
        less = (ms < q_set) | ((ms == q_set) & (me < q_elt))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo.clamp(0, cap - 1).to(torch.int64)


def _probe_plain(sets: Tensor, elts: Tensor, hops: Tensor, q_set: Tensor,
                 q_elt: Tensor) -> Tuple[Tensor, Tensor]:
    idx = search(sets, elts, q_set, q_elt)
    hit = (sets[idx] == q_set) & (elts[idx] == q_elt)
    return hit.to(torch.int32), torch.where(hit, hops[idx], 0).to(torch.int32)


def split_keys(keys: np.ndarray, pad_to: int) -> Tuple[np.ndarray, np.ndarray]:
    """(q_set, q_elt) int32 columns of packed int64 keys, padded with -1 to
    ``pad_to``; a -1 key (must miss) keeps a -1 element id."""
    q_set = np.full(pad_to, -1, np.int32)
    q_elt = np.full(pad_to, -1, np.int32)
    q_set[: len(keys)] = (keys >> 32).astype(np.int32)
    q_elt[: len(keys)] = (keys & 0x7FFFFFFF).astype(np.int32)
    # a -1 key's high half is -1 (arithmetic shift): no real set id matches
    q_elt[: len(keys)][keys < 0] = -1
    return q_set, q_elt


def probe_pairs(
    dev: Optional[Dict[str, Tensor]], keys: np.ndarray, pad_to: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Batched (hit, hop) on the host, bool and int32, through the device
    pairs (one :func:`probe` at any batch size); None when there are none.
    ``keys`` is the host's packed int64 array (-1 = must-miss row)."""
    if dev is None:
        return None
    q_set, q_elt = split_keys(keys, pad_to)
    d = dev["sets"].device
    hit, hop = probe(dev["sets"], dev["elts"], dev["hops"],
                     torch.from_numpy(q_set).to(d), torch.from_numpy(q_elt).to(d))
    # one device-to-host copy for both columns
    both = torch.stack([hit, hop]).cpu().numpy()
    return both[0, : len(keys)].astype(bool), both[1, : len(keys)]
