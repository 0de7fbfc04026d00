"""The fused wave: the whole tier cascade of a chunk with one fetch (K8).

The port of the JAX package's ``engine/fused.py``.  A chunk's check rows
run as one wave of device work, enqueued with no host sync:

* **tier 0** — the Leopard closure probe (K6, ``leopard/device.py``):
  the host resolves what needs dict state into one probe mode per row
  (``closure.prep_fused_checks``), and :func:`wave_tier0` finishes the
  ``LM_PROBE`` / ``LM_HIT_ONLY`` rows with the binary search over the
  shipped pair columns, then masks the answered rows out of tier 1;
* **tier 1** — the pure-OR BFS (``fastpath._fast_pass`` and its
  kernels) over the rows still active, then ``retry_lanes`` masked re-runs
  over the full Q at the retry schedule; :func:`wave_lane` keeps the
  monotone found bits, the next lane's active row and the fallback row
  (rows still over, and first-pass rows left unfound by a dirty row);
* **tier 2** — the AND/NOT program (``algebra._run_general`` and its
  kernels) over the general rows at Q = the wave's rows, plus one masked
  retry at the retry shapes; :func:`wave_gen_lane` builds the retry's
  active row and merges its codes;
* :func:`wave_pack` writes the one int32 ``[Q + F + G]`` output: per row
  the bit field below, then tier 1's first-pass occupancy (F =
  ``len(fast_sched)``), then tier 2's (G = ``len(sizes) + 2 +
  len(fast_sched)`` of the general schedule).  Absent tiers add nothing.

=====  ==========================================================
bits   per-row meaning (first Q entries)
=====  ==========================================================
0-1    general R_* verdict code (post-retry)
2      general over (post-retry, folds retry dirty/ERR)
3      general dirty (the program needed a row the overlay marked stale)
4      fast found (monotone across retry lanes)
5      fast fallback (still over after the retry lanes)
6      leopard answered
7      leopard allowed
8      fast row entered a retry lane
9      general row entered the retry lane
=====  ==========================================================

The caller copies the output to the host once.  Each of the four wave
wrappers launches its CUDA kernel (``csrc/wave.cu``) on CUDA tensors and
runs its plain PyTorch version on CPU tensors;
:func:`run_fused_wave_plain` runs the whole wave through the plain
versions only, on whatever device the tables are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import algebra as alg
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine.optable import R_ERR
from ketotpu_torch.leopard import device as leodev
from ketotpu_torch.leopard.closure import (
    LM_ALLOW,
    LM_DENY,
    LM_HIT_ONLY,
    LM_PROBE,
)

Tensor = torch.Tensor
Tables = Dict[str, Tensor]

#: rows of the wave's query block
QPACK_ROWS = 10
_I32 = torch.int32


def _i32(x: Tensor) -> Tensor:
    return x.to(_I32)


def _check_qpack(qpack: Tensor, rows: int = QPACK_ROWS) -> int:
    q = qpack.shape[1]
    kernels.require(qpack, _I32, "qpack", shape=(rows, q))
    return q


# -- tier 0 ----------------------------------------------------------------------


def wave_tier0(qpack: Tensor, leo: Optional[Tuple[Tensor, Tensor, Tensor]], *,
               depth_slack: int, fast: bool):
    """Tier 0 of a wave (``fused.py:122-145``).  ``leo``: the shipped
    (sets, elts, hops) pair columns, or None (no search: hit and ok_depth
    false).  Returns (leo, fact): ``leo`` int32[Q] = answered | allowed <<
    1; ``fact`` tier 1's active row, fast-eligible and not answered
    (int32[Q]; None unless ``fast``)."""
    if qpack.device.type == "cpu":
        return _wave_tier0_plain(qpack, leo, depth_slack=depth_slack, fast=fast)
    dev = qpack.device
    q = _check_qpack(qpack)
    cap = steps = 0
    cols = (None, None, None)
    if leo is not None:
        cap = leo[0].shape[0]
        steps = leodev.probe_steps(cap)
        cols = tuple(kernels.require(t, _I32, name, shape=(cap,), device=dev)
                     for t, name in zip(leo, ("sets", "elts", "hops")))
    out = torch.empty(q, dtype=_I32, device=dev)
    fact = torch.empty(q, dtype=_I32, device=dev) if fast else None
    kernels.launch(
        "wave", "wave_tier0", kernels.ptr(qpack), q, *map(kernels.ptr, cols),
        cap, steps, depth_slack, kernels.ptr(out), kernels.ptr(fact),
        kernels.stream(),
    )
    kernels.LAUNCHES["wave_tier0"] += 1
    return out, fact


def _wave_tier0_plain(qpack: Tensor, leo, *, depth_slack: int, fast: bool):
    q_depth = qpack[4]
    lmode = qpack[7]
    zeros = torch.zeros(qpack.shape[1], dtype=torch.bool, device=qpack.device)
    if leo is not None:
        hit, hop = leodev._probe_plain(*leo, qpack[8], qpack[9])
        hit = hit != 0
        ok_depth = hop + depth_slack <= q_depth[0]
    else:
        hit = ok_depth = zeros
    probe = lmode == LM_PROBE
    hit_only = lmode == LM_HIT_ONLY
    pass_ans = ok_depth | ~hit
    ans = torch.where(probe, pass_ans, (lmode == LM_ALLOW) | (lmode == LM_DENY)
                      | (hit_only & hit & ok_depth))
    allow = torch.where(probe, pass_ans & hit, (lmode == LM_ALLOW)
                        | (hit_only & hit & ok_depth))
    out = _i32(ans) | (_i32(allow) << 1)
    fact = _i32((qpack[5] != 0) & ~ans) if fast else None
    return out, fact


# -- tier 1's lanes ----------------------------------------------------------------


def wave_lane(act: Tensor, pfound: Tensor, pover: Tensor, pdirty: Tensor,
              found: Optional[Tensor], retried: Optional[Tensor],
              fb: Optional[Tensor], *, more: bool):
    """After one tier-1 pass over the active rows ``act`` with results
    ``pfound`` / ``pover`` / ``pdirty`` (``fused.py:158-173``): returns
    (found, unres, retried, fb).  After the first pass (``found``,
    ``retried`` and ``fb`` None): ``found`` the pass's own found bits,
    ``unres`` the rows over, not found and not dirty (a retry would read
    the same stale row), ``fb`` the dirty unfound rows plus ``unres``.
    After a retry lane: ``found | act & pfound``, ``unres`` the lane's
    rows still over or dirty and not found, ``fb`` the earlier dirty rows
    (``fb & ~act``) plus ``unres``.  ``unres`` is the next lane's active
    row; ``fb`` after the last pass is the fast fallback,
    ``(fast_act & dirty1 & ~found1) | unres``.  ``retried`` gains
    ``unres`` when ``more`` lanes follow."""
    if act.device.type == "cpu":
        return _wave_lane_plain(act, pfound, pover, pdirty, found, retried, fb,
                                more=more)
    dev = act.device
    q = act.shape[0]
    for t, name in ((act, "act"), (pfound, "pfound"), (pover, "pover"),
                    (pdirty, "pdirty"), (found, "found"), (retried, "retried"),
                    (fb, "fb")):
        if t is not None:
            kernels.require(t, _I32, name, shape=(q,), device=dev)
    if (found is None) != (retried is None) or (found is None) != (fb is None):
        raise ValueError("found, retried and fb come together")
    outs = [torch.empty(q, dtype=_I32, device=dev) for _ in range(4)]
    kernels.launch(
        "wave", "wave_lane", kernels.ptr(act), kernels.ptr(pfound),
        kernels.ptr(pover), kernels.ptr(pdirty), kernels.ptr(found),
        kernels.ptr(retried), kernels.ptr(fb), q, int(more),
        *map(kernels.ptr, outs), kernels.stream(),
    )
    kernels.LAUNCHES["wave_lane"] += 1
    return tuple(outs)


def _wave_lane_plain(act, pfound, pover, pdirty, found, retried, fb, *,
                     more: bool):
    a, f, o, d = act != 0, pfound != 0, pover != 0, pdirty != 0
    if found is None:
        found_out = f
        unres = a & o & ~f & ~d
        fb_out = (a & d & ~f) | unres
    else:
        found_out = (found != 0) | (a & f)
        unres = a & (o | d) & ~f
        fb_out = ((fb != 0) & ~a) | unres
    ret = torch.zeros_like(a) if retried is None else retried != 0
    if more:
        ret = ret | unres
    return _i32(found_out), _i32(unres), _i32(ret), _i32(fb_out)


# -- tier 2's retry lane -------------------------------------------------------------


def wave_gen_lane(gcodes: Tensor, gact: Tensor,
                  rcodes: Optional[Tensor] = None,
                  ract: Optional[Tensor] = None) -> Tensor:
    """The general retry lane (``fused.py:193-211``).  Without ``rcodes``:
    the retry's active row (int32[Q]), general (``gact``, the wave's
    general row) & over & ~dirty & code != R_ERR of the first pass's codes
    ``gcodes`` (uint8[Q]).  With the retry's codes ``rcodes`` and its
    active row ``ract``: the merged int32[Q] bits code | over << 2 | dirty
    << 3 | retried << 9."""
    if gcodes.device.type == "cpu":
        return _wave_gen_lane_plain(gcodes, gact, rcodes, ract)
    dev = gcodes.device
    q = gcodes.shape[0]
    kernels.require(gcodes, torch.uint8, "gcodes", shape=(q,), device=dev)
    kernels.require(gact, _I32, "gact", shape=(q,), device=dev)
    if rcodes is not None:
        kernels.require(rcodes, torch.uint8, "rcodes", shape=(q,), device=dev)
        kernels.require(ract, _I32, "ract", shape=(q,), device=dev)
    out = torch.empty(q, dtype=_I32, device=dev)
    kernels.launch(
        "wave", "wave_gen_lane", kernels.ptr(gcodes), kernels.ptr(gact), q,
        kernels.ptr(rcodes), kernels.ptr(ract), kernels.ptr(out),
        kernels.stream(),
    )
    kernels.LAUNCHES["wave_gen_lane"] += 1
    return out


def _wave_gen_lane_plain(gcodes, gact, rcodes=None, ract=None):
    c = _i32(gcodes)
    code = c & 3
    over = ((c >> 2) & 1) != 0
    dirty = ((c >> 3) & 1) != 0
    if rcodes is None:
        return _i32((gact != 0) & over & ~dirty & (code != R_ERR))
    gunres = ract != 0
    r = _i32(rcodes)
    rcode = r & 3
    rover = (((r >> 2) | (r >> 3)) & 1 != 0) | (rcode == R_ERR)
    code = torch.where(gunres, rcode, code)
    over = torch.where(gunres, rover, over)
    return code | (_i32(over) << 2) | (_i32(dirty) << 3) | (_i32(gunres) << 9)


# -- the output ------------------------------------------------------------------------


def wave_pack(leo: Tensor, found: Optional[Tensor], fast_fb: Optional[Tensor],
              retried: Optional[Tensor], gcodes: Optional[Tensor],
              gbits: Optional[Tensor], focc: Optional[Tensor],
              gocc: Optional[Tensor]) -> Tensor:
    """The wave's int32[Q + F + G] output (``fused.py:214-225``): the row
    bit field from tier 0's ``leo``, tier 1's ``found`` / ``fast_fb`` /
    ``retried`` and tier 2's merged ``gbits`` (or, with no general retry,
    its codes ``gcodes`` & 15), then the occupancy vectors ``focc`` and
    ``gocc``.  An absent tier's inputs are None."""
    if leo.device.type == "cpu":
        return _wave_pack_plain(leo, found, fast_fb, retried, gcodes, gbits,
                                focc, gocc)
    dev = leo.device
    q = leo.shape[0]
    kernels.require(leo, _I32, "leo", shape=(q,))
    for t, name in ((found, "found"), (fast_fb, "fast_fb"), (retried, "retried"),
                    (gbits, "gbits")):
        if t is not None:
            kernels.require(t, _I32, name, shape=(q,), device=dev)
    if (found is None) != (fast_fb is None) or (found is None) != (retried is None):
        raise ValueError("found, fast_fb and retried come together")
    if gcodes is not None:
        kernels.require(gcodes, torch.uint8, "gcodes", shape=(q,), device=dev)
    nf = 0 if focc is None else focc.shape[0]
    ng = 0 if gocc is None else gocc.shape[0]
    for t, name in ((focc, "focc"), (gocc, "gocc")):
        if t is not None:
            kernels.require(t, _I32, name, device=dev)
    out = torch.empty(q + nf + ng, dtype=_I32, device=dev)
    kernels.launch(
        "wave", "wave_pack", q, kernels.ptr(leo), kernels.ptr(found),
        kernels.ptr(fast_fb), kernels.ptr(retried), kernels.ptr(gcodes),
        kernels.ptr(gbits), kernels.ptr(focc), nf, kernels.ptr(gocc), ng,
        kernels.ptr(out), kernels.stream(),
    )
    kernels.LAUNCHES["wave_pack"] += 1
    return out


def _wave_pack_plain(leo, found, fast_fb, retried, gcodes, gbits, focc, gocc):
    if gbits is not None:
        rows = gbits.clone()
    elif gcodes is not None:
        rows = _i32(gcodes) & 15
    else:
        rows = torch.zeros_like(leo)
    rows = rows | ((leo & 1) << 6) | (((leo >> 1) & 1) << 7)
    if found is not None:
        rows = (rows | (_i32(found != 0) << 4) | (_i32(fast_fb != 0) << 5)
                | (_i32(retried != 0) << 8))
    return torch.cat([rows] + [t for t in (focc, gocc) if t is not None])


# -- the wave ------------------------------------------------------------------------


class WaveOps(NamedTuple):
    """The steps of a wave: its four own kernels' wrappers (or their plain
    versions) and the tier-1 and tier-2 steps it runs."""

    tier0: object
    lane: object
    gen_lane: object
    pack: object
    fast: fp._Ops
    gen: alg._GenOps


OPS = WaveOps(wave_tier0, wave_lane, wave_gen_lane, wave_pack, fp._OPS,
              alg._OPS)
PLAIN_OPS = WaveOps(_wave_tier0_plain, _wave_lane_plain, _wave_gen_lane_plain,
                    _wave_pack_plain, fp._PLAIN_OPS, alg._PLAIN_OPS)


def run_fused_wave(
    g: Tables,
    qpack,
    *,
    fast_sched: Optional[Tuple[Tuple[int, int], ...]],
    retry_sched: Optional[Tuple[Tuple[int, int], ...]],
    retry_lanes: int,
    gen: Optional[Tuple],
    gen_retry: Optional[Tuple],
    max_width: int = 100,
    depth_slack: int = 2,
) -> Tensor:
    """Enqueue one wave; returns the uncollected int32[Q + F + G] tensor on
    the tables' device (the caller's one copy to the host is the wave's
    fetch).  ``qpack``: int32[10, Q], numpy or a tensor.  ``g``: the check
    tables, with ``leo_sets`` / ``leo_elts`` / ``leo_hops`` when tier 0 has
    pair columns.  ``fast_sched`` None drops tier 1 and its lanes, ``gen``
    None tier 2 and its retry; ``gen`` and ``gen_retry`` are (sizes,
    fast_b, fast_sched, vcap) schedules.  On CUDA tables every step
    launches a kernel."""
    return run_wave(OPS, g, qpack, fast_sched=fast_sched,
                    retry_sched=retry_sched, retry_lanes=retry_lanes, gen=gen,
                    gen_retry=gen_retry, max_width=max_width,
                    depth_slack=depth_slack)


def run_fused_wave_plain(
    g: Tables,
    qpack,
    *,
    fast_sched: Optional[Tuple[Tuple[int, int], ...]],
    retry_sched: Optional[Tuple[Tuple[int, int], ...]],
    retry_lanes: int,
    gen: Optional[Tuple],
    gen_retry: Optional[Tuple],
    max_width: int = 100,
    depth_slack: int = 2,
) -> Tensor:
    """:func:`run_fused_wave` through the plain PyTorch versions only, on
    whatever device the tables are: it launches no kernel."""
    return run_wave(PLAIN_OPS, g, qpack, fast_sched=fast_sched,
                    retry_sched=retry_sched, retry_lanes=retry_lanes, gen=gen,
                    gen_retry=gen_retry, max_width=max_width,
                    depth_slack=depth_slack)


def run_wave(ops: WaveOps, g: Tables, qpack, *, fast_sched, retry_sched,
             retry_lanes: int, gen, gen_retry, max_width: int,
             depth_slack: int) -> Tensor:
    """The wave over the steps of ``ops`` (``fused.py:85`` _wave_body)."""
    dev = g["row_ptr"].device
    if isinstance(qpack, Tensor):
        qp = qpack.to(device=dev, dtype=_I32).contiguous()
    else:
        qp = torch.from_numpy(np.ascontiguousarray(qpack, np.int32)).to(dev)
    q = qp.shape[1]
    leo = None
    if "leo_sets" in g:
        leo = (g["leo_sets"], g["leo_elts"], g["leo_hops"])
    leo_bits, fact = ops.tier0(qp, leo, depth_slack=depth_slack,
                               fast=fast_sched is not None)

    found = fast_fb = retried = focc = None
    if fast_sched is not None:
        focc = torch.zeros(len(fast_sched), dtype=_I32, device=dev)
        pfound, pover, pdirty = fp._fast_pass(ops.fast, g, qp, fact, fast_sched,
                                              max_width=max_width, occ=focc)
        found, unres, retried, fb = ops.lane(fact, pfound, pover, pdirty, None,
                                             None, None, more=retry_lanes > 0)
        for lane in range(retry_lanes):
            # the lane's active rows are the last pass's unresolved ones;
            # its occupancy is not returned
            act = unres
            rocc = torch.zeros(len(retry_sched), dtype=_I32, device=dev)
            rfound, rover, rdirty = fp._fast_pass(
                ops.fast, g, qp, act, retry_sched, max_width=max_width,
                occ=rocc)
            found, unres, retried, fb = ops.lane(
                act, rfound, rover, rdirty, found, retried, fb,
                more=lane + 1 < retry_lanes)
        fast_fb = fb

    gcodes = gbits = gocc = None
    if gen is not None:
        gact = qp[6]
        sizes, fast_b, gsched, vcap = gen
        _res, st = alg._run_general(ops.gen, g, qp, sizes, fast_b, gsched,
                                    max_width, vcap, act=gact)
        gcodes, gocc = st.out[:q], st.occ()
        if gen_retry is not None:
            ract = ops.gen_lane(gcodes, gact)
            sizes, fast_b, gsched, vcap = gen_retry
            _rres, rst = alg._run_general(ops.gen, g, qp, sizes, fast_b,
                                          gsched, max_width, vcap, act=ract)
            gbits = ops.gen_lane(gcodes, gact, rst.out[:q], ract)
            gcodes = None
    return ops.pack(leo_bits, found, fast_fb, retried, gcodes, gbits, focc,
                    gocc)
