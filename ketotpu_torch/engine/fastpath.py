"""Pure-OR BFS fast path: batched reachability checks with a monotone found-bit.

The port of the JAX package's ``engine/fastpath.py`` (tier 1 of a Check
batch).  The checkgroup OR semantics of the reference collapse three-valued
logic at every level (`checkgroup/concurrent_checkgroup.go:108-123`), so a
query whose rewrite closure has no AND / NOT and no error-raising lookup is
*depth-bounded multi-source reachability*: the verdict is IS iff some
membership probe fires within the depth budget.  A batch is a frontier of
``(query, namespace, object, relation, depth, skip, force)`` items and a
per-query ``found`` bit fed by three probe families — direct membership
(`engine.go:167-208`), the computed-subject-set shortcut
(`rewrites.go:62-93`) and the EXISTS bit of subject-set expansion edges
(`engine.go:131-139`) — and one level per step expands subject-set CSR
rows, flattened computed-subject-set entries and tuple-to-userset rows.
Depth strictly decreases per level, so a batch ends after ``max_depth``
levels; an arena or frontier overflow poisons only the not-yet-found
queries it touched (``q_over``), which the engine retries at wider caps.

One level runs as four CUDA kernel modules, each with its plain PyTorch
version beside its wrapper here (the wrapper takes the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises):

* :func:`probe_level` (``csrc/probe.cu``) — node and membership probes,
  the found bits, the child segment lengths;
* :func:`xutil.arena_assign` (``csrc/arena.cu``) — arena allocation;
* :func:`expand_children` (``csrc/children.cu``) — one child per arena slot;
* :func:`_pack_scatter` (``csrc/pack.cu``) — dedup + compaction into the
  next frontier; :func:`init_state` and :func:`pack_verdicts` (also
  ``pack.cu``) — the packed query block in, the verdict bytes out.

:func:`run_fast_packed` enqueues every level of a batch on the current
stream with no host sync; the caller fetches verdicts and occupancy with
one device-to-host copy (:meth:`Packed.fetch`).

Queries, frontier columns and the found/over bits are int32 (skip/force
bool); found/over are 0/1 int32 so the kernels can OR them atomically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import hashtab
from ketotpu_torch.engine.xutil import _arena_assign_plain, arena_assign

Tensor = torch.Tensor
Tables = Dict[str, Tensor]

ITEM_COLS = ("qid", "ns", "obj", "rel", "d", "skip", "force")
_PACK_SALT = 0x9E3779B9
_SCAN_TILE = 4096  # csrc/scan.cuh kScanTile: elements per scan block


@dataclass
class Items:
    """A frontier, or one level's arena of children: seven equal columns."""

    qid: Tensor  # int32; -1 = empty / dead
    ns: Tensor  # int32
    obj: Tensor  # int32
    rel: Tensor  # int32
    d: Tensor  # int32 remaining depth
    skip: Tensor  # bool: skip the direct probe
    force: Tensor  # bool: probe membership regardless of depth

    @classmethod
    def empty(cls, n: int, device) -> "Items":
        i32 = dict(dtype=torch.int32, device=device)
        b = dict(dtype=torch.bool, device=device)
        return cls(
            torch.empty(n, **i32), torch.empty(n, **i32), torch.empty(n, **i32),
            torch.empty(n, **i32), torch.empty(n, **i32), torch.empty(n, **b),
            torch.empty(n, **b),
        )

    @classmethod
    def dead(cls, n: int, device) -> "Items":
        """n empty items, as ``expand_phase`` returns for a probe-only level."""
        i32 = dict(dtype=torch.int32, device=device)
        b = dict(dtype=torch.bool, device=device)
        return cls(
            torch.full((n,), -1, **i32), torch.full((n,), -1, **i32),
            torch.full((n,), -1, **i32), torch.full((n,), -1, **i32),
            torch.zeros(n, **i32), torch.zeros(n, **b), torch.zeros(n, **b),
        )


@dataclass
class LevelProbe:
    """Per-item outputs of the probe pass that the child pass reads."""

    node: Tensor  # int32[F] resolved node id of the item, -1 if none
    exp_deg: Tensor  # int32[F] expansion segment length (full row degree)
    ttu_node: Tensor  # int32[F, Kt] node of each TTU via relation
    seg_cum: Tensor  # int32[F, 1+Kc+Kt] running sums of the segments
    counts: Tensor  # int32[F] children requested (seg_cum[:, -1])


def _dims(g: Tables) -> Tuple[int, int, int, int]:
    ns_dim, rel_dim = g["f_direct_ok"].shape
    return ns_dim, rel_dim, g["f_css_rel"].shape[2], g["f_ttu_via"].shape[2]


# -- device helpers, plain form (K2; the CUDA form is csrc/common.cuh) -------


def _node_lookup(g: Tables, ns, obj, rel):
    """(ns, obj, rel) -> node id or -1.  Stride = padded relation count."""
    num_rels = g["f_direct_ok"].shape[1]
    hi = ns * num_rels + rel
    ok = (ns >= 0) & (obj >= 0) & (rel >= 0)
    idx, found = hashtab.lookup(hashtab.subtables(g, "nt_"), hi, obj)
    return torch.where(found & ok, idx, -1).to(torch.int32)


def _member(g: Tables, node, subj):
    """Does tuple (node, subject) exist?  ExistsRelationTuples equivalent."""
    _, found = hashtab.lookup(hashtab.subtables(g, "mt_"), node, subj)
    return found


def _row_deg(g: Tables, node):
    rp = g["row_ptr"]
    safe = node.clamp(0, rp.shape[0] - 2).to(torch.int64)
    deg = rp[safe + 1] - rp[safe]
    return torch.where(node >= 0, deg, 0).to(torch.int32)


def _scatter_or(flags: Tensor, idx: Tensor, bits: Tensor) -> Tensor:
    """flags with ``flags[idx] |= bits`` (0/1 int32; a scatter-max)."""
    return flags.scatter_reduce(0, idx.to(torch.int64), bits.to(torch.int32), "amax")


# -- roots (K5: _init_state) ---------------------------------------------------


def init_state(qpack: Tensor, *, frontier: int, levels: int, occ_out: Tensor):
    """Roots in slots 0..Q-1 of a ``frontier``-slot frontier from the packed
    int32[6, Q] block (ns, obj, rel, subj, depth, active); inactive queries
    never enter.  Depth is clamped to ``levels`` (the final level is probe
    only, which is sound only for d <= 1).  Writes the live-root count into
    ``occ_out`` (int32[1]).  Returns (frontier, q_found, q_over, q_subj)."""
    q = qpack.shape[1]
    if q > frontier:
        raise ValueError(f"batch {q} exceeds frontier capacity {frontier}")
    if qpack.device.type == "cpu":
        return _init_state_plain(qpack, frontier=frontier, levels=levels,
                                 occ_out=occ_out)
    kernels.require(qpack, torch.int32, "qpack", shape=(6, q))
    kernels.require(occ_out, torch.int32, "occ_out", shape=(1,), device=qpack.device)
    dev = qpack.device
    f = Items.empty(frontier, dev)
    q_found = torch.empty(q, dtype=torch.int32, device=dev)
    q_over = torch.empty(q, dtype=torch.int32, device=dev)
    kernels.launch(
        "pack", "init_state", kernels.ptr(qpack), q, levels, kernels.items(f),
        kernels.ptr(q_found), kernels.ptr(q_over), kernels.ptr(occ_out),
        kernels.stream(),
    )
    kernels.LAUNCHES["init_state"] += 1
    return f, q_found, q_over, qpack[3]


def _init_state_plain(qpack: Tensor, *, frontier: int, levels: int, occ_out: Tensor):
    q = qpack.shape[1]
    dev = qpack.device
    iota = torch.arange(frontier, dtype=torch.int32, device=dev)
    act = torch.zeros(frontier, dtype=torch.bool, device=dev)
    act[:q] = qpack[5] != 0
    in_q = (iota < q) & act

    def pad(row, fill):
        x = torch.full((frontier,), fill, dtype=torch.int32, device=dev)
        x[:q] = qpack[row]
        return torch.where(in_q, x, fill)

    f = Items(
        qid=torch.where(in_q, iota, -1),
        ns=pad(0, -1),
        obj=pad(1, -1),
        rel=pad(2, -1),
        d=pad(4, 0).clamp(max=levels),
        skip=torch.zeros(frontier, dtype=torch.bool, device=dev),
        force=torch.zeros(frontier, dtype=torch.bool, device=dev),
    )
    occ_out.copy_(in_q.sum(dtype=torch.int32).reshape(1))
    zeros = torch.zeros(q, dtype=torch.int32, device=dev)
    return f, zeros, zeros.clone(), qpack[3]


# -- one level, probe half (K1 + K2 + K3) --------------------------------------


def probe_level(g: Tables, f: Items, q_found: Tensor, q_subj: Tensor, *,
                probe_only: bool = False):
    """Probes of one level.  Returns (q_found', LevelProbe); a probe-only
    level (the final one: no item there can have children) returns only
    the node column in its LevelProbe and skips the segment pass."""
    if f.qid.device.type == "cpu":
        return _probe_level_plain(g, f, q_found, q_subj, probe_only=probe_only)
    dev = f.qid.device
    n = f.qid.shape[0]
    nq = q_found.shape[0]
    _, _, kc, kt = _dims(g)
    kernels.require(q_found, torch.int32, "q_found", device=dev)
    kernels.require(q_subj, torch.int32, "q_subj", shape=(nq,), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    q_found_out = torch.empty(nq, **i32)
    lv = LevelProbe(torch.empty(n, **i32), None, None, None, None)
    if not probe_only:
        lv.exp_deg = torch.empty(n, **i32)
        lv.ttu_node = torch.empty((n, kt), **i32)
        lv.seg_cum = torch.empty((n, 1 + kc + kt), **i32)
        lv.counts = torch.empty(n, **i32)
    kernels.launch(
        "probe", "probe_level", kernels.graph(g), kernels.items(f),
        kernels.ptr(q_found), kernels.ptr(q_found_out), kernels.ptr(q_subj), nq,
        kernels.ptr(lv.node), kernels.ptr(lv.exp_deg), kernels.ptr(lv.ttu_node),
        kernels.ptr(lv.seg_cum), kernels.ptr(lv.counts), int(probe_only),
        kernels.stream(),
    )
    kernels.LAUNCHES["probe_level"] += 1
    return q_found_out, lv


def _probe_level_plain(g: Tables, f: Items, q_found: Tensor, q_subj: Tensor, *,
                       probe_only: bool = False):
    NS, R, Kc, Kt = _dims(g)
    Q = q_found.shape[0]
    qid, ns, obj, rel, d = f.qid, f.ns, f.obj, f.rel, f.d
    qc = qid.clamp(0, Q - 1).to(torch.int64)
    live = (qid >= 0) & (q_found[qc] == 0)  # short-circuit: found queries stop
    subj = q_subj[qc]
    nsc = ns.clamp(0, NS - 1).to(torch.int64)
    relc = rel.clamp(0, R - 1).to(torch.int64)
    cfg = (ns >= 0) & (ns < NS) & (rel >= 0) & (rel < R)
    node = _node_lookup(g, ns, obj, rel)

    dok = torch.where(cfg, g["f_direct_ok"][nsc, relc], True) & ~f.skip
    eok = torch.where(cfg, g["f_expand_ok"][nsc, relc], True)

    # direct: counts only when d >= 2 (engine.go:242); a forced probe stands
    # in for the parent's expansion EXISTS bit and ignores depth
    found = live & _member(g, node, subj) & ((dok & (d >= 2)) | f.force)

    # batched computed-subject-set probes (rewrites.go:62-93)
    css_rel = torch.where(cfg[:, None], g["f_css_rel"][nsc, relc], -1)  # [F,Kc]
    css_dec = g["f_css_dec"][nsc, relc]
    css_probe = g["f_css_probe"][nsc, relc]
    css_ok = live[:, None] & (css_rel >= 0) & (d[:, None] - css_dec >= 1)
    for k in range(Kc):
        cnode = _node_lookup(g, ns, obj, css_rel[:, k])
        found = found | (css_ok[:, k] & css_probe[:, k] & _member(g, cnode, subj))

    q_found = _scatter_or(q_found, qc, found)
    if probe_only:
        return q_found, LevelProbe(node, None, None, None, None)
    live2 = live & (q_found[qc] == 0)

    # segments: [expansion | css 0..Kc | ttu 0..Kt]; the full row degree
    # is taken so found bits cover pre-truncation results (engine.go:131-139)
    exp_read = live2 & eok & (d >= 2)
    exp_deg = torch.where(exp_read, _row_deg(g, node), 0).to(torch.int32)
    css_need = (css_ok & live2[:, None] & (d[:, None] - css_dec - 1 >= 1)).to(
        torch.int32
    )
    ttu_via = torch.where(cfg[:, None], g["f_ttu_via"][nsc, relc], -1)  # [F,Kt]
    ttu_dec = g["f_ttu_dec"][nsc, relc]
    # TTU rows only matter when d - dec >= 2 (rewrites.go:247, :281)
    ttu_ok = live2[:, None] & (ttu_via >= 0) & (d[:, None] - ttu_dec >= 2)
    ttu_nodes = []
    ttu_degs = []
    for k in range(Kt):
        tn = _node_lookup(g, ns, obj, ttu_via[:, k])
        ttu_nodes.append(tn)
        ttu_degs.append(torch.where(ttu_ok[:, k], _row_deg(g, tn), 0).to(torch.int32))
    seg_len = torch.stack(
        [exp_deg] + [css_need[:, k] for k in range(Kc)] + ttu_degs, dim=1
    )
    seg_cum = torch.cumsum(seg_len, dim=1, dtype=torch.int32)
    return q_found, LevelProbe(
        node=node,
        exp_deg=exp_deg,
        ttu_node=torch.stack(ttu_nodes, dim=1),
        seg_cum=seg_cum,
        counts=seg_cum[:, -1].contiguous(),
    )


# -- one level, child half (K3) ------------------------------------------------


def expand_children(g: Tables, f: Items, lv: LevelProbe, offsets: Tensor,
                    parent: Tensor, ordinal: Tensor, q_found: Tensor,
                    q_over: Tensor, *, max_width: int):
    """Children of one level into the arena (``parent.shape[0]`` slots):
    capacity check per task (overflow marks the query over), segment
    decode, edge gathers, width truncation, skip/force.  Returns
    (children, q_over')."""
    if f.qid.device.type == "cpu":
        return _expand_children_plain(g, f, lv, offsets, parent, ordinal,
                                      q_found, q_over, max_width=max_width)
    dev = f.qid.device
    n = f.qid.shape[0]
    a = parent.shape[0]
    nq = q_found.shape[0]
    _, _, kc, kt = _dims(g)
    for name, t, shape in (
        ("node", lv.node, (n,)), ("exp_deg", lv.exp_deg, (n,)),
        ("ttu_node", lv.ttu_node, (n, kt)), ("seg_cum", lv.seg_cum, (n, 1 + kc + kt)),
        ("offsets", offsets, (n,)), ("counts", lv.counts, (n,)),
        ("parent", parent, (a,)), ("ordinal", ordinal, (a,)),
        ("q_found", q_found, (nq,)), ("q_over", q_over, (nq,)),
    ):
        kernels.require(t, torch.int32, name, shape=shape, device=dev)
    out = Items.empty(a, dev)
    q_over_out = torch.empty(nq, dtype=torch.int32, device=dev)
    kernels.launch(
        "children", "expand_children", kernels.graph(g), kernels.items(f),
        kernels.ptr(lv.node), kernels.ptr(lv.exp_deg), kernels.ptr(lv.ttu_node),
        kernels.ptr(lv.seg_cum), kernels.ptr(offsets), kernels.ptr(lv.counts),
        kernels.ptr(parent), kernels.ptr(ordinal), kernels.ptr(q_found),
        kernels.ptr(q_over), kernels.ptr(q_over_out), nq, max_width,
        kernels.items(out), kernels.stream(),
    )
    kernels.LAUNCHES["expand_children"] += 1
    return out, q_over_out


def _expand_children_plain(g: Tables, f: Items, lv: LevelProbe, offsets, parent,
                           ordinal, q_found, q_over, *, max_width: int):
    NS, R, Kc, Kt = _dims(g)
    F = f.qid.shape[0]
    Q = q_found.shape[0]
    A = parent.shape[0]
    S = 1 + Kc + Kt
    counts = lv.counts
    fits = offsets + counts <= A
    # counts > 0 implies the item's query was live after this level's
    # probes (every segment is gated on it), so qid >= 0 here
    q_over = _scatter_or(q_over, f.qid.clamp(0, Q - 1), (counts > 0) & ~fits)

    ap, ao = parent, ordinal
    aps = ap.clamp(0, F - 1).to(torch.int64)
    src_ok = (ap >= 0) & fits[aps]

    # segment decomposition per arena slot
    cum_p = lv.seg_cum[aps]  # [A, S]
    seg_idx = (ao[:, None] >= cum_p).sum(dim=1).clamp(0, S - 1)
    prev = torch.gather(cum_p, 1, (seg_idx - 1).clamp(0, S - 1)[:, None])[:, 0]
    prev_cum = torch.where(seg_idx > 0, prev, 0)
    off = ao - prev_cum

    p_ns, p_obj, p_d, p_qid = f.ns[aps], f.obj[aps], f.d[aps], f.qid[aps]

    is_exp = src_ok & (seg_idx == 0)
    is_css = src_ok & (seg_idx >= 1) & (seg_idx <= Kc)
    css_k = (seg_idx - 1).clamp(0, Kc - 1)
    is_ttu = src_ok & (seg_idx > Kc)
    ttu_k = (seg_idx - 1 - Kc).clamp(0, Kt - 1)

    # the parents' table fields, per slot
    nsc = f.ns.clamp(0, NS - 1).to(torch.int64)
    relc = f.rel.clamp(0, R - 1).to(torch.int64)
    cfg = (f.ns >= 0) & (f.ns < NS) & (f.rel >= 0) & (f.rel < R)
    css_rel = torch.where(cfg[:, None], g["f_css_rel"][nsc, relc], -1)[aps]
    css_dec = g["f_css_dec"][nsc, relc][aps]
    ttu_tgt = g["f_ttu_tgt"][nsc, relc][aps]
    ttu_dec = g["f_ttu_dec"][nsc, relc][aps]

    def pick(cols, k):
        return torch.gather(cols, 1, k.to(torch.int64)[:, None])[:, 0]

    # edge gathers for expansion / ttu rows
    rp = g["row_ptr"]
    rmax = rp.shape[0] - 2
    base_exp = rp[lv.node[aps].clamp(0, rmax).to(torch.int64)]
    ttu_node_p = pick(lv.ttu_node[aps], ttu_k)
    base_ttu = rp[ttu_node_p.clamp(0, rmax).to(torch.int64)]
    eidx = (torch.where(is_ttu, base_ttu, base_exp) + off).clamp(
        0, g["edge_hi"].shape[0] - 1
    ).to(torch.int64)
    e_hi, e_obj = g["edge_hi"][eidx], g["edge_obj"][eidx]
    e_ns = torch.where(e_hi >= 0, e_hi // R, -1)
    e_rel = torch.where(e_hi >= 0, e_hi % R, -1)

    css_rel_p = pick(css_rel, css_k)
    css_dec_p = pick(css_dec, css_k)
    ttu_tgt_p = pick(ttu_tgt, ttu_k)
    ttu_dec_p = pick(ttu_dec, ttu_k)

    ch_ns = torch.where(is_css, p_ns, e_ns)
    ch_obj = torch.where(is_css, p_obj, e_obj)
    ch_rel = torch.where(is_css, css_rel_p, torch.where(is_ttu, ttu_tgt_p, e_rel))
    ch_d = torch.where(
        is_css, p_d - css_dec_p - 1, torch.where(is_ttu, p_d - ttu_dec_p - 1, p_d - 1)
    )
    # expansion and batched CSS children skip the direct re-check
    # (engine.go:161, rewrites.go:86); TTU children do not (rewrites.go:281)
    ch_skip = is_exp | is_css
    ch_qid = torch.where(src_ok, p_qid, -1)
    # width truncation applies to recursion only (engine.go:141-150);
    # truncated expansion children ship probe-only (d = 0) with force set
    trunc = is_exp & (lv.exp_deg[aps] > max_width) & (off >= max_width - 1)
    ch_d = torch.where(trunc, 0, ch_d)
    alive = src_ok & (is_exp | (ch_d >= 1))
    alive = alive & (q_found[ch_qid.clamp(0, Q - 1).to(torch.int64)] == 0)

    children = Items(
        qid=torch.where(alive, ch_qid, -1).to(torch.int32),
        ns=ch_ns.to(torch.int32),
        obj=ch_obj.to(torch.int32),
        rel=ch_rel.to(torch.int32),
        d=ch_d.clamp(min=0).to(torch.int32),
        skip=ch_skip,
        force=is_exp,
    )
    return children, q_over


def expand_phase(g: Tables, f: Items, q_found: Tensor, q_over: Tensor,
                 q_subj: Tensor, *, arena: int, max_width: int,
                 probe_only: bool = False):
    """Probes + child construction of one level (the JAX ``expand_phase``).
    Returns (children[arena], q_found', q_over')."""
    q_found, lv = probe_level(g, f, q_found, q_subj, probe_only=probe_only)
    if probe_only:
        return Items.dead(arena, f.qid.device), q_found, q_over
    offsets, _total, parent, ordinal = arena_assign(lv.counts, arena)
    children, q_over = expand_children(
        g, f, lv, offsets, parent, ordinal, q_found, q_over, max_width=max_width
    )
    return children, q_found, q_over


# -- dedup + compaction into the next frontier (K5) ----------------------------


def _pack_bits(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def pack_phase(children: Items, q_found: Tensor, q_over: Tensor, *,
               frontier: int, ns_dim: int, rel_dim: int,
               occ_out: Optional[Tensor] = None):
    """Dedup by (query, node) — max depth, min skip, max force — and compact
    the survivors into the next frontier.  Returns (frontier, q_over').

    Only the linear hash-scatter form is ported: it needs (qid, ns, rel) to
    pack into 31 bits, which holds for every batch of up to 2^(31 - ns bits
    - rel bits) queries (2^21 at the synth graph's NS=4, R=16)."""
    qb = _pack_bits(q_found.shape[0])
    nsb = _pack_bits(ns_dim)
    relb = _pack_bits(rel_dim)
    if qb + nsb + relb > 31:
        raise NotImplementedError(
            f"sort-based pack for {qb}+{nsb}+{relb} key bits is not ported"
        )
    return _pack_scatter(children, q_found, q_over, frontier=frontier,
                         nsb=nsb, relb=relb, occ_out=occ_out)


def _pack_scatter(children: Items, q_found: Tensor, q_over: Tensor, *,
                  frontier: int, nsb: int, relb: int,
                  occ_out: Optional[Tensor] = None):
    """Linear hash-scatter merge: every alive child scatters into a 2A-slot
    table; the max-index child per slot owns it; children with the owner's
    key merge into it (max d, min skip, max force); alive colliders of other
    keys pass through.  Survivors compact by prefix sum; those past
    ``frontier`` mark their query over.  ``occ_out`` (int32[1]) receives
    the number of live items placed."""
    if children.qid.device.type == "cpu":
        return _pack_scatter_plain(children, q_found, q_over, frontier=frontier,
                                   nsb=nsb, relb=relb, occ_out=occ_out)
    dev = children.qid.device
    a = children.qid.shape[0]
    nq = q_found.shape[0]
    h = 1 << max((2 * a - 1).bit_length(), 4)
    kernels.require(q_found, torch.int32, "q_found", device=dev)
    kernels.require(q_over, torch.int32, "q_over", shape=(nq,), device=dev)
    if occ_out is not None:
        kernels.require(occ_out, torch.int32, "occ_out", shape=(1,), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.empty((4, h), **i32)  # own, d, skip, force
    per_child = torch.empty((3, a), **i32)  # hash slot, survivor, position
    total = torch.empty(1, **i32)
    block_sums = torch.empty(-(-max(a, 1) // _SCAN_TILE), **i32)
    out = Items.empty(frontier, dev)
    q_over_out = torch.empty(nq, **i32)
    kernels.launch(
        "pack", "pack_scatter", kernels.items(children), kernels.ptr(q_found),
        kernels.ptr(q_over), kernels.ptr(q_over_out), nq, nsb, relb, h,
        kernels.ptr(table[0]), kernels.ptr(table[1]), kernels.ptr(table[2]),
        kernels.ptr(table[3]), kernels.ptr(per_child[0]),
        kernels.ptr(per_child[1]), kernels.ptr(per_child[2]),
        kernels.ptr(total), kernels.ptr(block_sums), kernels.items(out),
        kernels.ptr(occ_out), kernels.stream(),
    )
    kernels.LAUNCHES["pack_scatter"] += 1
    return out, q_over_out


def _pack_scatter_plain(children: Items, q_found, q_over, *, frontier: int,
                        nsb: int, relb: int, occ_out: Optional[Tensor] = None):
    F = frontier
    dev = children.qid.device
    Q = q_found.shape[0]
    A = children.qid.shape[0]
    H = 1 << max((2 * A - 1).bit_length(), 4)
    qid = children.qid
    alive = (qid >= 0) & (q_found[qid.clamp(0, Q - 1).to(torch.int64)] == 0)
    k1 = (qid << (nsb + relb)) | (children.ns << relb) | children.rel
    k2 = children.obj
    idx = torch.arange(A, dtype=torch.int32, device=dev)
    h = hashtab.mix(k1, k2, _PACK_SALT) & (H - 1)
    # dead children and non-matching colliders scatter into sink slot H
    hs = torch.where(alive, h, H)
    own = torch.full((H + 1,), -1, dtype=torch.int32, device=dev)
    own = own.scatter_reduce(0, hs, idx, "amax")[:H]
    owner = own[h]
    oc = owner.clamp(0, A - 1).to(torch.int64)
    same = alive & (k1[oc] == k1) & (k2[oc] == k2)
    ms = torch.where(same, h, H)

    def table(fill, val, how):
        t = torch.full((H + 1,), fill, dtype=torch.int32, device=dev)
        return t.scatter_reduce(0, ms, val.to(torch.int32), how)[:H]

    d_tab = table(-1, children.d, "amax")
    skip_tab = table(1, children.skip, "amin")
    force_tab = table(0, children.force, "amax")
    is_owner = alive & (owner == idx)
    survivor = is_owner | (alive & ~same)
    d_out = torch.where(is_owner, d_tab[h], children.d)
    skip_out = torch.where(is_owner, skip_tab[h] != 0, children.skip)
    force_out = torch.where(is_owner, force_tab[h] != 0, children.force)

    pos = torch.cumsum(survivor.to(torch.int32), 0, dtype=torch.int32) - 1
    drop = survivor & (pos >= F)
    q_over = _scatter_or(q_over, qid.clamp(0, Q - 1), drop)
    spos = torch.where(survivor & (pos < F), pos, F).to(torch.int64)

    def scat(fill, val):
        x = torch.full((F + 1,), fill, dtype=val.dtype, device=dev)
        return x.scatter(0, spos, val)[:F]

    out = Items(
        qid=scat(-1, torch.where(survivor, qid, -1)),
        ns=scat(-1, children.ns),
        obj=scat(-1, children.obj),
        rel=scat(-1, children.rel),
        d=scat(0, d_out),
        skip=scat(False, skip_out),
        force=scat(False, force_out),
    )
    if occ_out is not None:
        occ_out.copy_((out.qid >= 0).sum(dtype=torch.int32).reshape(1))
    return out, q_over


def pack_verdicts(q_found: Tensor, q_over: Tensor, *, out: Tensor) -> None:
    """Write the verdict byte of each query into ``out`` (uint8[Q]):
    bit0 found, bit1 over; bit2 (dirty) needs the write overlay and is 0."""
    if q_found.device.type == "cpu":
        _pack_verdicts_plain(q_found, q_over, out=out)
        return
    nq = q_found.shape[0]
    dev = q_found.device
    kernels.require(q_found, torch.int32, "q_found", shape=(nq,))
    kernels.require(q_over, torch.int32, "q_over", shape=(nq,), device=dev)
    kernels.require(out, torch.uint8, "out", shape=(nq,), device=dev)
    kernels.launch("pack", "pack_verdicts", kernels.ptr(q_found),
                   kernels.ptr(q_over), nq, kernels.ptr(out), kernels.stream())
    kernels.LAUNCHES["pack_verdicts"] += 1


def _pack_verdicts_plain(q_found: Tensor, q_over: Tensor, *, out: Tensor) -> None:
    out.copy_((q_found != 0).to(torch.uint8) | ((q_over != 0).to(torch.uint8) << 1))


# -- the level schedule and the batch loop -------------------------------------


PROBE_ONLY_ARENA = 8  # arena <= this: level runs probes only, no children

#: worst-case per-level frontier multipliers (units of q); also the ceiling
#: the demand-adaptive schedule may never exceed
F_MULT = (1, 4, 5, 6, 6)


def level_schedule(
    q: int, frontier: int, arena: int, max_depth: int, boost: int = 1,
    mults: Optional[Tuple[int, ...]] = None,
) -> Tuple[Tuple[int, int], ...]:
    """Per-level (frontier, arena) sizes: level 0 holds exactly the roots,
    later levels grow geometrically up to the configured caps; ``mults``
    overrides the growth with measured per-level multipliers (the engine
    feeds back the per-level occupancy).  ``boost`` scales the per-query
    term, not just the caps (retry tiers).  The final level cannot produce
    live children (depth strictly decreases and a child needs d >= 1), so
    it runs probe-only with a token arena."""
    f_mult = F_MULT if mults is None else mults
    out = []
    for lvl in range(max_depth):
        last = lvl == max_depth - 1
        m = f_mult[min(lvl, len(f_mult) - 1)]
        fl = min(boost * m * q, frontier)
        a = 4 * fl if lvl == 0 else 2 * fl  # root fan-out exceeds chain growth
        out.append((fl, PROBE_ONLY_ARENA if last else min(a, arena)))
    return tuple(out)


class Packed(NamedTuple):
    """A batch's results on the device: uint8[Q] verdict bytes, then (at a
    4-byte aligned offset) int32[levels] occupancy, in ONE buffer."""

    buf: Tensor
    q: int
    levels: int

    @staticmethod
    def occ_offset(q: int) -> int:
        return -(-q // 4) * 4

    def codes(self) -> Tensor:
        return self.buf[: self.q]

    def occ(self) -> Tensor:
        off = self.occ_offset(self.q)
        return self.buf[off: off + 4 * self.levels].view(torch.int32)

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(verdict bytes, occupancy) on the host: one device-to-host copy."""
        host = self.buf.cpu().numpy()
        off = self.occ_offset(self.q)
        return host[: self.q], host[off: off + 4 * self.levels].view(np.int32)


def run_fast_packed(
    g: Tables,
    qpack,
    *,
    frontier: int = 8192,
    arena: int = 32768,
    max_depth: int = 5,
    max_width: int = 100,
    boost: int = 1,
    mults: Optional[Tuple[int, ...]] = None,
) -> Packed:
    """All BFS levels of one batch, enqueued on the current stream.

    ``qpack`` is the int32[6, Q] block (ns, obj, rel, subj, depth, active),
    numpy or a tensor; it goes to the tables' device in one copy.  An
    inactive query never enters the frontier and its verdict byte is 0.
    Returns the :class:`Packed` verdicts + per-level occupancy (live items
    entering each level).  On CUDA tables every level runs the kernels."""
    return _run_levels(_OPS, g, qpack, frontier, arena, max_depth, max_width,
                       boost, mults)


def run_fast_packed_plain(
    g: Tables,
    qpack,
    *,
    frontier: int = 8192,
    arena: int = 32768,
    max_depth: int = 5,
    max_width: int = 100,
    boost: int = 1,
    mults: Optional[Tuple[int, ...]] = None,
) -> Packed:
    """:func:`run_fast_packed` through the plain PyTorch versions only, on
    whatever device the tables are: it launches no kernel.  It is the
    whole-batch yardstick the kernels are held against on the card."""
    return _run_levels(_PLAIN_OPS, g, qpack, frontier, arena, max_depth,
                       max_width, boost, mults)


class _Ops(NamedTuple):
    init_state: object
    probe_level: object
    arena_assign: object
    expand_children: object
    pack_scatter: object
    pack_verdicts: object


_OPS = _Ops(init_state, probe_level, arena_assign, expand_children,
            _pack_scatter, pack_verdicts)
_PLAIN_OPS = _Ops(_init_state_plain, _probe_level_plain, _arena_assign_plain,
                  _expand_children_plain, _pack_scatter_plain, _pack_verdicts_plain)


def _run_levels(ops: _Ops, g: Tables, qpack, frontier: int, arena: int,
                max_depth: int, max_width: int, boost: int, mults) -> Packed:
    dev = g["row_ptr"].device
    q = qpack.shape[1]
    if q > frontier:
        raise ValueError(f"batch {q} exceeds frontier capacity {frontier}")
    ns_dim, rel_dim, _, _ = _dims(g)
    nsb, relb = _pack_bits(ns_dim), _pack_bits(rel_dim)
    if _pack_bits(q) + nsb + relb > 31:
        raise NotImplementedError(
            f"sort-based pack for {_pack_bits(q)}+{nsb}+{relb} key bits is "
            "not ported"
        )
    sched = level_schedule(q, frontier, arena, max_depth, boost, mults)
    levels = len(sched)
    if isinstance(qpack, torch.Tensor):
        qp = qpack.to(device=dev, dtype=torch.int32).contiguous()
    else:
        qp = torch.from_numpy(np.ascontiguousarray(qpack, np.int32)).to(dev)
    res = Packed(
        torch.empty(Packed.occ_offset(q) + 4 * levels, dtype=torch.uint8, device=dev),
        q, levels,
    )
    occ = res.occ()
    f, q_found, q_over, q_subj = ops.init_state(
        qp, frontier=sched[0][0], levels=levels, occ_out=occ[0:1]
    )
    for i, (_f, a) in enumerate(sched):
        last = i == levels - 1
        q_found, lv = ops.probe_level(g, f, q_found, q_subj, probe_only=last)
        if last:
            break  # the final level is probe-only: no children to pack
        offsets, _total, parent, ordinal = ops.arena_assign(lv.counts, a)
        children, q_over = ops.expand_children(
            g, f, lv, offsets, parent, ordinal, q_found, q_over,
            max_width=max_width,
        )
        f, q_over = ops.pack_scatter(
            children, q_found, q_over, frontier=sched[i + 1][0], nsb=nsb,
            relb=relb, occ_out=occ[i + 1: i + 2],
        )
    ops.pack_verdicts(q_found, q_over, out=res.codes())
    return res
