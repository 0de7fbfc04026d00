"""Tier 2: batched AND/NOT checks as one leveled device program (K7).

The port of the JAX package's ``engine/algebra.py``.  The check algebra
(`internal/check/rewrites.go:33-200`, `binop.go:18-73`) is an OR/AND/NOT
expression DAG whose leaves are graph-reachability subproblems.  A general
batch runs in four passes:

* the **down pass** builds the skeleton level by level: each task resolves
  in place (guards, client errors, direct/forced membership probes) or
  allocates its children into the next level's arena (K4
  ``arena_assign``); a child subcheck whose (namespace, relation) cannot
  reach AND/NOT (the static ``taint`` table) becomes a **fast leaf**, and
  expansion children are deduplicated by an open-addressed visited set;
* every fast leaf of every level is compacted into one sub-batch, which
  runs through the tier-1 BFS (``fastpath``'s level loop and its kernels)
  with per-leaf skip/force flags;
* the **up pass** resolves combiners bottom-up, one level at a time, from
  three-valued child counts (any-child-ERR first, then OR / AND / NOT /
  PASS);
* one buffer carries the verdict codes (bits 0-1 result, bit 2 over, bit 3
  dirty) and the occupancy vector, fetched with one device-to-host copy.

Every capacity shortfall (arena, fast-leaf buffer, visited probe window,
level budget) sets the query's ``over`` bit; the engine retries at boosted
sizes and only then asks the host oracle.

Two forms live here.  The JAX-shaped functions (``_init_roots``,
``_classify_level``, ``_visited``, ``_construct_level``, ``_collect_fast``)
take and return dicts of tensors exactly as their JAX counterparts do;
``_fast_subrun`` takes the leaf buffer as the device program holds it.  The
tests hold each against its JAX function.  The
device program keeps every level of the skeleton in one int32 buffer
(:class:`GenState`) and runs six kernel wrappers over it, each with its
plain PyTorch version beside it (built from the JAX-shaped functions) and
its CUDA kernel in ``csrc/algebra.cu``: :func:`gen_classify`,
:func:`gen_construct`, :func:`gen_visited`, :func:`gen_collect`,
:func:`gen_up`, :func:`gen_pack`.  A wrapper takes the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises.

The program is overlay-aware as in JAX: probes consult the ``om_`` /
``ovt_`` delta tables, a dirty or virtual node's edge rows read as empty,
and a task that needed such a row (or an unfound leaf whose sub-run
brushed one) sets its query's dirty code bit, which sends the row to the
host oracle.  The ``shard=`` branch of the JAX body (the graph-sharded
mesh, K10) runs these same steps on every shard with three mask inputs
(:func:`gen_classify`'s ``shard``, :func:`gen_construct`'s ``owner``,
:func:`gen_collect`'s ``n_shards``) and the owner merges of
``parallel/graphshard.py`` between them.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine import hashtab
from ketotpu_torch.engine.fastpath import (
    Items,
    Packed,
    _node_lookup,
    _overlay_deg,
    _row_deg,
    _scatter_or,
)
from ketotpu_torch.engine.fastpath import _member as _member_raw
from ketotpu_torch.engine.optable import (
    OP_AND,
    OP_NOT,
    OP_OR,
    OP_PASS,
    P_AND,
    P_BATCHCSS,
    P_CSS,
    P_NOT,
    P_OR,
    P_TTU,
    R_ERR,
    R_IS,
    R_NOT,
    R_UNKNOWN,
)
from ketotpu_torch.engine.xutil import _arena_assign_plain, arena_assign

Tensor = torch.Tensor
Tables = Dict[str, Tensor]

I32MAX = 2**31 - 1

# task kinds: a tree subcheck, a rewrite-program node, a delegated pure-OR
# leaf (resolved by the BFS sub-run)
K_CHECK, K_PROG, K_FAST = 0, 1, 2

# linear-probe window of the visited hash set
VPROBE = 8

#: the columns of one skeleton task; the first twelve are what the
#: construction writes, the rest what classification adds
TASK_COLS = (
    "kind", "ns", "obj", "rel", "d", "skip", "force", "prog", "qid",
    "vscope", "parent", "neg",
    "resolved", "res", "cop", "seed", "nchild", "fast_id",
)
#: per-task values classification computes for the construction; ``count``
#: is the children requested, ``acount`` the same masked to unresolved live
#: tasks (K4's input), ``evc`` marks a child that enters the visited set
AUX_COLS = (
    "node", "prog_root", "r0", "deg", "pk", "pp", "node_ttu", "dirt",
    "count", "acount", "evc",
)
BOOL_COLS = frozenset(("skip", "force", "neg", "resolved", "seed", "dirt", "evc"))
TI = {c: i for i, c in enumerate(TASK_COLS)}
AI = {c: i for i, c in enumerate(AUX_COLS)}


def _i32(x) -> Tensor:
    return x.to(torch.int32)


def _i64(x) -> Tensor:
    return x.to(torch.int64)


def _full(n: int, v: int, dev) -> Tensor:
    return torch.full((n,), v, dtype=torch.int32, device=dev)


def _sel(conds, vals, default):
    """``jnp.select``: the value of the FIRST true condition."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


# -- K2 helpers with the algebra's guards --------------------------------------


def _member(g: Tables, node, subj):
    return _member_raw(g, node, subj) & (node >= 0) & (subj >= 0)


def _deg_guarded(g: Tables, node):
    """Edge-row degree with overlay semantics, and the node's dirty bit: a
    dirty row's base edges are stale and a virtual node (>= ``ov_nbase``)
    has no base row, so both read as 0 edges; the caller raises the
    query's dirty flag (as ``fastpath.expand_phase`` does)."""
    return _overlay_deg(g, node, _row_deg(g, node))


def _vs_size(vcap: int) -> int:
    return hashtab._bucket_pow2(2 * vcap, 16)


# -- the JAX-shaped plain functions --------------------------------------------


def _init_roots(qpack: Tensor, Q: int,
                act: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Level-0 tasks: one tree CHECK per active query (``act``, default
    the block's row 5)."""
    dev = qpack.device
    iota = torch.arange(Q, dtype=torch.int32, device=dev)
    act = (qpack[5] if act is None else act) != 0
    zb = torch.zeros(Q, dtype=torch.bool, device=dev)
    return dict(
        kind=torch.zeros(Q, dtype=torch.int32, device=dev),
        ns=torch.where(act, qpack[0], -1),
        obj=torch.where(act, qpack[1], -1),
        rel=torch.where(act, qpack[2], -1),
        d=torch.where(act, qpack[4], 0),
        skip=zb,
        force=zb,
        prog=_full(Q, -1, dev),
        qid=torch.where(act, iota, -1),
        vscope=_full(Q, -1, dev),
        parent=_full(Q, -1, dev),
        neg=zb,
    )


def _classify_level(g: Tables, t: Dict[str, Tensor], q_subj: Tensor):
    """Resolve in-place leaves; compute child counts and combiner ops
    (direct/expand subchecks flattened into the CHECK task, engine.go:242-245
    depth math).  Returns (t, count, aux) like the JAX function."""
    NS, R = g["f_direct_ok"].shape
    P = g["p_kind"].shape[0]
    dev = t["kind"].device
    F = t["kind"].shape[0]
    Q = q_subj.shape[0]

    active = t["qid"] >= 0
    ns, obj, rel, d = t["ns"], t["obj"], t["rel"], t["d"]
    nsc = _i64(ns.clamp(0, NS - 1))
    relc = _i64(rel.clamp(0, R - 1))
    cfg = (ns >= 0) & (ns < NS) & (rel >= 0) & (rel < R)
    subj = q_subj[_i64(t["qid"].clamp(0, Q - 1))]

    is_check = active & (t["kind"] == K_CHECK)
    is_prog = active & (t["kind"] == K_PROG)

    # tree CHECK: rel-err, rewrite root, direct/forced probe, edges
    err = is_check & cfg & g["rel_err"][nsc, relc]
    prog_root = torch.where(cfg, g["prog_root"][nsc, relc], -1)
    has_rw = prog_root >= 0
    node = _node_lookup(g, ns, obj, rel)
    dok = torch.where(cfg, g["f_direct_ok"][nsc, relc], True) & ~t["skip"]
    eok = torch.where(cfg, g["f_expand_ok"][nsc, relc], True)
    member = _member(g, node, subj)
    # direct counts at depth-1 with its own <=0 guard => d >= 2; a forced
    # probe ignores depth (it stands in for the parent's EXISTS probe)
    is_fast = active & (t["kind"] == K_FAST)
    seed = is_check & member & (t["force"] | (dok & (d >= 2)))
    exp_read = (is_check | is_fast) & eok & (d >= 2)
    deg_row, node_nd = _deg_guarded(g, node)
    deg = _i32(torch.where(exp_read, deg_row, 0))
    dirt = exp_read & node_nd
    errable = cfg & g["err_reach"][nsc, relc]
    chk_count = _i32(torch.where(d >= 1, _i32(has_rw) + deg, 0))

    # trivial fast leaves (no rewrite, no subject-set edge) are one probe
    triv = is_fast & ~has_rw & (deg == 0)
    found_t = member & (t["force"] | (dok & (d >= 2)))

    # root-prog adoption: a CHECK whose only child would be its rewrite
    # program becomes the program root in place
    adopt = is_check & ~err & ~seed & has_rw & (deg == 0) & (d >= 1)
    is_check = is_check & ~adopt
    is_prog = is_prog | adopt
    prog_eff = torch.where(adopt, prog_root, t["prog"])

    # rewrite-program nodes
    pp = _i64(prog_eff.clamp(0, P - 1))
    pk = g["p_kind"][pp]
    p_deg = g["p_child_ptr"][pp + 1] - g["p_child_ptr"][pp]
    node_ttu = _node_lookup(g, ns, obj, g["p_a"][pp])
    ttu_row, ttu_nd = _deg_guarded(g, node_ttu)
    ttu_deg = _i32(torch.where(is_prog, ttu_row, 0))
    nb = g["b_ptr"].shape[0]
    browc = _i64(g["p_a"][pp].clamp(0, nb - 2))
    b_deg = g["b_ptr"][browc + 1] - g["b_ptr"][browc]
    p_oan = is_prog & ((pk == P_OR) | (pk == P_AND))
    p_not = is_prog & (pk == P_NOT)
    p_css = is_prog & (pk == P_CSS)
    p_ttu = is_prog & (pk == P_TTU)
    p_bat = is_prog & (pk == P_BATCHCSS)
    dirt = dirt | (p_ttu & ttu_nd)

    # depth guards: <=0 for check/or/and, <0 for NOT/CSS/TTU; BATCHCSS none
    guard = ((is_check | p_oan) & (d <= 0)) | ((p_not | p_css | p_ttu) & (d < 0))
    one = torch.ones(F, dtype=torch.int32, device=dev)
    count = _sel(
        [is_check, p_oan, p_not | p_css, p_ttu, p_bat],
        [chk_count, p_deg, one, ttu_deg, b_deg],
        torch.zeros(F, dtype=torch.int32, device=dev),
    )

    # resolution: guard, then err, then probes, then empty-group NOT
    guard_is = is_check & (d <= 0) & t["force"] & member
    r_guard = guard & ~guard_is
    r_err = err & ~guard
    r_short = is_check & ~guard & ~err & seed & ~errable
    leaf = r_guard | guard_is | r_err | r_short
    count = _i32(torch.where(leaf | ~active, 0, count))
    r_empty = (is_check | is_prog) & ~leaf & (count == 0)
    resolved = leaf | r_empty
    res = _sel(
        [r_err, guard_is | r_short | (r_empty & seed), r_guard],
        [_full(F, R_ERR, dev), _full(F, R_IS, dev), _full(F, R_UNKNOWN, dev)],
        _i32(torch.where(r_empty, R_NOT, R_UNKNOWN)),
    )
    res = _i32(torch.where(
        triv,
        torch.where(found_t, R_IS, torch.where(d >= 1, R_NOT, R_UNKNOWN)),
        res,
    ))
    resolved = resolved | triv
    cop = _sel(
        [p_oan & (pk == P_AND), p_not, p_css],
        [_full(F, OP_AND, dev), _full(F, OP_NOT, dev), _full(F, OP_PASS, dev)],
        _full(F, OP_OR, dev),
    )

    t = dict(
        t,
        kind=_i32(torch.where(adopt, K_PROG, t["kind"])),
        prog=_i32(prog_eff),
        resolved=resolved,
        res=res,
        cop=cop,
        seed=seed & ~resolved,
        nchild=torch.zeros(F, dtype=torch.int32, device=dev),
        fast_id=_full(F, -1, dev),
    )
    aux = dict(
        node=node, prog_root=_i32(prog_root),
        r0=_i32(has_rw & (d >= 1)),
        deg=deg, pk=_i32(pk), pp=_i32(pp), node_ttu=node_ttu,
        dirt=dirt,
    )
    return t, count, aux


def _vhash(k1, k2, k3, k4, vs: int) -> Tensor:
    """Slot of a visited-set key: hashtab.mix_device over the four words
    with salts 0..2, masked to the power-of-two table size (F1: int64
    lanes masked to 32 bits)."""
    s = hashtab._SALTS
    h = hashtab.mix(hashtab.mix(k1, k2, int(s[0])), hashtab.mix(k3, k4, int(s[1])),
                    int(s[2]))
    return h & (vs - 1)


def _visited(vset, k1, k2, k3, k4, evc, A: int):
    """Probe-and-insert into the open-addressed visited set: membership
    test, in-batch first-occurrence dedup by minimum arena index, insert.
    ``VPROBE`` synchronous rounds; in each, pending keys read their slot,
    claim an empty one (scatter-min of the arena index: the least index
    wins), the winners write, and the rest re-match.  Returns
    ((v1, v2, v3, v4), seen, vpend)."""
    v1, v2, v3, v4 = vset
    VS = v1.shape[0]
    dev = v1.device
    k1 = torch.where(evc, k1, I32MAX)
    k2 = torch.where(evc, k2, I32MAX)
    k3 = torch.where(evc, k3, I32MAX)
    k4 = torch.where(evc, k4, I32MAX)
    h = _vhash(k1, k2, k3, k4, VS)
    aidx = torch.arange(A, dtype=torch.int32, device=dev)
    seen = torch.zeros(A, dtype=torch.bool, device=dev)
    vpend = evc
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def same(j):
        return (v1[j] == k1) & (v2[j] == k2) & (v3[j] == k3) & (v4[j] == k4)

    def put(v, tgt, k):
        return torch.cat([v, sink]).scatter(0, tgt, k)[:VS]

    for i in range(VPROBE):
        j = (h + i) & (VS - 1)
        match = vpend & same(j)
        seen = seen | match
        vpend = vpend & ~match
        empty = v1[j] == I32MAX
        want = vpend & empty
        claim = torch.full((VS + 1,), I32MAX, dtype=torch.int32, device=dev)
        claim = claim.scatter_reduce(0, torch.where(want, j, VS), aidx, "amin")
        won = want & (claim[j] == aidx)
        tgt = torch.where(won, j, VS)
        v1, v2, v3, v4 = (put(v, tgt, k) for v, k in ((v1, k1), (v2, k2),
                                                      (v3, k3), (v4, k4)))
        vpend = vpend & ~won
        nowmatch = vpend & same(j)
        seen = seen | nowmatch
        vpend = vpend & ~nowmatch
    return (v1, v2, v3, v4), seen, vpend


def _construct_children(g: Tables, t, counts, aux, offsets, ap, ao, q_over, *,
                        A: int, level_base: int, max_width: int, Q: int,
                        pmine: Optional[Tensor] = None):
    """The construction half of ``_construct_level`` after K4: the parents'
    capacity verdicts and every arena slot's child, plus the slots that
    enter the visited set (``evc``; on a shard of the mesh only the
    children of the parents it owns, ``pmine``).  Returns (t, child, evc,
    q_over)."""
    NS, R = g["f_direct_ok"].shape
    P = g["p_kind"].shape[0]
    dev = t["kind"].device
    F = t["kind"].shape[0]

    fits = offsets + counts <= A
    overp = (counts > 0) & ~fits
    q_over = _scatter_or(q_over, t["qid"].clamp(0, Q - 1), overp)
    # over-capacity parents resolve UNKNOWN; their queries fall back
    t = dict(
        t,
        resolved=t["resolved"] | overp,
        res=_i32(torch.where(overp, R_UNKNOWN, t["res"])),
        nchild=_i32(torch.where(fits, counts, 0)),
    )

    aps = _i64(ap.clamp(0, F - 1))
    valid = (ap >= 0) & fits[aps] & (t["qid"][aps] >= 0)

    pkind = t["kind"][aps]
    ppk = aux["pk"][aps]
    r0 = aux["r0"][aps]
    pns, pobj, prel = t["ns"][aps], t["obj"][aps], t["rel"][aps]
    pd, pqid, pvs = t["d"][aps], t["qid"][aps], t["vscope"][aps]
    pp = _i64(aux["pp"][aps])
    ppa = g["p_a"][pp]
    ppb = g["p_b"][pp]

    c_rw = valid & (pkind == K_CHECK) & (ao < r0)
    c_edge = valid & (pkind == K_CHECK) & (ao >= r0)
    c_prog = valid & (pkind == K_PROG)
    c_oan = c_prog & ((ppk == P_OR) | (ppk == P_AND) | (ppk == P_NOT))
    c_css = c_prog & (ppk == P_CSS)
    c_ttu = c_prog & (ppk == P_TTU)
    c_bat = c_prog & (ppk == P_BATCHCSS)

    # edge gathers (expansion rows for CHECK parents, via-rows for TTU)
    rp = g["row_ptr"]
    rmax = rp.shape[0] - 2
    eo = ao - r0
    base_exp = rp[_i64(aux["node"][aps].clamp(0, rmax))]
    base_ttu = rp[_i64(aux["node_ttu"][aps].clamp(0, rmax))]
    eidx = _i64(torch.where(c_ttu, base_ttu + ao, base_exp + eo).clamp(
        0, g["edge_hi"].shape[0] - 1))
    e_hi, e_obj = g["edge_hi"][eidx], g["edge_obj"][eidx]
    num_rels = g["prog_root"].shape[1]
    e_ns = torch.where(e_hi >= 0, torch.div(e_hi, num_rels, rounding_mode="floor"), -1)
    e_rel = torch.where(e_hi >= 0, torch.remainder(e_hi, num_rels), -1)

    # program CSR gathers
    pci = _i64((g["p_child_ptr"][pp] + ao).clamp(0, g["p_child_idx"].shape[0] - 1))
    prog_child = g["p_child_idx"][pci]
    prog_dec = g["p_child_dec"][pci]
    prog_neg = g["p_child_neg"][pci]
    # CSS hop collapse: a P_CSS child is emitted as its subcheck directly
    pcc = _i64(prog_child.clamp(0, P - 1))
    pk2 = g["p_kind"][pcc]
    c_cssdir = c_oan & (pk2 == P_CSS)
    css_dir_rel = g["p_a"][pcc]

    # batched-CSS row gathers
    nb = g["b_ptr"].shape[0]
    bi = _i64((g["b_ptr"][_i64(ppa.clamp(0, nb - 2))] + ao).clamp(
        0, g["b_rel"].shape[0] - 1))
    brel = g["b_rel"][bi]
    bprobe = g["b_probe"][bi]

    ch_ns = torch.where(c_edge | c_ttu, e_ns, pns)
    ch_obj = torch.where(c_edge | c_ttu, e_obj, pobj)
    ch_rel = _sel([c_edge, c_ttu, c_css, c_bat, c_cssdir],
                  [e_rel, ppb, ppa, brel, css_dir_rel], prel)
    # expansion / TTU / batched-CSS children at depth-1; nested rewrite
    # children at depth - dec; rewrite root and CSS keep depth
    ch_d = _sel([c_edge | c_ttu | c_bat, c_oan], [pd - 1, pd - prog_dec], pd)
    ch_prog = _sel([c_rw, c_oan & ~c_cssdir], [aux["prog_root"][aps], prog_child],
                   _full(A, -1, dev))
    ch_skip = c_edge | c_bat  # skip_direct (engine.go:161, rewrites.go:86)
    ch_force = c_edge | (c_bat & bprobe)
    ch_neg = c_oan & prog_neg  # folded InvertResult parity
    # expansion children open a visited scope at the first expanding
    # ancestor; slot ids are globally unique via the static level base
    ch_vscope = torch.where(c_edge & (pvs < 0), level_base + _i32(aps), pvs)

    # tainted subchecks stay tree CHECKs, pure ones become fast leaves
    ch_nsc = _i64(ch_ns.clamp(0, NS - 1))
    ch_relc = _i64(ch_rel.clamp(0, R - 1))
    in_cfg = (ch_ns >= 0) & (ch_ns < NS) & (ch_rel >= 0) & (ch_rel < R)
    tainted = in_cfg & g["taint"][ch_nsc, ch_relc]
    ch_kind = torch.where(c_rw | (c_oan & ~c_cssdir), K_PROG,
                          torch.where(tainted, K_CHECK, K_FAST))

    # width truncation (engine.go:141-150): probe-only leaves at depth 0
    pdeg = aux["deg"][aps]
    trunc = c_edge & (pdeg > max_width) & (eo >= max_width - 1)
    evc = c_edge & ~trunc
    if pmine is not None:
        # sharded: only the parent's owner gathered real edges, and the
        # visited set is the shard's own
        evc = evc & pmine[aps]
    ch_kind = torch.where(trunc, K_FAST, ch_kind)
    ch_d = torch.where(trunc, 0, ch_d)

    child = dict(
        kind=_i32(torch.where(valid, ch_kind, 0)),
        ns=_i32(torch.where(valid, ch_ns, -1)),
        obj=_i32(torch.where(valid, ch_obj, -1)),
        rel=_i32(torch.where(valid, ch_rel, -1)),
        d=_i32(torch.where(valid, ch_d, 0)),
        skip=valid & ch_skip,
        force=valid & ch_force,
        prog=_i32(torch.where(valid, ch_prog, -1)),
        qid=_i32(torch.where(valid, pqid, -1)),
        vscope=_i32(torch.where(valid, ch_vscope, -1)),
        parent=_i32(torch.where(valid, ap, -1)),
        neg=valid & ch_neg,
    )
    return t, child, evc, q_over


def _apply_visited(child, vset, evc, q_over, A: int, Q: int):
    """Run the visited set over a constructed level: duplicates and keys
    that found no slot become probe-only leaves (they keep their EXISTS
    probe, engine.go:131-139,157-162); a key that found no slot marks its
    query over.  Returns (child, vset, q_over)."""
    vset, seen, vpend = _visited(
        vset, child["vscope"], child["ns"], child["obj"], child["rel"], evc, A
    )
    q_over = _scatter_or(q_over, child["qid"].clamp(0, Q - 1), vpend)
    po = seen | vpend
    child = dict(
        child,
        kind=_i32(torch.where(po, K_FAST, child["kind"])),
        d=_i32(torch.where(po, 0, child["d"])),
    )
    return child, vset, q_over


def _construct_level(g: Tables, t, count, aux, vset, q_over, *, A: int,
                     level_base: int, max_width: int, Q: int,
                     pmine: Optional[Tensor] = None):
    """Allocate and build the next level's tasks: child allocation (K4),
    edge/program gathers, visited-set insertion.  ``q_over`` is int32 0/1.
    Returns (t, child, vset, q_over) like the JAX function."""
    counts = _i32(torch.where(t["resolved"] | (t["qid"] < 0), 0, count))
    offsets, _total, ap, ao = _arena_assign_plain(counts, A)
    t, child, evc, q_over = _construct_children(
        g, t, counts, aux, offsets, ap, ao, q_over, A=A, level_base=level_base,
        max_width=max_width, Q=Q, pmine=pmine,
    )
    child, vset, q_over = _apply_visited(child, vset, evc, q_over, A, Q)
    return t, child, vset, q_over


def _collect_fast(levels: List[Dict[str, Tensor]], q_subj, q_over, B: int, Q: int):
    """Compact every unresolved K_FAST task across levels into one B-slot
    leaf buffer (running base across levels); leaves that do not fit
    resolve UNKNOWN and mark their query over.  Returns (levels, fb,
    q_over, fast_n) like the JAX function."""
    dev = q_subj.device
    fb = dict(
        ns=_full(B, -1, dev), obj=_full(B, -1, dev), rel=_full(B, -1, dev),
        d=_full(B, 0, dev),
        skip=torch.zeros(B, dtype=torch.bool, device=dev),
        force=torch.zeros(B, dtype=torch.bool, device=dev),
        subj=_full(B, 0, dev),
        valid=torch.zeros(B, dtype=torch.bool, device=dev),
    )
    base = torch.zeros((), dtype=torch.int32, device=dev)
    out_levels = []
    for t in levels:
        m = (t["kind"] == K_FAST) & (t["qid"] >= 0) & ~t["resolved"]
        pos = base + torch.cumsum(_i32(m), 0, dtype=torch.int32) - 1
        ok = m & (pos < B)
        tgt = _i64(torch.where(ok, pos, B))
        subj = q_subj[_i64(t["qid"].clamp(0, Q - 1))]
        vals = dict(ns=t["ns"], obj=t["obj"], rel=t["rel"],
                    d=t["d"].clamp(min=0), skip=t["skip"], force=t["force"],
                    subj=subj, valid=ok)
        fb = {k: torch.cat([fb[k], fb[k][:1]]).scatter(0, tgt, vals[k])[:B]
              for k in fb}
        drop = m & ~ok
        q_over = _scatter_or(q_over, t["qid"].clamp(0, Q - 1), drop)
        out_levels.append(dict(
            t,
            fast_id=_i32(torch.where(ok, pos, -1)),
            resolved=t["resolved"] | drop,
            res=_i32(torch.where(drop, R_UNKNOWN, t["res"])),
        ))
        base = base + _i32(m).sum(dtype=torch.int32)
    return out_levels, fb, q_over, base


def _leaf_items(fb, levels: int, active: Optional[Tensor] = None) -> Items:
    """The sub-run's level 0 from the leaf buffer: each leaf is its own
    query (qid = slot), its depth capped at the schedule's level count; on
    a shard of the mesh only the leaves it owns (``active``) are live."""
    B = fb["ns"].shape[0]
    iota = torch.arange(B, dtype=torch.int32, device=fb["ns"].device)
    live = fb["valid"] if active is None else fb["valid"] & active
    return Items(
        qid=_i32(torch.where(live, iota, -1)),
        ns=fb["ns"].clone(), obj=fb["obj"].clone(), rel=fb["rel"].clone(),
        d=_i32(fb["d"].clamp(max=levels)),
        skip=fb["skip"].clone(), force=fb["force"].clone(),
    )


def _fast_subrun(ops: fp._Ops, g: Tables, leaves: Items, subj: Tensor, *, sched,
                 max_width: int, occ: Tensor):
    """The tier-1 BFS over the collected pure-OR leaves (the JAX function
    without its ``shard=`` branch), through the steps of ``ops``.
    ``leaves`` is the sub-run's level 0 (what :func:`gen_collect` fills, or
    :func:`_leaf_items`), ``subj`` each leaf's subject; ``occ[0]`` holds the
    live leaves and the loop writes the live leaves entering each later
    level.  Returns (found, over, dirty): int32 0/1 per leaf.  The JAX loop
    packs once more after the probe-only last level (into a 1-slot
    frontier); a probe-only level has no children, so that pack changes no
    bit and the port's level loop stops before it."""
    zeros = torch.zeros(leaves.qid.shape[0], dtype=torch.int32, device=subj.device)
    return fp._level_loop(ops, g, leaves, zeros, zeros.clone(), zeros.clone(),
                          subj, sched, max_width=max_width, occ=occ)


# -- the device program's state ------------------------------------------------


@dataclass
class GenState:
    """One general dispatch's device state.  Every skeleton level lives in
    one column range of ``tasks`` / ``aux`` / ``cnt`` (level L at
    ``bases[L]``, ``widths[L]`` columns), so a level's slot ids are global
    (the visited scopes' static level base) and the leaf compaction is one
    scan over all levels."""

    tasks: Tensor  # int32[len(TASK_COLS), T]
    aux: Tensor  # int32[len(AUX_COLS), T]
    cnt: Tensor  # int32[3, T]: IS / NOT / ERR child counts of each task
    vset: Tensor  # int32[4, VS] visited-set keys, I32MAX = empty
    q_over: Tensor  # int32[Q]
    q_dirty: Tensor  # int32[Q]
    leaves: Items  # [B] the sub-run's level 0
    leaf_subj: Tensor  # int32[B]
    out: Tensor  # uint8: codes[Q], then occ int32[D + 2 + S] (Packed layout)
    q: int
    widths: Tuple[int, ...]
    bases: Tuple[int, ...]
    n_sched: int

    @classmethod
    def new(cls, q: int, sizes, fast_b: int, n_sched: int, vcap: int, dev):
        widths = (q, *sizes)
        bases = tuple(int(x) for x in np.cumsum((0,) + widths[:-1]))
        tot = sum(widths)
        i32 = dict(dtype=torch.int32, device=dev)
        levels = len(widths) + 1 + n_sched
        out = torch.zeros(Packed.occ_offset(q) + 4 * levels, dtype=torch.uint8,
                          device=dev)
        return cls(
            tasks=torch.empty((len(TASK_COLS), tot), **i32),
            aux=torch.empty((len(AUX_COLS), tot), **i32),
            cnt=torch.zeros((3, tot), **i32),
            vset=torch.full((4, _vs_size(vcap)), I32MAX, **i32),
            q_over=torch.zeros(q, **i32),
            q_dirty=torch.zeros(q, **i32),
            leaves=Items.empty(fast_b, dev),
            leaf_subj=torch.empty(fast_b, **i32),
            out=out, q=q, widths=widths, bases=bases, n_sched=n_sched,
        )

    @property
    def depth(self) -> int:  # D: skeleton levels below the roots
        return len(self.widths) - 1

    def packed(self) -> Packed:
        return Packed(self.out, self.q, self.depth + 2 + self.n_sched)

    def occ(self) -> Tensor:
        return self.packed().occ()

    def span(self, level: int) -> Tuple[int, int]:
        return self.bases[level], self.widths[level]

    def tensors(self) -> Dict[str, Tensor]:
        """Every tensor of the state, by name (for clones and comparisons)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Tensor):
                out[f.name] = v
            elif isinstance(v, Items):
                for c in fp.ITEM_COLS:
                    out[f"{f.name}.{c}"] = getattr(v, c)
        return out

    def clone(self) -> "GenState":
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Tensor):
                v = v.clone()
            elif isinstance(v, Items):
                v = Items(*(getattr(v, c).clone() for c in fp.ITEM_COLS))
            kw[f.name] = v
        return GenState(**kw)

    # -- the plain versions' views of one level --------------------------------

    def task_dict(self, level: int) -> Dict[str, Tensor]:
        lo, n = self.span(level)
        return {c: (self.tasks[i, lo:lo + n] != 0 if c in BOOL_COLS
                    else self.tasks[i, lo:lo + n]) for c, i in TI.items()}

    def aux_dict(self, level: int) -> Dict[str, Tensor]:
        lo, n = self.span(level)
        return {c: (self.aux[i, lo:lo + n] != 0 if c in BOOL_COLS
                    else self.aux[i, lo:lo + n]) for c, i in AI.items()}

    def put_tasks(self, level: int, t: Dict[str, Tensor]) -> None:
        lo, n = self.span(level)
        for c, v in t.items():
            self.tasks[TI[c], lo:lo + n] = v.to(torch.int32)

    def put_aux(self, level: int, a: Dict[str, Tensor]) -> None:
        lo, n = self.span(level)
        for c, v in a.items():
            self.aux[AI[c], lo:lo + n] = v.to(torch.int32)

    def acount(self, level: int) -> Tensor:
        lo, n = self.span(level)
        return self.aux[AI["acount"], lo:lo + n]


# -- kernel wrappers and their plain versions ------------------------------------


def _launch(fn: str, *args) -> None:
    kernels.launch("algebra", fn, *args, kernels.stream())
    kernels.LAUNCHES[fn] += 1


def gen_classify(g: Tables, st: GenState, level: int, q_subj: Tensor, *,
                 qpack: Optional[Tensor] = None, act: Optional[Tensor] = None,
                 last: bool = False, shard: bool = False) -> None:
    """Classify one skeleton level in place (K7 ``_classify_level``; with
    ``qpack``, level 0's roots first, ``_init_roots``, from its rows ns,
    obj, rel, depth and the active row ``act``, default row 5): the task
    fields, the aux columns, the dirty bits, the level's live count into
    the occupancy; ``last`` also caps the tasks that still need children
    (UNKNOWN + over).  On a shard of the mesh (``shard``) the dirty bits
    and the cap wait for the owner merge
    (``graphshard.merge_classified``)."""
    if qpack is not None and act is None:
        act = qpack[5]
    if st.tasks.device.type == "cpu":
        return _gen_classify_plain(g, st, level, q_subj, qpack=qpack, act=act,
                                   last=last, shard=shard)
    lo, n = st.span(level)
    dev = st.tasks.device
    kernels.require(q_subj, torch.int32, "q_subj", shape=(st.q,), device=dev)
    if qpack is not None:
        kernels.require(qpack, torch.int32, "qpack",
                        shape=(max(qpack.shape[0], 5), st.q), device=dev)
        kernels.require(act, torch.int32, "act", shape=(st.q,), device=dev)
    _launch("gen_classify", kernels.graph(g), kernels.prog(g), kernels.gen_state(st),
            lo, n, level, kernels.ptr(q_subj), kernels.ptr(qpack),
            kernels.ptr(act), int(last), int(shard))


def _gen_classify_plain(g: Tables, st: GenState, level: int, q_subj: Tensor, *,
                        qpack: Optional[Tensor] = None,
                        act: Optional[Tensor] = None, last: bool = False,
                        shard: bool = False) -> None:
    Q = st.q
    if qpack is not None:
        t = _init_roots(qpack, Q, act)
    else:
        t = {c: v for c, v in st.task_dict(level).items() if c in TASK_COLS[:12]}
    t, count, aux = _classify_level(g, t, q_subj)
    qc = t["qid"].clamp(0, Q - 1)
    if not shard:
        st.q_dirty.copy_(_scatter_or(st.q_dirty, qc, aux["dirt"]))
    if last and not shard:
        # the level budget is exhausted: a task that still needs children
        # resolves UNKNOWN and its query falls back (K_FAST tasks never
        # take skeleton children, so they stay for the sub-run)
        capped = (t["qid"] >= 0) & ~t["resolved"] & (count > 0)
        st.q_over.copy_(_scatter_or(st.q_over, qc, capped))
        t["resolved"] = t["resolved"] | capped
        t["res"] = _i32(torch.where(capped, R_UNKNOWN, t["res"]))
    aux["count"] = count
    aux["acount"] = _i32(torch.where(t["resolved"] | (t["qid"] < 0), 0, count))
    st.put_tasks(level, t)
    st.put_aux(level, aux)
    occ = st.occ()
    occ[level:level + 1] += (t["qid"] >= 0).sum(dtype=torch.int32)


def gen_construct(g: Tables, st: GenState, level: int, offsets: Tensor,
                  parent: Tensor, ordinal: Tensor, *, max_width: int,
                  owner: Optional[Tensor] = None, me: int = 0) -> None:
    """Build level ``level + 1`` from level ``level`` and K4's arena
    assignment (K7 ``_construct_level`` without the prefix sum and the
    visited set): the parents' over / UNKNOWN / child counts and one child
    per arena slot, with its visited-set flag.  On shard ``me`` of the mesh
    ``owner`` (int32, the level's owner shards) keeps the flag to the
    children of the parents it owns (the JAX ``pmine``)."""
    if st.tasks.device.type == "cpu":
        return _gen_construct_plain(g, st, level, offsets, parent, ordinal,
                                    max_width=max_width, owner=owner, me=me)
    lo, n = st.span(level)
    clo, a = st.span(level + 1)
    dev = st.tasks.device
    kernels.require(offsets, torch.int32, "offsets", shape=(n,), device=dev)
    kernels.require(parent, torch.int32, "parent", shape=(a,), device=dev)
    kernels.require(ordinal, torch.int32, "ordinal", shape=(a,), device=dev)
    if owner is not None:
        kernels.require(owner, torch.int32, "owner", shape=(n,), device=dev)
    _launch("gen_construct", kernels.graph(g), kernels.prog(g), kernels.gen_state(st),
            lo, n, clo, a, kernels.ptr(offsets), kernels.ptr(parent),
            kernels.ptr(ordinal), max_width, kernels.ptr(owner), me)


def _gen_construct_plain(g: Tables, st: GenState, level: int, offsets, parent,
                         ordinal, *, max_width: int,
                         owner: Optional[Tensor] = None, me: int = 0) -> None:
    lo, _n = st.span(level)
    _clo, a = st.span(level + 1)
    t = st.task_dict(level)
    aux = st.aux_dict(level)
    t, child, evc, q_over = _construct_children(
        g, t, aux["acount"], aux, offsets, parent, ordinal, st.q_over,
        A=a, level_base=lo, max_width=max_width, Q=st.q,
        pmine=None if owner is None else owner == me,
    )
    st.q_over.copy_(q_over)
    st.put_tasks(level, {c: t[c] for c in ("resolved", "res", "nchild")})
    st.put_tasks(level + 1, child)
    st.put_aux(level + 1, {"evc": evc})


def gen_visited(st: GenState, level: int) -> None:
    """The visited set over a constructed level (K7 ``_visited`` and its
    use in ``_construct_level``): one block, ``VPROBE`` synchronous
    probe / claim / insert rounds, so the table and the seen / pending bits
    equal the plain version's bit for bit."""
    if st.tasks.device.type == "cpu":
        return _gen_visited_plain(st, level)
    lo, a = st.span(level)
    vs = st.vset.shape[1]
    if vs > kernels.VISITED_SMEM_SLOTS:
        raise ValueError(
            f"gen_visited: a visited set of {vs} slots; the kernel's claims "
            f"fit {kernels.VISITED_SMEM_SLOTS} (vcap {kernels.VISITED_SMEM_SLOTS // 2})"
        )
    scratch = torch.empty((2, a), dtype=torch.int32, device=st.tasks.device)
    _launch("gen_visited", kernels.gen_state(st), lo, a, kernels.ptr(scratch))


def _gen_visited_plain(st: GenState, level: int) -> None:
    _lo, a = st.span(level)
    child = st.task_dict(level)
    evc = st.aux_dict(level)["evc"]
    vset = tuple(st.vset[i] for i in range(4))
    child, vset, q_over = _apply_visited(child, vset, evc, st.q_over, a, st.q)
    st.vset.copy_(torch.stack(vset))
    st.q_over.copy_(q_over)
    st.put_tasks(level, {"kind": child["kind"], "d": child["d"]})


def gen_collect(st: GenState, q_subj: Tensor, *, n_shards: int = 0,
                me: int = 0) -> None:
    """Compact every level's unresolved fast leaves into the sub-run's
    level 0 (K7 ``_collect_fast``): one scan over all levels, each leaf's
    slot id written back, leaves past the buffer resolved UNKNOWN + over;
    the leaf count and the sub-run's first occupancy into ``occ``.  On
    shard ``me`` of an ``n_shards`` mesh only the leaves whose (ns, obj)
    it owns are live (the sharded ``_fast_subrun``'s activation)."""
    if st.tasks.device.type == "cpu":
        return _gen_collect_plain(st, q_subj, n_shards=n_shards, me=me)
    tot = st.tasks.shape[1]
    dev = st.tasks.device
    kernels.require(q_subj, torch.int32, "q_subj", shape=(st.q,), device=dev)
    scratch = torch.empty(tot, dtype=torch.int32, device=dev)
    pos = torch.empty(tot, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    block_sums = torch.empty(-(-max(tot, 1) // fp._SCAN_TILE), dtype=torch.int32,
                             device=dev)
    _launch("gen_collect", kernels.gen_state(st), kernels.ptr(q_subj),
            kernels.ptr(scratch), kernels.ptr(pos), kernels.ptr(total),
            kernels.ptr(block_sums), n_shards, me)


def _gen_collect_plain(st: GenState, q_subj: Tensor, *, n_shards: int = 0,
                       me: int = 0) -> None:
    levels = [st.task_dict(L) for L in range(len(st.widths))]
    B = st.leaves.qid.shape[0]
    levels, fb, q_over, fast_n = _collect_fast(levels, q_subj, st.q_over, B, st.q)
    st.q_over.copy_(q_over)
    for L, t in enumerate(levels):
        st.put_tasks(L, {c: t[c] for c in ("fast_id", "resolved", "res")})
    mine = None
    if n_shards:
        mine = hashtab.shard_of(fb["ns"], fb["obj"], n_shards) == me
    f = _leaf_items(fb, st.n_sched, mine)
    for c in fp.ITEM_COLS:
        getattr(st.leaves, c).copy_(getattr(f, c))
    st.leaf_subj.copy_(fb["subj"])
    occ = st.occ()
    D = st.depth
    occ[D + 1:D + 2] = fast_n
    occ[D + 2:D + 3] = (f.qid >= 0).sum(dtype=torch.int32)


def gen_up(st: GenState, level: int, found: Tensor, fover: Tensor,
           fdirty: Tensor) -> None:
    """One level of the up pass: map the sub-run's verdicts back onto the
    level's fast leaves (an unfound leaf whose sub-run needed a dirty row
    marks its query dirty), resolve its unresolved combiners from their
    child counts (OR / AND / NOT / PASS, any ERR first), then add the
    level's effective IS / NOT / ERR into its parents' counts."""
    if st.tasks.device.type == "cpu":
        return _gen_up_plain(st, level, found, fover, fdirty)
    lo, n = st.span(level)
    plo, pn = st.span(level - 1) if level > 0 else (0, 0)
    B = st.leaves.qid.shape[0]
    dev = st.tasks.device
    kernels.require(found, torch.int32, "found", shape=(B,), device=dev)
    kernels.require(fover, torch.int32, "fover", shape=(B,), device=dev)
    kernels.require(fdirty, torch.int32, "fdirty", shape=(B,), device=dev)
    _launch("gen_up", kernels.gen_state(st), lo, n, level, plo, pn,
            kernels.ptr(found), kernels.ptr(fover), kernels.ptr(fdirty))


def _gen_up_plain(st: GenState, level: int, found: Tensor, fover: Tensor,
                  fdirty: Tensor) -> None:
    Q = st.q
    B = found.shape[0]
    t = st.task_dict(level)
    qc = t["qid"].clamp(0, Q - 1)
    # the sub-run's verdicts: pure-OR checks with depth >= 1 are exactly
    # IS / NOT (OR swallows UNKNOWN at every level); depth <= 0 is the root
    # guard UNKNOWN unless a forced probe hit
    has = t["fast_id"] >= 0
    fc = _i64(t["fast_id"].clamp(0, B - 1))
    fnd = found[fc] != 0
    f_res = torch.where(fnd, R_IS, torch.where(t["d"] >= 1, R_NOT, R_UNKNOWN))
    st.q_over.copy_(_scatter_or(st.q_over, qc, has & (fover[fc] != 0)))
    st.q_dirty.copy_(_scatter_or(st.q_dirty, qc, has & (fdirty[fc] != 0) & ~fnd))
    res = torch.where(has, f_res, t["res"])
    resolved = t["resolved"] | has
    if level < st.depth:
        # combiners over three-valued child counts (binop.go:18-73,
        # rewrites.go:186-230)
        lo, n = st.span(level)
        nis, nnot, nerr = (st.cnt[k, lo:lo + n] for k in range(3))
        unres = (t["qid"] >= 0) & ~resolved
        val_or = torch.where((nis > 0) | t["seed"], R_IS, R_NOT)
        val_and = torch.where(nis == t["nchild"], R_IS, R_NOT)
        val_not = torch.where(nis > 0, R_NOT, torch.where(nnot > 0, R_IS, R_UNKNOWN))
        val_pass = torch.where(nis > 0, R_IS, torch.where(nnot > 0, R_NOT, R_UNKNOWN))
        v = _sel(
            [nerr > 0, t["cop"] == OP_AND, t["cop"] == OP_NOT, t["cop"] == OP_PASS],
            [torch.full_like(val_or, R_ERR), val_and, val_not, val_pass],
            val_or,
        )
        res = torch.where(unres, v, res)
        resolved = resolved | unres
    st.put_tasks(level, {"res": res, "resolved": resolved})
    if level > 0:
        # folded-NOT parity: a negated edge delivers IS as NOT and vice
        # versa; UNKNOWN and ERR pass through
        plo, pn = st.span(level - 1)
        val = t["qid"] >= 0
        pt = _i64(torch.where(val, t["parent"].clamp(0, pn - 1), pn))
        eff_is = torch.where(t["neg"], res == R_NOT, res == R_IS)
        eff_not = torch.where(t["neg"], res == R_IS, res == R_NOT)
        for k, bit in enumerate((eff_is, eff_not, res == R_ERR)):
            row = torch.cat([st.cnt[k, plo:plo + pn],
                             torch.zeros(1, dtype=torch.int32, device=pt.device)])
            st.cnt[k, plo:plo + pn] = row.index_add(0, pt, _i32(bit))[:pn]


def gen_pack(st: GenState) -> None:
    """The verdict code of each query into the output buffer: bits 0-1 the
    root's result, bit 2 over, bit 3 dirty."""
    if st.tasks.device.type == "cpu":
        return _gen_pack_plain(st)
    _launch("gen_pack", kernels.gen_state(st))


def _gen_pack_plain(st: GenState) -> None:
    lo, n = st.span(0)
    res = st.tasks[TI["res"], lo:lo + n]
    code = (res.to(torch.uint8) | ((st.q_over != 0).to(torch.uint8) << 2)
            | ((st.q_dirty != 0).to(torch.uint8) << 3))
    st.out[:st.q].copy_(code)


# -- the program --------------------------------------------------------------------


class _GenOps(NamedTuple):
    classify: object
    construct: object
    visited: object
    collect: object
    up: object
    pack: object
    arena_assign: object
    fast: fp._Ops


_OPS = _GenOps(gen_classify, gen_construct, gen_visited, gen_collect, gen_up,
               gen_pack, arena_assign, fp._OPS)
_PLAIN_OPS = _GenOps(_gen_classify_plain, _gen_construct_plain,
                     _gen_visited_plain, _gen_collect_plain, _gen_up_plain,
                     _gen_pack_plain, _arena_assign_plain, fp._PLAIN_OPS)


def run_general_packed(g: Tables, qpack, *, sizes: Tuple[int, ...], fast_b: int,
                       fast_sched: Tuple[Tuple[int, int], ...],
                       max_width: int = 100, vcap: int = 4096) -> Packed:
    """One general (AND/NOT) batch, every launch enqueued on the current
    stream with no host sync.

    ``qpack``: int32[6, Q] (ns, obj, rel, subj, depth, active), numpy or a
    tensor.  ``sizes``: task capacity of skeleton levels 1..D (level 0 is
    Q); ``fast_b``: the leaf buffer; ``fast_sched``: the sub-run's
    (frontier, arena) per level; ``vcap``: the visited set's capacity.
    Returns the :class:`Packed` codes (uint8[Q]: bits 0-1 R_* result,
    bit 2 over, bit 3 dirty) and occupancy (int32[D + 2 + len(fast_sched)]:
    live tasks per skeleton level, the leaf count, the sub-run's live
    leaves per level), fetched with one copy.  On CUDA tables every step
    runs a kernel."""
    return _run_general(_OPS, g, qpack, sizes, fast_b, fast_sched, max_width,
                        vcap)[0]


def run_general_packed_plain(g: Tables, qpack, *, sizes: Tuple[int, ...],
                             fast_b: int,
                             fast_sched: Tuple[Tuple[int, int], ...],
                             max_width: int = 100, vcap: int = 4096) -> Packed:
    """:func:`run_general_packed` through the plain PyTorch versions only,
    on whatever device the tables are: it launches no kernel."""
    return _run_general(_PLAIN_OPS, g, qpack, sizes, fast_b, fast_sched,
                        max_width, vcap)[0]


def _run_general(ops: _GenOps, g: Tables, qpack, sizes, fast_b: int, fast_sched,
                 max_width: int, vcap: int, act: Optional[Tensor] = None):
    """The program over the steps of ``ops``, for the rows of ``qpack``
    (rows ns, obj, rel, subj, depth first) that ``act`` marks (int32[Q] on
    the tables' device; default the block's row 5).  Returns (packed,
    state)."""
    dev = g["row_ptr"].device
    if isinstance(qpack, torch.Tensor):
        qp = qpack.to(device=dev, dtype=torch.int32).contiguous()
    else:
        qp = torch.from_numpy(np.ascontiguousarray(qpack, np.int32)).to(dev)
    q = qp.shape[1]
    st = GenState.new(q, tuple(sizes), fast_b, len(fast_sched), vcap, dev)
    q_subj = qp[3]
    depth = len(sizes)
    ops.classify(g, st, 0, q_subj, qpack=qp, act=qp[5] if act is None else act,
                 last=depth == 0)
    for L, a in enumerate(sizes):
        offsets, _total, parent, ordinal = ops.arena_assign(st.acount(L), a)
        ops.construct(g, st, L, offsets, parent, ordinal, max_width=max_width)
        ops.visited(st, L + 1)
        ops.classify(g, st, L + 1, q_subj, last=L + 1 == depth)
    ops.collect(st, q_subj)
    found, fover, fdirty = _fast_subrun(ops.fast, g, st.leaves, st.leaf_subj,
                                        sched=fast_sched, max_width=max_width,
                                        occ=st.occ()[depth + 2:])
    for L in range(depth, -1, -1):
        ops.up(st, L, found, fover, fdirty)
    ops.pack(st)
    return st.packed(), st
