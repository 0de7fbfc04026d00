"""Batched Expand: a level walk on the card, the exact DFS replay on the host.

The port of the JAX package's ``engine/expand_device.py``.  The
reference's Expand (`internal/expand/engine.go:43-124`) walks one subject
set's membership recursively, with a *global* visited set shared across
the whole tree (the first DFS occurrence of a subject expands, later
occurrences render as leaves) and depth truncation.  The shape of the
output tree therefore depends on DFS order, which a data-parallel walk
cannot reproduce directly.  The work is split instead:

* **device** (:func:`expand_levels`, K9) -- all roots at once: per level,
  every live item's full member list (the membership CSR built at
  snapshot time, leaf subjects included, unlike the subject-set-only check
  CSR) is gathered into arena slots with per-item parent pointers.
  Expansion is bounded only by *ancestor* cycles (one ancestor column per
  level, so the check is a handful of compares) and by depth; there is no
  global visited set.  The result is a superset forest: every DFS-reachable
  subtree is present.  Each level is one K4 ``arena_assign`` plus one
  launch of ``csrc/expand.cu`` (:func:`expand_roots` for level 0,
  :func:`expand_level` after it), every record written into one packed
  buffer that the host fetches with one device-to-host copy.
* **host** (:func:`assemble`) -- replays the reference's exact recursion
  over the records: global visited set in DFS order, ``None``-pruning of
  empty rows, depth-1 leaf truncation (engine.go:102-106), children in
  row (insertion / pagination) order.  Ancestor-cycle items the device did
  not expand are exactly the items the DFS replay prunes through its
  visited set before looking at their children, so the superset is always
  sufficient.

Per-root arena overflow surfaces as an ``over`` bit; the engine answers
those roots with the sequential oracle.  Each kernel wrapper takes its
plain PyTorch version for CPU tensors only; on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.api.types import (
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
    Tree,
    TreeNodeType,
)
from ketotpu_torch.engine import delta as dl
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine.vocab import Vocab
from ketotpu_torch.engine.xutil import _arena_assign_plain, arena_assign

Tensor = torch.Tensor
Tables = Dict[str, Tensor]

#: the rows of a level record, int32[7, width] (live as 0/1)
REC = ("parent", "subj", "node", "d", "deg", "root", "live")


# -- K9, plain form (the CUDA form is csrc/expand.cu) ---------------------------


def _mem_deg(g: Tables, node: Tensor) -> Tensor:
    """Member-row degree; 0 for ``node < 0`` and for an overlay-created
    virtual node (``>= ov_nbase``), which has no base member row: its
    members come entirely from the host-side overlay merge.  A dirty row
    keeps its base degree (the host merges its deltas)."""
    ptr = g["mem_row_ptr"]
    safe = node.clamp(0, ptr.shape[0] - 2).to(torch.int64)
    deg = ptr[safe + 1] - ptr[safe]
    ok = node >= 0
    if "ov_nbase" in g:
        ok = ok & (node < g["ov_nbase"])
    return torch.where(ok, deg, 0).to(torch.int32)


def _expand_roots_plain(g: Tables, roots: Tensor, width: int, *,
                        out: Optional[Tensor] = None):
    """Level 0 from ``roots`` (int32[5, n]: ns, obj, rel, subj, depth) in
    ``width >= n`` slots; slots past n are dead padding.  Returns the
    record (int32[7, width], written into ``out`` when given), the arena
    counts (int32[width]) and the ancestor columns (int32[1, width])."""
    n = roots.shape[1]
    dev = roots.device

    def pad(x, fill):
        return torch.cat([x.to(torch.int32),
                          torch.full((width - n,), fill, dtype=torch.int32,
                                     device=dev)])

    node = pad(fp._node_lookup(g, roots[0], roots[1], roots[2]), -1)
    d = pad(roots[4], 0)
    subj = pad(roots[3], -1)
    root = pad(torch.arange(n, dtype=torch.int32, device=dev), -1)
    live = torch.arange(width, device=dev) < n
    deg = torch.where(live, _mem_deg(g, node), 0).to(torch.int32)
    counts = torch.where(live & (d >= 2), deg, 0).to(torch.int32)
    anc = torch.where(live, subj, -2).to(torch.int32)[None]
    rec = torch.stack([torch.full_like(node, -1), subj, node, d, deg, root,
                       live.to(torch.int32)])
    if out is not None:
        out.copy_(rec)
        rec = out
    return rec, counts, anc


def _expand_level_plain(g: Tables, rec: Tensor, counts: Tensor, anc: Tensor,
                        offsets: Tensor, parent: Tensor, ordinal: Tensor, *,
                        over: Tensor, out: Optional[Tensor] = None,
                        last: bool = False):
    """One level: the over bits (int32[R], set in place) of the roots of
    the level-l items (``rec``) whose members did not all fit the
    ``parent.shape[0]``-slot arena, then the level-l+1 record of every
    arena slot (K4's ``parent`` / ``ordinal``): its member subject, decode,
    node lookup, ancestor-cycle check, depth, degree and, unless ``last``,
    arena counts.  Returns (record int32[7, A], counts int32[A] or None,
    ancestor columns int32[k+1, A])."""
    C = rec.shape[1]
    A = parent.shape[0]
    R = over.shape[0]
    _par, _subj, node, d, _deg, root, live = rec
    fits = offsets + counts <= A
    flag = (live != 0) & (counts > 0) & ~fits
    over.scatter_reduce_(0, root.clamp(0, R - 1).to(torch.int64),
                         flag.to(torch.int32), "amax")
    aps = parent.clamp(0, C - 1).to(torch.int64)
    src_ok = (parent >= 0) & fits[aps]
    mrp, mos = g["mem_row_ptr"], g["mem_ord_subj"]
    mbase = mrp[node[aps].clamp(0, mrp.shape[0] - 2).to(torch.int64)]
    midx = (mbase + ordinal).clamp(0, mos.shape[0] - 1).to(torch.int64)
    c_subj = torch.where(src_ok, mos[midx], -1).to(torch.int32)
    sc = c_subj.clamp(0, g["sub_ns"].shape[0] - 1).to(torch.int64)
    s_ns = torch.where(c_subj >= 0, g["sub_ns"][sc], -1).to(torch.int32)
    c_is_set = s_ns >= 0
    c_node = fp._node_lookup(g, s_ns, g["sub_obj"][sc], g["sub_rel"][sc])
    c_d = (d[aps] - 1).clamp(min=0).to(torch.int32)
    a_par = anc[:, aps]
    cyc = (a_par == c_subj).any(0) & c_is_set
    expandable = src_ok & c_is_set & ~cyc
    anc_out = torch.cat([torch.where(src_ok, a_par, -2),
                         torch.where(src_ok & c_is_set, c_subj, -2)[None]]
                        ).to(torch.int32)
    n_node = torch.where(expandable, c_node, -1).to(torch.int32)
    n_deg = torch.where(expandable, _mem_deg(g, n_node), 0).to(torch.int32)
    n_counts = None if last else torch.where(
        expandable & (c_d >= 2), n_deg, 0).to(torch.int32)
    out_rec = torch.stack([
        torch.where(src_ok, parent, -1).to(torch.int32), c_subj, n_node, c_d,
        n_deg, torch.where(src_ok, root[aps], -1).to(torch.int32),
        expandable.to(torch.int32)])
    if out is not None:
        out.copy_(out_rec)
        out_rec = out
    return out_rec, n_counts, anc_out


# -- K9 wrappers: the kernel on CUDA tensors, the plain form on CPU ones -------


def expand_roots(g: Tables, roots: Tensor, width: int, *,
                 out: Optional[Tensor] = None):
    """Level 0 of the walk (:func:`_expand_roots_plain`)."""
    if roots.device.type == "cpu":
        return _expand_roots_plain(g, roots, width, out=out)
    n = roots.shape[1]
    if width < n:
        raise ValueError(f"level 0 of {width} slots holds fewer than {n} roots")
    dev = roots.device
    kernels.require(roots, torch.int32, "roots", shape=(5, n), device=dev)
    if out is None:
        out = torch.empty((7, width), dtype=torch.int32, device=dev)
    kernels.require(out, torch.int32, "out", shape=(7, width), device=dev)
    counts = torch.empty(width, dtype=torch.int32, device=dev)
    anc = torch.empty((1, width), dtype=torch.int32, device=dev)
    kernels.launch(
        "expand", "expand_roots", kernels.graph(g), kernels.xtab(g),
        kernels.ptr(roots), n, width, kernels.ptr(out), kernels.ptr(counts),
        kernels.ptr(anc), kernels.stream(),
    )
    kernels.LAUNCHES["expand_roots"] += 1
    return out, counts, anc


def expand_level(g: Tables, rec: Tensor, counts: Tensor, anc: Tensor,
                 offsets: Tensor, parent: Tensor, ordinal: Tensor, *,
                 over: Tensor, out: Optional[Tensor] = None,
                 last: bool = False):
    """One level of the walk after K4 (:func:`_expand_level_plain`)."""
    if rec.device.type == "cpu":
        return _expand_level_plain(g, rec, counts, anc, offsets, parent,
                                   ordinal, over=over, out=out, last=last)
    dev = rec.device
    C = rec.shape[1]
    A = parent.shape[0]
    R = over.shape[0]
    k = anc.shape[0]
    kernels.require(rec, torch.int32, "rec", shape=(7, C), device=dev)
    kernels.require(counts, torch.int32, "counts", shape=(C,), device=dev)
    kernels.require(anc, torch.int32, "anc", shape=(k, C), device=dev)
    kernels.require(offsets, torch.int32, "offsets", shape=(C,), device=dev)
    kernels.require(parent, torch.int32, "parent", shape=(A,), device=dev)
    kernels.require(ordinal, torch.int32, "ordinal", shape=(A,), device=dev)
    kernels.require(over, torch.int32, "over", shape=(R,), device=dev)
    if out is None:
        out = torch.empty((7, A), dtype=torch.int32, device=dev)
    kernels.require(out, torch.int32, "out", shape=(7, A), device=dev)
    n_counts = None if last else torch.empty(A, dtype=torch.int32, device=dev)
    anc_out = torch.empty((k + 1, A), dtype=torch.int32, device=dev)
    kernels.launch(
        "expand", "expand_level", kernels.graph(g), kernels.xtab(g),
        kernels.ptr(rec), kernels.ptr(counts), kernels.ptr(anc), k, C,
        kernels.ptr(offsets), kernels.ptr(parent), kernels.ptr(ordinal), A,
        kernels.ptr(over), R, kernels.ptr(out), kernels.ptr(n_counts),
        kernels.ptr(anc_out), kernels.stream(),
    )
    kernels.LAUNCHES["expand_level"] += 1
    return out, n_counts, anc_out


class XOps(NamedTuple):
    """The walk's steps: the wrappers (:data:`OPS`) or their plain versions
    (:data:`PLAIN_OPS`); a test or the smoke run substitutes its own."""

    roots: object
    level: object
    arena: object


OPS = XOps(expand_roots, expand_level, arena_assign)
PLAIN_OPS = XOps(_expand_roots_plain, _expand_level_plain, _arena_assign_plain)


def record_offsets(schedule: Tuple[int, ...]) -> List[int]:
    """Start of each level's record in the packed buffer (then ``over``)."""
    out = [0]
    for w in schedule:
        out.append(out[-1] + 7 * w)
    return out


def expand_levels(g: Tables, roots: Tensor, schedule: Tuple[int, ...],
                  ops: Optional[XOps] = None) -> Tensor:
    """Enqueue the whole walk on ``roots`` (int32[5, R], on the tables'
    device) with ``schedule[l]`` slots at level l (``schedule[0] >= R``).
    Returns one int32 buffer: every level's int32[7, schedule[l]] record,
    then ``over`` int32[R] (1 = a root's walk overflowed an arena).  No
    sync: the caller's one device-to-host copy of the buffer waits.
    ``ops`` defaults to :data:`OPS`."""
    ops = ops or OPS
    R = roots.shape[1]
    offs = record_offsets(schedule)
    buf = torch.empty(offs[-1] + R, dtype=torch.int32, device=roots.device)
    over = buf[offs[-1]:]
    over.zero_()

    def rec_out(level):
        return buf[offs[level]:offs[level + 1]].view(7, schedule[level])

    rec, counts, anc = ops.roots(g, roots, schedule[0], out=rec_out(0))
    for level in range(1, len(schedule)):
        offsets, _total, parent, ordinal = ops.arena(counts, schedule[level])
        rec, counts, anc = ops.level(
            g, rec, counts, anc, offsets, parent, ordinal, over=over,
            out=rec_out(level), last=level == len(schedule) - 1)
    return buf


def unpack(host: np.ndarray, schedule: Tuple[int, ...], n_roots: int):
    """The packed buffer on the host -> (per-level dicts of :data:`REC`
    columns, live as bool; over bool[n_roots])."""
    offs = record_offsets(schedule)
    levels = []
    for level, w in enumerate(schedule):
        rec = host[offs[level]:offs[level + 1]].reshape(7, w)
        cols = dict(zip(REC, rec))
        cols["live"] = cols["live"] != 0
        levels.append(cols)
    over = host[offs[-1]:offs[-1] + n_roots] != 0
    return levels, over


def _run_expand_plain(g: Tables, r_ns, r_obj, r_rel, r_subj, r_depth, *,
                      schedule: Tuple[int, ...]):
    """The whole walk through the plain versions: the JAX ``_run_expand``'s
    (levels, over) as numpy (the same records, bit for bit)."""
    roots = torch.stack([torch.as_tensor(np.asarray(x, np.int32)) for x in (
        r_ns, r_obj, r_rel, r_subj, r_depth)]).to(g["row_ptr"].device)
    buf = expand_levels(g, roots, schedule, PLAIN_OPS)
    return unpack(buf.cpu().numpy(), schedule, roots.shape[1])


# -- host half: schedule, roots, decode, overlay merge, DFS replay -------------


def expand_schedule(n_roots: int, fanout: int, max_depth: int,
                    cap: int) -> Tuple[int, ...]:
    """Item capacities per level: geometric in the expected fan-out,
    clamped to ``cap``; misses surface as per-root overflow bits."""
    out = [n_roots]
    for _ in range(max_depth - 1):
        out.append(min(out[-1] * fanout, cap))
    return tuple(out)


def encode_roots(vocab: Vocab, roots: List[SubjectSet]) -> np.ndarray:
    """int32[5, Rp] root block (ns, obj, rel, subj, depth 0), Rp the power
    of two >= max(8, len(roots)): one walk shape per bucket.  Padding rows
    carry -1 ids and depth 0; the walk never expands them and the assembly
    never visits them.  The caller sets row 4 of the real roots."""
    R = len(roots)
    Rp = 8
    while Rp < R:
        Rp <<= 1
    block = np.full((5, Rp), -1, np.int32)
    block[4] = 0
    block[0, :R] = np.fromiter(
        (vocab.namespaces.lookup(s.namespace) for s in roots), np.int32, R)
    block[1, :R] = np.fromiter(
        (vocab.objects.lookup(s.object) for s in roots), np.int32, R)
    block[2, :R] = np.fromiter(
        (vocab.relations.lookup(s.relation) for s in roots), np.int32, R)
    block[3, :R] = np.fromiter(
        (vocab.subject_key(s) for s in roots), np.int32, R)
    return block


class Decoder:
    """Reverse vocab: dense ids back to API strings and subjects (the
    uid-decode convention: the ``id:`` / ``set:`` prefixes of
    ``Subject.unique_id``)."""

    def __init__(self, vocab: Vocab):
        self.ns = vocab.namespaces.strings()
        self.obj = vocab.objects.strings()
        self.rel = vocab.relations.strings()
        self.sub = vocab.subjects.strings()

    def subject(self, subj_id: int, s_ns: int, s_obj: int, s_rel: int) -> Subject:
        if s_ns >= 0:
            return SubjectSet(self.ns[s_ns], self.obj[s_obj], self.rel[s_rel])
        uid = self.sub[subj_id]
        # unique_id format "id:<subject id>" (api/types.py)
        return SubjectID(uid[3:] if uid.startswith("id:") else uid)

    def subject_from_uid(self, subj_id: int) -> Subject:
        """Decode via the unique-id string alone: works for subjects
        interned AFTER the snapshot (overlay writes), which the snapshot's
        sub_ns / sub_obj / sub_rel arrays do not cover."""
        uid = self.sub[subj_id]
        if uid.startswith("set:"):
            return SubjectSet.from_string(uid[4:])
        return SubjectID(uid[3:] if uid.startswith("id:") else uid)


class OverlayMembers:
    """Host-side view of the write overlay for Expand: per-node membership
    deltas against the base snapshot, plus (hi, obj) -> virtual-node
    resolution.

    Built under the engine's lock (a point-in-time copy: the live
    ``OverlayState`` keeps mutating as writes land).  Expand is the one
    read path that needs *every* member of a row, so the overlay-exact
    story is host-side: the device enumerates base rows, and
    :func:`assemble` drops deleted members, appends added ones (in write
    order, matching the reference's insertion-ordered pagination,
    relationtuples.go:216-219), and recurses into added subject sets via
    the sequential engine.  One known divergence, as in JAX: a member
    deleted and re-added since the snapshot keeps its original row
    position here, while live-store pagination would move it to the end."""

    def __init__(self, overlay: dl.OverlayState, snap, vocab: Vocab):
        self.added: Dict[int, List[int]] = {}
        self.deleted: Dict[int, set] = {}
        for (node, subj), net in overlay.pair_net.items():
            # classify against the BASE pair count, exactly like
            # overlay_arrays: the sign of net alone diverges from
            # live-store membership under duplicate-tuple multiplicity
            # (the in-memory store permits exact duplicate rows), e.g.
            # delete-one-of-two must not drop the member
            base = (
                dl._base_pair_count(snap, node, subj)
                if node < snap.n_nodes
                else 0
            )
            now = base + net
            if now <= 0:
                if base > 0:
                    self.deleted.setdefault(node, set()).add(subj)
            elif now > base:
                # one entry per extra copy: duplicate inserts appear as
                # duplicate rows in live-store pagination
                self.added.setdefault(node, []).extend([subj] * (now - base))
            elif now < base:
                # delete-all-then-reinsert-fewer: drop the base copies and
                # append the surviving count (live pagination also moves
                # the re-inserted copies to the end)
                self.deleted.setdefault(node, set()).add(subj)
                self.added.setdefault(node, []).extend([subj] * now)
        self.new_nodes = dict(overlay.new_nodes)
        self._snap = snap
        self._vocab = vocab

    def resolve(self, s: SubjectSet) -> int:
        """Node id (base or virtual) for a subject set, -1 if unknown."""
        v = self._vocab
        ns = v.namespaces.lookup(s.namespace)
        rel = v.relations.lookup(s.relation)
        obj = v.objects.lookup(s.object)
        if ns < 0 or rel < 0 or obj < 0:
            return -1
        hi = ns * self._snap.num_rels + rel
        node = dl._base_node_id(self._snap, hi, obj)
        if node < 0:
            node = self.new_nodes.get((hi, obj), -1)
        return node


def _leaf(subject: Subject) -> Tree:
    return Tree(type=TreeNodeType.LEAF,
                tuple=RelationTuple("", "", "", subject))


def assemble(
    levels: List[Dict[str, np.ndarray]],
    sub_dec: Tuple[np.ndarray, np.ndarray, np.ndarray],
    vocab: Vocab,
    roots: List[SubjectSet],
    ov: Optional[OverlayMembers] = None,
    sub_expand=None,
) -> List[Optional[Tree]]:
    """Exact DFS replay of expand/engine.go:54-124 over the device records.

    With ``ov`` set, each union node's member list is the base row minus
    deleted pairs plus added pairs; added subject-set members (which the
    device never expanded) recurse through ``sub_expand(subject, depth,
    visited)``: the sequential engine sharing THIS tree's visited set, so
    the reference's global-DFS-visited semantics hold across the merge."""
    dec = Decoder(vocab)
    sub_ns, sub_obj, sub_rel = sub_dec
    n_snap_subj = len(sub_ns)
    # children of item i at level l: slots of level l+1 with parent == i,
    # in slot (row insertion) order
    kids: List[Dict[int, List[int]]] = []
    for nxt in levels[1:]:
        by_parent: Dict[int, List[int]] = {}
        for slot in np.flatnonzero(nxt["parent"] >= 0):
            by_parent.setdefault(int(nxt["parent"][slot]), []).append(int(slot))
        kids.append(by_parent)

    def decode(sid: int) -> Subject:
        if sid < n_snap_subj:
            return dec.subject(
                sid, int(sub_ns[sid]), int(sub_obj[sid]), int(sub_rel[sid])
            )
        return dec.subject_from_uid(sid)

    out: List[Optional[Tree]] = []
    for r, root_subject in enumerate(roots):
        visited = set()

        def build(level: int, slot: int, subject: Subject, depth: int):
            if isinstance(subject, SubjectID):
                return _leaf(subject)
            if subject.unique_id() in visited:
                return None
            visited.add(subject.unique_id())
            base_deg = int(levels[level]["deg"][slot])
            added: List[int] = []
            deleted: set = set()
            if ov is not None:
                node = ov.resolve(subject)
                if node >= 0:
                    added = ov.added.get(node, [])
                    deleted = ov.deleted.get(node, set())
            if base_deg - len(deleted) + len(added) <= 0:
                return None
            tree = Tree(type=TreeNodeType.UNION,
                        tuple=RelationTuple("", "", "", subject))
            if depth <= 1:
                tree.type = TreeNodeType.LEAF
                return tree
            for cslot in kids[level].get(slot, ()):  # row order
                rec = levels[level + 1]
                sid = int(rec["subj"][cslot])
                if sid in deleted:
                    continue
                child_subject = decode(sid)
                child = build(level + 1, cslot, child_subject,
                              int(rec["d"][cslot]))
                if child is None:
                    child = _leaf(child_subject)
                tree.children.append(child)
            for sid in added:  # write order = end of the live row
                child_subject = decode(sid)
                if isinstance(child_subject, SubjectID):
                    tree.children.append(_leaf(child_subject))
                    continue
                child = sub_expand(child_subject, depth - 1, visited)
                if child is None:
                    child = _leaf(child_subject)
                tree.children.append(child)
            return tree

        out.append(build(0, r, root_subject, int(levels[0]["d"][r])))
    return out


def run_expand(
    g: Tables,
    snap,
    roots: List[SubjectSet],
    rest_depth: int,
    *,
    max_depth: int = 5,
    fanout: int = 16,
    cap: int = 65536,
    ov: Optional[OverlayMembers] = None,
    sub_expand=None,
    timings: Optional[Dict[str, float]] = None,
    info: Optional[dict] = None,
):
    """Device walk + host assembly for a batch of subject-set roots.

    Returns ``(trees, over)``: per-root Optional[Tree] (None = prune / 404)
    and per-root overflow flags (True = answer with the oracle instead).
    ``timings`` (if given) receives the phase wall seconds: ``device``
    (root encode + the walk's enqueue), ``sync`` (the one device-to-host
    copy of every level record, which waits for the card), ``assemble``
    (host DFS replay + tree construction).  ``info`` (if given) receives
    the walk's ``schedule`` and padded root count ``roots``."""
    vocab = snap.vocab
    if rest_depth <= 0 or max_depth < rest_depth:
        rest_depth = max_depth
    t0 = time.perf_counter()
    R = len(roots)
    block = encode_roots(vocab, roots)
    block[4, :R] = rest_depth
    sched = expand_schedule(block.shape[1], fanout, rest_depth, cap)
    dev = g["row_ptr"].device
    buf = expand_levels(g, torch.from_numpy(block).to(dev), sched)
    t1 = time.perf_counter()
    host = buf.cpu().numpy()
    t2 = time.perf_counter()
    levels, over = unpack(host, sched, block.shape[1])
    over = over[:R]
    trees = assemble(
        levels, (snap.sub_ns, snap.sub_obj, snap.sub_rel), vocab, roots,
        ov=ov, sub_expand=sub_expand,
    )
    t3 = time.perf_counter()
    if timings is not None:
        timings["device"] = t1 - t0
        timings["sync"] = t2 - t1
        timings["assemble"] = t3 - t2
    if info is not None:
        info.update(schedule=sched, roots=block.shape[1])
    return trees, over
