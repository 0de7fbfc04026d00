"""Graph-sharded batch checks: the CSR partitioned across the mesh (K10).

The port of the JAX package's ``parallel/graphshard.py``.  A tuple row lives
on shard ``hash(namespace, object) % n`` (hashtab's mix, salt 0), so every
relation of an object is co-resident: direct membership probes, the
batched computed-subject-set shortcut and tuple-to-userset via-rows are
shard-local, and only *children* cross shards.  Each BFS level runs

    expand (local)  ->  route children to their owners  ->  exchange
    ->  merge the found bits  ->  pack (dedup on arrival)

and the general (AND/NOT) tier runs the K7 program on every shard over the
whole query block, each task's data-dependent classification and
construction taken from its owner shard by owner-masked merges
(``engine/algebra.py``'s ``shard=`` branch).

One process drives every shard, as JAX's single controller does: shard
``s``'s tables and per-level state live on ``mesh.devices[s]``.  The
counterpart of ``lax.all_to_all`` is :func:`exchange`, device-to-device
copies of each (source, destination) block; the counterpart of
``lax.psum`` is :func:`gather` (the n partials copied onto the shard's
device) followed by a merge kernel.  The copies are collectives, not
kernels, and take one code path whether or not two shards share a card.

The kernels (``csrc/shard.cu``), each with its plain PyTorch version
beside its wrapper (the wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises):

* :func:`shard_owner` — the owner hash of (ns, obj) (F1: ``mix32`` in
  uint32, ``% n``);
* :func:`shard_route` — each child's owner, its rank within its
  destination in (destination, index) order, the ``q_over`` bits of
  children past ``cap``, and the ``[n * cap, 7]`` send block with the
  reference's fills (F2: the dropped scatter lands in a sink row);
* :func:`merge_bits` (``shard_merge``), :func:`merge_classified`
  (``shard_merge_classified``), :func:`merge_child`
  (``shard_merge_child``) — ``psum(where(mine, x, 0))`` over the gathered
  partials, its ``> 0`` form for bools.

plus the mask inputs of ``fastpath.init_state`` (``assign``),
``algebra.gen_classify`` (``shard``), ``gen_construct`` (``owner``) and
``gen_collect`` (``n_shards``), and the packs (``fastpath._pack_scatter``
or, past 31 key bits, ``fastpath._pack_sort``) reading the received rows
as they are.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import algebra as alg
from ketotpu_torch.engine import delta as dl
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine import hashtab
from ketotpu_torch.engine.snapshot import (
    EXPAND_ONLY_KEYS,
    MESH_ONLY_KEYS,
    Snapshot,
)
from ketotpu_torch.engine.vocab import Vocab
from ketotpu_torch.parallel.mesh import Mesh, _on

Tensor = torch.Tensor

#: one routed child: qid, ns, obj, rel, d, skip, force (int32 each), and
#: the send block's fills
ROUTE_FILLS = (-1, -1, -1, -1, 0, 1, 0)
#: the task columns a construction writes (the child merge's columns)
CHILD_COLS = alg.TASK_COLS[:12]


# -- the partition (host) -------------------------------------------------------


def shard_of_np(ns_ids: np.ndarray, obj_ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard of (namespace, object) — host side."""
    h = hashtab._mix_np(
        np.asarray(ns_ids, np.int64), np.asarray(obj_ids, np.int64),
        hashtab._SALTS[0],
    )
    return (h % np.uint32(n_shards)).astype(np.int32)


def build_sharded_snapshot(
    store,
    manager,
    n_shards: int,
    vocab: Optional[Vocab] = None,
    cols=None,
    replicate: Optional[Dict[Tuple[int, int], Sequence[int]]] = None,
) -> Tuple[List[Snapshot], Dict[str, np.ndarray]]:
    """Partition the store by owner shard and build one snapshot per shard.

    All shards share one vocabulary (ids are global) and are padded to
    common array shapes (fill 0 for ``*ptr`` with CSR tail rows repeating
    the last pointer, False for bools, -1 otherwise), so the stacked dict
    (leading axis = shard) slices into each shard's tables.  ``cols`` is
    the engine's column mirror (``delta.TupleColumns``; built from the
    store otherwise); each shard projects through ``build_snapshot_cols``
    over a masked view of it.  ``replicate`` maps (ns_id, obj_id) keys to
    extra shards that get a COPY of those rows (the hash owner keeps
    them)."""
    vocab = vocab if vocab is not None else Vocab()
    if cols is None:
        exporter = getattr(store, "export_columns", None)
        store_vocab = getattr(store, "vocab", None)
        if exporter is not None and (
            store_vocab is vocab or len(vocab.subjects) == 0
        ):
            carr, alive, tail, _head = exporter()
            cols = dl.TupleColumns.from_arrays(store_vocab, carr, alive)
            for t in tail:
                cols.apply(1, t)
            vocab = store_vocab
        else:
            cols = dl.TupleColumns(vocab)
            for t in store.all_tuples():
                cols.apply(1, t)

    live = np.flatnonzero(cols.alive[: cols.n])
    shard = shard_of_np(cols.ns[live], cols.obj[live], n_shards)
    extra = [np.zeros(0, np.int64)] * n_shards
    if replicate:
        packed = (
            np.asarray(cols.ns[live], np.int64) << 32
        ) | (np.asarray(cols.obj[live], np.int64) & 0xFFFFFFFF)
        for (ns_id, obj_id), shards_for in replicate.items():
            key = (np.int64(ns_id) << 32) | (np.int64(obj_id) & 0xFFFFFFFF)
            rows = live[packed == key]
            if rows.size == 0:
                continue
            for s in shards_for:
                extra[int(s)] = np.concatenate([extra[int(s)], rows])
    version = getattr(store, "version", -1)
    snaps: List[Snapshot] = []
    for s in range(n_shards):
        keep = np.zeros(cols.n, bool)
        keep[live[shard == s]] = True
        keep[extra[s]] = True
        snaps.append(
            dl.build_snapshot_cols(cols.masked(keep), manager, version=version)
        )

    keys = snaps[0].arrays().keys()
    stacked: Dict[str, np.ndarray] = {}
    for k in keys:
        arrs = [np.asarray(s.arrays()[k]) for s in snaps]
        shape = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
        padded = []
        for a in arrs:
            pad = [(0, shape[i] - a.shape[i]) for i in range(a.ndim)]
            fill = 0 if k.endswith("ptr") else (False if a.dtype == bool else -1)
            b = np.pad(a, pad, constant_values=fill)
            if k.endswith("ptr") and a.shape[0] < shape[0]:
                b[a.shape[0]:] = a[-1]  # CSR tail rows stay empty
            padded.append(b)
        stacked[k] = np.stack(padded)
    return snaps, stacked


#: the stacked keys a shard's tables need on the device (the check arrays)
CHECK_KEYS_SKIP = frozenset(EXPAND_ONLY_KEYS) | frozenset(MESH_ONLY_KEYS)


def upload_shards(stacked: Dict[str, np.ndarray], mesh: Mesh,
                  skip=CHECK_KEYS_SKIP) -> List[kernels.DeviceTables]:
    """Each shard's slice of ``stacked`` (minus ``skip``) as tensors on its
    device: the port's counterpart of feeding the stacked dict through
    ``shard_map`` with ``P(axis)``."""
    out = []
    for s, dev in enumerate(mesh.devices):
        t = kernels.DeviceTables()
        for k, v in stacked.items():
            if k not in skip:
                t[k] = torch.from_numpy(np.ascontiguousarray(v[s])).to(dev)
        out.append(t)
    return out


# -- collectives (copies) --------------------------------------------------------


def gather(parts: Sequence, dev: torch.device) -> Tensor:
    """The n partials side by side on ``dev``: ``parts[s]`` is a tensor, or a
    list of equal-length rows, of shard ``s``; returns ``[n, *shape]``
    (the gather under ``lax.psum``)."""
    first = parts[0][0] if isinstance(parts[0], (list, tuple)) else parts[0]
    rows = len(parts[0]) if isinstance(parts[0], (list, tuple)) else None
    shape = (len(parts),) + ((rows,) if rows is not None else ()) + tuple(first.shape)
    stage = torch.empty(shape, dtype=first.dtype, device=dev)
    for s, p in enumerate(parts):
        if rows is None:
            stage[s].copy_(p)
        else:
            for r, x in enumerate(p):
                stage[s, r].copy_(x)
    return stage


def exchange(sends: Sequence[Tensor], devices: Sequence[torch.device],
             cap: int) -> List[Tensor]:
    """``lax.all_to_all`` of the routed send blocks (``[n * cap, 7]`` each):
    shard ``d`` receives ``concat_s(send_s[d])``, the ``cap``-row block
    every source addressed to it, in source order."""
    n = len(sends)
    out = []
    for d, dev in enumerate(devices):
        recv = torch.empty((n * cap, len(ROUTE_FILLS)), dtype=torch.int32,
                           device=dev)
        for s, send in enumerate(sends):
            recv[s * cap:(s + 1) * cap].copy_(send[d * cap:(d + 1) * cap])
        out.append(recv)
    return out


# -- kernel wrappers and their plain versions -------------------------------------


def _launch(name: str, *args) -> None:
    kernels.launch("shard", name, *args, kernels.stream())
    kernels.LAUNCHES[name] += 1


def shard_owner(ns: Tensor, obj: Tensor, n_shards: int) -> Tensor:
    """Owner shard of each (ns, obj) pair (the JAX ``shard_of_device``):
    int32[m]."""
    if ns.device.type == "cpu":
        return _shard_owner_plain(ns, obj, n_shards)
    m = ns.shape[0]
    dev = ns.device
    kernels.require(ns, torch.int32, "ns", shape=(m,))
    kernels.require(obj, torch.int32, "obj", shape=(m,), device=dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    _launch("shard_owner", kernels.ptr(ns), kernels.ptr(obj), m, n_shards,
            kernels.ptr(out))
    return out


def _shard_owner_plain(ns: Tensor, obj: Tensor, n_shards: int) -> Tensor:
    return hashtab.shard_of(ns, obj, n_shards)


def shard_route(children: fp.Items, q_over: Tensor, *, n_shards: int,
                cap: int) -> Tuple[Tensor, Tensor]:
    """Bucket one level's children by owner shard (the JAX ``_route``
    before its ``all_to_all``): ``cap`` rows per destination, a child's row
    its rank within its destination in (destination, index) order;
    children past ``cap`` mark their query over; dead children and
    overflowed ones are never sent.  Returns (send int32[n * cap, 7],
    q_over')."""
    if children.qid.device.type == "cpu":
        return _shard_route_plain(children, q_over, n_shards=n_shards, cap=cap)
    dev = children.qid.device
    a = children.qid.shape[0]
    nq = q_over.shape[0]
    kernels.require(q_over, torch.int32, "q_over", shape=(nq,), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    na = n_shards * a
    dest = torch.empty(a, **i32)
    flags = torch.empty(na, **i32)
    pos = torch.empty(na, **i32)
    total = torch.empty(1, **i32)
    block_sums = torch.empty(-(-max(na, 1) // fp._SCAN_TILE), **i32)
    send = torch.empty((n_shards * cap, len(ROUTE_FILLS)), **i32)
    q_over_out = torch.empty(nq, **i32)
    _launch("shard_route", kernels.items(children), n_shards, cap,
            kernels.ptr(q_over), kernels.ptr(q_over_out), nq, kernels.ptr(dest),
            kernels.ptr(flags), kernels.ptr(pos), kernels.ptr(total),
            kernels.ptr(block_sums), kernels.ptr(send))
    return send, q_over_out


def _shard_route_plain(children: fp.Items, q_over: Tensor, *, n_shards: int,
                       cap: int) -> Tuple[Tensor, Tensor]:
    n = n_shards
    qid = children.qid
    dev = qid.device
    A, Q = qid.shape[0], q_over.shape[0]
    dest = _shard_owner_plain(children.ns, children.obj, n).to(torch.int64)
    dest = torch.where(qid >= 0, dest, n)  # dead rows sort last
    iota = torch.arange(A, dtype=torch.int64, device=dev)
    order = torch.argsort(dest * (A + 1) + iota)  # keys are distinct
    dsorted = dest[order]
    pos = iota - torch.searchsorted(dsorted, dsorted, side="left")
    over_b = (dsorted < n) & (pos >= cap)
    cols = [children.qid, children.ns, children.obj, children.rel, children.d,
            children.skip.to(torch.int32), children.force.to(torch.int32)]
    srt = [c[order] for c in cols]
    q_over = fp._scatter_or(q_over, srt[0].clamp(0, Q - 1), over_b & (srt[0] >= 0))
    sink = n * cap  # F2: the reference's dropped rows scatter here
    slot = torch.where(dsorted < n, dsorted * cap + pos.clamp(0, cap - 1), sink)
    slot = torch.where(over_b, sink, slot)
    drop = over_b | (dsorted >= n)
    send = torch.empty((sink + 1, len(ROUTE_FILLS)), dtype=torch.int32, device=dev)
    for k, (col, fill) in enumerate(zip(srt, ROUTE_FILLS)):
        row = torch.full((sink + 1,), fill, dtype=torch.int32, device=dev)
        send[:, k] = row.scatter(0, slot, torch.where(drop, fill, col).to(torch.int32))
    return send[:sink].contiguous(), q_over


def merge_bits(stage: Tensor) -> Tensor:
    """``psum(x) > 0`` over the n partials of ``stage`` (int32[n, ...]):
    int32 0/1 of shape ``stage.shape[1:]`` (the found / over / dirty
    merges)."""
    if stage.device.type == "cpu":
        return _merge_bits_plain(stage)
    kernels.require(stage, torch.int32, "stage")
    out = torch.empty(stage.shape[1:], dtype=torch.int32, device=stage.device)
    _launch("shard_merge", kernels.ptr(stage), stage.shape[0], out.numel(),
            kernels.ptr(out))
    return out


def _merge_bits_plain(stage: Tensor) -> Tensor:
    return (stage.sum(0, dtype=torch.int32) > 0).to(torch.int32)


def _owner_masked(stage: Tensor, cols, owner: Tensor, bools) -> Dict[str, Tensor]:
    """``psum(where(mine, x, 0))`` of each column over the partials
    (``stage[s, col]``, shard ``s`` owning where ``owner == s``); a bool
    column as 0/1 words, then ``> 0``."""
    n = stage.shape[0]
    mine = torch.stack([owner == s for s in range(n)])
    out = {}
    for name, col in cols.items():
        x = stage[:, col]
        if name in bools:
            x = (x != 0).to(torch.int32)
        v = torch.where(mine, x, 0).sum(0, dtype=torch.int32)
        out[name] = v > 0 if name in bools else v
    return out


def merge_classified(g: Dict[str, Tensor], st: alg.GenState, level: int,
                     stage_t: Tensor, stage_a: Tensor, owner: Tensor, *,
                     last: bool) -> None:
    """The owner merge of one classified level (the JAX
    ``_merge_classified``) into this shard's state: each task's kind,
    prog, resolved, res, cop, seed, deg, dirt and count from its owner's
    partial (``stage_t`` / ``stage_a``: every shard's task and aux columns
    of the level, ``owner``: int32 per task); pp and pk recomputed from
    the merged prog; then the dirty fold, the depth cap of the last level
    and acount, as ``gen_classify`` does on one device."""
    if st.tasks.device.type == "cpu":
        return _merge_classified_plain(g, st, level, stage_t, stage_a, owner,
                                       last=last)
    lo, w = st.span(level)
    n = stage_t.shape[0]
    dev = st.tasks.device
    kernels.require(stage_t, torch.int32, "stage_t",
                    shape=(n, len(alg.TASK_COLS), w), device=dev)
    kernels.require(stage_a, torch.int32, "stage_a",
                    shape=(n, len(alg.AUX_COLS), w), device=dev)
    kernels.require(owner, torch.int32, "owner", shape=(w,), device=dev)
    p_kind = kernels.require(g["p_kind"], torch.int32, "p_kind", device=dev)
    _launch("shard_merge_classified", kernels.ptr(stage_t), kernels.ptr(stage_a),
            kernels.ptr(owner), w, lo, kernels.merge_state(st),
            kernels.ptr(p_kind), p_kind.shape[0], int(last))


#: the columns the classified merge takes from the owner
_CLS_TASK = ("kind", "prog", "resolved", "res", "cop", "seed")
_CLS_AUX = ("deg", "dirt", "count")


def _merge_classified_plain(g, st: alg.GenState, level: int, stage_t, stage_a,
                            owner, *, last: bool) -> None:
    lo, w = st.span(level)
    Q = st.q
    t = _owner_masked(stage_t, {c: alg.TI[c] for c in _CLS_TASK}, owner,
                      alg.BOOL_COLS)
    a = _owner_masked(stage_a, {c: alg.AI[c] for c in _CLS_AUX}, owner,
                      alg.BOOL_COLS)
    P = g["p_kind"].shape[0]
    pp = t["prog"].clamp(0, P - 1)
    qid = st.tasks[alg.TI["qid"], lo:lo + w]
    qc = qid.clamp(0, Q - 1)
    st.q_dirty.copy_(fp._scatter_or(st.q_dirty, qc, a["dirt"]))
    resolved, res = t["resolved"], t["res"]
    if last:
        capped = (qid >= 0) & ~resolved & (a["count"] > 0)
        st.q_over.copy_(fp._scatter_or(st.q_over, qc, capped))
        resolved = resolved | capped
        res = torch.where(capped, alg.R_UNKNOWN, res)
    st.put_tasks(level, dict(t, resolved=resolved, res=res))
    st.put_aux(level, dict(
        a, pp=pp, pk=g["p_kind"][pp.to(torch.int64)],
        acount=torch.where(resolved | (qid < 0), 0, a["count"]),
    ))


def merge_child(st: alg.GenState, level: int, stage: Tensor,
                owner_par: Tensor) -> None:
    """The owner merge of one constructed level (the JAX ``_merge_child``)
    into this shard's state: each child's twelve columns from its
    parent's owner's partial (``stage``: every shard's construction of the
    level, ``owner_par``: the parent level's owners; an empty row takes
    slot 0's owner's fills)."""
    if st.tasks.device.type == "cpu":
        return _merge_child_plain(st, level, stage, owner_par)
    lo, w = st.span(level)
    n = stage.shape[0]
    dev = st.tasks.device
    kernels.require(stage, torch.int32, "stage", shape=(n, len(CHILD_COLS), w),
                    device=dev)
    kernels.require(owner_par, torch.int32, "owner_par", device=dev)
    _launch("shard_merge_child", kernels.ptr(stage), kernels.ptr(owner_par),
            owner_par.shape[0], w, lo, kernels.merge_state(st))


def _merge_child_plain(st: alg.GenState, level: int, stage, owner_par) -> None:
    lo, w = st.span(level)
    parent = st.tasks[alg.TI["parent"], lo:lo + w]
    o = owner_par[parent.clamp(0, owner_par.shape[0] - 1).to(torch.int64)]
    st.put_tasks(level, _owner_masked(
        stage, {c: alg.TI[c] for c in CHILD_COLS}, o, alg.BOOL_COLS))


class MeshOps(NamedTuple):
    """The sharded programs' steps: the K10 kernels and the K7 program's
    (``gen``, whose ``fast`` are the tier-1 steps)."""

    owner: object
    route: object
    merge: object
    merge_classified: object
    merge_child: object
    gen: alg._GenOps


_OPS = MeshOps(shard_owner, shard_route, merge_bits, merge_classified,
               merge_child, alg._OPS)
_PLAIN_OPS = MeshOps(_shard_owner_plain, _shard_route_plain, _merge_bits_plain,
                     _merge_classified_plain, _merge_child_plain, alg._PLAIN_OPS)


# -- the sharded level loop --------------------------------------------------------


def _sharded_levels(ops: MeshOps, tables, devs, fronts, qf, qo, qd, qsubj,
                    sched, *, max_width: int, probe_last: bool, occ=None):
    """Every level of a BFS over the sharded graph from each shard's level-0
    frontier ``fronts[s]``: per shard the level's probes, its arena and
    children (``sched[i] = (frontier, arena)``), the route at ``cap =
    max(arena // n, 8)``; the exchange; per shard the merged found bits
    and the pack of the ``n * cap`` rows it received into the next
    frontier (``sched[i + 1][0]``; the last level's, its own).  With
    ``probe_last`` the last level runs probes only (the leaf sub-run);
    otherwise every level expands (``_sharded_fast_run``).  ``occ[s][i +
    1]`` receives shard s's live items entering level i + 1.  Returns the
    per-shard (found, over, dirty) lists, found merged after the last
    expanding level, not after a probe-only one."""
    n = len(devs)
    ns_dim, rel_dim = tables[0]["f_direct_ok"].shape
    nsb, relb = fp._pack_bits(ns_dim), fp._pack_bits(rel_dim)
    fops = ops.gen.fast
    pack = fp._pack_op(fops, qf[0].shape[0], nsb, relb)
    levels = len(sched)
    for i, (_fl, a) in enumerate(sched):
        probe_only = probe_last and i == levels - 1
        lvs = []
        for s, dev in enumerate(devs):
            with _on(dev):
                qf[s], qd[s], lv = fops.probe_level(tables[s], fronts[s], qf[s],
                                                    qd[s], qsubj[s],
                                                    probe_only=probe_only)
                lvs.append(lv)
        if probe_only:
            break
        cap = max(a // n, 8)
        sends = []
        for s, dev in enumerate(devs):
            with _on(dev):
                offsets, _total, parent, ordinal = fops.arena_assign(lvs[s].counts, a)
                ch, qo[s] = fops.expand_children(
                    tables[s], fronts[s], lvs[s], offsets, parent, ordinal, qf[s],
                    qo[s], max_width=max_width,
                )
                send, qo[s] = ops.route(ch, qo[s], n_shards=n, cap=cap)
                sends.append(send)
        recvs = exchange(sends, devs, cap)
        # merge found bits across shards before packing so arrived
        # children of already-found queries die at once
        merged = []
        for d, dev in enumerate(devs):
            with _on(dev):
                merged.append(ops.merge(gather(qf, dev)))
        nxt = sched[i + 1][0] if i + 1 < levels else sched[i][0]
        for d, dev in enumerate(devs):
            with _on(dev):
                fronts[d], qo[d] = pack(
                    recvs[d], merged[d], qo[d], frontier=nxt, nsb=nsb, relb=relb,
                    occ_out=None if occ is None else occ[d][i + 1:i + 2],
                )
        qf = merged
    return qf, qo, qd


def _merge_final(ops: MeshOps, qf, qo, qd, dev) -> Tensor:
    """found / over / dirty merged over every shard onto ``dev``:
    int32[3, Q]."""
    with _on(dev):
        return ops.merge(gather([[f, o, d] for f, o, d in zip(qf, qo, qd)], dev))


class ShardedResult(NamedTuple):
    """The merged verdict bits of a sharded fast run (bool[Q] each)."""

    found: np.ndarray
    over: np.ndarray
    dirty: np.ndarray

    @classmethod
    def of(cls, codes: Tensor) -> "ShardedResult":
        c = codes.cpu().numpy()
        return cls((c & 1) != 0, ((c >> 1) & 1) != 0, ((c >> 2) & 1) != 0)


def _sharded_fast(ops: MeshOps, tables, queries, mesh: Mesh, *, frontier: int,
                  arena: int, max_depth: int, max_width: int, active=None,
                  assign=None) -> Tensor:
    """The JAX ``_sharded_fast_run``: roots live on their assigned shard,
    ``max_depth`` expanding levels at a fixed ``frontier`` / ``arena``, the
    final merges.  Returns the verdict bytes (bit 0 found, 1 over, 2
    dirty; uint8[Q]) on the first shard's device."""
    devs = mesh.devices
    n = mesh.size
    q_ns, q_obj, q_rel, q_subj, q_depth = (np.asarray(a, np.int32) for a in queries)
    Q = q_ns.shape[0]
    act = np.ones(Q, bool) if active is None else np.asarray(active, bool)
    if assign is None:
        assign = shard_of_np(np.clip(q_ns.astype(np.int64), 0, None),
                             np.clip(q_obj.astype(np.int64), 0, None), n)
    block = np.stack([q_ns, q_obj, q_rel, q_subj, q_depth, act.astype(np.int32),
                      np.asarray(assign, np.int32)]).astype(np.int32)
    fops = ops.gen.fast
    fronts, qf, qo, qd, qsubj = [], [], [], [], []
    for s, dev in enumerate(devs):
        with _on(dev):
            qp = torch.from_numpy(block).to(dev)
            occ = torch.zeros(1, dtype=torch.int32, device=dev)
            f, found, over, subj = fops.init_state(
                qp[:5], frontier=frontier, levels=fp.NO_CLAMP, occ_out=occ,
                act=qp[5], assign=qp[6], me=s,
            )
        fronts.append(f)
        qf.append(found)
        qo.append(over)
        qd.append(torch.zeros_like(over))
        qsubj.append(subj)
    sched = ((frontier, arena),) * max_depth
    qf, qo, qd = _sharded_levels(ops, tables, devs, fronts, qf, qo, qd, qsubj,
                                 sched, max_width=max_width, probe_last=False)
    m = _merge_final(ops, qf, qo, qd, devs[0])
    out = torch.empty(Q, dtype=torch.uint8, device=devs[0])
    with _on(devs[0]):
        fops.pack_verdicts(m[0], m[1], m[2], out=out)
    return out


def sharded_check(tables, queries, mesh: Mesh, *, frontier: int = 2048,
                  arena: int = 8192, max_depth: int = 5, max_width: int = 100,
                  active=None, assign=None) -> ShardedResult:
    """Check a replicated query batch against the sharded graph
    (``tables[s]``: shard s's tables on ``mesh.devices[s]``; ``queries``:
    the (ns, obj, rel, subj, depth) id columns).  Each root activates only
    on the shard its ``assign`` slot names (the hash owner when None);
    found bits merge every level.  On CUDA tables every step launches its
    kernel."""
    return ShardedResult.of(_sharded_fast(
        _OPS, tables, queries, mesh, frontier=frontier, arena=arena,
        max_depth=max_depth, max_width=max_width, active=active, assign=assign))


# -- the sharded general (AND/NOT) tier ----------------------------------------------


def _merge_classified_level(ops: MeshOps, tables, sts, devs, level: int, *,
                            last: bool) -> List[Tensor]:
    """Owner columns of one classified level, then every shard's merge of
    it (all gathers first: a merge writes the state the others read).
    Returns the owner column on each shard's device."""
    n = len(devs)
    lo, w = sts[0].span(level)
    owners, stages = [], []
    for s, dev in enumerate(devs):
        with _on(dev):
            t = sts[s].tasks
            owners.append(ops.owner(t[alg.TI["ns"], lo:lo + w],
                                    t[alg.TI["obj"], lo:lo + w], n))
    for dev in devs:
        with _on(dev):
            stages.append((gather([st.tasks[:, lo:lo + w] for st in sts], dev),
                           gather([st.aux[:, lo:lo + w] for st in sts], dev)))
    for d, dev in enumerate(devs):
        with _on(dev):
            ops.merge_classified(tables[d], sts[d], level, *stages[d], owners[d],
                                 last=last)
    return owners


def _merge_child_level(ops: MeshOps, sts, devs, level: int, owners_par) -> None:
    lo, w = sts[0].span(level)
    k = len(CHILD_COLS)
    stages = []
    for dev in devs:
        with _on(dev):
            stages.append(gather([st.tasks[:k, lo:lo + w] for st in sts], dev))
    for d, dev in enumerate(devs):
        with _on(dev):
            ops.merge_child(sts[d], level, stages[d], owners_par[d])


def _sharded_general(ops: MeshOps, tables, qpack, mesh: Mesh, *, sizes,
                     fast_b: int, fast_sched, max_width: int,
                     vcap: int) -> List[alg.GenState]:
    """The K7 program over the sharded graph (the JAX ``_general_body`` with
    ``shard=``): every shard holds the whole skeleton; each classified
    level and each constructed level is owner-merged on every shard; the
    leaves run the sharded sub-run (owner-activated, routed, found bits
    merged per level); the up pass and the codes on the first shard, with
    the over / dirty bits of every shard merged in.  Returns every
    shard's state: codes in the first's, each its own occupancy row."""
    devs = mesh.devices
    n = mesh.size
    gops = ops.gen
    qp_np = np.ascontiguousarray(
        qpack.cpu().numpy() if isinstance(qpack, Tensor) else qpack, np.int32)
    q = qp_np.shape[1]
    depth = len(sizes)
    qps, sts = [], []
    for dev in devs:
        qps.append(torch.from_numpy(qp_np).to(dev))
        sts.append(alg.GenState.new(q, tuple(sizes), fast_b, len(fast_sched),
                                    vcap, dev))
    for s, dev in enumerate(devs):
        with _on(dev):
            gops.classify(tables[s], sts[s], 0, qps[s][3], qpack=qps[s],
                          act=qps[s][5], shard=True)
    owners = _merge_classified_level(ops, tables, sts, devs, 0, last=depth == 0)
    for L, a in enumerate(sizes):
        for s, dev in enumerate(devs):
            with _on(dev):
                offsets, _total, parent, ordinal = gops.arena_assign(
                    sts[s].acount(L), a)
                gops.construct(tables[s], sts[s], L, offsets, parent, ordinal,
                               max_width=max_width, owner=owners[s], me=s)
                gops.visited(sts[s], L + 1)
        _merge_child_level(ops, sts, devs, L + 1, owners)
        for s, dev in enumerate(devs):
            with _on(dev):
                gops.classify(tables[s], sts[s], L + 1, qps[s][3], shard=True)
        owners = _merge_classified_level(ops, tables, sts, devs, L + 1,
                                         last=L + 1 == depth)
    fronts, qf, qo, qd, subj, occ = [], [], [], [], [], []
    for s, dev in enumerate(devs):
        with _on(dev):
            gops.collect(sts[s], qps[s][3], n_shards=n, me=s)
            b = sts[s].leaves.qid.shape[0]
            fronts.append(sts[s].leaves)
            qf.append(torch.zeros(b, dtype=torch.int32, device=dev))
            qo.append(torch.zeros(b, dtype=torch.int32, device=dev))
            qd.append(torch.zeros(b, dtype=torch.int32, device=dev))
            subj.append(sts[s].leaf_subj)
            occ.append(sts[s].occ()[depth + 2:])
    qf, qo, qd = _sharded_levels(ops, tables, devs, fronts, qf, qo, qd, subj,
                                 fast_sched, max_width=max_width,
                                 probe_last=True, occ=occ)
    m = _merge_final(ops, qf, qo, qd, devs[0])
    st0 = sts[0]
    with _on(devs[0]):
        for L in range(depth, -1, -1):
            gops.up(st0, L, m[0], m[1], m[2])
        # visited-set overflow and the other owner-local over / dirty bits
        # become global
        bits = ops.merge(gather([[st.q_over, st.q_dirty] for st in sts], devs[0]))
        st0.q_over.copy_(bits[0])
        st0.q_dirty.copy_(bits[1])
        gops.pack(st0)
    return sts


def fetch_general(sts: List[alg.GenState]) -> Tuple[np.ndarray, np.ndarray]:
    """(codes uint8[Q], occ int32[n, L]) of a sharded general run: the
    codes from the first shard, one occupancy row per shard (skeleton
    counts and the leaf count replicated, the sub-run's per level the
    shard's own)."""
    codes, occ0 = sts[0].packed().fetch()
    rows = [occ0] + [st.packed().fetch()[1] for st in sts[1:]]
    return codes, np.stack(rows)


def sharded_general_check(tables, qpack, mesh: Mesh, *, sizes, fast_b: int,
                          fast_sched, max_width: int = 100, vcap: int = 4096):
    """General (AND/NOT) checks against the sharded graph (no replica):
    ``qpack`` int32[6, Q] replicated, ``sizes`` / ``fast_sched`` global
    shapes.  Returns (codes uint8[Q], occ int32[n, L]) as JAX does."""
    return fetch_general(_sharded_general(
        _OPS, tables, qpack, mesh, sizes=tuple(sizes), fast_b=int(fast_b),
        fast_sched=tuple(fast_sched), max_width=max_width, vcap=vcap))
