"""MeshCheckEngine: the serving engine over a graph-sharded mesh.

The port of the JAX package's ``parallel/meshengine.py`` serving core
(BASELINE config #5, ``engine.mesh_devices: n``).  The CSR is partitioned
by (namespace, object) hash over an n-shard :class:`~.mesh.Mesh`
(``parallel/graphshard.py``): each BFS level expands on every shard,
routes cross-shard children to their owner, and merges the found bits,
so each shard's card holds only its slice of the graph.  It inherits the
single-device engine's host surface (encode, classify, the oracle, the
write path's drain) and swaps the device dispatch:

* **writes ride per-shard delta overlays**: a change goes to its owner
  shard's overlay, against that shard's snapshot (node ids are
  shard-local); empty overlays ship with the first build so a shard's
  tables keep their names and shapes as writes land.  The replicated
  overlay is kept too: Expand reads it.  What the overlays cannot take
  re-partitions (no fold: ``supports_fold`` is false);
* **both tiers on the sharded graph**, each retried once at
  ``retry_scale``x before the oracle: pure-OR rows through
  ``graphshard.sharded_check``, AND/NOT rows through
  ``graphshard.sharded_general_check`` (no replicated graph);
* **tier 0 on the host**: its rows are answered by the closure index's
  host search, as JAX answers them (no K6 launch); the index's pairs are
  counted per owner shard for the stats (JAX also keeps the per-shard
  slices of the pair array, which nothing reads);
* **Expand through a bounded replica** on the first mesh device
  (``replica_budget_mb``), built at the first Expand; past the budget
  Expand goes to the oracle.

One process drives every shard; ``devices`` picks them (default the
first ``mesh_devices`` CUDA cards; an explicit list may repeat a device,
``["cpu"] * 4`` in the tests).  With fewer devices than shards it raises,
as JAX does.  Not ported, and refused when passed: the hot-key
replication controller and rebalancer, failover, the host link and peer
routing; the result cache and the flight recorder are not in the port.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ketotpu_torch.engine import delta as dl
from ketotpu_torch.engine.device import (
    DeviceCheckEngine,
    _bucket,
    upload,
)
from ketotpu_torch.engine.optable import R_ERR, R_IS
from ketotpu_torch.parallel import graphshard
from ketotpu_torch.parallel.mesh import make_mesh

#: one sharded program at a time in the process: its steps enqueue on
#: every shard's stream in turn, and two engines may share the cards
_MESH_RUN_LOCK = threading.Lock()

#: the JAX constructor's options of what this port leaves out
_NOT_PORTED = ("replicate_hot", "hot_min", "replica_max_keys",
               "rebalance_skew", "rebalance_interval_ms", "failover",
               "hostlink")


class MeshCheckEngine(DeviceCheckEngine):
    """Graph-sharded batched checks; oracle fallback on the host."""

    supports_fold = False
    supports_background_compaction = False

    def __init__(
        self,
        store,
        namespace_manager=None,
        *,
        mesh_devices: int,
        mesh_axis: str = "shard",
        replica_budget_mb: int = 8192,
        devices=None,
        **kwargs,
    ):
        refused = [k for k in _NOT_PORTED if k in kwargs]
        if refused:
            raise ValueError(
                f"MeshCheckEngine: {', '.join(refused)} not ported (the hot-key "
                "replication controller, failover and the host link)"
            )
        if "device" in kwargs:
            raise TypeError("MeshCheckEngine takes devices=[...], one per shard")
        self.mesh = make_mesh(mesh_devices, axis=mesh_axis, devices=devices)
        if self.mesh.size != mesh_devices:
            # serving with fewer devices than shards would drop the missing
            # shards' tuples as silent denials
            raise ValueError(
                f"engine.mesh_devices={mesh_devices} but only "
                f"{self.mesh.size} devices are available"
            )
        self.mesh_axis = mesh_axis
        self.n_shards = mesh_devices
        # the replicated state (host snapshot, Expand's replica) lives with
        # the first shard
        super().__init__(store, namespace_manager, device=self.mesh.devices[0],
                         **kwargs)
        self.fused_dispatch = False  # the sharded cascade has no fused wave
        self._stacked: Optional[List] = None  # per-shard tables on their devices
        self._stacked_base = None  # host: stacked base arrays
        self._stacked_np = None  # host: base + overlay stacks (the signature)
        self._shard_base_dev: Optional[List] = None
        self._shard_snaps: Optional[List] = None
        self._shard_overlays: Optional[List[dl.OverlayState]] = None
        self.replica_budget_bytes = int(replica_budget_mb) << 20
        self.shard_pair_cap = max(self.max_overlay_pairs // mesh_devices, 256)
        self._shard_fallbacks = np.zeros(mesh_devices, np.int64)
        self._shard_gen_occ = np.zeros(mesh_devices)
        self._shard_batches = np.zeros(mesh_devices, np.int64)
        self._leo_shard_pairs = np.zeros(mesh_devices, np.int64)
        # (ns_id, obj_id) -> extra shards holding a copy of the key's rows:
        # filled by the replication controller, which is not ported
        self._replica_map: dict = {}
        self._mesh_run_lock = _MESH_RUN_LOCK
        self.shard_build_s = 0.0  # the last sharded stacks' host build
        self.shard_upload_s = 0.0  # and their upload, synchronized

    # -- projection -------------------------------------------------------------

    def _sync_device(self) -> None:
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _ship_leopard(self, idx):
        # tier 0 answers on the host (the index's search), as in JAX
        return None

    def _install_leopard(self) -> None:
        """Build the closure index, then count its element pairs per shard
        by the owner set's (ns, obj) hash (the CSR's partition)."""
        super()._install_leopard()
        self._leo_shard_pairs = np.zeros(self.n_shards, np.int64)
        if self._leo is None or len(self._leo.index.elt_set) == 0:
            return
        idx = self._leo.index
        key = idx.nodes[idx.elt_set.astype(np.int64)]
        ns = ((key >> 32) // idx.R).astype(np.int64)
        obj = key & 0xFFFFFFFF
        shards = graphshard.shard_of_np(ns, obj, self.n_shards)
        self._leo_shard_pairs = np.bincount(
            shards, minlength=self.n_shards).astype(np.int64)

    def _install_device_arrays(self) -> None:
        """Ship the sharded tables (base + empty overlays), each shard's
        slice on its device; the replicated copy only Expand reads is built
        at the first Expand."""
        self._base_device = None
        self._device_arrays = None
        self._expand_extra = None
        t0 = time.perf_counter()
        self._shard_snaps, self._stacked_base = graphshard.build_sharded_snapshot(
            self.store, self.namespace_manager, self.n_shards, self._vocab,
            cols=self._cols, replicate=self._replica_map,
        )
        # overlay admission checks relation-level pairs against dyn_pairs;
        # a shard's slice sees only some of the graph's pairs, so it gets
        # the global set (taint is classified on the replicated snapshot)
        for sn in self._shard_snaps:
            sn.dyn_pairs = self._snap.dyn_pairs
        self._shard_overlays = [dl.OverlayState() for _ in range(self.n_shards)]
        t1 = time.perf_counter()
        self._shard_base_dev = graphshard.upload_shards(self._stacked_base,
                                                        self.mesh)
        self._install_overlays(self._overlay_stacks())
        self._sync_device()
        self.shard_build_s = t1 - t0
        self.shard_upload_s = time.perf_counter() - t1

    def _install_overlays(self, stacks) -> None:
        """Publish each shard's tables: its base with its overlay slice
        over it (fresh tensors, so a batch already enqueued keeps the old
        ones)."""
        self._stacked_np = dict(self._stacked_base, **stacks)
        ov = graphshard.upload_shards(stacks, self.mesh, skip=())
        out = []
        for base, o in zip(self._shard_base_dev, ov):
            t = type(base)(base)
            t.update(o)
            out.append(t)
        self._stacked = out

    def _swap_shape_signature(self):
        return self._array_shapes(self._stacked_np)

    def _overlay_stacks(self):
        """Per-shard overlay arrays padded to common shapes and stacked:
        ``om_`` / ``ovt_`` tables by ``shard_pair_cap``, ``ov_dirty`` to the
        largest shard's length bucketed by 64."""
        ovs = [
            dl.overlay_arrays(o, sn, pair_cap=self.shard_pair_cap)
            for o, sn in zip(self._shard_overlays, self._shard_snaps)
        ]
        out = {}
        for k in ovs[0]:
            arrs = [np.asarray(ov[k]) for ov in ovs]
            if arrs[0].ndim == 0:
                out[k] = np.stack(arrs)
                continue
            m = max(a.shape[0] for a in arrs)
            m = _bucket(m, 64) if k == "ov_dirty" else m
            arrs = [
                np.pad(a, [(0, m - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
                for a in arrs
            ]
            out[k] = np.stack(arrs)
        return out

    def _overlay_apply(self, changes) -> bool:
        """Route each change to its owner shard's overlay (the partition's
        hash) and re-ship only the overlay slices; the replicated overlay
        (Expand's) takes every change too.  False re-partitions."""
        if self._shard_snaps is None:
            return False
        w = self.last_write
        t0 = time.perf_counter()
        try:
            dl.apply_changes(self._overlay, self._snap, self._vocab, changes)
            for op_, t in changes:
                ns = self._vocab.namespaces.lookup(t.namespace)
                obj = self._vocab.objects.lookup(t.object)
                if ns < 0 or obj < 0:
                    return False  # ids not even interned: rebuild
                s = int(graphshard.shard_of_np(
                    np.array([ns]), np.array([obj]), self.n_shards)[0])
                targets = {s, *self._replica_map.get((int(ns), int(obj)), ())}
                for tgt in targets:
                    dl.apply_changes(self._shard_overlays[tgt],
                                     self._shard_snaps[tgt], self._vocab,
                                     [(op_, t)])
        except dl.OverlayRejected:
            return False
        pairs = sum(o.size()[0] for o in self._shard_overlays)
        dirty = sum(o.size()[1] for o in self._shard_overlays)
        if pairs > self.max_overlay_pairs or dirty > self.max_overlay_dirty:
            return False
        if any(o.size()[0] > self.shard_pair_cap for o in self._shard_overlays):
            return False  # one shard's fixed-shape table would overflow
        try:
            stacks = self._overlay_stacks()
            replica_ov = None
            if self._base_device is not None:
                replica_ov = dl.overlay_arrays(
                    self._overlay, self._snap,
                    pair_cap=max(self.max_overlay_pairs, 1))
        except ValueError:
            return False
        t1 = time.perf_counter()
        self._install_overlays(stacks)
        if replica_ov is not None:
            self._set_overlay_tables(upload(replica_ov, self.device))
        w["build_s"] = t1 - t0
        w["upload_s"] = time.perf_counter() - t1
        return True

    # -- Expand: the bounded replica ------------------------------------------------

    def _expand_arrays(self):
        """The replicated check tables (with the replicated overlay) on the
        first mesh device, built at the first Expand after a projection,
        plus the expand-only tables; None past ``replica_budget_mb`` (the
        base engine's Expand then asks the oracle for every root)."""
        if self._device_arrays is None:
            if sum(v.nbytes for v in self._snap.check_arrays().values()) \
                    > self.replica_budget_bytes:
                return None
            self._base_device = upload(self._snap.check_arrays(), self.device)
            self._set_overlay_tables(upload(
                dl.overlay_arrays(self._overlay, self._snap,
                                  pair_cap=max(self.max_overlay_pairs, 1)),
                self.device,
            ))
        return super()._expand_arrays()

    # -- dispatch ---------------------------------------------------------------------

    def _route_assign(self, ns_ids, obj_ids):
        """(assign, owner): the shard each root activates on and its hash
        owner (what child routing and fallback attribution use).  The
        replica map, and with it any other assignment, stays empty here."""
        owner = graphshard.shard_of_np(
            np.clip(np.asarray(ns_ids, np.int64), 0, None),
            np.clip(np.asarray(obj_ids, np.int64), 0, None), self.n_shards)
        return owner.copy(), owner

    def _sharded_run(self, stacked, padded, active, boost: int = 1,
                     assign=None) -> graphshard.ShardedResult:
        frontier, arena = boost * self.frontier, boost * self.arena
        self.dispatch_shapes[(len(padded[0]), frontier, arena, boost)] += 1
        with self._mesh_run_lock:
            return graphshard.sharded_check(
                stacked, padded, self.mesh, frontier=frontier, arena=arena,
                max_depth=self.max_depth, max_width=self.max_width,
                active=active, assign=assign,
            )

    def _run_general_mesh(self, stacked, enc, gi: np.ndarray, boost: int = 1):
        """One general dispatch over the sharded tables for rows ``gi``
        (global shapes: the whole batch's skeleton is on every shard).
        Returns (codes uint8[len(gi)], occ rows int32[n, L])."""
        qpack, sched = self.pack_general(enc, gi, boost)
        sizes, fast_b, fast_sched, vcap = sched
        self.general_shapes[(qpack.shape[1], boost, sched)] += 1
        with self._mesh_run_lock:
            codes, occ = graphshard.sharded_general_check(
                stacked, qpack, self.mesh, sizes=sizes, fast_b=fast_b,
                fast_sched=fast_sched, max_width=self.max_width, vcap=vcap,
            )
        return codes[: len(gi)], occ

    def _dispatch(self, queries, rest_depth: int):
        """Encode, classify and tier 0 one chunk, then run both sharded
        tiers (each fetched before it returns)."""
        n = len(queries)
        if n == 0:
            return None
        t0 = time.perf_counter()
        with self._view_lock:
            self._snapshot_locked()
            snap, stacked, leo_state = self._snap, self._stacked, self._leo
        enc = self._encode(snap, queries, rest_depth)
        err, general = self._classify(snap, enc[0], enc[2])
        leo_res = self._leopard_answers(enc, err, general, leo_state)
        act = ~(err | general)
        if leo_res is not None:
            act &= ~leo_res[1]
        assign, owner = self._route_assign(enc[0], enc[1])
        with self._mesh_run_lock:
            np.add.at(self._shard_batches, assign[act], 1)
            if general.any():
                np.add.at(self._shard_batches, owner[general], 1)
        t1 = self._phase("encode", t0)
        res = None
        if act.any():
            qpad = min(_bucket(n), self.frontier)
            res = self._sharded_run(
                stacked, self._pad(enc, n, qpad), np.pad(act, (0, qpad - n)),
                assign=np.pad(assign, (0, qpad - n)),
            )
        t1 = self._phase("mesh_fast", t1)
        gres = gi = None
        if general.any():
            gi = np.flatnonzero(general)
            gres = self._run_general_mesh(stacked, enc, gi)
            self._phase("mesh_general", t1)
        return enc, err, general, res, gi, gres, stacked, assign, leo_res

    def _collect(self, handle):
        """Decode both tiers, retry each one's overflow tail once at
        ``retry_scale``x, attribute every oracle fallback to its owner
        shard.  Returns (allowed, fallback)."""
        enc, err, general, res, gi, gres, stacked, assign, leo_res = handle
        n = err.shape[0]
        allowed = np.zeros(n, bool)
        fallback = err.copy()
        if gres is not None:
            t0 = time.perf_counter()
            packed, rows = gres
            # occ rows: skeleton counts and the leaf count are replicated
            # (take row 0); the sub-run's counts are per-shard partials
            split = self.gen_levels + 2
            self._shard_gen_occ = rows[:, split:].sum(axis=1).astype(float)
            self._update_gen_occ(np.concatenate(
                [rows[0, :split], rows[:, split:].sum(axis=0)]))
            codes = (packed & 3).astype(np.int8)
            gover = ((packed >> 2) & 1).astype(bool)
            # dirty: some shard's overlay marked a row the program needed;
            # the oracle answers (a device retry reads the same base)
            gdirty = ((packed >> 3) & 1).astype(bool)
            allowed[gi] = codes == R_IS
            gunres = gover & ~gdirty & (codes != R_ERR)
            if gunres.any() and self.retry_scale > 1:
                ri = gi[np.flatnonzero(gunres)]
                self.retries += len(ri)
                self.general_retries += len(ri)
                rpacked, _ = self._run_general_mesh(stacked, enc, ri,
                                                    boost=self.retry_scale)
                rcodes = (rpacked & 3).astype(np.int8)
                rover = ((rpacked >> 2) & 1).astype(bool)
                rdirty = ((rpacked >> 3) & 1).astype(bool)
                allowed[ri] = rcodes == R_IS
                gover[gunres] = rover | rdirty | (rcodes == R_ERR)
                codes = codes.copy()
                codes[np.flatnonzero(gunres)] = rcodes
            fallback[gi] |= gover | gdirty | (codes == R_ERR)
            self.general_rows += len(gi)
            self._phase("mesh_general_collect", t0)
        if res is not None:
            found, over, dirty = res.found[:n], res.over[:n], res.dirty[:n]
        else:
            found = over = dirty = np.zeros(n, bool)
        fmask = ~(err | general)
        allowed[fmask] = found[fmask]
        # found is monotone and overlay-exact: dirty and over rows void only
        # not-yet-found queries
        fallback |= fmask & dirty & ~found
        unres = fmask & over & ~found & ~dirty
        if unres.any() and self.retry_scale > 1:
            t0 = time.perf_counter()
            ri = np.flatnonzero(unres)
            rpad = min(_bucket(len(ri), 256), self.frontier)
            self.retries += len(ri)
            rres = self._sharded_run(
                stacked, self._pad(tuple(a[ri] for a in enc), len(ri), rpad),
                np.pad(np.ones(len(ri), bool), (0, rpad - len(ri))),
                boost=self.retry_scale,
                assign=np.pad(assign[ri], (0, rpad - len(ri))),
            )
            rfound = rres.found[: len(ri)]
            allowed[ri] = rfound
            unres[ri] = (rres.over[: len(ri)] | rres.dirty[: len(ri)]) & ~rfound
            self._phase("mesh_retry", t0)
        fallback |= unres
        if leo_res is not None:
            # closure verdicts; their rows were inactive on the mesh
            ans = leo_res[1]
            allowed[ans] = leo_res[0][ans]
            fallback &= ~ans
        fb = np.flatnonzero(fallback)
        if len(fb):
            # attribution only (err rows may carry -1 ids: clipped)
            np.add.at(self._shard_fallbacks, graphshard.shard_of_np(
                np.clip(enc[0][fb], 0, None), np.clip(enc[1][fb], 0, None),
                self.n_shards), 1)
        return allowed, fallback

    # -- stats --------------------------------------------------------------------------

    def shard_route_counts(self) -> np.ndarray:
        """Cumulative roots routed per shard."""
        return self._shard_batches.copy()

    def shard_stats(self) -> List[dict]:
        """Per shard: its device, routed roots, oracle fallbacks by owner,
        overlay pressure, graph nodes, the last general dispatch's sub-run
        occupancy, closure pairs, and its tables' bytes on its device."""
        ovs = self._shard_overlays or []
        snaps = self._shard_snaps or []
        out = []
        for i in range(self.n_shards):
            pairs, dirty = ovs[i].size() if i < len(ovs) else (0, 0)
            tables = self._stacked[i] if self._stacked else {}
            out.append({
                "shard": i,
                "device": str(self.mesh.devices[i]),
                "batches": int(self._shard_batches[i]),
                "fallbacks": int(self._shard_fallbacks[i]),
                "overlay_pairs": int(pairs),
                "overlay_dirty": int(dirty),
                "nodes": int(getattr(snaps[i], "n_nodes", 0)) if i < len(snaps) else 0,
                "gen_occupancy": float(self._shard_gen_occ[i]),
                "leopard_pairs": int(self._leo_shard_pairs[i]),
                "device_bytes": int(sum(t.numel() * t.element_size()
                                        for t in tables.values())),
            })
        return out

    def mesh_stats(self) -> dict:
        """The routed-root skew (max / mean over shards)."""
        b = self._shard_batches.astype(float)
        mean = float(b.mean())
        return {"skew": round(float(b.max() / mean) if mean > 0 else 1.0, 3)}
