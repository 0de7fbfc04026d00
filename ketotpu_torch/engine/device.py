"""The CUDA check engine: host wrapper around the tier-0, -1 and -2 kernels.

The port of the JAX package's ``engine/tpu.py`` ``DeviceCheckEngine``:
callers hand it relation tuples, it answers allow/deny.  It

1. projects the store into a snapshot (``delta.build_snapshot_cols``),
   uploads ``Snapshot.check_arrays()`` with an empty delta overlay, and
   with Leopard on (the default) builds the closure index
   (``leopard.closure``) and ships its pair columns.  Writes reach the card
   as the JAX engine's synchronous write path takes them, drained from the
   store's change log at the next batch: the O(delta) overlay
   (``delta.apply_changes`` / ``overlay_arrays``, re-shipped as fresh
   tensors), else an incremental fold of the changes since the base
   (``delta.fold_snapshot_cols``, same device shapes), else a full
   re-projection; the closure index folds the same changes
   (``ClosureIndex.apply_changes``) or rebuilds where JAX rebuilds.  A row
   whose exploration needed a row the overlay marked dirty comes back with
   its dirty bit and the oracle answers it (the background compactor of
   the JAX engine is not ported);
2. interns query strings to dense ids (unknown strings miss everywhere,
   which reproduces "unknown namespace => not allowed");
3. classifies each query: Leopard-eligible rows are answered by the
   closure index (tier 0); pure-OR queries run the tier-1 BFS on the card
   (``fastpath``); queries that can reach AND / NOT (general rows) run the
   tier-2 algebra program on the card (``algebra``); queries whose lookup
   is a client error go to the oracle, which raises the reference's typed
   error;
4. retries each tier's overflow tail once on the card at ``retry_scale``x
   caps (a general retry also gets ``gen_levels_max`` levels), then
   answers what is still over, or ERR, on the exact host oracle.

Two dispatch forms, as in JAX: the unfused cascade (tier 0 as one K6
launch per chunk, whatever its size, fetched; then one tier-1 and one
tier-2 dispatch, each fetched, each retried from the host), and with ``fused_dispatch`` the fused wave (``engine/fused.py``):
the whole cascade and its retry lanes enqueued as one wave per chunk with
one device-to-host copy.  The hot-spot result cache of the JAX engine is
not ported.

Expand (:meth:`DeviceCheckEngine.batch_expand`) walks every root's
membership on the card (K9, ``engine/expand_device.py``) over the check
tables plus the expand-only tables, uploaded at the first Expand, and
replays the reference's DFS on the host, with the overlay's member deltas
merged there; roots whose walk overflowed go to the oracle's Expand.

A CUDA error propagates: there is no fallback from the card to the host.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.api.types import (
    RelationTuple,
    SubjectID,
    SubjectSet,
    Tree,
    TreeNodeType,
)
from ketotpu_torch.engine import algebra as alg
from ketotpu_torch.engine import delta as dl
from ketotpu_torch.engine import expand_device as xd
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine import fused as fdx
from ketotpu_torch.engine.optable import R_ERR, R_IS
from ketotpu_torch.engine.oracle import (
    DEFAULT_MAX_DEPTH,
    DEFAULT_MAX_WIDTH,
    CheckEngine,
    ExpandEngine,
)
from ketotpu_torch.engine.snapshot import EXPAND_ONLY_KEYS, Snapshot
from ketotpu_torch.engine.vocab import Vocab
from ketotpu_torch.leopard import closure as leo
from ketotpu_torch.leopard import device as leodev
from ketotpu_torch.storage.namespaces import NamespaceManager, namespaces_fingerprint

#: the write path's limits, at the JAX engine's defaults: the overlay's
#: net pairs and dirty nodes (past either a write folds or rebuilds), and
#: the changes since the base that a fold still takes (past it, folds stay
#: off until the next full build); the JAX engine's background compactor
#: is not ported
MAX_OVERLAY_PAIRS = 4096
MAX_OVERLAY_DIRTY = 512
FOLD_MAX_PAIRS = 200_000
#: the Expand walk's schedule (``expand_device.expand_schedule``), at the
#: JAX engine's: arena slots per level grow by ``EXPAND_FANOUT`` per item
#: up to ``EXPAND_CAP``
EXPAND_FANOUT = 16
EXPAND_CAP = 65536


def _bucket(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _bucket15(n: int, floor: int = 64) -> int:
    """Smallest of {2^k, 1.5 * 2^k} >= n: every buffer of the general
    program scales with it, and the half-octave step bounds the padding at
    about a third."""
    b = floor
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


#: per-level task multipliers (units of general roots) of the algebra
#: skeleton before the first occupancy report: level 1 holds the rewrite
#: roots plus root expansion edges, the program fans out over the next few
#: levels, then tainted recursion thins out
_GEN_MULT_HEAD = (3, 4, 4, 4, 3, 3, 2, 2, 2, 2)


def _gen_mults(d: int):
    return tuple(
        _GEN_MULT_HEAD[i] if i < len(_GEN_MULT_HEAD) else 1 for i in range(d)
    )

#: one general dispatch's static shapes: (sizes, fast_b, fast_sched, vcap)
GenSchedule = Tuple[Tuple[int, ...], int, Tuple[Tuple[int, int], ...], int]


class LeoState(NamedTuple):
    """The closure index: the host index, its pair columns on the device
    (None for an empty index) and the current check tables with those
    columns added (what the fused wave reads; rebuilt whenever the check
    tables are re-shipped)."""

    index: leo.ClosureIndex
    pairs: Optional[Dict[str, torch.Tensor]]
    tables: Optional[Dict[str, torch.Tensor]]


class WavePlan(NamedTuple):
    """One chunk's fused wave as the engine dispatches it: the int32[10, Q]
    block, the tables, the keyword arguments of ``fused.run_fused_wave``,
    and what the collector needs."""

    qpack: np.ndarray
    tables: Dict[str, torch.Tensor]
    kwargs: dict
    n: int
    err: np.ndarray
    general: np.ndarray
    has_leo: bool

    def shape(self):
        """The wave's dispatch shape: its Q, its static schedules and
        whether tier 0 has pair columns."""
        return (self.qpack.shape[1], *(self.kwargs[k] for k in (
            "fast_sched", "retry_sched", "retry_lanes", "gen", "gen_retry")),
            "leo_sets" in self.tables)

    @property
    def flen(self) -> int:
        fs = self.kwargs["fast_sched"]
        return 0 if fs is None else len(fs)

    @property
    def glen(self) -> int:
        gen = self.kwargs["gen"]
        return 0 if gen is None else len(gen[0]) + 2 + len(gen[2])


def upload(arrays: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Ship a ``Snapshot.check_arrays()`` dict (of either package) to
    ``device``: one tensor per array, same names, same dtypes."""
    out = kernels.DeviceTables()
    for k, v in arrays.items():
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def config_fingerprint(manager: Optional[NamespaceManager]) -> int:
    """Namespace-config identity (``namespaces_fingerprint``), read before
    every batch.  A manager that keeps its own (the tenant plane's, whose
    thousands of qualified namespaces change only with the catalog)
    answers from it."""
    if manager is None:
        return 0
    own = getattr(manager, "config_fingerprint", None)
    if own is not None:
        return own()
    return namespaces_fingerprint(manager.namespaces())


class DeviceCheckEngine:
    """Batched permission checks on the card, oracle for what the BFS
    cannot answer."""

    # the write path's second tier (the fold) and, in JAX, the background
    # compactor; the graph-sharded engine (parallel/meshengine.py) opts out
    # of both: its device state is per-shard tables with their own publish
    # discipline, so a write the overlay cannot take re-projects (the
    # background compactor itself is not ported)
    supports_fold = True
    supports_background_compaction = False

    def __init__(
        self,
        store,
        namespace_manager: Optional[NamespaceManager] = None,
        *,
        max_depth: int = DEFAULT_MAX_DEPTH,
        max_width: int = DEFAULT_MAX_WIDTH,
        strict_mode: bool = False,
        frontier: int = 8192,
        arena: int = 16384,
        max_batch: int = 8192,
        retry_scale: int = 4,
        gen_arena: int = 8192,
        vcap: int = 4096,
        gen_levels: int = 12,
        gen_levels_max: int = 24,
        occ_headroom: float = 1.15,
        leopard: Optional[dict] = None,
        fused_dispatch: bool = False,
        fused_retry_lanes: int = 1,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceCheckEngine: no CUDA device (pass device='cpu' to run "
                "the plain PyTorch versions)"
            )
        self.store = store
        self.namespace_manager = namespace_manager
        self.max_depth = max_depth
        self.max_width = max_width
        self.strict_mode = strict_mode
        self.frontier = frontier
        self.arena = arena
        self.max_batch = min(max_batch, frontier)
        self.retry_scale = retry_scale
        self.gen_arena = gen_arena  # general skeleton: per-level task cap
        self.vcap = vcap  # general visited-set capacity
        vs = alg._vs_size(retry_scale * vcap)
        if self.device.type == "cuda" and vs > kernels.VISITED_SMEM_SLOTS:
            raise ValueError(
                f"vcap {vcap}: the retry's visited set of {vs} slots exceeds "
                f"the kernel's {kernels.VISITED_SMEM_SLOTS}"
            )
        self.gen_levels = gen_levels  # skeleton levels, first pass
        self.gen_levels_max = gen_levels_max  # skeleton levels, retry
        self.oracle = CheckEngine(
            store,
            namespace_manager,
            max_depth=max_depth,
            max_width=max_width,
            strict_mode=strict_mode,
        )
        self._vocab = Vocab()
        # the HTTP server calls batch_check from many threads: one drain of
        # the change log at a time (two threads draining with the same
        # cursor would apply a write twice), and (snapshot, tables, Leopard
        # state) read as one triple
        self._view_lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self._snap_fingerprint: Optional[int] = None
        # the base tables of the current projection and the check tables
        # (the base with the overlay's tables merged over it); a write
        # replaces the overlay tensors, never writes into them, so a batch
        # already enqueued keeps the overlay it was planned with
        self._base_device: Optional[Dict[str, torch.Tensor]] = None
        self._device_arrays: Optional[Dict[str, torch.Tensor]] = None
        # the expand-only tables of the current projection, uploaded at the
        # first Expand after it (Check serving never pays for them)
        self._expand_extra: Optional[Dict[str, torch.Tensor]] = None
        self.expand_upload_s = 0.0  # the last expand-only upload, synchronized
        self.expand_upload_bytes = 0
        # the last batch_expand's walk: its schedule, padded root count and
        # roots answered by the oracle after an arena overflow
        self.last_expand: Dict[str, object] = {}
        # the store's tuples as id columns, kept current from the change log
        self._cols: Optional[dl.TupleColumns] = None
        self._log_cursor = 0
        self._overlay: Optional[dl.OverlayState] = None
        self._overlay_active = False
        self.max_overlay_pairs = MAX_OVERLAY_PAIRS
        self.max_overlay_dirty = MAX_OVERLAY_DIRTY
        # demand-adaptive level scheduling: EMA of the per-level frontier
        # occupancy (units of active roots), None until the first batch
        self._occ_ema: Optional[np.ndarray] = None
        # the general program's: skeleton tasks per level, fast leaves and
        # the sub-run's live leaves per level, all per root
        self._gen_occ_ema: Optional[np.ndarray] = None
        self._gen_fast_ema: Optional[float] = None
        self._gen_fast_occ_ema: Optional[np.ndarray] = None
        # the first demand-sized general schedule per (Q, boost), frozen
        self._gen_sched_cache: Dict[Tuple[int, int], GenSchedule] = {}
        self._gen_lock = threading.Lock()
        self.occ_headroom = occ_headroom
        self.fallbacks = 0  # queries answered by the host oracle
        self.retries = 0  # queries re-run at retry_scale x caps
        self.rebuilds = 0  # full projections + uploads
        self.overlay_applies = 0  # writes served through the overlay
        self.folds = 0  # incremental folds of the changes since the base
        self.generation = 0  # base snapshots published (rebuilds + folds)
        self.last_compaction_mode = "none"  # fold | rebuild | none
        self.last_build_phases: Dict[str, float] = {}
        # the last drain of the change log: its tier (overlay / fold /
        # rebuild), the closure index's outcome (apply / rebuild / off) and
        # host seconds per step
        self.last_write: Dict[str, object] = {}
        # device batches enqueued, per (Q, frontier, arena, boost): every
        # batch of one shape launches the same kernels at the same sizes
        self.dispatch_shapes: Counter = Counter()
        # general dispatches, per (Q, boost, schedule)
        self.general_shapes: Counter = Counter()
        self.general_rows = 0  # rows sent to the general tier
        self.general_retries = 0  # of those, rows re-run at retry caps
        self.projection_build_s = 0.0  # host snapshot build of the last one
        self.projection_upload_s = 0.0  # its upload, synchronized
        # host wall seconds per batch_check phase: encode (+ classify, and
        # the re-projection when the store moved), enqueue (the level loop's wrapper calls), fetch (the one D2H copy,
        # which waits for the device), retry (enqueue + fetch of the retry
        # dispatch), general (the general dispatch's enqueue and its fetch),
        # general_retry (enqueue + fetch of the general retry), oracle; on
        # the fused path plan (tier 0's probe modes, the wave's block and
        # schedules), wave (the wave's enqueue) and fetch; leopard_build
        # (the closure index builds)
        self.phase_seconds: Dict[str, float] = {}
        # Leopard closure index (tier 0): rebuilt with every projection;
        # None while disabled, too large or not built yet
        lcfg = dict(leopard or {})
        self.leopard_enabled = bool(lcfg.get("enabled", True))
        self._leopard_cfg = {
            "max_pairs": int(lcfg.get("max_pairs", 4_000_000)),
        }
        self._leo: Optional[LeoState] = None
        self.leopard_answered = 0  # checks answered from the index
        self.leopard_hits = 0  # of those, answered allowed
        # fused tiered dispatch (engine/fused.py): one wave per chunk, one
        # device-to-host copy; the constructor default stays off, as in
        # JAX (the JAX serving config turns it on)
        self.fused_dispatch = bool(fused_dispatch)
        self.fused_retry_lanes = max(int(fused_retry_lanes), 0)
        self.fused_waves = 0  # fused waves collected
        self.fused_d2h_fetches = 0  # device-to-host copies of those (1/wave)
        # per-tier row attribution of fused waves, from the returned masks
        # (the cache tier is not ported: it stays 0)
        self.fused_tier_rows = {
            "cache": 0, "leopard": 0, "fastpath": 0, "general": 0,
            "oracle": 0,
        }
        # fused waves enqueued, per WavePlan.shape()
        self.wave_shapes: Counter = Counter()
        # the changes drained since the base snapshot (the fold's input);
        # None once they outgrew FOLD_MAX_PAIRS, until the next full build
        self._since_base: Optional[list] = []
        self._snap_cursor = 0  # log cursor the base snapshot covers
        self._served_cursor = 0  # log cursor the served view covers

    def _phase(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + (t1 - t0)
        return t1

    # -- snapshot lifecycle -------------------------------------------------
    #
    # The JAX engine's synchronous write path (engine/tpu.py:400-758):
    # writes drain from the store's change log into the column mirror and
    # the closure index, then reach the card through the O(delta) overlay,
    # else an incremental fold, else a full re-projection.

    def _view(self):
        """(snapshot, device tables, Leopard state), with every write the
        store logged since the last batch applied first."""
        with self._view_lock:
            self._snapshot_locked()
            return self._snap, self._device_arrays, self._leo

    def _sync_cols(self) -> None:
        """Bring the column mirror up to date with the store: from the
        change log when it still covers the cursor, else a full rescan
        (a columnar store's id columns adopted wholesale: the 10M path)."""
        if self._cols is not None:
            changes, head = self.store.changes_since(self._log_cursor)
            if changes is not None:
                for op, t in changes:
                    self._cols.apply(op, t)
                self._log_cursor = head
                return
            self._cols = None  # the change log overflowed past our cursor
        exporter = getattr(self.store, "export_columns", None)
        store_vocab = getattr(self.store, "vocab", None)
        if exporter is not None and (
            store_vocab is self._vocab or len(self._vocab.subjects) == 0
        ):
            cols, alive, tail, head = exporter()
            self._vocab = store_vocab
            self._cols = dl.TupleColumns.from_arrays(store_vocab, cols, alive)
            for t in tail:
                self._cols.apply(1, t)
            self._log_cursor = head
            return
        tuples, head = self.store.tuples_and_head()
        self._cols = dl.TupleColumns.from_tuples(self._vocab, tuples)
        self._log_cursor = head

    def _snapshot_locked(self) -> None:
        fingerprint = config_fingerprint(self.namespace_manager)
        if self._snap is None or self._snap_fingerprint != fingerprint:
            self._rebuild(fingerprint)
            return
        changes, head = self.store.changes_since(self._log_cursor)
        if changes is None:
            self._rebuild(fingerprint)
            return
        if not changes:
            return
        t0 = time.perf_counter()
        w = self.last_write = {"changes": len(changes)}
        for op, t in changes:
            self._cols.apply(op, t)
        self._log_cursor = head
        self._note_since_base(changes)
        t1 = time.perf_counter()
        w["drain_s"] = t1 - t0
        # the closure index folds at drain time, against the mirror
        w["leopard"] = self._leopard_fold(changes)
        w["leopard_s"] = time.perf_counter() - t1
        if self._overlay_apply(changes):
            self._overlay_active = True
            self.overlay_applies += 1
            self._served_cursor = self._log_cursor
            w["tier"] = "overlay"
        elif self.supports_fold and self._fold_locked(fingerprint):
            w["tier"] = "fold"
        else:
            self._rebuild(fingerprint)
            w["tier"] = "rebuild"
            w["build_s"] = self.projection_build_s
            w["upload_s"] = self.projection_upload_s
        w["total_s"] = time.perf_counter() - t0

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _array_shapes(d) -> Optional[dict]:
        if d is None:
            return None
        return {k: (tuple(v.shape), v.dtype) for k, v in d.items()}

    def _rebuild(self, fingerprint: int) -> None:
        t0 = time.perf_counter()
        ph: Dict[str, float] = {}
        self._sync_cols()
        self._cols.compact()
        self._snap = dl.build_snapshot_cols(
            self._cols, self.namespace_manager, strict=self.strict_mode,
            version=self.store.version, phases=ph,
        )
        t1 = time.perf_counter()
        self._snap_fingerprint = fingerprint
        self._overlay = dl.OverlayState()
        self._overlay_active = False
        old_shapes = self._swap_shape_signature()
        self._install_device_arrays()
        self._sync_device()
        self.projection_build_s = t1 - t0
        self.projection_upload_s = time.perf_counter() - t1
        self.rebuilds += 1
        self.generation += 1
        self._snap_cursor = self._served_cursor = self._log_cursor
        self._since_base = []
        self.last_compaction_mode = "rebuild"
        self.last_build_phases = {f"build_{k}": v for k, v in ph.items()}
        if self._swap_shape_signature() != old_shapes:
            with self._gen_lock:
                self._gen_sched_cache.clear()  # a new graph: re-adapt once
        self._install_leopard()

    def _swap_shape_signature(self) -> Optional[dict]:
        """The shapes of the tables a projection ships (a change re-adapts
        the general schedule); the mesh engine signs its sharded tables."""
        return self._array_shapes(self._device_arrays)

    def _install_device_arrays(self) -> None:
        """Ship the projection: the base tables once per build, then the
        overlay's tables merged over them, empty ones from the first build
        so the kernels see the same tables before and after a write."""
        self._base_device = upload(self._snap.check_arrays(), self.device)
        self._expand_extra = None  # the next Expand uploads the new ones
        self._set_overlay_tables(upload(
            dl.overlay_arrays(self._overlay, self._snap,
                              pair_cap=self.max_overlay_pairs),
            self.device,
        ))

    def _set_overlay_tables(self, ov: Dict[str, torch.Tensor]) -> None:
        """Publish new check tables (the base with ``ov`` over it) and the
        fused wave's tables built from them: nothing keeps reading the
        previous overlay through a stale view."""
        g = kernels.DeviceTables(self._base_device)
        g.update(ov)
        self._device_arrays = g
        if self._leo is not None:
            self._leo = self._leo._replace(tables=self._leo_tables(self._leo.pairs))

    def _leo_tables(self, pairs):
        if pairs is None:
            return None
        tables = kernels.DeviceTables(self._device_arrays)
        tables.update(leo_sets=pairs["sets"], leo_elts=pairs["elts"],
                      leo_hops=pairs["hops"])
        return tables

    def _overlay_apply(self, changes) -> bool:
        """Serve ``changes`` through the O(delta) overlay; False when it
        cannot (or should not) represent them."""
        w = self.last_write
        t0 = time.perf_counter()
        try:
            dl.apply_changes(self._overlay, self._snap, self._vocab, changes)
        except dl.OverlayRejected:
            return False
        pairs, dirty = self._overlay.size()
        if pairs > self.max_overlay_pairs or dirty > self.max_overlay_dirty:
            return False
        try:
            ov = dl.overlay_arrays(self._overlay, self._snap,
                                   pair_cap=self.max_overlay_pairs)
        except ValueError:  # the fixed-shape table could not fit the content
            return False
        t1 = time.perf_counter()
        # fresh tensors: a batch already enqueued keeps reading the old ones
        self._set_overlay_tables(upload(ov, self.device))
        w["build_s"] = t1 - t0
        w["upload_s"] = time.perf_counter() - t1
        return True

    def _note_since_base(self, changes) -> None:
        """Accumulate the drained changes for the fold; past the fold
        budget they are dropped and folds stay off until the next full
        build."""
        if self._since_base is None:
            return
        self._since_base.extend(changes)
        if len(self._since_base) > FOLD_MAX_PAIRS:
            self._since_base = None

    def _fold_locked(self, fingerprint: int) -> bool:
        """Second tier: fold the changes since the base into it instead of
        re-projecting every tuple.  The fold keeps every padded shape (it
        rejects pad crossings), so the re-shipped tables have the shapes
        the dispatch schedules were sized for."""
        if not self._since_base:
            return False
        ph: Dict[str, float] = {}
        t0 = time.perf_counter()
        try:
            snap = dl.fold_snapshot_cols(
                self._snap, self._vocab, self._since_base,
                version=self.store.version, phases=ph,
            )
        except dl.FoldRejected:
            return False
        t1 = time.perf_counter()
        old_shapes = self._swap_shape_signature()
        self._snap = snap
        self._snap_fingerprint = fingerprint
        self._snap_cursor = self._log_cursor
        self._since_base = []
        self._overlay = dl.OverlayState()
        self._overlay_active = False
        self._install_device_arrays()
        self._sync_device()
        self.projection_build_s = t1 - t0
        self.projection_upload_s = time.perf_counter() - t1
        self.generation += 1
        self.folds += 1
        self.last_compaction_mode = "fold"
        self.last_build_phases = dict(ph)
        self.last_write.update(build_s=self.projection_build_s,
                               upload_s=self.projection_upload_s)
        if self._swap_shape_signature() != old_shapes:
            with self._gen_lock:
                self._gen_sched_cache.clear()
        self._served_cursor = self._log_cursor
        return True

    def _install_leopard(self) -> None:
        """(Re)build the closure index from the column mirror and ship its
        pair columns.  A closure past ``max_pairs`` leaves the index off
        (the lower tiers answer everything)."""
        self._leo = None
        if not self.leopard_enabled or self._cols is None:
            return
        idx = leo.ClosureIndex(max_width=self.max_width, **self._leopard_cfg)
        try:
            idx.build_from_cols(self._cols, self.namespace_manager)
        except leo.ClosureTooLarge:
            return
        idx.bind_vocab(self._vocab)
        pairs = self._ship_leopard(idx)
        self._leo = LeoState(idx, pairs, self._leo_tables(pairs))
        self.phase_seconds["leopard_build"] = (
            self.phase_seconds.get("leopard_build", 0.0) + idx.build_s)

    def _ship_leopard(self, idx: leo.ClosureIndex):
        """The closure index's pair columns on the card (K6 probes them),
        None for an empty index.  A subclass that ships none answers tier 0
        by the index's host search (the mesh engine)."""
        return leodev.ship_pairs(idx, self.device)

    def _leopard_fold(self, changes) -> str:
        """Fold drained changes into the closure index: additions append
        closure pairs, deletions mark set ids dirty; what the delta cannot
        represent (an unknown node, its thresholds) rebuilds the index from
        the mirror.  Returns the outcome: apply, rebuild or off."""
        if self._leo is None:
            return "off"
        if self._leo.index.apply_changes(changes):
            return "apply"
        self._install_leopard()
        return "rebuild"

    def _expand_arrays(self) -> Dict[str, torch.Tensor]:
        """The tables the Expand walk reads: the check tables (the overlay's
        included) plus the expand-only tables, uploaded on the first call
        after each projection.  Called under the view lock."""
        if self._expand_extra is None:
            t0 = time.perf_counter()
            extra = {k: getattr(self._snap, k) for k in EXPAND_ONLY_KEYS}
            self._expand_extra = upload(extra, self.device)
            self._sync_device()
            self.expand_upload_s = time.perf_counter() - t0
            self.expand_upload_bytes = sum(int(v.nbytes) for v in extra.values())
        g = kernels.DeviceTables(self._device_arrays)
        g.update(self._expand_extra)
        return g

    def refresh(self) -> None:
        """Force a full re-projection."""
        with self._view_lock:
            self._rebuild(config_fingerprint(self.namespace_manager))

    def projection_stats(self) -> dict:
        """The write path's state in one consistent read (the JAX engine's
        ``projection_stats`` without its background-compactor fields)."""
        with self._view_lock:
            pairs, dirty = (self._overlay.size() if self._overlay is not None
                            else (0, 0))
            return {
                "generation": self.generation,
                "rebuilds": self.rebuilds,
                "folds": self.folds,
                "overlay_applies": self.overlay_applies,
                "last_compaction_mode": self.last_compaction_mode,
                "overlay_active": self._overlay_active,
                "overlay_pairs": pairs,
                "overlay_dirty": dirty,
                "overlay_pair_cap": self.max_overlay_pairs,
                "overlay_dirty_cap": self.max_overlay_dirty,
                "since_base": (len(self._since_base)
                               if self._since_base is not None else -1),
                "fold_max_pairs": FOLD_MAX_PAIRS,
                "snap_cursor": self._snap_cursor,
                "served_cursor": self._served_cursor,
                "log_cursor": self._log_cursor,
                "projection_build_s": round(self.projection_build_s, 6),
                "projection_upload_s": round(self.projection_upload_s, 6),
                "build_phases": {k: round(v, 6)
                                 for k, v in self.last_build_phases.items()},
            }

    def leopard_stats(self) -> dict:
        """Gauge snapshot of tier 0 (the JAX engine's keto_leopard_*)."""
        with self._view_lock:
            state = self._leo
        stats = state.index.stats() if state is not None else {
            "pairs": 0.0, "dirty_sets": 0.0, "fallbacks": 0.0,
            "build_s": 0.0, "builds": 0.0,
        }
        stats["answered"] = float(self.leopard_answered)
        stats["hits"] = float(self.leopard_hits)
        stats["active"] = 1.0 if state is not None else 0.0
        return stats

    def snapshot(self) -> Snapshot:
        return self._view()[0]

    def leopard_index(self) -> Optional[LeoState]:
        """The current projection's Leopard state (None while off)."""
        return self._view()[2]

    def device_tables(self) -> Dict[str, torch.Tensor]:
        """The uploaded check arrays of the current projection."""
        return self._view()[1]

    def encode_general(self, queries: Sequence[RelationTuple], rest_depth: int = 0):
        """(encoded columns, general row indices) of one chunk: what
        :meth:`pack_general` takes."""
        _g, enc, _err, general, _leo = self._prepare(queries, rest_depth)
        return enc, np.flatnonzero(general)

    def pack_queries(self, queries: Sequence[RelationTuple], rest_depth: int = 0):
        """(qpack, err, general) of one chunk: the int32[6, Qpad] block the
        BFS reads (ns, obj, rel, subj, depth, active), padded to the
        batch bucket, and the rows it leaves to the oracle."""
        _g, enc, err, general, _leo = self._prepare(queries, rest_depth)
        qpad = min(_bucket(len(queries)), self.frontier)
        return self._qpack(enc, ~(err | general), qpad), err, general

    def _prepare(self, queries, rest_depth: int):
        """(device tables, encoded columns, err mask, general mask, Leopard
        state)."""
        snap, g, leo_state = self._view()
        enc = self._encode(snap, queries, rest_depth)
        err, general = self._classify(snap, enc[0], enc[2])
        return g, enc, err, general, leo_state

    # -- query encoding -----------------------------------------------------

    def _encode(self, snap: Snapshot, queries, rest_depth: int):
        v = snap.vocab
        n = len(queries)
        q_ns = np.fromiter((v.namespaces.lookup(q.namespace) for q in queries), np.int32, n)
        q_obj = np.fromiter((v.objects.lookup(q.object) for q in queries), np.int32, n)
        q_rel = np.fromiter((v.relations.lookup(q.relation) for q in queries), np.int32, n)
        q_subj = np.fromiter((v.subject_key(q.subject) for q in queries), np.int32, n)
        # global max-depth precedence (engine.go:82-84)
        if rest_depth <= 0 or self.max_depth < rest_depth:
            rest_depth = self.max_depth
        q_depth = np.full(n, rest_depth, np.int32)
        return q_ns, q_obj, q_rel, q_subj, q_depth

    def _classify(self, snap: Snapshot, q_ns, q_rel):
        """(err, general) masks from the snapshot's static tables.

        err: the oracle must raise the reference's typed client error — a
        configured namespace queried with an undeclared non-empty relation
        (namespace/definitions.go:61).  general: the relation's closure can
        reach AND/NOT or an erroring lookup, so the BFS would be wrong."""
        num_ns, num_rel = snap.taint.shape
        ns_ok = q_ns >= 0
        nsc = np.clip(q_ns, 0, num_ns - 1)
        relc = np.clip(q_rel, 0, num_rel - 1)
        ns_cfg = ns_ok & snap.flat.ns_cfg[nsc]
        rel_known = q_rel >= 0
        err = ns_cfg & (~rel_known | snap.op.rel_err[nsc, relc])
        general = ~err & ns_ok & rel_known & snap.taint[nsc, relc]
        return err, general

    @staticmethod
    def _pad(arrays, n: int, qpad: int):
        fills = (-1, -1, -1, -1, 1)
        if qpad == n:
            return arrays
        return tuple(
            np.pad(a, (0, qpad - n), constant_values=f)
            for a, f in zip(arrays, fills)
        )

    # -- demand-adaptive level scheduling -----------------------------------

    def _adaptive_mults(self):
        """Per-level frontier multipliers from the occupancy EMA, quantized
        up to a small ladder (uniform base capped by F_MULT), or None (the
        worst-case F_MULT) before the first report."""
        ema = self._occ_ema
        if ema is None:
            return None
        caps = [
            fp.F_MULT[min(lvl, len(fp.F_MULT) - 1)]
            for lvl in range(1, self.max_depth)
        ]
        want = [
            max(1, min(c, int(np.ceil(
                ema[min(lvl, len(ema) - 1)] * self.occ_headroom
            ))))
            for lvl, c in zip(range(1, self.max_depth), caps)
        ]
        for base in (1, 2, 4):
            rung = [min(c, base) for c in caps]
            if all(r >= w for r, w in zip(rung, want)):
                return (1, *rung)
        return None

    def _update_occ(self, occ: np.ndarray) -> None:
        roots = float(occ[0])
        if roots <= 0:
            return
        ratio = occ.astype(np.float64) / roots
        if self._occ_ema is None or len(self._occ_ema) != len(ratio):
            self._occ_ema = ratio
        else:
            self._occ_ema = 0.5 * self._occ_ema + 0.5 * ratio

    # -- the general (AND/NOT) tier's static shapes ---------------------------

    def _gen_schedule(self, q: int, boost: int) -> GenSchedule:
        """Static shapes of one general dispatch: per-level skeleton sizes,
        the leaf buffer, the sub-run's level schedule and the visited-set
        capacity.  The level budget is fixed per tier (``gen_levels``, the
        retry ``gen_levels_max``).  Before the first occupancy report (and
        at the retry) the sizes are the fixed multipliers x roots; after it
        the first pass is demand-sized from the occupancy EMAs x headroom,
        half-octave bucketed, and that first pick is frozen per (Q, boost)
        so later batches reuse it."""
        with self._gen_lock:
            return self._gen_schedule_locked(q, boost)

    def _gen_schedule_locked(self, q: int, boost: int) -> GenSchedule:
        cached = self._gen_sched_cache.get((q, boost))
        if cached is not None:
            return cached
        D = self.gen_levels if boost <= 1 else self.gen_levels_max
        cap = boost * self.gen_arena
        adaptive = boost <= 1 and self._gen_occ_ema is not None
        if adaptive:
            want = self._gen_occ_ema[:D] * self.occ_headroom
            sizes = tuple(
                int(min(_bucket15(max(int(np.ceil(w * q)), 64), 64), cap))
                for w in want
            )
        else:
            sizes = tuple(
                int(min(_bucket15(m * q * boost, 64), cap))
                for m in _gen_mults(D)
            )
        fmul = 2.0
        if adaptive and self._gen_fast_ema is not None:
            fmul = max(self._gen_fast_ema * self.occ_headroom, 1 / 16)
        f_cap = boost * self.frontier
        a_cap = boost * self.arena
        fast_b = int(min(
            _bucket15(int(np.ceil(fmul * q)) * boost, 256), f_cap
        ))
        if adaptive and self._gen_fast_occ_ema is not None:
            # sub-run levels demand-sized in units of roots; level 0 is the
            # leaf buffer
            fls = [fast_b] + [
                int(min(_bucket15(max(int(np.ceil(w * q)), 64), 64), f_cap))
                for w in self._gen_fast_occ_ema[1:] * self.occ_headroom
            ]
            fast_sched = tuple(
                (fl,
                 fp.PROBE_ONLY_ARENA if i == len(fls) - 1
                 else min(4 * fl if i == 0 else 2 * fl, a_cap))
                for i, fl in enumerate(fls)
            )
        else:
            fast_sched = fp.level_schedule(fast_b, f_cap, a_cap, self.max_depth)
        vcap = boost * self.vcap
        if adaptive:
            # the visited set serves tainted expansion children only; an
            # overflow is an over bit and a retry, never a wrong verdict
            vcap = int(min(vcap, max(1024, _bucket15(4 * q))))
        out = (sizes, fast_b, fast_sched, vcap)
        if adaptive:
            self._gen_sched_cache[(q, boost)] = out
        return out

    def _update_gen_occ(self, occ: np.ndarray) -> None:
        """Fold one first-pass general dispatch's occupancy into the EMAs,
        in units of active roots."""
        D = self.gen_levels
        roots = float(occ[0])
        if roots <= 0:
            return
        lev = occ[1: D + 1].astype(np.float64) / roots
        fleaves = float(occ[D + 1]) / roots
        focc = occ[D + 2:].astype(np.float64) / roots
        with self._gen_lock:
            if self._gen_occ_ema is None or len(self._gen_occ_ema) != len(lev):
                self._gen_occ_ema = lev
                self._gen_fast_ema = fleaves
                self._gen_fast_occ_ema = focc
            else:
                self._gen_occ_ema = 0.5 * self._gen_occ_ema + 0.5 * lev
                self._gen_fast_ema = 0.5 * self._gen_fast_ema + 0.5 * fleaves
                if len(focc) == len(self._gen_fast_occ_ema):
                    self._gen_fast_occ_ema = (
                        0.5 * self._gen_fast_occ_ema + 0.5 * focc
                    )
                else:
                    self._gen_fast_occ_ema = focc

    def pack_general(self, enc, gi: np.ndarray, boost: int = 1):
        """(qpack, schedule) of one general dispatch over rows ``gi`` of the
        encoded chunk ``enc``: the int32[6, Qpad] block, padded to the
        half-octave bucket, and its static shapes."""
        n = len(gi)
        qpad = min(_bucket15(n, 256), self.max_batch)
        genc = self._pad(tuple(a[gi] for a in enc), n, qpad)
        active = np.arange(qpad) < n
        qpack = np.stack([*genc, active.astype(np.int32)]).astype(np.int32)
        return qpack, self._gen_schedule(qpad, boost)

    def _run_general(self, g, enc, gi: np.ndarray, boost: int = 1):
        """Enqueue one general dispatch for rows ``gi``; returns the
        uncollected (Packed, n) handle."""
        qpack, sched = self.pack_general(enc, gi, boost)
        sizes, fast_b, fast_sched, vcap = sched
        self.general_shapes[(qpack.shape[1], boost, sched)] += 1
        res = alg.run_general_packed(
            g, qpack, sizes=sizes, fast_b=fast_b, fast_sched=fast_sched,
            max_width=self.max_width, vcap=vcap,
        )
        return res, len(gi)

    # -- public API ---------------------------------------------------------

    def check(self, r: RelationTuple, rest_depth: int = 0) -> bool:
        return self.batch_check([r], rest_depth)[0]

    def check_is_member(self, r: RelationTuple, rest_depth: int = 0) -> bool:
        return self.check(r, rest_depth)

    def batch_check(
        self, queries: Sequence[RelationTuple], rest_depth: int = 0
    ) -> List[bool]:
        """Verdicts of a batch, in order.  Chunks of ``max_batch`` are all
        enqueued on the card before the first is collected."""
        queries = list(queries)
        chunks = [
            queries[lo: lo + self.max_batch]
            for lo in range(0, len(queries), self.max_batch)
        ]
        handles = [self._dispatch(c, rest_depth) for c in chunks]
        out: List[bool] = []
        for c, h in zip(chunks, handles):
            out.extend(self._finish_chunk(c, h, rest_depth).tolist())
        return out

    def expand_view(self):
        """(snapshot, Expand tables, overlay members or None) read as one
        view, with every write the store logged applied first."""
        with self._view_lock:
            self._snapshot_locked()
            ov = (xd.OverlayMembers(self._overlay, self._snap, self._vocab)
                  if self._overlay_active else None)
            return self._snap, self._expand_arrays(), ov

    def batch_expand(self, subjects, rest_depth: int = 0) -> List[Optional[Tree]]:
        """Batched Expand: one K9 walk for all subject-set roots, the exact
        DFS replay on the host (``expand_device.run_expand``).  SubjectID
        roots are leaves without the card (expand/handler.go:115-126).
        With writes pending in the overlay, the card still walks base rows
        and the assembly merges the overlay's member deltas
        (``expand_device.OverlayMembers``); added subject-set subtrees
        recurse through the oracle's Expand with the tree's shared visited
        set.  The snapshot, the tables and the overlay copy come from one
        locked view, so a write landing meanwhile never mixes generations.
        Roots whose walk overflowed an arena (:data:`EXPAND_CAP`) are
        answered by the oracle's Expand on the live store.

        Unlike the JAX engine, which serves the whole batch on the oracle
        when the device walk raises (``engine/tpu.py:2079-2091``), a CUDA
        error propagates here, as on the check path."""
        oracle = ExpandEngine(self.store, max_depth=self.max_depth)
        subjects = list(subjects)
        out: List[Optional[Tree]] = [None] * len(subjects)
        set_idx = [i for i, s in enumerate(subjects) if isinstance(s, SubjectSet)]
        for i, s in enumerate(subjects):
            if isinstance(s, SubjectID):
                out[i] = Tree(type=TreeNodeType.LEAF,
                              tuple=RelationTuple("", "", "", s))
        if not set_idx:
            return out  # leaves only: neither the card nor the lock
        t0 = time.perf_counter()
        snap, tables, ov = self.expand_view()
        self._phase("expand_snapshot", t0)
        timings: Dict[str, float] = {}
        info: dict = {}
        if tables is None:
            # no tables to walk (the mesh engine's replica past its
            # budget): every root goes to the oracle
            trees, over = [None] * len(set_idx), np.ones(len(set_idx), bool)
        else:
            trees, over = xd.run_expand(
                tables, snap, [subjects[i] for i in set_idx], rest_depth,
                max_depth=self.max_depth, fanout=EXPAND_FANOUT, cap=EXPAND_CAP,
                ov=ov, sub_expand=oracle._build, timings=timings, info=info,
            )
        for name, dt in timings.items():
            self.phase_seconds["expand_" + name] = (
                self.phase_seconds.get("expand_" + name, 0.0) + dt)
        t0 = time.perf_counter()
        for k, i in enumerate(set_idx):
            if over[k]:
                self.fallbacks += 1
                out[i] = oracle.build_tree(subjects[i], rest_depth)
            else:
                out[i] = trees[k]
        if over.any():
            self._phase("expand_oracle_fallback", t0)
        self.last_expand = dict(info, over=int(over.sum()))
        return out

    def _qpack(self, enc, active, qpad: int) -> np.ndarray:
        padded = self._pad(enc, len(active), qpad)
        act = np.pad(active, (0, qpad - len(active)))
        return np.stack([*padded, act.astype(np.int32)]).astype(np.int32)

    def _run(self, g, enc, active, qpad: int, *, frontier: int, arena: int,
             boost: int = 1, mults=None) -> fp.Packed:
        qpack = self._qpack(enc, active, qpad)
        self.dispatch_shapes[(qpad, frontier, arena, boost)] += 1
        return fp.run_fast_packed(
            g, qpack, frontier=frontier, arena=arena,
            max_depth=self.max_depth, max_width=self.max_width,
            boost=boost, mults=mults,
        )

    def _dispatch(self, queries, rest_depth: int):
        """Enqueue one chunk's device work; returns an uncollected handle."""
        n = len(queries)
        if n == 0:
            return None
        t0 = time.perf_counter()
        g, enc, err, general, leo_state = self._prepare(queries, rest_depth)
        if self.fused_dispatch:
            return self._dispatch_fused(enc, err, general, g, leo_state,
                                        rest_depth, t0)
        # Leopard first: the rows it answers leave the BFS entirely
        leo_res = self._leopard_answers(enc, err, general, leo_state)
        active = ~(err | general)
        if leo_res is not None:
            active &= ~leo_res[1]
        t1 = self._phase("encode", t0)
        res = None
        if active.any():
            res = self._run(
                g, enc, active, min(_bucket(n), self.frontier),
                frontier=self.frontier, arena=self.arena,
                mults=self._adaptive_mults(),
            )
        t1 = self._phase("enqueue", t1)
        gres = gi = None
        if general.any():
            gi = np.flatnonzero(general)
            gres = self._run_general(g, enc, gi)
            self._phase("general", t1)
        return enc, err, general, res, gi, gres, g, leo_res

    # -- tier 0 --------------------------------------------------------------

    def _leopard_answers(self, enc, err, general, leo_state: Optional[LeoState]):
        """(allowed, answered) bool arrays from the closure index, or None
        while the index is off: one binary search per row over the shipped
        pair columns (one K6 launch), for every chunk size; an index with no
        pair columns on the card (empty, or not shipped by a subclass) is
        searched on the host."""
        if leo_state is None or self.strict_mode:
            return None
        q_ns, q_obj, q_rel, q_subj, q_depth = enc
        n = len(q_ns)
        idx = leo_state.index
        # under the lock: a write's drain folds into this index in place
        with self._view_lock:
            nodes, node_hi = idx.node_ids_np(q_ns, q_obj, q_rel)
            probed = None
            if leo_state.pairs is not None:
                keys = np.where(
                    (nodes >= 0) & (q_subj >= 0),
                    (nodes.astype(np.int64) << 32) | q_subj.astype(np.int64),
                    np.int64(-1),
                )
                probed = leodev.probe_pairs(leo_state.pairs, keys, _bucket(n))
            allowed, answered = idx.answer_checks(
                nodes, q_subj, node_hi, int(q_depth[0]), probed=probed
            )
        answered &= ~(err | general)
        allowed &= answered
        self.leopard_answered += int(answered.sum())
        self.leopard_hits += int(allowed.sum())
        return allowed, answered

    # -- the fused wave --------------------------------------------------------

    def plan_wave(self, queries: Sequence[RelationTuple], rest_depth: int = 0):
        """The fused wave the engine would dispatch for one chunk (see
        :class:`WavePlan`); dispatches nothing."""
        g, enc, err, general, leo_state = self._prepare(queries, rest_depth)
        return self._plan_wave(enc, err, general, g, leo_state, rest_depth)

    def _plan_wave(self, enc, err, general, g, leo_state, rest_depth: int):
        """The JAX ``_dispatch_fused`` up to the dispatch: the host half of
        tier 0 as one probe mode per row (``prep_fused_checks``), the probe
        keys, the int32[10, Q] block and the tiers' static schedules.
        Absent tiers drop out of the wave; the retry lanes stay in whenever
        their tier is in, with or without rows to retry."""
        n = len(enc[0])
        q_ns, q_obj, q_rel, q_subj, q_depth = enc
        lmode = np.zeros(n, np.int32)
        leo_set = np.full(n, -1, np.int32)
        leo_elt = np.full(n, -1, np.int32)
        has_leo = leo_state is not None and not self.strict_mode
        tables = g
        if has_leo:
            idx = leo_state.index
            # under the lock: a write's drain folds into this index in place
            with self._view_lock:
                nodes, node_hi = idx.node_ids_np(q_ns, q_obj, q_rel)
                if leo_state.pairs is not None:
                    # the raw rest_depth (0 = the engine maximum), as the
                    # JAX _dispatch_fused passes it
                    lmode = idx.prep_fused_checks(nodes, q_subj, node_hi,
                                                  rest_depth)
                    probe_ok = (nodes >= 0) & (q_subj >= 0)
                    leo_set = np.where(probe_ok, nodes, -1).astype(np.int32)
                    leo_elt = np.where(probe_ok, q_subj, -1).astype(np.int32)
                    tables = leo_state.tables
                else:
                    # no pair columns (empty index): the host answers,
                    # encoded as pre-resolved modes that need no search
                    allowed, answered = idx.answer_checks(
                        nodes, q_subj, node_hi, int(q_depth[0]))
                    lmode[answered & allowed] = leo.LM_ALLOW
                    lmode[answered & ~allowed] = leo.LM_DENY
        lmode[err | general] = leo.LM_NONE
        fast_elig = ~(err | general)
        qpad = min(_bucket(n), self.frontier)
        padded = self._pad(enc, n, qpad)
        pad = qpad - n
        qpack = np.stack([
            *padded,
            np.pad(fast_elig, (0, pad)).astype(np.int32),
            np.pad(general, (0, pad)).astype(np.int32),
            np.pad(lmode, (0, pad)),
            np.pad(leo_set, (0, pad), constant_values=-1),
            np.pad(leo_elt, (0, pad), constant_values=-1),
        ]).astype(np.int32)
        fast_sched = retry_sched = None
        lanes = 0
        if fast_elig.any():
            fast_sched = fp.level_schedule(
                qpad, self.frontier, self.arena, self.max_depth, 1,
                self._adaptive_mults(),
            )
            lanes = self.fused_retry_lanes if self.retry_scale > 1 else 0
            if lanes:
                rs = self.retry_scale
                retry_sched = fp.level_schedule(
                    qpad, rs * self.frontier, rs * self.arena, self.max_depth,
                    rs,
                )
        gen = gen_retry = None
        if general.any():
            gen = self._gen_schedule(qpad, 1)
            if self.retry_scale > 1 and self.fused_retry_lanes > 0:
                gen_retry = self._gen_schedule(qpad, self.retry_scale)
        kwargs = dict(fast_sched=fast_sched, retry_sched=retry_sched,
                      retry_lanes=lanes, gen=gen, gen_retry=gen_retry,
                      max_width=self.max_width, depth_slack=leo.DEPTH_SLACK)
        return WavePlan(qpack, tables, kwargs, n, err, general, has_leo)

    def _dispatch_fused(self, enc, err, general, g, leo_state, rest_depth: int,
                        t0: float):
        """Fused branch of ``_dispatch``: one wave (engine/fused.py) for
        the whole chunk, fetched once at collect."""
        t1 = self._phase("encode", t0)
        plan = self._plan_wave(enc, err, general, g, leo_state, rest_depth)
        t1 = self._phase("plan", t1)
        self.wave_shapes[plan.shape()] += 1
        out = fdx.run_fused_wave(plan.tables, plan.qpack, **plan.kwargs)
        self._phase("wave", t1)
        return plan, out

    def _collect_fused(self, plan: WavePlan, out: torch.Tensor):
        """Fetch one wave (its one device-to-host copy), decode the bit
        field, feed the occupancy EMAs and the counters.  Returns
        (allowed, fallback)."""
        n, err, general = plan.n, plan.err, plan.general
        qpad, flen, glen = plan.qpack.shape[1], plan.flen, plan.glen
        t0 = time.perf_counter()
        packed = out.cpu().numpy()
        self._phase("fetch", t0)
        self.fused_waves += 1
        self.fused_d2h_fetches += 1
        rows = packed[:n]
        gcode = (rows & 3).astype(np.int8)
        gover = ((rows >> 2) & 1).astype(bool)
        gdirty = ((rows >> 3) & 1).astype(bool)
        found = ((rows >> 4) & 1).astype(bool)
        fast_fb = ((rows >> 5) & 1).astype(bool)
        leo_ans = ((rows >> 6) & 1).astype(bool)
        leo_allow = ((rows >> 7) & 1).astype(bool)
        retried = ((rows >> 8) & 1).astype(bool)
        gen_retried = ((rows >> 9) & 1).astype(bool)
        if flen:
            self._update_occ(packed[qpad: qpad + flen])
        if glen:
            self._update_gen_occ(packed[qpad + flen: qpad + flen + glen])
        self.retries += int(retried.sum()) + int(gen_retried.sum())
        self.general_retries += int(gen_retried.sum())
        self.general_rows += int(general.sum())
        if plan.has_leo:
            self.leopard_answered += int(leo_ans.sum())
            self.leopard_hits += int(leo_allow.sum())
        allowed = np.zeros(n, bool)
        fallback = err.copy()
        allowed[general] = (gcode == R_IS)[general]
        fallback[general] |= (gover | gdirty | (gcode == R_ERR))[general]
        fmask = ~(err | general)
        allowed[fmask] = found[fmask]
        if plan.has_leo:
            allowed[leo_ans] = leo_allow[leo_ans]
        # fast_fb is masked to the fast-active rows in the wave, which
        # already exclude the rows tier 0 answered
        fallback |= fast_fb
        # per-tier attribution: leopard -> oracle -> device, as in JAX
        tr = self.fused_tier_rows
        seen = leo_ans.copy() if plan.has_leo else np.zeros(n, bool)
        tr["leopard"] += int(seen.sum())
        orc = (fallback | err) & ~seen
        tr["oracle"] += int(orc.sum())
        rest = ~(seen | orc)
        tr["general"] += int((rest & general).sum())
        tr["fastpath"] += int((rest & ~general).sum())
        return allowed, fallback

    def _collect_general(self, g, enc, gi: np.ndarray, gres):
        """Fetch one general dispatch (one device-to-host copy), retry its
        overflowed rows once at ``retry_scale``x caps.  Returns (allowed,
        fallback) of rows ``gi``: the oracle takes what is still over, ERR
        or dirty."""
        t0 = time.perf_counter()
        res, n = gres
        packed, occ = res.fetch()
        packed = packed[:n]
        self._update_gen_occ(occ)
        self._phase("general", t0)
        codes = (packed & 3).astype(np.int8)
        over = ((packed >> 2) & 1).astype(bool)
        # dirty: the skeleton touched overlay-stale state (a changed edge
        # row); under AND/NOT even an IS can be wrong, so the oracle
        # answers, and a device retry would read the same stale base
        dirty = ((packed >> 3) & 1).astype(bool)
        allowed = codes == R_IS
        unres = over & ~dirty & (codes != R_ERR)
        if unres.any() and self.retry_scale > 1:
            t0 = time.perf_counter()
            ri = np.flatnonzero(unres)
            self.retries += len(ri)
            self.general_retries += len(ri)
            rres, rn = self._run_general(g, enc, gi[ri], boost=self.retry_scale)
            rpacked, _ = rres.fetch()
            rpacked = rpacked[:rn]
            rcodes = (rpacked & 3).astype(np.int8)
            allowed[ri] = rcodes == R_IS
            over[ri] = (((rpacked >> 2) & 1) | ((rpacked >> 3) & 1)).astype(bool) \
                | (rcodes == R_ERR)
            codes[ri] = rcodes
            self._phase("general_retry", t0)
        self.general_rows += n
        return allowed, over | dirty | (codes == R_ERR)

    def _collect(self, handle):
        """Fetch one chunk's verdicts (one device-to-host copy per tier, or
        one per fused wave), retry each tier's overflow tail at
        retry_scale x caps (unfused).  Returns (allowed, fallback)."""
        if isinstance(handle[0], WavePlan):
            return self._collect_fused(*handle)
        enc, err, general, res, gi, gres, g, leo_res = handle
        n = err.shape[0]
        allowed = np.zeros(n, bool)
        fallback = err.copy()
        if gres is not None:
            allowed[gi], fallback[gi] = self._collect_general(g, enc, gi, gres)
        if leo_res is not None:
            # closure verdicts; their rows were inactive on the device
            allowed[leo_res[1]] = leo_res[0][leo_res[1]]
        if res is None:
            return allowed, fallback
        t0 = time.perf_counter()
        codes, occ = res.fetch()
        t0 = self._phase("fetch", t0)
        codes = codes[:n]
        self._update_occ(occ)
        found = (codes & 1).astype(bool)
        over = ((codes >> 1) & 1).astype(bool)
        dirty = ((codes >> 2) & 1).astype(bool)
        fmask = ~(err | general)
        if leo_res is not None:
            fmask &= ~leo_res[1]
        allowed[fmask] = found[fmask]
        # a dirty row needed an edge row with pending writes: the oracle
        # answers unless membership was already found (found bits are
        # overlay-exact and monotone); a device retry would read the same
        # stale row, so dirty rows stay out of the retry
        fallback |= fmask & dirty & ~found
        # found is monotone: an overflow only voids not-yet-found queries
        unres = fmask & over & ~found & ~dirty
        if unres.any() and self.retry_scale > 1:
            ri = np.flatnonzero(unres)
            self.retries += len(ri)
            rpad = min(_bucket(len(ri), 256), self.retry_scale * self.frontier)
            rres = self._run(
                g, tuple(a[ri] for a in enc), np.ones(len(ri), bool), rpad,
                frontier=self.retry_scale * self.frontier,
                arena=self.retry_scale * self.arena, boost=self.retry_scale,
            )
            rcodes, _ = rres.fetch()
            rcodes = rcodes[: len(ri)]
            rfound = (rcodes & 1).astype(bool)
            allowed[ri] = rfound
            unres[ri] = (((rcodes >> 1) | (rcodes >> 2)) & 1).astype(bool) \
                & ~rfound
            self._phase("retry", t0)
        return allowed, fallback | unres

    def _finish_chunk(self, queries, handle, rest_depth: int) -> np.ndarray:
        """Collect one chunk; the oracle answers the fallback rows exactly
        (an err row raises its typed error from here)."""
        if handle is None:
            return np.zeros(0, bool)
        allowed, fallback = self._collect(handle)
        t0 = time.perf_counter()
        for i in np.flatnonzero(fallback):
            self.fallbacks += 1
            allowed[i] = self.oracle.check_is_member(queries[i], rest_depth)
        self._phase("oracle", t0)
        return allowed
