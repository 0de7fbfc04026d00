"""The CUDA check engine: host wrapper around the tier-1 BFS kernels.

The port's counterpart of the JAX package's ``engine/tpu.py``
``DeviceCheckEngine`` as it runs with ``fused_dispatch`` off and Leopard
disabled: callers hand it relation tuples, it answers allow/deny.  It

1. projects the store into a snapshot (``delta.build_snapshot_cols``) and
   uploads ``Snapshot.check_arrays()`` to the device once per store
   version — any write makes the next batch re-project (the O(delta)
   overlay of the JAX engine is not ported yet);
2. interns query strings to dense ids (unknown strings miss everywhere,
   which reproduces "unknown namespace => not allowed");
3. classifies each query: pure-OR queries run the tier-1 BFS on the card
   (``fastpath.run_fast_packed``), queries that can reach AND / NOT go to
   the exact host oracle, and queries whose lookup is a client error go to
   the oracle, which raises the reference's typed error;
4. retries the not-found overflow tail once on the card at
   ``retry_scale``x caps, then answers what is still over on the oracle.

A CUDA error propagates: there is no fallback from the card to the host.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ketotpu_torch import kernels
from ketotpu_torch.api.types import RelationTuple
from ketotpu_torch.engine import delta as dl
from ketotpu_torch.engine import fastpath as fp
from ketotpu_torch.engine.oracle import (
    DEFAULT_MAX_DEPTH,
    DEFAULT_MAX_WIDTH,
    CheckEngine,
)
from ketotpu_torch.engine.snapshot import Snapshot
from ketotpu_torch.engine.vocab import Vocab
from ketotpu_torch.storage.namespaces import NamespaceManager


def _bucket(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def upload(arrays: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Ship a ``Snapshot.check_arrays()`` dict (of either package) to
    ``device``: one tensor per array, same names, same dtypes."""
    out = kernels.DeviceTables()
    for k, v in arrays.items():
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def config_fingerprint(manager: Optional[NamespaceManager]) -> int:
    """Namespace-config identity: the AST reprs pin the content, so a
    reloaded config re-projects even when the tuple store did not move."""
    if manager is None:
        return 0
    digest = hashlib.sha256()
    for ns in manager.namespaces():
        digest.update(repr(ns).encode())
        digest.update(b"\x00")
    return int.from_bytes(digest.digest()[:8], "big", signed=True)


class DeviceCheckEngine:
    """Batched permission checks on the card, oracle for what the BFS
    cannot answer."""

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
        self.oracle = CheckEngine(
            store,
            namespace_manager,
            max_depth=max_depth,
            max_width=max_width,
            strict_mode=strict_mode,
        )
        self._vocab = Vocab()
        # the HTTP server calls batch_check from many threads: one
        # projection at a time, and (snapshot, tables) read as one pair
        self._view_lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self._snap_key = None
        self._device_arrays: Optional[Dict[str, torch.Tensor]] = None
        # demand-adaptive level scheduling: EMA of the per-level frontier
        # occupancy (units of active roots), None until the first batch
        self._occ_ema: Optional[np.ndarray] = None
        self.occ_headroom = 1.15
        self.fallbacks = 0  # queries answered by the host oracle
        self.retries = 0  # queries re-run at retry_scale x caps
        self.rebuilds = 0  # projections + uploads
        # device batches enqueued, per (Q, frontier, arena, boost): every
        # batch of one shape launches the same kernels at the same sizes
        self.dispatch_shapes: Counter = Counter()
        self.projection_build_s = 0.0  # host snapshot build of the last one
        self.projection_upload_s = 0.0  # its upload, synchronized
        # host wall seconds per batch_check phase: encode (+ classify, and
        # the re-projection when the store moved), enqueue (the level loop's wrapper calls), fetch (the one D2H copy,
        # which waits for the device), retry (enqueue + fetch of the retry
        # dispatch), oracle
        self.phase_seconds: Dict[str, float] = {}

    def _phase(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + (t1 - t0)
        return t1

    # -- snapshot lifecycle -------------------------------------------------

    def _view(self):
        """(snapshot, device tables), re-projecting when the store or the
        namespace config moved since the last projection."""
        with self._view_lock:
            key = (self.store.version,
                   config_fingerprint(self.namespace_manager))
            if self._snap is None or key != self._snap_key:
                self._rebuild(key)
            return self._snap, self._device_arrays

    def _columns(self) -> dl.TupleColumns:
        exporter = getattr(self.store, "export_columns", None)
        store_vocab = getattr(self.store, "vocab", None)
        if exporter is not None and (
            store_vocab is self._vocab or len(self._vocab.subjects) == 0
        ):
            # columnar store: adopt its id columns wholesale (10M path)
            cols, alive, tail, _head = exporter()
            self._vocab = store_vocab
            out = dl.TupleColumns.from_arrays(store_vocab, cols, alive)
            for t in tail:
                out.apply(1, t)
            return out
        tuples, _head = self.store.tuples_and_head()
        return dl.TupleColumns.from_tuples(self._vocab, tuples)

    def _rebuild(self, key) -> None:
        t0 = time.perf_counter()
        cols = self._columns()
        cols.compact()
        self._snap = dl.build_snapshot_cols(
            cols, self.namespace_manager, strict=self.strict_mode,
            version=self.store.version,
        )
        t1 = time.perf_counter()
        self._device_arrays = upload(self._snap.check_arrays(), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.projection_build_s = t1 - t0
        self.projection_upload_s = time.perf_counter() - t1
        self._snap_key = key
        self.rebuilds += 1

    def snapshot(self) -> Snapshot:
        return self._view()[0]

    def device_tables(self) -> Dict[str, torch.Tensor]:
        """The uploaded check arrays of the current projection."""
        return self._view()[1]

    def pack_queries(self, queries: Sequence[RelationTuple], rest_depth: int = 0):
        """(qpack, err, general) of one chunk: the int32[6, Qpad] block the
        BFS reads (ns, obj, rel, subj, depth, active), padded to the
        batch bucket, and the rows it leaves to the oracle."""
        _g, enc, err, general = self._prepare(queries, rest_depth)
        qpad = min(_bucket(len(queries)), self.frontier)
        return self._qpack(enc, ~(err | general), qpad), err, general

    def _prepare(self, queries, rest_depth: int):
        """(device tables, encoded columns, err mask, general mask)."""
        snap, g = self._view()
        enc = self._encode(snap, queries, rest_depth)
        err, general = self._classify(snap, enc[0], enc[2])
        return g, enc, err, general

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
        g, enc, err, general = self._prepare(queries, rest_depth)
        active = ~(err | general)
        t1 = self._phase("encode", t0)
        res = None
        if active.any():
            res = self._run(
                g, enc, active, min(_bucket(n), self.frontier),
                frontier=self.frontier, arena=self.arena,
                mults=self._adaptive_mults(),
            )
        self._phase("enqueue", t1)
        return enc, err, general, res, g

    def _collect(self, handle):
        """Fetch one chunk's verdicts (one device-to-host copy), retry the
        not-found overflow tail at retry_scale x caps.  Returns (allowed,
        fallback)."""
        enc, err, general, res, g = handle
        n = err.shape[0]
        allowed = np.zeros(n, bool)
        fallback = err | general
        if res is None:
            return allowed, fallback
        t0 = time.perf_counter()
        codes, occ = res.fetch()
        t0 = self._phase("fetch", t0)
        codes = codes[:n]
        self._update_occ(occ)
        found = (codes & 1).astype(bool)
        over = ((codes >> 1) & 1).astype(bool)
        fmask = ~(err | general)
        allowed[fmask] = found[fmask]
        # found is monotone: an overflow only voids not-yet-found queries
        unres = fmask & over & ~found
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
            unres[ri] = ((rcodes >> 1) & 1).astype(bool) & ~rfound
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
