#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build the tier-1 CUDA kernels from ``ketotpu_torch/csrc`` (one ``nvcc``
   per source, all at once) into ``build/ketotpu_torch/``;
2. build the 10M-tuple synth graph, project and upload it, then hold every
   kernel against its plain PyTorch version on the same CUDA tensors
   (tolerance 0), level by level, at every shape the engine dispatches:
   each chunk's first pass (Q = frontier = 8192, arena = 16384) and the
   retry of its overflowed rows (frontier 32768, arena 65536, boost 4).
   This runs on a chunk of which half the checks are derived from grants
   in the graph (its verdicts are held against the exact oracle, row for
   row) and on every chunk of the main path's own checks;
3. serve 2 x 8192 seeded Doc#view checks through
   ``DeviceCheckEngine.batch_check`` (warm, then timed with the launch
   counters reset just before and read just after);
4. check the main path: its verdicts against the level-by-level replay of
   phase 2, one chunk's verdict bytes and occupancy against the plain path
   at the first-pass and the retry caps, a seeded sample plus grant-derived
   checks against the exact oracle, every kernel launched, and every shape
   the engine dispatched held against the plain versions in phase 2;
5. answer checks over HTTP (``server.rest.make_server``) and compare them
   with ``batch_check``;
6. time every kernel per dispatch shape on the main path's own calls
   (CUDA-graph replay, so the time is the device's and not the host's
   enqueue), its plain version and, where one PyTorch call computes the
   same function, that call; print the kernel JSON line, whose per-launch
   numbers are weighted by the timed run's launches at each shape.

The card's name and power limit (as ``nvidia-smi`` reports them) are
printed before the last line, which is the device JSON object.  The script
imports nothing of JAX and nothing of the ``ketotpu`` package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

Q = 8192  # the served batch bucket = frontier
N_BATCHES = 2
SEED_GRAPH, SEED_KERNEL_QUERIES, SEED_QUERIES, SEED_SAMPLE = 0, 5, 3, 7
SEED_GRANTS = 11
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
ORACLE_SAMPLE = 256

#: per kernel wrapper: CUDA source and the JAX function it replaces
KERNELS = {
    "init_state": ("ketotpu_torch/csrc/pack.cu", "ketotpu/engine/fastpath.py:175"),
    "probe_level": ("ketotpu_torch/csrc/probe.cu", "ketotpu/engine/fastpath.py:204"),
    "arena_assign": ("ketotpu_torch/csrc/arena.cu", "ketotpu/engine/xutil.py:87"),
    "expand_children": ("ketotpu_torch/csrc/children.cu",
                        "ketotpu/engine/fastpath.py:204"),
    "pack_scatter": ("ketotpu_torch/csrc/pack.cu", "ketotpu/engine/fastpath.py:448"),
    "pack_verdicts": ("ketotpu_torch/csrc/pack.cu", "ketotpu/engine/fastpath.py:702"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phase 2: every kernel against its plain version ---------------------------

#: keyword arguments a wrapper writes into (each side gets its own buffer)
OUT_KW = ("occ_out", "out")


def pairs():
    """kernel wrapper name -> (wrapper, plain version): same signature."""
    from ketotpu_torch.engine import fastpath as fp
    from ketotpu_torch.engine import xutil

    return {
        "init_state": (fp.init_state, fp._init_state_plain),
        "probe_level": (fp.probe_level, fp._probe_level_plain),
        "arena_assign": (xutil.arena_assign, xutil._arena_assign_plain),
        "expand_children": (fp.expand_children, fp._expand_children_plain),
        "pack_scatter": (fp._pack_scatter, fp._pack_scatter_plain),
        "pack_verdicts": (fp.pack_verdicts, fp._pack_verdicts_plain),
    }


def flatten(x):
    """The tensors of a wrapper's result, in order (None fields skipped)."""
    import dataclasses

    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return flatten([getattr(x, f.name) for f in dataclasses.fields(x)])
    return [t for item in x for t in flatten(item)]


class Recorder:
    """Runs each wrapper and its plain version on the same CUDA tensors,
    compares every output exactly, and keeps the arguments of every call
    under the tag of the batch it belongs to (the timing phase replays
    them)."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}
        self.calls = {k: [] for k in KERNELS}
        self.tag = None

    def run(self, name, *args, **kw):
        kernel, plain = pairs()[name]
        kw_plain = {k: (v.clone() if k in OUT_KW and v is not None else v)
                    for k, v in kw.items()}
        got = kernel(*args, **kw)
        want = plain(*args, **kw_plain)
        outs = [k for k in OUT_KW if kw.get(k) is not None]
        self.compare(name, flatten(got) + [kw[k] for k in outs],
                     flatten(want) + [kw_plain[k] for k in outs])
        self.calls[name].append((self.tag, args, kw))
        return got

    def shapes(self, dataset):
        """The dispatch shapes this recorder held ``dataset`` at."""
        return {tag[1] for calls in self.calls.values()
                for tag, _a, _k in calls if tag[0] == dataset}

    def compare(self, name, got, want):
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs vs {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(
                    f"{name}[{i}]: {a.dtype}{tuple(a.shape)} vs "
                    f"{b.dtype}{tuple(b.shape)}"
                )
            e = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
            self.err[name] = max(self.err[name], e)
            if e:
                raise AssertionError(f"{name}[{i}]: kernel differs from plain by {e}")


def check_kernels(g, qpack, sched, max_width, rec: Recorder, tag=None):
    """Run one batch level by level on the kernel path, holding every call
    against its plain version (tolerance 0).  Returns the verdict bytes
    and the occupancy, on the host."""
    from ketotpu_torch.engine import fastpath as fp

    rec.tag = tag
    dev = g["row_ptr"].device
    ns_dim, rel_dim = g["f_direct_ok"].shape
    nsb, relb = fp._pack_bits(ns_dim), fp._pack_bits(rel_dim)
    levels = len(sched)
    qp = torch.from_numpy(qpack).to(dev)
    occ = torch.zeros(levels, dtype=torch.int32, device=dev)
    f, qf, qo, qs = rec.run("init_state", qp, frontier=sched[0][0],
                            levels=levels, occ_out=occ[0:1])
    for i, (_fl, a) in enumerate(sched):
        last = i == levels - 1
        qf2, lv = rec.run("probe_level", g, f, qf, qs, probe_only=last)
        if last:
            qf = qf2
            break
        off, _tot, par, ordn = rec.run("arena_assign", lv.counts, a)
        ch, qo2 = rec.run("expand_children", g, f, lv, off, par, ordn, qf2, qo,
                          max_width=max_width)
        f, qo = rec.run("pack_scatter", ch, qf2, qo2, frontier=sched[i + 1][0],
                        nsb=nsb, relb=relb, occ_out=occ[i + 1:i + 2])
        qf = qf2
    out = torch.empty(qp.shape[1], dtype=torch.uint8, device=dev)
    rec.run("pack_verdicts", qf, qo, out=out)
    return out.cpu().numpy(), occ.cpu().numpy()


def schedule(shape, max_depth):
    """The per-level (frontier, arena) sizes of one dispatch shape
    ``(Q, frontier cap, arena cap, boost)``."""
    from ketotpu_torch.engine import fastpath as fp

    q, frontier, arena, boost = shape
    return fp.level_schedule(q, frontier, arena, max_depth, boost)


def shape_name(shape) -> str:
    q, frontier, arena, boost = shape
    return f"Q{q}/F{frontier}/A{arena}/boost{boost}"


def per_dispatch(levels: int):
    """Launches of each kernel in one dispatch of ``levels`` levels."""
    return {"init_state": 1, "probe_level": levels, "arena_assign": levels - 1,
            "expand_children": levels - 1, "pack_scatter": levels - 1,
            "pack_verdicts": 1}


def two_pass(engine, g, chunk, rec: Recorder, dataset: str):
    """One chunk as the engine answers it, level by level through
    :func:`check_kernels`: the first pass at the served caps, then the
    overflowed, not-found rows at ``retry_scale`` x caps.  Returns the
    device verdicts, the mask of rows still over (the oracle's), and
    counts per pass."""
    qpack, err, general = engine.pack_queries(chunk)
    if err.any() or general.any():
        raise AssertionError(f"{dataset}: rows off the tier-1 path")
    n = len(chunk)
    shape = (qpack.shape[1], engine.frontier, engine.arena, 1)
    codes, _occ = check_kernels(g, qpack, schedule(shape, engine.max_depth),
                                engine.max_width, rec, (dataset, shape))
    codes = codes[:n]
    found, over = (codes & 1).astype(bool), ((codes >> 1) & 1).astype(bool)
    allowed, unres = found.copy(), np.zeros(n, bool)
    ri = np.flatnonzero(over & ~found)
    stats = {"found": int(found.sum()), "retried": len(ri), "retry_found": 0}
    if len(ri) and engine.retry_scale > 1:
        rq, _, _ = engine.pack_queries([chunk[i] for i in ri])
        rs = engine.retry_scale
        rshape = (rq.shape[1], rs * engine.frontier, rs * engine.arena, rs)
        rcodes, _ = check_kernels(g, rq, schedule(rshape, engine.max_depth),
                                  engine.max_width, rec, (dataset, rshape))
        rcodes = rcodes[: len(ri)]
        rfound = (rcodes & 1).astype(bool)
        allowed[ri] = rfound
        unres[ri] = ((rcodes >> 1) & 1).astype(bool) & ~rfound
        stats["retry_found"] = int(rfound.sum())
        stats["retry_shape"] = shape_name(rshape)
    elif len(ri):
        unres[ri] = True
    stats["unresolved"] = int(unres.sum())
    stats["shape"] = shape_name(shape)
    return allowed, unres, stats


# -- phase 6: timing ------------------------------------------------------------


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call: captured once in a CUDA graph and
    replayed ``reps`` times between two events (the host's enqueue cost is
    left out; it is timed separately by :func:`host_ms`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: allocator pools and lazily built constants
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Wall time per eager call, enqueue included, synchronized at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_bytes(name, args, kw, g) -> int:
    """The least bytes one call must move: each input column read once,
    each output written once, and for the table probes only the entries
    this call's data gathers (per hash probe one bucket pointer, one key
    pair and the payload; per CSR row its two row pointers; per edge child
    its packed edge word and object)."""
    kc, kt = g["f_css_rel"].shape[2], g["f_ttu_via"].shape[2]
    s = 1 + kc + kt
    item = 5 * 4 + 2  # five int32 columns + two bool columns
    if name == "init_state":
        q = args[0].shape[1]
        return 6 * 4 * q + item * kw["frontier"] + 2 * 4 * q + 4
    if name == "probe_level":
        _g, f, qf, _qs = args
        n, nq = f.qid.shape[0], qf.shape[0]
        live = int(((f.qid >= 0) & (qf[f.qid.clamp(0, nq - 1).long()] == 0)).sum())
        b = item * n + 2 * 4 * nq  # frontier + found bits in and out
        b += 16 * n + 4 * n  # node probe + node column out
        b += 8 * live + 12 * live * (1 + kc)  # query gathers + member probes
        b += 16 * live * kc  # css node probes
        if not kw["probe_only"]:
            b += 16 * n * kt + 8 * live * (1 + kt)  # ttu probes + row degrees
            b += 4 * n * (2 + kt + s)  # exp_deg, counts, ttu_node, seg_cum out
        return b
    if name == "arena_assign":
        n = args[0].shape[0]
        return 4 * n + 4 * n + 4 + 8 * args[1]
    if name == "expand_children":
        f, par, qf = args[1], args[4], args[6]
        n, a, nq = f.qid.shape[0], par.shape[0], qf.shape[0]
        live = int((par >= 0).sum())
        b = 4 * n * (7 + s + kt) + 8 * a  # parent columns once + slot map
        b += live * (4 + 8 + 4)  # row pointer, edge word + object, found bit
        b += item * a + 2 * 4 * nq  # children out + over bits in and out
        return b
    if name == "pack_scatter":
        ch, qf = args[0], args[1]
        a, nq = ch.qid.shape[0], qf.shape[0]
        alive = int((ch.qid >= 0).sum())
        # the scratch dedup table is left out: it fits in L2 (pack.cu)
        b = item * a + 4 * alive  # children + their found bits
        b += item * kw["frontier"] + 2 * 4 * nq + 4  # frontier, over bits, occ
        return b
    if name == "pack_verdicts":
        nq = args[0].shape[0]
        return 2 * 4 * nq + nq
    raise KeyError(name)


#: one PyTorch call that computes the same function, where there is one
LIBRARY = {
    "arena_assign": lambda args, kw: torch.cumsum(args[0], 0, dtype=torch.int32),
}


def time_kernels(g, rec: Recorder, dataset: str):
    """Per kernel, per dispatch shape: device ms per launch, its plain
    version's and the library call's, the byte bound and the host's
    enqueue ms, averaged over ``dataset``'s calls at that shape."""
    rows = {}
    for name, calls in rec.calls.items():
        kernel, plain = pairs()[name]
        by_shape = {}
        for tag, args, kw in calls:
            if tag[0] != dataset:
                continue

            def k(args=args, kw=kw):
                return kernel(*args, **kw)

            def p(args=args, kw=kw):
                return plain(*args, **kw)

            r = by_shape.setdefault(tag[1], {
                "ms": [], "plain_ms": [], "library_ms": [], "host_ms": [],
                "bound_ms": []})
            # plain, kernel, kernel, plain: neither gains from going first
            p0, k0, k1, p1 = device_ms(p), device_ms(k), device_ms(k), device_ms(p)
            r["ms"].append((k0 + k1) / 2)
            r["plain_ms"].append((p0 + p1) / 2)
            r["host_ms"].append(host_ms(k))
            if name in LIBRARY:
                r["library_ms"].append(device_ms(
                    lambda args=args, kw=kw: LIBRARY[name](args, kw)))
            r["bound_ms"].append(
                kernel_bytes(name, args, kw, g) / HBM_BYTES_PER_S * 1e3)
        rows[name] = {
            shape: {key: (float(np.mean(v)) if v else None)
                    for key, v in r.items()} | {"calls": len(r["ms"])}
            for shape, r in by_shape.items()
        }
    return rows


def weighted(per_shape, launches_by_shape, key):
    """A per-launch number over the timed run: each shape's value weighted
    by the launches the main path made at that shape."""
    n = sum(launches_by_shape.values())
    if any(per_shape[s][key] is None for s in launches_by_shape):
        return None
    return sum(per_shape[s][key] * c for s, c in launches_by_shape.items()) / n


# -- phase 4 helpers ------------------------------------------------------------


def known_allowed(graph, n: int, seed: int):
    """Doc#view checks derived from grants in the graph, at several depths:
    a direct viewer or owner of the doc, a viewer or owner of a folder up
    to three hops above it, or a member of a group that views or owns such
    a folder.  Grants deeper than the engine's max depth are denials; the
    exact oracle is the judge of every one."""
    from ketotpu_torch.api.types import RelationQuery, RelationTuple, SubjectID

    rng = np.random.default_rng(seed)
    store = graph.store

    def rows(ns, obj, rel):
        return store.get_relation_tuples(
            RelationQuery(namespace=ns, object=obj, relation=rel))[0]

    out = []
    while len(out) < n:
        d = graph.docs[int(rng.integers(len(graph.docs)))]
        subjects = [t.subject for rel in ("viewers", "owners")
                    for t in rows("Doc", d, rel)]
        folders = [t.subject.object for t in rows("Doc", d, "parents")]
        for _hop in range(3):
            above = []
            for f in folders:
                for t in rows("Folder", f, "viewers") + rows("Folder", f, "owners"):
                    s = t.subject
                    if isinstance(s, SubjectID):
                        subjects.append(s)
                    elif s.namespace == "Group":
                        subjects.extend(m.subject for m in rows(
                            "Group", s.object, "members")[:2])
                above += [t.subject.object for t in rows("Folder", f, "parents")]
            folders = above
        out.extend(RelationTuple("Doc", d, "view", s) for s in subjects[:4]
                   if isinstance(s, SubjectID))
    return out[:n]


def http_check(base: str, route: str, t, method: str):
    q = {"namespace": t.namespace, "object": t.object, "relation": t.relation,
         "subject_id": t.subject.id}
    if method == "GET":
        req = urllib.request.Request(f"{base}{route}?{urllib.parse.urlencode(q)}")
    else:
        req = urllib.request.Request(
            f"{base}{route}", data=json.dumps(q).encode(), method="POST",
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ketotpu_torch import kernels
    from ketotpu_torch.engine import fastpath as fp
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.server.rest import make_server
    from ketotpu_torch.utils.synth import build_synth_columnar, synth_queries

    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[1] build: {len(built)} of {len(kernels.MODULES)} kernel modules "
        f"compiled in {time.perf_counter() - t0:.1f} s")

    # -- main path set-up: graph, projection, upload ------------------------
    t0 = time.perf_counter()
    graph = build_synth_columnar(seed=SEED_GRAPH)
    log(f"[3] synth graph: {len(graph.store)} tuples built in "
        f"{time.perf_counter() - t0:.1f} s (full size, no cut)")
    engine = DeviceCheckEngine(graph.store, graph.manager)
    g = engine.device_tables()
    dev_bytes = sum(t.numel() * t.element_size() for t in g.values())
    log(f"[3] projection {engine.projection_build_s:.2f} s, upload "
        f"{engine.projection_upload_s:.2f} s, check arrays on the card "
        f"{dev_bytes} bytes in {len(g)} tensors")

    # -- 2. every kernel against its plain version --------------------------
    rec = Recorder()
    kernels.reset_launches()
    t0 = time.perf_counter()
    grants = known_allowed(graph, Q // 2, SEED_GRANTS)
    mixed = grants + synth_queries(graph, Q - len(grants), seed=SEED_KERNEL_QUERIES)
    mixed = [mixed[i] for i in np.random.default_rng(SEED_GRANTS).permutation(Q)]
    m_allowed, m_unres, stats = two_pass(engine, g, mixed, rec, "mixed")
    log(f"[2] mixed chunk ({len(grants)} grant-derived + {Q - len(grants)} "
        f"random checks): {stats}")
    if not (stats["found"] and stats["retry_found"]):
        raise AssertionError("the mixed chunk left a pass with no found row")
    n_oracle = 0
    for i, q in enumerate(mixed):
        want = engine.oracle.check_is_member(q)
        if not m_unres[i] and m_allowed[i] != want:
            raise AssertionError(f"{q}: device {m_allowed[i]} oracle {want}")
        n_oracle += want
    log(f"[2] mixed chunk: oracle agrees on all {Q} rows ({n_oracle} allowed, "
        f"{int(m_unres.sum())} left to it) in {time.perf_counter() - t0:.1f} s")
    queries = synth_queries(graph, N_BATCHES * Q, seed=SEED_QUERIES)
    replay = []
    for lo in range(0, len(queries), Q):
        allowed, unres, stats = two_pass(engine, g, queries[lo: lo + Q], rec, "main")
        replay.append((allowed, unres))
        log(f"[2] main-path chunk {lo // Q} replayed: {stats}")
    for name in KERNELS:
        log(f"[2] {name}: {len(rec.calls[name])} calls, kernel == plain "
            f"(max abs err {rec.err[name]}), {kernels.LAUNCHES[name]} launches")

    # -- 3. the main path ------------------------------------------------------
    t0 = time.perf_counter()
    warm = engine.batch_check(queries)
    torch.cuda.synchronize()
    log(f"[3] warm batch_check of {len(queries)}: {time.perf_counter() - t0:.3f} s")
    r0, f0 = engine.retries, engine.fallbacks
    engine.phase_seconds.clear()
    engine.dispatch_shapes.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = engine.batch_check(queries)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = dict(engine.dispatch_shapes)
    phases = {k: round(v * 1e3, 3) for k, v in engine.phase_seconds.items()}
    retries, fallbacks = engine.retries - r0, engine.fallbacks - f0
    more = []
    for _ in range(2):
        t1 = time.perf_counter()
        engine.batch_check(queries)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    log(f"[3] timed batch_check: {len(queries)} checks in {dt:.4f} s = "
        f"{len(queries) / dt:.0f} checks/s (repeats: "
        f"{', '.join(f'{len(queries) / x:.0f}' for x in more)} checks/s); "
        f"allowed {sum(out)}, retried {retries}, oracle fallback "
        f"{fallbacks} ({fallbacks / len(queries):.4%})")
    log(f"[3] launches in the timed run: {launches}")
    log(f"[3] dispatches in the timed run: "
        f"{ {shape_name(k): v for k, v in shapes.items()} }")
    log(f"[3] host ms per phase of the timed run: {phases}")

    # -- 4. main-path checks ---------------------------------------------------
    if out != warm:
        raise AssertionError("timed batch differs from the warm batch")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    unheld = set(shapes) - rec.shapes("main")
    if unheld:
        raise AssertionError(f"dispatched at shapes phase 2 never held: {unheld}")
    levels = engine.max_depth
    by_shape = {name: {s: c * per_dispatch(levels)[name] for s, c in shapes.items()}
                for name in KERNELS}
    for name in KERNELS:
        if sum(by_shape[name].values()) != launches[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"{by_shape[name]} by dispatch shape")
    for (q, frontier, arena, boost) in shapes:
        if boost == 1 and fp.level_schedule(
                q, frontier, arena, levels,
                mults=engine._adaptive_mults()) != schedule(
                    (q, frontier, arena, boost), levels):
            raise AssertionError("the adaptive schedule differs from the replay's")
    for lo, (allowed, unres) in zip(range(0, len(queries), Q), replay):
        got = np.asarray(out[lo: lo + Q])
        if (got[~unres] != allowed[~unres]).any():
            raise AssertionError(f"chunk {lo // Q}: batch_check != phase 2 replay")
    log(f"[4] batch_check verdicts equal the level-by-level replay of phase 2")
    chunk = queries[:Q]
    qpack, _, _ = engine.pack_queries(chunk)
    args = dict(frontier=engine.frontier, arena=engine.arena,
                max_depth=engine.max_depth, max_width=engine.max_width)
    res_k = fp.run_fast_packed(g, qpack, **args)
    res_p = fp.run_fast_packed_plain(g, qpack, **args)
    if not (torch.equal(res_k.codes(), res_p.codes())
            and torch.equal(res_k.occ(), res_p.occ())):
        raise AssertionError("chunk verdicts/occupancy: kernel path != plain path")
    codes, occ = res_k.fetch()
    codes = codes[:Q]
    ri = np.flatnonzero(((codes >> 1) & 1).astype(bool) & ~(codes & 1).astype(bool))
    if not len(ri):
        raise AssertionError("chunk 0 retried no row: the retry caps went unchecked")
    rq, _, _ = engine.pack_queries([chunk[i] for i in ri])
    rs = engine.retry_scale
    rargs = dict(args, frontier=rs * engine.frontier, arena=rs * engine.arena,
                 boost=rs)
    rres_k = fp.run_fast_packed(g, rq, **rargs)
    rres_p = fp.run_fast_packed_plain(g, rq, **rargs)
    if not (torch.equal(rres_k.codes(), rres_p.codes())
            and torch.equal(rres_k.occ(), rres_p.occ())):
        raise AssertionError("retry verdicts/occupancy: kernel path != plain path")
    log(f"[4] chunk 0: {len(codes)} verdict bytes + occupancy {occ.tolist()} "
        f"equal on kernel and plain paths; its {len(ri)} retried rows at "
        f"{rq.shape[1]} x {rs}x caps: verdict bytes + occupancy "
        f"{rres_k.occ().tolist()} equal too (tolerance 0)")
    rng = np.random.default_rng(SEED_SAMPLE)
    sample = rng.choice(len(queries), ORACLE_SAMPLE, replace=False)
    t0 = time.perf_counter()
    for i in sample:
        want = engine.oracle.check_is_member(queries[i])
        if out[i] != want:
            raise AssertionError(f"{queries[i]}: device {out[i]} oracle {want}")
    granted = grants[:64]
    got = engine.batch_check(granted)
    for q, v in zip(granted, got):
        want = engine.oracle.check_is_member(q)
        if v != want:
            raise AssertionError(f"{q}: device {v} oracle {want}")
    if not any(got):
        raise AssertionError("no grant-derived check was allowed")
    log(f"[4] oracle agrees on {ORACLE_SAMPLE} sampled checks and "
        f"{len(granted)} grant-derived checks ({sum(got)} allowed) in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 5. REST ---------------------------------------------------------------
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://%s:%d" % server.server_address[:2]
        allow = granted[int(np.flatnonzero(got)[0])]
        deny = queries[int(np.flatnonzero(~np.asarray(out))[0])]
        n_http = 0
        for t, verdict in ((allow, True), (deny, False)):
            for method in ("GET", "POST"):
                for route, mirror in (("/relation-tuples/check", True),
                                      ("/relation-tuples/check/openapi", False)):
                    status, body = http_check(base, route, t, method)
                    want = 403 if (mirror and not verdict) else 200
                    if status != want or body != {"allowed": verdict}:
                        raise AssertionError(
                            f"{method} {route} {t}: {status} {body}, "
                            f"want {want} allowed={verdict}")
                    n_http += 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    log(f"[5] REST: {n_http} checks answered with the batch_check verdicts "
        f"(200 allowed, 403 denied on the mirror route, 200 on /openapi)")

    # -- 6. timing -------------------------------------------------------------
    rows = time_kernels(g, rec, "main")
    line = []
    busy = 0.0
    for name, (source, replaces) in KERNELS.items():
        per, lb = rows[name], by_shape[name]
        for s, c in lb.items():
            r = per[s]
            busy += r["ms"] * c
            log(f"[6] {name} at {shape_name(s)}: {r['ms']:.4f} ms/launch on the "
                f"card (host enqueue incl. {r['host_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.5f} ms (bytes), {c} launches in the timed run, "
                f"mean of {r['calls']} calls")
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec.err[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"), "bound_by": "bytes",
            "library_ms": weighted(per, lb, "library_ms"),
            "launches_by_shape": {shape_name(s): c for s, c in lb.items()},
            "ms_by_shape": {shape_name(s): per[s]["ms"] for s in lb},
            "plain_ms_by_shape": {shape_name(s): per[s]["plain_ms"] for s in lb},
            "bound_ms_by_shape": {shape_name(s): per[s]["bound_ms"] for s in lb},
        })
    host = [r["host_ms"] for per in rows.values() for r in per.values()]
    log(f"[6] where the timed batch went: {dt * 1e3:.3f} ms wall; kernels "
        f"{busy:.3f} ms, derived (each shape's measured device ms per launch x "
        f"the timed run's launches at that shape; not read from a trace), a "
        f"derived device busy share of {busy / (dt * 1e3):.4f}; host phases "
        f"{phases} ms; host enqueue per wrapper call "
        f"{min(host):.4f}-{max(host):.4f} ms")
    log(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
