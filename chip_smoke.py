#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build the CUDA kernels (tier 1 and the tier-2 algebra) from
   ``ketotpu_torch/csrc`` (one ``nvcc`` per source, all at once) into
   ``build/ketotpu_torch/``;
2. build the 10M-tuple synth graph, project and upload it, then hold every
   tier-1 kernel against its plain PyTorch version on the same CUDA
   tensors (tolerance 0), level by level, at every shape the engine
   dispatches: each chunk's first pass (Q = frontier = 8192, arena =
   16384) and the retry of its overflowed rows (frontier 32768, arena
   65536, boost 4).  This runs on a chunk of which half the checks are
   derived from grants in the graph (its verdicts are held against the
   exact oracle, row for row) and on every chunk of the pure-OR path;
3. serve 2 x 8192 seeded Doc#view checks (the pure-OR path) through
   ``DeviceCheckEngine.batch_check`` (warm, then timed with the launch
   counters reset just before and read just after);
4. check the pure-OR path: its verdicts against the level-by-level replay
   of phase 2, one chunk's verdict bytes and occupancy against the plain
   path at the first-pass and the retry caps, a seeded sample plus
   grant-derived checks against the exact oracle, every kernel launched,
   and every shape the engine dispatched held in phase 2;
5. answer checks over HTTP (``server.rest.make_server``) and compare them
   with ``batch_check``;
6. the mixed path (tier 2): 10,000 rows of ``synth_queries_mixed(seed=9,
   general_frac=0.3)`` (30% Doc#edit = !banned && view, the AND/NOT
   rows), warmed twice (the second run freezes the general program's
   demand-sized shapes), then every tier-2 kernel held against its plain
   version step by step on every chunk's general rows at the engine's
   first-pass shapes and at the retry shapes (the tier-1 kernels of the
   leaf sub-run too), the whole program against the plain program, and
   a mixed chunk of 4,096 grant-derived view + edit rows (edits whose
   subject is banned from the doc among them, so NOT flips an allowed
   view) plus 4,096 random mixed rows, held row for row against the
   oracle; then the mixed batch timed (checks/s, general rows, retries,
   oracle fallbacks, host phases), with every kernel's launches counted
   and checked against the replay's launches per dispatch shape.  No key
   enters the visited set on this traffic, so the tier-2 parity fixture
   (``tests/torch_parity.py``) is dispatched step by step at the first
   pass's and the retry's visited-set sizes, and must insert keys and see
   keys already there;
7. time every kernel per dispatch shape on each path's own calls
   (CUDA-graph replay, so the time is the device's and not the host's
   enqueue; a K7 call runs back to back on clones of the state it found,
   reset outside the timed span), its plain version and, where one
   PyTorch call computes the same function, that call; print the kernel
   JSON line, whose per-launch numbers are weighted by the timed runs'
   launches at each shape.

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
from collections import Counter
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

MIXED_N, SEED_MIXED, GENERAL_FRAC = 10_000, 9, 0.3  # bench.py scale_10m_mixed
SEED_GEN_CHUNK, SEED_GEN_GRANTS = 13, 17
BANNED_SCAN = 200_000  # banned (doc, user) pairs scanned for NOT flips
FORCED_RETRY_ROWS = 256

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


#: the tier-2 (K7) kernel wrappers: CUDA source and the JAX function each
#: replaces
GEN_KERNELS = {
    "gen_classify": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:172"),
    "gen_construct": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:370"),
    "gen_visited": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:320"),
    "gen_collect": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:534"),
    "gen_up": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:825"),
    "gen_pack": ("ketotpu_torch/csrc/algebra.cu", "ketotpu/engine/algebra.py:890"),
}
ALL_KERNELS = (*KERNELS, *GEN_KERNELS)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phases 2 and 6: every kernel against its plain version ---------------------

#: keyword arguments a tier-1 wrapper writes into (each side gets its own buffer)
OUT_KW = ("occ_out", "out")


def pairs():
    """kernel wrapper name -> (wrapper, plain version): same signature."""
    from ketotpu_torch.engine import algebra as alg
    from ketotpu_torch.engine import fastpath as fp
    from ketotpu_torch.engine import xutil

    return {
        "init_state": (fp.init_state, fp._init_state_plain),
        "probe_level": (fp.probe_level, fp._probe_level_plain),
        "arena_assign": (xutil.arena_assign, xutil._arena_assign_plain),
        "expand_children": (fp.expand_children, fp._expand_children_plain),
        "pack_scatter": (fp._pack_scatter, fp._pack_scatter_plain),
        "pack_verdicts": (fp.pack_verdicts, fp._pack_verdicts_plain),
        "gen_classify": (alg.gen_classify, alg._gen_classify_plain),
        "gen_construct": (alg.gen_construct, alg._gen_construct_plain),
        "gen_visited": (alg.gen_visited, alg._gen_visited_plain),
        "gen_collect": (alg.gen_collect, alg._gen_collect_plain),
        "gen_up": (alg.gen_up, alg._gen_up_plain),
        "gen_pack": (alg.gen_pack, alg._gen_pack_plain),
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


def state_index(args):
    """Where a K7 wrapper's ``GenState`` sits among its arguments (None for
    a tier-1 wrapper)."""
    from ketotpu_torch.engine import algebra as alg

    return next((i for i, a in enumerate(args) if isinstance(a, alg.GenState)),
                None)


class Recorder:
    """Runs each wrapper and its plain version on the same CUDA tensors,
    compares every output exactly, and keeps the arguments of every call
    under the tag of the batch it belongs to (the timing phase replays
    them).  A tier-1 wrapper returns its outputs (and writes its ``OUT_KW``
    buffers).  A K7 wrapper updates a ``GenState`` in place: its plain
    version runs on a clone made just before, every tensor of the two
    states is compared (dead slots included), and the call is kept with a
    clone of the state as it found it."""

    def __init__(self):
        self.err = {k: 0 for k in ALL_KERNELS}
        self.calls = {k: [] for k in ALL_KERNELS}
        self.tag = None
        self.dispatches = Counter()  # replayed dispatches per tag

    def run(self, name, *args, **kw):
        kernel, plain = pairs()[name]
        i = state_index(args)
        if i is not None:
            st = args[i]
            before, twin = st.clone(), st.clone()
            kernel(*args, **kw)
            plain(*args[:i], twin, *args[i + 1:], **kw)
            self.compare(name, st.tensors(), twin.tensors())
            self.calls[name].append((self.tag, args[:i] + (before,) + args[i + 1:], kw))
            return None
        kw_plain = {k: (v.clone() if k in OUT_KW and v is not None else v)
                    for k, v in kw.items()}
        got = kernel(*args, **kw)
        want = plain(*args, **kw_plain)
        outs = [k for k in OUT_KW if kw.get(k) is not None]
        self.compare(name, dict(enumerate(flatten(got) + [kw[k] for k in outs])),
                     dict(enumerate(flatten(want) + [kw_plain[k] for k in outs])))
        self.calls[name].append((self.tag, args, kw))
        return got

    def ops(self):
        """The K7 program's steps, its K4 and its sub-run's tier-1 steps
        included, each through :meth:`run`."""
        from ketotpu_torch.engine import algebra as alg
        from ketotpu_torch.engine import fastpath as fp

        def step(name):
            return lambda *a, **k: self.run(name, *a, **k)

        fast = fp._Ops(*(step(n) for n in (
            "init_state", "probe_level", "arena_assign", "expand_children",
            "pack_scatter", "pack_verdicts")))
        return alg._GenOps(*(step(n) for n in (
            "gen_classify", "gen_construct", "gen_visited", "gen_collect",
            "gen_up", "gen_pack", "arena_assign")), fast)

    def shapes(self, dataset):
        """The dispatch shapes this recorder held ``dataset`` at."""
        return {tag[1] for calls in self.calls.values()
                for tag, _a, _k in calls if tag is not None and tag[0] == dataset}

    def compare(self, name, got, want):
        """``got`` and ``want``: label -> tensor."""
        if got.keys() != want.keys():
            raise AssertionError(f"{name}: outputs {list(got)} vs {list(want)}")
        for k, a in got.items():
            b = want[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(
                    f"{name}[{k}]: {a.dtype}{tuple(a.shape)} vs "
                    f"{b.dtype}{tuple(b.shape)}"
                )
            e = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
            self.err[name] = max(self.err[name], e)
            if e:
                raise AssertionError(f"{name}[{k}]: kernel differs from plain by {e}")


def check_kernels(g, qpack, sched, max_width, rec: Recorder, tag=None):
    """Run one batch level by level on the kernel path, holding every call
    against its plain version (tolerance 0).  Returns the verdict bytes
    and the occupancy, on the host."""
    from ketotpu_torch.engine import fastpath as fp

    rec.tag = tag
    rec.dispatches[tag] += 1
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


def _level_live(st, level: int, col: str = "qid") -> int:
    from ketotpu_torch.engine import algebra as alg

    lo, n = st.span(level)
    return int((st.tasks[alg.TI[col], lo:lo + n] >= 0).sum())


def shape_name(shape) -> str:
    if shape[0] == "gen":
        _, q, boost, (sizes, fast_b, fast_sched, vcap) = shape
        return (f"general/Q{q}/D{len(sizes)}/T{q + sum(sizes)}/B{fast_b}/"
                f"S{len(fast_sched)}/V{vcap}/boost{boost}")
    q, frontier, arena, boost = shape
    return f"Q{q}/F{frontier}/A{arena}/boost{boost}"


def expected_launches(calls, dispatches, dataset, shapes):
    """Per kernel, per dispatch shape: the launches the engine made at that
    shape (``shapes``: dispatches per shape), from the replay's calls per
    replayed dispatch of the same shape.  Raises for a shape never held."""
    out = {}
    for name, cs in calls.items():
        per = Counter(c[0] for c in cs if c[0] is not None and c[0][0] == dataset)
        out[name] = {}
        for shape, count in shapes.items():
            n_disp = dispatches[(dataset, shape)]
            if not n_disp:
                raise AssertionError(
                    f"dispatched at {shape_name(shape)}, never held")
            k = per[(dataset, shape)]
            if k % n_disp:
                raise AssertionError(f"{name}: {k} calls over {n_disp} dispatches")
            if k:
                out[name][shape] = count * k // n_disp
    return out


def two_pass(engine, g, chunk, rec: Recorder, dataset: str,
             allow_general: bool = False):
    """One chunk's tier-1 rows as the engine answers them, level by level
    through :func:`check_kernels`: the first pass at the served caps, then
    the overflowed, not-found rows at ``retry_scale`` x caps.  Returns the
    device verdicts, the mask of rows still over (the oracle's), and
    counts per pass (general rows, where allowed, are inactive here)."""
    qpack, err, general = engine.pack_queries(chunk)
    if err.any() or (general.any() and not allow_general):
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


# -- phase 6: the tier-2 program step by step ----------------------------------


def gen_key(qpack, boost: int, sched):
    return ("gen", qpack.shape[1], boost, sched)


def check_general(g, qpack, sched, max_width, rec: Recorder, tag):
    """One general dispatch step by step on the kernel path, every K7 call
    held against its plain version (and K4 and the sub-run's tier-1 calls
    against theirs), then the verdict codes and occupancy against the
    plain program's.  Returns (codes, occ) on the host."""
    from ketotpu_torch.engine import algebra as alg

    rec.tag = tag
    rec.dispatches[tag] += 1
    sizes, fast_b, fast_sched, vcap = sched
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched,
              max_width=max_width, vcap=vcap)
    res, _st = alg._run_general(rec.ops(), g, qpack, sizes, fast_b, fast_sched,
                                max_width, vcap)
    plain = alg.run_general_packed_plain(g, qpack, **kw)
    if not (torch.equal(res.codes(), plain.codes())
            and torch.equal(res.occ(), plain.occ())):
        bad = (res.codes() != plain.codes()).nonzero().flatten()[:8].tolist()
        raise AssertionError(
            f"{shape_name(tag[1])}: kernel program != plain program (codes "
            f"differ at {bad}; occ {res.occ().tolist()} vs {plain.occ().tolist()})")
    return res.fetch()


def replay_general(engine, g, chunk, rec: Recorder, dataset: str):
    """One chunk's general rows as the engine answers them, step by step
    through :func:`check_general`: the first pass at the engine's shape,
    then the overflowed rows at ``retry_scale`` x caps.  When no row
    overflows, the retry shapes are held anyway on the first
    ``FORCED_RETRY_ROWS`` general rows (tagged ``dataset + "-forced"``, so
    they never count as the engine's).  Returns (general row indices,
    allowed, fallback mask of those rows, stats)."""
    enc, gi = engine.encode_general(chunk)
    stats = {"general": len(gi)}
    if not len(gi):
        return gi, np.zeros(0, bool), np.zeros(0, bool), stats
    qpack, sched = engine.pack_general(enc, gi)
    key = gen_key(qpack, 1, sched)
    codes, _occ = check_general(g, qpack, sched, engine.max_width, rec,
                                (dataset, key))
    codes = codes[: len(gi)]
    res = codes & 3
    over = ((codes >> 2) & 1).astype(bool)
    dirty = ((codes >> 3) & 1).astype(bool)
    allowed = res == 1
    unres = over & ~dirty & (res != 3)
    stats.update(shape=shape_name(key), allowed=int(allowed.sum()),
                 over=int(over.sum()))
    rs = engine.retry_scale
    if unres.any():
        ri = np.flatnonzero(unres)
        rq, rsched = engine.pack_general(enc, gi[ri], boost=rs)
        rkey = gen_key(rq, rs, rsched)
        rcodes, _ = check_general(g, rq, rsched, engine.max_width, rec,
                                  (dataset, rkey))
        rcodes = rcodes[: len(ri)]
        allowed[ri] = (rcodes & 3) == 1
        over[ri] = (((rcodes >> 2) | (rcodes >> 3)) & 1).astype(bool) \
            | ((rcodes & 3) == 3)
        res[ri] = rcodes & 3
        stats.update(retried=len(ri), retry_shape=shape_name(rkey))
    else:
        fi = np.arange(min(FORCED_RETRY_ROWS, len(gi)))
        rq, rsched = engine.pack_general(enc, gi[fi], boost=rs)
        rkey = gen_key(rq, rs, rsched)
        rcodes, _ = check_general(g, rq, rsched, engine.max_width, rec,
                                  (dataset + "-forced", rkey))
        same = (rcodes[: len(fi)] & 3) == res[fi]
        if not same[~over[fi]].all():
            raise AssertionError("retry caps changed a first-pass verdict")
        stats.update(retried=0, forced_retry_shape=shape_name(rkey))
    return gi, allowed, over | dirty | (res == 3), stats


def not_flips(graph, engine, limit: int):
    """(Doc#view, Doc#edit) pairs whose subject is banned from the doc yet
    may view it, so that ``edit = !banned && view`` is NOT-flipped to a
    denial: the first ``limit`` banned tuples of the graph, their view
    checks answered on the card, the allowed ones kept."""
    from ketotpu_torch.api.types import RelationTuple, SubjectID

    cols, alive, _tail, _head = graph.store.export_columns()
    v = graph.store.vocab
    m = (np.asarray(alive, bool) & (cols["ns"] == v.namespaces.lookup("Doc"))
         & (cols["rel"] == v.relations.lookup("banned")) & (cols["is_set"] == 0))
    idx = np.flatnonzero(m)[:limit]
    objs, subs = v.objects.strings(), v.subjects.strings()
    views = [RelationTuple("Doc", objs[o], "view", SubjectID(subs[s][3:]))
             for o, s in zip(cols["obj"][idx], cols["subj"][idx])]
    got = engine.batch_check(views)
    return [(t, RelationTuple("Doc", t.object, "edit", t.subject))
            for t, ok in zip(views, got) if ok]


def fixture_engine():
    """An engine over the tier-2 parity fixture of ``tests/torch_parity.py``
    (AND / NOT permits, a NOT chain, subject sets into AND/NOT permits that
    enter the visited set, a deep tainted recursion) and its query batches,
    by name."""
    import os

    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.opl.parser import parse
    from ketotpu_torch.storage.memory import InMemoryTupleStore
    from ketotpu_torch.storage.namespaces import StaticNamespaceManager

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from torch_parity import ALGEBRA_BATCHES, ALGEBRA_OPL, algebra_tuples

    namespaces, errs = parse(ALGEBRA_OPL)
    if errs:
        raise AssertionError(f"fixture namespaces: {errs}")
    store = InMemoryTupleStore()
    store.write_relation_tuples(
        *[RelationTuple.from_string(s) for s in algebra_tuples()])
    batches = {name: [RelationTuple.from_string(s) for s in batch]
               for name, batch in ALGEBRA_BATCHES.items()}
    return DeviceCheckEngine(store, StaticNamespaceManager(namespaces)), batches


def visited_counts(st, level: int):
    """(keys, inserted, seen, pending) of the visited set over one
    constructed level, from the plain ``_visited`` on the state as
    ``gen_visited`` found it: the keys that enter it, those it inserts,
    those already in it (or duplicated in the level) and those that found
    no slot."""
    from ketotpu_torch.engine import algebra as alg

    _lo, a = st.span(level)
    t = st.task_dict(level)
    evc = st.aux_dict(level)["evc"]
    _v, seen, pend = alg._visited(tuple(st.vset), t["vscope"], t["ns"], t["obj"],
                                  t["rel"], evc, a)
    keys, seen, pend = int(evc.sum()), int(seen.sum()), int(pend.sum())
    return keys, keys - seen - pend, seen, pend


# -- phase 7: timing ------------------------------------------------------------


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call that leaves its inputs as they
    were: captured once in a CUDA graph and replayed ``reps`` times between
    two events (the host's enqueue cost is left out; it is timed separately
    by :func:`host_ms`)."""
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


#: clones of the state per timed replay of a K7 call, and timed replays
STATE_COPIES, STATE_ROUNDS = 16, 5
#: device clock cycles the card spins before a timed replay (about 0.5 ms)
HOLD_CYCLES = 1_000_000


def state_ms(call, before):
    """Times of one ``call(state)`` that updates a ``GenState`` in place,
    from the state ``before`` it ran: one CUDA graph runs it back to back
    on ``STATE_COPIES`` clones of that state, and every clone is reset
    before each of ``STATE_ROUNDS`` replays, outside the timed span (no
    subtraction), the card held busy while the host submits the replay.  Returns (device ms per call: the median of the replays,
    their spread max - min, host ms per eager call on the clones with the
    device's time included)."""
    works = [before.clone() for _ in range(STATE_COPIES)]
    src = before.tensors()

    def reset():
        for w in works:
            for k, t in w.tensors().items():
                t.copy_(src[k])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(works[0])  # warm: allocator pools and lazily built constants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for w in works:
            call(w)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(STATE_ROUNDS):
        reset()
        # keep the card busy while the host submits the graph, so that the
        # span between the events holds no wait for the host
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        per.append(e0.elapsed_time(e1) / STATE_COPIES)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in works:
        call(w)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / STATE_COPIES
    return float(np.median(per)), max(per) - min(per), host


def kernel_bytes(name, args, kw, g) -> int:
    """The least bytes one call must move: each input column read once,
    each output written once, and for the table probes only the entries
    this call's data gathers (per hash probe one bucket pointer, one key
    pair and the payload; per CSR row its two row pointers; per edge child
    its packed edge word and object).  A K7 call counts from the state it
    found; the small program and routing tables (kilobytes, L2-resident)
    are left out."""
    from ketotpu_torch.engine import algebra as alg

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
    st = args[state_index(args)]
    t = st.tasks
    if name == "gen_classify":
        level = args[2]
        _lo, n = st.span(level)
        qp = kw.get("qpack")
        if qp is not None:
            # qpack's ns, obj, rel, depth and active rows in (the subject
            # row is gathered per live root below); the twelve columns of a
            # root written, then the eighteen classification writes, two of
            # them (kind, prog) the same columns
            live = int((qp[5] != 0).sum())
            b = n * 4 * (5 + 12 + 18 - 2)
        else:
            # kind, ns, obj, rel, d, skip, force, prog, qid in; eight task
            # and ten aux columns out
            live = _level_live(st, level)
            b = n * 4 * (9 + 18)
        b += live * (4 + 16 + 12 + 8 + 16) + 4  # subject, probes, degree, occ
        return b
    if name == "gen_construct":
        level, par = args[2], args[4]
        _lo, n = st.span(level)
        _clo, a = st.span(level + 1)
        live = int((par >= 0).sum())
        # per parent: offsets and acount in, resolved / res / nchild out, and
        # the fourteen fields its children read (qid, kind, ns, obj, rel, d,
        # vscope; pk, r0, pp, node, node_ttu, deg, prog_root)
        b = n * 4 * (2 + 3 + 14)
        b += a * 4 * 2 + a * 4 * 13  # slot map in, child columns + flag out
        b += live * (8 + 4)  # edge word + object, row pointer
        return b
    if name == "gen_visited":
        level = args[1]
        _lo, a = st.span(level)
        keys, inserted, seen, pend = visited_counts(st, level)
        # the flag column; per key its four words and its slot's four read,
        # per inserted key the slot written, per seen or pending key its
        # kind and depth written
        return a * 4 + keys * (16 + 16) + inserted * 16 + (seen + pend) * 8
    if name == "gen_collect":
        tot = t.shape[1]
        b_ = st.leaves.qid.shape[0]
        m = ((t[alg.TI["kind"]] == alg.K_FAST) & (t[alg.TI["qid"]] >= 0)
             & (t[alg.TI["resolved"]] == 0))
        leaves = int(m.sum())
        placed = min(leaves, b_)
        b = tot * 4 * 3  # kind, qid, resolved
        b += b_ * (5 * 4 + 2 + 4)  # the leaf buffer + subjects out
        # per placed leaf: ns, obj, rel, d, skip, force in, its subject
        # gathered, its slot id out; per dropped leaf: resolved, res out
        b += placed * (6 * 4 + 4 + 4) + (leaves - placed) * 8
        return b
    if name == "gen_up":
        level = args[1]
        lo, n = st.span(level)
        # thirteen columns in (qid, fast_id, res, resolved, d, three counts,
        # cop, nchild, seed, neg, parent), res and resolved out, per leaf
        # its found and over bits; the parents that receive a count get
        # their three count columns written
        leaves = int((t[alg.TI["fast_id"], lo:lo + n] >= 0).sum())
        par = t[alg.TI["parent"], lo:lo + n][t[alg.TI["qid"], lo:lo + n] >= 0]
        touched = int(torch.unique(par).numel()) if level else 0
        return n * 4 * (13 + 2) + leaves * 8 + touched * 12
    if name == "gen_pack":
        return st.q * (4 + 4 + 4 + 1)
    raise KeyError(name)


#: one PyTorch call that computes the same function, where there is one
LIBRARY = {
    "arena_assign": lambda args, kw: torch.cumsum(args[0], 0, dtype=torch.int32),
}


def time_kernels(g, rec: Recorder, dataset: str, names=ALL_KERNELS):
    """Per kernel of ``names``, per dispatch shape: device ms per launch,
    its plain version's and the library call's, the byte bound and the
    host's ms per eager call, averaged over ``dataset``'s calls at that
    shape.  A tier-1 call is replayed as it was (:func:`device_ms`); a K7
    call restarts from the state it found (:func:`state_ms`), and
    ``spread_ms`` is the largest spread of its replays."""
    rows = {}
    for name in names:
        kernel, plain = pairs()[name]
        by_shape = {}
        for tag, args, kw in rec.calls[name]:
            if tag is None or tag[0] != dataset:
                continue
            r = by_shape.setdefault(tag[1], {
                "ms": [], "plain_ms": [], "library_ms": [], "host_ms": [],
                "bound_ms": [], "spread_ms": []})
            i = state_index(args)
            # plain, kernel, kernel, plain: neither gains from going first
            if i is None:
                def k(args=args, kw=kw):
                    return kernel(*args, **kw)

                def p(args=args, kw=kw):
                    return plain(*args, **kw)

                p0, k0, k1, p1 = device_ms(p), device_ms(k), device_ms(k), device_ms(p)
                r["host_ms"].append(host_ms(k))
            else:
                def on(fn, args=args, kw=kw, i=i):
                    return lambda st: fn(*args[:i], st, *args[i + 1:], **kw)

                (p0, _, _), (k0, s0, h0), (k1, s1, _), (p1, _, _) = (
                    state_ms(on(plain), args[i]), state_ms(on(kernel), args[i]),
                    state_ms(on(kernel), args[i]), state_ms(on(plain), args[i]))
                r["host_ms"].append(h0)
                r["spread_ms"].append(max(s0, s1))
            r["ms"].append((k0 + k1) / 2)
            r["plain_ms"].append((p0 + p1) / 2)
            if name in LIBRARY:
                r["library_ms"].append(device_ms(
                    lambda args=args, kw=kw: LIBRARY[name](args, kw)))
            r["bound_ms"].append(
                kernel_bytes(name, args, kw, g) / HBM_BYTES_PER_S * 1e3)
        rows[name] = {
            shape: {key: (float(np.max(v) if key == "spread_ms" else np.mean(v))
                          if v else None)
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
    missing = [k for k in KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the pure-OR path: {missing}")
    unheld = set(shapes) - rec.shapes("main")
    if unheld:
        raise AssertionError(f"dispatched at shapes phase 2 never held: {unheld}")
    levels = engine.max_depth
    by_shape = expected_launches(rec.calls, rec.dispatches, "main", shapes)
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

    # -- 6. the mixed path: general (AND/NOT) rows on tier 2 --------------------
    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.utils.synth import synth_queries_mixed

    mb = engine.max_batch
    mixed_q = synth_queries_mixed(graph, MIXED_N, seed=SEED_MIXED,
                                  general_frac=GENERAL_FRAC)
    t0 = time.perf_counter()
    w1 = engine.batch_check(mixed_q)
    w2 = engine.batch_check(mixed_q)
    torch.cuda.synchronize()
    if w1 != w2:
        raise AssertionError("the mixed batch changed between warm runs")
    frozen = {f"Q{q}/boost{b}": shape_name(("gen", q, b, sch))
              for (q, b), sch in engine._gen_sched_cache.items()}
    log(f"[6] mixed path warmed twice in {time.perf_counter() - t0:.2f} s; "
        f"frozen general shapes {frozen}")
    t0 = time.perf_counter()
    mreplay = []
    for lo in range(0, MIXED_N, mb):
        chunk = mixed_q[lo: lo + mb]
        gi, g_allowed, g_fb, gstats = replay_general(engine, g, chunk, rec,
                                                     "mixed-main")
        f_allowed, f_unres, fstats = two_pass(engine, g, chunk, rec, "mixed-main",
                                              allow_general=True)
        mreplay.append((gi, g_allowed, g_fb, f_allowed, f_unres))
        log(f"[6] mixed-path chunk {lo // mb} replayed: general {gstats}; "
            f"tier 1 {fstats}")
    r0, f0 = engine.retries, engine.fallbacks
    gr0, grr0 = engine.general_rows, engine.general_retries
    engine.phase_seconds.clear()
    engine.dispatch_shapes.clear()
    engine.general_shapes.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mout = engine.batch_check(mixed_q)
    torch.cuda.synchronize()
    mdt = time.perf_counter() - t0
    mlaunches = dict(kernels.LAUNCHES)
    mshapes = dict(engine.dispatch_shapes)
    mshapes.update({("gen", q, b, sch): c
                    for (q, b, sch), c in engine.general_shapes.items()})
    mphases = {k: round(v * 1e3, 3) for k, v in engine.phase_seconds.items()}
    mretries, mfallbacks = engine.retries - r0, engine.fallbacks - f0
    grows, gretries = engine.general_rows - gr0, engine.general_retries - grr0
    more = []
    for _ in range(2):
        t1 = time.perf_counter()
        engine.batch_check(mixed_q)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    log(f"[6] timed mixed batch_check: {MIXED_N} checks in {mdt:.4f} s = "
        f"{MIXED_N / mdt:.0f} checks/s (repeats: "
        f"{', '.join(f'{MIXED_N / x:.0f}' for x in more)} checks/s); allowed "
        f"{sum(mout)}; general rows {grows}, general retries {gretries}, all "
        f"retries {mretries}, oracle fallbacks {mfallbacks} "
        f"({mfallbacks / MIXED_N:.4%})")
    log(f"[6] launches in the timed mixed run: {mlaunches}")
    log(f"[6] dispatches in the timed mixed run: "
        f"{ {shape_name(k): v for k, v in mshapes.items()} }")
    log(f"[6] host ms per phase of the timed mixed run: {mphases}")
    if mout != w2:
        raise AssertionError("timed mixed batch differs from the warm batch")
    missing = [k for k, n in mlaunches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mixed path: {missing}")
    for shape in mshapes:
        if shape[0] != "gen" and shape[3] == 1 and fp.level_schedule(
                *shape[:3], levels, mults=engine._adaptive_mults()) != schedule(
                    shape, levels):
            raise AssertionError("the adaptive schedule differs from the replay's")
    mby_shape = expected_launches(rec.calls, rec.dispatches, "mixed-main", mshapes)
    for name in ALL_KERNELS:
        if sum(mby_shape[name].values()) != mlaunches[name]:
            raise AssertionError(f"{name}: {mlaunches[name]} launches on the "
                                 f"mixed path, {mby_shape[name]} by dispatch shape")
    for lo, (gi, g_allowed, g_fb, f_allowed, f_unres) in zip(
            range(0, MIXED_N, mb), mreplay):
        got = np.asarray(mout[lo: lo + mb])
        fast = np.ones(len(got), bool)
        fast[gi] = False
        if (got[gi][~g_fb] != g_allowed[~g_fb]).any() or \
                (got[fast & ~f_unres] != f_allowed[fast & ~f_unres]).any():
            raise AssertionError(f"mixed chunk {lo // mb}: batch_check != replay")
    t0 = time.perf_counter()
    for i in np.random.default_rng(SEED_SAMPLE).choice(MIXED_N, ORACLE_SAMPLE,
                                                        replace=False):
        want = engine.oracle.check_is_member(mixed_q[i])
        if mout[i] != want:
            raise AssertionError(f"{mixed_q[i]}: device {mout[i]} oracle {want}")
    log(f"[6] mixed path: verdicts equal the step-by-step replay; launches per "
        f"kernel equal the replay's per dispatch shape; oracle agrees on "
        f"{ORACLE_SAMPLE} sampled rows ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    flips = not_flips(graph, engine, BANNED_SCAN)
    nf = min(len(flips), 256)
    grants2 = known_allowed(graph, Q // 4, SEED_GEN_GRANTS)
    gen_rows = [t for pair in flips[:nf] for t in pair]
    for t in grants2:
        gen_rows += [t, RelationTuple("Doc", t.object, "edit", t.subject)]
    gen_rows = gen_rows[: Q // 2]
    n_derived = len(gen_rows)
    gen_rows += synth_queries_mixed(graph, Q - n_derived, seed=SEED_GEN_CHUNK,
                                    general_frac=GENERAL_FRAC)
    gen_rows = [gen_rows[i] for i in np.random.default_rng(SEED_GEN_CHUNK).permutation(Q)]
    gi, g_allowed, g_fb, gstats = replay_general(engine, g, gen_rows, rec,
                                                 "mixed-chunk")
    got = engine.batch_check(gen_rows)
    if (np.asarray(got)[gi][~g_fb] != g_allowed[~g_fb]).any():
        raise AssertionError("mixed chunk: batch_check != the step-by-step replay")
    n_allowed = n_edit_allowed = 0
    for i, q in enumerate(gen_rows):
        want = engine.oracle.check_is_member(q)
        if got[i] != want:
            raise AssertionError(f"{q}: device {got[i]} oracle {want}")
        n_allowed += want
        n_edit_allowed += want and q.relation == "edit"
    flipped = 0
    for view, edit in flips[:nf]:
        if not (engine.oracle.check_is_member(view)
                and not engine.oracle.check_is_member(edit)):
            raise AssertionError(f"{edit}: not a NOT flip")
        flipped += 1
    if not (n_edit_allowed and flipped):
        raise AssertionError("the mixed chunk lacks allowed edits or NOT flips")
    log(f"[6] mixed chunk ({n_derived} grant-derived view + edit rows, "
        f"{2 * flipped} of them banned-subject pairs, + {Q - n_derived} random "
        f"mixed rows): general {gstats}; oracle agrees on all {Q} rows "
        f"({n_allowed} allowed, {n_edit_allowed} of them edits; {flipped} edits "
        f"NOT-flipped from an allowed view; {len(flips)} flips in the first "
        f"{BANNED_SCAN} banned pairs) in {time.perf_counter() - t0:.1f} s")

    # no key enters the visited set on the mixed traffic: the tier-2 parity
    # fixture gives gen_visited real work, at the first pass's and the
    # retry's visited-set sizes (tagged apart from the main path)
    from ketotpu_torch.engine import algebra as alg

    # (the flood batch, built to overflow small caps, would push the
    # duplicate keys past the first pass's arena)
    t0 = time.perf_counter()
    feng, fbatches = fixture_engine()
    frows = [t for name, b in fbatches.items() if name != "flood" for t in b]
    fg = feng.device_tables()
    fenc, fgi = feng.encode_general(frows)
    for boost in (1, feng.retry_scale):
        fq, fsched = feng.pack_general(fenc, fgi, boost)
        tag = ("visited-fixture", gen_key(fq, boost, fsched))
        check_general(fg, fq, fsched, feng.max_width, rec, tag)
        work = np.sum([visited_counts(a[0], a[1])
                       for t, a, _k in rec.calls["gen_visited"] if t == tag], axis=0)
        keys, inserted, seen, pend = (int(x) for x in work)
        if not (inserted and seen):
            raise AssertionError(f"{shape_name(tag[1])}: the visited set got "
                                 f"{inserted} inserts and {seen} seen keys")
        log(f"[6] tier-2 fixture ({len(fgi)} general rows) at "
            f"{shape_name(tag[1])}, visited set of {alg._vs_size(fsched[3])} "
            f"slots: {keys} keys, {inserted} inserted, {seen} seen, {pend} "
            f"pending; every kernel == plain ({time.perf_counter() - t0:.1f} s)")
    for name in GEN_KERNELS:
        log(f"[6] {name}: {len(rec.calls[name])} calls, kernel == plain "
            f"(max abs err {rec.err[name]}, whole state compared)")

    # -- 7. timing -------------------------------------------------------------
    rows = time_kernels(g, rec, "main", KERNELS)
    mrows = time_kernels(g, rec, "mixed-main")
    forced = time_kernels(g, rec, "mixed-main-forced", GEN_KERNELS)
    line = []
    busy = mbusy = 0.0
    for name, (source, replaces) in KERNELS.items():
        per, lb = rows[name], by_shape[name]
        mper, mlb = mrows[name], mby_shape[name]
        for s, c in lb.items():
            r = per[s]
            busy += r["ms"] * c
            log(f"[7] {name} at {shape_name(s)}: {r['ms']:.4f} ms/launch on the "
                f"card (host enqueue incl. {r['host_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.5f} ms (bytes), {c} launches in the timed "
                f"pure-OR run, mean of {r['calls']} calls")
        for s, c in mlb.items():
            mbusy += mper[s]["ms"] * c
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
            "mixed_path": {
                "launches": mlaunches[name],
                "ms": weighted(mper, mlb, "ms"),
                "bound_ms": weighted(mper, mlb, "bound_ms"),
                "launches_by_shape": {shape_name(s): c for s, c in mlb.items()},
                "ms_by_shape": {shape_name(s): mper[s]["ms"] for s in mlb},
            },
        })
    for name, (source, replaces) in GEN_KERNELS.items():
        per, lb = mrows[name], mby_shape[name]
        every = {**per, **forced[name]}
        for s, r in every.items():
            c = lb.get(s, 0)
            mbusy += r["ms"] * c
            log(f"[7] {name} at {shape_name(s)}: {r['ms']:.4f} ms/launch on the "
                f"card (replay spread up to {r['spread_ms']:.4f} ms; host "
                f"{r['host_ms']:.4f} ms per eager call), plain "
                f"{r['plain_ms']:.4f} ms, library none, bound {r['bound_ms']:.5f} "
                f"ms (bytes), {c} launches in the timed mixed run, mean of "
                f"{r['calls']} calls")
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": mlaunches[name], "max_abs_err": rec.err[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"), "bound_by": "bytes",
            "library_ms": None,
            "launches_by_shape": {shape_name(s): c for s, c in lb.items()},
            "ms_by_shape": {shape_name(s): r["ms"] for s, r in every.items()},
            "plain_ms_by_shape": {shape_name(s): r["plain_ms"]
                                  for s, r in every.items()},
            "bound_ms_by_shape": {shape_name(s): r["bound_ms"]
                                  for s, r in every.items()},
            "spread_ms_by_shape": {shape_name(s): r["spread_ms"]
                                   for s, r in every.items()},
        })
    host = [r["host_ms"] for per in rows.values() for r in per.values()]
    log(f"[7] where the timed pure-OR batch went: {dt * 1e3:.3f} ms wall; kernels "
        f"{busy:.3f} ms, derived (each shape's measured device ms per launch x "
        f"the timed run's launches at that shape; not read from a trace), a "
        f"derived device busy share of {busy / (dt * 1e3):.4f}; host phases "
        f"{phases} ms; host enqueue per wrapper call "
        f"{min(host):.4f}-{max(host):.4f} ms")
    log(f"[7] where the timed mixed batch went: {mdt * 1e3:.3f} ms wall; kernels "
        f"{mbusy:.3f} ms, derived the same way, a derived device busy share of "
        f"{mbusy / (mdt * 1e3):.4f}; host phases {mphases} ms")
    log(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
