#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-only   # phase 16 alone, on every card

Phases, in order; any failure raises and exits non-zero:

1. build the CUDA kernels (tier 0, tier 1, the tier-2 algebra, the
   fused wave, the Expand walk, the mesh, the radix sort and the binary
   search) from
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
7. path A, the membership deployment: a second engine over the same graph,
   ``fused_dispatch`` on and Leopard on with ``max_pairs`` 2^25 (the 10M
   graph's closure has about 19M element pairs); 16,384 seeded
   ``Group:g#members@User`` checks (direct members, parents of nested
   groups with a member of the child, random pairs) timed through
   ``batch_check``, every verdict held against the oracle, every wave
   replayed with its four kernels held against their plain versions and
   its whole int32 output against the plain wave;
8. path B: the mixed traffic of phase 6 through the fused wave with
   Leopard on, its verdicts equal to phase 6's row for row, one
   device-to-host copy per wave;
9. path C: the membership traffic through the unfused cascade with
   Leopard on, where the K6 probe launches on its own (once per chunk);
10. path D: the deep-groups fixture (chains of 12 nested groups) at
   ``max_depth`` 16, answered at tier 0, and at rest depth 10, where the
   too-deep hits go to tier 1 in the same wave; plus one wave with
   hand-set probe modes;
11. time every kernel per dispatch shape on each path's own calls
   (CUDA-graph replay, so the time is the device's and not the host's
   enqueue; a K7 call runs back to back on clones of the state it found,
   reset outside the timed span; a K6 or wave kernel call runs back to
   back on its own inputs, which it does not change), its plain version
   and, where one PyTorch call computes the same function, that call;
   time one whole wave per fused path on the card, with and without its
   retry lanes; count the device operations of one ``arena_assign`` call
   per shape with ``torch.profiler`` (one launch; more fails the run);
   time ``arena_assign`` (and ``lex_sort`` in phases 15 and 16) also as
   graphs of back-to-back calls beside its library call; print the kernel
   JSON line, whose per-launch numbers are weighted by the timed runs'
   launches at each shape;
12. the write path on path A's engine (fused, Leopard on, the served
   defaults; every check table carries the delta overlay, empty until the
   first write): (a) memberships added to nested groups and base
   memberships deleted, then the added ones removed; (b) a new Doc, a
   virtual node; (c) a group nested in another, a dirty row; each served
   by the overlay with no re-projection; (d) a burst of 4,200 memberships,
   past the overlay's 4,096 pairs, folded into the base with the device
   shapes unchanged.  After each write one ``batch_check`` of the rows it
   touched plus 256 sampled rows, every verdict against the oracle, the
   tier and the closure index's outcome (apply or rebuild) against the
   expected ones, the write-to-verdict wall split into its steps, and on
   the tables that check read every tier-1, tier-2 and wave kernel held
   against its plain version (the overlay's branches and dirty bits);
   after (c), and again after (d), ``batch_expand`` of the subject sets
   the writes touched (a1's groups, b's virtual Doc, c's dirty group, 64
   of d's groups), the trees against the oracle's on the live store and
   the Expand kernels against their plain versions on the served tables;
   then the ``ov_dirty`` upload, a full re-projection plus closure build
   for comparison, and the overlay kernels timed on (c)'s tables (the
   kernel line's ``overlay_path``);
13. Expand on path A's engine (``bench.py:934-982``): 512 ``Doc#parents``
   roots drawn with ``default_rng(11)`` at depth 5, the expand-only
   upload, a warm batch, then timed batches (trees/s, oracle fallbacks,
   host ms per phase, launches per batch, the schedule) with the launch
   counters reset just before each; 20 single-root calls (p50, p99); the
   walk step by step with ``expand_roots`` / ``expand_level`` (and K4)
   held against their plain versions at every shape the timed runs used,
   and whole (every level record and ``over``); 64 sampled trees and 128
   ``Group#members`` / ``Folder#viewers`` trees against the oracle's (a
   group has about 48 members, past the default fan-out 16: the over
   roots go to the oracle; their walk at 4x fan-out and cap, as a retry
   on the card would run it, is held too, its trees against the oracle's
   and its time against the oracle's, alternated); a cap at which the
   walk overflows, where exactly the over roots go to the oracle; then
   both kernels timed as in phase 11 (no library call), on the
   Doc#parents walk and on the wide one (the kernel line's
   ``wide_path``);
14. the graph-sharded mesh (K10) at n = 1 and n = 4 shards of the card
   (``mesh_phase``): both traffics, every kernel held step by step,
   verdicts against the single-device engine's, writes and Expand
   through the replica, the mesh kernels timed;
15. the tenant plane (``tenant_phase``): 8,192 networks of Keto's ``nid``
   multi-tenancy (``tenancy/``) over a ~10.6M-tuple store of qualified
   tuples (namespace dim 65,536), so every frontier of a batch of more
   than 2,048 rows packs by sort (K5b, ``pack_sort`` on the radix sort
   ``lex_sort``) and smaller batches by the scatter; pure-OR and mixed
   traffic in 8,192-row chunks and 1,024- and 2,048-row chunks, each
   wave replayed with every step held against its plain version,
   launches per wave shape equal to the replay's; tenant facades, a user
   of one tenant denied on another's docs, a write through a tenant's
   view, a tenant created after the traffic (one rebuild); ``pack_sort``
   and ``lex_sort`` timed (library call: a stable ``torch.sort`` of the
   keys packed into one int64), ``lex_sort``'s device operations per call
   counted with ``torch.profiler`` (at most the memset, the histograms and
   one launch per digit pass; more fails the run), and ``pack_sort``'s
   share of each wave.

16. the query-data-parallel checks (``dp_phase``) on the tables of the
   phase-3 engine as uploaded before any write (overlay empty): (a)
   ``shard_fast_check`` over four 8,192-row slices of pure-OR Doc#view
   traffic (phase 3's two chunks and two more), at the served caps
   (frontier 8,192, arena 16,384) and the retry's (32,768 / 65,536), at n =
   1 per slice and n = 4 slices of the card (one slice per card where
   there are more), every kernel call of one slice's steps held against
   its plain version, the n = 4 bits equal to the n = 1 slices', found
   rows allowed and rows not over equal to the engine's verdicts,
   launches per call one ``init_state`` and 5 x (``probe_level``,
   ``arena_assign``, ``expand_children``, the pack), no oracle; checks/s
   per call, over shares, device ms per step; (b) ``shard_general_check``
   on phase 6's general rows at n = 1 and n = 4, the n = 4 codes and
   occupancy rows equal to the n = 1 slices', rows not over equal to the
   engine's verdicts, one slice held step by step as in phase 6; (c)
   ``lex_searchsorted`` (``csrc/search.cu``) over the synth's 10.6M (ns,
   obj, rel, subject) tuple columns sorted by ``lex_sort``, and over a
   sorted phase-15 frontier, 65,536 queries each (half drawn from the
   keys, half absent, some past each end): kernel equal to its plain
   version, found rows equal to their queries, the insertion points equal
   to ``torch.searchsorted``'s on packed keys; timed as in phase 11.  Both
   sorts under it (the 10.6M tuple rows at 4 x 32 bits, 16 digit passes;
   the phase-15 frontier) are held against ``lex_sort``'s plain version,
   timed, and their device operations counted as in phase 15.

The card's name and power limit (as ``nvidia-smi`` reports them) are
printed before the last line, which is the device JSON object.  The script
imports nothing of JAX and nothing of the ``ketotpu`` package.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time
from collections import Counter
from types import SimpleNamespace
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
#: tier 0 (K6) and the fused wave's own kernels (K8): CUDA source and the
#: JAX function each replaces
LEO_KERNELS = {
    "leo_probe": ("ketotpu_torch/csrc/leopard.cu", "ketotpu/leopard/device.py:96"),
}
WAVE_KERNELS = {
    "wave_tier0": ("ketotpu_torch/csrc/wave.cu", "ketotpu/engine/fused.py:85"),
    "wave_lane": ("ketotpu_torch/csrc/wave.cu", "ketotpu/engine/fused.py:85"),
    "wave_gen_lane": ("ketotpu_torch/csrc/wave.cu", "ketotpu/engine/fused.py:85"),
    "wave_pack": ("ketotpu_torch/csrc/wave.cu", "ketotpu/engine/fused.py:85"),
}
#: the Expand walk (K9): CUDA source and the JAX function each replaces
EXPAND_KERNELS = {
    "expand_roots": ("ketotpu_torch/csrc/expand.cu",
                     "ketotpu/engine/expand_device.py:69"),
    "expand_level": ("ketotpu_torch/csrc/expand.cu",
                     "ketotpu/engine/expand_device.py:69"),
}
#: the graph-sharded mesh (K10): CUDA source and the JAX function each
#: replaces
MESH_KERNELS = {
    "shard_owner": ("ketotpu_torch/csrc/shard.cu",
                    "ketotpu/parallel/graphshard.py:62"),
    "shard_route": ("ketotpu_torch/csrc/shard.cu",
                    "ketotpu/parallel/graphshard.py:159"),
    "shard_merge": ("ketotpu_torch/csrc/shard.cu",
                    "ketotpu/parallel/graphshard.py:296"),
    "shard_merge_classified": ("ketotpu_torch/csrc/shard.cu",
                               "ketotpu/engine/algebra.py:730"),
    "shard_merge_child": ("ketotpu_torch/csrc/shard.cu",
                          "ketotpu/engine/algebra.py:754"),
}
#: the sort-based pack (K5b) and the radix sort under it: CUDA source and
#: the JAX function each replaces
SORT_KERNELS = {
    "pack_sort": ("ketotpu_torch/csrc/pack.cu", "ketotpu/engine/fastpath.py:515"),
    "lex_sort": ("ketotpu_torch/csrc/sort.cu", "ketotpu/engine/xutil.py:81"),
}
#: the lexicographic binary search: CUDA source and the JAX function it
#: replaces
SEARCH_KERNELS = {
    "lex_searchsorted": ("ketotpu_torch/csrc/search.cu",
                         "ketotpu/engine/xutil.py:43"),
}
ALL_KERNELS = (*KERNELS, *GEN_KERNELS, *LEO_KERNELS, *WAVE_KERNELS,
               *EXPAND_KERNELS, *MESH_KERNELS, *SORT_KERNELS, *SEARCH_KERNELS)
#: the tier-1 kernels a fused wave launches (its results stay on the card:
#: no pack_verdicts)
WAVE_FAST_KERNELS = ("init_state", "probe_level", "arena_assign",
                     "expand_children", "pack_scatter")

LEO_MAX_PAIRS = 1 << 25  # leopard.max_pairs of the membership deployment
MEMBERS_DIRECT, MEMBERS_HOP1, MEMBERS_RANDOM = 8192, 4096, 4096
C_TAIL = 1808  # path C's short chunk: 10,000 mixed rows end in 1,808
SEED_MEMBERS = 19
DEEP_DEPTH, DEEP_CHAINS, DEEP_N = 12, 64, 2048  # bench.py _leopard_deep
DEEP_MAX_DEPTH, DEEP_REST = 16, 10
SEED_DEEP, SEED_MODES = 23, 29


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, prefixed with the seconds since the script
    started (where the script's time goes)."""
    print(f"{time.perf_counter() - _T0:7.1f} s  {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phases 2 and 6: every kernel against its plain version ---------------------

#: keyword arguments a tier-1 or Expand wrapper writes into (each side gets
#: its own copy: ``over`` is set in place)
OUT_KW = ("occ_out", "out", "over")


def pairs():
    """kernel wrapper name -> (wrapper, plain version): same signature."""
    from ketotpu_torch.engine import algebra as alg
    from ketotpu_torch.engine import expand_device as xd
    from ketotpu_torch.engine import fastpath as fp
    from ketotpu_torch.engine import xutil

    from ketotpu_torch.engine import fused as fdx
    from ketotpu_torch.leopard import device as leodev
    from ketotpu_torch.parallel import graphshard as gs

    return {
        "shard_owner": (gs.shard_owner, gs._shard_owner_plain),
        "shard_route": (gs.shard_route, gs._shard_route_plain),
        "shard_merge": (gs.merge_bits, gs._merge_bits_plain),
        "shard_merge_classified": (gs.merge_classified,
                                   gs._merge_classified_plain),
        "shard_merge_child": (gs.merge_child, gs._merge_child_plain),
        "expand_roots": (xd.expand_roots, xd._expand_roots_plain),
        "expand_level": (xd.expand_level, xd._expand_level_plain),
        "leo_probe": (leodev.probe, leodev._probe_plain),
        "wave_tier0": (fdx.wave_tier0, fdx._wave_tier0_plain),
        "wave_lane": (fdx.wave_lane, fdx._wave_lane_plain),
        "wave_gen_lane": (fdx.wave_gen_lane, fdx._wave_gen_lane_plain),
        "wave_pack": (fdx.wave_pack, fdx._wave_pack_plain),
        "init_state": (fp.init_state, fp._init_state_plain),
        "probe_level": (fp.probe_level, fp._probe_level_plain),
        "arena_assign": (xutil.arena_assign, xutil._arena_assign_plain),
        "expand_children": (fp.expand_children, fp._expand_children_plain),
        "pack_scatter": (fp._pack_scatter, fp._pack_scatter_plain),
        "pack_sort": (fp._pack_sort, fp._pack_sort_plain),
        "lex_sort": (xutil.lex_sort, xutil._lex_sort_plain),
        "lex_searchsorted": (xutil.lex_searchsorted, xutil._lex_searchsorted_plain),
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
        # False: count the calls per tag but keep no arguments (nothing to
        # time; the card's memory stays free)
        self.keep = True

    def run(self, name, *args, **kw):
        kernel, plain = pairs()[name]
        i = state_index(args)
        if i is not None:
            st = args[i]
            before, twin = st.clone(), st.clone()
            kernel(*args, **kw)
            plain(*args[:i], twin, *args[i + 1:], **kw)
            self.compare(name, st.tensors(), twin.tensors())
            self.calls[name].append(
                (self.tag, args[:i] + (before,) + args[i + 1:], kw) if self.keep
                else (self.tag, None, None))
            return None
        kw_plain = {k: (v.clone() if k in OUT_KW and v is not None else v)
                    for k, v in kw.items()}
        got = kernel(*args, **kw)
        want = plain(*args, **kw_plain)
        outs = [k for k in OUT_KW if kw.get(k) is not None]
        self.compare(name, dict(enumerate(flatten(got) + [kw[k] for k in outs])),
                     dict(enumerate(flatten(want) + [kw_plain[k] for k in outs])))
        self.calls[name].append((self.tag, args, kw) if self.keep
                                else (self.tag, None, None))
        if name == "pack_sort":
            # the sort the pack ran, on the same keys, held on its own
            from ketotpu_torch.engine import fastpath as fp

            keys, pay = fp._sort_keys_plain(args[0], args[1])
            self.run("lex_sort", keys, pay, bits=fp._sort_bits(
                args[1].shape[0], kw["nsb"], kw["relb"]))
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
            "pack_scatter", "pack_verdicts", "pack_sort")))
        return alg._GenOps(*(step(n) for n in (
            "gen_classify", "gen_construct", "gen_visited", "gen_collect",
            "gen_up", "gen_pack", "arena_assign")), fast)

    def wave_ops(self):
        """A fused wave's steps: its four own kernels through :meth:`run`,
        the tier-1 and tier-2 kernels it runs as the engine runs them."""
        from ketotpu_torch.engine import algebra as alg
        from ketotpu_torch.engine import fastpath as fp
        from ketotpu_torch.engine import fused as fdx

        def step(name):
            return lambda *a, **k: self.run(name, *a, **k)

        return fdx.WaveOps(step("wave_tier0"), step("wave_lane"),
                           step("wave_gen_lane"), step("wave_pack"), fp._OPS,
                           alg._OPS)

    def full_wave_ops(self):
        """A fused wave's steps, every one through :meth:`run`: its own four
        kernels, and its tier-1 and tier-2 steps (the packs of its levels,
        of its retry lane and of the general sub-run among them)."""
        from ketotpu_torch.engine import fused as fdx

        def step(name):
            return lambda *a, **k: self.run(name, *a, **k)

        gen = self.ops()
        return fdx.WaveOps(step("wave_tier0"), step("wave_lane"),
                           step("wave_gen_lane"), step("wave_pack"), gen.fast,
                           gen)

    def mesh_ops(self):
        """The sharded programs' steps (K10 and the K7 / tier-1 steps they
        run), each through :meth:`run`."""
        from ketotpu_torch.parallel import graphshard as gs

        def step(name):
            return lambda *a, **k: self.run(name, *a, **k)

        return gs.MeshOps(step("shard_owner"), step("shard_route"),
                          step("shard_merge"), step("shard_merge_classified"),
                          step("shard_merge_child"), self.ops())

    def expand_ops(self):
        """The Expand walk's steps (K9 and its K4), each through :meth:`run`."""
        from ketotpu_torch.engine import expand_device as xd

        def step(name):
            return lambda *a, **k: self.run(name, *a, **k)

        return xd.XOps(step("expand_roots"), step("expand_level"),
                       step("arena_assign"))

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
    pack = pack_name(qpack.shape[1], nsb, relb)
    levels = len(sched)
    qp = torch.from_numpy(qpack).to(dev)
    occ = torch.zeros(levels, dtype=torch.int32, device=dev)
    f, qf, qo, qs = rec.run("init_state", qp, frontier=sched[0][0],
                            levels=levels, occ_out=occ[0:1])
    qd = torch.zeros_like(qo)
    for i, (_fl, a) in enumerate(sched):
        last = i == levels - 1
        qf2, qd, lv = rec.run("probe_level", g, f, qf, qd, qs, probe_only=last)
        if last:
            qf = qf2
            break
        off, _tot, par, ordn = rec.run("arena_assign", lv.counts, a)
        ch, qo2 = rec.run("expand_children", g, f, lv, off, par, ordn, qf2, qo,
                          max_width=max_width)
        f, qo = rec.run(pack, ch, qf2, qo2, frontier=sched[i + 1][0],
                        nsb=nsb, relb=relb, occ_out=occ[i + 1:i + 2])
        qf = qf2
    out = torch.empty(qp.shape[1], dtype=torch.uint8, device=dev)
    rec.run("pack_verdicts", qf, qo, qd, out=out)
    return out.cpu().numpy(), occ.cpu().numpy()


def pack_name(q: int, nsb: int, relb: int) -> str:
    """The pack wrapper a level of a ``q``-query batch launches: the field
    ``fastpath._pack_op`` picks, by name."""
    from ketotpu_torch.engine import fastpath as fp

    return fp._pack_op(fp._Ops._make(fp._Ops._fields), q, nsb, relb)


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
    if shape[0] == "wave":
        _, q, fast, _retry, lanes, gen, gen_retry, leo = shape
        parts = [f"wave/Q{q}", f"F{len(fast)}" if fast else "noF",
                 f"lanes{lanes}"]
        for name, gs in (("G", gen), ("GR", gen_retry)):
            if gs is not None:
                sizes, fast_b, fsched, vcap = gs
                parts.append(f"{name}:D{len(sizes)}/T{q + sum(sizes)}/B{fast_b}/"
                             f"S{len(fsched)}/V{vcap}")
        parts.append("leo" if leo else "noleo")
        return "/".join(parts)
    if shape[0] == "leo":
        return f"leo/Q{shape[1]}/cap{shape[2]}"
    if shape[0] == "sort":
        return f"sort/{shape[1]}/N{shape[2]}/K{shape[3]}"
    if shape[0] == "expand":
        return f"expand/R{shape[1]}/" + "x".join(map(str, shape[2]))
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
                 over=int(over.sum()), dirty=int(dirty.sum()))
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


def fixture_engine(cls=None, **kw):
    """An engine over the tier-2 parity fixture of ``tests/torch_parity.py``
    (AND / NOT permits, a NOT chain, subject sets into AND/NOT permits that
    enter the visited set, a deep tainted recursion) and its query batches,
    by name: a ``DeviceCheckEngine``, or ``cls`` built with ``kw``."""
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
    return (cls or DeviceCheckEngine)(store, StaticNamespaceManager(namespaces),
                                      **kw), batches


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


# -- phases 7-10: tier 0 and the fused wave -------------------------------------


def wave_key(plan):
    return ("wave", *plan.shape())


def check_wave(plan, rec: Recorder, tag, qpack=None, kwargs=None, full=False):
    """One fused wave with its four own kernels held against their plain
    versions call by call (with ``full``, its tier-1 and tier-2 kernels
    too; else they run as the engine runs them), then the whole int32
    output against the plain wave's (tolerance 0).  Returns the output on
    the host."""
    from ketotpu_torch.engine import fused as fdx

    qpack = plan.qpack if qpack is None else qpack
    kwargs = plan.kwargs if kwargs is None else kwargs
    rec.tag = tag
    rec.dispatches[tag] += 1
    ops = rec.full_wave_ops() if full else rec.wave_ops()
    out = fdx.run_wave(ops, plan.tables, qpack, **kwargs)
    want = fdx.run_fused_wave_plain(plan.tables, qpack, **kwargs)
    if out.shape != want.shape or not torch.equal(out, want):
        bad = (out != want).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"{shape_name(tag[1])}: wave != plain wave at {bad}")
    return out.cpu().numpy()


def decode_wave(plan, out):
    """(allowed, fallback) of one wave's rows, as the engine decodes them."""
    n, err, general = plan.n, plan.err, plan.general
    rows = out[:n]
    gcode = rows & 3
    found, fast_fb = (rows >> 4) & 1 == 1, (rows >> 5) & 1 == 1
    leo_ans, leo_allow = (rows >> 6) & 1 == 1, (rows >> 7) & 1 == 1
    allowed = np.zeros(n, bool)
    fallback = err.copy()
    allowed[general] = (gcode == 1)[general]
    fallback[general] |= ((((rows >> 2) | (rows >> 3)) & 1 == 1)
                          | (gcode == 3))[general]
    fmask = ~(err | general)
    allowed[fmask] = found[fmask]
    if plan.has_leo:
        allowed[leo_ans] = leo_allow[leo_ans]
    return allowed, fallback | fast_fb


def replay_waves(engine, queries, rec: Recorder, dataset: str, rest_depth=0,
                 full=False):
    """Every chunk of ``queries`` as the engine's wave, held step by step
    (:func:`check_wave`).  Returns per chunk (plan, output, allowed,
    fallback)."""
    out = []
    mb = engine.max_batch
    for lo in range(0, len(queries), mb):
        plan = engine.plan_wave(queries[lo: lo + mb], rest_depth)
        res = check_wave(plan, rec, (dataset, wave_key(plan)), full=full)
        out.append((plan, res, *decode_wave(plan, res)))
    return out


def hold_timed_shapes(engine, queries, rec: Recorder, dataset, shapes,
                      rest_depth=0, full=False):
    """Replay, on a chunk of the same Q, any wave shape the timed run
    dispatched that the replay did not hold (the adaptive tier-1 schedule
    may move between them)."""
    held = rec.shapes(dataset)
    for key in shapes:
        if key in held:
            continue
        _, q, fast, retry, lanes, gen, gen_retry, _leo = key
        for lo in range(0, len(queries), engine.max_batch):
            plan = engine.plan_wave(queries[lo: lo + engine.max_batch],
                                    rest_depth)
            if plan.qpack.shape[1] == q:
                kw = dict(plan.kwargs, fast_sched=fast, retry_sched=retry,
                          retry_lanes=lanes, gen=gen, gen_retry=gen_retry)
                check_wave(plan, rec, (dataset, key), kwargs=kw, full=full)
                break
        else:
            raise AssertionError(f"no chunk of Q {q} to hold {shape_name(key)}")


def wave_launches(shapes, names=WAVE_KERNELS):
    """Per wave kernel, per wave shape: the launches a run of ``shapes``
    (Counter of wave keys) makes: one tier0 and one pack per wave, one lane
    per tier-1 pass, two general lanes with a general retry."""
    out = {k: {} for k in names}
    for key, c in shapes.items():
        _, _q, fast, _retry, lanes, gen, gen_retry, _leo = key
        per = {"wave_tier0": 1, "wave_pack": 1,
               "wave_lane": (1 + lanes) if fast else 0,
               "wave_gen_lane": 2 if (gen is not None and gen_retry is not None)
               else 0}
        for k in names:
            if per[k]:
                out[k][key] = per[k] * c
    return out


def membership_queries(graph, seed: int, n_direct=MEMBERS_DIRECT,
                       n_hop1=MEMBERS_HOP1, n_random=MEMBERS_RANDOM):
    """Group:g#members@User checks on the synth graph: ``n_direct`` live
    direct-member tuples (allowed, hop 0), ``n_hop1`` parents g(i-1) of a
    nested g(i) with a member of g(i) (allowed, hop 1), and ``n_random``
    uniform random (group, user) pairs; shuffled with ``seed``."""
    from ketotpu_torch.api.types import RelationTuple, SubjectID

    rng = np.random.default_rng(seed)
    cols, alive, _tail, _head = graph.store.export_columns()
    v = graph.store.vocab
    grp = np.asarray(alive, bool) & (cols["ns"] == v.namespaces.lookup("Group")) & (
        cols["rel"] == v.relations.lookup("members"))
    direct = np.flatnonzero(grp & (cols["is_set"] == 0))
    nested = np.flatnonzero(grp & (cols["is_set"] == 1))
    objs, subs = v.objects.strings(), v.subjects.strings()

    def row(o, s):
        return RelationTuple("Group", objs[o], "members", SubjectID(subs[s][3:]))

    out = [row(cols["obj"][i], cols["subj"][i])
           for i in rng.choice(direct, n_direct, replace=False)]
    # members of each group: direct rows sorted by group
    d_obj, d_subj = cols["obj"][direct], cols["subj"][direct]
    order = np.argsort(d_obj, kind="stable")
    d_obj, d_subj = d_obj[order], d_subj[order]
    for i in rng.choice(nested, n_hop1):
        child = cols["s_obj"][i]
        lo, hi = np.searchsorted(d_obj, [child, child + 1])
        out.append(row(cols["obj"][i], d_subj[lo + rng.integers(hi - lo)]))
    groups = np.unique(d_obj)
    users = np.unique(d_subj)
    out += [row(o, s) for o, s in zip(rng.choice(groups, n_random),
                                      rng.choice(users, n_random))]
    return [out[i] for i in rng.permutation(len(out))]


def leo_replay(engine, chunk, rec: Recorder, tag):
    """The unfused path's K6 launch for one chunk, held against its plain
    version: the same keys ``DeviceCheckEngine._leopard_answers`` builds."""
    from ketotpu_torch.engine.device import _bucket
    from ketotpu_torch.leopard import device as leodev

    _g, enc, _err, _general, state = engine._prepare(chunk, 0)
    nodes, _hi = state.index.node_ids_np(enc[0], enc[1], enc[2])
    q_subj = enc[3]
    keys = np.where((nodes >= 0) & (q_subj >= 0),
                    nodes.astype(np.int64) << 32 | q_subj.astype(np.int64), -1)
    q_set, q_elt = leodev.split_keys(keys, _bucket(len(chunk)))
    p = state.pairs
    dev = p["sets"].device
    rec.tag = tag
    rec.dispatches[tag] += 1
    hit, hop = rec.run("leo_probe", p["sets"], p["elts"], p["hops"],
                       torch.from_numpy(q_set).to(dev),
                       torch.from_numpy(q_elt).to(dev))
    return hit.cpu().numpy()[: len(chunk)], hop.cpu().numpy()[: len(chunk)]


def search_bytes(sets, elts, q_set, q_elt, rows=None) -> int:
    """Bytes the K6 searches of ``rows`` (all when None) must read: every
    distinct pair slot their steps visit (set and element words), the hop
    word of each hit, and each query's two key words."""
    from ketotpu_torch.leopard import device as leodev

    if rows is not None:
        q_set, q_elt = q_set[rows], q_elt[rows]
    if not q_set.numel():
        return 0
    cap = sets.shape[0]
    lo = torch.zeros_like(q_set)
    hi = torch.full_like(q_set, cap)
    seen = []
    for _ in range(leodev.probe_steps(cap)):
        mid = (lo + hi) >> 1
        mc = mid.clamp(max=cap - 1).long()
        seen.append(mc)
        less = (sets[mc] < q_set) | ((sets[mc] == q_set) & (elts[mc] < q_elt))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    idx = lo.clamp(0, cap - 1).long()
    slots = int(torch.unique(torch.cat(seen + [idx])).numel())
    hits = int(((sets[idx] == q_set) & (elts[idx] == q_elt)).sum())
    return 8 * slots + 4 * hits + 8 * q_set.numel()


_PACKED = {}


def library_probe(sets, elts, hops, q_set, q_elt):
    """K6 as PyTorch calls compute it: ``torch.searchsorted`` over the
    packed int64 (set << 32 | element) keys, the match test and the hop
    gather.  The packed column is built once per pair column, outside the
    timed call."""
    key = sets.data_ptr()
    if key not in _PACKED:
        _PACKED[key] = (sets.long() << 32) | elts.long()
    packed = _PACKED[key]
    q = (q_set.long() << 32) | q_elt.long()
    pos = torch.searchsorted(packed, q).clamp_(max=packed.numel() - 1)
    hit = packed[pos] == q
    return hit, torch.where(hit, hops[pos], 0)


def deep_engine():
    """The deep nested-group fixture (bench.py's leopard deep check):
    ``DEEP_CHAINS`` chains of ``DEEP_DEPTH`` groups, the fused engine at
    ``max_depth`` ``DEEP_MAX_DEPTH``, and ``DEEP_N`` seeded root checks."""
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.utils.synth import build_deep_groups, deep_queries

    deep = build_deep_groups(depth=DEEP_DEPTH, n_chains=DEEP_CHAINS,
                             seed=SEED_DEEP)
    eng = DeviceCheckEngine(deep.store, deep.manager, max_depth=DEEP_MAX_DEPTH,
                            fused_dispatch=True)
    return eng, deep_queries(deep, DEEP_N, depth=DEEP_DEPTH, seed=SEED_DEEP + 1)


def timed(engine, queries, rest_depth=0, repeats=2):
    """One warm ``batch_check`` with every launch count and the engine's
    counters set to 0 just before and read just after, then ``repeats``
    more timed runs.  Returns (verdicts, seconds, launches, counter deltas,
    wave shapes, host ms per phase, the repeats' seconds)."""
    from ketotpu_torch import kernels

    names = ("leopard_answered", "leopard_hits", "retries", "fallbacks",
             "fused_waves", "fused_d2h_fetches", "general_rows",
             "general_retries")
    before = {k: getattr(engine, k) for k in names}
    tiers0 = dict(engine.fused_tier_rows)
    engine.phase_seconds.clear()
    engine.wave_shapes.clear()
    engine.dispatch_shapes.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = engine.batch_check(queries, rest_depth)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counts = {k: getattr(engine, k) - before[k] for k in names}
    counts["tier_rows"] = {k: v - tiers0[k] for k, v in engine.fused_tier_rows.items()}
    shapes = Counter({("wave", *k): c for k, c in engine.wave_shapes.items()})
    phases = {k: round(v * 1e3, 3) for k, v in engine.phase_seconds.items()}
    more = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        engine.batch_check(queries, rest_depth)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    return out, dt, launches, counts, shapes, phases, more


def require_launched(launches, names, path):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {path}: {missing}")


def require_wave_launches(launches, shapes, path):
    """Each wave kernel's launches in a timed run equal what its wave
    shapes make."""
    want = wave_launches(shapes)
    for k in WAVE_KERNELS:
        if sum(want[k].values()) != launches[k]:
            raise AssertionError(f"{path}: {k} launched {launches[k]} times, "
                                 f"{sum(want[k].values())} by wave shape")
    return want


# -- phase 11: timing -----------------------------------------------------------


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


def device_ops(fn):
    """The device operations (kernels, memsets, copies) one ``fn()`` call
    enqueues, by name: a ``torch.profiler`` trace of one call, after a warm
    one.  None where the trace holds no device event (the count is then not
    measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the first trace of a process can come back without device events:
    # one more try
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return None


def gate_ops(rec: Recorder, dataset: str, name: str, most, phase: str):
    """Per shape of ``dataset``'s kept ``name`` calls, the device operations
    one call enqueues (:func:`device_ops` over the first call kept at the
    shape), logged; raises where more than ``most(args, kw)`` (the source's
    count) were measured.  Returns the kernel line's
    ``device_ops_by_shape`` ("not measured" where the profiler saw no
    device event)."""
    kernel = pairs()[name][0]
    out = {}
    for tag, args, kw in rec.calls[name]:
        if tag is None or tag[0] != dataset or args is None:
            continue
        key = shape_name(tag[1])
        if key in out:
            continue
        rows = (args[0].shape[-1] if isinstance(args[0], torch.Tensor)
                else args[0][0].shape[0])
        bound = most(args, kw)
        ops = device_ops(lambda args=args, kw=kw: kernel(*args, **kw))
        if ops is None:
            log(f"{phase} {name} at {key} ({rows} rows): device operations per "
                f"call not measured (the profiler saw no device event); the "
                f"source enqueues {bound}")
            out[key] = "not measured"
            continue
        log(f"{phase} {name} at {key} ({rows} rows): {len(ops)} device "
            f"operations per call (torch.profiler; the source's count "
            f"{bound}): {dict(Counter(ops))}")
        if len(ops) > bound:
            raise AssertionError(f"{name} at {key}: {len(ops)} device operations "
                                 f"per call, the source enqueues {bound}")
        out[key] = len(ops)
    return out


def sort_ops(args, kw) -> int:
    """The device operations of one ``lex_sort`` call by the source: the
    memset, the histograms and one launch per digit pass (two copies when
    there is no pass)."""
    from ketotpu_torch.engine import xutil

    keys = args[0]
    n = keys.shape[-1] if isinstance(keys, torch.Tensor) else keys[0].shape[0]
    nk = keys.shape[0] if isinstance(keys, torch.Tensor) else len(keys)
    bits = kw.get("bits") or (32,) * nk
    return 2 + len(xutil.sort_layout(n, bits).passes)


def host_ms(fn, reps: int = 20) -> float:
    """Wall time per eager call, enqueue included, synchronized at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


#: calls timed per kernel and dispatch shape in phase 11 (evenly spaced
#: over the main and mixed paths' calls; every call is held against its
#: plain version when it is recorded all the same)
MAIN_TIMED_SAMPLE = 8
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
    its packed edge word and object).  With the delta overlay in the
    tables, every membership probe also probes the ``om_`` table and every
    row degree read reads its ``ov_dirty`` byte; the ``ovt_`` probe of a
    node the base lacks is left out (a lower bound).  A K7 call counts
    from the state it found; the small program and routing tables
    (kilobytes, L2-resident) are left out."""
    from ketotpu_torch.engine import algebra as alg

    kc, kt = g["f_css_rel"].shape[2], g["f_ttu_via"].shape[2]
    s = 1 + kc + kt
    item = 5 * 4 + 2  # five int32 columns + two bool columns
    ov = "om_ptr" in g  # the overlay: one more probe per membership probe
    mem = 12 + (16 if ov else 0)  # bytes per membership probe
    deg = 8 + (1 if ov else 0)  # bytes per row degree read
    if name == "init_state":
        q = args[0].shape[1]
        b = 6 * 4 * q + item * kw["frontier"] + 2 * 4 * q + 4
        # a shard of the mesh: the assign row too
        return b + (4 * q if kw.get("assign") is not None else 0)
    if name == "probe_level":
        _g, f, qf, _qd, _qs = args
        n, nq = f.qid.shape[0], qf.shape[0]
        live = int(((f.qid >= 0) & (qf[f.qid.clamp(0, nq - 1).long()] == 0)).sum())
        b = item * n + 4 * 4 * nq  # frontier + found, dirty bits in and out
        b += 16 * n + 4 * n  # node probe + node column out
        b += 8 * live + mem * live * (1 + kc)  # query gathers + member probes
        b += 16 * live * kc  # css node probes
        if not kw["probe_only"]:
            b += 16 * n * kt + deg * live * (1 + kt)  # ttu probes + degrees
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
    if name == "lex_sort":
        keys, payload = args[0], args[1:]
        nk, n = (keys.shape if isinstance(keys, torch.Tensor)
                 else (len(keys), keys[0].shape[0]))
        # every key and payload column read once and written once, sorted
        return 8 * (nk + len(payload)) * n
    if name == "lex_searchsorted":
        keys, queries = tuple(args[0]), tuple(args[1])
        k, q = len(keys), queries[0].shape[0]
        # per distinct key row any search reads, its k words; the query
        # columns; idx and found written
        return 4 * k * search_slots(keys, queries) + 4 * k * q + 5 * q
    if name in ("pack_scatter", "pack_sort"):
        ch, qf = args[0], args[1]
        if isinstance(ch, torch.Tensor):  # the rows a shard received
            a, row = ch.shape[0], 4 * ch.shape[1]
            alive = int((ch[:, 0] >= 0).sum())
        else:
            a, row = ch.qid.shape[0], item
            alive = int((ch.qid >= 0).sum())
        nq = qf.shape[0]
        # the scratch (the dedup table; the sort's keys and permutations)
        # is left out: it fits in L2 (pack.cu, sort.cuh)
        b = row * a + 4 * alive  # children + their found bits
        b += item * kw["frontier"] + 2 * 4 * nq + 4  # frontier, over bits, occ
        return b
    if name == "pack_verdicts":
        nq = args[0].shape[0]
        return 3 * 4 * nq + nq
    if name == "expand_roots":
        from ketotpu_torch.engine import expand_device as xd

        g_, roots, width = args
        known = int((roots[:3] >= 0).all(0).sum())  # ids the vocab knows
        found = int((xd._expand_roots_plain(g_, roots, width)[0][2] >= 0).sum())
        # the root block in; per known root one node probe and, per root
        # with a node, its two member row pointers; the record, counts and
        # ancestor column written
        return (5 * 4 * roots.shape[1] + 16 * known + 8 * found
                + 4 * width * (7 + 1 + 1))
    if name == "expand_level":
        _g, rec_, counts, anc, off, par, _ordn = args
        C, A, k = rec_.shape[1], par.shape[0], anc.shape[0]
        pos = counts > 0
        fits = (off + counts) <= A
        flag = pos & ~fits
        parents = par[par >= 0].long()
        kept = parents[fits[parents]]
        n_par, n_kept_par = int(parents.unique().numel()), int(kept.unique().numel())
        out, nodes = expand_level_counts(args, kw)
        # every item's count; the offset of each item with members and the
        # root of each that overflowed; one over bit set per such root;
        # the slot map in; per distinct parent of a slot its d, per
        # distinct kept parent its node, root, k ancestor columns and
        # member row pointer; per kept slot its member subject and
        # namespace decode; per expandable child its object and relation
        # and one node probe, per child with a node its member row
        # pointers; the record, the next counts (not at the last level)
        # and k + 1 ancestor columns written
        b = 4 * C + 4 * int(pos.sum()) + 4 * int(flag.sum())
        b += 4 * int(rec_[5][flag].unique().numel()) + 8 * A
        b += 4 * n_par + 4 * n_kept_par * (k + 3) + 8 * int(kept.numel())
        b += out * (8 + 16) + nodes * 8
        b += 4 * A * (7 + (0 if kw.get("last") else 1) + k + 1)
        return b
    if name == "leo_probe":
        sets, elts, _hops, q_set, q_elt = args
        return search_bytes(sets, elts, q_set, q_elt) + 8 * q_set.shape[0]
    if name == "wave_tier0":
        from ketotpu_torch.leopard.closure import LM_HIT_ONLY, LM_PROBE

        qp, leo = args
        q = qp.shape[1]
        b = 4 * q + 4 + 4 * q  # probe modes, the rest depth; tier-0 bits out
        if leo is not None:
            rows = ((qp[7] == LM_PROBE) | (qp[7] == LM_HIT_ONLY)).nonzero().flatten()
            b += search_bytes(leo[0], leo[1], qp[8], qp[9], rows)
        if kw["fast"]:
            b += 4 * q + 4 * q  # the fast-eligible row in, tier 1's row out
        return b
    if name == "wave_lane":
        act, _pf, _po, _pd, found, retried, fb = args
        q = act.shape[0]
        b = 4 * 4 * q + 4 * 4 * q  # act, found, over, dirty in; 4 masks out
        b += 4 * q * ((found is not None) + (retried is not None)
                      + (fb is not None))
        return b
    if name == "wave_gen_lane":
        q = args[0].shape[0]
        if len(args) < 3 or args[2] is None:
            return q + 4 * q + 4 * q  # codes, general row in; retry row out
        return q + q + 4 * q + 4 * q  # both codes, the retry row; bits out
    if name == "wave_pack":
        leo, found, _fb, _rt, gcodes, gbits, focc, gocc = args
        q = leo.shape[0]
        nf = 0 if focc is None else focc.shape[0]
        ng = 0 if gocc is None else gocc.shape[0]
        b = 4 * q + (12 * q if found is not None else 0)
        b += 4 * q if gbits is not None else (q if gcodes is not None else 0)
        return b + 4 * (nf + ng) + 4 * (q + nf + ng)
    if name == "shard_owner":
        return 3 * 4 * args[0].shape[0]  # ns, obj in; owner out
    if name == "shard_route":
        ch, qo = args
        a, nq = ch.qid.shape[0], qo.shape[0]
        alive = int((ch.qid >= 0).sum())
        # every child's qid; an alive child's other six columns; the over
        # bits in and out; the send block written (the scan's scratch
        # fits in L2 and is left out)
        return (4 * a + (item - 4) * alive + 2 * 4 * nq
                + 4 * 7 * kw["n_shards"] * kw["cap"])
    if name == "shard_merge":
        stage = args[0]
        return 4 * stage.numel() + 4 * stage[0].numel()
    st = args[state_index(args)]
    t = st.tasks
    if name == "shard_merge_classified":
        w = args[3].shape[2]
        # psum(where(mine, x, 0)) is the owner's partial: its nine columns,
        # the owner and qid columns in; twelve columns out (p_kind's few
        # words and the q bits' atomics left out)
        return 4 * w * (9 + 2 + 12)
    if name == "shard_merge_child":
        stage, owner_par = args[2], args[3]
        lo, w = st.span(args[1])
        parent = t[alg.TI["parent"], lo:lo + w]
        n_par = int(torch.unique(parent.clamp(0, owner_par.shape[0] - 1)).numel())
        # the owner's partial of the twelve columns and the parent column
        # in, the owner of each distinct parent; twelve columns out
        return 4 * w * (12 + 1 + 12) + 4 * n_par
    if name == "gen_classify":
        level = args[2]
        _lo, n = st.span(level)
        qp = kw.get("qpack")
        if qp is not None:
            # qpack's ns, obj, rel, depth and active rows in (the subject
            # row is gathered per live root below); the twelve columns of a
            # root written, then the eighteen classification writes, two of
            # them (kind, prog) the same columns
            live = int((kw["act"] != 0).sum())
            b = n * 4 * (5 + 12 + 18 - 2)
        else:
            # kind, ns, obj, rel, d, skip, force, prog, qid in; eight task
            # and ten aux columns out
            live = _level_live(st, level)
            b = n * 4 * (9 + 18)
        b += live * (4 + 16 + mem + deg + 16) + 4  # subject, probes, degree, occ
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
        if kw.get("owner") is not None:
            b += n * 4  # a shard of the mesh: the parents' owners
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
        # its found, over and dirty bits; the parents that receive a count
        # get their three count columns written
        leaves = int((t[alg.TI["fast_id"], lo:lo + n] >= 0).sum())
        par = t[alg.TI["parent"], lo:lo + n][t[alg.TI["qid"], lo:lo + n] >= 0]
        touched = int(torch.unique(par).numel()) if level else 0
        return n * 4 * (13 + 2) + leaves * 12 + touched * 12
    if name == "gen_pack":
        return st.q * (4 + 4 + 4 + 1)
    raise KeyError(name)


def expand_level_counts(args, kw):
    """(expandable children, expandable children with a node) of one
    ``expand_level`` call, from its plain version's outputs."""
    from ketotpu_torch.engine import expand_device as xd

    rec, _counts, _anc = xd._expand_level_plain(
        *args, over=kw["over"].clone(), last=kw.get("last", False))
    return int(rec[6].sum()), int((rec[2] >= 0).sum())


#: one PyTorch call that computes the same function, where there is one
LIBRARY = {
    "arena_assign": lambda args, kw: torch.cumsum(args[0], 0, dtype=torch.int32),
    "leo_probe": lambda args, kw: library_probe(*args),
    # psum(x) > 0 of int32 0/1 partials is their max
    "shard_merge": lambda args, kw: torch.amax(args[0], 0),
}


def pack_columns(cols, lows, widths):
    """int32 columns packed into one int64, most significant first, each
    shifted by its low value (order-preserving)."""
    packed = torch.zeros(cols[0].shape[0], dtype=torch.int64,
                         device=cols[0].device)
    for c, lo, w in zip(cols, lows, widths):
        packed = (packed << w) | (c.to(torch.int64) - lo)
    return packed


def packed_sort(args, kw):
    """The library yardstick of a ``lex_sort`` call: one stable
    ``torch.sort`` of its keys packed into one int64 with the widths this
    call's (non-negative) data needs, when they fit 63 bits; else None.
    The packing is done here, outside the timed call."""
    keys = args[0]
    keys = keys if isinstance(keys, torch.Tensor) else torch.stack(keys)
    if keys.numel() == 0 or int(keys.min()) < 0:
        return None
    widths = [max(int(k.max()).bit_length(), 1) for k in keys]
    if sum(widths) > 63:
        return None
    packed = pack_columns(keys, [0] * len(widths), widths)
    return lambda: torch.sort(packed, stable=True)


def packed_search(args, kw):
    """The library yardstick of a ``lex_searchsorted`` call: one
    ``torch.searchsorted`` of its queries in its keys, each packed into one
    int64 (each column shifted by its least value over keys and queries,
    with the width the two need), when the widths fit 63 bits; else None.
    The packing is done here, outside the timed call."""
    keys, queries = tuple(args[0]), tuple(args[1])
    if keys[0].numel() == 0:
        return None
    lows = [min(int(k.min()), int(q.min())) for k, q in zip(keys, queries)]
    widths = [max((max(int(k.max()), int(q.max())) - lo).bit_length(), 1)
              for k, q, lo in zip(keys, queries, lows)]
    if sum(widths) > 63:
        return None
    pk = pack_columns(keys, lows, widths)
    pq = pack_columns(queries, lows, widths)
    return lambda: torch.searchsorted(pk, pq)


#: per kernel, a function of a call's arguments that prepares the library
#: yardstick and returns it as a call to time (or None where it does not
#: apply)
LIBRARY_PREPARED = {"lex_sort": packed_sort, "lex_searchsorted": packed_search}
#: kernels timed as a graph of back-to-back calls (they leave their inputs
#: as they found them)
CALLS_TIMED = (*LEO_KERNELS, *WAVE_KERNELS)
#: kernels also timed back to back beside their library call (``b2b_ms``,
#: ``library_b2b_ms``): a replay of one call carries the graph launch too,
#: which at a few microseconds blurs the comparison
B2B_TIMED = ("arena_assign", "lex_sort")


def calls_ms(fn):
    """Times of one ``fn()`` that leaves its inputs as they were: one CUDA
    graph runs it ``STATE_COPIES`` times back to back, replayed
    ``STATE_ROUNDS`` times with the card held busy while the host submits
    each replay.  Returns (device ms per call: the median of the replays,
    their spread max - min, host ms per eager call, device time
    included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: allocator pools and lazily built constants
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(STATE_COPIES):
            fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(STATE_ROUNDS):
        torch.cuda._sleep(HOLD_CYCLES)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        per.append(e0.elapsed_time(e1) / STATE_COPIES)
    return float(np.median(per)), max(per) - min(per), host_ms(fn)


def _sampled(calls, dataset, sample):
    """``dataset``'s kept calls; with ``sample``, at most that many per
    shape, evenly spaced over the calls at that shape."""
    by = {}
    for c in calls:
        if c[0] is not None and c[0][0] == dataset and c[1] is not None:
            by.setdefault(c[0][1], []).append(c)
    out = []
    for cs in by.values():
        if sample and len(cs) > sample:
            cs = [cs[int(i)] for i in np.unique(
                np.linspace(0, len(cs) - 1, sample).round())]
        out += cs
    return out


def time_kernels(g, rec: Recorder, dataset: str, names=ALL_KERNELS, sample=None):
    """Per kernel of ``names``, per dispatch shape: device ms per launch,
    its plain version's and the library call's, the byte bound and the
    host's ms per eager call, averaged over ``dataset``'s calls at that
    shape (with ``sample``, over that many of them, evenly spaced).  A
    tier-1 call is replayed as it was (:func:`device_ms`); a K7 call
    restarts from the state it found (:func:`state_ms`), and
    ``spread_ms`` is the largest spread of its replays."""
    rows = {}
    for name in names:
        kernel, plain = pairs()[name]
        by_shape = {}
        for tag, args, kw in _sampled(rec.calls[name], dataset, sample):
            r = by_shape.setdefault(tag[1], {
                "ms": [], "plain_ms": [], "library_ms": [], "host_ms": [],
                "bound_ms": [], "spread_ms": [], "b2b_ms": [],
                "library_b2b_ms": []})
            i = state_index(args)
            # plain, kernel, kernel, plain: neither gains from going first
            if i is None:
                def k(args=args, kw=kw):
                    return kernel(*args, **kw)

                def p(args=args, kw=kw):
                    return plain(*args, **kw)

                if name in CALLS_TIMED:
                    (p0, _, _), (k0, s0, h0), (k1, s1, _), (p1, _, _) = (
                        calls_ms(p), calls_ms(k), calls_ms(k), calls_ms(p))
                    r["host_ms"].append(h0)
                    r["spread_ms"].append(max(s0, s1))
                else:
                    p0, k0, k1, p1 = (device_ms(p), device_ms(k), device_ms(k),
                                      device_ms(p))
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
            elif name in LIBRARY_PREPARED:
                lib_fn = LIBRARY_PREPARED[name](args, kw)
                if lib_fn is not None:
                    r["library_ms"].append(device_ms(lib_fn))
            if name in B2B_TIMED:
                # kernel, library, library, kernel, each a graph of calls
                # back to back
                lib_fn = ((lambda args=args, kw=kw: LIBRARY[name](args, kw))
                          if name in LIBRARY else LIBRARY_PREPARED[name](args, kw))
                kb0 = calls_ms(k)[0]
                if lib_fn is not None:
                    r["library_b2b_ms"].append(
                        (calls_ms(lib_fn)[0] + calls_ms(lib_fn)[0]) / 2)
                r["b2b_ms"].append((kb0 + calls_ms(k)[0]) / 2)
            r["bound_ms"].append(
                kernel_bytes(name, args, kw, g) / HBM_BYTES_PER_S * 1e3)
        rows[name] = {
            shape: {key: (float(np.max(v) if key == "spread_ms" else np.mean(v))
                          if v else None)
                    for key, v in r.items()} | {"calls": len(r["ms"])}
            for shape, r in by_shape.items()
        }
    return rows


def b2b_note(r) -> str:
    """The back-to-back times of a :data:`B2B_TIMED` kernel's row, for a
    log line ("" for other kernels)."""
    if r.get("b2b_ms") is None:
        return ""
    lib = r.get("library_b2b_ms")
    return (f"; back to back {r['b2b_ms']:.4f} ms a call, library "
            f"{'none' if lib is None else f'{lib:.4f}'} ms")


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


def fused_paths(graph, rec: Recorder, mixed_q, mout, engine):
    """Phases 7-10: the fused engine with Leopard on over the same graph
    (paths A, B, C) and the deep-groups fixture (path D).  ``mixed_q`` and
    ``mout`` are the mixed traffic and its unfused verdicts (phase 6),
    ``engine`` the engine whose oracle judges them.  Returns what the
    timing phase reads."""
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.engine.oracle import CheckEngine

    # -- 7. path A: membership checks, the fused wave, Leopard on --------------
    t0 = time.perf_counter()
    leng = DeviceCheckEngine(graph.store, graph.manager, fused_dispatch=True,
                             fused_retry_lanes=1,
                             leopard={"max_pairs": LEO_MAX_PAIRS})
    lg = leng.device_tables()
    state = leng.leopard_index()
    if state is None or state.pairs is None:
        raise AssertionError("the closure index was not built")
    idx = state.index
    pair_bytes = sum(t.numel() * t.element_size() for t in state.pairs.values())
    log(f"[7] fused engine, Leopard max_pairs {LEO_MAX_PAIRS}: projection "
        f"{leng.projection_build_s:.2f} s, upload {leng.projection_upload_s:.2f} "
        f"s; closure index built in {idx.build_s:.2f} s on the host: "
        f"{len(idx.elt_packed)} element pairs, {len(idx.set_src)} set pairs, "
        f"{idx.n_nodes} nodes, {int(idx.tainted.sum())} tainted; pair columns "
        f"on the card {pair_bytes} bytes ({state.pairs['sets'].shape[0]} slots "
        f"x 3 int32), {time.perf_counter() - t0:.1f} s in all")
    memb = membership_queries(graph, SEED_MEMBERS, MEMBERS_DIRECT, MEMBERS_HOP1,
                              MEMBERS_RANDOM)
    t0 = time.perf_counter()
    oracle = CheckEngine(graph.store, graph.manager)
    m_want = np.array([oracle.check_is_member(q) for q in memb])
    log(f"[7] membership traffic: {len(memb)} Group#members checks "
        f"({MEMBERS_DIRECT} direct members, {MEMBERS_HOP1} parent-of-nested, "
        f"{MEMBERS_RANDOM} random); the oracle allows {int(m_want.sum())} "
        f"({time.perf_counter() - t0:.1f} s)")
    leng.batch_check(memb)  # warm
    a_out, a_dt, a_launch, a_cnt, a_shapes, a_phases, a_more = timed(leng, memb)
    a_out = np.asarray(a_out)
    t0 = time.perf_counter()
    a_replay = replay_waves(leng, memb, rec, "fused-members")
    hold_timed_shapes(leng, memb, rec, "fused-members", a_shapes)
    a_active = sum(int((((out[:pl.n] >> 6) & 1) == 0)[~(pl.err | pl.general)].sum())
                   for pl, out, _a, _f in a_replay)
    log(f"[7] timed membership batch_check (fused): {len(memb)} checks in "
        f"{a_dt:.4f} s = {len(memb) / a_dt:.0f} checks/s (repeats: "
        f"{', '.join(f'{len(memb) / x:.0f}' for x in a_more)} checks/s); "
        f"allowed {int(a_out.sum())}; leopard answered "
        f"{a_cnt['leopard_answered']}, hits {a_cnt['leopard_hits']}; tier-1 "
        f"active rows {a_active}; retries {a_cnt['retries']}, oracle fallbacks "
        f"{a_cnt['fallbacks']}; waves {a_cnt['fused_waves']}, device-to-host "
        f"copies {a_cnt['fused_d2h_fetches']}; tier rows {a_cnt['tier_rows']}")
    log(f"[7] launches in the timed membership run: {a_launch}")
    log(f"[7] waves: { {shape_name(k): v for k, v in a_shapes.items()} }")
    log(f"[7] host ms per phase of the timed membership run: {a_phases}")
    if (a_out != m_want).any():
        bad = np.flatnonzero(a_out != m_want)[:4]
        raise AssertionError(f"membership verdicts != oracle at {bad}")
    if a_cnt["leopard_answered"] != len(memb) or a_cnt["fallbacks"] or a_active:
        raise AssertionError("the membership path left rows to tiers 1-2 or "
                             "the oracle")
    a_allowed = np.concatenate([a for _p, _o, a, _f in a_replay])
    if (a_allowed != a_out).any():
        raise AssertionError("membership batch_check != the wave replay")
    require_launched(a_launch, ("wave_tier0", "wave_lane", "wave_pack",
                                *WAVE_FAST_KERNELS), "the membership path")
    a_by_shape = require_wave_launches(a_launch, a_shapes, "membership path")
    log(f"[7] membership path: all {len(memb)} verdicts equal the oracle's and "
        f"the step-by-step wave replay (every wave output == plain wave, "
        f"tolerance 0); wave launches equal the replay's per wave shape "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 8. path B: the reference mixed traffic through the fused wave --------
    leng.batch_check(mixed_q)
    leng.batch_check(mixed_q)  # warm twice: the general shapes freeze
    b_out, b_dt, b_launch, b_cnt, b_shapes, b_phases, b_more = timed(leng, mixed_q)
    t0 = time.perf_counter()
    b_replay = replay_waves(leng, mixed_q, rec, "fused-mixed")
    hold_timed_shapes(leng, mixed_q, rec, "fused-mixed", b_shapes)
    n_chunks = -(-MIXED_N // leng.max_batch)
    log(f"[8] timed mixed batch_check (fused, Leopard on): {MIXED_N} checks in "
        f"{b_dt:.4f} s = {MIXED_N / b_dt:.0f} checks/s (repeats: "
        f"{', '.join(f'{MIXED_N / x:.0f}' for x in b_more)} checks/s); allowed "
        f"{sum(b_out)}; leopard answered {b_cnt['leopard_answered']}; general "
        f"rows {b_cnt['general_rows']}, general retries "
        f"{b_cnt['general_retries']}, all retries {b_cnt['retries']}, oracle "
        f"fallbacks {b_cnt['fallbacks']}; waves {b_cnt['fused_waves']}, "
        f"device-to-host copies {b_cnt['fused_d2h_fetches']}; tier rows "
        f"{b_cnt['tier_rows']}")
    log(f"[8] launches in the timed fused mixed run: {b_launch}")
    log(f"[8] waves: { {shape_name(k): v for k, v in b_shapes.items()} }")
    log(f"[8] host ms per phase of the timed fused mixed run: {b_phases}")
    if b_out != mout:
        bad = [i for i, (x, y) in enumerate(zip(b_out, mout)) if x != y][:4]
        raise AssertionError(f"fused mixed verdicts != unfused at rows {bad}")
    if not (b_cnt["fused_waves"] == b_cnt["fused_d2h_fetches"] == n_chunks):
        raise AssertionError("the fused mixed run did not fetch once per wave")
    b_allowed = np.concatenate([a for _p, _o, a, _f in b_replay])
    b_fb = np.concatenate([f for _p, _o, _a, f in b_replay])
    if (b_allowed[~b_fb] != np.asarray(b_out)[~b_fb]).any():
        raise AssertionError("fused mixed batch_check != the wave replay")
    require_launched(b_launch, (*WAVE_KERNELS, *WAVE_FAST_KERNELS,
                                *GEN_KERNELS), "the fused mixed path")
    b_by_shape = require_wave_launches(b_launch, b_shapes, "fused mixed path")
    for i in np.random.default_rng(SEED_SAMPLE + 1).choice(
            MIXED_N, ORACLE_SAMPLE, replace=False):
        if b_out[i] != engine.oracle.check_is_member(mixed_q[i]):
            raise AssertionError(f"{mixed_q[i]}: fused verdict != oracle")
    log(f"[8] fused mixed path: verdicts equal the unfused mixed run's row for "
        f"row, the wave replay's, and the oracle on {ORACLE_SAMPLE} sampled "
        f"rows; one device-to-host copy per wave ({n_chunks} waves) "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 9. path C: the unfused cascade with Leopard on (K6 on its own) -------
    # the membership checks and a short tail (C_TAIL rows, the size of the
    # mixed traffic's last chunk): every chunk, whatever its size, probes
    # on the card
    c_rows = memb + memb[:C_TAIL]
    c_want = np.concatenate([a_out, a_out[:C_TAIL]])
    leng.fused_dispatch = False
    leng.batch_check(c_rows)  # warm
    c_out, c_dt, c_launch, c_cnt, _c_shapes, c_phases, c_more = timed(leng, c_rows)
    leng.fused_dispatch = True
    t0 = time.perf_counter()
    c_shapes = Counter()
    for lo in range(0, len(c_rows), leng.max_batch):
        chunk = c_rows[lo: lo + leng.max_batch]
        key = ("leo", len(chunk), state.pairs["sets"].shape[0])
        c_shapes[key] += 1
        hit, _hop = leo_replay(leng, chunk, rec, ("unfused-members", key))
        if (hit.astype(bool) != c_want[lo: lo + len(chunk)]).any():
            raise AssertionError("K6 hits != the membership verdicts")
    log(f"[9] timed membership batch_check (unfused, Leopard on): {len(c_rows)} "
        f"checks in {c_dt:.4f} s = {len(c_rows) / c_dt:.0f} checks/s (repeats: "
        f"{', '.join(f'{len(c_rows) / x:.0f}' for x in c_more)} checks/s); "
        f"leopard answered {c_cnt['leopard_answered']}, fallbacks "
        f"{c_cnt['fallbacks']}; launches {c_launch}; host ms per phase "
        f"{c_phases}")
    if list(c_out) != list(c_want):
        raise AssertionError("unfused membership verdicts != fused ones")
    c_chunks = -(-len(c_rows) // leng.max_batch)
    if c_cnt["leopard_answered"] != len(c_rows) or c_cnt["fallbacks"]:
        raise AssertionError(f"path C: tier 0 answered "
                             f"{c_cnt['leopard_answered']} of {len(c_rows)}")
    if c_launch["leo_probe"] != c_chunks or sum(c_shapes.values()) != c_chunks:
        raise AssertionError(f"leo_probe launched {c_launch['leo_probe']} "
                             f"times for {c_chunks} chunks")
    log(f"[9] unfused path: verdicts equal path A's; K6 launched once per "
        f"chunk, its hits (kernel == plain) equal to the verdicts (every row "
        f"is a pair within the depth budget or a miss) "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 10. path D: the deep-groups fixture -----------------------------------
    t0 = time.perf_counter()
    deng, dq = deep_engine()
    doracle = CheckEngine(deng.store, deng.namespace_manager,
                          max_depth=DEEP_MAX_DEPTH)
    d_stats = {}
    for rest in (0, DEEP_REST):
        want = np.array([doracle.check_is_member(q, rest) for q in dq])
        deng.batch_check(dq, rest)  # warm
        d_out, d_dt, d_launch, d_cnt, d_shapes, _ph, _m = timed(deng, dq, rest, 0)
        d_out = np.asarray(d_out)
        tag = f"deep-{rest}"
        d_replay = replay_waves(deng, dq, rec, tag, rest)
        hold_timed_shapes(deng, dq, rec, tag, d_shapes, rest)
        active = sum(int((((o[:pl.n] >> 6) & 1) == 0)[~(pl.err | pl.general)].sum())
                     for pl, o, _a, _f in d_replay)
        if (d_out != want).any():
            raise AssertionError(f"deep checks at rest depth {rest} != oracle")
        if (np.concatenate([a for _p, _o, a, _f in d_replay]) != d_out).any():
            raise AssertionError("deep batch_check != the wave replay")
        require_launched(d_launch, ("wave_tier0", "wave_lane", "wave_pack",
                                    *WAVE_FAST_KERNELS), f"deep path {rest}")
        require_wave_launches(d_launch, d_shapes, f"deep path {rest}")
        d_stats[rest] = dict(checks_per_s=round(len(dq) / d_dt),
                             allowed=int(d_out.sum()),
                             leopard_answered=d_cnt["leopard_answered"],
                             tier1_active=active, fallbacks=d_cnt["fallbacks"])
    if d_stats[0]["leopard_answered"] != len(dq) or d_stats[0]["tier1_active"]:
        raise AssertionError(f"deep checks at max depth left tier 0: {d_stats}")
    if not d_stats[DEEP_REST]["tier1_active"]:
        raise AssertionError("deep checks at the short rest depth never "
                             "reached tier 1")
    # hand-set probe modes: LM_ALLOW / LM_HIT_ONLY come only from the
    # closure fold, which the engine does not run yet; at the max depth the
    # hits are within the budget (LM_HIT_ONLY answers them), at rest depth
    # 10 they are not
    modes = {}
    for rest in (0, DEEP_REST):
        plan = deng.plan_wave(dq[: deng.max_batch], rest)
        qmodes = plan.qpack.copy()
        qmodes[7] = np.random.default_rng(SEED_MODES).integers(
            0, 5, qmodes.shape[1]).astype(np.int32)
        res = check_wave(plan, rec, (f"deep-modes-{rest}", wave_key(plan)),
                         qpack=qmodes)
        modes[rest] = {int(m): int(((res[:plan.n] >> 6) & 1)[
            qmodes[7][:plan.n] == m].sum()) for m in range(5)}
    if not modes[0][4]:
        raise AssertionError("no LM_HIT_ONLY row was answered at the max depth")
    log(f"[10] deep groups ({DEEP_CHAINS} chains x {DEEP_DEPTH}, "
        f"{len(deng.store)} tuples, max depth {DEEP_MAX_DEPTH}): "
        f"{len(dq)} root checks per run; at the max depth {d_stats[0]}; at "
        f"rest depth {DEEP_REST} {d_stats[DEEP_REST]}; verdicts equal the "
        f"oracle's and the wave replay; a wave with hand-set probe modes at "
        f"each depth (rows answered per mode {modes}) == plain wave "
        f"({time.perf_counter() - t0:.1f} s)")
    for name in (*LEO_KERNELS, *WAVE_KERNELS):
        log(f"[10] {name}: {len(rec.calls[name])} calls, kernel == plain (max "
            f"abs err {rec.err[name]})")

    return SimpleNamespace(
        leng=leng, state=state, memb=memb, a_replay=a_replay,
        b_replay=b_replay, a=(a_dt, a_launch, a_shapes, a_phases, a_by_shape),
        b=(b_dt, b_launch, b_shapes, b_phases, b_by_shape), c_launch=c_launch,
        c_shapes=c_shapes)


# -- phase 12: writes served in O(delta) -----------------------------------------

WRITE_PAIRS = 16  # memberships added, and base memberships deleted, in (a)
WRITE_BURST = 4200  # membership writes of (d): past the overlay's 4,096 pairs
WRITE_SAMPLE = 256  # sampled rows checked against the oracle after each write
SEED_WRITES = 37
#: the kernels that read the overlay's tables or bits
OVERLAY_KERNELS = ("probe_level", "pack_verdicts", "gen_classify", "wave_lane")


def write_script(graph, rng):
    """The write batches, each with the check rows that touch what it
    wrote, the tier the write path must take and the closure index's
    outcome: (a1) memberships added to nested groups and base memberships
    deleted, (a2) the added ones removed, (b) a new Doc (a virtual node,
    a dirty one through its parents edge), (c) a group nested in another
    (a dirty row), (d) a burst past the overlay's capacity.  Yields one
    batch at a time (a later batch reads the graph an earlier one wrote)."""
    from ketotpu_torch.api.types import RelationTuple

    T = RelationTuple.from_string
    store = graph.store
    cols, alive, _tail, _head = store.export_columns()
    v = store.vocab
    alive = np.asarray(alive, bool)
    objs = v.objects.strings()
    n_groups, n_users = len(graph.groups), len(graph.users)

    def members(g_idx, k):
        """k direct members of group g_idx (user i is in group i % G)."""
        return [f"u{g_idx + n_groups * j}" for j in range(k)
                if g_idx + n_groups * j < n_users]

    def viewer_folders(g_idx):
        m = (alive & (cols["ns"] == v.namespaces.lookup("Folder"))
             & (cols["rel"] == v.relations.lookup("viewers"))
             & (cols["is_set"] == 1) & (cols["s_obj"] == v.objects.lookup(
                 f"g{g_idx}")))
        return [objs[o] for o in cols["obj"][m][:2]]

    def docs_under(folder, k):
        m = (alive & (cols["ns"] == v.namespaces.lookup("Doc"))
             & (cols["rel"] == v.relations.lookup("parents"))
             & (cols["s_obj"] == v.objects.lookup(folder)))
        return [objs[o] for o in cols["obj"][m][:k]]

    # (a1) nested children g(3k+1): their parent g(3k) sees the new member
    kids = 1 + 3 * rng.choice((n_groups - 1) // 3, WRITE_PAIRS, replace=False)
    added = []
    rows = []
    for x in kids.tolist():
        y = int(rng.integers(n_users))
        if y % n_groups == x:
            y = (y + 1) % n_users
        added.append(f"Group:g{x}#members@u{y}")
        rows += [f"Group:g{x}#members@u{y}", f"Group:g{x - 1}#members@u{y}"]
        rows += [f"Folder:{f}#view@u{y}" for f in viewer_folders(x)]
    gone = []
    for i in rng.choice(n_users, WRITE_PAIRS, replace=False).tolist():
        gone.append(f"Group:g{i % n_groups}#members@u{i}")
        rows.append(gone[-1])
        if i % n_groups % 3 == 1:
            rows.append(f"Group:g{i % n_groups - 1}#members@u{i}")
    yield ("a1", [T(t) for t in added], [T(t) for t in gone], rows,
           "overlay", "apply")
    yield ("a2", [], [T(t) for t in added], rows, "overlay", "apply")
    # (b) a new object: a virtual node through ovt_; its parents edge makes
    # it dirty as well
    doc = f"dnew{int(rng.integers(1 << 30))}"
    users = [f"u{int(u)}" for u in rng.choice(n_users, 4, replace=False)]
    folder = graph.folders[int(rng.integers(len(graph.folders)))]
    new = [f"Doc:{doc}#viewers@{users[0]}", f"Doc:{doc}#owners@{users[1]}",
           f"Doc:{doc}#parents@Folder:{folder}"]
    rows = [f"Doc:{doc}#{rel}@{u}" for u in users
            for rel in ("viewers", "owners", "view", "edit")]
    yield ("b", [T(t) for t in new], [], rows, "overlay", "rebuild")
    # (c) nest g(b) in a group g(a) that views a folder: g(a)'s row is dirty
    m = (alive & (cols["ns"] == v.namespaces.lookup("Folder"))
         & (cols["rel"] == v.relations.lookup("viewers"))
         & (cols["is_set"] == 1))
    pick = int(rng.choice(np.flatnonzero(m)))
    folder, ga = objs[cols["obj"][pick]], objs[cols["s_obj"][pick]]
    gb = int(rng.integers(n_groups))
    if f"g{gb}" == ga:
        gb = (gb + 1) % n_groups
    us = members(gb, 8)
    rows = [f"Group:{ga}#members@{u}" for u in us]
    rows += [f"Folder:{folder}#view@{u}" for u in us]
    rows += [f"Doc:{d}#{rel}@{u}" for d in docs_under(folder, 4) for u in us
             for rel in ("view", "edit")]
    yield ("c", [T(f"Group:{ga}#members@Group:g{gb}#members")], [], rows,
           "overlay", "apply")
    # (d) a burst of new memberships: the overlay overflows, the changes
    # since the base fold into it
    burst = set()
    while len(burst) < WRITE_BURST:
        x, y = int(rng.integers(n_groups)), int(rng.integers(n_users))
        if y % n_groups != x:
            burst.add(f"Group:g{x}#members@u{y}")
    burst = sorted(burst)
    yield ("d", [T(t) for t in burst], [], burst, "fold", None)


def write_phase(graph, leng, samples, rec: Recorder):
    """Phase 12: the write batches of :func:`write_script` on the fused
    engine with Leopard on, each followed by one ``batch_check`` of the
    rows it touched plus sampled rows: every verdict against the oracle,
    the tier and the closure outcome against the expected ones, the write
    to next verdict wall split into its steps, the launches of that check,
    and, on the tables the check read, every tier-1 kernel (the probe's
    overlay branches and the dirty bit of the verdict byte), every tier-2
    kernel and every wave kernel held against its plain version.  Then the
    ``ov_dirty`` upload, and a full re-projection plus closure build for
    comparison.  Returns what the kernel line reads."""
    from ketotpu_torch import kernels
    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.engine import delta as dl
    from ketotpu_torch.engine.device import upload
    from ketotpu_torch.engine.oracle import CheckEngine

    from ketotpu_torch.api.types import SubjectSet

    rng = np.random.default_rng(SEED_WRITES)
    store = graph.store
    oracle = CheckEngine(store, graph.manager)
    report = {}
    touched = {}  # the subject sets the writes touched, in write order
    c_tables = None  # batch c's tables: the overlay kernels are timed there
    for name, ins, dels, rows, tier, leo_want in write_script(graph, rng):
        if leo_want is None:
            # the burst's delta pairs (at least one per new membership)
            # pass the closure index's budget: it rebuilds, as in JAX
            budget = leng._leo.index.rebuild_delta_pairs
            leo_want = "rebuild" if len(ins) > budget else "apply"
        rows = [RelationTuple.from_string(r) for r in rows]
        sample = [samples[i] for i in rng.choice(len(samples), WRITE_SAMPLE,
                                                 replace=False)]
        checks = rows + sample
        before = {k: getattr(leng, k) for k in (
            "rebuilds", "overlay_applies", "folds", "fallbacks")}
        shapes0 = leng._array_shapes(leng._device_arrays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.transact_relation_tuples(insert=ins, delete=dels)
        t1 = time.perf_counter()
        kernels.reset_launches()
        out = leng.batch_check(checks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)
        w = dict(leng.last_write)
        moved = {k: getattr(leng, k) - v for k, v in before.items()}
        want = [oracle.check_is_member(q) for q in checks]
        if out != want:
            bad = [str(q) for q, a, b in zip(checks, out, want) if a != b][:4]
            raise AssertionError(f"write batch {name}: verdicts != oracle {bad}")
        if (w.get("tier"), w.get("leopard")) != (tier, leo_want):
            raise AssertionError(f"write batch {name}: tier {w.get('tier')}, "
                                 f"closure {w.get('leopard')}; expected "
                                 f"{tier}, {leo_want}")
        if moved["rebuilds"]:
            raise AssertionError(f"write batch {name} re-projected the store")
        if tier == "fold" and (moved["folds"] != 1 or leng._array_shapes(
                leng._device_arrays) != shapes0):
            raise AssertionError(f"write batch {name}: folds {moved['folds']}, "
                                 "device shapes changed")
        require_launched(launches, ("wave_tier0", "wave_lane", "wave_pack",
                                    *WAVE_FAST_KERNELS), f"write batch {name}")
        # the tables this check read (the overlay non-empty before the
        # fold of d, then d's base tables spliced in place), every kernel
        # held against its plain version on them: the tier-1 pass (its
        # dirty bits counted), the general rows and the waves
        g = leng.device_tables()
        tag = f"writes-{name}"
        qpack, err, general = leng.pack_queries(checks)
        shape = (qpack.shape[1], leng.frontier, leng.arena, 1)
        codes, _occ = check_kernels(g, qpack, schedule(shape, leng.max_depth),
                                    leng.max_width, rec, (tag, shape))
        codes = codes[: len(checks)]
        unfound = ~(err | general) & ((codes & 1) == 0)
        dirty = int((((codes >> 2) & 1) == 1)[unfound].sum())
        _gi, _ga, _gfb, gstats = replay_general(leng, g, checks, rec,
                                                tag + "-gen")
        gdirty = gstats.get("dirty", 0)
        wreplay = replay_waves(leng, checks, rec, tag + "-fused")
        w_allowed = np.concatenate([a for _p, _o, a, _f in wreplay])
        w_fb = np.concatenate([f for _p, _o, _a, f in wreplay])
        if (w_allowed[~w_fb] != np.asarray(out)[~w_fb]).any():
            raise AssertionError(f"write batch {name}: batch_check != the "
                                 "wave replay")
        if name == "c":
            if not (dirty and gstats["general"]):
                raise AssertionError("batch c: no dirty tier-1 row or no "
                                     "general row to hold the overlay's "
                                     "branches")
            c_tables = (g, leng.leopard_index().tables, tag)
        total = t2 - t0
        check_s = (t2 - t1) - w.get("total_s", 0.0)
        report[name] = dict(
            inserts=len(ins), deletes=len(dels), rows=len(checks),
            touched_rows=len(rows), tier=w.get("tier"),
            leopard=w.get("leopard"),
            write_to_verdict_ms=round(total * 1e3, 3),
            store_write_ms=round((t1 - t0) * 1e3, 3),
            drain_ms=round((w.get("drain_s", 0.0) + w.get("leopard_s", 0.0))
                           * 1e3, 3),
            closure_ms=round(w.get("leopard_s", 0.0) * 1e3, 3),
            build_ms=round(w.get("build_s", 0.0) * 1e3, 3),
            upload_ms=round(w.get("upload_s", 0.0) * 1e3, 3),
            check_ms=round(check_s * 1e3, 3),
            dirty_rows=dirty, general_dirty_rows=gdirty,
            fallbacks=moved["fallbacks"], allowed=int(sum(out)),
            launches={k: c for k, c in launches.items() if c},
            overlay=leng.projection_stats()["overlay_pairs"],
            fold_phases_ms=({k: round(v * 1e3, 3)
                             for k, v in leng.last_build_phases.items()}
                            if tier == "fold" else None),
        )
        log(f"[12] write batch {name}: {json.dumps(report[name])}")
        # Expand of the roots the writes touched: after c on the overlay
        # (a virtual node, a dirty row), after d on the folded base
        mine = {}
        for t in [*ins, *dels]:
            mine.setdefault(SubjectSet(t.namespace, t.object, t.relation), None)
        if name == "d":
            expand_written(leng, graph, [*touched, *list(mine)[:EXPAND_WRITE_ROOTS]],
                           rec, name)
        touched.update(mine)
        if name == "c":
            expand_written(leng, graph, list(touched), rec, name)
    # the overlay's upload: ov_dirty alone, and the whole overlay, re-shipped
    # as the engine ships it after a write (median of 5, synchronized)
    ov = dl.overlay_arrays(leng._overlay, leng._snap,
                           pair_cap=leng.max_overlay_pairs)
    up = {}
    for label, arrays in (("ov_dirty", {"ov_dirty": ov["ov_dirty"]}),
                          ("overlay", ov)):
        per = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upload(arrays, leng.device)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        up[label] = round(float(np.median(per)), 3)
    # a full re-projection plus closure build of the same store, for
    # comparison with the writes above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leng.refresh()
    torch.cuda.synchronize()
    full = dict(wall_ms=round((time.perf_counter() - t0) * 1e3, 3),
                projection_ms=round(leng.projection_build_s * 1e3, 3),
                upload_ms=round(leng.projection_upload_s * 1e3, 3),
                closure_ms=round(leng.leopard_index().index.build_s * 1e3, 3))
    log(f"[12] ov_dirty ({ov['ov_dirty'].shape[0]} bools) upload "
        f"{up['ov_dirty']} ms, the whole overlay {up['overlay']} ms; a full "
        f"re-projection + closure build of the written store: {json.dumps(full)}")
    for k in OVERLAY_KERNELS:
        n = sum(1 for t, _a, _k in rec.calls[k] if t and t[0].startswith("writes"))
        log(f"[12] {k}: {n} calls on the written tables, kernel == plain (max "
            f"abs err {rec.err[k]})")
    # the overlay kernels timed on batch c's tables (added, deleted and
    # virtual entries, dirty rows)
    g_c, lg_c, tag = c_tables
    timed_ov = {}
    for ds, names, tables in ((tag, ("probe_level", "pack_verdicts"), g_c),
                              (tag + "-gen", ("gen_classify",), g_c),
                              (tag + "-fused", ("wave_lane",), lg_c)):
        for k, per in time_kernels(tables, rec, ds, names).items():
            n = sum(r["calls"] for r in per.values())
            timed_ov[k] = {key: sum(r[key] * r["calls"] for r in per.values()) / n
                           for key in ("ms", "plain_ms", "bound_ms")}
            timed_ov[k]["calls"] = n
            log(f"[12] {k} with batch c's overlay: {timed_ov[k]['ms']:.4f} "
                f"ms/launch on the card, plain {timed_ov[k]['plain_ms']:.4f} ms, "
                f"bound {timed_ov[k]['bound_ms']:.6f} ms (bytes), mean of {n} "
                f"calls")
    return SimpleNamespace(report=report, upload_ms=up, full=full,
                           timed=timed_ov)

# -- phase 13: Expand (K9) ------------------------------------------------------

#: bench.py:934-982, the JAX package's config #3: depth-5 Expand of 512
#: Doc#parents roots drawn with default_rng(11) over the 10M graph
EXPAND_ROOTS, EXPAND_DEPTH, SEED_EXPAND = 512, 5, 11
EXPAND_SAMPLE = 64  # timed roots whose trees are held against the oracle
EXPAND_LATENCY_N = 20  # single-root calls (bench.py:567-580)
EXPAND_REPEATS = 3
EXPAND_OVER_CAP = 256  # a cap at which the 512-root walk overflows
#: Group#members and Folder#viewers roots each (deeper trees; a group of
#: the 10M graph has about 48 direct members, past the default fan-out 16)
EXPAND_WIDE = 64
EXPAND_WRITE_ROOTS = 64  # of batch d's groups
#: the over roots' walk at 4x fan-out and cap (a retry on the card, as the
#: check path's, would run it so)
EXPAND_WIDE_SCALE = 4
SEED_EXPAND_SAMPLE = 41


class GCPauses:
    """The interpreter's garbage-collection pauses while registered
    (``gc.callbacks``): (generation, ms) per collection."""

    def __init__(self):
        self.pauses = []
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                round((time.perf_counter() - self._t) * 1e3, 3)))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def tree_json(t):
    return None if t is None else t.to_json()


def hold_expand(g, vocab, roots, rec: Recorder, dataset, cap=65536,
                fanout=16):
    """The Expand walk of ``roots`` at rest depth 5 on the tables ``g``,
    as the engine enqueues it: step by step with each kernel (K9 and its
    K4) held against its plain version (tolerance 0), then whole on the
    kernels and whole on the plain versions, the packed buffers (every
    level record and ``over``) equal.  Returns the walk's shape and the
    over bits of the roots."""
    from ketotpu_torch.engine import expand_device as xd

    block = xd.encode_roots(vocab, roots)
    block[4, :len(roots)] = EXPAND_DEPTH
    sched = xd.expand_schedule(block.shape[1], fanout, EXPAND_DEPTH, cap)
    shape = ("expand", block.shape[1], sched)
    rec.tag = (dataset, shape)
    rec.dispatches[rec.tag] += 1
    rb = torch.from_numpy(block).to(g["row_ptr"].device)
    stepped = xd.expand_levels(g, rb, sched, rec.expand_ops())
    rec.tag = None
    whole = xd.expand_levels(g, rb, sched)
    plain = xd.expand_levels(g, rb, sched, xd.PLAIN_OPS)
    if not (torch.equal(stepped, whole) and torch.equal(whole, plain)):
        raise AssertionError(f"{dataset}: the kernel walk's records differ "
                             "from the plain walk's")
    _levels, over = xd.unpack(whole.cpu().numpy(), sched, block.shape[1])
    return shape, over[:len(roots)]


def hold_served(leng, g, vocab, roots, rec: Recorder, dataset, info,
                cap=None):
    """The walk one ``batch_expand`` of ``roots`` made on the tables ``g``
    (``info`` is its ``last_expand``; ``cap`` the ``EXPAND_CAP`` it ran
    at), held by :func:`hold_expand`, its shape and over bits checked
    against ``info``.  Returns (launches per shape of each expand kernel,
    the indices of the over roots: the oracle's)."""
    from ketotpu_torch.engine import device as tdev

    cap = tdev.EXPAND_CAP if cap is None else cap
    shape, over = hold_expand(g, vocab, roots, rec, dataset, cap=cap,
                              fanout=tdev.EXPAND_FANOUT)
    idx = np.flatnonzero(over)
    if shape[1:] != (info["roots"], info["schedule"]) or len(idx) != info["over"]:
        raise AssertionError(f"{dataset}: the engine's walk {info} is not "
                             f"{shape_name(shape)} with {len(idx)} over")
    by_shape = {"expand_roots": {shape: 1},
                "expand_level": {shape: len(shape[2]) - 1}}
    return by_shape, idx


def wide_walk(leng, roots, oracle):
    """The walk of ``roots`` at ``EXPAND_WIDE_SCALE``x the engine's fan-out
    and cap on the engine's served view, assembled as the engine
    assembles (``expand_device.run_expand``), synchronized.  Returns
    (trees, over bits, ms)."""
    from ketotpu_torch.engine import device as tdev
    from ketotpu_torch.engine import expand_device as xd

    snap, tables, ov = leng.expand_view()
    t0 = time.perf_counter()
    trees, over = xd.run_expand(
        tables, snap, roots, EXPAND_DEPTH, max_depth=leng.max_depth,
        fanout=tdev.EXPAND_FANOUT * EXPAND_WIDE_SCALE,
        cap=tdev.EXPAND_CAP * EXPAND_WIDE_SCALE, ov=ov,
        sub_expand=oracle._build)
    torch.cuda.synchronize()
    return trees, over, (time.perf_counter() - t0) * 1e3


def hold_trees(trees, roots, oracle, what):
    bad = [str(r) for r, t in zip(roots, trees)
           if tree_json(t) != tree_json(oracle.build_tree(r, EXPAND_DEPTH))]
    if bad:
        raise AssertionError(f"{what}: trees differ from the oracle's: {bad[:4]}")


def expand_written(leng, graph, roots, rec: Recorder, name):
    """Phase 12's Expand after a write batch: the touched roots' trees on
    the live store's oracle, and the walk's kernels held against their
    plain versions on the overlay's tables."""
    from ketotpu_torch.engine import device as tdev
    from ketotpu_torch.engine.oracle import ExpandEngine

    oracle = ExpandEngine(graph.store, max_depth=leng.max_depth)
    f0 = leng.fallbacks
    t0 = time.perf_counter()
    trees = leng.batch_expand(roots, EXPAND_DEPTH)
    dt = time.perf_counter() - t0
    info = dict(leng.last_expand)
    if leng.fallbacks - f0 != info["over"]:
        raise AssertionError(f"write batch {name}: fallbacks vs {info}")
    hold_trees(trees, roots, oracle, f"expand after write batch {name}")
    snap, tables, ov = leng.expand_view()
    _b, idx = hold_served(leng, tables, snap.vocab, roots, rec,
                          f"expand-writes-{name}", info)
    # the over roots from the card too, at 4x: the overlay merged into
    # nested trees
    sub = [roots[i] for i in idx]
    wshape = None
    if sub:
        wtrees, wover, _ms = wide_walk(leng, sub, oracle)
        if wover.any():
            raise AssertionError(f"write batch {name}: the 4x walk overflowed")
        hold_trees(wtrees, sub, oracle, f"expand after write batch {name}, 4x")
        wshape, _o = hold_expand(
            tables, snap.vocab, sub, rec, f"expand-writes-{name}",
            cap=tdev.EXPAND_CAP * EXPAND_WIDE_SCALE,
            fanout=tdev.EXPAND_FANOUT * EXPAND_WIDE_SCALE)
    added = 0 if ov is None else sum(len(v) for v in ov.added.values())
    deleted = 0 if ov is None else sum(len(v) for v in ov.deleted.values())
    log(f"[12] expand after write batch {name}: {len(roots)} touched roots "
        f"({sum(t is not None for t in trees)} trees, "
        f"{sum(len(json.dumps(tree_json(t))) for t in trees)} JSON bytes) in "
        f"{dt * 1e3:.3f} ms, equal to the oracle's on the live store; overlay "
        f"members merged on the host: {added} added, {deleted} deleted; "
        f"{info['over']} roots over at {info['schedule']}, answered by the "
        f"oracle; from the card at {EXPAND_WIDE_SCALE}x "
        f"({shape_name(wshape) if wshape else 'none over'}) their trees equal "
        f"the oracle's too; both walks on the served tables, kernel == plain")


def expand_phase(graph, leng, rec: Recorder):
    """Phase 13: the Expand path on path A's engine (fused, Leopard on, the
    10M graph): the expand-only upload, a warm 512-root batch, timed
    repeats (trees/s, host ms per phase, launches per batch, the
    schedule), single-root latency, the gates (kernels == plain at every
    shape used, 64 sampled trees and 128 Group / Folder trees == the
    oracle's, the over ones also from the card at 4x, an overflowing cap
    sending exactly the over roots to the oracle) and the kernels' timing
    on both walks.  Returns the kernel line's entries."""
    from ketotpu_torch import kernels
    from ketotpu_torch.api.types import SubjectSet
    from ketotpu_torch.engine import device as tdev
    from ketotpu_torch.engine import expand_device as xd
    from ketotpu_torch.engine.oracle import ExpandEngine

    rng = np.random.default_rng(SEED_EXPAND)
    roots = [SubjectSet("Doc", graph.docs[int(rng.integers(len(graph.docs)))],
                        "parents") for _ in range(EXPAND_ROOTS)]
    oracle = ExpandEngine(graph.store, max_depth=leng.max_depth)
    t0 = time.perf_counter()
    warm = leng.batch_expand(roots, EXPAND_DEPTH)
    torch.cuda.synchronize()
    log(f"[13] warm batch_expand of {EXPAND_ROOTS} Doc#parents roots at depth "
        f"{EXPAND_DEPTH}: {time.perf_counter() - t0:.3f} s, the expand-only "
        f"upload included ({leng.expand_upload_bytes} bytes in "
        f"{leng.expand_upload_s * 1e3:.3f} ms, synchronized)")
    sched = leng.last_expand["schedule"]
    runs = []
    for i in range(EXPAND_REPEATS):
        f0 = leng.fallbacks
        leng.phase_seconds.clear()
        kernels.reset_launches()
        with GCPauses() as gcp:
            t0 = time.perf_counter()
            trees = leng.batch_expand(roots, EXPAND_DEPTH)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        phases = {k: round(v * 1e3, 3) for k, v in leng.phase_seconds.items()
                  if k.startswith("expand_")}
        runs.append((dt, launches, phases, leng.fallbacks - f0))
        if [tree_json(t) for t in trees] != [tree_json(t) for t in warm]:
            raise AssertionError("a timed batch_expand differs from the warm one")
        log(f"[13] timed batch_expand {i}: {EXPAND_ROOTS} trees in {dt:.4f} s "
            f"= {EXPAND_ROOTS / dt:.1f} trees/s; oracle fallbacks "
            f"{runs[-1][3]}; host ms per phase {phases}; garbage-collection "
            f"pauses (generation, ms) {gcp.pauses}; launches "
            f"{ {k: c for k, c in launches.items() if c} }")
    launches = runs[0][1]
    require_launched(launches, ("expand_roots", "expand_level", "arena_assign"),
                     "the Expand path")
    if launches["expand_roots"] != 1 or launches["expand_level"] != len(sched) - 1:
        raise AssertionError(f"Expand launches {launches} for schedule {sched}")
    log(f"[13] schedule {sched} (padded roots {leng.last_expand['roots']}); "
        f"launches per batch { {k: c for k, c in launches.items() if c} }; "
        f"{sum(t is not None for t in trees)} "
        f"trees, {sum(len(t.children) for t in trees if t)} children")
    # single-root latency (bench.py:567-580)
    leng.batch_expand(roots[:1], EXPAND_DEPTH)
    calls = []
    for _ in range(EXPAND_LATENCY_N):
        leng.phase_seconds.clear()
        with GCPauses() as gcp:
            t0 = time.perf_counter()
            leng.batch_expand(roots[:1], EXPAND_DEPTH)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        calls.append((ms, {k: round(v * 1e3, 3)
                           for k, v in leng.phase_seconds.items()}, gcp.pauses))
    lats = sorted(c[0] for c in calls)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    slow = max(calls, key=lambda c: c[0])
    t0 = time.perf_counter()
    xd.Decoder(leng.snapshot().vocab)
    dec_ms = (time.perf_counter() - t0) * 1e3
    log(f"[13] single-root batch_expand over {EXPAND_LATENCY_N} calls: p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms (schedule "
        f"{leng.last_expand['schedule']}); every call in ms "
        f"{[round(c[0], 3) for c in calls]}; garbage-collection ms per call "
        f"{[round(sum(p[1] for p in c[2]), 3) for c in calls]}; the slowest's "
        f"host phases {slow[1]} and collections (generation, ms) {slow[2]}; "
        f"one reverse-vocab build (expand_device.Decoder, inside assemble) "
        f"{dec_ms:.3f} ms")

    # -- gates ---------------------------------------------------------------
    t0 = time.perf_counter()
    snap, g, _ov = leng.expand_view()
    shape, over = hold_expand(g, snap.vocab, roots, rec, "expand")
    if over.any():
        raise AssertionError("the served walk overflowed")
    one, _ = hold_expand(g, snap.vocab, roots[:1], rec, "expand")
    pick = np.random.default_rng(SEED_EXPAND_SAMPLE).choice(
        EXPAND_ROOTS, EXPAND_SAMPLE, replace=False)
    hold_trees([trees[i] for i in pick], [roots[i] for i in pick], oracle,
               "sampled Doc#parents roots")
    rng = np.random.default_rng(SEED_EXPAND_SAMPLE)
    wide = [SubjectSet("Group", graph.groups[int(i)], "members") for i in
            rng.choice(len(graph.groups), EXPAND_WIDE, replace=False)]
    wide += [SubjectSet("Folder", graph.folders[int(i)], "viewers") for i in
             rng.choice(len(graph.folders), EXPAND_WIDE, replace=False)]
    f0 = leng.fallbacks
    kernels.reset_launches()
    t1 = time.perf_counter()
    wtrees = leng.batch_expand(wide, EXPAND_DEPTH)
    torch.cuda.synchronize()
    wdt = time.perf_counter() - t1
    wlaunch = dict(kernels.LAUNCHES)
    winfo = dict(leng.last_expand)
    if leng.fallbacks - f0 != winfo["over"]:
        raise AssertionError(f"the wide roots: fallbacks vs {winfo}")
    hold_trees(wtrees, wide, oracle, "Group#members and Folder#viewers roots")
    wby, wover = hold_served(leng, g, snap.vocab, wide, rec, "expand-wide",
                             winfo)
    if any(sum(wby[n].values()) != wlaunch[n] for n in EXPAND_KERNELS):
        raise AssertionError(f"the wide roots: launches {wlaunch} vs {wby}")
    # the over roots from the card at 4x, as a retry would serve them: the
    # trees against the oracle's, the walk held, and the time against the
    # oracle's on the same roots, alternated
    sub = [wide[i] for i in wover]
    sshape = None
    if sub:
        strees, sover, _ms = wide_walk(leng, sub, oracle)
        if sover.any():
            raise AssertionError("the 4x walk of the over wide roots overflowed")
        hold_trees(strees, sub, oracle, "the over wide roots at 4x")
        sshape, _o = hold_expand(
            g, snap.vocab, sub, rec, "expand-wide-4x",
            cap=tdev.EXPAND_CAP * EXPAND_WIDE_SCALE,
            fanout=tdev.EXPAND_FANOUT * EXPAND_WIDE_SCALE)
        cmp_ = {"card": [], "oracle": []}
        for side in ("card", "oracle", "oracle", "card", "card", "oracle"):
            with GCPauses() as gcp:
                if side == "card":
                    ms = wide_walk(leng, sub, oracle)[2]
                else:
                    t1 = time.perf_counter()
                    [oracle.build_tree(r, EXPAND_DEPTH) for r in sub]
                    ms = (time.perf_counter() - t1) * 1e3
            cmp_[side].append((round(ms, 3),
                               round(sum(p[1] for p in gcp.pauses), 3)))
        for side, v in cmp_.items():
            log(f"[13] the {len(sub)} over wide roots "
                f"{'walked on the card at 4x and assembled' if side == 'card' else 'built by the oracle'}: "
                f"median {float(np.median([x[0] for x in v])):.3f} ms; (ms, "
                f"garbage-collection ms) per call {v}")
    log(f"[13] {EXPAND_SAMPLE} sampled Doc#parents trees and {len(wide)} "
        f"Group#members / Folder#viewers trees "
        f"({sum(t is not None for t in wtrees)} non-empty, "
        f"{sum(len(json.dumps(tree_json(t))) for t in wtrees)} JSON bytes, "
        f"{wdt * 1e3:.3f} ms) equal the oracle's; at the engine's schedule "
        f"{winfo['schedule']}, {winfo['over']} of the {len(wide)} wide roots "
        f"overflowed and went to the oracle; their walk at "
        f"{EXPAND_WIDE_SCALE}x ({shape_name(sshape) if sshape else 'none'}) "
        f"gives the oracle's trees; launches {wlaunch['expand_roots']} + "
        f"{wlaunch['expand_level']}; every expand kernel == plain at "
        f"{shape_name(shape)}, {shape_name(one)}, "
        f"{[shape_name(s) for s in wby['expand_roots']]}, whole walks equal")
    # an overflowing cap: exactly the over roots go to the oracle
    asked = []

    class Asked(ExpandEngine):
        def build_tree(self, subject, rest_depth=0):
            asked.append(subject)
            return super().build_tree(subject, rest_depth)

    f0, cap0 = leng.fallbacks, tdev.EXPAND_CAP
    tdev.ExpandEngine, tdev.EXPAND_CAP = Asked, EXPAND_OVER_CAP
    try:
        capped = leng.batch_expand(roots, EXPAND_DEPTH)
        cinfo = dict(leng.last_expand)
    finally:
        tdev.ExpandEngine, tdev.EXPAND_CAP = ExpandEngine, cap0
    _cby, cover = hold_served(leng, g, snap.vocab, roots, rec, "expand-capped",
                              cinfo, cap=EXPAND_OVER_CAP)
    want = [roots[i] for i in cover]
    if not want or asked != want or leng.fallbacks - f0 != len(want):
        raise AssertionError(f"cap {EXPAND_OVER_CAP}: {len(asked)} roots sent to "
                             f"the oracle, {len(want)} over")
    if [tree_json(t) for t in capped] != [tree_json(t) for t in trees]:
        raise AssertionError(f"cap {EXPAND_OVER_CAP}: trees differ")
    log(f"[13] cap {EXPAND_OVER_CAP} (schedule {cinfo['schedule']}): "
        f"{len(want)} of {EXPAND_ROOTS} roots over, exactly those answered by "
        f"the oracle, every tree equal to the uncapped run's; gates in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- kernel timing -----------------------------------------------------------
    trows = time_kernels(g, rec, "expand", tuple(EXPAND_KERNELS))
    wrows = time_kernels(g, rec, "expand-wide", tuple(EXPAND_KERNELS))
    entries = []
    for name, (source, replaces) in EXPAND_KERNELS.items():
        per = trows[name]
        for ds, rows_ in (("expand", per), ("expand-wide", wrows[name])):
            for s2, r in rows_.items():
                log(f"[13] {name} at {shape_name(s2)} ({ds}): {r['ms']:.4f} "
                    f"ms/launch on the card (host enqueue incl. "
                    f"{r['host_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                    f"library none, bound {r['bound_ms']:.6f} ms (bytes), mean "
                    f"of {r['calls']} calls")
        lb, wper = {shape: launches[name]}, wrows[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec.err[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"), "bound_by": "bytes",
            "library_ms": None, "path": "expand",
            "launches_by_shape": {shape_name(shape): launches[name]},
            "ms_by_shape": {shape_name(s2): r["ms"]
                            for s2, r in {**per, **wrows[name]}.items()},
            "bound_ms_by_shape": {shape_name(s2): r["bound_ms"]
                                  for s2, r in {**per, **wrows[name]}.items()},
            "wide_path": {
                "launches": sum(wby[name].values()),
                "launches_by_shape": {shape_name(s2): c
                                      for s2, c in wby[name].items()},
                "ms": weighted(wper, wby[name], "ms"),
                "plain_ms": weighted(wper, wby[name], "plain_ms"),
                "bound_ms": weighted(wper, wby[name], "bound_ms")},
        })
    dt, _l, phases, _f = runs[0]
    busy = sum(per_[shape]["ms"] * launches[n] for n, per_ in trows.items())
    log(f"[13] where the timed Expand batch went: {dt * 1e3:.3f} ms wall; its "
        f"K9 kernels {busy:.4f} ms on the card (derived: measured ms per launch "
        f"x launches), host phases {phases} ms")
    return SimpleNamespace(entries=entries, runs=runs, p50=p50, p99=p99)


# -- phase 14: the graph-sharded mesh (K10) -------------------------------------

MESH_SHARDS = (1, 4)  # n = 1 on the first card; n = 4 as ["cuda:0"] * 4
MESH_TIMED_SAMPLE = 4  # calls timed per kernel and dispatch shape
SEED_MESH_WRITES = 59
#: the kernels with a mask input for the mesh (timed on its calls too)
MESH_MASKED = ("init_state", "gen_classify", "gen_construct", "gen_collect",
               "pack_scatter")


def mesh_replay(meng, chunk, rec: Recorder, dataset: str):
    """One chunk as the mesh engine answers it, step by step through
    ``rec`` (every kernel against its plain version): its tier-1 rows'
    sharded run at the first pass's caps and the retry of its over rows,
    its general rows' sharded program at the first pass's shapes and the
    retry's; each whole run's verdicts (and occupancy rows) against the
    plain run's.  Returns (allowed, fallback, stats) as the engine's
    collect computes them."""
    from ketotpu_torch.engine.device import _bucket
    from ketotpu_torch.parallel import graphshard as gs

    n = len(chunk)
    snap = meng.snapshot()
    enc = meng._encode(snap, chunk, 0)
    err, general = meng._classify(snap, enc[0], enc[2])
    act = ~(err | general)
    assign, _owner = meng._route_assign(enc[0], enc[1])
    allowed, fallback = np.zeros(n, bool), err.copy()
    stats = {"route_over_rows": 0, "fast_retried": 0, "fast_fallbacks": 0,
             "general": int(general.sum()), "general_retried": 0,
             "general_fallbacks": 0}
    ops = rec.mesh_ops()
    route = ops.route

    def counted(ch, qo, **kw):
        send, qo2 = route(ch, qo, **kw)
        stats["route_over_rows"] += int(((qo2 != 0) & (qo == 0)).sum())
        return send, qo2

    ops = ops._replace(route=counted)

    def fast(rows, act_, assign_, qpad, boost):
        frontier, arena = boost * meng.frontier, boost * meng.arena
        rec.tag = (dataset, (qpad, frontier, arena, boost))
        rec.dispatches[rec.tag] += 1
        m = len(act_)
        kw = dict(frontier=frontier, arena=arena, max_depth=meng.max_depth,
                  max_width=meng.max_width, active=np.pad(act_, (0, qpad - m)),
                  assign=np.pad(assign_, (0, qpad - m)))
        padded = meng._pad(rows, m, qpad)
        got = gs._sharded_fast(ops, meng._stacked, padded, meng.mesh, **kw)
        want = gs._sharded_fast(gs._PLAIN_OPS, meng._stacked, padded, meng.mesh,
                                **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"{dataset}: sharded run != plain run")
        return gs.ShardedResult.of(got)

    if act.any():
        res = fast(enc, act, assign, min(_bucket(n), meng.frontier), 1)
        found, over, dirty = res.found[:n], res.over[:n], res.dirty[:n]
        allowed[act] = found[act]
        fallback |= act & dirty & ~found
        unres = act & over & ~found & ~dirty
        ri = np.flatnonzero(unres)
        stats["fast_retried"] = len(ri)
        if len(ri):
            rres = fast(tuple(a[ri] for a in enc), np.ones(len(ri), bool),
                        assign[ri], min(_bucket(len(ri), 256), meng.frontier),
                        meng.retry_scale)
            rf = rres.found[: len(ri)]
            allowed[ri] = rf
            unres[ri] = (rres.over[: len(ri)] | rres.dirty[: len(ri)]) & ~rf
        fallback |= unres
        stats["fast_fallbacks"] = int(unres.sum() + (act & dirty & ~found).sum())

    def gen(rows, boost):
        qpack, sched = meng.pack_general(enc, rows, boost)
        rec.tag = (dataset, gen_key(qpack, boost, sched))
        rec.dispatches[rec.tag] += 1
        kw = dict(sizes=sched[0], fast_b=sched[1], fast_sched=sched[2],
                  max_width=meng.max_width, vcap=sched[3])
        got = gs.fetch_general(gs._sharded_general(ops, meng._stacked, qpack,
                                                   meng.mesh, **kw))
        want = gs.fetch_general(gs._sharded_general(
            gs._PLAIN_OPS, meng._stacked, qpack, meng.mesh, **kw))
        if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
            raise AssertionError(f"{dataset}: sharded general != plain program")
        return got[0][: len(rows)]

    if general.any():
        gi = np.flatnonzero(general)
        packed = gen(gi, 1)
        codes = (packed & 3).astype(np.int8)
        gover = ((packed >> 2) & 1).astype(bool)
        gdirty = ((packed >> 3) & 1).astype(bool)
        allowed[gi] = codes == 1
        gunres = gover & ~gdirty & (codes != 3)
        if gunres.any():
            ri = gi[np.flatnonzero(gunres)]
            stats["general_retried"] = len(ri)
            rp = gen(ri, meng.retry_scale)
            rcodes = (rp & 3).astype(np.int8)
            allowed[ri] = rcodes == 1
            gover[gunres] = (((rp >> 2) | (rp >> 3)) & 1).astype(bool) | (rcodes == 3)
            codes = codes.copy()
            codes[np.flatnonzero(gunres)] = rcodes
        gfb = gover | gdirty | (codes == 3)
        fallback[gi] |= gfb
        stats["general_fallbacks"] = int(gfb.sum())
    return allowed, fallback, stats


def mesh_serve(meng, traffic, name, rec: Recorder, dataset: str, keep: bool):
    """One traffic on a mesh engine: warmed twice (the general schedule
    freezes), replayed chunk by chunk (:func:`mesh_replay`; the served
    collect equal to the replay), then served with the launch counts
    reset just before and read just after.  Returns the timed run's
    numbers."""
    from ketotpu_torch import kernels

    mb = meng.max_batch
    w1 = meng.batch_check(traffic)
    w2 = meng.batch_check(traffic)
    if w1 != w2:
        raise AssertionError(f"{name}: the mesh's verdicts changed between warm runs")
    rec.keep = keep
    stats = Counter()
    for lo in range(0, len(traffic), mb):
        chunk = traffic[lo: lo + mb]
        a, fb, st = mesh_replay(meng, chunk, rec, dataset)
        sa, sfb = meng._collect(meng._dispatch(chunk, 0))
        if not (np.array_equal(a[~fb], sa[~sfb]) and np.array_equal(fb, sfb)):
            raise AssertionError(f"{name}: the served chunk != its replay")
        stats.update(st)
    rec.keep = True
    r0, gr0, f0 = meng.retries, meng.general_retries, meng.fallbacks
    meng.phase_seconds.clear()
    meng.dispatch_shapes.clear()
    meng.general_shapes.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = meng.batch_check(traffic)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    shapes = dict(meng.dispatch_shapes)
    shapes.update({("gen", q, b, sch): c
                   for (q, b, sch), c in meng.general_shapes.items()})
    phases = {k: round(v * 1e3, 3) for k, v in meng.phase_seconds.items()}
    retries, gretries = meng.retries - r0, meng.general_retries - gr0
    fallbacks = meng.fallbacks - f0
    more = []
    for _ in range(2):
        t1 = time.perf_counter()
        meng.batch_check(traffic)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t1)
    if out != w2:
        raise AssertionError(f"{name}: the timed batch differs from the warm batch")
    unheld = set(shapes) - rec.shapes(dataset)
    if unheld:
        raise AssertionError(f"{name}: dispatched at shapes never held: {unheld}")
    by_shape = expected_launches(rec.calls, rec.dispatches, dataset, shapes)
    for k in (*KERNELS, *GEN_KERNELS, *MESH_KERNELS):
        if sum(by_shape[k].values()) != launches[k]:
            raise AssertionError(f"{name}: {k} {launches[k]} launches, the "
                                 f"replay's {by_shape[k]} by dispatch shape")
    return SimpleNamespace(out=out, dt=dt, more=more, launches=launches,
                           shapes=shapes, by_shape=by_shape, phases=phases,
                           retries=retries, general_retries=gretries,
                           fallbacks=fallbacks, replay=dict(stats))


def mesh_phase(graph, engine, queries, mixed_q):
    """Phase 14: the graph-sharded mesh engine on the 10M graph at n = 1
    (the default device selection) and n = 4 (``["cuda:0"] * 4``): both
    traffics served, every kernel held step by step, verdicts against the
    single-device engine's (row for row) and sampled rows against the
    oracle's; at n = 4 two write batches (per-shard overlays; a dirty
    nested group to the oracle) and 512 Doc#parents trees through the
    replica against the single-device engine's; the new kernels timed.
    Returns the kernel line's entries for the mesh kernels and the mesh
    numbers of the masked ones."""
    from ketotpu_torch import kernels
    from ketotpu_torch.api.types import RelationTuple, SubjectSet
    from ketotpu_torch.parallel import MeshCheckEngine
    from ketotpu_torch.parallel import graphshard as gs

    rec = Recorder()
    t0 = time.perf_counter()
    ref = {"pure-OR": engine.batch_check(queries), "mixed": engine.batch_check(mixed_q)}
    single = {}
    for name, traffic in (("pure-OR", queries), ("mixed", mixed_q)):
        t1 = time.perf_counter()
        if engine.batch_check(traffic) != ref[name]:
            raise AssertionError(f"{name}: the single-device engine changed")
        single[name] = len(traffic) / (time.perf_counter() - t1)
    log(f"[14] single-device engine now (after phase 12's writes): pure-OR "
        f"{single['pure-OR']:.0f}, mixed {single['mixed']:.0f} checks/s "
        f"({time.perf_counter() - t0:.1f} s with its drain)")
    log(f"[14] torch.cuda.device_count() = {torch.cuda.device_count()}")
    sample = np.random.default_rng(SEED_SAMPLE)
    entries, masked, report = {}, {}, {}
    timing = None
    meng = None
    for n in MESH_SHARDS:
        meng = None
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        devices = None if n == 1 else ["cuda:0"] * n
        meng = MeshCheckEngine(graph.store, graph.manager, mesh_devices=n,
                               devices=devices, leopard={"enabled": False})
        meng.snapshot()
        torch.cuda.synchronize()
        stats = meng.shard_stats()
        log(f"[14] n = {n}: MeshCheckEngine(mesh_devices={n}, devices={devices}) "
            f"on {[str(d) for d in meng.mesh.devices]}; built in "
            f"{time.perf_counter() - t0:.2f} s: replicated snapshot "
            f"{meng.projection_build_s:.3f} s, sharded stacks "
            f"{meng.shard_build_s:.3f} s, their upload {meng.shard_upload_s:.3f} s; "
            f"per shard (nodes, bytes on the card): "
            f"{[(r['nodes'], r['device_bytes']) for r in stats]}")
        report[n] = {"build_s": meng.shard_build_s, "upload_s": meng.shard_upload_s,
                     "device_bytes": [r["device_bytes"] for r in stats]}
        for name, traffic in (("pure-OR", queries), ("mixed", mixed_q)):
            t0 = time.perf_counter()
            dataset = f"mesh{n}-{name}"
            r = mesh_serve(meng, traffic, name, rec, dataset, keep=n == 4)
            bad = np.flatnonzero(np.asarray(r.out) != np.asarray(ref[name]))
            if len(bad):
                raise AssertionError(f"n = {n} {name}: {len(bad)} verdicts differ "
                                     f"from the single-device engine's, first "
                                     f"{traffic[int(bad[0])]}")
            for i in sample.choice(len(traffic), ORACLE_SAMPLE // 2, replace=False):
                want = engine.oracle.check_is_member(traffic[i])
                if r.out[i] != want:
                    raise AssertionError(f"{traffic[i]}: mesh {r.out[i]} oracle {want}")
            missing = [k for k in MESH_KERNELS if name == "mixed" and r.launches[k] == 0]
            if missing:
                raise AssertionError(f"n = {n}: never launched on the mixed path: {missing}")
            report[(n, name)] = r
            log(f"[14] n = {n} {name}: {len(traffic)} checks in {r.dt:.4f} s = "
                f"{len(traffic) / r.dt:.0f} checks/s (repeats: "
                f"{', '.join(f'{len(traffic) / x:.0f}' for x in r.more)}; the "
                f"single-device engine {single[name]:.0f}); verdicts equal the "
                f"single-device engine's row for row and {ORACLE_SAMPLE // 2} "
                f"sampled rows the oracle's; retries {r.retries} (general "
                f"{r.general_retries}), oracle fallbacks {r.fallbacks}; replay "
                f"{r.replay}; host ms per phase {r.phases}; launches "
                f"{ {k: v for k, v in r.launches.items() if v} }; dispatches "
                f"{ {shape_name(k): v for k, v in r.shapes.items()} } "
                f"({time.perf_counter() - t0:.1f} s with the replay)")
    # -- n = 4: writes, then Expand ------------------------------------------
    from ketotpu_torch.engine.oracle import CheckEngine

    oracle = CheckEngine(graph.store, graph.manager)
    rng = np.random.default_rng(SEED_MESH_WRITES)
    for name, ins, dels, touched, tier, _leo in write_script(graph, rng):
        if name not in ("a1", "c"):
            continue
        f0, r0 = meng.fallbacks, meng.rebuilds
        t0 = time.perf_counter()
        graph.store.transact_relation_tuples(insert=ins, delete=dels)
        rows = [RelationTuple.from_string(r) for r in touched] + [
            mixed_q[int(i)] for i in rng.choice(len(mixed_q), WRITE_SAMPLE,
                                                replace=False)]
        got = meng.batch_check(rows)
        dt = time.perf_counter() - t0
        for q, v in zip(rows, got):
            if v != oracle.check_is_member(q):
                raise AssertionError(f"write batch {name}: {q}: mesh {v}")
        if meng.last_write.get("tier") != tier or meng.rebuilds != r0:
            raise AssertionError(f"write batch {name}: tier {meng.last_write}")
        pairs = sum(s["overlay_pairs"] for s in meng.shard_stats())
        dirty = sum(s["overlay_dirty"] for s in meng.shard_stats())
        log(f"[14] n = 4 write batch {name} (+{len(ins)} / -{len(dels)}): tier "
            f"{meng.last_write['tier']} (per-shard overlays: {pairs} pairs, "
            f"{dirty} dirty rows), write to next verdict {dt * 1e3:.3f} ms "
            f"(drain {meng.last_write.get('drain_s', 0) * 1e3:.3f}, overlay "
            f"build {meng.last_write.get('build_s', 0) * 1e3:.3f}, upload "
            f"{meng.last_write.get('upload_s', 0) * 1e3:.3f}); {len(rows)} rows "
            f"equal the oracle's; {meng.fallbacks - f0} to the oracle")
        if name == "c":
            if meng.fallbacks == f0:
                raise AssertionError("write batch c: no dirty row reached the oracle")
            break
    roots = [SubjectSet("Doc", graph.docs[int(i)], "parents") for i in
             np.random.default_rng(SEED_EXPAND).integers(len(graph.docs), size=EXPAND_ROOTS)]
    want = engine.batch_expand(roots, EXPAND_DEPTH)
    t0 = time.perf_counter()
    got = meng.batch_expand(roots, EXPAND_DEPTH)
    dt_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = meng.batch_expand(roots, EXPAND_DEPTH)
    dt = time.perf_counter() - t0
    if [tree_json(t) for t in got] != [tree_json(t) for t in want] or \
            [tree_json(t) for t in again] != [tree_json(t) for t in want]:
        raise AssertionError("Expand through the replica != the single-device engine")
    log(f"[14] n = 4 Expand: {EXPAND_ROOTS} Doc#parents trees through the replica "
        f"equal the single-device engine's; first call {dt_first:.3f} s (the "
        f"replica's upload), then {EXPAND_ROOTS / dt:.1f} trees/s; "
        f"{meng.last_expand.get('over', 0)} over")
    # -- timing: the new kernels and the masked ones on the n = 4 calls -------
    g0 = meng._stacked[0]
    t0 = time.perf_counter()
    rows = time_kernels(g0, rec, "mesh4-mixed", (*MESH_KERNELS, *MESH_MASKED),
                        sample=MESH_TIMED_SAMPLE)
    log(f"[14] kernels timed on the n = 4 mixed run's calls in "
        f"{time.perf_counter() - t0:.1f} s")
    merges = _sampled(rec.calls["shard_merge"], "mesh4-mixed", MESH_TIMED_SAMPLE)
    for _tag, args, _kw in merges:
        if not torch.equal(LIBRARY["shard_merge"](args, {}), gs.merge_bits(*args)):
            raise AssertionError("shard_merge: torch.amax differs from the kernel")
    log(f"[14] shard_merge's library call (torch.amax over the partials) equals "
        f"the kernel on the {len(merges)} timed calls")
    r4 = report[(4, "mixed")]
    for name in (*MESH_KERNELS, *MESH_MASKED):
        per, lb = rows[name], r4.by_shape[name]
        for s_, r in per.items():
            log(f"[14] {name} at {shape_name(s_)} (n = 4, mixed): {r['ms']:.4f} "
                f"ms/launch on the card (spread up to {r['spread_ms']}; host "
                f"{r['host_ms']:.4f} ms per eager call), plain {r['plain_ms']:.4f} "
                f"ms, bound {r['bound_ms']:.6f} ms (bytes), {lb.get(s_, 0)} "
                f"launches in the timed mixed run, mean of {r['calls']} sampled calls")
        entry = {
            "launches": r4.launches[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"),
            "launches_by_shape": {shape_name(s_): c for s_, c in lb.items()},
            "ms_by_shape": {shape_name(s_): per[s_]["ms"] for s_ in lb},
            "pure_or_launches": report[(4, "pure-OR")].launches[name],
            "n1_launches": {t: report[(1, t)].launches[name]
                            for t in ("pure-OR", "mixed")},
        }
        if name in MESH_KERNELS:
            source, replaces = MESH_KERNELS[name]
            entries[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": rec.err[name],
                "bound_by": "bytes", "library_ms": weighted(per, lb, "library_ms"),
                "path": "mesh4-mixed",
                **entry}
        else:
            masked[name] = entry
    return SimpleNamespace(entries=list(entries.values()), masked=masked,
                           report=report, engine=meng)


# -- phase 15: the tenant plane at 8,192 tenants (K5b) ------------------------------

#: networks on the plane (Keto's nid, persister.go:91-93; README
#: "Multi-tenancy"), plus the default network the plane always holds; the
#: last (smallest) network is created after the traffic
TENANTS = 8192
#: build_synth_columnar's scale (about 10.6M tuples), split over the
#: tenants by Zipf (s = 1) shares, at least one of each kind per tenant
TENANT_SCALE = dict(n_users=1_200_000, n_groups=25_000, n_folders=500_000,
                    n_docs=6_500_000)
TENANT_FANOUT = 4
SEED_TENANTS, SEED_TENANT_TRAFFIC = 43, 47
TENANT_SMALL_CHUNKS = (1024, 2048)  # chunks that stay on the scatter
TENANT_FACADES = 3  # tenants served through TenantCheckEngine
TENANT_FACADE_ROWS = 512
TENANT_ISOLATION = 256  # rows of one tenant's user on another's doc
TENANT_TIMED_SAMPLE = 4  # calls timed per kernel and wave shape
#: the unit separator of a qualified namespace (tenancy/store.py SEP)
NS_SEP = "\x1f"


def tenant_nid(t: int) -> str:
    return f"n{t:04d}"


def zipf_sizes(total: int, n: int) -> np.ndarray:
    """``n`` Zipf (s = 1) shares of ``total``, at least 1 each."""
    w = 1.0 / np.arange(1, n + 1)
    return np.maximum(1, np.round(total * w / w.sum())).astype(np.int64)


def build_tenant_columnar(n_tenants=None, seed=SEED_TENANTS, scale=None,
                          fanout=TENANT_FANOUT):
    """The synth graph's shape per tenant, at each tenant's Zipf share of
    ``scale``, under qualified namespaces (``{nid}\\x1f{ns}``), built as id
    columns as ``build_synth_columnar`` builds them.  Names are unique over
    the plane (``u{i}``, ``g{i}``, ``f{i}``, ``d{i}``), so a user belongs
    to one tenant.  The last tenant's rows are kept out of the store, as
    unqualified tuples to write through its view once it is created.
    Returns the store, the base namespace manager and the id ranges."""
    from ketotpu_torch.api.types import RelationTuple, SubjectID, SubjectSet
    from ketotpu_torch.engine.vocab import Vocab
    from ketotpu_torch.opl.parser import parse
    from ketotpu_torch.storage.columnar import ColumnarTupleStore
    from ketotpu_torch.storage.namespaces import StaticNamespaceManager
    from ketotpu_torch.utils.synth import SYNTH_OPL

    rng = np.random.default_rng(seed)
    namespaces, errors = parse(SYNTH_OPL)
    assert not errors, errors
    T = TENANTS if n_tenants is None else n_tenants
    scale = TENANT_SCALE if scale is None else scale
    nids = [tenant_nid(t) for t in range(T)]
    size = {k: zipf_sizes(v, T) for k, v in scale.items()}
    base = {k: np.concatenate([[0], np.cumsum(v)[:-1]]) for k, v in size.items()}
    owner = {k: np.repeat(np.arange(T), v) for k, v in size.items()}
    U, G, F, D = (int(size[k].sum()) for k in (
        "n_users", "n_groups", "n_folders", "n_docs"))
    v = Vocab()
    fams = ("Group", "Folder", "Doc")
    v.namespaces._ids = {f"{nid}{NS_SEP}{fam}": 3 * t + j
                         for t, nid in enumerate(nids) for j, fam in enumerate(fams)}
    objs = {f"g{i}": i for i in range(G)}
    objs.update((f"f{i}", G + i) for i in range(F))
    objs.update((f"d{i}", G + F + i) for i in range(D))
    v.objects._ids = objs
    R_EMPTY = v.relations.intern("")
    rel_id = {r: v.relations.intern(r) for r in (
        "members", "parents", "viewers", "owners", "banned")}
    subs = {f"id:u{i}": i for i in range(U)}
    gt, ft = owner["n_groups"], owner["n_folders"]
    subs.update((f"set:{nids[t]}{NS_SEP}Group:g{i}#members", U + i)
                for i, t in enumerate(gt.tolist()))
    subs.update((f"set:{nids[t]}{NS_SEP}Folder:f{i}#", U + G + i)
                for i, t in enumerate(ft.tolist()))
    v.subjects._ids = subs
    OBJ_F, OBJ_D, SUB_G, SUB_F = G, G + F, U, U + G

    def local(kind):
        return np.arange(int(size[kind].sum())) - base[kind][owner[kind]]

    def pick(kind, tenants):
        """A uniform random item of ``kind`` in each row's tenant."""
        return base[kind][tenants] + (
            rng.random(len(tenants)) * size[kind][tenants]).astype(np.int64)

    segs = []

    def seg(tenants, fam, obj, rel, subj, s_fam=None, s_obj=None, s_rel=-1):
        n = len(obj)
        is_set = s_fam is not None
        segs.append({
            "ns": (3 * tenants + fams.index(fam)).astype(np.int32),
            "obj": np.asarray(obj, np.int32),
            "rel": np.full(n, rel, np.int32),
            "subj": np.asarray(subj, np.int32),
            "is_set": np.full(n, int(is_set), np.int32),
            "s_ns": ((3 * tenants + fams.index(s_fam)).astype(np.int32)
                     if is_set else np.full(n, -1, np.int32)),
            "s_obj": (np.asarray(s_obj, np.int32) if is_set
                      else np.full(n, -1, np.int32)),
            "s_rel": np.full(n, s_rel, np.int32),
        })

    ut, lu = owner["n_users"], local("n_users")
    # group membership: a tenant's users spread over its groups
    seg(ut, "Group", base["n_groups"][ut] + lu % size["n_groups"][ut],
        rel_id["members"], np.arange(U))
    # nested groups: every 3rd of a tenant's groups is a member of the one before
    lg = local("n_groups")
    gi = np.flatnonzero(lg % 3 == 1)
    seg(gt[gi], "Group", gi - 1, rel_id["members"], SUB_G + gi, "Group", gi,
        rel_id["members"])
    # each tenant's folder tree
    lf = local("n_folders")
    fi = np.flatnonzero(lf >= 1)
    par = base["n_folders"][ft[fi]] + (lf[fi] - 1) // fanout
    seg(ft[fi], "Folder", OBJ_F + fi, rel_id["parents"], SUB_F + par, "Folder",
        OBJ_F + par, R_EMPTY)
    f3, f5, f4 = (np.flatnonzero(lf % k == 0) for k in (3, 5, 4))
    seg(ft[f3], "Folder", OBJ_F + f3, rel_id["viewers"], pick("n_users", ft[f3]))
    seg(ft[f5], "Folder", OBJ_F + f5, rel_id["owners"], pick("n_users", ft[f5]))
    g4 = pick("n_groups", ft[f4])
    seg(ft[f4], "Folder", OBJ_F + f4, rel_id["viewers"], SUB_G + g4, "Group",
        g4, rel_id["members"])
    # docs under their tenant's folders, with occasional direct grants
    dt, ld = owner["n_docs"], local("n_docs")
    doc_folder = pick("n_folders", dt)
    seg(dt, "Doc", OBJ_D + np.arange(D), rel_id["parents"], SUB_F + doc_folder,
        "Folder", OBJ_F + doc_folder, R_EMPTY)
    for k, rel in ((7, "viewers"), (11, "owners"), (13, "banned")):
        di = np.flatnonzero(ld % k == 0)
        seg(dt[di], "Doc", OBJ_D + di, rel_id[rel], pick("n_users", dt[di]))
    cols = {k: np.concatenate([s[k] for s in segs]) for k in segs[0]}
    late = cols["ns"] // 3 == T - 1
    store = ColumnarTupleStore(v)
    store.bulk_load_ids({k: c[~late] for k, c in cols.items()})
    # the late tenant's rows as unqualified tuples for its view
    objs_s, rels_s = v.objects.strings(), v.relations.strings()
    late_rows = []
    for i in np.flatnonzero(late):
        fam = fams[cols["ns"][i] % 3]
        if cols["is_set"][i]:
            subj = SubjectSet(fams[cols["s_ns"][i] % 3], objs_s[cols["s_obj"][i]],
                              rels_s[cols["s_rel"][i]])
        else:
            subj = SubjectID(f"u{cols['subj'][i]}")
        late_rows.append(RelationTuple(fam, objs_s[cols["obj"][i]],
                                       rels_s[cols["rel"][i]], subj))
    # folders with a direct user viewer (grant-derived doc checks)
    folder_viewer = np.full(F, -1, np.int64)
    folder_viewer[f3] = segs[3]["subj"]
    return SimpleNamespace(
        store=store, manager=StaticNamespaceManager(namespaces), nids=nids,
        size=size, base=base, owner=owner, late_rows=late_rows,
        n_loaded=int((~late).sum()), doc_folder=doc_folder,
        folder_viewer=folder_viewer,
        doc_viewer=(segs[7]["obj"] - OBJ_D, segs[7]["subj"]))


def tenant_row(tg, t, fam, obj, rel, subj):
    """One check of tenant ``t`` (qualified): ``subj`` a user index or a
    (family, object) subject set."""
    from ketotpu_torch.api.types import RelationTuple, SubjectID, SubjectSet

    q = f"{tg.nids[t]}{NS_SEP}"
    if isinstance(subj, tuple):
        s = SubjectSet(q + subj[0], subj[1], "members")
    else:
        s = SubjectID(f"u{subj}")
    return RelationTuple(q + fam, obj, rel, s)


def tenant_queries(tg, n, rng, general_frac=0.0, subject_set_frac=0.0,
                   granted=0.0, tenants=None):
    """``n`` Doc checks with tenants drawn in proportion to their size (a
    uniform doc of the loaded tenants, or of ``tenants``), a user of the
    doc's tenant; with ``general_frac`` some are Doc#edit (AND/NOT), with
    ``subject_set_frac`` some ask for a group of the tenant; a ``granted``
    share is derived from grants (a direct viewer of the doc, or a direct
    viewer of its folder)."""
    docs_loaded = int(tg.base["n_docs"][-1])
    if tenants is None:
        docs = np.arange(docs_loaded)
    else:
        docs = np.concatenate([tg.base["n_docs"][t] + np.arange(tg.size["n_docs"][t])
                               for t in tenants])
    out = []
    n_grant = int(n * granted)
    dv_doc, dv_user = tg.doc_viewer
    dv_ok = np.isin(dv_doc, docs)
    dv_doc, dv_user = dv_doc[dv_ok], dv_user[dv_ok]
    fv_docs = docs[tg.folder_viewer[tg.doc_folder[docs]] >= 0]
    for k in range(n):
        if k < n_grant and k % 2 == 0 and len(dv_doc):
            j = int(rng.integers(len(dv_doc)))
            d, u = int(dv_doc[j]), int(dv_user[j])
        elif k < n_grant and len(fv_docs):
            d = int(fv_docs[int(rng.integers(len(fv_docs)))])
            u = int(tg.folder_viewer[tg.doc_folder[d]])
        else:
            d = int(docs[int(rng.integers(len(docs)))])
            t = int(tg.owner["n_docs"][d])
            u = int(tg.base["n_users"][t] + rng.integers(tg.size["n_users"][t]))
        t = int(tg.owner["n_docs"][d])
        rel = "edit" if rng.random() < general_frac else "view"
        subj = u
        if rng.random() < subject_set_frac:
            g = int(tg.base["n_groups"][t] + rng.integers(tg.size["n_groups"][t]))
            subj = ("Group", f"g{g}")
        out.append(tenant_row(tg, t, "Doc", f"d{d}", rel, subj))
    return [out[i] for i in rng.permutation(n)]


def key_bits(q: int, ns_dim: int, rel_dim: int) -> str:
    from ketotpu_torch.engine import fastpath as fp

    qb, nsb, relb = fp._pack_bits(q), fp._pack_bits(ns_dim), fp._pack_bits(rel_dim)
    return (f"Q {q}: {qb} + {nsb} + {relb} = {qb + nsb + relb} key bits -> "
            f"{pack_name(q, nsb, relb)}")


def wave_packs(shape, ns_dim, rel_dim):
    """Key bits of every pack a wave of ``shape`` runs: its tier-1 passes
    (Q) and its general sub-runs (their leaf buffers)."""
    _, q, fast, _retry, _lanes, gen, gen_retry, _leo = shape
    out = [key_bits(q, ns_dim, rel_dim)] if fast else []
    for gs in (gen, gen_retry):
        if gs is not None:
            out.append("sub-run " + key_bits(gs[1], ns_dim, rel_dim))
    return out


def tenant_traffic(engine, rec, name, queries, oracle, ns_dim, rel_dim):
    """One traffic on the tenant plane: warmed, timed with the launch
    counts set to 0 just before and read just after, every chunk replayed
    as a wave with every step held against its plain version, the timed
    run's shapes held, the engine's launches per kernel equal to the
    replay's per wave shape, verdicts equal to the replay's and sampled
    rows to the oracle's."""
    engine.batch_check(queries)
    engine.batch_check(queries)  # warm twice: the general shapes freeze
    out, dt, launches, cnt, shapes, phases, more = timed(engine, queries)
    replay = replay_waves(engine, queries, rec, name, full=True)
    hold_timed_shapes(engine, queries, rec, name, shapes, full=True)
    allowed = np.concatenate([a for _p, _o, a, _f in replay])
    fb = np.concatenate([f for _p, _o, _a, f in replay])
    got = np.asarray(out)
    if (allowed[~fb] != got[~fb]).any():
        raise AssertionError(f"{name}: batch_check != the wave replay")
    by_shape = expected_launches(rec.calls, rec.dispatches, name, shapes)
    for k, n in launches.items():
        if sum(by_shape.get(k, {}).values()) != n:
            raise AssertionError(f"{name}: {k} launched {n} times, the replay's "
                                 f"{by_shape.get(k)} by wave shape")
    rng = np.random.default_rng(SEED_SAMPLE)
    for i in rng.choice(len(queries), min(ORACLE_SAMPLE, len(queries)),
                        replace=False):
        if got[i] != oracle.check_is_member(queries[i]):
            raise AssertionError(f"{name}: {queries[i]}: device {got[i]}")
    log(f"[15] {name}: {len(queries)} checks in {dt:.4f} s = "
        f"{len(queries) / dt:.0f} checks/s (repeats: "
        f"{', '.join(f'{len(queries) / x:.0f}' for x in more)} checks/s); "
        f"allowed {int(got.sum())}; general rows {cnt['general_rows']}, "
        f"retries {cnt['retries']}, oracle fallbacks {cnt['fallbacks']}; waves "
        f"{cnt['fused_waves']}; tier rows {cnt['tier_rows']}; "
        f"{ORACLE_SAMPLE} sampled rows equal the oracle's")
    log(f"[15] {name}: waves { {shape_name(k): v for k, v in shapes.items()} }; "
        f"packs {sorted({b for k in shapes for b in wave_packs(k, ns_dim, rel_dim)})}")
    log(f"[15] {name}: launches {launches}; host ms per phase {phases}")
    return SimpleNamespace(out=out, dt=dt, more=more, launches=launches,
                           shapes=shapes, by_shape=by_shape, counts=cnt,
                           phases=phases, replay=replay)


def tenant_phase():
    """Phase 15: the tenant plane at 8,192 tenants on one card.  A fused
    engine (Leopard on, ``max_pairs`` 2^25) over a ~10.6M-tuple store of
    8,191 tenants' qualified tuples: namespace dim 65,536, so a batch of
    more than 2,048 rows packs every level by sort (K5b) on the radix sort.
    Pure-OR and mixed traffic in 8,192-row chunks, 1,024- and 2,048-row
    chunks on the scatter, tenant facades, cross-tenant isolation, a write
    through a tenant's view and a tenant created after the traffic; every
    kernel held against its plain version at every wave shape; pack_sort
    and lex_sort timed.  Returns the kernel line's entries for them."""
    from ketotpu_torch.api.types import RelationTuple, SubjectID, TooManyRequestsError
    from ketotpu_torch.engine import fused as fdx
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.tenancy import TenantPlane

    t0 = time.perf_counter()
    tg = build_tenant_columnar()
    late_t = TENANTS - 1
    plane = TenantPlane(tg.store, tg.manager, max_tenants=TENANTS + 1)
    for nid in tg.nids[:late_t]:
        plane.create(nid)
    sizes = tg.size["n_docs"]
    log(f"[15] tenant plane: {len(plane.tenant_ids())} networks ({late_t} "
        f"tenants + the default), {tg.n_loaded} qualified tuples (Zipf s = 1: "
        f"the largest tenant {int(sizes[0])} docs, the smallest {int(sizes[-1])}; "
        f"the last tenant's {len(tg.late_rows)} tuples wait for its creation), "
        f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine = DeviceCheckEngine(tg.store, plane.manager, fused_dispatch=True,
                               fused_retry_lanes=1,
                               leopard={"max_pairs": LEO_MAX_PAIRS})
    g = engine.device_tables()
    ns_dim, rel_dim = g["f_direct_ok"].shape
    state = engine.leopard_index()
    if state is None or state.pairs is None:
        raise AssertionError("the closure index was not built")
    log(f"[15] engine: NS {ns_dim}, R {rel_dim}; projection "
        f"{engine.projection_build_s:.2f} s, upload "
        f"{engine.projection_upload_s:.2f} s, closure index "
        f"{state.index.build_s:.2f} s ({len(state.index.elt_packed)} element "
        f"pairs); {time.perf_counter() - t0:.1f} s in all")
    for q in (*TENANT_SMALL_CHUNKS, Q):
        log(f"[15] {key_bits(q, ns_dim, rel_dim)}")
    oracle = engine.oracle
    rng = np.random.default_rng(SEED_TENANT_TRAFFIC)
    rec = Recorder()
    traffic = {
        "tenants-pure": tenant_queries(tg, 2 * Q, rng, granted=0.5),
        "tenants-mixed": tenant_queries(tg, 2 * Q, rng, general_frac=GENERAL_FRAC,
                                        subject_set_frac=0.15),
    }
    for n in TENANT_SMALL_CHUNKS:
        traffic[f"tenants-{n}"] = tenant_queries(tg, n, rng, granted=0.5)
    runs = {}
    for name, queries in traffic.items():
        t0 = time.perf_counter()
        runs[name] = r = tenant_traffic(engine, rec, name, queries, oracle,
                                        ns_dim, rel_dim)
        small = len(queries) <= 2048
        sort_n, scat_n = r.launches["pack_sort"], r.launches["pack_scatter"]
        if small and (sort_n or not scat_n):
            raise AssertionError(f"{name}: a chunk of {len(queries)} rows took the "
                                 f"sort ({sort_n}) or no scatter ({scat_n})")
        if not small and (scat_n or not sort_n):
            raise AssertionError(f"{name}: 8,192-row chunks took the scatter "
                                 f"({scat_n}) or no sort ({sort_n})")
        if r.launches["lex_sort"] != sort_n:
            raise AssertionError(f"{name}: {r.launches['lex_sort']} sorts for "
                                 f"{sort_n} sort packs")
        path = ("init_state", "probe_level", "arena_assign", "expand_children",
                "wave_tier0", "wave_lane", "wave_pack")
        path += ("pack_scatter",) if small else tuple(SORT_KERNELS)
        if name == "tenants-mixed":
            path += (*GEN_KERNELS, "wave_gen_lane")
        require_launched(r.launches, path, name)
        log(f"[15] {name}: held and checked in {time.perf_counter() - t0:.1f} s")

    # -- tenant facades and isolation -----------------------------------------
    t0 = time.perf_counter()
    picks = (0, TENANTS // 64, TENANTS // 2)
    for t in picks:
        nid = tg.nids[t]
        rows = tenant_queries(tg, TENANT_FACADE_ROWS, rng, granted=0.5,
                              tenants=[t])
        facade = plane.engine_for(nid, engine)
        bare = [type(q)(q.namespace.split(NS_SEP, 1)[1], q.object, q.relation,
                        q.subject) for q in rows]
        got = facade.batch_check(bare)
        if got != engine.batch_check(rows):
            raise AssertionError(f"tenant {nid}: the facade != the shared engine")
        for q, v in list(zip(rows, got))[:64]:
            if v != oracle.check_is_member(q):
                raise AssertionError(f"tenant {nid}: {q}: {v}")
    grants = [q for q in traffic["tenants-pure"][:Q]
              if isinstance(q.subject, SubjectID)][:4 * TENANT_ISOLATION]
    own = engine.batch_check(grants)
    granted = [q for q, v in zip(grants, own) if v][:TENANT_ISOLATION]
    cross = []
    for q in granted:
        t = int(tg.owner["n_docs"][int(q.object[1:])])
        other = (t + 1 + int(rng.integers(late_t - 1))) % late_t
        cross.append(type(q)(f"{tg.nids[other]}{NS_SEP}Doc", q.object, q.relation,
                             q.subject))
    denied = engine.batch_check(cross)
    if any(denied) or any(oracle.check_is_member(q) for q in cross[:64]):
        raise AssertionError("a user was allowed on another tenant's doc")
    log(f"[15] facades: {len(picks)} tenants x {TENANT_FACADE_ROWS} rows through "
        f"TenantCheckEngine equal the shared engine's (64 each the oracle's); "
        f"isolation: {len(granted)} granted (doc, user) pairs asked under another "
        f"tenant's namespace all denied ({time.perf_counter() - t0:.1f} s)")

    # -- a write through a tenant's view, then its next verdict ----------------
    def outsider(t):
        """(group, user) of tenant t: its first group, and one of its last
        users that the group does not hold yet (or None)."""
        g_i = int(tg.base["n_groups"][t])
        hi = int(tg.base["n_users"][t] + tg.size["n_users"][t])
        for u_i in range(hi - 1, max(hi - 64, int(tg.base["n_users"][t])) - 1, -1):
            if not oracle.check_is_member(
                    tenant_row(tg, t, "Group", f"g{g_i}", "members", u_i)):
                return g_i, u_i
        return None

    t = next(t for t in range(TENANTS // 8, -1, -1) if outsider(t))
    nid = tg.nids[t]
    g_i, u_i = outsider(t)
    q = tenant_row(tg, t, "Group", f"g{g_i}", "members", u_i)
    before = engine.batch_check([q])[0]
    view = plane.view_for(nid)
    t0 = time.perf_counter()
    view.write_relation_tuples(RelationTuple("Group", f"g{g_i}", "members",
                                             SubjectID(f"u{u_i}")))
    after = engine.batch_check([q])[0]
    w_ms = (time.perf_counter() - t0) * 1e3
    if before or not after or not oracle.check_is_member(q):
        raise AssertionError(f"{q}: {before} -> {after} after the write")
    log(f"[15] write through tenant {nid}'s view: {q} {before} -> {after}, write "
        f"to next verdict {w_ms:.3f} ms (tier {engine.last_write.get('tier')}, "
        f"closure {engine.last_write.get('leopard')})")

    # -- a tenant created after the traffic ---------------------------------------
    late = tg.nids[late_t]
    r0 = engine.rebuilds
    t0 = time.perf_counter()
    plane.create(late)
    plane.view_for(late).write_relation_tuples(*tg.late_rows)
    rows = tenant_queries(tg, 512, rng, granted=0.0, tenants=[late_t])
    got = engine.batch_check(rows)
    c_s = time.perf_counter() - t0
    if engine.rebuilds != r0 + 1:
        raise AssertionError(f"creating {late}: {engine.rebuilds - r0} rebuilds")
    for q, v in zip(rows, got):
        if v != oracle.check_is_member(q):
            raise AssertionError(f"late tenant {late}: {q}: {v}")
    try:
        plane.create("one-more")
        raise AssertionError("the plane took a tenant past max_tenants")
    except TooManyRequestsError:
        pass
    log(f"[15] tenant {late} created after the traffic with {len(tg.late_rows)} "
        f"tuples: create + write + first batch {c_s:.3f} s (one rebuild: "
        f"projection {engine.projection_build_s:.2f} s, upload "
        f"{engine.projection_upload_s:.2f} s); its 512 rows ({sum(got)} allowed) "
        f"equal the oracle's; NS still {engine.device_tables()['f_direct_ok'].shape[0]}; "
        f"a {TENANTS + 2}th network is refused (max_tenants {TENANTS + 1})")

    # -- timing ---------------------------------------------------------------------
    t0 = time.perf_counter()
    entries = []
    pure = runs["tenants-pure"]
    timed_rows = {name: time_kernels(g, rec, name, tuple(SORT_KERNELS),
                                     sample=TENANT_TIMED_SAMPLE)
                  for name in ("tenants-pure", "tenants-mixed")}
    for name, (source, replaces) in SORT_KERNELS.items():
        per, lb = timed_rows["tenants-pure"][name], pure.by_shape[name]
        for ds, rows_ in timed_rows.items():
            for s_, r in rows_[name].items():
                log(f"[15] {name} at {shape_name(s_)} ({ds}): {r['ms']:.4f} "
                    f"ms/launch on the card (host {r['host_ms']:.4f} ms per "
                    f"eager call), plain {r['plain_ms']:.4f} ms, library "
                    f"{r['library_ms']}, bound {r['bound_ms']:.6f} ms (bytes), "
                    f"{runs[ds].by_shape[name].get(s_, 0)} launches in the timed "
                    f"run, mean of {r['calls']} calls{b2b_note(r)}")
        mper, mlb = timed_rows["tenants-mixed"][name], runs["tenants-mixed"].by_shape[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": pure.launches[name], "max_abs_err": rec.err[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"), "bound_by": "bytes",
            "library_ms": weighted(per, lb, "library_ms"),
            "path": "tenants-pure",
            "launches_by_shape": {shape_name(s_): c for s_, c in lb.items()},
            "ms_by_shape": {shape_name(s_): per[s_]["ms"] for s_ in lb},
            "plain_ms_by_shape": {shape_name(s_): per[s_]["plain_ms"] for s_ in lb},
            "bound_ms_by_shape": {shape_name(s_): per[s_]["bound_ms"] for s_ in lb},
            "mixed_path": {
                "launches": runs["tenants-mixed"].launches[name],
                "ms": weighted(mper, mlb, "ms"),
                "bound_ms": weighted(mper, mlb, "bound_ms"),
                "library_ms": weighted(mper, mlb, "library_ms"),
            },
        })
    entries[1]["device_ops_by_shape"] = {
        ds: gate_ops(rec, ds, "lex_sort", sort_ops, "[15]")
        for ds in ("tenants-pure", "tenants-mixed")}
    for key in ("library_ms", "b2b_ms", "library_b2b_ms"):
        entries[1][f"{key}_by_shape"] = {
            shape_name(s_): per_[key]
            for s_, per_ in timed_rows["tenants-pure"]["lex_sort"].items()}
    # pack_sort's share of a wave's device time (its time includes the
    # lex_sort it runs), per wave of the timed pure-OR run
    ms_pack = {s_: r["ms"] for s_, r in timed_rows["tenants-pure"]["pack_sort"].items()}
    for plan, _o, _a, _f in pure.replay:
        qd = torch.from_numpy(plan.qpack).to(g["row_ptr"].device)
        key = wave_key(plan)
        dev_ms, spread, _h = calls_ms(
            lambda plan=plan, qd=qd: fdx.run_fused_wave(plan.tables, qd, **plan.kwargs))
        n_pack = pure.by_shape["pack_sort"].get(key, 0) // pure.shapes[key]
        share = n_pack * ms_pack[key] / dev_ms
        log(f"[15] wave {shape_name(key)}: {dev_ms:.4f} ms on the card (spread "
            f"{spread:.4f}); {n_pack} pack_sort launches x {ms_pack[key]:.4f} ms "
            f"= a pack_sort share of {share:.4f}")
        entries[0].setdefault("wave_share", []).append(
            {"wave": shape_name(key), "wave_ms": dev_ms, "share": share})
    log(f"[15] timing in {time.perf_counter() - t0:.1f} s")
    for name in SORT_KERNELS:
        log(f"[15] {name}: {len(rec.calls[name])} calls held, kernel == plain "
            f"(max abs err {rec.err[name]})")
    # one pure-OR wave's sort keys, for phase 16's search (the largest)
    _t, args, kw = max(rec.calls["lex_sort"], key=lambda c: c[1][0].shape[1])
    return SimpleNamespace(entries=entries, runs=runs,
                           sort_keys=(args[0], kw["bits"]))


# -- phase 16: the query-data-parallel checks, and the binary search --------------

DP_SHARDS = 4  # n = 4 slices; n = 1 runs each slice alone
#: phase 3's two pure-OR chunks, phase 2's grant-derived chunk (its
#: allowed rows give the found bits something to hold) and one more
DP_ROWS = DP_SHARDS * Q
#: (frontier, arena) caps: the served first pass and the retry's
DP_CAPS = {"served": (Q, 2 * Q), "retry": (4 * Q, 8 * Q)}
DP_REPEATS = 3  # timed n = 4 calls per cap set
SEARCH_Q = 1 << 16  # queries per search
SEED_DP, SEED_SEARCH = 61, 67


def search_slots(keys, queries) -> int:
    """The distinct key rows a search of ``queries`` in ``keys`` reads: the
    clamped midpoint of every live step and the insertion point compared
    at the end (the plain version's walk, recorded)."""
    from ketotpu_torch.engine import xutil

    n, q = keys[0].shape[0], queries[0].shape[0]
    if n == 0:
        return 0
    dev = queries[0].device
    lo = torch.zeros(q, dtype=torch.int32, device=dev)
    hi = torch.full((q,), n, dtype=torch.int32, device=dev)
    read = []
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi) // 2
        at = mid.clamp(0, n - 1)
        live = lo < hi
        read.append(at[live])
        go = live & xutil._lex_less([k[at.long()] for k in keys], queries)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go | ~live, hi, mid)
    read.append(lo[lo < n])
    return int(torch.unique(torch.cat(read)).numel())


def search_queries(keys, nq: int, rng):
    """``nq`` queries (int32[k, nq]) for the sorted ``keys`` (int32[k, N]),
    the mask of those that must be found and where each kind lies: the first half drawn from the keys; then an
    eighth each with column k - 2, or the last column, outside the keys'
    range of that column (absent, their insertion point inside the
    array), with column 0 below its least value (insertion point 0), and
    above its largest (N)."""
    k, n = len(keys), keys[0].shape[0]
    dev = keys[0].device
    take = torch.from_numpy(rng.integers(0, n, nq)).to(dev)
    out = torch.stack([c[take] for c in keys])
    lo = [int(c.min()) for c in keys]
    hi = [int(c.max()) for c in keys]
    r = torch.arange(nq, dtype=torch.int32, device=dev) % 7

    def outside(c, below=False):
        if below or hi[c] > 2**31 - 9:
            return lo[c] - 1 - r
        return hi[c] + 1 + r

    half, e = nq // 2, nq // 8
    parts = {"missing": (max(k - 2, 0), False), "missing_last": (k - 1, False),
             "below": (0, True), "above": (0, False)}
    where = {}
    for i, (name, (c, below)) in enumerate(parts.items()):
        sl = slice(half + i * e, half + (i + 1) * e)
        out[c, sl] = outside(c, below)[sl]
        where[name] = sl
    must = torch.zeros(nq, dtype=torch.bool, device=dev)
    must[:half] = True
    return out, must, where


def dp_capture(graph, engine, g, queries, verdicts, grant_chunk, mixed_q,
               mverdicts):
    """Phase 16's inputs, taken from the phase-3/6 engine (Leopard off,
    unfused) before any write: its tables as uploaded at the start (the
    overlay empty); phase 3's two pure-OR chunks, phase 2's grant-derived
    chunk and one more random chunk, with that engine's verdicts; phase
    6's general rows with the verdicts of its timed mixed run (padded with
    inactive rows to a multiple of ``DP_SHARDS``); the store's tuple
    columns."""
    from ketotpu_torch.utils.synth import synth_queries

    if bool(g["ov_dirty"].any()) or int(g["om_ptr"][-1]) or int(g["ovt_ptr"][-1]):
        raise AssertionError("phase 16: the tables carry a non-empty overlay")
    extra = list(grant_chunk) + synth_queries(
        graph, DP_ROWS - len(queries) - len(grant_chunk), seed=SEED_DP)
    rows = list(queries) + extra
    allowed = np.concatenate([np.asarray(verdicts, bool),
                              np.asarray(engine.batch_check(extra), bool)])
    chunks = []
    for lo in range(0, DP_ROWS, Q):
        qp, err, general = engine.pack_queries(rows[lo: lo + Q])
        if err.any() or general.any() or qp.shape[1] != Q:
            raise AssertionError("phase 16: pure-OR rows off tier 1")
        chunks.append(qp)
    enc, gi = engine.encode_general(mixed_q)
    n = len(gi)
    gen = np.full((6, n + (-n % DP_SHARDS)), -1, np.int32)
    for r in range(5):
        gen[r, :n] = enc[r][gi]
    gen[4, n:] = 1
    gen[5] = np.arange(gen.shape[1]) < n
    cols, alive, _tail, _head = graph.store.export_columns()
    tuples = np.stack([np.asarray(cols[c])[alive]
                       for c in ("ns", "obj", "rel", "subj")]).astype(np.int32)
    return SimpleNamespace(g=g, engine=engine, fast=np.concatenate(chunks, axis=1),
                           fast_allowed=allowed, gen=gen,
                           gen_allowed=np.asarray(mverdicts, bool)[gi],
                           tuples=tuples)


def _launch_gate(launches, per_call, calls, what):
    for name, k in per_call.items():
        if launches[name] != k * calls:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, {k * calls} expected")
    extra = {k: v for k, v in launches.items() if v and k not in per_call}
    if extra:
        raise AssertionError(f"{what}: other kernels launched: {extra}")


def dp_fast(dp, rec: Recorder, dev0, mesh1, meshn):
    """(a): ``shard_fast_check`` at both cap sets."""
    from ketotpu_torch import kernels
    from ketotpu_torch.engine import fastpath as fp
    from ketotpu_torch.parallel import mesh as pm

    g, eng = dp.g, dp.engine
    depth, w = eng.max_depth, Q
    ns_dim, rel_dim = g["f_direct_ok"].shape
    pack = pack_name(w, fp._pack_bits(ns_dim), fp._pack_bits(rel_dim))
    per_call = {"init_state": 1, "probe_level": depth, "arena_assign": depth,
                "expand_children": depth, pack: depth}
    cols, act, allowed = dp.fast[:5], dp.fast[5], dp.fast_allowed
    out = {}
    for cap, (fr, ar) in DP_CAPS.items():
        kw = dict(frontier=fr, arena=ar, max_depth=depth, max_width=eng.max_width)
        # one slice's every step, each kernel call against its plain version
        rec.tag = ("dp", ("dp", w, fr, ar))
        rec.dispatches[rec.tag] += 1
        held = pm._shard_fast(rec.ops().fast, g, cols[:, :w], mesh1, axis="data",
                              active=act[:w], **kw)
        ones, dt1 = [], []
        for s in range(DP_SHARDS):
            sl = slice(s * w, (s + 1) * w)
            kernels.reset_launches()
            t0 = time.perf_counter()
            r = pm.shard_fast_check(g, cols[:, sl], mesh1, active=act[sl], **kw)
            bits = (r.found.cpu().numpy(), r.over.cpu().numpy())
            dt1.append(time.perf_counter() - t0)
            _launch_gate(kernels.LAUNCHES, per_call, 1, f"dp n = 1 {cap}")
            ones.append(bits)
        if not (np.array_equal(held.found.cpu().numpy(), ones[0][0])
                and np.array_equal(held.over.cpu().numpy(), ones[0][1])):
            raise AssertionError(f"dp {cap}: the held slice != the kernel call")
        found1 = np.concatenate([f for f, _ in ones])
        over1 = np.concatenate([o for _, o in ones])
        dtn, launches = [], None
        for _ in range(DP_REPEATS):
            kernels.reset_launches()
            t0 = time.perf_counter()
            r = pm.shard_fast_check(g, cols, meshn, active=act, **kw)
            found, over = r.found.cpu().numpy(), r.over.cpu().numpy()
            dtn.append(time.perf_counter() - t0)
            launches = dict(kernels.LAUNCHES)
            _launch_gate(launches, per_call, DP_SHARDS, f"dp n = {DP_SHARDS} {cap}")
            if not (np.array_equal(found, found1) and np.array_equal(over, over1)):
                raise AssertionError(f"dp {cap}: n = {DP_SHARDS} bits != the "
                                     f"{DP_SHARDS} n = 1 slices")
        if (found1 & ~allowed).any():
            raise AssertionError(f"dp {cap}: a found row the engine denied")
        if ((found1 != allowed) & ~over1).any():
            raise AssertionError(f"dp {cap}: a row not over differs from the engine")
        cards = torch.cuda.device_count() if dev0.type == "cuda" else 1
        multi = None
        if cards > 1:
            mc = pm.make_mesh(cards)
            pick = [s % DP_SHARDS for s in range(cards)]
            cc = np.concatenate([dp.fast[:, p * w:(p + 1) * w] for p in pick], axis=1)
            dts = []
            for _ in range(DP_REPEATS + 1):
                t0 = time.perf_counter()
                r = pm.shard_fast_check(g, cc[:5], mc, active=cc[5], **kw)
                found, over = r.found.cpu().numpy(), r.over.cpu().numpy()
                dts.append(time.perf_counter() - t0)
                if not (np.array_equal(found, np.concatenate([ones[p][0] for p in pick]))
                        and np.array_equal(over, np.concatenate([ones[p][1] for p in pick]))):
                    raise AssertionError(f"dp {cap}: {cards} cards != the n = 1 slices")
            multi = (cards, [cards * w / x for x in dts[1:]])  # the first copies
        # device time of slice 0: each step, and the whole call (roots + the
        # steps, queries already on the card) against its plain version
        qp0 = torch.from_numpy(np.ascontiguousarray(dp.fast[:, :w])).to(dev0)
        states = [fp.step_state(qp0, frontier=fr)]
        for _ in range(depth - 1):
            states.append(fp.step_impl(g, states[-1], frontier=fr, arena=ar,
                                       max_width=eng.max_width))
        step_ms = [device_ms(lambda s=s: fp.step_impl(
            g, s, frontier=fr, arena=ar, max_width=eng.max_width)) for s in states]

        def run(ops, fr=fr, ar=ar):
            s = fp.step_state(qp0, frontier=fr, ops=ops)
            for _ in range(depth):
                s = fp.step_impl(g, s, frontier=fr, arena=ar,
                                 max_width=eng.max_width, ops=ops)
            return s

        p0, k0, k1, p1 = (device_ms(lambda: run(fp._PLAIN_OPS)),
                          device_ms(lambda: run(fp._OPS)),
                          device_ms(lambda: run(fp._OPS)),
                          device_ms(lambda: run(fp._PLAIN_OPS)))
        bound = sum(kernel_bytes(name, a, k, g) for name in per_call
                    for tag, a, k in rec.calls[name] if tag == rec.tag)
        res = dict(
            rows=len(found1), found=int(found1.sum()), over=float(over1.mean()),
            checks_s_n1=[w / x for x in dt1],
            checks_s_n=[DP_ROWS / x for x in dtn], launches=launches,
            step_ms=step_ms, ms=(k0 + k1) / 2, plain_ms=(p0 + p1) / 2,
            bound_ms=bound / HBM_BYTES_PER_S * 1e3, multi=multi)
        out[cap] = res
        log(f"[16] shard_fast_check at {cap} caps (frontier {fr}, arena {ar}, "
            f"max_depth {depth}): n = 1 per {w}-row slice "
            f"{', '.join(f'{x:.0f}' for x in res['checks_s_n1'])} checks/s; "
            f"n = {DP_SHARDS} on one card ({DP_ROWS} rows) "
            f"{', '.join(f'{x:.0f}' for x in res['checks_s_n'])} checks/s; "
            f"found {res['found']}, over share {res['over']:.4f}; bits of n = "
            f"{DP_SHARDS} == the n = 1 slices; found rows allowed and rows not "
            f"over equal to the engine's verdicts; launches per n = "
            f"{DP_SHARDS} call { {k: v for k, v in launches.items() if v} }")
        log(f"[16] slice 0 on the card at {cap}: device ms per step "
            f"{[round(x, 4) for x in step_ms]}, per call (roots + {depth} steps) "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.6f} ms (bytes, the held calls' sum); every call "
            f"of its {depth} steps == plain")
        if multi:
            log(f"[16] one slice per card on {multi[0]} cards: "
                f"{', '.join(f'{x:.0f}' for x in multi[1])} checks/s (after a "
                f"first call that copies the tables to each card); bits == "
                f"the n = 1 slices")
    return out


def dp_general(dp, rec: Recorder, mesh1, meshn):
    """(b): ``shard_general_check`` at n = 1 and n = ``DP_SHARDS``."""
    from ketotpu_torch import kernels
    from ketotpu_torch.engine.optable import R_IS
    from ketotpu_torch.parallel import mesh as pm

    g, eng, gq = dp.g, dp.engine, dp.gen
    nq = gq.shape[1]
    active = gq[5] != 0
    out = {}
    for n, mesh in ((1, mesh1), (DP_SHARDS, meshn)):
        sched = eng._gen_schedule(nq // n, 1)
        sizes, fast_b, fast_sched, vcap = sched
        kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched,
                  max_width=eng.max_width, vcap=vcap)
        kernels.reset_launches()
        t0 = time.perf_counter()
        codes, occ = pm.shard_general_check(g, gq, mesh, **kw)
        codes, occ = codes.cpu().numpy(), occ.cpu().numpy()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if occ.shape[0] != n:
            raise AssertionError(f"dp general n = {n}: {occ.shape[0]} occ rows")
        over = ((codes >> 2) & 1).astype(bool)[active]
        got = (codes & 3)[active] == R_IS
        if (got != dp.gen_allowed)[~over].any():
            raise AssertionError(f"dp general n = {n}: a row not over differs "
                                 f"from the engine's verdict")
        out[n] = (codes, occ, kw, sched)
        log(f"[16] shard_general_check n = {n}: {int(active.sum())} general rows "
            f"(+{nq - int(active.sum())} inactive) at {shape_name(gen_key(gq[:, :nq // n], 1, sched))} "
            f"per device in {dt * 1e3:.3f} ms = {active.sum() / dt:.0f} checks/s; "
            f"over share {over.mean():.4f}, rows not over == the engine's "
            f"verdicts; {occ.shape[0]} occ rows; launches {launches}")
    codes4, occ4, kw4, sched4 = out[DP_SHARDS]
    w = nq // DP_SHARDS
    for s in range(DP_SHARDS):
        c1, o1 = pm.shard_general_check(g, gq[:, s * w:(s + 1) * w], mesh1, **kw4)
        if not (np.array_equal(c1.cpu().numpy(), codes4[s * w:(s + 1) * w])
                and np.array_equal(o1.cpu().numpy()[0], occ4[s])):
            raise AssertionError(f"dp general: slice {s} of n = {DP_SHARDS} != n = 1")
    cards = torch.cuda.device_count() if mesh1.devices[0].type == "cuda" else 1
    if cards == DP_SHARDS:
        # one slice per card: the per-device shapes of n = 4
        kernels.reset_launches()
        t0 = time.perf_counter()
        codes, occ = pm.shard_general_check(g, gq, pm.make_mesh(cards), **kw4)
        codes, occ = codes.cpu().numpy(), occ.cpu().numpy()
        dt = time.perf_counter() - t0
        if not (np.array_equal(codes, codes4) and np.array_equal(occ, occ4)):
            raise AssertionError(f"dp general: {cards} cards != n = {DP_SHARDS}")
        log(f"[16] shard_general_check on {cards} cards, one slice each: "
            f"{dt * 1e3:.3f} ms = {active.sum() / dt:.0f} checks/s; codes and "
            f"occ rows == n = {DP_SHARDS} on one card")
    q0 = np.ascontiguousarray(gq[:, :w])
    check_general(g, q0, sched4, eng.max_width, rec,
                  ("dp-general", gen_key(q0, 1, sched4)))
    log(f"[16] shard_general_check: n = {DP_SHARDS} codes and occ rows == the "
        f"{DP_SHARDS} n = 1 slices; slice 0 step by step, every K7 call == plain "
        f"and the program == the plain program")


def dp_search(dp, rec: Recorder, dev0, frontier_keys=None):
    """(c): ``lex_searchsorted`` over the synth's sorted tuple columns (and
    a sorted frontier of phase 15).  Returns the kernel line's entry."""
    from ketotpu_torch import kernels
    from ketotpu_torch.engine import xutil

    rng = np.random.default_rng(SEED_SEARCH)
    # each key set sorted by lex_sort, held against its plain version (the
    # 10.6M tuple rows at 4 x 32 bits: 16 digit passes), as one int32[4, N]
    # block (no copy inside the timed call)
    unsorted = {"tuples": (torch.from_numpy(dp.tuples).to(dev0), None)}
    if frontier_keys is not None:
        keys, bits = frontier_keys
        unsorted["frontier"] = (keys.to(dev0), bits)
    sets = {}
    for name, (keys, bits) in unsorted.items():
        rec.tag = ("sort", ("sort", name, keys.shape[1], keys.shape[0]))
        rec.dispatches[rec.tag] += 1
        sets[name] = torch.stack(rec.run("lex_sort", keys, bits=bits)[0])
        log(f"[16] lex_sort of the {keys.shape[1]} {name} rows ({keys.shape[0]} "
            f"key columns, bits {bits or 'all 32'}): kernel == plain, keys row "
            f"for row")
    sort_rows = time_kernels(dp.g, rec, "sort", ("lex_sort",))["lex_sort"]
    sort_ops_by = gate_ops(rec, "sort", "lex_sort", sort_ops, "[16]")
    for shape, r in sort_rows.items():
        log(f"[16] lex_sort {shape_name(shape)}: {r['ms']:.4f} ms on the card "
            f"(host {r['host_ms']:.4f} ms per eager call), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.6f} ms (bytes){b2b_note(r)}")
    searches = {}
    for name, keys in sets.items():
        queries, must, where = search_queries(keys, SEARCH_Q, rng)
        searches[name] = (keys, queries, must, where)
    kernels.reset_launches()
    results = {name: xutil.lex_searchsorted(keys, queries)
               for name, (keys, queries, _m, _w) in searches.items()}
    if dev0.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.LAUNCHES["lex_searchsorted"]
    if launches != len(searches):
        raise AssertionError(f"lex_searchsorted: {launches} launches")
    shapes = {}
    for name, (keys, queries, must, where) in searches.items():
        idx, found = results[name]
        n = keys[0].shape[0]
        if not torch.equal(found, must):
            raise AssertionError(f"search {name}: found {int(found.sum())}, "
                                 f"{int(must.sum())} drawn from the keys")
        at = idx.clamp(0, max(n - 1, 0)).long()
        for k, q in zip(keys, queries):
            if not torch.equal(k[at][found], q[found]):
                raise AssertionError(f"search {name}: a found row's key != its query")
        if (idx[where["below"]] != 0).any() or (idx[where["above"]] != n).any():
            raise AssertionError(f"search {name}: a query past an end misplaced")
        lib = packed_search((keys, queries), {})
        if lib is not None and not torch.equal(lib().to(torch.int32), idx):
            raise AssertionError(f"search {name}: torch.searchsorted disagrees")
        shape = ("search", name, n, SEARCH_Q)
        shapes[shape] = 1
        rec.tag = ("search", shape)
        rec.dispatches[rec.tag] += 1
        rec.run("lex_searchsorted", keys, queries)
        log(f"[16] lex_searchsorted over {n} sorted {name} keys ({len(keys)} "
            f"columns): {SEARCH_Q} queries, {int(found.sum())} found (every one "
            f"drawn from the keys), the rest absent, past both ends at 0 and N; "
            f"kernel == plain (idx and found), == torch.searchsorted on packed "
            f"keys{'' if lib is not None else ' (not packable)'}")
    per = time_kernels(dp.g, rec, "search", ("lex_searchsorted",))["lex_searchsorted"]
    for shape, r in per.items():
        log(f"[16] lex_searchsorted {shape[1]} (N {shape[2]}, Q {shape[3]}): "
            f"{r['ms']:.4f} ms on the card (host {r['host_ms']:.4f} ms per eager "
            f"call), plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
            f"bound {r['bound_ms']:.6f} ms (bytes)")
    source, replaces = SEARCH_KERNELS["lex_searchsorted"]
    sorts = {shape_name(s): {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms", "b2b_ms",
                                               "library_b2b_ms")}
             | {"device_ops": sort_ops_by[shape_name(s)]}
             for s, r in sort_rows.items()}
    return sorts, {
        "name": "lex_searchsorted", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": rec.err["lex_searchsorted"],
        "ms": weighted(per, shapes, "ms"), "plain_ms": weighted(per, shapes, "plain_ms"),
        "bound_ms": weighted(per, shapes, "bound_ms"), "bound_by": "bytes",
        "library_ms": weighted(per, shapes, "library_ms"),
        "path": "phase 16 (no engine caller)",
        "ms_by_shape": {f"{s[1]}/N{s[2]}/Q{s[3]}": per[s]["ms"] for s in shapes},
        "library_ms_by_shape": {f"{s[1]}/N{s[2]}/Q{s[3]}": per[s]["library_ms"]
                                for s in shapes},
        "bound_ms_by_shape": {f"{s[1]}/N{s[2]}/Q{s[3]}": per[s]["bound_ms"]
                              for s in shapes},
    }


def dp_phase(dp, frontier_keys=None, devices=None):
    """Phase 16: the query-data-parallel checks on the tables of the phase-3
    engine before any write (``dp_capture``), then ``lex_searchsorted``.
    Returns the kernel line's ``lex_searchsorted`` entry and the tier-1
    kernels' launches on the n = 4 served-caps call."""
    rec = Recorder()
    dev0 = torch.device(devices[0] if devices else "cuda:0")
    from ketotpu_torch.parallel import mesh as pm

    mesh1 = pm.make_mesh(devices=[dev0])
    meshn = pm.make_mesh(devices=[dev0] * DP_SHARDS)
    oracle = dp.engine.oracle

    def refuse(*_a, **_k):
        raise AssertionError("phase 16 asked the oracle")

    oracle.check_is_member = refuse  # no oracle on this path
    try:
        t0 = time.perf_counter()
        fast = dp_fast(dp, rec, dev0, mesh1, meshn)
        log(f"[16] (a) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_general(dp, rec, mesh1, meshn)
        log(f"[16] (b) in {time.perf_counter() - t0:.1f} s")
    finally:
        del oracle.check_is_member
    t0 = time.perf_counter()
    sorts, entry = dp_search(dp, rec, dev0, frontier_keys)
    log(f"[16] (c) in {time.perf_counter() - t0:.1f} s")
    return SimpleNamespace(entry=entry, launches=fast["served"]["launches"],
                           fast=fast, sorts=sorts)


def dp_only() -> int:
    """``python3 chip_smoke.py --dp-only``: phase 16 alone, with the set-up
    it reads (the 10M graph, the Leopard-off unfused engine, phase 3's and
    phase 2's pure-OR chunks, phase 6's mixed traffic, their verdicts),
    on every card of the machine: with more than one card, (a) runs one
    slice per card too, and (b) with four.  Prints each card's name and
    power limit, then the device line."""
    from ketotpu_torch import kernels
    from ketotpu_torch.engine.device import DeviceCheckEngine
    from ketotpu_torch.utils.synth import (build_synth_columnar, synth_queries,
                                           synth_queries_mixed)

    t_start = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    kernels.build()
    graph = build_synth_columnar(seed=SEED_GRAPH)
    engine = DeviceCheckEngine(graph.store, graph.manager,
                               leopard={"enabled": False})
    g = engine.device_tables()
    queries = synth_queries(graph, N_BATCHES * Q, seed=SEED_QUERIES)
    out = engine.batch_check(queries)
    grants = known_allowed(graph, Q // 2, SEED_GRANTS)
    mixed = grants + synth_queries(graph, Q - len(grants), seed=SEED_KERNEL_QUERIES)
    mixed = [mixed[i] for i in np.random.default_rng(SEED_GRANTS).permutation(Q)]
    mixed_q = synth_queries_mixed(graph, MIXED_N, seed=SEED_MIXED,
                                  general_frac=GENERAL_FRAC)
    engine.batch_check(mixed_q)
    mout = engine.batch_check(mixed_q)
    dp = dp_capture(graph, engine, g, queries, out, mixed, mixed_q, mout)
    log(f"[16] set-up in {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    dpr = dp_phase(dp)
    print(json.dumps({"kernels": [dpr.entry]}))
    log(f"[16] data-parallel phase in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(cards)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--dp-only"]:
        return dp_only()
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
    engine = DeviceCheckEngine(graph.store, graph.manager,
                               leopard={"enabled": False})
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
    missing = [k for k in (*KERNELS, *GEN_KERNELS) if mlaunches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mixed path: {missing}")
    for shape in mshapes:
        if shape[0] != "gen" and shape[3] == 1 and fp.level_schedule(
                *shape[:3], levels, mults=engine._adaptive_mults()) != schedule(
                    shape, levels):
            raise AssertionError("the adaptive schedule differs from the replay's")
    mby_shape = expected_launches(rec.calls, rec.dispatches, "mixed-main", mshapes)
    for name in (*KERNELS, *GEN_KERNELS):
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

    # phase 16's inputs, before any write reaches the store
    dp = dp_capture(graph, engine, g, queries, out, mixed, mixed_q, mout)

    fz = fused_paths(graph, rec, mixed_q, mout, engine)
    leng, state, memb = fz.leng, fz.state, fz.memb
    a_replay, b_replay, c_launch = fz.a_replay, fz.b_replay, fz.c_launch
    c_shapes = fz.c_shapes
    a_dt, a_launch, _a_shapes, a_phases, a_by_shape = fz.a
    b_dt, b_launch, _b_shapes, b_phases, b_by_shape = fz.b
    lg = leng.device_tables()

    # -- 11. timing ------------------------------------------------------------
    rows = time_kernels(g, rec, "main", KERNELS, sample=MAIN_TIMED_SAMPLE)
    # K4 is one launch of one thread-block cluster (csrc/arena.cu)
    arena_ops = gate_ops(rec, "main", "arena_assign", lambda a, k: 1, "[11]")
    mrows = time_kernels(g, rec, "mixed-main", sample=MAIN_TIMED_SAMPLE)
    forced = time_kernels(g, rec, "mixed-main-forced", GEN_KERNELS,
                          sample=MAIN_TIMED_SAMPLE)
    line = []
    busy = mbusy = 0.0
    for name, (source, replaces) in KERNELS.items():
        per, lb = rows[name], by_shape[name]
        mper, mlb = mrows[name], mby_shape[name]
        for s, c in lb.items():
            r = per[s]
            busy += r["ms"] * c
            log(f"[11] {name} at {shape_name(s)}: {r['ms']:.4f} ms/launch on the "
                f"card (host enqueue incl. {r['host_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.5f} ms (bytes), {c} launches in the timed "
                f"pure-OR run, mean of {r['calls']} calls{b2b_note(r)}")
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
        if name == "arena_assign":
            for key in ("library_ms", "b2b_ms", "library_b2b_ms"):
                line[-1][f"{key}_by_shape"] = {shape_name(s): per[s][key] for s in lb}
            line[-1]["device_ops_by_shape"] = arena_ops
    for name, (source, replaces) in GEN_KERNELS.items():
        per, lb = mrows[name], mby_shape[name]
        every = {**per, **forced[name]}
        for s, r in every.items():
            c = lb.get(s, 0)
            mbusy += r["ms"] * c
            log(f"[11] {name} at {shape_name(s)}: {r['ms']:.4f} ms/launch on the "
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
    # tier 0 and the fused wave: each kernel from its own path's calls
    # (leo_probe: path C; wave_gen_lane: path B; the others: path A, with
    # path B's numbers beside them)
    by_path = {"fused-members": a_by_shape, "fused-mixed": b_by_shape,
               "unfused-members": {"leo_probe": dict(c_shapes)}}
    launches_of = {"fused-members": a_launch, "fused-mixed": b_launch,
                   "unfused-members": c_launch}
    trows = {ds: time_kernels(lg, rec, ds, names) for ds, names in (
        ("fused-members", ("wave_tier0", "wave_lane", "wave_pack")),
        ("fused-mixed", tuple(WAVE_KERNELS)),
        ("unfused-members", tuple(LEO_KERNELS)))}
    for name, (source, replaces) in {**LEO_KERNELS, **WAVE_KERNELS}.items():
        ds = {"leo_probe": "unfused-members",
              "wave_gen_lane": "fused-mixed"}.get(name, "fused-members")
        per, lb = trows[ds][name], by_path[ds][name]
        for d2, t2 in trows.items():
            for s2, r in t2.get(name, {}).items():
                log(f"[11] {name} at {shape_name(s2)} ({d2}): {r['ms']:.4f} "
                    f"ms/launch on the card (replay spread up to "
                    f"{r['spread_ms']:.4f} ms; host {r['host_ms']:.4f} ms per "
                    f"eager call), plain {r['plain_ms']:.4f} ms, library "
                    f"{r['library_ms']}, bound {r['bound_ms']:.6f} ms (bytes), "
                    f"{by_path[d2].get(name, {}).get(s2, 0)} launches in the "
                    f"timed run, mean of {r['calls']} calls")
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_of[ds][name], "max_abs_err": rec.err[name],
            "ms": weighted(per, lb, "ms"), "plain_ms": weighted(per, lb, "plain_ms"),
            "bound_ms": weighted(per, lb, "bound_ms"), "bound_by": "bytes",
            "library_ms": weighted(per, lb, "library_ms"),
            "path": ds,
            "launches_by_shape": {shape_name(s2): c for s2, c in lb.items()},
            "ms_by_shape": {shape_name(s2): per[s2]["ms"] for s2 in lb},
            "spread_ms_by_shape": {shape_name(s2): per[s2]["spread_ms"] for s2 in lb},
        }
        if name in WAVE_KERNELS and ds != "fused-mixed":
            bper, blb = trows["fused-mixed"][name], b_by_shape[name]
            entry["fused_mixed_path"] = {
                "launches": b_launch[name], "ms": weighted(bper, blb, "ms"),
                "bound_ms": weighted(bper, blb, "bound_ms")}
        line.append(entry)

    # one whole wave on the card, and the host's enqueue of it, per path;
    # then the same wave without its retry lanes (the lanes are enqueued
    # whether or not a row overflowed)
    from ketotpu_torch.engine import fused as fdx

    wave_times = {}
    for path, (plan, _o, _a, _f), i in [("A", r, i) for i, r in enumerate(a_replay)] + [
            ("B", r, i) for i, r in enumerate(b_replay)]:
        qd = torch.from_numpy(plan.qpack).to(lg["row_ptr"].device)
        for label, kw in (("as served", plan.kwargs),
                          ("no retry lanes", dict(plan.kwargs, retry_lanes=0,
                                                  retry_sched=None,
                                                  gen_retry=None))):
            dev_ms, spread, _h = calls_ms(
                lambda kw=kw: fdx.run_fused_wave(plan.tables, qd, **kw))
            kernels.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fdx.run_fused_wave(plan.tables, qd, **kw)
            enq = (time.perf_counter() - t1) * 1e3
            torch.cuda.synchronize()
            n_launch = sum(kernels.LAUNCHES.values())
            wave_times[(path, i, label)] = (dev_ms, enq, n_launch)
            log(f"[11] path {path} wave {i} {shape_name(wave_key(plan))} {label}: "
                f"{dev_ms:.4f} ms on the card (spread {spread:.4f}), host "
                f"enqueue {enq:.3f} ms for {n_launch} launches")
    for path, dt_s, ph in (("A", a_dt, a_phases), ("B", b_dt, b_phases)):
        dev = sum(t[0] for k, t in wave_times.items()
                  if k[0] == path and k[2] == "as served")
        log(f"[11] where the timed path-{path} batch went: {dt_s * 1e3:.3f} ms "
            f"wall; its waves {dev:.3f} ms on the card (each wave measured "
            f"whole), a derived device busy share of {dev / (dt_s * 1e3):.4f}; "
            f"host phases {ph} ms")

    host = [r["host_ms"] for per in rows.values() for r in per.values()]
    log(f"[11] where the timed pure-OR batch went: {dt * 1e3:.3f} ms wall; kernels "
        f"{busy:.3f} ms, derived (each shape's measured device ms per launch x "
        f"the timed run's launches at that shape; not read from a trace), a "
        f"derived device busy share of {busy / (dt * 1e3):.4f}; host phases "
        f"{phases} ms; host enqueue per wrapper call "
        f"{min(host):.4f}-{max(host):.4f} ms")
    log(f"[11] where the timed mixed batch went: {mdt * 1e3:.3f} ms wall; kernels "
        f"{mbusy:.3f} ms, derived the same way, a derived device busy share of "
        f"{mbusy / (mdt * 1e3):.4f}; host phases {mphases} ms")

    # -- 12. writes --------------------------------------------------------------
    t0 = time.perf_counter()
    wr = write_phase(graph, leng, memb + list(mixed_q), rec)
    for entry in line:
        if entry["name"] in wr.timed:
            entry["overlay_path"] = wr.timed[entry["name"]]
    log(f"[12] write phase in {time.perf_counter() - t0:.1f} s")

    # -- 13. Expand ---------------------------------------------------------------
    t0 = time.perf_counter()
    xp = expand_phase(graph, leng, rec)
    line.extend(xp.entries)
    for name in EXPAND_KERNELS:
        log(f"[13] {name}: {len(rec.calls[name])} calls held, kernel == plain "
            f"(max abs err {rec.err[name]})")
    log(f"[13] Expand phase in {time.perf_counter() - t0:.1f} s")

    # -- 14. the graph-sharded mesh -------------------------------------------
    t0 = time.perf_counter()
    mp = mesh_phase(graph, engine, queries, list(mixed_q))
    for entry in line:
        if entry["name"] in mp.masked:
            entry["mesh_path"] = mp.masked[entry["name"]]
    line.extend(mp.entries)
    log(f"[14] mesh phase in {time.perf_counter() - t0:.1f} s")

    # -- 15. the tenant plane: frontiers packed by sort (K5b) ---------------------
    t0 = time.perf_counter()
    tp = tenant_phase()
    line.extend(tp.entries)
    log(f"[15] tenant phase in {time.perf_counter() - t0:.1f} s")

    # -- 16. the query-data-parallel checks, and the binary search --------------
    t0 = time.perf_counter()
    dpr = dp_phase(dp, frontier_keys=tp.sort_keys)
    for entry in line:
        if dpr.launches.get(entry["name"]):
            entry["dp_path"] = {"launches": dpr.launches[entry["name"]]}
        if entry["name"] == "lex_sort":
            entry["phase16_sorts"] = dpr.sorts
    line.append(dpr.entry)
    log(f"[16] data-parallel phase in {time.perf_counter() - t0:.1f} s")
    log(f"[16] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
