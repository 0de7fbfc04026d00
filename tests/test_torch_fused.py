"""Port parity of the fused wave (K8): ``ketotpu_torch.engine.fused``
against the JAX package's ``engine/fused.py`` at tolerance 0.

The wave's whole int32 ``[Q + F + G]`` output (per-row bit field, tier-1
and tier-2 occupancy) of ``run_fused_wave_plain`` must equal the JAX
``_wave_body`` run eagerly, as ``tests/test_fused.py`` runs it (here with
a few of its steps jitted one by one, ``_JITTED``), on the same
block and the same static schedules: mixed, all-fast and Leopard-only
waves, every probe mode, absent tiers, and retry lanes that fire.  Then
the port's engine with ``fused_dispatch`` against the JAX one (Leopard on,
non-adaptive schedules) on ``test_fused.py``'s mixed fixture: verdicts and
the tier counters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ketotpu.api.types import KetoAPIError as JKetoAPIError
from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import algebra as jalg
from ketotpu.engine import fastpath as jfp
from ketotpu.engine import fused as jfdx
from ketotpu.engine import hashtab as jhashtab
from ketotpu.engine import xutil as jxutil
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu_torch import kernels
from ketotpu_torch.api.types import KetoAPIError as TKetoAPIError
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine import fused as tfdx
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from test_fused import MIXED_TUPLES, OPL_MIXED, mixed_queries
from torch_parity import release_jax_caches  # noqa: F401 - autouse fixture

torch.set_num_threads(1)

#: one set of caps for every wave of this file, so the eager JAX wave
#: compiles its operations for one family of shapes (Q = 256) only; small
#: enough that tier 1 and tier 2 overflow and their retry lanes take rows
CAPS = dict(frontier=256, arena=64, gen_arena=32, vcap=64, gen_levels=3,
            gen_levels_max=5)

ERR_ROWS = ("Doc:d0#nope@User:u0", "Nope:x#view@User:u0")


#: steps of the JAX wave, each jitted on its own (the wave around them
#: runs eagerly): op by op, the first wave compiles some 600 single
#: operations and every wave dispatches thousands (a hash probe alone is a
#: few dozen gathers); a jitted step computes the same integers, as it
#: does inside the served jitted wave
_JITTED = [
    (jhashtab, "lookup", jax.jit(jhashtab.lookup, static_argnames=("probe",))),
    (jfp, "arena_assign", jax.jit(jxutil.arena_assign, static_argnums=1)),
    (jalg, "arena_assign", jax.jit(jxutil.arena_assign, static_argnums=1)),
    (jalg, "_visited", jax.jit(jalg._visited, static_argnums=6)),
    (jalg, "_classify_level", jax.jit(jalg._classify_level)),
    (jfp, "_pack_scatter", jax.jit(jfp._pack_scatter, static_argnames=(
        "frontier", "nsb", "relb"))),
]


@pytest.fixture(autouse=True)
def _eager_jax(monkeypatch):
    """The JAX engine's wave runs eagerly and its schedules stay fixed, as
    in ``tests/test_fused.py``, with its steps jitted (``_JITTED``)."""
    monkeypatch.setattr(jfdx, "_run_wave", jfdx._wave_body)
    for module, name, jitted in _JITTED:
        monkeypatch.setattr(module, name, jitted)
    monkeypatch.setenv("KETO_NO_ADAPTIVE", "1")


def _engines(**kw):
    """The JAX and the port engine, fused, Leopard on, over the mixed
    fixture; the port's schedules pinned non-adaptive like the JAX one's."""
    jns, jerr = jparse(OPL_MIXED)
    tns, terr = tparse(OPL_MIXED)
    assert not jerr and not terr
    jstore, tstore = JStore(), TStore()
    jstore.write_relation_tuples(*[JTuple.from_string(s) for s in MIXED_TUPLES])
    tstore.write_relation_tuples(*[TTuple.from_string(s) for s in MIXED_TUPLES])
    caps = dict(CAPS, **kw)
    jeng = JEngine(jstore, JManager(jns), fused_dispatch=True,
                   fused_retry_lanes=1, **caps)
    teng = TEngine(tstore, TManager(tns), fused_dispatch=True,
                   fused_retry_lanes=1, device="cpu", **caps)
    teng._update_occ = lambda occ: None
    teng._update_gen_occ = lambda occ: None
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _jax_tables(jeng, with_leo: bool):
    jeng.snapshot()
    g = dict(jeng._device_arrays)
    if with_leo:
        d = jeng._leo_device
        g.update(leo_sets=d["sets"], leo_elts=d["elts"], leo_hops=d["hops"])
    return g


def _run_both(jeng, tables, qpack, kwargs):
    """The JAX wave body, eager, and the port's plain wave and wrapper
    (CPU tensors: the plain versions) on the same inputs."""
    jg = _jax_tables(jeng, "leo_sets" in tables)
    want = np.asarray(jfdx._wave_body(jg, jnp.asarray(qpack), **kwargs))
    kernels.reset_launches()
    got = tfdx.run_fused_wave_plain(tables, qpack, **kwargs)
    wrapped = tfdx.run_fused_wave(tables, qpack, **kwargs)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert torch.equal(got, wrapped)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


FAST_ROWS = [f"Doc:d{i % 5}#view@User:u{i}" for i in range(30)]
#: view checks whose editor subject set must be expanded: at these caps
#: they overflow tier 1's arena
OVER_ROWS = [f"Doc:d1#view@User:x{i}" for i in range(40)]
LEO_ROWS = ["Group:g#members@User:gm1", "Group:g2#members@User:gm1",
            "Group:g#members@User:nobody", "Group:g2#members@User:u3",
            "Group:g9#members@User:gm1"]


@pytest.mark.parametrize("rows,depth", [
    ("mixed", 0), ("fast", 0), ("leopard", 0), ("leopard", 1),
])
def test_wave_matches_jax(engines, rows, depth):
    """A mixed wave (every tier, both retry lanes taking rows: bits 8 and
    9), an all-fast wave (tier 2 absent), and Leopard-only waves: at depth
    0 tier 0 answers every row, at depth 1 its hits are too deep and go to
    tier 1."""
    jeng, teng = engines
    batch = {"mixed": [s for s in mixed_queries() if s not in ERR_ROWS[:1]]
             + OVER_ROWS, "fast": FAST_ROWS, "leopard": LEO_ROWS}[rows]
    plan = teng.plan_wave([TTuple.from_string(s) for s in batch], depth)
    out = _run_both(jeng, plan.tables, plan.qpack, plan.kwargs)
    r = out[:plan.n]
    assert len(out) == plan.qpack.shape[1] + plan.flen + plan.glen
    if rows == "mixed":
        assert ((r >> 4) & 1).any() and ((r & 3) == 1).any()
        assert ((r >> 8) & 1).any() and ((r >> 9) & 1).any()
    if rows == "fast":
        assert plan.kwargs["gen"] is None and ((r >> 4) & 1).any()
    if rows == "leopard":
        assert plan.kwargs["gen"] is None
        assert ((r >> 6) & 1).all() == (depth == 0)
        assert ((r >> 7) & 1).any() == (depth == 0)


def test_every_probe_mode_and_absent_tiers_match_jax(engines):
    """Hand-set probe modes (all five, on every kind of row) at depth 2,
    through the wave with every tier and two tier-1 retry lanes, then with
    tier 1 absent and no pair columns, with tier 2 absent and no lanes, and
    with tier 0 alone."""
    jeng, teng = engines
    plan = teng.plan_wave([TTuple.from_string(s) for s in
                           mixed_queries() + LEO_ROWS + OVER_ROWS], 2)
    rng = np.random.default_rng(0)
    qpack = plan.qpack.copy()
    qpack[7] = rng.integers(0, 5, qpack.shape[1]).astype(np.int32)
    no_leo = {k: v for k, v in plan.tables.items() if not k.startswith("leo_")}
    base = plan.kwargs
    no_fast = dict(fast_sched=None, retry_sched=None, retry_lanes=0)
    no_gen = dict(gen=None, gen_retry=None)
    variants = [
        (plan.tables, dict(base, retry_lanes=2)),
        (no_leo, dict(base, **no_fast)),
        (plan.tables, dict(base, retry_lanes=0, **no_gen)),
        (plan.tables, dict(base, **no_fast, **no_gen)),
    ]
    for tables, kwargs in variants:
        out = _run_both(jeng, tables, qpack, kwargs)
        leo = (out[:plan.qpack.shape[1]] >> 6) & 3
        assert leo.any()


def _counters(eng):
    return {
        "leopard_answered": eng.leopard_answered,
        "leopard_hits": eng.leopard_hits,
        "retries": eng.retries,
        "fallbacks": eng.fallbacks,
        "fused_tier_rows": dict(eng.fused_tier_rows),
        "fused_waves": eng.fused_waves,
        "fused_d2h_fetches": eng.fused_d2h_fetches,
    }


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_fused_engine_matches_jax_engine(depth):
    jeng, teng = _engines()
    rows = [s for s in mixed_queries() + LEO_ROWS + OVER_ROWS
            if s not in ERR_ROWS]
    want = jeng.batch_check([JTuple.from_string(s) for s in rows], depth)
    got = teng.batch_check([TTuple.from_string(s) for s in rows], depth)
    assert got == want
    oracle = JOracle(jeng.store, jeng.namespace_manager)
    assert got == [oracle.check_is_member(JTuple.from_string(s), depth)
                   for s in rows]
    assert _counters(teng) == _counters(jeng)
    assert teng.fused_waves == teng.fused_d2h_fetches == 1
    tr = teng.fused_tier_rows
    assert tr["leopard"] > 0 and tr["fastpath"] > 0 and tr["general"] > 0
    assert teng.retries > 0
    # an undeclared relation raises the reference's typed error from the
    # oracle after the wave; an unknown namespace is a plain denial
    outcomes = [(_outcome(teng, TTuple, s, depth), _outcome(jeng, JTuple, s,
                                                            depth))
                for s in ERR_ROWS]
    assert all(t == j for t, j in outcomes)
    assert outcomes[0][0][0] == "raised"
    assert _counters(teng) == _counters(jeng)


def _outcome(eng, tuple_type, row: str, depth: int):
    try:
        return "answered", eng.batch_check([tuple_type.from_string(row)], depth)
    except (JKetoAPIError, TKetoAPIError) as e:
        return "raised", type(e).__name__, e.status_code


def test_fused_and_unfused_leopard_paths_agree(engines):
    """The port's two dispatch forms with Leopard on give the same
    verdicts and the same tier-0 counts, at caps that make both retry."""
    _jeng, fused0 = engines
    store, manager = fused0.store, fused0.namespace_manager
    fused = TEngine(store, manager, device="cpu", fused_dispatch=True, **CAPS)
    unfused = TEngine(store, manager, device="cpu", **CAPS)
    rows = [TTuple.from_string(s) for s in mixed_queries() + LEO_ROWS
            + OVER_ROWS if s not in ERR_ROWS]
    for depth in (0, 3):
        assert fused.batch_check(rows, depth) == unfused.batch_check(rows, depth)
    assert fused.leopard_answered == unfused.leopard_answered > 0
    assert fused.leopard_hits == unfused.leopard_hits > 0
    stats = fused.leopard_stats()
    assert stats["active"] == 1.0 and stats["answered"] == fused.leopard_answered
