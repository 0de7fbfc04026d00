"""Port parity: ``ketotpu_torch.engine.device.DeviceCheckEngine`` (on the
CPU, through the plain PyTorch versions) against the JAX package's
``DeviceCheckEngine`` with the unfused cascade and Leopard off, and
against the JAX oracle (``tests/test_torch_fused.py`` holds the fused wave
with Leopard on).

Verdicts are exact on both sides (the BFS answers pure-OR rows, the
algebra program AND/NOT rows, the host oracle what overflows both tiers'
retries), so they must agree bit for bit; an error row must raise the
same typed error.
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import KetoAPIError as JKetoAPIError
from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.ast import Namespace as JNamespace
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import KetoAPIError as TKetoAPIError
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.opl.ast import Namespace as TNamespace
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from ketotpu_torch.utils import synth as tsynth
from torch_parity import (
    ALGEBRA_BATCHES,
    ALGEBRA_OPL,
    CAT_VIDEOS_QUERIES,
    FIXTURES,
    REWRITES_QUERIES,
    REWRITES_TUPLES,
    SMALL_SYNTH,
    algebra_tuples,
    cat_videos_tuples,
    granted_checks,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

# one schedule for every JAX batch of this file: no adaptive re-sizing, and
# caps wide enough that no row needs the retry program
JAX_CAPS = dict(frontier=1024, arena=8192)


@pytest.fixture(autouse=True)
def _fixed_jax_schedule(monkeypatch):
    monkeypatch.setenv("KETO_NO_ADAPTIVE", "1")


@pytest.fixture(scope="module")
def synth():
    jg = jsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    tg = tsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    jeng = JEngine(jg.store, jg.manager, fused_dispatch=False,
                   leopard={"enabled": False}, **JAX_CAPS)
    teng = TEngine(tg.store, tg.manager, leopard={"enabled": False},
                   device="cpu")
    return jg, tg, jeng, teng


def _synth_queries(jg):
    """Mixed Doc view/edit rows (edit reaches AND/NOT: general rows) with
    subject-set subjects, plus grant-derived rows so verdicts are mixed."""
    mixed = jsynth.synth_queries_mixed(jg, 160, seed=4)
    rows = [str(t) for t in mixed]
    return rows + granted_checks(jg.store, 96, seed=4)


def test_synth_batch_matches_jax_engine_and_oracle(synth):
    jg, tg, jeng, teng = synth
    rows = _synth_queries(jg)
    jq = [JTuple.from_string(s) for s in rows]
    tq = [TTuple.from_string(s) for s in rows]
    oracle = JOracle(jg.store, jg.manager)
    got = teng.batch_check(tq)
    assert got == jeng.batch_check(jq)
    assert got == [oracle.check_is_member(q) for q in jq]
    assert any(got) and not all(got)
    # the edit rows ran the algebra program, none went to the oracle
    assert teng.general_rows > 0 and teng.fallbacks == 0
    # shallower request depths (the JAX algebra program would compile anew
    # per depth, so these hold the port against the oracle alone)
    for depth in (3, 2):
        want = [oracle.check_is_member(q, depth) for q in jq]
        assert teng.batch_check(tq, depth) == want
    assert teng.rebuilds == 1


def test_error_row_raises_the_same_typed_error(synth):
    jg, tg, jeng, teng = synth
    bad = "Doc:d1#nope@u1"
    with pytest.raises(JKetoAPIError) as jerr:
        jeng.batch_check([JTuple.from_string(bad)])
    with pytest.raises(TKetoAPIError) as terr:
        teng.batch_check([TTuple.from_string(bad)])
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert terr.value.status_code == jerr.value.status_code
    assert terr.value.message == jerr.value.message


def test_overflow_retry_then_oracle(synth):
    """Caps far too small: the not-found tail retries at 4x, what still
    overflows goes to the oracle, and the verdicts stay exact."""
    jg, tg, _jeng, _teng = synth
    rows = [str(t) for t in jsynth.synth_queries(jg, 200, seed=6)]
    rows += granted_checks(jg.store, 56, seed=6)
    tiny = TEngine(tg.store, tg.manager, frontier=256, arena=64, device="cpu")
    oracle = JOracle(jg.store, jg.manager)
    got = tiny.batch_check([TTuple.from_string(s) for s in rows])
    assert got == [oracle.check_is_member(JTuple.from_string(s)) for s in rows]
    assert tiny.retries > 0 and tiny.fallbacks > 0


def test_general_rows_retry_at_boosted_caps(synth):
    """A general skeleton far too small for the batch: the overflowed rows
    re-run at retry_scale x caps and fit there; no row reaches the
    oracle."""
    jg, tg, _jeng, _teng = synth
    rows = [str(t) for t in jsynth.synth_queries_mixed(jg, 40, seed=8,
                                                       general_frac=1.0)]
    rows += [s.replace("#view@", "#edit@") for s in granted_checks(jg.store, 24, 8)]
    eng = TEngine(tg.store, tg.manager, gen_arena=64, device="cpu")
    oracle = JOracle(jg.store, jg.manager)
    got = eng.batch_check([TTuple.from_string(s) for s in rows])
    assert got == [oracle.check_is_member(JTuple.from_string(s)) for s in rows]
    assert eng.general_retries > 0 and eng.fallbacks == 0
    assert any(got) and not all(got)


def test_general_rows_over_after_retry_go_to_the_oracle(synth):
    """One skeleton level at both tiers: every edit root exhausts the level
    budget, retries, exhausts it again and is answered by the oracle."""
    jg, tg, _jeng, _teng = synth
    rows = [s.replace("#view@", "#edit@") for s in granted_checks(jg.store, 64, 9)]
    eng = TEngine(tg.store, tg.manager, gen_levels=1, gen_levels_max=1,
                  device="cpu")
    oracle = JOracle(jg.store, jg.manager)
    got = eng.batch_check([TTuple.from_string(s) for s in rows])
    assert got == [oracle.check_is_member(JTuple.from_string(s)) for s in rows]
    assert eng.general_retries == len(rows) == eng.fallbacks
    assert any(got)


def test_algebra_fixture_matches_the_oracle():
    """The tier-2 fixture (AND, NOT chains, visited-set dedup, a tainted
    recursion, a client error mid-traversal) through the port engine at
    its default caps: verdicts equal the oracle's, the error row raises
    its typed error."""
    from ketotpu.storage import InMemoryTupleStore as JS

    namespaces, errs = jparse(ALGEBRA_OPL)
    assert not errs, errs
    tns, terrs = tparse(ALGEBRA_OPL)
    assert not terrs, terrs
    js, ts = JS(), TStore()
    js.write_relation_tuples(*[JTuple.from_string(s) for s in algebra_tuples()])
    ts.write_relation_tuples(*[TTuple.from_string(s) for s in algebra_tuples()])
    oracle = JOracle(js, JManager(namespaces))
    teng = TEngine(ts, TManager(tns), device="cpu")
    for name, batch in ALGEBRA_BATCHES.items():
        if name == "error":
            with pytest.raises(TKetoAPIError):
                teng.batch_check([TTuple.from_string(s) for s in batch])
            with pytest.raises(JKetoAPIError):
                oracle.check_is_member(JTuple.from_string(batch[0]))
            continue
        want = [oracle.check_is_member(JTuple.from_string(s)) for s in batch]
        assert teng.batch_check([TTuple.from_string(s) for s in batch]) == want
    assert teng.general_rows > 0


def _fixture_engines(case):
    if case == "cat-videos":
        rows = cat_videos_tuples()
        jt = [JTuple.from_json(d) for d in rows]
        tt = [TTuple.from_json(d) for d in rows]
        jm = JManager([JNamespace(name="videos")])
        tm = TManager([TNamespace(name="videos")])
        queries = CAT_VIDEOS_QUERIES
    else:
        src = (FIXTURES / "rewrites_namespaces.keto.ts").read_text()
        jm, tm = JManager(jparse(src)[0]), TManager(tparse(src)[0])
        jt = [JTuple.from_string(s) for s in REWRITES_TUPLES]
        tt = [TTuple.from_string(s) for s in REWRITES_TUPLES]
        queries = REWRITES_QUERIES
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*jt)
    ts.write_relation_tuples(*tt)
    return js, jm, ts, tm, queries


@pytest.mark.parametrize("case", ["cat-videos", "rewrites"])
def test_fixtures_match_jax_engine_and_oracle(case):
    js, jm, ts, tm, queries = _fixture_engines(case)
    jeng = JEngine(js, jm, fused_dispatch=False, leopard={"enabled": False},
                   **JAX_CAPS)
    teng = TEngine(ts, tm, leopard={"enabled": False}, device="cpu")
    oracle = JOracle(js, jm)
    jq = [JTuple.from_string(s) for s in queries]
    want = [oracle.check_is_member(q) for q in jq]
    got = teng.batch_check([TTuple.from_string(s) for s in queries])
    assert got == want == jeng.batch_check(jq)
    assert any(got) and not all(got)


def test_write_reprojects_before_the_next_batch():
    """A write reaches the next batch: the engine drains the store's change
    log before it plans, here through the delta overlay (a membership write
    on known ids), as the JAX engine does, with no re-projection."""
    js, jm, ts, tm, _queries = _fixture_engines("rewrites")
    teng = TEngine(ts, tm, device="cpu")
    q = TTuple.from_string("File:keto/README.md#view@eve")
    assert teng.batch_check([q]) == [False]
    ts.write_relation_tuples(TTuple.from_string("Group:dev#members@eve"))
    js.write_relation_tuples(JTuple.from_string("Group:dev#members@eve"))
    assert teng.batch_check([q]) == [True]
    assert JOracle(js, jm).check_is_member(JTuple.from_string(str(q)))
    assert (teng.rebuilds, teng.overlay_applies) == (1, 1)
    assert teng.last_write["tier"] == "overlay"
    ts.delete_relation_tuples(TTuple.from_string("Group:dev#members@eve"))
    assert teng.check(q) is False
    assert (teng.rebuilds, teng.overlay_applies) == (1, 2)


def test_large_batch_chunks_in_order():
    """More rows than max_batch: chunks are enqueued, then collected in
    order."""
    js, jm, ts, tm, queries = _fixture_engines("rewrites")
    teng = TEngine(ts, tm, max_batch=256, device="cpu")
    rows = list(queries) * 60  # 720 rows, three chunks
    want = [JOracle(js, jm).check_is_member(JTuple.from_string(s))
            for s in queries] * 60
    assert teng.batch_check([TTuple.from_string(s) for s in rows]) == want
    assert np.mean(want) > 0
