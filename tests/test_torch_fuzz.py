"""Engine-level differential fuzz of the port against the JAX oracle.

Random namespace configs and graphs from the JAX suite's own generator
(``tests/test_device_engine.py::_random_case``: one or two namespaces,
unions, tuple-to-usersets, AND and AND-NOT rewrites, subject-set edges)
served by the port's ``DeviceCheckEngine`` on the CPU (the plain PyTorch
versions of every kernel):

* the verdict fuzz: every query at rest depths 0, 1, 2 and 4, through the
  unfused cascade (Leopard off) and the fused wave (Leopard on);
* the write fuzz: random inserts and deletes between batches, served
  through the delta overlay (else the fold, else a re-projection), at
  rest depths 0 and 2, with the tier each drain took held against the JAX
  engine's on the same changes.

Every verdict must equal the oracle's (an error row must raise the same
typed error).
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import KetoAPIError as JKetoAPIError
from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu_torch.api.types import KetoAPIError as TKetoAPIError
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from test_device_engine import _random_case

torch.set_num_threads(1)

#: small caps: the random graphs are tiny, and CPU time grows with them
CAPS = dict(frontier=256, arena=1024, max_batch=256, gen_arena=256, vcap=64)
TIER = ("rebuilds", "overlay_applies", "folds", "generation")


def _stores(source, tuples):
    jns, errs = jparse(source)
    assert not errs, errs
    tns, errs = tparse(source)
    assert not errs, errs
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*map(JTuple.from_string, tuples))
    ts.write_relation_tuples(*map(TTuple.from_string, tuples))
    return js, JManager(jns), ts, TManager(tns)


def _oracle_rows(oracle, queries, depth):
    """The oracle's verdict per query, or the name of its typed error."""
    out = []
    for q in queries:
        try:
            out.append(oracle.check_is_member(JTuple.from_string(q), depth))
        except JKetoAPIError as e:
            out.append(type(e).__name__)
    return out


def _assert_engine(eng, queries, depth, want):
    """Error rows one by one (each must raise the oracle's error type); the
    rest as one batch."""
    ok = [i for i, w in enumerate(want) if isinstance(w, bool)]
    got = eng.batch_check([TTuple.from_string(queries[i]) for i in ok], depth)
    assert got == [want[i] for i in ok], (depth, [
        queries[i] for i, g in zip(ok, got) if g != want[i]])
    for i, w in enumerate(want):
        if not isinstance(w, bool):
            with pytest.raises(TKetoAPIError) as e:
                eng.check(TTuple.from_string(queries[i]), depth)
            assert type(e.value).__name__ == w


@pytest.mark.parametrize("seed", range(8))
def test_verdict_fuzz(seed):
    source, tuples, queries = _random_case(np.random.default_rng(seed))
    js, jm, ts, tm = _stores(source, tuples)
    oracle = JOracle(js, jm)
    engines = [
        TEngine(ts, tm, device="cpu", leopard={"enabled": False}, **CAPS),
        TEngine(ts, tm, device="cpu", fused_dispatch=True, **CAPS),
    ]
    for depth in (0, 1, 2, 4):
        want = _oracle_rows(oracle, queries, depth)
        for eng in engines:
            _assert_engine(eng, queries, depth, want)
    assert engines[1].fused_waves > 0


def _random_write(rng, source_tuples, live):
    """One insert or delete over the case's own vocabulary."""
    if live and rng.random() < 0.45:
        return -1, live[int(rng.integers(len(live)))]
    t = source_tuples[int(rng.integers(len(source_tuples)))]
    head, subj = t.split("@", 1)
    ns, rest = head.split(":", 1)
    obj = f"o{int(rng.integers(5))}"  # o4 is an object the graph never had
    return 1, f"{ns}:{obj}#{rest.split('#', 1)[1]}@{subj}"


@pytest.mark.parametrize("seed", range(6))
def test_write_fuzz(seed):
    rng = np.random.default_rng(1000 + seed)
    source, tuples, queries = _random_case(rng)
    js, jm, ts, tm = _stores(source, tuples)
    oracle = JOracle(js, jm)
    jeng = JEngine(js, jm, **CAPS)
    eng = TEngine(ts, tm, device="cpu", fused_dispatch=bool(seed % 2), **CAPS)
    live = list(tuples)
    for step in range(6):
        for depth in (0, 2):
            _assert_engine(eng, queries, depth,
                           _oracle_rows(oracle, queries, depth))
        jeng.snapshot()
        assert [getattr(eng, k) for k in TIER] == [
            getattr(jeng, k) for k in TIER], step
        op, t = _random_write(rng, tuples, live)
        if op > 0:
            js.write_relation_tuples(JTuple.from_string(t))
            ts.write_relation_tuples(TTuple.from_string(t))
            live.append(t)
        else:
            js.delete_relation_tuples(JTuple.from_string(t))
            ts.delete_relation_tuples(TTuple.from_string(t))
            live.remove(t)
    assert eng.overlay_applies > 0
