"""Port parity of the write path: ``DeviceCheckEngine`` on the CPU (the
plain PyTorch versions), unfused and fused, against the JAX package's
engine on the same write script.

The scripts are the JAX suite's own: ``tests/test_delta.py::
TestOverlayEngine`` (membership writes through the overlay, edge writes
that mark rows dirty, an unrepresentable write, net-zero churn, AND/NOT
rows under pending writes, the overlay threshold) and
``tests/test_projection.py::TestSyncFold`` (an overflowing overlay folds;
a new node and delete-then-re-add fold).  After every step:

* both port engines' verdicts equal the JAX oracle's;
* the write path took the same tier as the JAX engine on the same
  changes: ``rebuilds``, ``overlay_applies``, ``folds``, ``generation``
  and ``last_compaction_mode`` equal (the JAX engine drains the same
  change log through ``snapshot()``, which compiles nothing);
* the closure index folded or rebuilt as the JAX engine's did (its pair,
  delta and dirty-set counts equal).

Plus the rest-depth quirk: at rest depth 0 the fused wave gets
``LM_HIT_ONLY`` for a delta pair of the closure index, as JAX does, and
answers as the oracle.
"""

import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.leopard import closure as tleo
from ketotpu_torch.utils import synth as tsynth

torch.set_num_threads(1)

GRAPH = dict(n_users=64, n_groups=8, n_folders=32, n_docs=128)
#: the JAX tests' engine sizes, with a small general tier (CPU time)
CAPS = dict(frontier=2048, arena=4096, max_batch=512, gen_arena=512,
            vcap=256)
TIER = ("rebuilds", "overlay_applies", "folds", "generation",
        "last_compaction_mode")


class Script:
    """One write script on two stores: the JAX engine's and the port's
    (one unfused and one fused engine over the same port store)."""

    def __init__(self, **engine):
        self.jg = jsynth.build_synth(**GRAPH)
        self.tg = tsynth.build_synth(**GRAPH)
        self.jeng = JEngine(self.jg.store, self.jg.manager, **CAPS)
        self.engines = [
            TEngine(self.tg.store, self.tg.manager, device="cpu", **CAPS,
                    **engine),
            TEngine(self.tg.store, self.tg.manager, device="cpu",
                    fused_dispatch=True, **CAPS, **engine),
        ]
        self.oracle = JOracle(self.jg.store, self.jg.manager)
        self.tuples = [str(t) for t in self.jg.store.all_tuples()]

    def set(self, **attrs):
        for e in (self.jeng, *self.engines):
            for k, v in attrs.items():
                setattr(e, k, v)

    def write(self, *rows):
        self.jg.store.write_relation_tuples(*map(JTuple.from_string, rows))
        self.tg.store.write_relation_tuples(*map(TTuple.from_string, rows))

    def delete(self, *rows):
        self.jg.store.delete_relation_tuples(*map(JTuple.from_string, rows))
        self.tg.store.delete_relation_tuples(*map(TTuple.from_string, rows))

    def check(self, rows, rest_depth=0):
        """Every engine's verdicts against the oracle's, then the tiers."""
        want = [self.oracle.check_is_member(JTuple.from_string(r), rest_depth)
                for r in rows]
        for e in self.engines:
            got = e.batch_check([TTuple.from_string(r) for r in rows],
                                rest_depth)
            assert got == want, [r for r, a, b in zip(rows, got, want) if a != b]
        self.jeng.snapshot()
        self.assert_tiers()
        return want

    def assert_tiers(self):
        jt = [getattr(self.jeng, k) for k in TIER]
        for e in self.engines:
            assert [getattr(e, k) for k in TIER] == jt, e.fused_dispatch
        jl = self.jeng._leopard
        for e in self.engines:
            tl = e.leopard_index()
            assert (jl is None) == (tl is None)
            if jl is not None:
                js, ts = jl.stats(), tl.index.stats()
                for k in ("pairs", "dirty_sets", "delta_pairs"):
                    assert ts[k] == js[k], k

    def counts(self, name):
        return [getattr(e, name) for e in self.engines]


def _queries(script, n, seed):
    return [str(t) for t in jsynth.synth_queries(script.jg, n, seed=seed)]


def _users(script, n):
    return sorted({t.split("@", 1)[1] for t in script.tuples
                   if ":" not in t.split("@", 1)[1]})[:n]


# -- tests/test_delta.py::TestOverlayEngine ------------------------------------


def test_membership_writes_apply_via_overlay():
    s = Script()
    qs = _queries(s, 200, 11)
    s.check(qs)
    base = s.counts("rebuilds")
    doc = next(t for t in s.tuples if "#viewers@" in t)
    user = next(t.split("@", 1)[1] for t in s.tuples
                if ":" not in t.split("@", 1)[1])
    grant = f"{doc.split('#', 1)[0]}#viewers@{user}"
    s.write(grant)
    assert s.check(qs + [grant])[-1] is True
    s.delete(grant)
    s.check(qs + [grant])
    assert s.counts("rebuilds") == base
    assert min(s.counts("overlay_applies")) >= 2
    assert all(e.last_write["tier"] == "overlay" for e in s.engines)


def test_edge_writes_mark_dirty_and_stay_exact():
    s = Script()
    qs = _queries(s, 300, 13)
    s.check(qs)
    base = s.counts("rebuilds")
    fb = s.counts("fallbacks")
    edge = next(t for t in s.tuples
                if "#viewers@" in t and "#" in t.split("@", 1)[1])
    s.delete(edge)
    s.check(qs)  # rows through the dirty row fall back to the oracle
    s.write(edge)
    s.check(qs)
    assert s.counts("rebuilds") == base
    assert all(b > a for a, b in zip(fb, s.counts("fallbacks")))


def test_unrepresentable_change_triggers_rebuild():
    s = Script()
    qs = _queries(s, 100, 17)
    s.check(qs)
    base = s.counts("rebuilds")
    s.write("brandnewns:obj#rel@someone")
    s.check(qs)
    assert s.counts("rebuilds") == [b + 1 for b in base]


def test_net_zero_churn_is_absorbed():
    s = Script()
    qs = _queries(s, 60, 19)
    s.check(qs)
    base = s.counts("rebuilds")
    many = [t for t in s.tuples[:20] if "#viewers@" not in t]
    s.delete(*many)
    s.write(*many)
    s.check(qs)
    assert s.counts("rebuilds") == base
    assert all(e._overlay.size()[0] == 0 for e in s.engines)


def test_general_queries_on_device_with_overlay():
    """AND/NOT rows are answered on the card under pending writes: a ban
    (a membership write) changes Doc#edit with no oracle fallback; a
    deleted Doc#parents edge dirties its row and the rows through it go to
    the oracle, exactly."""
    s = Script()
    dv = next(t for t in s.tuples if t.startswith("Doc:")
              and "#viewers@" in t and "#" not in t.split("@", 1)[1])
    user, doc = dv.split("@", 1)[1], dv.split("#", 1)[0].split(":", 1)[1]
    q = f"Doc:{doc}#edit@{user}"
    assert s.check([q]) == [True]
    base = s.counts("rebuilds")
    fb = s.counts("fallbacks")
    s.write(f"Doc:{doc}#banned@{user}")
    assert s.check([q]) == [False]
    assert s.counts("fallbacks") == fb  # a clean overlay: no fallback
    assert s.counts("rebuilds") == base
    s.delete(f"Doc:{doc}#banned@{user}")
    assert s.check([q]) == [True]
    assert s.counts("fallbacks") == fb
    edge = next(t for t in s.tuples
                if t.startswith("Doc:") and "#parents@" in t)
    s.delete(edge)
    s.check([f"Doc:{edge.split('#', 1)[0].split(':', 1)[1]}#edit@{u}"
             for u in _users(s, 8)])
    s.write(edge)
    assert s.counts("rebuilds") == base


def test_overlay_threshold_triggers_the_jax_tier():
    """More net overlay pairs than ``max_overlay_pairs``: the engine takes
    whatever tier the JAX engine takes (fold, else rebuild)."""
    s = Script()
    s.set(max_overlay_pairs=8)
    qs = _queries(s, 60, 21)
    s.check(qs)
    doc = next(t for t in s.tuples if "#viewers@" in t).split("#", 1)[0]
    grants = [f"{doc}#viewers@{u}" for u in _users(s, 12)]
    s.write(*grants)
    s.check(qs + grants)
    assert s.engines[0].last_write["tier"] in ("fold", "rebuild")


# -- tests/test_projection.py::TestSyncFold --------------------------------------


def test_overlay_overflow_folds_instead_of_rebuilding():
    s = Script()
    s.set(max_overlay_pairs=4)
    qs = _queries(s, 120, 23)
    s.check(qs)
    base = s.counts("rebuilds")
    doc = next(t for t in s.tuples
               if t.startswith("Doc:") and "#viewers@" in t).split("#", 1)[0]
    grants = [f"{doc}#viewers@{u}" for u in _users(s, 8)]
    s.write(*grants)
    assert s.check(grants) == [True] * len(grants)
    assert min(s.counts("folds")) >= 1
    assert s.counts("rebuilds") == base
    for e in s.engines:
        st = e.projection_stats()
        assert e.last_compaction_mode == "fold"
        assert st["served_cursor"] == st["log_cursor"]
        assert st["since_base"] == 0
    s.check(qs)
    s.delete(*grants)
    s.check(qs + grants)


def test_fold_handles_new_node_and_delete_then_readd():
    s = Script()
    s.set(max_overlay_pairs=2)
    qs = _queries(s, 120, 29)
    s.check(qs)
    base = s.counts("rebuilds")
    fresh = [f"Doc:folddoc#viewers@{u}" for u in _users(s, 6)]
    s.write(*fresh)
    s.delete(fresh[0])
    s.write(fresh[0])
    assert s.check(fresh + qs)[:6] == [True] * 6
    assert min(s.counts("folds")) >= 1
    s.delete(*fresh)
    assert s.check(fresh + qs)[:6] == [False] * 6
    assert s.counts("rebuilds") == base


# -- the rest-depth quirk (LM_HIT_ONLY at rest depth 0) --------------------------


def test_depth0_delta_pair_is_hit_only_and_exact():
    """A membership written after the closure build is a delta pair of the
    index.  The fused engine passes the raw rest depth 0 to
    ``prep_fused_checks`` (as JAX does), so the pair's probe mode is
    ``LM_HIT_ONLY`` there and ``LM_ALLOW`` at rest depth 5: tier 1
    answers the first, tier 0 the second, both as the oracle."""
    s = Script()
    qs = _queries(s, 40, 31)
    s.check(qs)
    fused = s.engines[1]
    grant = "Group:g1#members@" + _users(s, 40)[-1]
    assert not s.check([grant])[0]
    s.write(grant)
    assert s.check([grant] + qs, rest_depth=0)[0] is True
    assert fused.last_write["leopard"] == "apply"
    jl = s.jeng._leopard
    assert jl is not None and jl.stats()["delta_pairs"] >= 1
    for depth, mode in ((0, tleo.LM_HIT_ONLY), (5, tleo.LM_ALLOW)):
        plan = fused.plan_wave([TTuple.from_string(grant)], depth)
        assert int(plan.qpack[7, 0]) == mode, depth
        s.check([grant] + qs, rest_depth=depth)
    assert fused.leopard_answered > 0
