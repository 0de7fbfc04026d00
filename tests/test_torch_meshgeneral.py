"""Port parity: the sharded AND/NOT tier (``graphshard.sharded_general_check``,
the K7 program with the JAX ``shard=`` branch's owner merges) against the
JAX package's ``parallel/graphshard.py:217`` ``sharded_general_check``, at
tolerance 0: the codes and every shard's occupancy row.

The AND/NOT fixture of ``tests/torch_parity.py`` (intersection, exclusion,
a NOT chain, subject sets into AND/NOT permits across shards, a tainted
recursion deeper than the level budget, a client error, the visited set's
duplicate key) runs in one 128-row block at two static shapes of four skeleton levels,
because XLA:CPU compiles each sharded program anew (about 25-35 s):
four shards at the tier-2 parity file's small capacities (every batch
reaches a capacity edge), and three shards at roomier ones, where ``n *
cap`` differs from the arena (a 16-slot arena's ``arena // n`` is under
8, so its cap is 8).
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.opl.parser import parse as jparse
from ketotpu.parallel import graphshard as jgs
from ketotpu.parallel import make_mesh as jmake_mesh
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.parallel import graphshard as tgs
from ketotpu_torch.parallel import make_mesh as tmake_mesh
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from torch_parity import (
    ALGEBRA_BATCHES,
    ALGEBRA_OPL,
    algebra_tuples,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

Q = 128
#: (shards, sizes, fast_b, sub-run schedule, vcap)
SHAPES = {
    "small": (4, (96, 96, 64, 64), 16, tfp.level_schedule(16, 64, 128, 5), 8),
    "three": (3, (256,) * 4, 128, tfp.level_schedule(128, 256, 16, 5), 64),
}


@pytest.fixture(scope="module")
def fixture():
    """Both packages' stores over the fixture, and the 128-row block."""
    jns, errs = jparse(ALGEBRA_OPL)
    assert not errs, errs
    tns, errs = tparse(ALGEBRA_OPL)
    assert not errs, errs
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*[JTuple.from_string(s) for s in algebra_tuples()])
    ts.write_relation_tuples(*[TTuple.from_string(s) for s in algebra_tuples()])
    rows = [r for b in ALGEBRA_BATCHES.values() for r in b]
    assert len(rows) <= Q
    return (js, JManager(jns)), (ts, TManager(tns)), rows


def _qpack(vocab, rows):
    qp = np.zeros((6, Q), np.int32)
    qp[:4, len(rows):] = -1
    qp[4] = 1
    ts = [TTuple.from_string(r) for r in rows]
    qp[0, :len(rows)] = [vocab.namespaces.lookup(t.namespace) for t in ts]
    qp[1, :len(rows)] = [vocab.objects.lookup(t.object) for t in ts]
    qp[2, :len(rows)] = [vocab.relations.lookup(t.relation) for t in ts]
    qp[3, :len(rows)] = [vocab.subject_key(t.subject) for t in ts]
    qp[4, :len(rows)] = 5
    qp[5, :len(rows)] = 1
    return qp


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_general_matches_jax(fixture, shape):
    (js, jm), (ts, tm), rows = fixture
    n, sizes, fast_b, fast_sched, vcap = SHAPES[shape]
    _jsn, jst = jgs.build_sharded_snapshot(js, jm, n)
    tsn, tst = tgs.build_sharded_snapshot(ts, tm, n)
    for k in jst:
        assert np.array_equal(tst[k], jst[k]), k
    qpack = _qpack(tsn[0].vocab, rows)
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched, max_width=100,
              vcap=vcap)
    jcodes, jocc = jgs.sharded_general_check(
        jst, qpack, jmake_mesh(n, axis="shard"), axis="shard", **kw)
    tmesh = tmake_mesh(n, "shard", ["cpu"] * n)
    tcodes, tocc = tgs.sharded_general_check(
        tgs.upload_shards(tst, tmesh), qpack, tmesh, **kw)
    jcodes, jocc = np.asarray(jcodes), np.asarray(jocc)
    assert np.array_equal(tcodes, jcodes)
    assert tocc.shape == jocc.shape == (n, len(sizes) + 2 + len(fast_sched))
    assert np.array_equal(tocc, jocc)
    res = tcodes[: len(rows)] & 3
    assert (res == 1).any() and (res == 2).any()
    # the sub-run's occupancy is per shard: the rows differ there
    split = len(sizes) + 2
    assert (tocc[:, :split] == tocc[0, :split]).all()
    assert ((tcodes[: len(rows)] >> 2) & 1).any(), "the caps must overflow"
    assert len(set(map(tuple, tocc[:, split:]))) > 1
