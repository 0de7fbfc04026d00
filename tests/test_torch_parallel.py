"""Port parity: the query-data-parallel checks (``parallel/mesh.py``
``shard_fast_check``, ``shard_general_check``) and their unpacked step
(``engine/fastpath.py`` ``step_impl``) against the JAX package, at
tolerance 0.

The JAX side runs on the virtual 8-device CPU platform that
``tests/conftest.py`` forces; the port's mesh is ``["cpu"] * n`` in one
process, so its wrappers take their plain versions (``chip_smoke.py``
holds the CUDA kernels against those on the card).  Both packages read the
same numpy tables: the JAX engine's check arrays.  ``jax.jit`` compiles
the JAX ``shard_fast_check`` anew on every call (its program is a closure
built per call), and the general program costs XLA:CPU about 25 s per
shape, so the file keeps to two fast calls, one jitted step and one
general shape.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import fastpath as jfp
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.parser import parse as jparse
from ketotpu.parallel import make_mesh as jmake_mesh
from ketotpu.parallel import shard_fast_check as jshard_fast_check
from ketotpu.parallel import shard_general_check as jshard_general_check
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils.synth import build_synth, synth_queries
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.parallel import FastResult
from ketotpu_torch.parallel import make_mesh as tmake_mesh
from ketotpu_torch.parallel import shard_fast_check, shard_general_check
from ketotpu_torch.parallel.mesh import replicate
from torch_parity import release_jax_caches  # noqa: F401 - autouse fixture

torch.set_num_threads(1)

N = 8
#: the JAX suite's caps: no overflow; four levels keep the JAX compile
#: short (the port alone runs the fifth, against the oracle)
ROOMY = dict(frontier=1024, arena=4096, max_depth=4)
#: depth-5 roots, 3 levels: every level builds children, and the last
#: level's arena overflows (its over bits are part of the result)
TIGHT = dict(frontier=64, arena=64, max_depth=3)
FRONTIER_COLS = ("qid", "ns", "obj", "rel", "depth", "skip", "force")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(n):
    return tmake_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def synth():
    """The JAX suite's synth graph: its engine's check tables (numpy, read
    by both packages), 128 encoded Doc#view queries and their oracle
    verdicts."""
    graph = build_synth(n_users=64, n_groups=8, n_folders=32, n_docs=128)
    eng = JEngine(graph.store, graph.manager, frontier=1024, arena=4096)
    snap = eng.snapshot()
    queries = synth_queries(graph, 128)
    enc = tuple(np.asarray(a) for a in eng._encode(snap, queries, 0))
    g = {k: np.asarray(v) for k, v in eng._device_arrays.items()}
    want = np.array([eng.oracle.check_is_member(r) for r in queries])
    return g, enc, want


@pytest.mark.parametrize("caps", ["roomy", "tight"])
def test_shard_fast_check_matches_jax(synth, caps):
    g, enc, want = synth
    kw = ROOMY if caps == "roomy" else TIGHT
    jres = jshard_fast_check(g, enc, jmake_mesh(N), **kw)
    res = shard_fast_check(g, enc, _mesh(N), **kw)
    assert isinstance(res, FastResult) and res.dirty is None
    assert res.found.dtype == torch.bool and res.over.dtype == torch.bool
    assert np.array_equal(_np(res.found), _np(jres.found))
    assert np.array_equal(_np(res.over), _np(jres.over))
    if caps == "roomy":
        assert not _np(res.over).any() and _np(res.found).any()
        # no row overflows, so the verdicts do not depend on the slicing,
        # and at the engine's depth (5) they are the oracle's
        for n in (1, 2, N):
            other = shard_fast_check(g, enc, _mesh(n), **dict(kw, max_depth=5))
            assert np.array_equal(_np(other.found), want) and want.any()
            assert not _np(other.over).any()
    else:
        # the last level's arena overflow adds over bits of its own
        before = shard_fast_check(g, enc, _mesh(N), **dict(kw, max_depth=2))
        late = _np(res.over) & ~_np(before.over)
        assert late.any()
        # found is monotone: a found row is allowed
        assert not (_np(res.found) & ~want).any()


def test_step_impl_matches_jax(synth):
    """Two steps of the unpacked state, column by column, from the roots
    of one 16-row slice (depth 5: no clamp)."""
    g, enc, _want = synth
    q, frontier, arena = 16, 64, 128
    cols = [a[:q] for a in enc]
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    js = jfp.init_state(*[jnp.asarray(c) for c in cols], frontier=frontier)
    tg = replicate(g, [torch.device("cpu")])[torch.device("cpu")]
    qp = torch.from_numpy(np.stack([*cols, np.ones(q, np.int32)]))
    ts = tfp.step_state(qp, frontier=frontier)
    step = jax.jit(jfp.step_impl, static_argnames=("frontier", "arena", "max_width"))
    for level in range(2):
        js = step(jg, js, frontier=frontier, arena=arena, max_width=100)
        ts = tfp.fast_step(tg, ts, frontier=frontier, arena=arena, max_width=100)
        for name, col in zip(FRONTIER_COLS, (ts.f.qid, ts.f.ns, ts.f.obj, ts.f.rel,
                                             ts.f.d, ts.f.skip, ts.f.force)):
            assert np.array_equal(_np(col), np.asarray(js["f_" + name])), (level, name)
        for name in ("q_found", "q_over", "q_dirty"):
            assert np.array_equal(_np(getattr(ts, name)) != 0,
                                  np.asarray(js[name])), (level, name)
        assert np.array_equal(_np(ts.q_subj), np.asarray(js["q_subj"]))
        assert (_np(ts.f.qid) >= 0).any(), level
    assert int(ts.f.d.max()) == 3  # roots entered at depth 5, unclamped


def test_uneven_batch_raises(synth):
    g, enc, _want = synth
    bad = tuple(a[:100] for a in enc)
    with pytest.raises(ValueError, match="not divisible"):
        shard_fast_check(g, bad, _mesh(N))
    with pytest.raises(ValueError, match="not divisible"):
        shard_general_check(g, np.zeros((6, 100), np.int32), _mesh(N), sizes=(64,),
                            fast_b=16, fast_sched=((16, 64),))


AND_OPL = """
import { Namespace, Context } from "@ory/keto-namespace-types"
class User implements Namespace {}
class d implements Namespace {
  related: { editors: User[], signers: User[] }
  permits = {
    finalize: (ctx: Context): boolean =>
      this.related.editors.includes(ctx.subject) &&
      this.related.signers.includes(ctx.subject),
  }
}
"""


def test_shard_general_check_matches_jax():
    """``tests/test_parallel.py``'s AND/NOT fixture: 16 rows over 8
    devices at the JAX engine's per-device schedule; the codes and every
    device's occupancy row, and the verdicts of the rows not over against
    the oracle."""
    store = JStore()
    store.write_relation_tuples(
        *[JTuple.from_string(f"d:o{i}#editors@u{i % 4}") for i in range(16)],
        *[JTuple.from_string(f"d:o{i}#signers@u{i % 3}") for i in range(16)],
    )
    namespaces, errs = jparse(AND_OPL)
    assert not errs
    # three skeleton levels and two sub-run levels reach every verdict
    # here and keep the JAX program's compile under 20 s
    eng = JEngine(store, JManager(namespaces), frontier=512, arena=1024,
                  cap=2048, gen_arena=2048, vcap=1024, gen_levels=3,
                  max_depth=2)
    snap = eng.snapshot()
    queries = [JTuple.from_string(f"d:o{i}#finalize@u{i % 5}") for i in range(16)]
    enc = eng._encode(snap, queries, 0)
    qpack = np.stack([*enc, np.ones(len(queries), np.int32)]).astype(np.int32)
    sizes, fast_b, fast_sched, vcap = eng._gen_schedule(len(queries) // N, 1)
    kw = dict(sizes=sizes, fast_b=fast_b, fast_sched=fast_sched, vcap=vcap)
    g = {k: np.asarray(v) for k, v in eng._device_arrays.items()}
    jcodes, jocc = jshard_general_check(g, qpack, jmake_mesh(N), **kw)
    codes, occ = shard_general_check(g, qpack, _mesh(N), **kw)
    assert codes.dtype == torch.uint8 and occ.dtype == torch.int32
    assert np.array_equal(_np(codes), np.asarray(jcodes))
    assert _np(occ).shape == np.asarray(jocc).shape and _np(occ).shape[0] == N
    assert np.array_equal(_np(occ), np.asarray(jocc))
    want = np.array([eng.oracle.check_is_member(r) for r in queries])
    got, over = (_np(codes) & 3) == 1, ((_np(codes) >> 2) & 1) != 0
    assert np.array_equal(got[~over], want[~over]) and want.any() and not over.any()
