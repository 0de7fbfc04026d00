"""Port parity: the host projection (the port's "weights").

The port's copy of ``build_snapshot_cols`` (and of everything it reads:
API types, OPL, stores, vocab, op tables, hash-table build) must project
byte-identical ``Snapshot.check_arrays()`` — key for key, dtype for dtype —
so both packages probe the same tables.  ``upload`` must carry either
package's arrays to torch unchanged.
"""

import numpy as np
import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine import delta as jdelta
from ketotpu.engine.tpu import DeviceCheckEngine as JEngine
from ketotpu.opl.ast import Namespace as JNamespace
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu.utils import synth as jsynth
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine import delta as tdelta
from ketotpu_torch.engine.device import DeviceCheckEngine as TEngine
from ketotpu_torch.engine.device import upload
from ketotpu_torch.opl.ast import Namespace as TNamespace
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from ketotpu_torch.utils import synth as tsynth
from torch_parity import (
    FIXTURES,
    REWRITES_TUPLES,
    SMALL_SYNTH,
    cat_videos_tuples,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)


def assert_same_arrays(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def _memory_case(case):
    """(jax store, jax manager, port store, port manager) of a fixture."""
    if case == "cat-videos":
        rows = cat_videos_tuples()
        jt = [JTuple.from_json(d) for d in rows]
        tt = [TTuple.from_json(d) for d in rows]
        jm = JManager([JNamespace(name="videos")])
        tm = TManager([TNamespace(name="videos")])
    else:
        src = (FIXTURES / "rewrites_namespaces.keto.ts").read_text()
        jns, jerr = jparse(src)
        tns, terr = tparse(src)
        assert not jerr and not terr
        jt = [JTuple.from_string(s) for s in REWRITES_TUPLES]
        tt = [TTuple.from_string(s) for s in REWRITES_TUPLES]
        jm, tm = JManager(jns), TManager(tns)
    js, ts = JStore(), TStore()
    js.write_relation_tuples(*jt)
    ts.write_relation_tuples(*tt)
    return js, jm, ts, tm


@pytest.mark.parametrize("case", ["cat-videos", "rewrites"])
def test_projection_matches_on_fixtures(case):
    from ketotpu.engine.vocab import Vocab as JVocab
    from ketotpu_torch.engine.vocab import Vocab as TVocab

    js, jm, ts, tm = _memory_case(case)
    jsnap = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_tuples(JVocab(), js.all_tuples()), jm
    )
    tsnap = tdelta.build_snapshot_cols(
        tdelta.TupleColumns.from_tuples(TVocab(), ts.all_tuples()), tm
    )
    assert_same_arrays(jsnap.check_arrays(), tsnap.check_arrays())
    assert np.array_equal(jsnap.taint, tsnap.taint)
    # the engines' own projections agree too
    jeng = JEngine(js, jm, leopard={"enabled": False})
    teng = TEngine(ts, tm, leopard={"enabled": False}, device="cpu")
    assert_same_arrays(jeng.snapshot().check_arrays(), teng.snapshot().check_arrays())


def test_projection_matches_on_small_synth():
    jg = jsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    tg = tsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    assert len(jg.store) == len(tg.store) == 10405

    def project(delta, g):
        cols, alive, _tail, _head = g.store.export_columns()
        return delta.build_snapshot_cols(
            delta.TupleColumns.from_arrays(g.store.vocab, cols, alive), g.manager
        )

    jsnap, tsnap = project(jdelta, jg), project(tdelta, tg)
    assert_same_arrays(jsnap.check_arrays(), tsnap.check_arrays())
    # the synth's op dims, which size the dedup key (K5b is not reached)
    assert jsnap.flat.css_rel.shape == (4, 16, 2)
    assert jsnap.flat.ttu_via.shape == (4, 16, 1)
    teng = TEngine(tg.store, tg.manager, device="cpu")
    assert_same_arrays(jsnap.check_arrays(), teng.snapshot().check_arrays())


def test_upload_carries_either_packages_arrays():
    js, jm, _ts, _tm = _memory_case("rewrites")
    from ketotpu.engine.vocab import Vocab as JVocab

    arrays = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_tuples(JVocab(), js.all_tuples()), jm
    ).check_arrays()
    g = upload(arrays, "cpu")
    assert list(g) == list(arrays)
    for k, v in arrays.items():
        t = g[k]
        assert t.device.type == "cpu"
        assert t.numpy().dtype == v.dtype and np.array_equal(t.numpy(), v), k
