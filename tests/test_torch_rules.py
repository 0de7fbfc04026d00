"""Rules of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless the caller asks for the CPU, and a
CUDA path never falls back to the plain versions."""

import ast
import pathlib

import pytest
import torch

from ketotpu_torch import kernels
from ketotpu_torch.engine import device as tdevice
from ketotpu_torch.engine import fastpath as tfp
from ketotpu_torch.engine import xutil as txutil

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port_sources():
    files = sorted((ROOT / "ketotpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "ketotpu" \
        or name.startswith("ketotpu.")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_ketotpu_imports(path):
    text = path.read_text()
    for needle in ("import jax", "from jax", "import ketotpu.", "from ketotpu.",
                   "from ketotpu import"):
        assert needle not in text, f"{path.name}: {needle!r}"
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path.name}: {names}"


def test_engine_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    import inspect

    sig = inspect.signature(tdevice.DeviceCheckEngine.__init__)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ketotpu_torch.storage.memory import InMemoryTupleStore

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.DeviceCheckEngine(InMemoryTupleStore())


def test_kernel_arguments_must_be_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.require(torch.zeros(4, dtype=torch.int32), torch.int32, "x")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "build_dir", lambda: tmp_path / "kt")
    monkeypatch.setattr(kernels.shutil, "which", lambda _name: None)
    monkeypatch.setattr(kernels, "_DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    counts = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    off, total, parent, ordinal = txutil.arena_assign(counts, 8)
    assert off.tolist() == [0, 2, 2, 5]
    assert int(total) == 6
    assert parent.tolist() == [0, 0, 2, 2, 2, 3, -1, -1]
    assert ordinal.tolist() == [0, 1, 0, 1, 2, 0, 0, 0]
    flags = torch.zeros(4, dtype=torch.int32)
    out = torch.empty(4, dtype=torch.uint8)
    tfp.pack_verdicts(flags + 1, flags, flags, out=out)
    assert out.tolist() == [1, 1, 1, 1]
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_general_program_on_cpu_launches_nothing():
    """The tier-2 wrappers take their plain versions for CPU tensors: a
    general batch through the engine on the CPU counts no launch."""
    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.opl.parser import parse
    from ketotpu_torch.storage.memory import InMemoryTupleStore
    from ketotpu_torch.storage.namespaces import StaticNamespaceManager
    from torch_parity import ALGEBRA_BATCHES, ALGEBRA_OPL, algebra_tuples

    namespaces, errs = parse(ALGEBRA_OPL)
    assert not errs, errs
    store = InMemoryTupleStore()
    store.write_relation_tuples(
        *[RelationTuple.from_string(s) for s in algebra_tuples()])
    eng = tdevice.DeviceCheckEngine(store, StaticNamespaceManager(namespaces),
                                    device="cpu")
    kernels.reset_launches()
    got = eng.batch_check(
        [RelationTuple.from_string(s) for s in ALGEBRA_BATCHES["andnot"]])
    assert any(got) and eng.general_rows > 0
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_fused_wave_and_leopard_on_cpu_launch_nothing(monkeypatch):
    """Tier 0 and the fused wave take their plain versions for CPU
    tensors: a fused engine with Leopard on, and the unfused one with the
    device probe of a chunk (any size probes), count no launch."""
    from ketotpu_torch.leopard import device as tleodev
    from ketotpu_torch.utils.synth import build_synth_columnar, synth_queries_mixed
    from torch_parity import SMALL_SYNTH

    g = build_synth_columnar(seed=0, **SMALL_SYNTH)
    rows = synth_queries_mixed(g, 300, seed=3)
    kernels.reset_launches()
    fused = tdevice.DeviceCheckEngine(g.store, g.manager, fused_dispatch=True,
                                      device="cpu")
    assert fused.batch_check(rows) and fused.fused_waves == 1
    unfused = tdevice.DeviceCheckEngine(g.store, g.manager, device="cpu")
    from ketotpu_torch.api.types import RelationTuple, SubjectID

    probes = [RelationTuple("Group", g.groups[i % len(g.groups)], "members",
                            SubjectID(g.users[i % len(g.users)]))
              for i in range(300)]
    probed = []
    real_probe = tleodev.probe
    monkeypatch.setattr(tleodev, "probe",
                        lambda *a: probed.append(a) or real_probe(*a))
    unfused.batch_check(probes)
    assert unfused.leopard_answered == len(probes) and len(probed) == 1
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_expand_on_cpu_launches_nothing_and_its_kernels_refuse_cpu_tables():
    """The Expand wrappers take their plain versions for CPU tensors only:
    a CPU engine's ``batch_expand`` counts no launch, and a tensor on any
    other device goes to the kernel, whose argument checks refuse CPU
    tables (no fallback to the plain version)."""
    from ketotpu_torch.api.types import SubjectSet
    from ketotpu_torch.engine import expand_device as txd
    from ketotpu_torch.utils.synth import build_synth

    g = build_synth(n_users=32, n_groups=4, n_folders=16, n_docs=64)
    eng = tdevice.DeviceCheckEngine(g.store, g.manager, device="cpu")
    kernels.reset_launches()
    trees = eng.batch_expand([SubjectSet("Group", "g0", "members")])
    assert trees[0] is not None and trees[0].children
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    tables = eng.expand_view()[1]
    roots = torch.empty((5, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        txd.expand_roots(tables, roots, 8)
    rec = torch.empty((7, 8), dtype=torch.int32, device="meta")
    cols = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        txd.expand_level(tables, rec, cols, rec[:1], cols, cols, cols,
                         over=cols)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_mesh_engine_defaults_to_the_cards_and_raises_without_them(monkeypatch):
    """The mesh engine's shards default to the first CUDA cards (no CPU
    default), and it raises when fewer cards exist than shards."""
    import inspect

    from ketotpu_torch.parallel import MeshCheckEngine, make_mesh
    from ketotpu_torch.storage.memory import InMemoryTupleStore

    assert inspect.signature(MeshCheckEngine.__init__).parameters[
        "devices"].default is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh(2).devices == (torch.device("cuda", 0),
                                    torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert make_mesh(4).devices == ()
    with pytest.raises(ValueError, match="only 0 devices"):
        MeshCheckEngine(InMemoryTupleStore(), mesh_devices=1)


def test_mesh_on_cpu_launches_nothing():
    """Both sharded tiers take their plain versions for CPU tensors: a
    general batch through a two-shard mesh on the CPU counts no launch."""
    from ketotpu_torch.api.types import RelationTuple
    from ketotpu_torch.opl.parser import parse
    from ketotpu_torch.parallel import MeshCheckEngine
    from ketotpu_torch.storage.memory import InMemoryTupleStore
    from ketotpu_torch.storage.namespaces import StaticNamespaceManager
    from torch_parity import ALGEBRA_BATCHES, ALGEBRA_OPL, algebra_tuples

    namespaces, errs = parse(ALGEBRA_OPL)
    assert not errs, errs
    store = InMemoryTupleStore()
    store.write_relation_tuples(
        *[RelationTuple.from_string(s) for s in algebra_tuples()])
    eng = MeshCheckEngine(store, StaticNamespaceManager(namespaces),
                          mesh_devices=2, devices=["cpu", "cpu"])
    kernels.reset_launches()
    rows = [RelationTuple.from_string(s)
            for s in ALGEBRA_BATCHES["andnot"] + ALGEBRA_BATCHES["visited"]]
    got = eng.batch_check(rows)
    assert any(got) and eng.general_rows > 0
    assert eng.shard_route_counts().sum() > 0
    assert all(n == 0 for n in kernels.LAUNCHES.values())
