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
    tfp.pack_verdicts(flags + 1, flags, out=out)
    assert out.tolist() == [1, 1, 1, 1]
    assert all(n == 0 for n in kernels.LAUNCHES.values())
