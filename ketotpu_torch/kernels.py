"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``csrc/{probe,arena,children,pack}.cu`` (plus the shared
headers ``common.cuh`` and ``scan.cuh``).  Each ``.cu`` compiles with
``nvcc`` into its own shared library with a plain C interface, under
``build/ketotpu_torch/`` at the root of the checkout, named by a digest of
its sources and flags so a stale build is never loaded.  The libraries are
built on first use (all four ``nvcc`` processes run at once) and loaded
with ``ctypes``; pointers and the stream travel as ``c_void_p``.

The wrappers that launch the kernels live beside their plain PyTorch
versions (``engine/fastpath.py``, ``engine/xutil.py``).  Each wrapper adds
one to its entry of :data:`LAUNCHES` where it launches, and nowhere else.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
MODULES = ("probe", "arena", "children", "pack")
HEADERS = ("common.cuh", "scan.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: launches per wrapper: the main path's proof that it ran the kernels
LAUNCHES: Dict[str, int] = {
    "probe_level": 0,
    "arena_assign": 0,
    "expand_children": 0,
    "pack_scatter": 0,
    "init_state": 0,
    "pack_verdicts": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "build" / "ketotpu_torch"


_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(module: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (f"{module}.cu",) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"{module}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every kernel module (concurrently) that has no up-to-date
    build.  Returns the ``nvcc`` output per module compiled; raises with
    the compiler's output on failure."""
    todo = [m for m in MODULES if not _target(m).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for m in todo:
        out = _target(m)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{m}.cu")]
        procs[m] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {}
    failed = []
    for m, (p, tmp, out) in procs.items():
        logs[m] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(m)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + "\n"
            + "\n".join(logs[m] for m in failed)
        )
    return logs


# -- argument structs (csrc/common.cuh, field for field) ---------------------

_P = ctypes.c_void_p
_I = ctypes.c_int32


class HashTab(ctypes.Structure):
    _fields_ = [
        ("ptr", _P), ("key_a", _P), ("key_b", _P), ("val", _P), ("meta", _P),
        ("probe", _I), ("cap", _I),
    ]


class Graph(ctypes.Structure):
    _fields_ = [
        ("nt", HashTab), ("mt", HashTab),
        ("direct_ok", _P), ("expand_ok", _P),
        ("css_rel", _P), ("css_dec", _P), ("css_probe", _P),
        ("ttu_via", _P), ("ttu_tgt", _P), ("ttu_dec", _P),
        ("row_ptr", _P), ("edge_hi", _P), ("edge_obj", _P),
        ("ns_dim", _I), ("rel_dim", _I), ("kc", _I), ("kt", _I),
        ("n_row_ptr", _I), ("n_edges", _I),
    ]


class Items(ctypes.Structure):
    _fields_ = [
        ("qid", _P), ("ns", _P), ("obj", _P), ("rel", _P), ("d", _P),
        ("skip", _P), ("force", _P), ("n", _I),
    ]


_SIGNATURES = {
    "probe": {
        "probe_level": [Graph, Items, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                        _I, _P],
    },
    "arena": {
        "arena_assign": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    },
    "children": {
        "expand_children": [Graph, Items, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, Items, _P],
    },
    "pack": {
        "pack_scatter": [Items, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, Items, _P, _P],
        "init_state": [_P, _I, _I, Items, _P, _P, _P, _P],
        "pack_verdicts": [_P, _P, _I, _P, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def lib(module: str) -> ctypes.CDLL:
    """The loaded library of one kernel module (all four are built on the
    first call)."""
    with _lock:
        if not _libs:
            build()
            for m in MODULES:
                so = ctypes.CDLL(str(_target(m)))
                for fn, args in _SIGNATURES[m].items():
                    f = getattr(so, fn)
                    f.argtypes = args
                    f.restype = ctypes.c_int
                so.kt_error_string.argtypes = [ctypes.c_int]
                so.kt_error_string.restype = ctypes.c_char_p
                _libs[m] = so
        return _libs[module]


def launch(module: str, fn: str, *args) -> None:
    """Call one C entry point; raise on the cudaGetLastError it returns."""
    so = lib(module)
    rc = getattr(so, fn)(*args)
    if rc != 0:
        msg = so.kt_error_string(rc).decode()
        raise RuntimeError(f"{module}.{fn}: CUDA error {rc}: {msg}")


# -- argument helpers ---------------------------------------------------------


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, dtype: torch.dtype, name: str, *,
            shape=None, device=None) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` where given)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    return t


def _hash_tab(g, prefix: str, device, with_val: bool) -> HashTab:
    cap = g[prefix + "key_a"].shape[0]
    return HashTab(
        ptr=ptr(require(g[prefix + "ptr"], torch.int32, prefix + "ptr",
                        device=device)),
        key_a=ptr(require(g[prefix + "key_a"], torch.int32, prefix + "key_a",
                          device=device)),
        key_b=ptr(require(g[prefix + "key_b"], torch.int32, prefix + "key_b",
                          shape=(cap,), device=device)),
        val=ptr(require(g[prefix + "val"], torch.int32, prefix + "val",
                        shape=(cap,), device=device)) if with_val else None,
        meta=ptr(require(g[prefix + "meta"], torch.int32, prefix + "meta",
                         shape=(2,), device=device)),
        probe=g[prefix + "pw"].shape[0],
        cap=cap,
    )


class DeviceTables(dict):
    """The snapshot's check arrays on the device (``Snapshot.check_arrays``
    names), caching the kernels' validated :class:`Graph` view so a level
    does not rebuild it per launch.  Treat it as read-only once built."""

    _graph: Optional[Graph] = None


def graph(g: Dict[str, torch.Tensor]) -> Graph:
    """The kernels' view of the uploaded snapshot tables (validated; cached
    on a :class:`DeviceTables`)."""
    cached = getattr(g, "_graph", None)
    if cached is not None:
        return cached
    out = _graph(g)
    if isinstance(g, DeviceTables):
        g._graph = out
    return out


def _graph(g: Dict[str, torch.Tensor]) -> Graph:
    device = g["row_ptr"].device
    ns_dim, rel_dim = g["f_direct_ok"].shape
    kc = g["f_css_rel"].shape[2]
    kt = g["f_ttu_via"].shape[2]

    def t(name, dtype, shape):
        return ptr(require(g[name], dtype, name, shape=shape, device=device))

    return Graph(
        nt=_hash_tab(g, "nt_", device, True),
        mt=_hash_tab(g, "mt_", device, False),
        direct_ok=t("f_direct_ok", torch.bool, (ns_dim, rel_dim)),
        expand_ok=t("f_expand_ok", torch.bool, (ns_dim, rel_dim)),
        css_rel=t("f_css_rel", torch.int32, (ns_dim, rel_dim, kc)),
        css_dec=t("f_css_dec", torch.int32, (ns_dim, rel_dim, kc)),
        css_probe=t("f_css_probe", torch.bool, (ns_dim, rel_dim, kc)),
        ttu_via=t("f_ttu_via", torch.int32, (ns_dim, rel_dim, kt)),
        ttu_tgt=t("f_ttu_tgt", torch.int32, (ns_dim, rel_dim, kt)),
        ttu_dec=t("f_ttu_dec", torch.int32, (ns_dim, rel_dim, kt)),
        row_ptr=t("row_ptr", torch.int32, None),
        edge_hi=t("edge_hi", torch.int32, None),
        edge_obj=t("edge_obj", torch.int32, g["edge_hi"].shape),
        ns_dim=ns_dim, rel_dim=rel_dim, kc=kc, kt=kt,
        n_row_ptr=g["row_ptr"].shape[0], n_edges=g["edge_hi"].shape[0],
    )


def items(cols, device=None) -> Items:
    """The kernels' view of a frontier / children column set (validated)."""
    n = cols.qid.shape[0]
    device = device if device is not None else cols.qid.device

    def c(name, dtype):
        return ptr(require(getattr(cols, name), dtype, name, shape=(n,),
                           device=device))

    return Items(
        qid=c("qid", torch.int32), ns=c("ns", torch.int32),
        obj=c("obj", torch.int32), rel=c("rel", torch.int32),
        d=c("d", torch.int32), skip=c("skip", torch.bool),
        force=c("force", torch.bool), n=n,
    )
