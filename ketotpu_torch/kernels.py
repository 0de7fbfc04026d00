"""Build, load and count the port's hand-written CUDA kernels.

The sources are
``csrc/{probe,arena,children,pack,algebra,leopard,wave,expand,shard,sort,search}.cu``
(plus the shared headers ``common.cuh``, ``scan.cuh``, ``leopard.cuh`` and
``sort.cuh``).
Each ``.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, under
``build/ketotpu_torch/`` at the root of the checkout, named by a digest of
its sources and flags so a stale build is never loaded.  The libraries are
built on first use (all ``nvcc`` processes run at once) and loaded
with ``ctypes``; pointers and the stream travel as ``c_void_p``.

The wrappers that launch the kernels live beside their plain PyTorch
versions (``engine/fastpath.py``, ``engine/xutil.py``,
``engine/algebra.py``, ``leopard/device.py``, ``engine/fused.py``,
``engine/expand_device.py``, ``parallel/graphshard.py``).  Each
wrapper adds one to its entry of :data:`LAUNCHES` where it launches, and
nowhere else.
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
MODULES = ("probe", "arena", "children", "pack", "algebra", "leopard", "wave",
           "expand", "shard", "sort", "search")
HEADERS = ("common.cuh", "scan.cuh", "leopard.cuh", "sort.cuh")
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
    "pack_sort": 0,
    "lex_sort": 0,
    "lex_searchsorted": 0,
    "init_state": 0,
    "pack_verdicts": 0,
    "gen_classify": 0,
    "gen_construct": 0,
    "gen_visited": 0,
    "gen_collect": 0,
    "gen_up": 0,
    "gen_pack": 0,
    "leo_probe": 0,
    "wave_tier0": 0,
    "wave_lane": 0,
    "wave_gen_lane": 0,
    "wave_pack": 0,
    "expand_roots": 0,
    "expand_level": 0,
    "shard_owner": 0,
    "shard_route": 0,
    "shard_merge": 0,
    "shard_merge_classified": 0,
    "shard_merge_child": 0,
}

#: the largest visited set: its claim array fills the one block's shared
#: memory (csrc/algebra.cu kVisitedSmemSlots)
VISITED_SMEM_SLOTS = 32768


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
_L = ctypes.c_int64


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
        ("om", HashTab), ("ovt", HashTab), ("ov_dirty", _P), ("ov_nbase", _P),
        ("n_dirty", _I), ("has_ov", _I),
    ]


class Items(ctypes.Structure):
    _fields_ = [
        ("qid", _P), ("ns", _P), ("obj", _P), ("rel", _P), ("d", _P),
        ("skip", _P), ("force", _P), ("n", _I),
    ]


class Prog(ctypes.Structure):
    _fields_ = [
        ("p_kind", _P), ("p_a", _P), ("p_b", _P), ("p_child_ptr", _P),
        ("p_child_idx", _P), ("p_child_dec", _P), ("p_child_neg", _P),
        ("b_ptr", _P), ("b_rel", _P), ("b_probe", _P), ("prog_root", _P),
        ("rel_err", _P), ("err_reach", _P), ("taint", _P),
        ("n_prog", _I), ("n_child", _I), ("n_bptr", _I), ("n_brel", _I),
    ]


class GenState(ctypes.Structure):
    _fields_ = [
        ("tasks", _P), ("aux", _P), ("cnt", _P), ("vset", _P),
        ("q_over", _P), ("q_dirty", _P), ("leaves", Items), ("leaf_subj", _P),
        ("codes", _P), ("occ", _P),
        ("total", _I), ("vs", _I), ("q", _I), ("depth", _I), ("n_sched", _I),
    ]


class MergeState(ctypes.Structure):
    _fields_ = [
        ("tasks", _P), ("aux", _P), ("q_over", _P), ("q_dirty", _P),
        ("total", _I), ("q", _I),
    ]


class XTab(ctypes.Structure):
    _fields_ = [
        ("mem_row_ptr", _P), ("mem_ord_subj", _P), ("sub_ns", _P),
        ("sub_obj", _P), ("sub_rel", _P),
        ("n_mem_ptr", _I), ("n_mem", _I), ("n_sub", _I),
    ]


_SIGNATURES = {
    "probe": {
        "probe_level": [Graph, Items, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                        _P, _I, _P],
    },
    "arena": {
        "arena_assign": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    },
    "children": {
        "expand_children": [Graph, Items, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, Items, _P],
    },
    "pack": {
        "pack_scatter": [Items, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, Items, _P, _P],
        "pack_scatter_rows": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, Items, _P, _P],
        "pack_sort_keys": [Items, _P, _I, _P, _P, _P],
        "pack_sort_keys_rows": [_P, _I, _P, _I, _P, _P, _P],
        "pack_sort": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                      Items, _P, _P],
        "init_state": [_P, _P, _P, _I, _I, _I, Items, _P, _P, _P, _P],
        "pack_verdicts": [_P, _P, _P, _I, _P, _P],
    },
    "algebra": {
        "gen_classify": [Graph, Prog, GenState, _I, _I, _I, _P, _P, _P, _I, _I,
                         _P],
        "gen_construct": [Graph, Prog, GenState, _I, _I, _I, _I, _P, _P, _P,
                          _I, _P, _I, _P],
        "gen_visited": [GenState, _I, _I, _P, _P],
        "gen_collect": [GenState, _P, _P, _P, _P, _P, _I, _I, _P],
        "gen_up": [GenState, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "gen_pack": [GenState, _P],
    },
    "leopard": {
        "leo_probe": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P],
    },
    "wave": {
        "wave_tier0": [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
        "wave_lane": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                      _P],
        "wave_gen_lane": [_P, _P, _I, _P, _P, _P, _P],
        "wave_pack": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P],
    },
    "expand": {
        "expand_roots": [Graph, XTab, _P, _I, _I, _P, _P, _P, _P],
        "expand_level": [Graph, XTab, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P,
                         _I, _P, _P, _P, _P],
    },
    "shard": {
        "shard_owner": [_P, _P, _I, _I, _P, _P],
        "shard_route": [Items, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
        "shard_merge": [_P, _I, _I, _P, _P],
        "shard_merge_classified": [_P, _P, _P, _I, _I, MergeState, _P, _I, _I,
                                   _P],
        "shard_merge_child": [_P, _P, _I, _I, _I, MergeState, _P],
    },
    "sort": {
        "lex_sort": [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _L, _P],
    },
    "search": {
        "lex_searchsorted": [_P, _I, _I, _P, _I, _P, _P, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def lib(module: str) -> ctypes.CDLL:
    """The loaded library of one kernel module (all are built on the first
    call)."""
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
    _prog: Optional[Prog] = None
    _xtab: Optional["XTab"] = None
    #: copies on other devices (``parallel.mesh.replicate``)
    _replicas: Optional[dict] = None


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

    overlay = {}
    if "om_ptr" in g:
        # the delta overlay (delta.overlay_arrays): the engine ships it with
        # every projection, empty until the first write
        n_dirty = g["ov_dirty"].shape[0]
        overlay = dict(
            om=_hash_tab(g, "om_", device, True),
            ovt=_hash_tab(g, "ovt_", device, True),
            ov_dirty=t("ov_dirty", torch.bool, (n_dirty,)),
            ov_nbase=t("ov_nbase", torch.int32, (1,)),
            n_dirty=n_dirty, has_ov=1,
        )
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
        **overlay,
    )


def merge_state(st) -> MergeState:
    """The shard merges' view of an ``algebra.GenState``: its task and aux
    columns and its over / dirty bits (validated by :func:`gen_state`)."""
    cv = gen_state(st)
    return MergeState(tasks=cv.tasks, aux=cv.aux, q_over=cv.q_over,
                      q_dirty=cv.q_dirty, total=cv.total, q=cv.q)


def xtab(g: Dict[str, torch.Tensor]) -> XTab:
    """The Expand kernels' view of the expand-only tables
    (``snapshot.EXPAND_ONLY_KEYS``; validated; cached on a
    :class:`DeviceTables`)."""
    cached = getattr(g, "_xtab", None)
    if cached is not None:
        return cached
    device = g["row_ptr"].device
    n_sub = g["sub_ns"].shape[0]

    def t(name, shape=None):
        return ptr(require(g[name], torch.int32, name, shape=shape,
                           device=device))

    out = XTab(
        mem_row_ptr=t("mem_row_ptr"), mem_ord_subj=t("mem_ord_subj"),
        sub_ns=t("sub_ns"), sub_obj=t("sub_obj", (n_sub,)),
        sub_rel=t("sub_rel", (n_sub,)),
        n_mem_ptr=g["mem_row_ptr"].shape[0],
        n_mem=g["mem_ord_subj"].shape[0], n_sub=n_sub,
    )
    if isinstance(g, DeviceTables):
        g._xtab = out
    return out


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


def prog(g: Dict[str, torch.Tensor]) -> Prog:
    """The algebra kernels' view of the rewrite-program and routing tables
    (validated; cached on a :class:`DeviceTables`)."""
    cached = getattr(g, "_prog", None)
    if cached is not None:
        return cached
    device = g["row_ptr"].device
    ns_dim, rel_dim = g["f_direct_ok"].shape

    def t(name, dtype, shape=None):
        return ptr(require(g[name], dtype, name, shape=shape, device=device))

    n_prog = g["p_kind"].shape[0]
    n_child = g["p_child_idx"].shape[0]
    n_brel = g["b_rel"].shape[0]
    out = Prog(
        p_kind=t("p_kind", torch.int32),
        p_a=t("p_a", torch.int32, (n_prog,)),
        p_b=t("p_b", torch.int32, (n_prog,)),
        p_child_ptr=t("p_child_ptr", torch.int32, (n_prog + 1,)),
        p_child_idx=t("p_child_idx", torch.int32),
        p_child_dec=t("p_child_dec", torch.int32, (n_child,)),
        p_child_neg=t("p_child_neg", torch.bool, (n_child,)),
        b_ptr=t("b_ptr", torch.int32),
        b_rel=t("b_rel", torch.int32),
        b_probe=t("b_probe", torch.bool, (n_brel,)),
        prog_root=t("prog_root", torch.int32, (ns_dim, rel_dim)),
        rel_err=t("rel_err", torch.bool, (ns_dim, rel_dim)),
        err_reach=t("err_reach", torch.bool, (ns_dim, rel_dim)),
        taint=t("taint", torch.bool, (ns_dim, rel_dim)),
        n_prog=n_prog, n_child=n_child, n_bptr=g["b_ptr"].shape[0],
        n_brel=n_brel,
    )
    if isinstance(g, DeviceTables):
        g._prog = out
    return out


def gen_state(st) -> GenState:
    """The algebra kernels' view of an ``algebra.GenState`` (validated once;
    the state's tensors are never reallocated, so the view is cached on
    it)."""
    cached = getattr(st, "_cview", None)
    if cached is not None:
        return cached
    device = st.tasks.device
    tot = st.tasks.shape[1]
    vs = st.vset.shape[1]
    b = st.leaves.qid.shape[0]
    occ_off = -(-st.q // 4) * 4
    n_occ = st.depth + 2 + st.n_sched
    require(st.out, torch.uint8, "out", shape=(occ_off + 4 * n_occ,),
            device=device)
    out = GenState(
        tasks=ptr(require(st.tasks, torch.int32, "tasks", device=device)),
        aux=ptr(require(st.aux, torch.int32, "aux", shape=(st.aux.shape[0], tot),
                        device=device)),
        cnt=ptr(require(st.cnt, torch.int32, "cnt", shape=(3, tot),
                        device=device)),
        vset=ptr(require(st.vset, torch.int32, "vset", shape=(4, vs),
                         device=device)),
        q_over=ptr(require(st.q_over, torch.int32, "q_over", shape=(st.q,),
                           device=device)),
        q_dirty=ptr(require(st.q_dirty, torch.int32, "q_dirty", shape=(st.q,),
                            device=device)),
        leaves=items(st.leaves, device),
        leaf_subj=ptr(require(st.leaf_subj, torch.int32, "leaf_subj",
                              shape=(b,), device=device)),
        codes=st.out.data_ptr(), occ=st.out.data_ptr() + occ_off,
        total=tot, vs=vs, q=st.q, depth=st.depth, n_sched=st.n_sched,
    )
    if vs & (vs - 1):
        raise ValueError(f"visited set of {vs} slots: not a power of two")
    st._cview = out
    return out
