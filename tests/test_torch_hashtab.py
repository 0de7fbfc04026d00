"""Port parity: the table hash and the bucketed hash probe (K1).

``ketotpu_torch.engine.hashtab.mix`` / ``lookup`` (the plain PyTorch
versions of the probe the CUDA kernels inline) against the JAX package's
``_mix_np`` / ``mix_device`` / ``lookup`` on the same numpy inputs, at
tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ketotpu.engine import delta as jdelta
from ketotpu.engine import hashtab as jhash
from ketotpu.utils import synth as jsynth
from ketotpu_torch.engine import hashtab as thash
from torch_parity import (
    SMALL_SYNTH,
    release_jax_caches,  # noqa: F401 - autouse fixture
)

torch.set_num_threads(1)

# int32 corner values: the mix must wrap exactly as uint32 arithmetic
_EDGES = np.array(
    [0, 1, -1, 2**31 - 1, -(2**31), 0x85EBCA77 - 2**32, 12345, -7], np.int32
)


@pytest.mark.parametrize("salt_i", [0, 3, 7])
def test_mix_matches_numpy_and_jax(salt_i):
    rng = np.random.default_rng(salt_i)
    a = np.concatenate([_EDGES, rng.integers(-(2**31), 2**31, 4096, dtype=np.int64)
                        .astype(np.int32)])
    b = np.concatenate([_EDGES[::-1], rng.integers(-(2**31), 2**31, 4096,
                                                   dtype=np.int64).astype(np.int32)])
    salt = jhash._SALTS[salt_i]
    want = jhash._mix_np(a, b, salt).astype(np.int64)
    got = thash.mix(torch.from_numpy(a), torch.from_numpy(b), int(salt)).numpy()
    assert np.array_equal(got, want)
    dev = np.asarray(jhash.mix_device(jnp.asarray(a), jnp.asarray(b),
                                      jnp.uint32(salt))).astype(np.int64)
    assert np.array_equal(got, dev)


def _compare_lookup(tab_np, a, b):
    jt = {k: jnp.asarray(v) for k, v in tab_np.items()}
    jv, jf = jhash.lookup(jt, jnp.asarray(a), jnp.asarray(b))
    tt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab_np.items()}
    tv, tf = thash.lookup(tt, torch.from_numpy(a), torch.from_numpy(b))
    assert tv.dtype == torch.int32 and tf.dtype == torch.bool
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    hv, hf = jhash.lookup_np(tab_np, a, b)
    assert np.array_equal(tv.numpy(), hv) and np.array_equal(tf.numpy(), hf)
    return tf.numpy()


@pytest.mark.parametrize("with_val", [True, False])
def test_lookup_on_built_tables(with_val):
    rng = np.random.default_rng(11 + with_val)
    n = 100  # toy tables share the 128-bucket floor shape
    ka = rng.integers(0, 50, n).astype(np.int32)
    kb = rng.integers(0, 1000, n).astype(np.int32)
    keys = np.unique(np.stack([ka, kb], 1), axis=0)
    val = np.arange(len(keys), dtype=np.int32) * 3 if with_val else None
    tab = jhash.build_table(keys[:, 0], keys[:, 1], val)
    tab_t = thash.build_table(keys[:, 0], keys[:, 1], val)
    for k in tab:
        assert np.array_equal(tab[k], tab_t[k]) and tab[k].dtype == tab_t[k].dtype
    # present keys, absent keys, negative keys
    qa = np.concatenate([keys[:, 0], rng.integers(0, 60, 64), [-1, 3, -5]]).astype(np.int32)
    qb = np.concatenate([keys[:, 1], rng.integers(0, 1200, 64), [4, -1, -9]]).astype(np.int32)
    found = _compare_lookup(tab, qa, qb)
    assert found[: len(keys)].all() and not found[-3:].any()


def test_lookup_on_snapshot_tables():
    """The node and membership tables of a projected synth graph."""
    g = jsynth.build_synth_columnar(seed=0, **SMALL_SYNTH)
    cols, alive, _tail, _head = g.store.export_columns()
    snap = jdelta.build_snapshot_cols(
        jdelta.TupleColumns.from_arrays(g.store.vocab, cols, alive), g.manager
    )
    rng = np.random.default_rng(5)
    sel = rng.choice(snap.n_nodes, 512)
    found = _compare_lookup(
        snap.node_tab,
        np.concatenate([snap.node_hi[sel], snap.node_hi[sel] + 1]),
        np.concatenate([snap.node_lo[sel], snap.node_lo[sel]]),
    )
    assert found[:512].all()
    sel = rng.choice(snap.n_tuples, 512)
    found = _compare_lookup(
        snap.mem_tab,
        np.concatenate([snap.mem_node[sel], snap.mem_node[sel]]),
        np.concatenate([snap.mem_subj[sel], snap.mem_subj[sel] + 7]).astype(np.int32),
    )
    assert found[:512].all()
