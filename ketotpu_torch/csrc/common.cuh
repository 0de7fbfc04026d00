// Shared device code of the tier-1 BFS kernels: the argument structs the
// ctypes wrappers fill (ketotpu_torch/kernels.py mirrors their layout field
// for field), the 32-bit table hash, the bucketed hash probe, and the
// count of a kernel's blocks the card holds at once (resident_blocks).
//
// Replaces, as inlined device functions, the JAX package's
// engine/hashtab.py:81 mix_device and :445 lookup (K1) and
// engine/fastpath.py:114 _node_lookup, :134 _member, :149 _node_dirty,
// :157 _row_deg (K2), with the delta overlay's branches: virtual node ids
// through the ovt_ table, membership as base OR added AND NOT deleted
// through om_, the ov_dirty bitset, and the zeroed rows of dirty and
// virtual nodes (fastpath.py:282-288, :305-308; algebra.py:129
// _deg_guarded).
// Every load here is a dependent random gather into a table far larger
// than L2 at the 10M-tuple scale, so each probe costs one DRAM round trip
// per round; the probe loop stops at the first hit and issues the payload
// gather once, at the matched slot.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// One bucket-CSR hash table (hashtab.build_table's device half).
struct HashTab {
    const int32_t* ptr;    // [buckets + 1]
    const int32_t* key_a;  // [cap]
    const int32_t* key_b;  // [cap]
    const int32_t* val;    // [cap] payload, or nullptr: return the slot
    const int32_t* meta;   // [2] = (salt index, bucket mask), on the device
    int32_t probe;         // rounds = the table's pw length
    int32_t cap;
};

// The device snapshot tables the pure-OR BFS reads (Snapshot.check_arrays
// names in the comments), and the delta overlay over them
// (delta.overlay_arrays names; has_ov == 0 when the tables carry none).
struct Graph {
    HashTab nt;                 // nt_*: (ns * R + rel, obj) -> node id
    HashTab mt;                 // mt_*: (node, subject) membership set
    const uint8_t* direct_ok;   // f_direct_ok [NS, R]
    const uint8_t* expand_ok;   // f_expand_ok [NS, R]
    const int32_t* css_rel;     // f_css_rel [NS, R, Kc]
    const int32_t* css_dec;     // f_css_dec [NS, R, Kc]
    const uint8_t* css_probe;   // f_css_probe [NS, R, Kc]
    const int32_t* ttu_via;     // f_ttu_via [NS, R, Kt]
    const int32_t* ttu_tgt;     // f_ttu_tgt [NS, R, Kt]
    const int32_t* ttu_dec;     // f_ttu_dec [NS, R, Kt]
    const int32_t* row_ptr;     // [n_rows + 1] subject-set CSR
    const int32_t* edge_hi;     // [n_edges] ns * R + rel of the edge target
    const int32_t* edge_obj;    // [n_edges]
    int32_t ns_dim, rel_dim, kc, kt;
    int32_t n_row_ptr, n_edges;
    HashTab om;                 // om_*: (node, subject) -> OV_ADDED / OV_DELETED
    HashTab ovt;                // ovt_*: (ns * R + rel, obj) -> virtual node id
    const uint8_t* ov_dirty;    // [n_dirty] edge list changed since the base
    const int32_t* ov_nbase;    // [1] base node count: ids >= it are virtual
    int32_t n_dirty, has_ov;
};

// delta.py OV_ADDED / OV_DELETED: the om_ table's payload codes
#define OV_ADDED 1
#define OV_DELETED 2

// One frontier (or arena of children): seven columns of equal length.
struct Items {
    int32_t* qid;
    int32_t* ns;
    int32_t* obj;
    int32_t* rel;
    int32_t* d;
    uint8_t* skip;
    uint8_t* force;
    int32_t n;
};

__constant__ static const uint32_t kSalts[8] = {
    0x243F6A88u, 0x85A308D3u, 0x13198A2Eu, 0x03707344u,
    0xA4093822u, 0x299F31D0u, 0x082EFA98u, 0xEC4E6C89u,
};

__device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// hashtab._mix_np in uint32 arithmetic (wraps exactly as numpy's uint32).
__device__ __forceinline__ uint32_t mix32(int32_t a, int32_t b, uint32_t salt) {
    uint32_t h = ((uint32_t)a ^ ((uint32_t)b * 0x85EBCA77u)) * 0x9E3779B1u + salt;
    h ^= h >> 16;
    h *= 0xC2B2AE3Du;
    h ^= h >> 13;
    return h;
}

// The graph-sharded mesh's partition (engine/hashtab.py shard_of,
// parallel/graphshard.py shard_of_np): the owner shard of a (namespace,
// object), mix32 with salt 0, % n.
__device__ __forceinline__ int32_t shard_of(int32_t ns, int32_t obj,
                                            int32_t n_shards) {
    return (int32_t)(mix32(ns, obj, kSalts[0]) % (uint32_t)n_shards);
}

// hashtab.lookup: payload (or slot) of the first match, found flag.
// Probing past a bucket's end is safe: an entry of another bucket never
// equals the query key.  Negative keys never match.
__device__ __forceinline__ int32_t tab_lookup(const HashTab& t, int32_t a,
                                              int32_t b, bool* found) {
    int32_t salt_i = clampi(t.meta[0], 0, 7);
    uint32_t mask = (uint32_t)t.meta[1];
    uint32_t h = mix32(a, b, kSalts[salt_i]) & mask;
    int32_t base = t.ptr[h];
    bool ok = (a >= 0) & (b >= 0);
    int32_t hit_j = -1;
    if (ok) {
        for (int32_t i = 0; i < t.probe; ++i) {
            int32_t j = clampi(base + i, 0, t.cap - 1);
            if (t.key_a[j] == a && t.key_b[j] == b) {
                hit_j = j;
                break;
            }
        }
    }
    *found = hit_j >= 0;
    if (hit_j < 0) return -1;
    return t.val != nullptr ? t.val[hit_j] : hit_j;
}

// fastpath._node_lookup: (ns, obj, rel) -> node id or -1; a node the base
// lacks resolves to its virtual id through the overlay's ovt_ table (the
// JAX select keeps the base id otherwise, so the probe is skipped there).
__device__ __forceinline__ int32_t node_lookup(const Graph& g, int32_t ns,
                                               int32_t obj, int32_t rel) {
    bool ok = (ns >= 0) & (obj >= 0) & (rel >= 0);
    int32_t hi = ns * g.rel_dim + rel;
    bool found;
    int32_t v = tab_lookup(g.nt, hi, obj, &found);
    found = found && ok;
    int32_t res = found ? v : -1;
    if (g.has_ov && ok && !found) {
        bool vfound;
        int32_t vid = tab_lookup(g.ovt, hi, obj, &vfound);
        if (vfound) res = vid;
    }
    return res;
}

// fastpath._member: does tuple (node, subject) exist?  Overlay-exact: base
// OR added since the base AND NOT deleted since it.
__device__ __forceinline__ bool member(const Graph& g, int32_t node,
                                       int32_t subj) {
    bool found;
    tab_lookup(g.mt, node, subj, &found);
    if (g.has_ov) {
        bool vf;
        int32_t v = tab_lookup(g.om, node, subj, &vf);
        found = (found || (vf && v == OV_ADDED)) && !(vf && v == OV_DELETED);
    }
    return found;
}

// fastpath._node_dirty: did the node's subject-set edge list change since
// the base?  The read clamps into the bitset as the JAX gather does.
__device__ __forceinline__ bool node_dirty(const Graph& g, int32_t node) {
    if (!g.has_ov || node < 0) return false;
    return g.ov_dirty[clampi(node, 0, g.n_dirty - 1)] != 0;
}

// fastpath._row_deg: subject-set CSR row degree, 0 for node < 0.
__device__ __forceinline__ int32_t row_deg(const Graph& g, int32_t node) {
    int32_t safe = clampi(node, 0, g.n_row_ptr - 2);
    int32_t deg = g.row_ptr[safe + 1] - g.row_ptr[safe];
    return node >= 0 ? deg : 0;
}

// The row degree with the overlay's rows zeroed (fastpath._overlay_deg,
// algebra._deg_guarded): a dirty row's base edges are stale and a virtual
// node has no base row.  *dirty receives node_dirty.
__device__ __forceinline__ int32_t row_deg_ov(const Graph& g, int32_t node,
                                              bool* dirty) {
    int32_t deg = row_deg(g, node);
    *dirty = node_dirty(g, node);
    if (g.has_ov && (*dirty || node >= *g.ov_nbase)) deg = 0;
    return deg;
}

// Each entry point returns cudaGetLastError() after its launches, so the
// wrapper raises on a refused launch.
#define KT_EXPORT extern "C" __attribute__((visibility("default")))

KT_EXPORT const char* kt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Blocks of `kernel` (threads a block, no dynamic shared memory) that the
// current device holds at once, cached per device in cache[64]; 0 where
// the runtime cannot tell.  A grid no larger than this has every block
// running at once, so a block may wait on any other (decoupled look-back).
static inline int resident_blocks(const void* kernel, int threads, int* cache) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (cache[dev] == 0) {
        int per_sm = 0, sms = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) !=
                cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            return 0;
        }
        cache[dev] = per_sm * sms;
    }
    return cache[dev];
}

static inline int kt_blocks(int64_t n, int threads) {
    int64_t b = (n + threads - 1) / threads;
    return (int)(b < 1 ? 1 : b);
}
