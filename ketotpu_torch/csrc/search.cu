// Lexicographic binary search over sorted key columns: the port of the JAX
// package's engine/xutil.py:43 lex_searchsorted.  Plain version:
// xutil._lex_searchsorted_plain (JAX's unrolled bit_length(N) + 1 steps in
// torch).
//
// keys: int32[n_keys, n], the columns sorted together in lex_sort order
// (column 0 most significant); queries: int32[n_keys, q].  Per query: the
// first index whose key is >= the query (its insertion point), and
// whether the key there equals it.  n == 0 gives 0 and false.
//
// Bound: bytes, but not the bytes of a roofline.  One thread per query
// walks the search: each step is a dependent gather of up to n_keys words
// at a midpoint that the previous step decides, so a query costs about
// log2(n) + 1 memory round trips in sequence.  The first steps' midpoints
// are shared by every query (one key slot at step 0, two at step 1, ...)
// and stay in L1/L2; only the last ~log2(q) steps spread over distinct
// slots.  Design: the query's columns live in registers (a fixed-size
// array, unrolled to kSearchMaxKeys), a step compares column by column
// and stops at the first difference, and the loop runs while lo < hi,
// which takes the midpoints of JAX's unrolled steps in the same order (its
// extra steps, once lo == hi, change nothing).  Every midpoint read is
// clamped to n - 1, as JAX clamps its gathers.
#include "common.cuh"

constexpr int kSearchMaxKeys = 8;  // xutil.MAX_SORT_KEYS

__global__ void lex_search(const int32_t* __restrict__ keys, int32_t n_keys,
                           int32_t n, const int32_t* __restrict__ queries,
                           int32_t q, int32_t* __restrict__ idx,
                           uint8_t* __restrict__ found) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    int32_t qv[kSearchMaxKeys];
#pragma unroll
    for (int k = 0; k < kSearchMaxKeys; ++k) {
        qv[k] = k < n_keys ? queries[(int64_t)k * q + i] : 0;
    }
    int32_t lo = 0, hi = n;
    while (lo < hi) {
        int32_t mid = (int32_t)(((int64_t)lo + hi) >> 1);
        int64_t at = mid < n - 1 ? mid : n - 1;
        bool less = false;  // key[mid] < query
#pragma unroll
        for (int k = 0; k < kSearchMaxKeys; ++k) {
            if (k < n_keys) {
                int32_t kv = keys[(int64_t)k * n + at];
                if (kv != qv[k]) {
                    less = kv < qv[k];
                    break;
                }
            }
        }
        if (less) lo = mid + 1; else hi = mid;
    }
    bool eq = lo < n;
    if (eq) {
#pragma unroll
        for (int k = 0; k < kSearchMaxKeys; ++k) {
            if (k < n_keys && keys[(int64_t)k * n + lo] != qv[k]) {
                eq = false;
                break;
            }
        }
    }
    idx[i] = lo;
    found[i] = eq ? 1 : 0;
}

// idx: int32[q]; found: bool[q] (one byte each).
KT_EXPORT int lex_searchsorted(const int32_t* keys, int32_t n_keys, int32_t n,
                               const int32_t* queries, int32_t q, int32_t* idx,
                               uint8_t* found, cudaStream_t stream) {
    if (n_keys < 1 || n_keys > kSearchMaxKeys || n < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (q <= 0) return (int)cudaGetLastError();
    const int threads = 256;
    lex_search<<<kt_blocks(q, threads), threads, 0, stream>>>(
        keys, n_keys, n, queries, q, idx, found);
    return (int)cudaGetLastError();
}
