// Stable LSD radix sort of N rows by K int32 key columns, shared by sort.cu
// (xutil.lex_sort) and pack.cu (the sort-based frontier pack,
// fastpath._pack_sort).
//
// Replaces the sort of the JAX package's engine/xutil.py:81 lex_sort and of
// engine/fastpath.py:515 _pack_sort: jax.lax.sort(keys + payload,
// num_keys=K).  lax.sort is not stable; this sort is, which is one of the
// orders lax.sort may return (equal keys in row order).
//
// Bound: bytes.  Each digit pass reads the permutation and gathers one key
// column through it (the column, 4N bytes, stays in L2 at the arena sizes
// the pack sorts), then writes the permutation; the least any sort can move
// is every key and payload column read once and written once in sorted
// order.  Design: 8-bit digits, least significant key first and, within a
// key, least significant digit first.  The sort carries only a
// permutation (int32[N]); the keys and payload are gathered through it
// once at the end.  A key column with a bit width below 32 promises
// 0 <= key < 2^bits, so only its ceil(bits / 8) low digits are passed over
// (a caller that knows its keys' range skips dead passes); at 32 bits the
// sign bit is flipped first so that negative keys sort first, as lax.sort
// orders int32.
//
// One digit pass is three steps, each a launch boundary (a grid-wide
// barrier): a per-tile histogram of the digit in shared memory; an
// exclusive scan of the (digit, tile) counts, digit-major, with
// csrc/scan.cuh (three launches); and a stable scatter in which each tile
// ranks its rows among equal digits in row order: 256 rows at a time, a
// warp's equal digits found with __match_any_sync, the warps' counts
// scanned per digit in shared memory.
#pragma once

#include "scan.cuh"

constexpr int kSortThreads = 256;  // one thread per digit value in a pass
constexpr int kSortTile = 1024;    // rows per tile (block) of a pass
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortMaxKeys = 8;

__device__ __forceinline__ uint32_t sort_digit(int32_t key, int32_t shift,
                                               uint32_t flip) {
    return (((uint32_t)key ^ flip) >> shift) & 0xFFu;
}

// Row i of the current order: perm[i], or i before the first pass.
__device__ __forceinline__ int32_t sort_row(const int32_t* perm, int64_t i) {
    return perm != nullptr ? perm[i] : (int32_t)i;
}

// counts[d * n_tiles + tile] = rows of the tile whose digit is d.
__global__ void radix_hist(const int32_t* __restrict__ key,
                           const int32_t* __restrict__ perm, int32_t n,
                           int32_t n_tiles, int32_t shift, uint32_t flip,
                           int32_t* __restrict__ counts) {
    __shared__ int32_t hist[256];
    hist[threadIdx.x] = 0;
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * kSortTile;
    for (int k = threadIdx.x; k < kSortTile; k += kSortThreads) {
        int64_t i = base + k;
        if (i < n) atomicAdd(&hist[sort_digit(key[sort_row(perm, i)], shift, flip)], 1);
    }
    __syncthreads();
    counts[(int64_t)threadIdx.x * n_tiles + blockIdx.x] = hist[threadIdx.x];
}

// Stable scatter: row i of the tile goes to offsets[d * n_tiles + tile]
// plus the number of the tile's rows before it with the same digit d.
__global__ void radix_scatter(const int32_t* __restrict__ key,
                              const int32_t* __restrict__ perm_in, int32_t n,
                              int32_t n_tiles, int32_t shift, uint32_t flip,
                              const int32_t* __restrict__ offsets,
                              int32_t* __restrict__ perm_out) {
    __shared__ int32_t warp_base[kSortWarps][256];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    // thread t keeps digit t's next free position in the tile's range
    int32_t run = offsets[(int64_t)threadIdx.x * n_tiles + blockIdx.x];
    const int64_t base = (int64_t)blockIdx.x * kSortTile;
    for (int c = 0; c < kSortTile; c += kSortThreads) {
        for (int w = 0; w < kSortWarps; ++w) warp_base[w][threadIdx.x] = 0;
        __syncthreads();
        const int64_t i = base + c + threadIdx.x;
        const bool in = i < n;
        int32_t r = 0;
        uint32_t d = 256;  // rows past the end form their own group
        if (in) {
            r = sort_row(perm_in, i);
            d = sort_digit(key[r], shift, flip);
        }
        const uint32_t peers = __match_any_sync(0xffffffffu, d);
        const uint32_t before = peers & ((1u << lane) - 1u);
        if (in && before == 0) warp_base[wid][d] = __popc(peers);
        __syncthreads();
        // per digit: the warps' counts -> their first positions, in warp
        // (= row) order
        for (int w = 0; w < kSortWarps; ++w) {
            int32_t cnt = warp_base[w][threadIdx.x];
            warp_base[w][threadIdx.x] = run;
            run += cnt;
        }
        __syncthreads();
        if (in) perm_out[warp_base[wid][d] + __popc(before)] = r;
        __syncthreads();  // warp_base is cleared for the next 256 rows
    }
}

// dst[j, i] = src[j, perm[i]] for each of `rows` columns of n.
__global__ void radix_gather(const int32_t* __restrict__ src, int32_t rows,
                             int32_t n, const int32_t* __restrict__ perm,
                             int32_t* __restrict__ dst) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)rows * n) return;
    int64_t j = t / n, i = t % n;
    dst[t] = src[j * n + sort_row(perm, i)];
}

static inline int32_t sort_tiles(int32_t n) { return kt_blocks(n, kSortTile); }

// Scratch of a sort of n rows (int32): two permutations [n each], the
// (digit, tile) counts [256 * sort_tiles(n)], the scan's total [1] and
// block sums [ceil(256 * sort_tiles(n) / kScanTile)].
struct SortScratch {
    int32_t* perm_a;
    int32_t* perm_b;
    int32_t* counts;
    int32_t* total;
    int32_t* block_sums;
};

// Enqueue every digit pass over the n-row key block keys[n_keys, n]
// (column k at keys + k * n, column 0 the most significant; bits: host
// array of n_keys widths).  Returns the sorted order as a permutation on
// the device, or nullptr when no pass ran (the identity).
static const int32_t* enqueue_radix_sort(const int32_t* keys, int32_t n_keys,
                                         const int32_t* bits, int32_t n,
                                         SortScratch s, cudaStream_t stream) {
    const int32_t* cur = nullptr;
    if (n <= 0) return cur;
    const int32_t n_tiles = sort_tiles(n);
    int32_t* bufs[2] = {s.perm_a, s.perm_b};
    int which = 0;
    for (int32_t k = n_keys - 1; k >= 0; --k) {
        int32_t b = bits[k] < 0 ? 0 : (bits[k] > 32 ? 32 : bits[k]);
        uint32_t flip = b >= 32 ? 0x80000000u : 0u;
        const int32_t* key = keys + (int64_t)k * n;
        for (int32_t shift = 0; shift < b; shift += 8) {
            radix_hist<<<n_tiles, kSortThreads, 0, stream>>>(
                key, cur, n, n_tiles, shift, flip, s.counts);
            // -- grid-wide barrier: every tile's histogram is written --
            enqueue_scan(s.counts, 256 * n_tiles, s.counts, s.total,
                         s.block_sums, stream);
            // -- grid-wide barrier: every (digit, tile) offset is final --
            int32_t* out = bufs[which];
            which ^= 1;
            radix_scatter<<<n_tiles, kSortThreads, 0, stream>>>(
                key, cur, n, n_tiles, shift, flip, s.counts, out);
            // -- grid-wide barrier: the pass's order is complete --
            cur = out;
        }
    }
    return cur;
}
