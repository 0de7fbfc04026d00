// Prefix sums of int32, shared by arena.cu (the arena offsets of
// xutil.arena_assign), pack.cu (the survivor positions of
// fastpath._pack_scatter and the segment ranks of fastpath._pack_sort),
// algebra.cu (gen_collect), shard.cu (shard_route) and sort.cuh (the
// digit offsets of a radix pass).
//
// Building blocks: block_exclusive_scan, one block's scan of one value per
// thread with warp shuffles, and block_scan_items, of several consecutive
// values per thread (arena.cu's one-launch scan, in which every block
// scans every count).  And the three-launch multi-block scan enqueue_scan
// (a block scan per tile, one block scanning the tile sums in chunks with
// a carry, so any length works, and a fix-up add), whose grid-wide
// barriers are launch boundaries; pack.cu, algebra.cu and shard.cu still
// use it.
#pragma once

#include "common.cuh"

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // consecutive elements per thread
constexpr int kScanTile = kScanThreads * kScanItems;

// Exclusive scan of one value per thread across the block; *block_total
// receives the block's sum.  Warp shuffles, then one warp over warp sums.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* block_total) {
    __shared__ int32_t warp_sums[kScanThreads / 32];
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
        int32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
        int32_t w = lane < nwarps ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            int32_t y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        if (lane < nwarps) warp_sums[lane] = w;
    }
    __syncthreads();
    int32_t warp_off = wid > 0 ? warp_sums[wid - 1] : 0;
    *block_total = warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums may be reused by the caller's next tile
    return warp_off + x - v;
}

// A block's exclusive scan of ITEMS consecutive values per thread (thread
// t holds values t * ITEMS .. t * ITEMS + ITEMS - 1 in v): returns the sum
// of every earlier thread's values, the base from which the thread runs
// through its own; *block_total receives the block's sum.
template <int ITEMS>
__device__ int32_t block_scan_items(const int32_t (&v)[ITEMS],
                                    int32_t* block_total) {
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) sum += v[k];
    return block_exclusive_scan(sum, block_total);
}

// Pass 1: per-tile exclusive scan; tile sums to block_sums.
__global__ void scan_tiles(const int32_t* __restrict__ x, int32_t n,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ block_sums) {
    int64_t base = (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
    int32_t v[kScanItems];
    int32_t local = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        v[k] = (base + k < n) ? x[base + k] : 0;
        local += v[k];
    }
    int32_t tile_total;
    int32_t run = block_exclusive_scan(local, &tile_total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        if (base + k < n) out[base + k] = run;
        run += v[k];
    }
    if (threadIdx.x == 0) block_sums[blockIdx.x] = tile_total;
}

// Pass 2 (one block): exclusive scan of the tile sums, in chunks with a
// carry, so any tile count works; the grand total goes to *total.
__global__ void scan_tile_sums(int32_t* __restrict__ block_sums, int32_t nb,
                               int32_t* __restrict__ total) {
    int32_t carry = 0;
    for (int32_t lo = 0; lo < nb; lo += blockDim.x) {
        int32_t i = lo + threadIdx.x;
        int32_t v = i < nb ? block_sums[i] : 0;
        int32_t chunk_total;
        int32_t ex = block_exclusive_scan(v, &chunk_total);
        if (i < nb) block_sums[i] = carry + ex;
        carry += chunk_total;
    }
    if (threadIdx.x == 0) *total = carry;
}

// Pass 3: add each tile's offset.
__global__ void scan_fixup(int32_t* __restrict__ out, int32_t n,
                           const int32_t* __restrict__ block_sums) {
    int64_t i = (int64_t)blockIdx.x * kScanTile + threadIdx.x;
    int32_t off = block_sums[blockIdx.x];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k, i += kScanThreads) {
        if (i < n) out[i] += off;
    }
}

static void enqueue_scan(const int32_t* x, int32_t n, int32_t* out,
                         int32_t* total, int32_t* block_sums,
                         cudaStream_t stream) {
    int nb = kt_blocks(n, kScanTile);
    scan_tiles<<<nb, kScanThreads, 0, stream>>>(x, n, out, block_sums);
    // -- grid-wide barrier: every tile sum is written --
    scan_tile_sums<<<1, kScanThreads, 0, stream>>>(block_sums, nb, total);
    // -- grid-wide barrier: tile offsets and the total are final --
    scan_fixup<<<nb, kScanThreads, 0, stream>>>(out, n, block_sums);
}

