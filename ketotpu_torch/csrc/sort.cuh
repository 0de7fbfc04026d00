// Stable LSD radix sort of N rows by K int32 key columns, onesweep: one
// histogram launch for every digit pass, then one launch per digit pass.
// Used by sort.cu (xutil.lex_sort, which the sort-based frontier pack
// fastpath._pack_sort calls).
//
// Replaces the sort of the JAX package's engine/xutil.py:81 lex_sort and of
// engine/fastpath.py:515 _pack_sort: jax.lax.sort(keys + payload,
// num_keys=K).  lax.sort is not stable; this sort is, which is one of the
// orders lax.sort may return (equal keys in row order).
//
// Bound: bytes.  The least any sort can move is every key and payload
// column read once and written once in sorted order; at the tenant
// plane's pack (N = 16,384-65,536, four keys and one payload) that is
// 0.0005 ms at 3.35 TB/s, far under one launch.  The earlier design took
// five launches per 8-bit digit pass (a tile histogram, three for the scan
// of scan.cuh, a scatter) and one or two gathers: 47 launches at the
// tenant shapes, each a grid-wide barrier of about 2.7 us.  Design, after
// Adinets and Merrill's onesweep sort:
//
// - The pass plan (per pass the key column, the shift and whether the sign
//   bit is flipped) comes from the wrapper (xutil.sort_layout): 8-bit
//   digits, least significant key first and, within a key, least
//   significant digit first; a key column of width b < 32 promises
//   0 <= key < 2^b, so only its ceil(b / 8) low digits are passes; at 32
//   bits the sign bit is flipped so that negative keys sort first, as
//   lax.sort orders int32.
// - The global count of each digit in each pass does not depend on the
//   order the rows are in, so radix_hist_all counts every pass's 256
//   digits in one launch.
// - Each pass is one launch of radix_onesweep.  Block b takes tile b of
//   kSortTile rows when every tile's block fits on the card at once
//   (resident_blocks), so its rows load while it scans the histogram;
//   else blocks take tiles from an atomic tile counter, so a tile waits
//   only on tiles already running.  A block ranks its rows stably (a
//   warp's equal digits by __match_any_sync, the warps in row order),
//   publishes its per-digit counts as one 32-bit status word per (tile,
//   digit) (a flag in the top two bits, the count below: n < 2^30), looks
//   back over the preceding tiles' words for its per-digit base (decoupled
//   look-back, kLookback words in flight per thread), adds the pass's
//   global digit offset (a block scan of the histogram) and scatters.
// - The sort carries a permutation (int32[N]); a pass gathers its key
//   column through it (the column stays in L2 at the pack's sizes).  The
//   last pass scatters the key and payload columns themselves into sorted
//   order, so no gather launch follows.
// - The tile counters and status words start at zero: the entry point
//   clears them with one cudaMemsetAsync (a node of a CUDA graph too).
//   The kernels allocate nothing.
//
// P passes make 1 memset + 1 histogram + P pass launches (11 at the tenant
// shapes, 9 passes).  The build needs sm_90a (the port's one target).
#pragma once

#include "scan.cuh"

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 4;  // rows per thread per tile
constexpr int kSortTile = kSortThreads * kSortItems;  // rows per tile
constexpr int kSortBins = 256;
constexpr int kSortMaxKeys = 8;
constexpr int kSortMaxPasses = 4 * kSortMaxKeys;
constexpr int kSortHistRows = 4;  // rows per thread of the histogram launch
constexpr int kLookback = 8;  // status words read at once in the look-back
constexpr uint32_t kSpinLimit = 1u << 24;  // look-back waits (seconds) before a trap

// status word: the flag in the top two bits, the count below
constexpr uint32_t kStatusAggregate = 1u << 30;  // the tile's own count
constexpr uint32_t kStatusPrefix = 2u << 30;  // count through this tile
constexpr uint32_t kStatusCount = (1u << 30) - 1u;

// The pass plan: pass p sorts by the 8-bit digit at shift[p] of key
// column col[p] (xor flip[p]).
struct SortPlan {
    int32_t n_pass;
    int32_t col[kSortMaxPasses];
    int32_t shift[kSortMaxPasses];
    uint32_t flip[kSortMaxPasses];
};

__device__ __forceinline__ uint32_t sort_digit(int32_t key, int32_t shift,
                                               uint32_t flip) {
    return (((uint32_t)key ^ flip) >> shift) & 0xFFu;
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
    return *(const volatile uint32_t*)p;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
    *(volatile uint32_t*)p = v;
}

// hist[p * 256 + d] += rows whose pass-p digit is d (hist starts at 0).
__global__ void __launch_bounds__(kSortThreads)
radix_hist_all(const int32_t* __restrict__ keys, int32_t n, SortPlan plan,
               int32_t* __restrict__ hist) {
    __shared__ int32_t counts[kSortMaxPasses * kSortBins];
    const int cells = plan.n_pass * kSortBins;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) counts[i] = 0;
    __syncthreads();
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        for (int p = 0; p < plan.n_pass; ++p) {
            const int32_t key = keys[(int64_t)plan.col[p] * n + i];
            atomicAdd(&counts[p * kSortBins +
                              sort_digit(key, plan.shift[p], plan.flip[p])], 1);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        if (counts[i]) atomicAdd(&hist[i], counts[i]);
    }
}

// One digit pass over n rows of keys[n_keys, n].  perm_in: the order so
// far (nullptr: the identity, before the first pass).  perm_out: where the
// pass's order goes, or nullptr on the last pass, which writes
// keys_out[n_keys, n] and payload_out[n_payload, n] in sorted order.
// hist: this pass's 256 digit counts; tile_ctr: its tile counter; status:
// its int32[n_tiles, 256] words (both zeroed).  by_ticket: 0 when every
// block of the grid fits on the card at once (block b takes tile b: no
// tile can wait on a block that cannot start), else blocks take tiles in
// the order they start, from tile_ctr.
__global__ void __launch_bounds__(kSortThreads)
radix_onesweep(const int32_t* __restrict__ keys, int32_t n_keys,
               const int32_t* __restrict__ payload, int32_t n_payload,
               int32_t n, int32_t col, int32_t shift, uint32_t flip,
               const int32_t* __restrict__ hist, int32_t* tile_ctr,
               uint32_t* status, int32_t by_ticket,
               const int32_t* __restrict__ perm_in,
               int32_t* __restrict__ perm_out, int32_t* __restrict__ keys_out,
               int32_t* __restrict__ payload_out) {
    // per warp and digit: its rows of the digit, then (once the tile is
    // ranked) the tile's rows of the digit in earlier warps
    __shared__ int32_t warp_count[kSortWarps][kSortBins];
    __shared__ int32_t digit_base[kSortBins];
    __shared__ int32_t tile_shared;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (by_ticket && threadIdx.x == 0) tile_shared = atomicAdd(tile_ctr, 1);
    for (int i = threadIdx.x; i < kSortWarps * kSortBins; i += blockDim.x) {
        (&warp_count[0][0])[i] = 0;
    }
    const int32_t* key = keys + (int64_t)col * n;
    int32_t row[kSortItems];
    uint32_t digit[kSortItems];
    int32_t rank[kSortItems];
    // rows tile * kSortTile + wid * 32 * kSortItems + k * 32 + lane: row
    // order is (warp, k, lane); rows past the end form their own group
    // (digit 256)
    auto load = [&](int32_t tile) {
        const int64_t first = (int64_t)tile * kSortTile + wid * (32 * kSortItems);
#pragma unroll
        for (int k = 0; k < kSortItems; ++k) {
            const int64_t i = first + k * 32 + lane;
            row[k] = i < n ? (perm_in != nullptr ? perm_in[i] : (int32_t)i) : -1;
        }
#pragma unroll
        for (int k = 0; k < kSortItems; ++k) {
            digit[k] = row[k] >= 0 ? sort_digit(key[row[k]], shift, flip) : kSortBins;
        }
    };
    // the rows' loads overlap the scan of the histogram where the tile is
    // known from the start
    if (!by_ticket) load(blockIdx.x);
    // the pass's global digit offsets (its barriers publish tile_shared
    // and the zeroed counts)
    int32_t hist_total;
    const int32_t global_off =
        block_exclusive_scan(threadIdx.x < kSortBins ? hist[threadIdx.x] : 0,
                             &hist_total);
    const int32_t tile = by_ticket ? tile_shared : (int32_t)blockIdx.x;
    if (by_ticket) load(tile);
    const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
        const uint32_t d = digit[k];
        const uint32_t peers = __match_any_sync(0xffffffffu, d);
        const uint32_t below = peers & lanes_below;
        const int32_t seen = d < kSortBins ? warp_count[wid][d] : 0;
        rank[k] = seen + __popc(below);
        __syncwarp();
        if (d < kSortBins && below == 0) warp_count[wid][d] = seen + __popc(peers);
        __syncwarp();
    }
    __syncthreads();  // every warp's counts are final

    if (threadIdx.x < kSortBins) {
        const int d = threadIdx.x;
        int32_t count = 0;
        for (int w = 0; w < kSortWarps; ++w) {
            const int32_t c = warp_count[w][d];
            warp_count[w][d] = count;
            count += c;
        }
        uint32_t* mine = status + (int64_t)tile * kSortBins + d;
        int32_t before = 0;  // rows of digit d in the tiles before this one
        if (tile == 0) {
            store_status(mine, kStatusPrefix | (uint32_t)count);
        } else {
            store_status(mine, kStatusAggregate | (uint32_t)count);
            int32_t j = tile - 1;  // the next tile to read
            uint32_t waits = 0;
            for (;;) {
                uint32_t w[kLookback];
#pragma unroll
                for (int u = 0; u < kLookback; ++u) {
                    w[u] = j - u >= 0
                        ? load_status(status + (int64_t)(j - u) * kSortBins + d)
                        : kStatusPrefix;  // tile 0 always ends the walk
                }
                int used = 0;
                bool done = false;
#pragma unroll
                for (int u = 0; u < kLookback; ++u) {
                    if (!done && used == u && (w[u] >> 30) != 0) {
                        before += (int32_t)(w[u] & kStatusCount);
                        done = (w[u] & kStatusPrefix) != 0;
                        used = u + 1;
                    }
                }
                if (done) break;
                if (used == 0) {  // tile j has not published yet
                    // a tile that never publishes is a fault: end the launch
                    // with an error instead of hanging the card
                    if (++waits > kSpinLimit) __trap();
                    __nanosleep(64);
                }
                j -= used;
            }
            store_status(mine, kStatusPrefix | (uint32_t)(before + count));
        }
        digit_base[d] = global_off + before;
    }
    __syncthreads();  // digit_base and the warps' prefixes are final

#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
        const uint32_t d = digit[k];
        if (d >= kSortBins) continue;
        const int64_t dest = (int64_t)digit_base[d] + warp_count[wid][d] + rank[k];
        const int64_t r = row[k];
        if (perm_out != nullptr) {
            perm_out[dest] = (int32_t)r;
        } else {
            for (int c = 0; c < n_keys; ++c) {
                keys_out[(int64_t)c * n + dest] = keys[(int64_t)c * n + r];
            }
            for (int c = 0; c < n_payload; ++c) {
                payload_out[(int64_t)c * n + dest] = payload[(int64_t)c * n + r];
            }
        }
    }
}

static inline int64_t sort_tiles(int64_t n) { return (n + kSortTile - 1) / kSortTile; }

// Zeroed scratch words of a sort of n rows in n_pass passes: the
// histograms [n_pass * 256], the tile counters [n_pass], the status words
// [n_pass * sort_tiles(n) * 256] (xutil.sort_layout computes the same).
static inline int64_t sort_zeroed_words(int64_t n, int32_t n_pass) {
    return (int64_t)n_pass * (kSortBins + 1 + sort_tiles(n) * kSortBins);
}

// Enqueue the whole sort: the memset, the histograms, every pass.  perms:
// int32[2, n] (pass p writes perms + (p & 1) * n; one permutation with
// two passes, none with one); zeroed: sort_zeroed_words(n, plan.n_pass)
// words.
static int enqueue_radix_sort(const int32_t* keys, int32_t n_keys,
                              const int32_t* payload, int32_t n_payload,
                              int32_t n, const SortPlan& plan,
                              int32_t* keys_out, int32_t* payload_out,
                              int32_t* perms, int32_t* zeroed,
                              cudaStream_t stream) {
    const int32_t np = plan.n_pass;
    const int64_t tiles = sort_tiles(n);
    int32_t* hist = zeroed;
    int32_t* ctr = hist + (int64_t)np * kSortBins;
    uint32_t* status = (uint32_t*)(ctr + np);
    cudaError_t e = cudaMemsetAsync(
        zeroed, 0, (size_t)sort_zeroed_words(n, np) * sizeof(int32_t), stream);
    if (e != cudaSuccess) return (int)e;
    const int hist_blocks = kt_blocks(n, kSortThreads * kSortHistRows);
    radix_hist_all<<<hist_blocks < 1024 ? hist_blocks : 1024, kSortThreads, 0,
                     stream>>>(keys, n, plan, hist);
    // -- grid-wide barrier (launch boundary): every histogram is complete --
    static int resident_cache[64] = {};
    const int32_t by_ticket =
        tiles > resident_blocks((const void*)radix_onesweep, kSortThreads, resident_cache);
    const int32_t* perm_in = nullptr;
    for (int32_t p = 0; p < np; ++p) {
        const bool last = p == np - 1;
        int32_t* perm_out = last ? nullptr : perms + (int64_t)(p & 1) * n;
        radix_onesweep<<<(int)tiles, kSortThreads, 0, stream>>>(
            keys, n_keys, payload, n_payload, n, plan.col[p], plan.shift[p],
            plan.flip[p], hist + (int64_t)p * kSortBins, ctr + p,
            status + (int64_t)p * tiles * kSortBins, by_ticket, perm_in,
            perm_out, keys_out, payload_out);
        // -- grid-wide barrier (launch boundary): the pass's order is complete --
        perm_in = perm_out;
    }
    return (int)cudaGetLastError();
}
