// Arena allocation: exclusive prefix sum of per-task child counts, then
// the owning task and child ordinal of every arena slot, in one launch.
//
// Replaces the JAX package's engine/xutil.py:87 arena_assign (K4).
// Plain version: xutil._arena_assign_plain.
//
// Bound: bytes, and at the served sizes launch latency.  The call reads T
// int32 counts and writes T + 1 offsets and 2 int32 per arena slot: at
// the first pass (T = 8,192, A = 16,384) about 0.2 MB, 0.00006 ms at
// 3.35 TB/s, far under one launch.  The earlier design took four launches
// (three for the multi-block scan of scan.cuh, one for the slots), each a
// grid-wide barrier of about 3 us.
//
// Design: one launch, a chained scan with decoupled look-back.
// - Tiles.  Block b scans tile b of kArenaTile tasks (block_scan_items of
//   scan.cuh; the grid is no larger than the card holds at once, so a tile
//   never waits on a block that cannot start; with more tiles than that,
//   the blocks take tile after tile from a ticket counter instead, so a
//   tile waits only on tiles already running), publishes the tile's sum as
//   a 64-bit status word (a flag in the high half), and its first warp
//   looks back over up to 32 preceding tiles' words at once for its base;
//   it then publishes the inclusive prefix and writes its offsets.
// - Slots.  Each task writes its own slots, [offset, offset + count) below
//   A: parent = the task, ordinal = the slot's rank in it.  For counts >= 0
//   (the kernel assumes it, as the JAX function's callers guarantee) the
//   ranges tile [0, total), so this is exactly the plain version's running
//   max of the range starts (xutil.py:52-59).  A binary search over the
//   tile's offsets in shared memory, one slot per thread, was measured
//   slower on the H100, skewed counts included.  No slot at or past A is
//   written.
// - The total is the last tile's inclusive prefix.  One thread of each
//   block waits for it while the others write their slots (the last tile
//   is already running), then the block fills its share of the slots in
//   [total, A) with parent -1 and ordinal 0.
// - State.  The ticket, a count of finished blocks and the status words
//   live in a zeroed int32 buffer the wrapper keeps per device
//   (xutil._arena_state) across calls; the last block to finish zeroes
//   what the call used, so no memset launch precedes the next call (each
//   block counts itself finished after its last status read, while it
//   fills the slots past the total).
//   Calls on one device therefore run in stream order (the engine's one
//   stream), as their shared buffer requires.
// One eight-block thread-block cluster exchanging its blocks' sums through
// distributed shared memory was measured slower on the H100: eight SMs
// fill 65,536 slots too slowly (PERF.md).
#include "scan.cuh"

constexpr int kArenaThreads = 256;
constexpr int kArenaItems = 2;  // consecutive counts per thread
constexpr int kArenaTile = kArenaThreads * kArenaItems;  // tasks per tile
constexpr uint32_t kArenaSpinLimit = 1u << 24;  // waits (seconds) before a trap

// status word of a tile: the flag in the high half, the sum in the low
constexpr uint64_t kTileAggregate = 1ull << 32;  // the tile's own sum
constexpr uint64_t kTilePrefix = 2ull << 32;  // the sum through this tile

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint64_t load_tile(const uint64_t* p) {
    return *(const volatile uint64_t*)p;
}

__device__ __forceinline__ void store_tile(uint64_t* p, uint64_t v) {
    *(volatile uint64_t*)p = v;
}

__device__ __forceinline__ void arena_wait(uint32_t* waits) {
    // a tile that never publishes is a fault: end the launch with an
    // error instead of hanging the card
    if (++*waits > kArenaSpinLimit) __trap();
    __nanosleep(32);
}

// The total: the last tile's inclusive prefix, once it is published.
__device__ __forceinline__ int32_t wait_total(const uint64_t* status, int32_t n_tiles) {
    if (n_tiles == 0) return 0;
    uint32_t waits = 0;
    uint64_t w;
    while (((w = load_tile(status + n_tiles - 1)) >> 32) != 2) arena_wait(&waits);
    return (int32_t)(uint32_t)w;
}

// state: int32 [ticket, finished blocks, then n_tiles uint64 status words]
__global__ void __launch_bounds__(kArenaThreads)
arena_assign_k(const int32_t* __restrict__ counts, int32_t n, int32_t arena,
               int32_t* __restrict__ offsets, int32_t* __restrict__ total_out,
               int32_t* __restrict__ parent, int32_t* __restrict__ ordinal,
               int32_t* state, int32_t n_tiles) {
    __shared__ int32_t s_tile, s_base, s_total, s_last;
    int32_t* ticket = state;
    int32_t* finished = state + 1;
    uint64_t* status = reinterpret_cast<uint64_t*>(state + 2);
    const int lane = threadIdx.x & 31;
    // one tile per block (tile = block: every block fits on the card at
    // once, so none waits on a block that cannot start), or, with more
    // tiles than blocks, tile after tile by ticket
    const bool by_ticket = n_tiles > (int)gridDim.x;
    // the thread that waits for the total and counts the block finished
    const bool waiter = threadIdx.x == blockDim.x - 32;
    const bool aligned = ((uintptr_t)counts & 15) == 0;

    for (int32_t t = blockIdx.x;;) {
        if (by_ticket) {
            if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
            __syncthreads();
            t = s_tile;
        }
        if (t >= n_tiles) break;
        const int64_t t0 = (int64_t)t * kArenaTile;
        const int32_t tile_n = (int32_t)min64((int64_t)kArenaTile, (int64_t)n - t0);
        const int32_t mine = threadIdx.x * kArenaItems;
        int32_t v[kArenaItems];
        if (aligned && mine + kArenaItems <= tile_n) {
            const int2 x = *reinterpret_cast<const int2*>(counts + t0 + mine);
            v[0] = x.x;
            v[1] = x.y;
        } else {
#pragma unroll
            for (int k = 0; k < kArenaItems; ++k) {
                v[k] = mine + k < tile_n ? counts[t0 + mine + k] : 0;
            }
        }
        int32_t tile_sum;
        const int32_t local = block_scan_items<kArenaItems>(v, &tile_sum);
        if (threadIdx.x < 32) {
            if (lane == 0) {
                store_tile(status + t, (t == 0 ? kTilePrefix : kTileAggregate) |
                                           (uint32_t)tile_sum);
            }
            // look back: lane l reads tile j - l; the nearest prefix and
            // every aggregate after it give the base
            int32_t base = 0;
            uint32_t waits = 0;
            for (int32_t j = t - 1; j >= 0;) {
                const int32_t idx = j - lane;
                const uint64_t w = idx >= 0 ? load_tile(status + idx) : kTilePrefix;
                const uint32_t ready = __ballot_sync(0xffffffffu, (w >> 32) != 0);
                const uint32_t pre = __ballot_sync(0xffffffffu, (w >> 32) == 2);
                const int first_pre = pre ? __ffs(pre) - 1 : 31;
                const uint32_t upto = first_pre == 31 ? 0xffffffffu : (2u << first_pre) - 1u;
                if ((ready & upto) != upto) {
                    arena_wait(&waits);  // a tile before the prefix has not published
                    continue;
                }
                int32_t x = lane <= first_pre ? (int32_t)(uint32_t)w : 0;
                for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                base += x;
                if (pre) break;
                j -= 32;
            }
            if (lane == 0) {
                if (t > 0) store_tile(status + t, kTilePrefix | (uint32_t)(base + tile_sum));
                s_base = base;
            }
        }
        __syncthreads();
        if (!by_ticket && waiter) s_total = wait_total(status, n_tiles);
        // the offsets, and each task's own slots below A
        int32_t run = s_base + local;
#pragma unroll
        for (int k = 0; k < kArenaItems; ++k) {
            if (mine + k < tile_n) {
                offsets[t0 + mine + k] = run;
                const int32_t end = (int32_t)min64((int64_t)run + v[k], (int64_t)arena);
                for (int32_t j = run; j < end; ++j) {
                    parent[j] = (int32_t)(t0 + mine + k);
                    ordinal[j] = j - run;
                }
            }
            run += v[k];
        }
        if (!by_ticket) break;
        __syncthreads();  // s_tile is rewritten next
    }
    // out of tiles by ticket: the last tile is taken, its prefix comes
    if ((by_ticket || n_tiles == 0) && waiter) s_total = wait_total(status, n_tiles);
    __syncthreads();  // s_total is known
    const int32_t total = s_total;
    // the block's last status read is done: it counts itself finished
    // while the slots past the total are filled
    const bool last = waiter && atomicAdd(finished, 1) == (int)gridDim.x - 1;
    if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = total;
    for (int64_t j = min64((int64_t)total, (int64_t)arena) +
                     (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < arena; j += (int64_t)gridDim.x * blockDim.x) {
        parent[j] = -1;
        ordinal[j] = 0;
    }
    if (waiter) s_last = last;
    __syncthreads();
    // the last block to finish leaves the state zeroed for the next call
    if (s_last) {
        for (int32_t i = threadIdx.x; i < n_tiles; i += blockDim.x) status[i] = 0;
        if (threadIdx.x == 0) {
            *ticket = 0;
            *finished = 0;
        }
    }
}

// state: the wrapper's zeroed int32[2 + 2 * state_tiles] (xutil._arena_state),
// zeroed again by the call.
KT_EXPORT int arena_assign(const int32_t* counts, int32_t n, int32_t arena,
                           int32_t* offsets, int32_t* total, int32_t* parent,
                           int32_t* ordinal, int32_t* state, int32_t state_tiles,
                           cudaStream_t stream) {
    if (n < 0 || arena < 0) return (int)cudaErrorInvalidValue;
    const int32_t n_tiles = (int32_t)(((int64_t)n + kArenaTile - 1) / kArenaTile);
    if (n_tiles > state_tiles) return (int)cudaErrorInvalidValue;
    // every block of the grid fits on the card at once; with no task, one
    // block writes the total and clears the slots
    static int resident_cache[64] = {};
    const int resident = resident_blocks((const void*)arena_assign_k, kArenaThreads,
                                         resident_cache);
    int blocks = n_tiles < resident ? n_tiles : resident;
    blocks = blocks < 1 ? 1 : blocks;
    arena_assign_k<<<blocks, kArenaThreads, 0, stream>>>(
        counts, n, arena, offsets, total, parent, ordinal, state, n_tiles);
    return (int)cudaGetLastError();
}
