// Arena allocation: exclusive prefix sum of per-task child counts, then
// the owning task and child ordinal of every arena slot.
//
// Replaces the JAX package's engine/xutil.py:87 arena_assign (K4).  The
// same exclusive scan (csrc/scan.cuh) also serves the compaction of
// engine/fastpath.py:448 _pack_scatter in pack.cu.
// Plain version: xutil._arena_assign_plain.
//
// Bound: bytes, and at this slice's sizes launch latency.  The scan reads
// n int32 and writes n + 1; the slot pass writes 2 int32 per arena slot and
// reads the offsets, which at F <= 32768 stay in L1/L2.  Design: a three
// pass multi-block scan (block scan with warp shuffles, one block scanning
// the block sums, a fix-up add); instead of the JAX scatter-max of task
// starts plus a running-max scan over the arena, each slot finds its
// owner by binary search over the non-decreasing offsets: the last task
// whose offset is <= the slot is exactly the running max of the marks,
// so the result is the same and the arena-sized mark array disappears.
//
// Grid-wide barriers: between the block scans and the block-sum scan, and
// between the block-sum scan and the fix-up (and the slot pass, which
// reads the finished offsets and total).  Each is a launch boundary.
#include "scan.cuh"

// Slot pass: parent = last task whose offset <= j (binary search over the
// non-decreasing offsets), -1 past the total; ordinal = j - offsets[parent].
__global__ void arena_slots(const int32_t* __restrict__ offsets, int32_t n,
                            const int32_t* __restrict__ total, int32_t arena,
                            int32_t* __restrict__ parent,
                            int32_t* __restrict__ ordinal) {
    int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= arena) return;
    if (j >= *total) {
        parent[j] = -1;
        ordinal[j] = 0;
        return;
    }
    int32_t lo = 0, hi = n;  // first index with offsets > j
    while (lo < hi) {
        int32_t mid = (lo + hi) >> 1;
        if (offsets[mid] <= j) lo = mid + 1; else hi = mid;
    }
    int32_t p = lo - 1;
    parent[j] = p;
    ordinal[j] = j - offsets[p];
}

// Scratch: block_sums holds ceil(n / kScanTile) int32.
KT_EXPORT int arena_assign(const int32_t* counts, int32_t n, int32_t arena,
                           int32_t* offsets, int32_t* total, int32_t* parent,
                           int32_t* ordinal, int32_t* block_sums,
                           cudaStream_t stream) {
    enqueue_scan(counts, n, offsets, total, block_sums, stream);
    // -- grid-wide barrier: offsets and total are final --
    const int threads = 256;
    arena_slots<<<kt_blocks(arena, threads), threads, 0, stream>>>(
        offsets, n, total, arena, parent, ordinal);
    return (int)cudaGetLastError();
}
