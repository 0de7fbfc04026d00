// The Leopard pair search (K6) as a device function, shared by the
// standalone probe (leopard.cu) and the fused wave's tier 0 (wave.cu).
//
// Replaces the body of the JAX package's leopard/device.py:96
// probe_in_program: one lexicographic binary search of (q_set, q_elt) over
// the sorted int32 pair columns (sets, elts), exactly `steps` =
// bit_length(cap) unrolled steps, then the clamped compare.  A midpoint of
// `cap` (only reachable when the pairs fill their bucket exactly and the
// query sorts after the last pair) is read at cap - 1, as JAX clamps an
// out-of-range gather; the verdict is then a miss, as in JAX.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The slot a query's search ends on, clamped to [0, cap - 1].
__device__ __forceinline__ int32_t leo_search(const int32_t* __restrict__ sets,
                                              const int32_t* __restrict__ elts,
                                              int32_t cap, int32_t steps,
                                              int32_t qs, int32_t qe) {
    int32_t lo = 0, hi = cap;
    for (int32_t s = 0; s < steps; ++s) {
        int32_t mid = (lo + hi) >> 1;
        int32_t mc = mid < cap - 1 ? mid : cap - 1;
        int32_t ms = __ldg(sets + mc);
        int32_t me = __ldg(elts + mc);
        bool less = (ms < qs) || (ms == qs && me < qe);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    return lo < 0 ? 0 : (lo > cap - 1 ? cap - 1 : lo);
}

// (hit, hop) of one query: hop is the pair's hop count on a hit, else 0.
__device__ __forceinline__ bool leo_probe_one(const int32_t* __restrict__ sets,
                                              const int32_t* __restrict__ elts,
                                              const int32_t* __restrict__ hops,
                                              int32_t cap, int32_t steps,
                                              int32_t qs, int32_t qe,
                                              int32_t* hop) {
    int32_t idx = leo_search(sets, elts, cap, steps, qs, qe);
    bool hit = (__ldg(sets + idx) == qs) && (__ldg(elts + idx) == qe);
    *hop = hit ? __ldg(hops + idx) : 0;
    return hit;
}
