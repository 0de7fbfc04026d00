// Tier 0, the Leopard closure probe (K6), as its own launch: the unfused
// cascade's device probe of a whole chunk.
//
// Replaces the JAX package's leopard/device.py:96 probe_in_program, jitted
// at :124 as _probe.  Plain version: leopard/device.py::_probe_plain.
//
// Bound: bytes.  Each query reads its two key words, writes hit and hop,
// and makes bit_length(cap) dependent gathers of a (set, element) pair
// (26 at the 2^25-slot columns of the 10M-tuple graph).  The first levels
// of the implicit search tree are the same few slots for every query and
// stay in L1/L2; the last levels are random DRAM reads, one round trip
// each, so a query's time is its chain of dependent loads.  Design: one
// thread per query, the search unrolled by the compiler over a runtime
// step count, read-only loads (__ldg), enough threads in flight (8192 per
// served chunk) to overlap the chains of different queries.
#include "common.cuh"
#include "leopard.cuh"

__global__ void k_leo_probe(const int32_t* __restrict__ sets,
                            const int32_t* __restrict__ elts,
                            const int32_t* __restrict__ hops, int32_t cap,
                            int32_t steps, const int32_t* __restrict__ q_set,
                            const int32_t* __restrict__ q_elt, int32_t n,
                            int32_t* __restrict__ hit,
                            int32_t* __restrict__ hop) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int32_t h;
    bool found = leo_probe_one(sets, elts, hops, cap, steps, q_set[i],
                               q_elt[i], &h);
    hit[i] = found ? 1 : 0;
    hop[i] = h;
}

KT_EXPORT int leo_probe(const int32_t* sets, const int32_t* elts,
                        const int32_t* hops, int32_t cap, int32_t steps,
                        const int32_t* q_set, const int32_t* q_elt, int32_t n,
                        int32_t* hit, int32_t* hop, cudaStream_t stream) {
    const int threads = 256;
    k_leo_probe<<<kt_blocks(n, threads), threads, 0, stream>>>(
        sets, elts, hops, cap, steps, q_set, q_elt, n, hit, hop);
    return (int)cudaGetLastError();
}
