// The fused wave's own work (K8): tier-0 routing, the retry lanes' masks
// and the one output buffer.
//
// Replaces the per-row parts of the JAX package's engine/fused.py:85
// _wave_body (jitted at :229 as _run_wave); the tier-1 passes and the
// tier-2 program inside the wave launch the kernels of probe.cu, arena.cu,
// children.cu, pack.cu and algebra.cu (their root steps, init_state and
// gen_classify, take the active row apart from the block).  Plain versions:
// engine/fused.py::_wave_tier0_plain, _wave_lane_plain,
// _wave_gen_lane_plain, _wave_pack_plain.
//
// Bound: bytes, and at the served Q = 8192 rows launch latency: each
// kernel reads and writes a few int32 per row.  wave_tier0 also runs the
// K6 search (leopard.cuh) on the rows whose probe mode needs it (LM_PROBE
// and LM_HIT_ONLY; the others' verdicts do not depend on the search), so
// its time there is the search's chain of dependent gathers.  Design: one
// thread per row, every output written once, no atomics, nothing fetched
// to the host inside a wave.  The tier-1 and tier-2 passes read rows 0-4
// of the wave's block in place, each with its own active row: tier 1's
// first pass the row wave_tier0 writes, each retry lane the unresolved
// row wave_lane writes, tier 2 the block's general row, its retry the row
// wave_gen_lane writes.
//
// The wave's query block is int32[10, Q]: ns, obj, rel, subj, depth,
// fast-eligible, general, probe mode (LM_*), probe set id, probe element.
#include "common.cuh"
#include "leopard.cuh"

// leopard/closure.py LM_* probe modes and engine/optable.py R_ERR
#define LM_PROBE 1
#define LM_ALLOW 2
#define LM_DENY 3
#define LM_HIT_ONLY 4
#define R_ERR 3

// Tier 0 (fused.py:122-145): the probe, ok_depth against the chunk's one
// rest depth q_depth[0], the two selects in their order, then the tier-1
// active row fast_elig & ~leo_ans (fact, when tier 1 is in the wave).
// leo[i] = leo_ans | leo_allow << 1.  cap == 0: no pair columns (hit and
// ok_depth are false).
__global__ void k_wave_tier0(const int32_t* __restrict__ qpack, int32_t q,
                             const int32_t* __restrict__ sets,
                             const int32_t* __restrict__ elts,
                             const int32_t* __restrict__ hops, int32_t cap,
                             int32_t steps, int32_t depth_slack,
                             int32_t* __restrict__ leo,
                             int32_t* __restrict__ fact) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    int32_t lmode = qpack[7 * q + i];
    bool hit = false, ok_depth = false;
    if (cap > 0 && (lmode == LM_PROBE || lmode == LM_HIT_ONLY)) {
        int32_t hop;
        hit = leo_probe_one(sets, elts, hops, cap, steps, qpack[8 * q + i],
                            qpack[9 * q + i], &hop);
        ok_depth = hop + depth_slack <= qpack[4 * q];
    }
    bool ans = false, allow = false;
    if (lmode == LM_PROBE) {
        ans = ok_depth || !hit;
        allow = ans && hit;
    } else if (lmode == LM_ALLOW) {
        ans = allow = true;
    } else if (lmode == LM_DENY) {
        ans = true;
    } else if (lmode == LM_HIT_ONLY) {
        ans = allow = hit && ok_depth;
    }
    leo[i] = (ans ? 1 : 0) | (allow ? 2 : 0);
    if (fact != nullptr) fact[i] = (qpack[5 * q + i] != 0 && !ans) ? 1 : 0;
}

// After a tier-1 pass over active rows `act` (fused.py:158-173).  First
// pass (found_in null): found = the pass's own, unres = act & over & ~found
// & ~dirty (a retry would read the same stale row), fb = (act & dirty &
// ~found) | unres.  A retry lane: found = found_in | act & pfound, unres =
// act & (over | dirty) & ~found of the pass, fb = (fb_in & ~act) | unres
// (the first pass's dirty rows never enter a lane).  retried |= unres when
// another lane follows (`more`): unres is that lane's active row.  After
// the last pass, fb is the fast fallback mask.
__global__ void k_wave_lane(const int32_t* __restrict__ act,
                            const int32_t* __restrict__ pfound,
                            const int32_t* __restrict__ pover,
                            const int32_t* __restrict__ pdirty,
                            const int32_t* __restrict__ found_in,
                            const int32_t* __restrict__ retried_in,
                            const int32_t* __restrict__ fb_in, int32_t q,
                            int32_t more, int32_t* __restrict__ found_out,
                            int32_t* __restrict__ unres_out,
                            int32_t* __restrict__ retried_out,
                            int32_t* __restrict__ fb_out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    bool a = act[i] != 0, f = pfound[i] != 0, o = pover[i] != 0;
    bool dt = pdirty[i] != 0;
    bool found, unres, fb;
    if (found_in == nullptr) {
        found = f;
        unres = a && o && !f && !dt;
        fb = (a && dt && !f) || unres;
    } else {
        found = (found_in[i] != 0) || (a && f);
        unres = a && (o || dt) && !f;
        fb = (fb_in[i] != 0 && !a) || unres;
    }
    bool retried = (retried_in != nullptr && retried_in[i] != 0) ||
                   (more != 0 && unres);
    found_out[i] = found ? 1 : 0;
    unres_out[i] = unres ? 1 : 0;
    retried_out[i] = retried ? 1 : 0;
    fb_out[i] = fb ? 1 : 0;
}

// The general retry lane (fused.py:193-211).  Without rcodes: the retry's
// active row gunres = gact & over & ~dirty & code != R_ERR of the first
// pass (gact: the wave's general row).  With rcodes and that row (ract):
// the merged bits code | over << 2 | dirty << 3 | gunres << 9, the
// retry's code and over (over | dirty | ERR) on the gunres rows, the first
// pass's elsewhere.
__global__ void k_wave_gen_lane(const uint8_t* __restrict__ gcodes,
                                const int32_t* __restrict__ gact, int32_t q,
                                const uint8_t* __restrict__ rcodes,
                                const int32_t* __restrict__ ract,
                                int32_t* __restrict__ out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    int32_t c = gcodes[i];
    int32_t code = c & 3;
    bool over = (c >> 2) & 1, dirty = (c >> 3) & 1;
    if (rcodes == nullptr) {
        bool gunres = gact[i] != 0 && over && !dirty && code != R_ERR;
        out[i] = gunres ? 1 : 0;
        return;
    }
    bool gunres = ract[i] != 0;
    if (gunres) {
        int32_t r = rcodes[i];
        code = r & 3;
        over = ((r >> 2) & 1) || ((r >> 3) & 1) || code == R_ERR;
    }
    out[i] = code | (over ? 4 : 0) | (dirty ? 8 : 0) | (gunres ? 512 : 0);
}

// The wave's output (fused.py:214-225): the ten-bit row field, then the
// tier-1 occupancy (F entries), then the tier-2 occupancy (G entries).
// Absent inputs are zero: gbits (merged general bits) or, without a
// general retry, gcodes & 15.
__global__ void k_wave_pack(int32_t q, const int32_t* __restrict__ leo,
                            const int32_t* __restrict__ found,
                            const int32_t* __restrict__ fast_fb,
                            const int32_t* __restrict__ retried,
                            const uint8_t* __restrict__ gcodes,
                            const int32_t* __restrict__ gbits,
                            const int32_t* __restrict__ focc, int32_t nf,
                            const int32_t* __restrict__ gocc, int32_t ng,
                            int32_t* __restrict__ out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < q) {
        int32_t g = gbits != nullptr ? gbits[i]
                    : (gcodes != nullptr ? (gcodes[i] & 15) : 0);
        int32_t l = leo[i];
        int32_t row = g | ((l & 1) << 6) | (((l >> 1) & 1) << 7);
        if (found != nullptr) {
            row |= (found[i] != 0 ? 16 : 0) | (fast_fb[i] != 0 ? 32 : 0) |
                   (retried[i] != 0 ? 256 : 0);
        }
        out[i] = row;
    } else if (i < q + nf) {
        out[i] = focc[i - q];
    } else if (i < q + nf + ng) {
        out[i] = gocc[i - q - nf];
    }
}

KT_EXPORT int wave_tier0(const int32_t* qpack, int32_t q, const int32_t* sets,
                         const int32_t* elts, const int32_t* hops, int32_t cap,
                         int32_t steps, int32_t depth_slack, int32_t* leo,
                         int32_t* fact, cudaStream_t stream) {
    const int threads = 256;
    k_wave_tier0<<<kt_blocks(q, threads), threads, 0, stream>>>(
        qpack, q, sets, elts, hops, cap, steps, depth_slack, leo, fact);
    return (int)cudaGetLastError();
}

KT_EXPORT int wave_lane(const int32_t* act, const int32_t* pfound,
                        const int32_t* pover, const int32_t* pdirty,
                        const int32_t* found_in, const int32_t* retried_in,
                        const int32_t* fb_in, int32_t q, int32_t more,
                        int32_t* found_out, int32_t* unres_out,
                        int32_t* retried_out, int32_t* fb_out,
                        cudaStream_t stream) {
    const int threads = 256;
    k_wave_lane<<<kt_blocks(q, threads), threads, 0, stream>>>(
        act, pfound, pover, pdirty, found_in, retried_in, fb_in, q, more,
        found_out, unres_out, retried_out, fb_out);
    return (int)cudaGetLastError();
}

KT_EXPORT int wave_gen_lane(const uint8_t* gcodes, const int32_t* gact,
                            int32_t q, const uint8_t* rcodes,
                            const int32_t* ract, int32_t* out,
                            cudaStream_t stream) {
    const int threads = 256;
    k_wave_gen_lane<<<kt_blocks(q, threads), threads, 0, stream>>>(
        gcodes, gact, q, rcodes, ract, out);
    return (int)cudaGetLastError();
}

KT_EXPORT int wave_pack(int32_t q, const int32_t* leo, const int32_t* found,
                        const int32_t* fast_fb, const int32_t* retried,
                        const uint8_t* gcodes, const int32_t* gbits,
                        const int32_t* focc, int32_t nf, const int32_t* gocc,
                        int32_t ng, int32_t* out, cudaStream_t stream) {
    const int threads = 256;
    k_wave_pack<<<kt_blocks((int64_t)q + nf + ng, threads), threads, 0,
                  stream>>>(q, leo, found, fast_fb, retried, gcodes, gbits,
                            focc, nf, gocc, ng, out);
    return (int)cudaGetLastError();
}
