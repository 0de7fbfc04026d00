// Frontier packing and the batch's packed I/O: the roots of a batch, the
// dedup + compaction of one level's children into the next frontier, and
// the verdict bytes.
//
// Replaces the JAX package's engine/fastpath.py:448 _pack_scatter,
// :175 _init_state and the output packing of :702 _run_fused_packed (K5);
// the level loop of :657 _fused_body is the host loop in
// fastpath.run_fast_packed, which enqueues every level on one stream.
// Plain versions: fastpath._pack_scatter_plain, _init_state_plain,
// _pack_verdicts_plain.
//
// Bound: bytes.  _pack_scatter reads the seven child columns of the arena
// (plus the owner's key and a q_found bit per child), keeps a 2A-slot
// table of four int32 words, and writes seven columns of the next
// frontier.  The table (<= 1 MB at the retry's A = 65536) lives in L2, so
// the atomics are L2 atomics.  Design: linear hash-scatter dedup exactly
// as the JAX program (owner = max index by atomicMax; depth and force
// merged by atomicMax, skip by atomicMin, over children of the owner's key
// only; colliders of other keys pass through), then compaction by the
// survivor prefix sum, so the result is deterministic and equal to the
// plain version bit for bit.
//
// Grid-wide barriers: table fill -> owner scatter -> merge scatter ->
// survivor scan (three launches, csrc/scan.cuh) -> emit.  Each is a launch
// boundary.
#include "scan.cuh"

constexpr uint32_t kPackSalt = 0x9E3779B9u;

__device__ __forceinline__ int32_t pack_key(int32_t qid, int32_t ns, int32_t rel,
                                            int32_t nsb, int32_t relb) {
    // int32 bit pattern of (qid << (nsb + relb)) | (ns << relb) | rel
    return (int32_t)(((uint32_t)qid << (nsb + relb)) | ((uint32_t)ns << relb) |
                     (uint32_t)rel);
}

__device__ __forceinline__ bool child_alive(const Items& ch, int32_t i,
                                            const int32_t* q_found, int32_t nq) {
    int32_t q = ch.qid[i];
    return q >= 0 && q_found[clampi(q, 0, nq - 1)] == 0;
}

// Fill the dedup table and the next frontier with their empty values.
__global__ void pack_fill(int32_t h_slots, int32_t* __restrict__ own,
                          int32_t* __restrict__ d_tab, int32_t* __restrict__ skip_tab,
                          int32_t* __restrict__ force_tab, Items out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < h_slots) {
        own[i] = -1;
        d_tab[i] = -1;
        skip_tab[i] = 1;
        force_tab[i] = 0;
    }
    if (i < out.n) {
        out.qid[i] = -1;
        out.ns[i] = -1;
        out.obj[i] = -1;
        out.rel[i] = -1;
        out.d[i] = 0;
        out.skip[i] = 0;
        out.force[i] = 0;
    }
}

// Owner pass: every alive child claims its slot; the largest index wins.
__global__ void pack_owner(Items ch, const int32_t* __restrict__ q_found, int32_t nq,
                           int32_t nsb, int32_t relb, int32_t h_slots,
                           int32_t* __restrict__ hslot, int32_t* __restrict__ own) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ch.n) return;
    int32_t k1 = pack_key(ch.qid[i], ch.ns[i], ch.rel[i], nsb, relb);
    int32_t h = (int32_t)(mix32(k1, ch.obj[i], kPackSalt) & (uint32_t)(h_slots - 1));
    hslot[i] = h;
    if (child_alive(ch, i, q_found, nq)) atomicMax(&own[h], i);
}

// Merge pass: children with the owner's key merge into the slot (max d,
// min skip, max force); survivors are owners and alive non-matching
// colliders.
__global__ void pack_merge(Items ch, const int32_t* __restrict__ q_found, int32_t nq,
                           int32_t nsb, int32_t relb,
                           const int32_t* __restrict__ hslot,
                           const int32_t* __restrict__ own,
                           int32_t* __restrict__ d_tab, int32_t* __restrict__ skip_tab,
                           int32_t* __restrict__ force_tab,
                           int32_t* __restrict__ surv) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ch.n) return;
    bool alive = child_alive(ch, i, q_found, nq);
    int32_t h = hslot[i];
    int32_t owner = own[h];
    int32_t oc = clampi(owner, 0, ch.n - 1);
    bool same = alive &&
                pack_key(ch.qid[oc], ch.ns[oc], ch.rel[oc], nsb, relb) ==
                    pack_key(ch.qid[i], ch.ns[i], ch.rel[i], nsb, relb) &&
                ch.obj[oc] == ch.obj[i];
    if (same) {
        atomicMax(&d_tab[h], ch.d[i]);
        atomicMin(&skip_tab[h], (int32_t)ch.skip[i]);
        atomicMax(&force_tab[h], (int32_t)ch.force[i]);
    }
    bool is_owner = alive && owner == i;
    surv[i] = (is_owner || (alive && !same)) ? 1 : 0;
}

// Emit pass: survivors land at their prefix-sum position; those past the
// frontier mark their query over.  Thread 0 records the next level's
// occupancy (the live items it receives).
__global__ void pack_emit(Items ch, const int32_t* __restrict__ hslot,
                          const int32_t* __restrict__ own,
                          const int32_t* __restrict__ d_tab,
                          const int32_t* __restrict__ skip_tab,
                          const int32_t* __restrict__ force_tab,
                          const int32_t* __restrict__ surv,
                          const int32_t* __restrict__ pos,
                          const int32_t* __restrict__ total, int32_t nq,
                          int32_t* __restrict__ q_over, Items out,
                          int32_t* __restrict__ occ_slot) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i == 0 && occ_slot != nullptr) {
        int32_t t = *total;
        *occ_slot = t < out.n ? t : out.n;
    }
    if (i >= ch.n || !surv[i]) return;
    int32_t p = pos[i];
    int32_t q = ch.qid[i];
    if (p >= out.n) {
        atomicOr(&q_over[clampi(q, 0, nq - 1)], 1);
        return;
    }
    int32_t h = hslot[i];
    bool is_owner = own[h] == i;  // only alive children claim a slot
    out.qid[p] = q;
    out.ns[p] = ch.ns[i];
    out.obj[p] = ch.obj[i];
    out.rel[p] = ch.rel[i];
    out.d[p] = is_owner ? d_tab[h] : ch.d[i];
    out.skip[p] = is_owner ? (uint8_t)(skip_tab[h] != 0) : ch.skip[i];
    out.force[p] = is_owner ? (uint8_t)(force_tab[h] != 0) : ch.force[i];
}

// Scratch (int32): own, d_tab, skip_tab, force_tab [h_slots each];
// hslot, surv, pos [ch.n each]; total [1]; block_sums [ceil(ch.n / 4096)].
KT_EXPORT int pack_scatter(Items ch, const int32_t* q_found,
                           const int32_t* q_over_in, int32_t* q_over_out,
                           int32_t nq, int32_t nsb, int32_t relb, int32_t h_slots,
                           int32_t* own, int32_t* d_tab, int32_t* skip_tab,
                           int32_t* force_tab, int32_t* hslot, int32_t* surv,
                           int32_t* pos, int32_t* total, int32_t* block_sums,
                           Items out, int32_t* occ_slot, cudaStream_t stream) {
    cudaMemcpyAsync(q_over_out, q_over_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    int32_t fill_n = h_slots > out.n ? h_slots : out.n;
    pack_fill<<<kt_blocks(fill_n, threads), threads, 0, stream>>>(
        h_slots, own, d_tab, skip_tab, force_tab, out);
    // -- grid-wide barrier: the table is empty --
    pack_owner<<<kt_blocks(ch.n, threads), threads, 0, stream>>>(
        ch, q_found, nq, nsb, relb, h_slots, hslot, own);
    // -- grid-wide barrier: every slot's owner is final --
    pack_merge<<<kt_blocks(ch.n, threads), threads, 0, stream>>>(
        ch, q_found, nq, nsb, relb, hslot, own, d_tab, skip_tab, force_tab, surv);
    // -- grid-wide barrier: merges and survivor flags are final --
    enqueue_scan(surv, ch.n, pos, total, block_sums, stream);
    // -- grid-wide barrier: positions and the survivor total are final --
    pack_emit<<<kt_blocks(ch.n, threads), threads, 0, stream>>>(
        ch, hslot, own, d_tab, skip_tab, force_tab, surv, pos, total, nq,
        q_over_out, out, occ_slot);
    return (int)cudaGetLastError();
}

// _init_state: roots in slots 0..nq-1 from the packed int32[6, nq] query
// block (ns, obj, rel, subj, depth, active); depth clamped to the level
// count; the live-root count goes to *occ0.
__global__ void pack_init_state(const int32_t* __restrict__ qpack, int32_t nq,
                                int32_t levels, Items f,
                                int32_t* __restrict__ q_found,
                                int32_t* __restrict__ q_over,
                                int32_t* __restrict__ occ0) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in_q = false;
    if (i < f.n) {
        in_q = i < nq && qpack[5 * nq + i] != 0;
        int32_t depth = in_q ? qpack[4 * nq + i] : 0;
        f.qid[i] = in_q ? i : -1;
        f.ns[i] = in_q ? qpack[i] : -1;
        f.obj[i] = in_q ? qpack[nq + i] : -1;
        f.rel[i] = in_q ? qpack[2 * nq + i] : -1;
        f.d[i] = depth < levels ? depth : levels;
        f.skip[i] = 0;
        f.force[i] = 0;
    }
    if (i < nq) {
        q_found[i] = 0;
        q_over[i] = 0;
    }
    int n_live = __syncthreads_count(in_q);
    if (threadIdx.x == 0 && n_live > 0) atomicAdd(occ0, n_live);
}

KT_EXPORT int init_state(const int32_t* qpack, int32_t nq, int32_t levels, Items f,
                         int32_t* q_found, int32_t* q_over, int32_t* occ0,
                         cudaStream_t stream) {
    cudaMemsetAsync(occ0, 0, sizeof(int32_t), stream);
    const int threads = 256;
    int32_t n = f.n > nq ? f.n : nq;
    pack_init_state<<<kt_blocks(n, threads), threads, 0, stream>>>(
        qpack, nq, levels, f, q_found, q_over, occ0);
    return (int)cudaGetLastError();
}

// The verdict byte per query: bit0 found, bit1 over (bit2, dirty, needs
// the write overlay and stays 0).
__global__ void pack_verdict_bytes(const int32_t* __restrict__ q_found,
                                   const int32_t* __restrict__ q_over, int32_t nq,
                                   uint8_t* __restrict__ out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    out[i] = (uint8_t)((q_found[i] != 0) | ((q_over[i] != 0) << 1));
}

KT_EXPORT int pack_verdicts(const int32_t* q_found, const int32_t* q_over,
                            int32_t nq, uint8_t* out, cudaStream_t stream) {
    const int threads = 256;
    pack_verdict_bytes<<<kt_blocks(nq, threads), threads, 0, stream>>>(
        q_found, q_over, nq, out);
    return (int)cudaGetLastError();
}
