// Frontier packing and the batch's packed I/O: the roots of a batch, the
// dedup + compaction of one level's children into the next frontier, and
// the verdict bytes.
//
// Replaces the JAX package's engine/fastpath.py:448 _pack_scatter,
// :515 _pack_sort, :175 _init_state and the output packing of :702
// _run_fused_packed (K5, K5b);
// on the graph-sharded mesh (K10) the same packs read the routed children
// as the rows parallel/graphshard.py:159 _route receives (the *_rows entry
// points) and the roots activate on their assigned shard (init_state's
// assign); the level loop of :657 _fused_body is the host loop in
// fastpath.run_fast_packed, which enqueues every level on one stream.
// Plain versions: fastpath._pack_scatter_plain, _pack_sort_plain,
// _init_state_plain, _pack_verdicts_plain.
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
//
// K5b, the sort-based pack (any key width: the (qid, ns, rel) key of the
// scatter needs 31 bits or fewer), in three steps, the middle one the
// radix sort of csrc/sort.cu through xutil.lex_sort:
// pack_sort_keys writes the four sort keys (qid, ns, rel, obj; a dead
// child sorts last as qid = Q) and the payload d << 2 | skip << 1 | force;
// lex_sort sorts them; pack_sort flags each segment's first row (valid and
// its key differs from the previous row's), ranks the first rows with the
// scan, reduces each contiguous segment to max d, min skip and max force
// (the first row's thread walks its segment: duplicates of one child are
// few), writes the survivors below the frontier size in sorted order and
// marks the query over for each first row past it.  Bound: bytes, the
// child columns read once, the frontier and the over bits written once;
// the keys, payload and flags between the steps are scratch of 4 * 10
// bytes per child, in L2 at the served arena sizes.
#include "scan.cuh"

constexpr uint32_t kPackSalt = 0x9E3779B9u;

__device__ __forceinline__ int32_t pack_key(int32_t qid, int32_t ns, int32_t rel,
                                            int32_t nsb, int32_t relb) {
    // int32 bit pattern of (qid << (nsb + relb)) | (ns << relb) | rel
    return (int32_t)(((uint32_t)qid << (nsb + relb)) | ((uint32_t)ns << relb) |
                     (uint32_t)rel);
}

// The children a pack reads: the arena's seven columns (ColSrc), or the
// [n, 7] int32 rows a sharded level routed to this shard (RowSrc: qid, ns,
// obj, rel, d, skip, force; a bool is any non-zero word).
struct ColSrc {
    Items it;
    __device__ __forceinline__ int32_t qid(int32_t i) const { return it.qid[i]; }
    __device__ __forceinline__ int32_t ns(int32_t i) const { return it.ns[i]; }
    __device__ __forceinline__ int32_t obj(int32_t i) const { return it.obj[i]; }
    __device__ __forceinline__ int32_t rel(int32_t i) const { return it.rel[i]; }
    __device__ __forceinline__ int32_t d(int32_t i) const { return it.d[i]; }
    __device__ __forceinline__ uint8_t skip(int32_t i) const { return it.skip[i]; }
    __device__ __forceinline__ uint8_t force(int32_t i) const { return it.force[i]; }
    __host__ __device__ int32_t n() const { return it.n; }
};

struct RowSrc {
    const int32_t* r;
    int32_t rows;
    __device__ __forceinline__ int32_t at(int32_t i, int k) const {
        return r[7 * (int64_t)i + k];
    }
    __device__ __forceinline__ int32_t qid(int32_t i) const { return at(i, 0); }
    __device__ __forceinline__ int32_t ns(int32_t i) const { return at(i, 1); }
    __device__ __forceinline__ int32_t obj(int32_t i) const { return at(i, 2); }
    __device__ __forceinline__ int32_t rel(int32_t i) const { return at(i, 3); }
    __device__ __forceinline__ int32_t d(int32_t i) const { return at(i, 4); }
    __device__ __forceinline__ uint8_t skip(int32_t i) const { return at(i, 5) != 0; }
    __device__ __forceinline__ uint8_t force(int32_t i) const { return at(i, 6) != 0; }
    __host__ __device__ int32_t n() const { return rows; }
};

template <class Src>
__device__ __forceinline__ bool child_alive(const Src& ch, int32_t i,
                                            const int32_t* q_found, int32_t nq) {
    int32_t q = ch.qid(i);
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
template <class Src>
__global__ void pack_owner(Src ch, const int32_t* __restrict__ q_found, int32_t nq,
                           int32_t nsb, int32_t relb, int32_t h_slots,
                           int32_t* __restrict__ hslot, int32_t* __restrict__ own) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ch.n()) return;
    int32_t k1 = pack_key(ch.qid(i), ch.ns(i), ch.rel(i), nsb, relb);
    int32_t h = (int32_t)(mix32(k1, ch.obj(i), kPackSalt) & (uint32_t)(h_slots - 1));
    hslot[i] = h;
    if (child_alive(ch, i, q_found, nq)) atomicMax(&own[h], i);
}

// Merge pass: children with the owner's key merge into the slot (max d,
// min skip, max force); survivors are owners and alive non-matching
// colliders.
template <class Src>
__global__ void pack_merge(Src ch, const int32_t* __restrict__ q_found, int32_t nq,
                           int32_t nsb, int32_t relb,
                           const int32_t* __restrict__ hslot,
                           const int32_t* __restrict__ own,
                           int32_t* __restrict__ d_tab, int32_t* __restrict__ skip_tab,
                           int32_t* __restrict__ force_tab,
                           int32_t* __restrict__ surv) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ch.n()) return;
    bool alive = child_alive(ch, i, q_found, nq);
    int32_t h = hslot[i];
    int32_t owner = own[h];
    int32_t oc = clampi(owner, 0, ch.n() - 1);
    bool same = alive &&
                pack_key(ch.qid(oc), ch.ns(oc), ch.rel(oc), nsb, relb) ==
                    pack_key(ch.qid(i), ch.ns(i), ch.rel(i), nsb, relb) &&
                ch.obj(oc) == ch.obj(i);
    if (same) {
        atomicMax(&d_tab[h], ch.d(i));
        atomicMin(&skip_tab[h], (int32_t)ch.skip(i));
        atomicMax(&force_tab[h], (int32_t)ch.force(i));
    }
    bool is_owner = alive && owner == i;
    surv[i] = (is_owner || (alive && !same)) ? 1 : 0;
}

// Emit pass: survivors land at their prefix-sum position; those past the
// frontier mark their query over.  Thread 0 records the next level's
// occupancy (the live items it receives).
template <class Src>
__global__ void pack_emit(Src ch, const int32_t* __restrict__ hslot,
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
    if (i >= ch.n() || !surv[i]) return;
    int32_t p = pos[i];
    int32_t q = ch.qid(i);
    if (p >= out.n) {
        atomicOr(&q_over[clampi(q, 0, nq - 1)], 1);
        return;
    }
    int32_t h = hslot[i];
    bool is_owner = own[h] == i;  // only alive children claim a slot
    out.qid[p] = q;
    out.ns[p] = ch.ns(i);
    out.obj[p] = ch.obj(i);
    out.rel[p] = ch.rel(i);
    out.d[p] = is_owner ? d_tab[h] : ch.d(i);
    out.skip[p] = is_owner ? (uint8_t)(skip_tab[h] != 0) : ch.skip(i);
    out.force[p] = is_owner ? (uint8_t)(force_tab[h] != 0) : ch.force(i);
}

template <class Src>
static int enqueue_pack(Src ch, const int32_t* q_found, const int32_t* q_over_in,
                        int32_t* q_over_out, int32_t nq, int32_t nsb,
                        int32_t relb, int32_t h_slots, int32_t* own,
                        int32_t* d_tab, int32_t* skip_tab, int32_t* force_tab,
                        int32_t* hslot, int32_t* surv, int32_t* pos,
                        int32_t* total, int32_t* block_sums, Items out,
                        int32_t* occ_slot, cudaStream_t stream) {
    cudaMemcpyAsync(q_over_out, q_over_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    const int32_t n = ch.n();
    int32_t fill_n = h_slots > out.n ? h_slots : out.n;
    pack_fill<<<kt_blocks(fill_n, threads), threads, 0, stream>>>(
        h_slots, own, d_tab, skip_tab, force_tab, out);
    // -- grid-wide barrier: the table is empty --
    pack_owner<<<kt_blocks(n, threads), threads, 0, stream>>>(
        ch, q_found, nq, nsb, relb, h_slots, hslot, own);
    // -- grid-wide barrier: every slot's owner is final --
    pack_merge<<<kt_blocks(n, threads), threads, 0, stream>>>(
        ch, q_found, nq, nsb, relb, hslot, own, d_tab, skip_tab, force_tab, surv);
    // -- grid-wide barrier: merges and survivor flags are final --
    enqueue_scan(surv, n, pos, total, block_sums, stream);
    // -- grid-wide barrier: positions and the survivor total are final --
    pack_emit<<<kt_blocks(n, threads), threads, 0, stream>>>(
        ch, hslot, own, d_tab, skip_tab, force_tab, surv, pos, total, nq,
        q_over_out, out, occ_slot);
    return (int)cudaGetLastError();
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
    return enqueue_pack(ColSrc{ch}, q_found, q_over_in, q_over_out, nq, nsb,
                        relb, h_slots, own, d_tab, skip_tab, force_tab, hslot,
                        surv, pos, total, block_sums, out, occ_slot, stream);
}

// The same pack over n_rows routed children ([n_rows, 7] int32 rows, as a
// sharded level receives them); scratch as pack_scatter's with ch.n =
// n_rows.
KT_EXPORT int pack_scatter_rows(const int32_t* rows, int32_t n_rows,
                                const int32_t* q_found, const int32_t* q_over_in,
                                int32_t* q_over_out, int32_t nq, int32_t nsb,
                                int32_t relb, int32_t h_slots, int32_t* own,
                                int32_t* d_tab, int32_t* skip_tab,
                                int32_t* force_tab, int32_t* hslot,
                                int32_t* surv, int32_t* pos, int32_t* total,
                                int32_t* block_sums, Items out,
                                int32_t* occ_slot, cudaStream_t stream) {
    return enqueue_pack(RowSrc{rows, n_rows}, q_found, q_over_in, q_over_out,
                        nq, nsb, relb, h_slots, own, d_tab, skip_tab,
                        force_tab, hslot, surv, pos, total, block_sums, out,
                        occ_slot, stream);
}

// -- K5b: the sort-based pack (fastpath._pack_sort) ---------------------------

// The sort keys of every child, int32[4, n] (qid, ns, rel, obj: a dead
// child -- qid < 0 or its query found -- is (nq, 0, 0, 0), after every live
// one) and the payload d << 2 | skip << 1 | force.
template <class Src>
__global__ void pack_sort_keys_k(Src ch, const int32_t* __restrict__ q_found,
                                 int32_t nq, int32_t* __restrict__ keys,
                                 int32_t* __restrict__ pay) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    const int32_t n = ch.n();
    if (i >= n) return;
    bool alive = child_alive(ch, i, q_found, nq);
    keys[i] = alive ? ch.qid(i) : nq;
    keys[n + i] = alive ? ch.ns(i) : 0;
    keys[2 * (int64_t)n + i] = alive ? ch.rel(i) : 0;
    keys[3 * (int64_t)n + i] = alive ? ch.obj(i) : 0;
    pay[i] = (int32_t)(((uint32_t)ch.d(i) << 2) | ((uint32_t)ch.skip(i) << 1) |
                       (uint32_t)ch.force(i));
}

KT_EXPORT int pack_sort_keys(Items ch, const int32_t* q_found, int32_t nq,
                             int32_t* keys, int32_t* pay, cudaStream_t stream) {
    const int threads = 256;
    pack_sort_keys_k<<<kt_blocks(ch.n, threads), threads, 0, stream>>>(
        ColSrc{ch}, q_found, nq, keys, pay);
    return (int)cudaGetLastError();
}

KT_EXPORT int pack_sort_keys_rows(const int32_t* rows, int32_t n_rows,
                                  const int32_t* q_found, int32_t nq,
                                  int32_t* keys, int32_t* pay,
                                  cudaStream_t stream) {
    const int threads = 256;
    pack_sort_keys_k<<<kt_blocks(n_rows, threads), threads, 0, stream>>>(
        RowSrc{rows, n_rows}, q_found, nq, keys, pay);
    return (int)cudaGetLastError();
}

// first[i]: row i of the sorted children is valid (a live child) and its
// key differs from row i - 1's.
__global__ void pack_sort_first(const int32_t* __restrict__ sq,
                                const int32_t* __restrict__ sns,
                                const int32_t* __restrict__ srel,
                                const int32_t* __restrict__ sobj, int32_t a,
                                int32_t nq, int32_t* __restrict__ first) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a) return;
    bool same = i > 0 && sq[i] == sq[i - 1] && sns[i] == sns[i - 1] &&
                srel[i] == srel[i - 1] && sobj[i] == sobj[i - 1];
    first[i] = (sq[i] < nq && !same) ? 1 : 0;
}

// Each segment's first row merges its segment (the rows after it that are
// valid and not first) and lands at its rank, or marks its query over
// past the frontier.  Thread 0 records the next level's occupancy.
__global__ void pack_sort_emit(const int32_t* __restrict__ sq,
                               const int32_t* __restrict__ sns,
                               const int32_t* __restrict__ srel,
                               const int32_t* __restrict__ sobj,
                               const int32_t* __restrict__ spay, int32_t a,
                               int32_t nq, const int32_t* __restrict__ first,
                               const int32_t* __restrict__ pos,
                               const int32_t* __restrict__ total,
                               int32_t* __restrict__ q_over, Items out,
                               int32_t* __restrict__ occ_slot) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i == 0 && occ_slot != nullptr) {
        int32_t t = *total;
        *occ_slot = t < out.n ? t : out.n;
    }
    if (i >= a || !first[i]) return;
    int32_t p = pos[i];
    int32_t q = sq[i];
    if (p >= out.n) {
        atomicOr(&q_over[clampi(q, 0, nq - 1)], 1);
        return;
    }
    int32_t pay = spay[i];
    int32_t d = pay >> 2, skip = (pay >> 1) & 1, force = pay & 1;
    for (int32_t j = i + 1; j < a && !first[j] && sq[j] < nq; ++j) {
        int32_t pj = spay[j];
        d = max(d, pj >> 2);
        skip = min(skip, (pj >> 1) & 1);
        force = max(force, pj & 1);
    }
    out.qid[p] = q;
    out.ns[p] = sns[i];
    out.obj[p] = sobj[i];
    out.rel[p] = srel[i];
    out.d[p] = d;
    out.skip[p] = (uint8_t)skip;
    out.force[p] = (uint8_t)force;
}

// sq, sns, srel, sobj, spay: the sorted keys and payload of a children
// (lex_sort of pack_sort_keys' output).  Scratch (int32): first, pos [a];
// total [1]; block_sums [ceil(a / 4096)].
KT_EXPORT int pack_sort(const int32_t* sq, const int32_t* sns,
                        const int32_t* srel, const int32_t* sobj,
                        const int32_t* spay, int32_t a,
                        const int32_t* q_over_in, int32_t* q_over_out,
                        int32_t nq, int32_t* first, int32_t* pos,
                        int32_t* total, int32_t* block_sums, Items out,
                        int32_t* occ_slot, cudaStream_t stream) {
    cudaMemcpyAsync(q_over_out, q_over_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    pack_fill<<<kt_blocks(out.n, threads), threads, 0, stream>>>(
        0, nullptr, nullptr, nullptr, nullptr, out);
    pack_sort_first<<<kt_blocks(a, threads), threads, 0, stream>>>(
        sq, sns, srel, sobj, a, nq, first);
    // -- grid-wide barrier: every first flag is written --
    enqueue_scan(first, a, pos, total, block_sums, stream);
    // -- grid-wide barrier: ranks and the survivor total are final --
    pack_sort_emit<<<kt_blocks(a, threads), threads, 0, stream>>>(
        sq, sns, srel, sobj, spay, a, nq, first, pos, total, q_over_out, out,
        occ_slot);
    return (int)cudaGetLastError();
}

// _init_state: roots in slots 0..nq-1 from the packed query block (rows
// ns, obj, rel, subj, depth of nq entries each, then any others) and its
// active row `act`; depth clamped to the level count; the live-root count
// goes to *occ0.  With `assign` (a shard of the mesh), a root is live only
// on the shard it is assigned to (assign[i] == me: _sharded_fast_run's
// act & mine).
__global__ void pack_init_state(const int32_t* __restrict__ qpack,
                                const int32_t* __restrict__ act,
                                const int32_t* __restrict__ assign, int32_t me,
                                int32_t nq, int32_t levels, Items f,
                                int32_t* __restrict__ q_found,
                                int32_t* __restrict__ q_over,
                                int32_t* __restrict__ occ0) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    bool in_q = false;
    if (i < f.n) {
        in_q = i < nq && act[i] != 0 && (assign == nullptr || assign[i] == me);
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

KT_EXPORT int init_state(const int32_t* qpack, const int32_t* act,
                         const int32_t* assign, int32_t me, int32_t nq,
                         int32_t levels, Items f, int32_t* q_found,
                         int32_t* q_over, int32_t* occ0, cudaStream_t stream) {
    cudaMemsetAsync(occ0, 0, sizeof(int32_t), stream);
    const int threads = 256;
    int32_t n = f.n > nq ? f.n : nq;
    pack_init_state<<<kt_blocks(n, threads), threads, 0, stream>>>(
        qpack, act, assign, me, nq, levels, f, q_found, q_over, occ0);
    return (int)cudaGetLastError();
}

// The verdict byte per query (_run_fused_packed :711-724): bit0 found,
// bit1 over, bit2 dirty (an expansion needed a row the overlay marked
// stale).
__global__ void pack_verdict_bytes(const int32_t* __restrict__ q_found,
                                   const int32_t* __restrict__ q_over,
                                   const int32_t* __restrict__ q_dirty,
                                   int32_t nq, uint8_t* __restrict__ out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nq) return;
    out[i] = (uint8_t)((q_found[i] != 0) | ((q_over[i] != 0) << 1) |
                       ((q_dirty[i] != 0) << 2));
}

KT_EXPORT int pack_verdicts(const int32_t* q_found, const int32_t* q_over,
                            const int32_t* q_dirty, int32_t nq, uint8_t* out,
                            cudaStream_t stream) {
    const int threads = 256;
    pack_verdict_bytes<<<kt_blocks(nq, threads), threads, 0, stream>>>(
        q_found, q_over, q_dirty, nq, out);
    return (int)cudaGetLastError();
}
