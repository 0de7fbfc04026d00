// The graph-sharded mesh (K10): owner routing and shard merges.
//
// Replaces the JAX package's parallel/graphshard.py:62 shard_of_device
// (engine/algebra.py:117 _shard_owner) as shard_owner, :159 _route as
// shard_route, and the psum merges of :296 _sharded_fast_run and of the
// shard= branch of engine/algebra.py (:718-779 _mi / _mb /
// _merge_classified / _merge_child / _pmax_bool, the q_found psums of
// :597-604 and :626-633) as the three merge entry points below.  The
// collectives themselves (lax.all_to_all, the gathers under lax.psum) are
// device-to-device copies in parallel/graphshard.py: a shard's merge reads
// the n partials gathered onto its own device.  Plain versions:
// graphshard._shard_owner_plain, _shard_route_plain, _merge_bits_plain,
// _merge_classified_plain, _merge_child_plain.
//
// Bound: bytes, and at the served sizes launch latency.  shard_merge reads
// n partial columns and writes one; the owner merges read the owner's
// partial of each column only; the route reads the seven child columns and
// writes its send block.
//
// Determinism: the route ranks each child within its destination by an
// exclusive scan over the n destination flag rows laid end to end
// (csrc/scan.cuh), so a child's slot is its rank in (destination, index)
// order, the order of the reference's stable sort; no slot counter is an
// atomic (that would change which duplicates pack merges and which
// children overflow).  Over bits are int32 0/1 set with atomicOr.  The
// merges sum int32 partials as psum does and compare bool partials with
// > 0, so every output equals the plain version's bit for bit.
#include "scan.cuh"

// engine/optable.py, engine/algebra.py (as csrc/algebra.cu)
constexpr int32_t R_UNKNOWN = 0;
// engine/algebra.py TASK_COLS / AUX_COLS (as csrc/algebra.cu)
enum TaskCol {
    T_KIND, T_NS, T_OBJ, T_REL, T_D, T_SKIP, T_FORCE, T_PROG, T_QID,
    T_VSCOPE, T_PARENT, T_NEG, T_RESOLVED, T_RES, T_COP, T_SEED, T_NCHILD,
    T_FAST_ID, N_TASK_COLS,
};
enum AuxCol {
    A_NODE, A_PROG_ROOT, A_R0, A_DEG, A_PK, A_PP, A_NODE_TTU, A_DIRT,
    A_COUNT, A_ACOUNT, A_EVC, N_AUX_COLS,
};
// the columns a child level's construction writes (TASK_COLS[:12]) and
// which of them are bools
constexpr int kChildCols = 12;
constexpr uint32_t kChildBools = (1u << T_SKIP) | (1u << T_FORCE) | (1u << T_NEG);
// one routed child: qid, ns, obj, rel, d, skip, force (int32 each)
constexpr int kRouteCols = 7;

// -- shard_owner ----------------------------------------------------------------

__global__ void k_shard_owner(const int32_t* __restrict__ ns,
                              const int32_t* __restrict__ obj, int32_t m,
                              int32_t n_shards, int32_t* __restrict__ out) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) out[i] = shard_of(ns[i], obj[i], n_shards);
}

KT_EXPORT int shard_owner(const int32_t* ns, const int32_t* obj, int32_t m,
                          int32_t n_shards, int32_t* out,
                          cudaStream_t stream) {
    const int threads = 256;
    k_shard_owner<<<kt_blocks(m, threads), threads, 0, stream>>>(
        ns, obj, m, n_shards, out);
    return (int)cudaGetLastError();
}

// -- shard_route ----------------------------------------------------------------

// Pass 1: each child's destination (its owner; n for a dead child) and one
// flag per destination row (flags[k * A + i] = dest[i] == k); the send
// block's fills (qid, ns, obj, rel -1; d 0; skip 1; force 0).
__global__ void k_route_flags(Items ch, int32_t n_shards,
                              int32_t* __restrict__ dest,
                              int32_t* __restrict__ flags, int32_t send_rows,
                              int32_t* __restrict__ send) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < ch.n) {
        const int32_t d = ch.qid[i] >= 0 ? shard_of(ch.ns[i], ch.obj[i], n_shards)
                                         : n_shards;
        dest[i] = d;
        for (int32_t k = 0; k < n_shards; ++k)
            flags[(int64_t)k * ch.n + i] = d == k;
    }
    if (i < send_rows) {
        int32_t* row = send + (int64_t)kRouteCols * i;
        row[0] = row[1] = row[2] = row[3] = -1;
        row[4] = 0;
        row[5] = 1;
        row[6] = 0;
    }
}

// Pass 2 (after the scan): the rank of a child within its destination is
// its scan position less the run's start; ranks past cap mark the query
// over, the rest land at row dest * cap + rank.
__global__ void k_route_emit(Items ch, int32_t n_shards, int32_t cap,
                             const int32_t* __restrict__ dest,
                             const int32_t* __restrict__ pos, int32_t nq,
                             int32_t* __restrict__ q_over,
                             int32_t* __restrict__ send) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ch.n) return;
    const int32_t d = dest[i];
    if (d >= n_shards) return;
    const int64_t run = (int64_t)d * ch.n;
    const int32_t rank = pos[run + i] - pos[run];
    const int32_t q = ch.qid[i];
    if (rank >= cap) {
        atomicOr(&q_over[clampi(q, 0, nq - 1)], 1);
        return;
    }
    int32_t* row = send + (int64_t)kRouteCols * ((int64_t)d * cap + rank);
    row[0] = q;
    row[1] = ch.ns[i];
    row[2] = ch.obj[i];
    row[3] = ch.rel[i];
    row[4] = ch.d[i];
    row[5] = ch.skip[i] != 0;
    row[6] = ch.force[i] != 0;
}

// Scratch (int32): dest [A], flags and pos [n * A], total [1], block_sums
// [ceil(n * A / kScanTile)].  send: [n * cap, 7].
KT_EXPORT int shard_route(Items ch, int32_t n_shards, int32_t cap,
                          const int32_t* q_over_in, int32_t* q_over_out,
                          int32_t nq, int32_t* dest, int32_t* flags,
                          int32_t* pos, int32_t* total, int32_t* block_sums,
                          int32_t* send, cudaStream_t stream) {
    cudaMemcpyAsync(q_over_out, q_over_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    const int32_t send_rows = n_shards * cap;
    const int32_t work = ch.n > send_rows ? ch.n : send_rows;
    k_route_flags<<<kt_blocks(work, threads), threads, 0, stream>>>(
        ch, n_shards, dest, flags, send_rows, send);
    // -- grid-wide barrier: every destination flag is written --
    enqueue_scan(flags, n_shards * ch.n, pos, total, block_sums, stream);
    // -- grid-wide barrier: every rank is final --
    k_route_emit<<<kt_blocks(ch.n, threads), threads, 0, stream>>>(
        ch, n_shards, cap, dest, pos, nq, q_over_out, send);
    return (int)cudaGetLastError();
}

// -- shard_merge: psum(x) > 0 over n partial rows ---------------------------------

// stage: [n, k, w] int32 partials; out: [k, w].  Every part contributes
// (the found / over / dirty psums).
__global__ void k_merge_bits(const int32_t* __restrict__ stage, int32_t n,
                             int32_t kw, int32_t* __restrict__ out) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= kw) return;
    int32_t s = 0;
    for (int32_t p = 0; p < n; ++p) s += stage[(int64_t)p * kw + i];
    out[i] = s > 0;
}

KT_EXPORT int shard_merge(const int32_t* stage, int32_t n, int32_t kw,
                          int32_t* out, cudaStream_t stream) {
    const int threads = 256;
    k_merge_bits<<<kt_blocks(kw, threads), threads, 0, stream>>>(stage, n, kw,
                                                                 out);
    return (int)cudaGetLastError();
}

// -- shard_merge_classified: _merge_classified, then the level's epilogue --------

// The GenState fields this kernel writes (a subset of csrc/algebra.cu's
// GenState, passed as plain pointers).
struct MergeState {
    int32_t* tasks;    // [N_TASK_COLS, total]
    int32_t* aux;      // [N_AUX_COLS, total]
    int32_t* q_over;   // [q]
    int32_t* q_dirty;  // [q]
    int32_t total, q;
};

__device__ __forceinline__ int32_t merged(const int32_t* __restrict__ stage,
                                          int32_t cols, int32_t w,
                                          int32_t col, int32_t j,
                                          int32_t owner, bool as_bool) {
    // psum(where(mine, x, 0)) is the owner's partial: read that one only
    const int32_t x = stage[((int64_t)owner * cols + col) * w + j];
    return as_bool ? (x != 0) : x;
}

// One thread per task of the level (columns lo .. lo + w).  stage_t /
// stage_a: [n, N_TASK_COLS, w] / [n, N_AUX_COLS, w], each shard's
// classification of the level; owner: [w] each task's owner shard.  The
// owner's kind, prog, resolved, res, cop, seed, deg, dirt and count stand;
// pp = clip(prog) and pk = p_kind[pp] follow them; then, as the
// unsharded gen_classify does after classifying, the dirt bit into the
// query's dirty bit, the depth cap on the last level, and acount.
__global__ void k_merge_classified(const int32_t* __restrict__ stage_t,
                                   const int32_t* __restrict__ stage_a,
                                   const int32_t* __restrict__ owner,
                                   int32_t w, int32_t lo,
                                   MergeState st,
                                   const int32_t* __restrict__ p_kind,
                                   int32_t n_prog, int32_t last) {
    const int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= w) return;
    const int32_t o = owner[j];
    const int32_t nt = N_TASK_COLS, na = N_AUX_COLS;
    const int32_t kind = merged(stage_t, nt, w, T_KIND, j, o, false);
    const int32_t prog = merged(stage_t, nt, w, T_PROG, j, o, false);
    bool resolved = merged(stage_t, nt, w, T_RESOLVED, j, o, true) != 0;
    int32_t res = merged(stage_t, nt, w, T_RES, j, o, false);
    const int32_t cop = merged(stage_t, nt, w, T_COP, j, o, false);
    const int32_t seed = merged(stage_t, nt, w, T_SEED, j, o, true);
    const int32_t deg = merged(stage_a, na, w, A_DEG, j, o, false);
    const int32_t dirt = merged(stage_a, na, w, A_DIRT, j, o, true);
    const int32_t count = merged(stage_a, na, w, A_COUNT, j, o, false);
    const int32_t pp = clampi(prog, 0, n_prog - 1);

    const int32_t c = lo + j;
    const int64_t T = st.total;
    const int32_t qid = st.tasks[T_QID * T + c];
    const int32_t qc = clampi(qid, 0, st.q - 1);
    if (dirt) atomicOr(&st.q_dirty[qc], 1);
    if (last && qid >= 0 && !resolved && count > 0) {
        // level budget exhausted: UNKNOWN + over
        atomicOr(&st.q_over[qc], 1);
        resolved = true;
        res = R_UNKNOWN;
    }
    st.tasks[T_KIND * T + c] = kind;
    st.tasks[T_PROG * T + c] = prog;
    st.tasks[T_RESOLVED * T + c] = resolved;
    st.tasks[T_RES * T + c] = res;
    st.tasks[T_COP * T + c] = cop;
    st.tasks[T_SEED * T + c] = seed;
    st.aux[A_DEG * T + c] = deg;
    st.aux[A_DIRT * T + c] = dirt;
    st.aux[A_COUNT * T + c] = count;
    st.aux[A_PP * T + c] = pp;
    st.aux[A_PK * T + c] = p_kind[pp];
    st.aux[A_ACOUNT * T + c] = (resolved || qid < 0) ? 0 : count;
}

KT_EXPORT int shard_merge_classified(const int32_t* stage_t,
                                     const int32_t* stage_a,
                                     const int32_t* owner, int32_t w,
                                     int32_t lo, MergeState st,
                                     const int32_t* p_kind, int32_t n_prog,
                                     int32_t last, cudaStream_t stream) {
    const int threads = 256;
    k_merge_classified<<<kt_blocks(w, threads), threads, 0, stream>>>(
        stage_t, stage_a, owner, w, lo, st, p_kind, n_prog, last);
    return (int)cudaGetLastError();
}

// -- shard_merge_child: _merge_child ------------------------------------------------

// One thread per child of the level (columns clo .. clo + w).  stage:
// [n, 12, w], each shard's construction of the level; a child takes the
// values its parent's owner built (owner_par: [n_par], the parent level's
// owners; the parent index is the shard's own, clipped as the reference
// clips it), an empty row those of slot 0's owner.
__global__ void k_merge_child(const int32_t* __restrict__ stage,
                              const int32_t* __restrict__ owner_par,
                              int32_t n_par, int32_t w, int32_t clo,
                              MergeState st) {
    const int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= w) return;
    const int64_t T = st.total;
    const int32_t c = clo + j;
    const int32_t o = owner_par[clampi(st.tasks[T_PARENT * T + c], 0, n_par - 1)];
    int32_t out[kChildCols];
#pragma unroll
    for (int col = 0; col < kChildCols; ++col)
        out[col] = merged(stage, kChildCols, w, col, j, o,
                          (kChildBools >> col) & 1u);
#pragma unroll
    for (int col = 0; col < kChildCols; ++col) st.tasks[col * T + c] = out[col];
}

KT_EXPORT int shard_merge_child(const int32_t* stage, const int32_t* owner_par,
                                int32_t n_par, int32_t w, int32_t clo,
                                MergeState st,
                                cudaStream_t stream) {
    const int threads = 256;
    k_merge_child<<<kt_blocks(w, threads), threads, 0, stream>>>(
        stage, owner_par, n_par, w, clo, st);
    return (int)cudaGetLastError();
}
