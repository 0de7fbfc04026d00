// Device Expand (K9): every root's membership walked level by level, one
// record of seven int32 columns per level (parent, subj, node, d, deg,
// root, live) plus a per-root overflow bit; the host replays the
// reference's DFS over the records (engine/expand_device.py::assemble).
//
// Replaces the JAX package's engine/expand_device.py:69 _run_expand (jit
// :68) with :56 _mem_deg inlined, and its overlay branch: only virtual
// nodes (>= ov_nbase) read 0 members; a dirty row keeps its base degree,
// since the host merges the overlay's member deltas into the tree.  The
// node lookup is common.cuh's node_lookup (K1 with K2's ovt_ branch), and
// the arena between levels is K4 (arena.cu).  Plain versions:
// expand_device._expand_roots_plain and _expand_level_plain.
//
// Bound: bytes.  Per level slot: its parent's columns (L2 hits: a level's
// record is at most 65,536 x 7 int32), one mem_row_ptr gather and one
// mem_ord_subj gather at random rows of ~10M-entry arrays, the subject's
// (ns, obj, rel) decode (three gathers into a ~10M-entry table), one node
// probe for a subject-set child, one mem_row_ptr pair for its degree,
// and seven columns plus the ancestor columns written once.  Each slot's
// gathers form a dependent chain (row pointer -> member -> decode ->
// probe -> degree), so a slot is latency-bound; the design keeps one
// thread per slot with the chain in registers, skips the node probe of
// every slot that cannot be expanded (a leaf subject, a dead slot, an
// ancestor cycle), and computes the next level's degrees and arena counts
// in the same pass, so a level is one arena_assign plus one launch.
//
// Ancestor cycle check: the JAX program carries one ancestor column per
// level (the root's subject where live, then each subject-set child's
// subject); a level-l item reads its l + 1 columns at its parent's slot.
// The same columns are carried here ([n_anc, width] int32, -2 = none).
//
// Grid-wide barrier: none inside a launch.  expand_level reads the
// previous level's record, the counts and K4's offsets / slot map, all
// finished earlier in stream order.
#include "common.cuh"

// The expand-only snapshot tables (snapshot.EXPAND_ONLY_KEYS), passed
// beside the check tables' Graph.
struct XTab {
    const int32_t* mem_row_ptr;   // [n_mem_ptr] member CSR over nodes
    const int32_t* mem_ord_subj;  // [n_mem] member subjects, insertion order
    const int32_t* sub_ns;        // [n_sub] subject-set decode, -1 = a SubjectID
    const int32_t* sub_obj;       // [n_sub]
    const int32_t* sub_rel;       // [n_sub]
    int32_t n_mem_ptr, n_mem, n_sub;
};

// The level record's rows (expand_device.REC).
#define R_PARENT 0
#define R_SUBJ 1
#define R_NODE 2
#define R_D 3
#define R_DEG 4
#define R_ROOT 5
#define R_LIVE 6

// expand_device._mem_deg: member-row degree, 0 for node < 0 and for a
// virtual node (no base member row).
__device__ __forceinline__ int32_t mem_deg(const Graph& g, const XTab& x,
                                           int32_t node) {
    int32_t safe = clampi(node, 0, x.n_mem_ptr - 2);
    int32_t deg = x.mem_row_ptr[safe + 1] - x.mem_row_ptr[safe];
    bool ok = node >= 0;
    if (g.has_ov) ok = ok && node < *g.ov_nbase;
    return ok ? deg : 0;
}

// Level 0 (one thread per slot of `width` >= n): the roots' node lookup,
// degrees and arena counts; slots past n are dead padding.
__global__ void k_expand_roots(Graph g, XTab x, const int32_t* __restrict__ roots,
                               int32_t n, int32_t width,
                               int32_t* __restrict__ rec,
                               int32_t* __restrict__ counts,
                               int32_t* __restrict__ anc) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    bool live = i < n;
    int32_t node = -1, subj = -1, d = 0, root = -1;
    if (live) {
        node = node_lookup(g, roots[i], roots[n + i], roots[2 * n + i]);
        subj = roots[3 * n + i];
        d = roots[4 * n + i];
        root = i;
    }
    int32_t deg = live ? mem_deg(g, x, node) : 0;
    rec[R_PARENT * width + i] = -1;
    rec[R_SUBJ * width + i] = subj;
    rec[R_NODE * width + i] = node;
    rec[R_D * width + i] = d;
    rec[R_DEG * width + i] = deg;
    rec[R_ROOT * width + i] = root;
    rec[R_LIVE * width + i] = live ? 1 : 0;
    counts[i] = (live && d >= 2) ? deg : 0;
    anc[i] = live ? subj : -2;
}

// One level (one thread per index t < max(A, C)): thread t first marks
// the root of item t (a level-l item whose members did not all fit) as
// over, in place, then builds arena slot t of level l + 1.
__global__ void k_expand_level(Graph g, XTab x, const int32_t* __restrict__ rec,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ anc, int32_t n_anc,
                               int32_t C, const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ parent,
                               const int32_t* __restrict__ ordinal, int32_t A,
                               int32_t* __restrict__ over, int32_t R,
                               int32_t* __restrict__ rec_out,
                               int32_t* __restrict__ counts_out,
                               int32_t* __restrict__ anc_out) {
    int32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < C) {
        // counts > 0 only for a live item
        int32_t c = counts[t];
        if (c > 0 && offsets[t] + c > A) {
            over[clampi(rec[R_ROOT * C + t], 0, R - 1)] = 1;
        }
    }
    if (t >= A) return;
    const int32_t j = t;
    int32_t ap = parent[j], ao = ordinal[j];
    int32_t aps = clampi(ap, 0, C - 1);
    bool fits = offsets[aps] + counts[aps] <= A;
    bool src_ok = (ap >= 0) && fits;
    int32_t p_node = rec[R_NODE * C + aps];
    int32_t c_subj = -1;
    if (src_ok) {
        int32_t mbase = x.mem_row_ptr[clampi(p_node, 0, x.n_mem_ptr - 2)];
        c_subj = x.mem_ord_subj[clampi(mbase + ao, 0, x.n_mem - 1)];
    }
    int32_t sc = clampi(c_subj, 0, x.n_sub - 1);
    int32_t s_ns = c_subj >= 0 ? x.sub_ns[sc] : -1;
    bool c_is_set = s_ns >= 0;
    bool cyc = false;
    for (int32_t k = 0; k < n_anc; ++k) {
        int32_t a = anc[k * C + aps];
        cyc = cyc || (a == c_subj);
        anc_out[k * A + j] = src_ok ? a : -2;
    }
    anc_out[n_anc * A + j] = (src_ok && c_is_set) ? c_subj : -2;
    cyc = cyc && c_is_set;
    bool expandable = src_ok && c_is_set && !cyc;
    int32_t c_node = -1;
    if (expandable) c_node = node_lookup(g, s_ns, x.sub_obj[sc], x.sub_rel[sc]);
    int32_t pd = rec[R_D * C + aps] - 1;
    int32_t c_d = pd > 0 ? pd : 0;
    int32_t deg = expandable ? mem_deg(g, x, c_node) : 0;
    rec_out[R_PARENT * A + j] = src_ok ? ap : -1;
    rec_out[R_SUBJ * A + j] = c_subj;
    rec_out[R_NODE * A + j] = c_node;
    rec_out[R_D * A + j] = c_d;
    rec_out[R_DEG * A + j] = deg;
    rec_out[R_ROOT * A + j] = src_ok ? rec[R_ROOT * C + aps] : -1;
    rec_out[R_LIVE * A + j] = expandable ? 1 : 0;
    if (counts_out != nullptr) counts_out[j] = (expandable && c_d >= 2) ? deg : 0;
}

// roots: int32[5, n] (ns, obj, rel, subj, depth); rec: int32[7, width];
// counts: int32[width]; anc: int32[1, width].
KT_EXPORT int expand_roots(Graph g, XTab x, const int32_t* roots, int32_t n,
                           int32_t width, int32_t* rec, int32_t* counts,
                           int32_t* anc, cudaStream_t stream) {
    const int threads = 256;
    k_expand_roots<<<kt_blocks(width, threads), threads, 0, stream>>>(
        g, x, roots, n, width, rec, counts, anc);
    return (int)cudaGetLastError();
}

// rec: int32[7, C], counts: int32[C], anc: int32[n_anc, C], offsets:
// int32[C], parent / ordinal: int32[A] (K4's outputs); over: int32[R],
// bits set in place; rec_out: int32[7, A], counts_out: int32[A] or null
// (the last level), anc_out: int32[n_anc + 1, A].
KT_EXPORT int expand_level(Graph g, XTab x, const int32_t* rec,
                           const int32_t* counts, const int32_t* anc,
                           int32_t n_anc, int32_t C, const int32_t* offsets,
                           const int32_t* parent, const int32_t* ordinal,
                           int32_t A, int32_t* over, int32_t R,
                           int32_t* rec_out, int32_t* counts_out,
                           int32_t* anc_out, cudaStream_t stream) {
    const int threads = 256;
    int32_t n = A > C ? A : C;
    k_expand_level<<<kt_blocks(n, threads), threads, 0, stream>>>(
        g, x, rec, counts, anc, n_anc, C, offsets, parent, ordinal, A,
        over, R, rec_out, counts_out, anc_out);
    return (int)cudaGetLastError();
}
