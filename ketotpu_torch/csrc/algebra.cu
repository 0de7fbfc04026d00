// Tier 2: the AND/NOT algebra program (K7), one general batch over a
// leveled skeleton kept in one int32 buffer (engine/algebra.py GenState).
//
// Replaces the JAX package's engine/algebra.py (jit :906): :151
// _init_roots + :172 _classify_level (gen_classify), :370
// _construct_level without its prefix sum (gen_construct; the prefix sum is
// K4, csrc/arena.cu), :320 _visited (gen_visited), :534 _collect_fast
// (gen_collect), and the leaf-verdict map-back + up pass of :668
// _general_body (gen_up, gen_pack).  On the graph-sharded mesh (the
// shard= branch, :718-779) each shard classifies without folding its
// dirty bits or capping the last level (gen_classify's `shard`: the owner
// merge in csrc/shard.cu does both after it), gates the visited set on the
// parent's owner (gen_construct's `owner`, :506-507 pmine) and activates
// only the leaves it owns (gen_collect's `n_shards`, :597-604).  The BFS
// sub-run over the leaves (:580
// _fast_subrun) launches the tier-1 kernels of probe.cu, arena.cu,
// children.cu and pack.cu as they are.  Plain versions: the _gen_*_plain
// functions of engine/algebra.py, which reuse the JAX-shaped functions.
// The delta overlay's branches (common.cuh) come in through the probes,
// the degrees of :129 _deg_guarded (dirty and virtual rows read as 0
// edges, the task's dirt bit raised) and the sub-run's dirty leaves
// (:839), which set the query's code bit 3.
//
// Bound: bytes, and at this slice's sizes launch latency.  Per task,
// classification reads the task's columns and gathers a node probe, a
// membership probe and a few table rows (the same dependent DRAM round
// trips as the tier-1 probe); construction gathers one edge or program
// row per arena slot; the rest is a few int32 per task.  The design keeps
// one thread per task (or arena slot) with every intermediate in registers
// and writes each output column once.
//
// Determinism: every cross-thread update is an integer atomic whose result
// does not depend on order (atomicOr of 0/1 flags, atomicAdd of counts,
// atomicMin claims), so every output equals the plain version's bit for
// bit, dead slots included.  Bool flags that the JAX program scatter-maxes
// (q_over, q_dirty) are int32 here and set with atomicOr(…, 1).
//
// Every jnp.select of the reference is an if-chain in the same order
// (first true condition wins).  Every dropped scatter of the reference
// (mode="drop") is a bounds test here.
#include "scan.cuh"

// engine/optable.py
constexpr int32_t P_OR = 0, P_AND = 1, P_NOT = 2, P_CSS = 3, P_TTU = 4,
                  P_BATCHCSS = 5;
constexpr int32_t R_UNKNOWN = 0, R_IS = 1, R_NOT = 2, R_ERR = 3;
constexpr int32_t OP_OR = 0, OP_AND = 1, OP_NOT = 2, OP_PASS = 3;
constexpr int32_t K_CHECK = 0, K_PROG = 1, K_FAST = 2;
constexpr int32_t I32MAX = 0x7fffffff;
constexpr int kVProbe = 8;  // algebra.VPROBE

// engine/algebra.py TASK_COLS and AUX_COLS, in order.
enum TaskCol {
    T_KIND, T_NS, T_OBJ, T_REL, T_D, T_SKIP, T_FORCE, T_PROG, T_QID,
    T_VSCOPE, T_PARENT, T_NEG, T_RESOLVED, T_RES, T_COP, T_SEED, T_NCHILD,
    T_FAST_ID,
};
enum AuxCol {
    A_NODE, A_PROG_ROOT, A_R0, A_DEG, A_PK, A_PP, A_NODE_TTU, A_DIRT,
    A_COUNT, A_ACOUNT, A_EVC,
};

// The rewrite-program and routing tables (Snapshot.check_arrays names).
struct Prog {
    const int32_t* p_kind;       // [P]
    const int32_t* p_a;          // [P] CSS rel / TTU via-rel / batch row
    const int32_t* p_b;          // [P] TTU computed rel
    const int32_t* p_child_ptr;  // [P + 1]
    const int32_t* p_child_idx;  // [C]
    const int32_t* p_child_dec;  // [C]
    const uint8_t* p_child_neg;  // [C]
    const int32_t* b_ptr;        // [NB]
    const int32_t* b_rel;        // [BT]
    const uint8_t* b_probe;      // [BT]
    const int32_t* prog_root;    // [NS, R]
    const uint8_t* rel_err;      // [NS, R]
    const uint8_t* err_reach;    // [NS, R]
    const uint8_t* taint;        // [NS, R]
    int32_t n_prog, n_child, n_bptr, n_brel;
};

// One dispatch's state (algebra.GenState; kernels.py mirrors it).
struct GenState {
    int32_t* tasks;      // [len(TASK_COLS), total]
    int32_t* aux;        // [len(AUX_COLS), total]
    int32_t* cnt;        // [3, total]: IS / NOT / ERR child counts
    int32_t* vset;       // [4, vs]
    int32_t* q_over;     // [q]
    int32_t* q_dirty;    // [q]
    Items leaves;        // [B] the sub-run's level 0
    int32_t* leaf_subj;  // [B]
    uint8_t* codes;      // [q]
    int32_t* occ;        // [depth + 2 + n_sched]
    int32_t total, vs, q, depth, n_sched;
};

__device__ __forceinline__ int32_t& TK(const GenState& s, int col, int32_t c) {
    return s.tasks[(int64_t)col * s.total + c];
}
__device__ __forceinline__ int32_t& AX(const GenState& s, int col, int32_t c) {
    return s.aux[(int64_t)col * s.total + c];
}

// -- gen_classify: _init_roots + _classify_level (+ the depth cap) ------------

// One thread per task of the level (columns lo .. lo + n).  With qpack the
// level is the roots, built first (level 0, n == q) from its rows ns, obj,
// rel, depth and the active row `act`.  The level's live
// count goes to occ[level] (one atomicAdd per block).  With `shard` the
// dirty fold and the depth cap wait for the owner merge.
__global__ void k_gen_classify(Graph g, Prog p, GenState st, int32_t lo,
                               int32_t n, int32_t level,
                               const int32_t* __restrict__ q_subj,
                               const int32_t* __restrict__ qpack,
                               const int32_t* __restrict__ act_row,
                               int32_t last, int32_t shard) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    bool live_slot = false;
    if (i < n) {
        const int32_t c = lo + i;
        int32_t kind, ns, obj, rel, d, prog, qid;
        bool skip, force;
        if (qpack != nullptr) {
            const int32_t q = st.q;
            bool act = act_row[i] != 0;
            kind = K_CHECK;
            ns = act ? qpack[i] : -1;
            obj = act ? qpack[q + i] : -1;
            rel = act ? qpack[2 * q + i] : -1;
            d = act ? qpack[4 * q + i] : 0;
            skip = force = false;
            prog = -1;
            qid = act ? i : -1;
            TK(st, T_KIND, c) = kind;
            TK(st, T_NS, c) = ns;
            TK(st, T_OBJ, c) = obj;
            TK(st, T_REL, c) = rel;
            TK(st, T_D, c) = d;
            TK(st, T_SKIP, c) = 0;
            TK(st, T_FORCE, c) = 0;
            TK(st, T_PROG, c) = -1;
            TK(st, T_QID, c) = qid;
            TK(st, T_VSCOPE, c) = -1;
            TK(st, T_PARENT, c) = -1;
            TK(st, T_NEG, c) = 0;
        } else {
            kind = TK(st, T_KIND, c);
            ns = TK(st, T_NS, c);
            obj = TK(st, T_OBJ, c);
            rel = TK(st, T_REL, c);
            d = TK(st, T_D, c);
            skip = TK(st, T_SKIP, c) != 0;
            force = TK(st, T_FORCE, c) != 0;
            prog = TK(st, T_PROG, c);
            qid = TK(st, T_QID, c);
        }
        const int32_t NS = g.ns_dim, R = g.rel_dim;
        const bool active = qid >= 0;
        live_slot = active;
        const int32_t nr = clampi(ns, 0, NS - 1) * R + clampi(rel, 0, R - 1);
        const bool cfg = (ns >= 0) & (ns < NS) & (rel >= 0) & (rel < R);
        const int32_t subj = q_subj[clampi(qid, 0, st.q - 1)];

        bool is_check = active && kind == K_CHECK;
        bool is_prog = active && kind == K_PROG;
        const bool is_fast = active && kind == K_FAST;

        // tree CHECK: rel-err, rewrite root, direct/forced probe, edges
        const bool err = is_check && cfg && p.rel_err[nr] != 0;
        const int32_t prog_root = cfg ? p.prog_root[nr] : -1;
        const bool has_rw = prog_root >= 0;
        const int32_t node = node_lookup(g, ns, obj, rel);
        const bool dok = (cfg ? g.direct_ok[nr] != 0 : true) && !skip;
        const bool eok = cfg ? g.expand_ok[nr] != 0 : true;
        // only CHECK and FAST tasks read the membership bit
        const bool mem = (is_check || is_fast) && node >= 0 && subj >= 0 &&
                         member(g, node, subj);
        const bool seed = is_check && mem && (force || (dok && d >= 2));
        const bool exp_read = (is_check || is_fast) && eok && d >= 2;
        // _deg_guarded: dirty and virtual rows read as 0 edges
        bool node_nd = false;
        const int32_t deg = exp_read ? row_deg_ov(g, node, &node_nd) : 0;
        bool dirt = exp_read && node_nd;
        const bool errable = cfg && p.err_reach[nr] != 0;
        const int32_t chk_count = d >= 1 ? (has_rw ? 1 : 0) + deg : 0;
        const bool triv = is_fast && !has_rw && deg == 0;
        const bool found_t = mem && (force || (dok && d >= 2));

        // root-prog adoption: OR-of-one becomes the program root in place
        const bool adopt =
            is_check && !err && !seed && has_rw && deg == 0 && d >= 1;
        is_check = is_check && !adopt;
        is_prog = is_prog || adopt;
        const int32_t prog_eff = adopt ? prog_root : prog;

        // rewrite-program nodes
        const int32_t pp = clampi(prog_eff, 0, p.n_prog - 1);
        const int32_t pk = p.p_kind[pp];
        const int32_t p_deg = p.p_child_ptr[pp + 1] - p.p_child_ptr[pp];
        const int32_t pa = p.p_a[pp];
        const int32_t node_ttu = node_lookup(g, ns, obj, pa);
        bool ttu_nd = false;
        const int32_t ttu_deg = is_prog ? row_deg_ov(g, node_ttu, &ttu_nd) : 0;
        const int32_t browc = clampi(pa, 0, p.n_bptr - 2);
        const int32_t b_deg = p.b_ptr[browc + 1] - p.b_ptr[browc];
        const bool p_oan = is_prog && (pk == P_OR || pk == P_AND);
        const bool p_not = is_prog && pk == P_NOT;
        const bool p_css = is_prog && pk == P_CSS;
        const bool p_ttu = is_prog && pk == P_TTU;
        const bool p_bat = is_prog && pk == P_BATCHCSS;
        dirt = dirt || (p_ttu && ttu_nd);

        // depth guards: <=0 for check/or/and, <0 for NOT/CSS/TTU
        const bool guard = ((is_check || p_oan) && d <= 0) ||
                           ((p_not || p_css || p_ttu) && d < 0);
        int32_t count;
        if (is_check) count = chk_count;
        else if (p_oan) count = p_deg;
        else if (p_not || p_css) count = 1;
        else if (p_ttu) count = ttu_deg;
        else if (p_bat) count = b_deg;
        else count = 0;

        // resolution: guard, then err, then probes, then empty-group NOT
        const bool guard_is = is_check && d <= 0 && force && mem;
        const bool r_guard = guard && !guard_is;
        const bool r_err = err && !guard;
        const bool r_short = is_check && !guard && !err && seed && !errable;
        const bool leaf = r_guard || guard_is || r_err || r_short;
        if (leaf || !active) count = 0;
        const bool r_empty = (is_check || is_prog) && !leaf && count == 0;
        bool resolved = leaf || r_empty;
        int32_t res;
        if (r_err) res = R_ERR;
        else if (guard_is || r_short || (r_empty && seed)) res = R_IS;
        else if (r_guard) res = R_UNKNOWN;
        else res = r_empty ? R_NOT : R_UNKNOWN;
        if (triv) res = found_t ? R_IS : (d >= 1 ? R_NOT : R_UNKNOWN);
        resolved = resolved || triv;
        int32_t cop;
        if (p_oan && pk == P_AND) cop = OP_AND;
        else if (p_not) cop = OP_NOT;
        else if (p_css) cop = OP_PASS;
        else cop = OP_OR;

        const int32_t qc = clampi(qid, 0, st.q - 1);
        // the seed column is the classification's (before any depth cap)
        const bool seed_out = seed && !resolved;
        if (dirt && !shard) atomicOr(&st.q_dirty[qc], 1);
        if (last && !shard && qid >= 0 && !resolved && count > 0) {
            // level budget exhausted: UNKNOWN + over (K_FAST tasks have
            // count 0 and stay for the sub-run)
            atomicOr(&st.q_over[qc], 1);
            resolved = true;
            res = R_UNKNOWN;
        }

        TK(st, T_KIND, c) = adopt ? K_PROG : kind;
        TK(st, T_PROG, c) = prog_eff;
        TK(st, T_RESOLVED, c) = resolved;
        TK(st, T_RES, c) = res;
        TK(st, T_COP, c) = cop;
        TK(st, T_SEED, c) = seed_out;
        TK(st, T_NCHILD, c) = 0;
        TK(st, T_FAST_ID, c) = -1;
        AX(st, A_NODE, c) = node;
        AX(st, A_PROG_ROOT, c) = prog_root;
        AX(st, A_R0, c) = has_rw && d >= 1;
        AX(st, A_DEG, c) = deg;
        AX(st, A_PK, c) = pk;
        AX(st, A_PP, c) = pp;
        AX(st, A_NODE_TTU, c) = node_ttu;
        AX(st, A_DIRT, c) = dirt;
        AX(st, A_COUNT, c) = count;
        AX(st, A_ACOUNT, c) = (resolved || qid < 0) ? 0 : count;
    }
    int32_t live = __syncthreads_count(live_slot);
    if (threadIdx.x == 0 && live) atomicAdd(&st.occ[level], live);
}

// -- gen_construct: _construct_level after K4, before the visited set ----------

// Threads i < n update parent i of level lo (over / UNKNOWN / child count);
// threads j < a build child j of level clo from K4's (offsets, parent,
// ordinal).  Child threads read only parent fields no thread writes here.
// With `owner` (the parent level's owner shards; this is shard `me`) only
// the children of parents this shard owns enter the visited set.
__global__ void k_gen_construct(Graph g, Prog p, GenState st, int32_t lo,
                                int32_t n, int32_t clo, int32_t a,
                                const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ parent,
                                const int32_t* __restrict__ ordinal,
                                int32_t max_width,
                                const int32_t* __restrict__ owner,
                                int32_t me) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        const int32_t c = lo + i;
        const int32_t counts = AX(st, A_ACOUNT, c);
        const bool fits = offsets[i] + counts <= a;
        const bool overp = counts > 0 && !fits;
        if (overp) {
            atomicOr(&st.q_over[clampi(TK(st, T_QID, c), 0, st.q - 1)], 1);
            TK(st, T_RESOLVED, c) = 1;
            TK(st, T_RES, c) = R_UNKNOWN;
        }
        TK(st, T_NCHILD, c) = fits ? counts : 0;
    }
    if (i >= a) return;
    const int32_t j = i;
    const int32_t ap = parent[j], ao = ordinal[j];
    const int32_t aps = clampi(ap, 0, n - 1);
    const int32_t pc = lo + aps;
    const bool fits_p = offsets[aps] + AX(st, A_ACOUNT, pc) <= a;
    const int32_t pqid = TK(st, T_QID, pc);
    const bool valid = ap >= 0 && fits_p && pqid >= 0;

    const int32_t pkind = TK(st, T_KIND, pc);
    const int32_t ppk = AX(st, A_PK, pc);
    const int32_t r0 = AX(st, A_R0, pc);
    const int32_t pns = TK(st, T_NS, pc), pobj = TK(st, T_OBJ, pc);
    const int32_t prel = TK(st, T_REL, pc), pd = TK(st, T_D, pc);
    const int32_t pvs = TK(st, T_VSCOPE, pc);
    const int32_t pp = AX(st, A_PP, pc);
    const int32_t ppa = p.p_a[pp], ppb = p.p_b[pp];

    const bool c_rw = valid && pkind == K_CHECK && ao < r0;
    const bool c_edge = valid && pkind == K_CHECK && ao >= r0;
    const bool c_prog = valid && pkind == K_PROG;
    const bool c_oan = c_prog && (ppk == P_OR || ppk == P_AND || ppk == P_NOT);
    const bool c_css = c_prog && ppk == P_CSS;
    const bool c_ttu = c_prog && ppk == P_TTU;
    const bool c_bat = c_prog && ppk == P_BATCHCSS;

    // edge gathers (expansion rows for CHECK parents, via-rows for TTU)
    const int32_t rmax = g.n_row_ptr - 2;
    const int32_t eo = ao - r0;
    const int32_t base_exp = g.row_ptr[clampi(AX(st, A_NODE, pc), 0, rmax)];
    const int32_t base_ttu = g.row_ptr[clampi(AX(st, A_NODE_TTU, pc), 0, rmax)];
    const int32_t eidx =
        clampi(c_ttu ? base_ttu + ao : base_exp + eo, 0, g.n_edges - 1);
    const int32_t e_hi = g.edge_hi[eidx], e_obj = g.edge_obj[eidx];
    const int32_t R = g.rel_dim;
    const int32_t e_ns = e_hi >= 0 ? e_hi / R : -1;
    const int32_t e_rel = e_hi >= 0 ? e_hi % R : -1;

    // program CSR gathers; a P_CSS child collapses into its subcheck
    const int32_t pci = clampi(p.p_child_ptr[pp] + ao, 0, p.n_child - 1);
    const int32_t prog_child = p.p_child_idx[pci];
    const int32_t prog_dec = p.p_child_dec[pci];
    const bool prog_neg = p.p_child_neg[pci] != 0;
    const int32_t pcc = clampi(prog_child, 0, p.n_prog - 1);
    const bool c_cssdir = c_oan && p.p_kind[pcc] == P_CSS;
    const int32_t css_dir_rel = p.p_a[pcc];

    // batched-CSS row gathers
    const int32_t bi =
        clampi(p.b_ptr[clampi(ppa, 0, p.n_bptr - 2)] + ao, 0, p.n_brel - 1);
    const int32_t brel = p.b_rel[bi];
    const bool bprobe = p.b_probe[bi] != 0;

    const int32_t ch_ns = (c_edge || c_ttu) ? e_ns : pns;
    const int32_t ch_obj = (c_edge || c_ttu) ? e_obj : pobj;
    int32_t ch_rel;
    if (c_edge) ch_rel = e_rel;
    else if (c_ttu) ch_rel = ppb;
    else if (c_css) ch_rel = ppa;
    else if (c_bat) ch_rel = brel;
    else if (c_cssdir) ch_rel = css_dir_rel;
    else ch_rel = prel;
    int32_t ch_d;
    if (c_edge || c_ttu || c_bat) ch_d = pd - 1;
    else if (c_oan) ch_d = pd - prog_dec;
    else ch_d = pd;
    int32_t ch_prog;
    if (c_rw) ch_prog = AX(st, A_PROG_ROOT, pc);
    else if (c_oan && !c_cssdir) ch_prog = prog_child;
    else ch_prog = -1;
    const bool ch_skip = c_edge || c_bat;
    const bool ch_force = c_edge || (c_bat && bprobe);
    const bool ch_neg = c_oan && prog_neg;
    const int32_t ch_vscope = (c_edge && pvs < 0) ? lo + aps : pvs;

    // tainted subchecks stay tree CHECKs, pure ones become fast leaves
    const int32_t NS = g.ns_dim;
    const bool in_cfg = ch_ns >= 0 && ch_ns < NS && ch_rel >= 0 && ch_rel < R;
    const bool tainted =
        in_cfg &&
        p.taint[clampi(ch_ns, 0, NS - 1) * R + clampi(ch_rel, 0, R - 1)] != 0;
    int32_t ch_kind = (c_rw || (c_oan && !c_cssdir))
                          ? K_PROG
                          : (tainted ? K_CHECK : K_FAST);
    // width truncation: probe-only leaves at depth 0
    const bool trunc =
        c_edge && AX(st, A_DEG, pc) > max_width && eo >= max_width - 1;
    if (trunc) {
        ch_kind = K_FAST;
        ch_d = 0;
    }

    const int32_t cc = clo + j;
    TK(st, T_KIND, cc) = valid ? ch_kind : 0;
    TK(st, T_NS, cc) = valid ? ch_ns : -1;
    TK(st, T_OBJ, cc) = valid ? ch_obj : -1;
    TK(st, T_REL, cc) = valid ? ch_rel : -1;
    TK(st, T_D, cc) = valid ? ch_d : 0;
    TK(st, T_SKIP, cc) = valid && ch_skip;
    TK(st, T_FORCE, cc) = valid && ch_force;
    TK(st, T_PROG, cc) = valid ? ch_prog : -1;
    TK(st, T_QID, cc) = valid ? pqid : -1;
    TK(st, T_VSCOPE, cc) = valid ? ch_vscope : -1;
    TK(st, T_PARENT, cc) = valid ? ap : -1;
    TK(st, T_NEG, cc) = valid && ch_neg;
    AX(st, A_EVC, cc) = c_edge && !trunc && (owner == nullptr || owner[aps] == me);
}

// -- gen_visited: _visited over one constructed level ---------------------------

constexpr int kVisitedThreads = 1024;
constexpr int kVisitedSmemSlots = 32768;  // kernels.VISITED_SMEM_SLOTS

__device__ __forceinline__ bool vmatch(const GenState& s, int32_t slot,
                                       int32_t k1, int32_t k2, int32_t k3,
                                       int32_t k4) {
    const int32_t vs = s.vs;
    return s.vset[slot] == k1 && s.vset[vs + slot] == k2 &&
           s.vset[2 * vs + slot] == k3 && s.vset[3 * vs + slot] == k4;
}

// One block.  The reference runs kVProbe synchronous rounds over all keys:
// every pending key reads its slot (a match marks it seen), claims an empty
// slot by scatter-min of its arena index, the least index writes its key,
// and the losers re-match.  Block barriers separate the phases of a round
// (read + claim | win + write | reset + re-match), so the table and the
// seen / pending bits are the reference's.  Per key: hbuf = its hash, flags
// = bit 0 pending, bit 1 seen, bit 2 claimed this round.  The claim array
// lives in shared memory (vs <= kVisitedSmemSlots, which the wrapper
// checks).
__global__ void __launch_bounds__(kVisitedThreads)
k_gen_visited(GenState st, int32_t lo, int32_t a, int32_t* __restrict__ hbuf,
              int32_t* __restrict__ flags) {
    extern __shared__ int32_t claim[];
    const int32_t vs = st.vs;
    const uint32_t mask = (uint32_t)(vs - 1);
    const int tid = threadIdx.x, bs = blockDim.x;
    for (int32_t k = tid; k < vs; k += bs) claim[k] = I32MAX;
    for (int32_t j = tid; j < a; j += bs) {
        const int32_t c = lo + j;
        const bool evc = AX(st, A_EVC, c) != 0;
        const int32_t k1 = evc ? TK(st, T_VSCOPE, c) : I32MAX;
        const int32_t k2 = evc ? TK(st, T_NS, c) : I32MAX;
        const int32_t k3 = evc ? TK(st, T_OBJ, c) : I32MAX;
        const int32_t k4 = evc ? TK(st, T_REL, c) : I32MAX;
        const uint32_t h = mix32((int32_t)mix32(k1, k2, kSalts[0]),
                                 (int32_t)mix32(k3, k4, kSalts[1]), kSalts[2]);
        hbuf[j] = (int32_t)(h & mask);
        flags[j] = evc ? 1 : 0;
    }
    __syncthreads();
    for (int round = 0; round < kVProbe; ++round) {
        // phase 1: match, or claim an empty slot
        for (int32_t j = tid; j < a; j += bs) {
            int32_t f = flags[j];
            if (!(f & 1)) continue;
            const int32_t c = lo + j;
            const int32_t slot = (int32_t)((uint32_t)(hbuf[j] + round) & mask);
            if (vmatch(st, slot, TK(st, T_VSCOPE, c), TK(st, T_NS, c),
                       TK(st, T_OBJ, c), TK(st, T_REL, c))) {
                flags[j] = 2;
            } else if (st.vset[slot] == I32MAX) {
                atomicMin(&claim[slot], j);
                flags[j] = f | 4;
            }
        }
        __syncthreads();
        // phase 2: the least claimant of each slot writes its key
        for (int32_t j = tid; j < a; j += bs) {
            if (!(flags[j] & 4)) continue;
            const int32_t slot = (int32_t)((uint32_t)(hbuf[j] + round) & mask);
            if (claim[slot] == j) {
                const int32_t c = lo + j;
                st.vset[slot] = TK(st, T_VSCOPE, c);
                st.vset[vs + slot] = TK(st, T_NS, c);
                st.vset[2 * vs + slot] = TK(st, T_OBJ, c);
                st.vset[3 * vs + slot] = TK(st, T_REL, c);
                flags[j] = 4;  // inserted: neither pending nor seen
            }
        }
        __syncthreads();
        // phase 3: reset the claims; pending keys re-match (a loser whose
        // key the winner wrote is a duplicate)
        for (int32_t j = tid; j < a; j += bs) {
            int32_t f = flags[j];
            const int32_t slot = (int32_t)((uint32_t)(hbuf[j] + round) & mask);
            if (f & 4) {
                claim[slot] = I32MAX;
                f &= ~4;
            }
            if (f & 1) {
                const int32_t c = lo + j;
                if (vmatch(st, slot, TK(st, T_VSCOPE, c), TK(st, T_NS, c),
                           TK(st, T_OBJ, c), TK(st, T_REL, c))) {
                    f = 2;
                }
            }
            flags[j] = f;
        }
        __syncthreads();
    }
    // duplicates and keys that found no slot become probe-only leaves; a
    // key that found no slot marks its query over
    for (int32_t j = tid; j < a; j += bs) {
        const int32_t f = flags[j];
        if (!(f & 3)) continue;
        const int32_t c = lo + j;
        if (f & 1) atomicOr(&st.q_over[clampi(TK(st, T_QID, c), 0, st.q - 1)], 1);
        TK(st, T_KIND, c) = K_FAST;
        TK(st, T_D, c) = 0;
    }
}

// -- gen_collect: _collect_fast over every level at once --------------------------

// The leaf mask of every task of every level (the levels are consecutive
// column ranges, so one scan gives each leaf the reference's running base).
// On a shard of the mesh (n_shards > 0) the live-leaf count starts at 0.
__global__ void k_gen_leaf_mask(GenState st, int32_t* __restrict__ m,
                                int32_t n_shards) {
    const int32_t c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c == 0 && n_shards > 0) st.occ[st.depth + 2] = 0;
    if (c >= st.total) return;
    m[c] = TK(st, T_KIND, c) == K_FAST && TK(st, T_QID, c) >= 0 &&
           TK(st, T_RESOLVED, c) == 0;
}

// Leaves land at their scan position (their slot id written back); those
// past the buffer resolve UNKNOWN + over; slots past the leaf count get
// the buffer's empty values.  occ[D + 1] = leaves, occ[D + 2] = placed.
// On shard `me` of an n_shards mesh a placed leaf is live (its slot id as
// its query) only if this shard owns its (ns, obj), and occ[D + 2] counts
// the live ones.
// One leaf of k_gen_leaf_emit (column c of the mask); returns whether it
// is live.
__device__ bool emit_leaf(GenState st, const int32_t* __restrict__ q_subj,
                          const int32_t* __restrict__ pos, int32_t c, int32_t b,
                          int32_t n_shards, int32_t me) {
    const int32_t p = pos[c];
    const int32_t qid = TK(st, T_QID, c);
    if (p >= b) {
        atomicOr(&st.q_over[clampi(qid, 0, st.q - 1)], 1);
        TK(st, T_RESOLVED, c) = 1;
        TK(st, T_RES, c) = R_UNKNOWN;
        return false;
    }
    int32_t d = TK(st, T_D, c);
    d = d < 0 ? 0 : d;
    const int32_t ns = TK(st, T_NS, c), obj = TK(st, T_OBJ, c);
    const bool live = n_shards <= 0 || shard_of(ns, obj, n_shards) == me;
    st.leaves.qid[p] = live ? p : -1;
    st.leaves.ns[p] = ns;
    st.leaves.obj[p] = obj;
    st.leaves.rel[p] = TK(st, T_REL, c);
    st.leaves.d[p] = d < st.n_sched ? d : st.n_sched;
    st.leaves.skip[p] = TK(st, T_SKIP, c) != 0;
    st.leaves.force[p] = TK(st, T_FORCE, c) != 0;
    st.leaf_subj[p] = q_subj[clampi(qid, 0, st.q - 1)];
    TK(st, T_FAST_ID, c) = p;
    return live;
}

__global__ void k_gen_leaf_emit(GenState st, const int32_t* __restrict__ q_subj,
                                const int32_t* __restrict__ m,
                                const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ total,
                                int32_t n_shards, int32_t me) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    const int32_t b = st.leaves.n;
    const int32_t tot = *total;
    if (i == 0) {
        st.occ[st.depth + 1] = tot;
        if (n_shards <= 0) st.occ[st.depth + 2] = tot < b ? tot : b;
    }
    if (i < b && i >= tot) {
        st.leaves.qid[i] = -1;
        st.leaves.ns[i] = -1;
        st.leaves.obj[i] = -1;
        st.leaves.rel[i] = -1;
        st.leaves.d[i] = 0;
        st.leaves.skip[i] = 0;
        st.leaves.force[i] = 0;
        st.leaf_subj[i] = 0;
    }
    bool live = false;
    if (i < st.total && m[i]) live = emit_leaf(st, q_subj, pos, i, b, n_shards, me);
    if (n_shards > 0) {
        const int32_t placed = __syncthreads_count(live);
        if (threadIdx.x == 0 && placed) atomicAdd(&st.occ[st.depth + 2], placed);
    }
}

// -- gen_up: leaf verdicts, combiners, counts into the parents -------------------

// One thread per task of level `level` (columns lo .. lo + n); the
// parents' level is plo .. plo + pn.  All counts into this level were
// added by the previous launch (the level below).
__global__ void k_gen_up(GenState st, int32_t lo, int32_t n, int32_t level,
                         int32_t plo, int32_t pn,
                         const int32_t* __restrict__ found,
                         const int32_t* __restrict__ fover,
                         const int32_t* __restrict__ fdirty) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int32_t c = lo + i;
    const int32_t qid = TK(st, T_QID, c);
    const int32_t fid = TK(st, T_FAST_ID, c);
    int32_t res = TK(st, T_RES, c);
    bool resolved = TK(st, T_RESOLVED, c) != 0;
    if (fid >= 0) {
        // pure-OR leaves with depth >= 1 are exactly IS / NOT; depth <= 0
        // is the root guard UNKNOWN unless a forced probe hit
        const int32_t fc = clampi(fid, 0, st.leaves.n - 1);
        const int32_t d = TK(st, T_D, c);
        res = found[fc] != 0 ? R_IS : (d >= 1 ? R_NOT : R_UNKNOWN);
        resolved = true;
        if (fover[fc] != 0) atomicOr(&st.q_over[clampi(qid, 0, st.q - 1)], 1);
        // an unfound leaf whose sub-run needed a dirty row: host oracle
        if (fdirty[fc] != 0 && found[fc] == 0)
            atomicOr(&st.q_dirty[clampi(qid, 0, st.q - 1)], 1);
    }
    if (level < st.depth && qid >= 0 && !resolved) {
        const int32_t nis = st.cnt[c];
        const int32_t nnot = st.cnt[(int64_t)st.total + c];
        const int32_t nerr = st.cnt[2 * (int64_t)st.total + c];
        const int32_t cop = TK(st, T_COP, c);
        if (nerr > 0) res = R_ERR;
        else if (cop == OP_AND) res = nis == TK(st, T_NCHILD, c) ? R_IS : R_NOT;
        else if (cop == OP_NOT) res = nis > 0 ? R_NOT : (nnot > 0 ? R_IS : R_UNKNOWN);
        else if (cop == OP_PASS) res = nis > 0 ? R_IS : (nnot > 0 ? R_NOT : R_UNKNOWN);
        else res = (nis > 0 || TK(st, T_SEED, c) != 0) ? R_IS : R_NOT;
        resolved = true;
    }
    TK(st, T_RES, c) = res;
    TK(st, T_RESOLVED, c) = resolved;
    if (level > 0 && qid >= 0) {
        // folded-NOT parity flips IS / NOT on delivery; UNKNOWN, ERR pass
        const bool neg = TK(st, T_NEG, c) != 0;
        const int32_t pt = plo + clampi(TK(st, T_PARENT, c), 0, pn - 1);
        const bool eff_is = neg ? res == R_NOT : res == R_IS;
        const bool eff_not = neg ? res == R_IS : res == R_NOT;
        if (eff_is) atomicAdd(&st.cnt[pt], 1);
        if (eff_not) atomicAdd(&st.cnt[(int64_t)st.total + pt], 1);
        if (res == R_ERR) atomicAdd(&st.cnt[2 * (int64_t)st.total + pt], 1);
    }
}

// The code byte of each query: bits 0-1 the root's result, bit 2 over,
// bit 3 dirty.
__global__ void k_gen_pack(GenState st) {
    const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= st.q) return;
    st.codes[i] = (uint8_t)(TK(st, T_RES, i) | ((st.q_over[i] != 0) << 2) |
                            ((st.q_dirty[i] != 0) << 3));
}

// -- entry points -------------------------------------------------------------------

constexpr int kThreads = 256;

KT_EXPORT int gen_classify(Graph g, Prog p, GenState st, int32_t lo, int32_t n,
                           int32_t level, const int32_t* q_subj,
                           const int32_t* qpack, const int32_t* act,
                           int32_t last, int32_t shard, cudaStream_t stream) {
    k_gen_classify<<<kt_blocks(n, kThreads), kThreads, 0, stream>>>(
        g, p, st, lo, n, level, q_subj, qpack, act, last, shard);
    return (int)cudaGetLastError();
}

KT_EXPORT int gen_construct(Graph g, Prog p, GenState st, int32_t lo,
                            int32_t n, int32_t clo, int32_t a,
                            const int32_t* offsets, const int32_t* parent,
                            const int32_t* ordinal, int32_t max_width,
                            const int32_t* owner, int32_t me,
                            cudaStream_t stream) {
    const int32_t work = n > a ? n : a;
    k_gen_construct<<<kt_blocks(work, kThreads), kThreads, 0, stream>>>(
        g, p, st, lo, n, clo, a, offsets, parent, ordinal, max_width, owner, me);
    return (int)cudaGetLastError();
}

// Scratch: hf holds 2 x a int32 (hashes, flags).  Needs st.vs <=
// kVisitedSmemSlots.
KT_EXPORT int gen_visited(GenState st, int32_t lo, int32_t a, int32_t* hf,
                          cudaStream_t stream) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(k_gen_visited,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kVisitedSmemSlots * (int)sizeof(int32_t));
        attr_set = true;
    }
    const size_t smem = (size_t)st.vs * sizeof(int32_t);
    k_gen_visited<<<1, kVisitedThreads, smem, stream>>>(st, lo, a, hf, hf + a);
    return (int)cudaGetLastError();
}

// Scratch: m and pos hold total int32, sum one, block_sums
// ceil(total / kScanTile).
KT_EXPORT int gen_collect(GenState st, const int32_t* q_subj, int32_t* m,
                          int32_t* pos, int32_t* sum, int32_t* block_sums,
                          int32_t n_shards, int32_t me, cudaStream_t stream) {
    k_gen_leaf_mask<<<kt_blocks(st.total, kThreads), kThreads, 0, stream>>>(
        st, m, n_shards);
    // -- grid-wide barrier: every mask bit is written --
    enqueue_scan(m, st.total, pos, sum, block_sums, stream);
    // -- grid-wide barrier: positions and the leaf count are final --
    const int32_t work = st.total > st.leaves.n ? st.total : st.leaves.n;
    k_gen_leaf_emit<<<kt_blocks(work, kThreads), kThreads, 0, stream>>>(
        st, q_subj, m, pos, sum, n_shards, me);
    return (int)cudaGetLastError();
}

KT_EXPORT int gen_up(GenState st, int32_t lo, int32_t n, int32_t level,
                     int32_t plo, int32_t pn, const int32_t* found,
                     const int32_t* fover, const int32_t* fdirty,
                     cudaStream_t stream) {
    k_gen_up<<<kt_blocks(n, kThreads), kThreads, 0, stream>>>(
        st, lo, n, level, plo, pn, found, fover, fdirty);
    return (int)cudaGetLastError();
}

KT_EXPORT int gen_pack(GenState st, cudaStream_t stream) {
    k_gen_pack<<<kt_blocks(st.q, kThreads), kThreads, 0, stream>>>(st);
    return (int)cudaGetLastError();
}
