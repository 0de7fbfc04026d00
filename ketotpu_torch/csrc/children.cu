// Child half of one BFS level: the capacity check of every task, then one
// child per arena slot (segment decode, CSR edge gathers, CSS/TTU fields,
// width truncation, skip/force, and the liveness test).
//
// Replaces the child half of the JAX package's engine/fastpath.py:204
// expand_phase (from the `fits` test after arena_assign to the children
// dict).  Plain version: fastpath._expand_children_plain.
//
// Bound: bytes.  Per arena slot: the parent's columns and segment sums
// (gathered, mostly L2 hits since F is small), one row_ptr gather and one
// edge_hi + edge_obj gather at random rows of ~10M-entry arrays, and seven
// output columns written once.  The design decodes each slot's segment in
// registers from its parent's 1 + Kc + Kt running sums (no [A, S] array),
// recomputes the parent's CSS/TTU table fields from its (ns, rel) instead
// of gathering [F, K] intermediates, and packs (ns, rel) in one edge word
// so an expansion child costs two edge gathers, as in the JAX program.
//
// Grid-wide barrier: none inside; both kernels read only what arena.cu and
// probe.cu finished earlier in stream order.
#include "common.cuh"

// One thread per task: fits = offsets + counts <= arena; an item whose
// children do not all fit marks its query over (counts > 0 implies the
// item's query was live after this level's probes: every segment is gated
// on it).
__global__ void children_overflow(const int32_t* __restrict__ qid,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ counts, int32_t n,
                                  int32_t arena, int32_t nq,
                                  int32_t* __restrict__ q_over) {
    int32_t t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    int32_t c = counts[t];
    if (c > 0 && offsets[t] + c > arena) {
        atomicOr(&q_over[clampi(qid[t], 0, nq - 1)], 1);
    }
}

// One thread per arena slot.  Every output is computed for every slot
// with the same clamps as the plain version, dead slots included, so the
// two agree bit for bit on all columns.
__global__ void children_slots(Graph g, Items f, const int32_t* __restrict__ node,
                               const int32_t* __restrict__ exp_deg,
                               const int32_t* __restrict__ ttu_node,
                               const int32_t* __restrict__ seg_cum,
                               const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ parent,
                               const int32_t* __restrict__ ordinal,
                               const int32_t* __restrict__ q_found, int32_t nq,
                               int32_t max_width, Items out) {
    int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= out.n) return;
    const int32_t kc = g.kc, kt = g.kt, s = 1 + kc + kt;
    const int32_t R = g.rel_dim;
    int32_t ap = parent[j], ao = ordinal[j];
    int32_t aps = clampi(ap, 0, f.n - 1);
    bool fits = offsets[aps] + counts[aps] <= out.n;
    bool src_ok = (ap >= 0) && fits;

    // segment decode: seg_idx = #(running sums <= ordinal), clipped
    const int32_t* cum = seg_cum + (int64_t)aps * s;
    int32_t seg_idx = 0;
    for (int32_t k = 0; k < s; ++k) seg_idx += (ao >= cum[k]) ? 1 : 0;
    seg_idx = clampi(seg_idx, 0, s - 1);
    int32_t prev_cum = seg_idx > 0 ? cum[seg_idx - 1] : 0;
    int32_t off = ao - prev_cum;

    int32_t p_ns = f.ns[aps], p_obj = f.obj[aps], p_rel = f.rel[aps];
    int32_t p_d = f.d[aps], p_qid = f.qid[aps];
    bool is_exp = src_ok && seg_idx == 0;
    bool is_css = src_ok && seg_idx >= 1 && seg_idx <= kc;
    bool is_ttu = src_ok && seg_idx > kc;
    int32_t css_k = clampi(seg_idx - 1, 0, kc - 1);
    int32_t ttu_k = clampi(seg_idx - 1 - kc, 0, kt - 1);

    // the parent's table fields (expand_phase's [F, K] arrays, per slot)
    bool cfg = (p_ns >= 0) & (p_ns < g.ns_dim) & (p_rel >= 0) & (p_rel < R);
    int32_t nr = clampi(p_ns, 0, g.ns_dim - 1) * R + clampi(p_rel, 0, R - 1);
    int32_t css_rel_p = cfg ? g.css_rel[nr * kc + css_k] : -1;
    int32_t css_dec_p = g.css_dec[nr * kc + css_k];
    int32_t ttu_tgt_p = g.ttu_tgt[nr * kt + ttu_k];
    int32_t ttu_dec_p = g.ttu_dec[nr * kt + ttu_k];

    // edge gathers for expansion / TTU segments
    int32_t rmax = g.n_row_ptr - 2;
    int32_t base_exp = g.row_ptr[clampi(node[aps], 0, rmax)];
    int32_t ttu_node_p = ttu_node[(int64_t)aps * kt + ttu_k];
    int32_t base_ttu = g.row_ptr[clampi(ttu_node_p, 0, rmax)];
    int32_t eidx = clampi((is_ttu ? base_ttu : base_exp) + off, 0, g.n_edges - 1);
    int32_t e_hi = g.edge_hi[eidx], e_obj = g.edge_obj[eidx];
    int32_t e_ns = e_hi >= 0 ? e_hi / R : -1;
    int32_t e_rel = e_hi >= 0 ? e_hi % R : -1;

    int32_t ch_ns = is_css ? p_ns : e_ns;
    int32_t ch_obj = is_css ? p_obj : e_obj;
    int32_t ch_rel = is_css ? css_rel_p : (is_ttu ? ttu_tgt_p : e_rel);
    int32_t ch_d = is_css ? p_d - css_dec_p - 1
                          : (is_ttu ? p_d - ttu_dec_p - 1 : p_d - 1);
    bool ch_skip = is_exp || is_css;
    int32_t ch_qid = src_ok ? p_qid : -1;
    // width truncation applies to recursion only; truncated expansion
    // children ship probe-only (d = 0) so their EXISTS probe survives
    bool trunc = is_exp && (exp_deg[aps] > max_width) && (off >= max_width - 1);
    if (trunc) ch_d = 0;
    bool alive = src_ok && (is_exp || ch_d >= 1);
    alive = alive && q_found[clampi(ch_qid, 0, nq - 1)] == 0;

    out.qid[j] = alive ? ch_qid : -1;
    out.ns[j] = ch_ns;
    out.obj[j] = ch_obj;
    out.rel[j] = ch_rel;
    out.d[j] = ch_d > 0 ? ch_d : 0;
    out.skip[j] = ch_skip ? 1 : 0;
    out.force[j] = is_exp ? 1 : 0;
}

KT_EXPORT int expand_children(Graph g, Items f, const int32_t* node,
                              const int32_t* exp_deg, const int32_t* ttu_node,
                              const int32_t* seg_cum, const int32_t* offsets,
                              const int32_t* counts, const int32_t* parent,
                              const int32_t* ordinal, const int32_t* q_found,
                              const int32_t* q_over_in, int32_t* q_over_out,
                              int32_t nq, int32_t max_width, Items out,
                              cudaStream_t stream) {
    cudaMemcpyAsync(q_over_out, q_over_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    children_overflow<<<kt_blocks(f.n, threads), threads, 0, stream>>>(
        f.qid, offsets, counts, f.n, out.n, nq, q_over_out);
    children_slots<<<kt_blocks(out.n, threads), threads, 0, stream>>>(
        g, f, node, exp_deg, ttu_node, seg_cum, offsets, counts, parent,
        ordinal, q_found, nq, max_width, out);
    return (int)cudaGetLastError();
}
