// Probe half of one BFS level: node resolution, membership probes, the
// per-query found bits, then the child segment lengths of every item.
//
// Replaces the probe half of the JAX package's engine/fastpath.py:204
// expand_phase, with hashtab.py:445 lookup / :81 mix_device and
// fastpath.py:114 _node_lookup, :134 _member, :149 _node_dirty, :157
// _row_deg inlined (csrc/common.cuh), and its overlay branches
// (fastpath.py:282-288, :305-308): dirty and virtual nodes expand nothing,
// and an expansion or TTU row that needed a dirty node raises the query's
// dirty bit.  Plain version: fastpath._probe_level_plain.
//
// Bound: bytes.  Per frontier item the level reads its 7 columns and
// gathers (1 + Kc + Kt) node probes and (1 + Kc) membership probes, each
// one bucket pointer plus a few key pairs at random addresses in tables of
// ~10M entries, plus up to 1 + Kt CSR row degrees.  Nothing is reused
// across items, so the least time is those gathered bytes over 3.35 TB/s;
// in practice each dependent gather chain is latency-bound.  The design
// keeps one thread per item with every probe of that item in registers
// (no intermediate [F, K] arrays in device memory, which the XLA program
// materialised), and stops each probe loop at its first hit.
//
// Grid-wide barrier: pass 2 needs the FINAL found bit of the item's query
// (live2 in expand_phase), which any item of the level may set in pass 1.
// The barrier is the boundary between the two launches.
#include "common.cuh"

// Pass 1 (one thread per frontier item): direct and computed-subject-set
// probes; found bits are OR-ed into q_found_out (a copy of q_found_in).
// live reads the level's INPUT bits, as expand_phase does, so the result
// does not depend on the order in which threads run.
__global__ void probe_pass1(Graph g, Items f, const int32_t* __restrict__ q_found_in,
                            int32_t* __restrict__ q_found_out,
                            const int32_t* __restrict__ q_subj, int32_t nq,
                            int32_t* __restrict__ node_out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= f.n) return;
    int32_t qid = f.qid[i], ns = f.ns[i], obj = f.obj[i], rel = f.rel[i];
    int32_t d = f.d[i];
    int32_t qc = clampi(qid, 0, nq - 1);
    bool live = (qid >= 0) && (q_found_in[qc] == 0);
    int32_t node = node_lookup(g, ns, obj, rel);
    node_out[i] = node;
    if (!live) return;
    int32_t subj = q_subj[qc];
    bool cfg = (ns >= 0) & (ns < g.ns_dim) & (rel >= 0) & (rel < g.rel_dim);
    int32_t nr = clampi(ns, 0, g.ns_dim - 1) * g.rel_dim + clampi(rel, 0, g.rel_dim - 1);
    bool dok = (cfg ? g.direct_ok[nr] != 0 : true) && (f.skip[i] == 0);
    bool force = f.force[i] != 0;
    bool found = false;
    if ((dok && d >= 2) || force) found = member(g, node, subj);
    for (int32_t k = 0; k < g.kc && !found; ++k) {
        int32_t crel = cfg ? g.css_rel[nr * g.kc + k] : -1;
        bool css_ok = (crel >= 0) && (d - g.css_dec[nr * g.kc + k] >= 1);
        if (css_ok && g.css_probe[nr * g.kc + k]) {
            found = member(g, node_lookup(g, ns, obj, crel), subj);
        }
    }
    if (found) atomicOr(&q_found_out[qc], 1);
}

// Pass 2 (one thread per frontier item): segment lengths
// [expansion | css x Kc | ttu x Kt], their running sum and the TTU nodes.
// Every output is written for every item (zero where gated), exactly as
// the plain version computes it; dirty bits are OR-ed into q_dirty_out (a
// copy of the level's input bits).
__global__ void probe_pass2(Graph g, Items f, const int32_t* __restrict__ q_found,
                            int32_t* __restrict__ q_dirty_out,
                            int32_t nq, const int32_t* __restrict__ node_in,
                            int32_t* __restrict__ exp_deg_out,
                            int32_t* __restrict__ ttu_node_out,
                            int32_t* __restrict__ seg_cum_out,
                            int32_t* __restrict__ counts_out) {
    int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= f.n) return;
    int32_t qid = f.qid[i], ns = f.ns[i], obj = f.obj[i], rel = f.rel[i];
    int32_t d = f.d[i];
    int32_t qc = clampi(qid, 0, nq - 1);
    // live2 = live & ~q_found[final]; the final bits contain the input ones
    bool live2 = (qid >= 0) && (q_found[qc] == 0);
    bool cfg = (ns >= 0) & (ns < g.ns_dim) & (rel >= 0) & (rel < g.rel_dim);
    int32_t nr = clampi(ns, 0, g.ns_dim - 1) * g.rel_dim + clampi(rel, 0, g.rel_dim - 1);
    int32_t s = 1 + g.kc + g.kt;
    int32_t* cum = seg_cum_out + (int64_t)i * s;

    bool eok = cfg ? g.expand_ok[nr] != 0 : true;
    int32_t node = node_in[i];
    bool dirty = false;
    int32_t exp_deg = 0;
    if (live2 && eok && d >= 2) {
        bool nd;
        exp_deg = row_deg_ov(g, node, &nd);
        dirty = nd;
    }
    exp_deg_out[i] = exp_deg;
    int32_t run = exp_deg;
    cum[0] = run;
    for (int32_t k = 0; k < g.kc; ++k) {
        int32_t crel = cfg ? g.css_rel[nr * g.kc + k] : -1;
        int32_t dec = g.css_dec[nr * g.kc + k];
        bool need = live2 && (crel >= 0) && (d - dec >= 1) && (d - dec - 1 >= 1);
        run += need ? 1 : 0;
        cum[1 + k] = run;
    }
    for (int32_t k = 0; k < g.kt; ++k) {
        int32_t via = cfg ? g.ttu_via[nr * g.kt + k] : -1;
        int32_t tn = node_lookup(g, ns, obj, via);
        ttu_node_out[(int64_t)i * g.kt + k] = tn;
        bool ok = live2 && (via >= 0) && (d - g.ttu_dec[nr * g.kt + k] >= 2);
        if (ok) {
            bool nd;
            run += row_deg_ov(g, tn, &nd);
            dirty = dirty || nd;
        }
        cum[1 + g.kc + k] = run;
    }
    counts_out[i] = run;
    if (dirty) atomicOr(&q_dirty_out[qc], 1);
}

// Enqueue one level's probes on `stream`.  probe_only runs pass 1 alone
// (the final level: no item can have children, the dirty bits pass
// through).
KT_EXPORT int probe_level(Graph g, Items f, const int32_t* q_found_in,
                          int32_t* q_found_out, const int32_t* q_dirty_in,
                          int32_t* q_dirty_out, const int32_t* q_subj, int32_t nq,
                          int32_t* node_out, int32_t* exp_deg_out,
                          int32_t* ttu_node_out, int32_t* seg_cum_out,
                          int32_t* counts_out, int32_t probe_only,
                          cudaStream_t stream) {
    cudaMemcpyAsync(q_found_out, q_found_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    cudaMemcpyAsync(q_dirty_out, q_dirty_in, sizeof(int32_t) * nq,
                    cudaMemcpyDeviceToDevice, stream);
    const int threads = 256;
    probe_pass1<<<kt_blocks(f.n, threads), threads, 0, stream>>>(
        g, f, q_found_in, q_found_out, q_subj, nq, node_out);
    if (!probe_only) {
        // -- grid-wide barrier: every pass-1 found bit is final --
        probe_pass2<<<kt_blocks(f.n, threads), threads, 0, stream>>>(
            g, f, q_found_out, q_dirty_out, nq, node_out, exp_deg_out, ttu_node_out,
            seg_cum_out, counts_out);
    }
    return (int)cudaGetLastError();
}
