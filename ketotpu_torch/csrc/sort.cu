// Lexicographic sort of key columns with payload columns carried along:
// the port of the JAX package's engine/xutil.py:81 lex_sort
// (jax.lax.sort(keys + payload, num_keys=K)).  Plain version:
// xutil._lex_sort_plain (a chain of stable torch.sort calls, least
// significant key first).
//
// The onesweep radix sort itself, its bound and its design are in
// sort.cuh.  This entry point takes the wrapper's pass plan and scratch,
// and enqueues 1 memset + 1 histogram + one launch per digit pass; the
// last pass writes the sorted keys and payload.  With no pass (every key
// 0 bits wide) the columns are copied as they are (at most two copies).
#include "sort.cuh"

// keys: int32[n_keys, n] (column 0 most significant); payload:
// int32[n_payload, n] or nullptr; passes: host int32[n_pass, 3] rows
// (key column, shift, flip the sign bit 0/1), least significant digit
// first (xutil.sort_layout); keys_out / payload_out: the same shapes as
// keys / payload, in sorted order.  Scratch: perms int32[n] with two
// passes, int32[2, n] with more; zeroed: n_zeroed int32 words, which must
// be sort_zeroed_words(n, n_pass).  n < 2^30 (the status words' count).
KT_EXPORT int lex_sort(const int32_t* keys, int32_t n_keys,
                       const int32_t* payload, int32_t n_payload, int32_t n,
                       const int32_t* passes, int32_t n_pass,
                       int32_t* keys_out, int32_t* payload_out, int32_t* perms,
                       int32_t* zeroed, int64_t n_zeroed, cudaStream_t stream) {
    if (n_keys < 1 || n_keys > kSortMaxKeys || n_payload < 0 || n < 0 ||
        n > (int32_t)kStatusCount || n_pass < 0 || n_pass > kSortMaxPasses) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaGetLastError();
    if (n_pass == 0) {
        cudaError_t e = cudaMemcpyAsync(keys_out, keys,
                                        (size_t)n_keys * n * sizeof(int32_t),
                                        cudaMemcpyDeviceToDevice, stream);
        if (e == cudaSuccess && n_payload > 0) {
            e = cudaMemcpyAsync(payload_out, payload,
                                (size_t)n_payload * n * sizeof(int32_t),
                                cudaMemcpyDeviceToDevice, stream);
        }
        return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
    }
    if (n_zeroed != sort_zeroed_words(n, n_pass)) return (int)cudaErrorInvalidValue;
    SortPlan plan{};
    plan.n_pass = n_pass;
    for (int32_t p = 0; p < n_pass; ++p) {
        const int32_t col = passes[3 * p], shift = passes[3 * p + 1];
        if (col < 0 || col >= n_keys || shift < 0 || shift > 24 || shift % 8) {
            return (int)cudaErrorInvalidValue;
        }
        plan.col[p] = col;
        plan.shift[p] = shift;
        plan.flip[p] = passes[3 * p + 2] ? 0x80000000u : 0u;
    }
    return enqueue_radix_sort(keys, n_keys, n_payload > 0 ? payload : nullptr,
                              n_payload, n, plan, keys_out, payload_out, perms,
                              zeroed, stream);
}
