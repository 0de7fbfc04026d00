// Lexicographic sort of key columns with payload columns carried along:
// the port of the JAX package's engine/xutil.py:81 lex_sort
// (jax.lax.sort(keys + payload, num_keys=K)).  Plain version:
// xutil._lex_sort_plain (a chain of stable torch.sort calls, least
// significant key first).
//
// The radix sort itself, its bound and its design are in sort.cuh; this
// entry point adds the final gather of the keys and the payload through
// the sorted permutation (one launch over every column).
#include "sort.cuh"

// keys: int32[n_keys, n] (column 0 most significant); bits: host array of
// n_keys widths (a width below 32 promises 0 <= key < 2^width); payload:
// int32[n_payload, n] or nullptr; keys_out / payload_out: the same shapes
// in sorted order.  Scratch as SortScratch (sort.cuh).
KT_EXPORT int lex_sort(const int32_t* keys, int32_t n_keys, const int32_t* bits,
                       const int32_t* payload, int32_t n_payload, int32_t n,
                       int32_t* keys_out, int32_t* payload_out, int32_t* perm_a,
                       int32_t* perm_b, int32_t* counts, int32_t* total,
                       int32_t* block_sums, cudaStream_t stream) {
    if (n_keys < 1 || n_keys > kSortMaxKeys || n_payload < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (n <= 0) return (int)cudaGetLastError();
    SortScratch s{perm_a, perm_b, counts, total, block_sums};
    const int32_t* perm = enqueue_radix_sort(keys, n_keys, bits, n, s, stream);
    const int threads = 256;
    radix_gather<<<kt_blocks((int64_t)n_keys * n, threads), threads, 0, stream>>>(
        keys, n_keys, n, perm, keys_out);
    if (n_payload > 0) {
        radix_gather<<<kt_blocks((int64_t)n_payload * n, threads), threads, 0,
                       stream>>>(payload, n_payload, n, perm, payload_out);
    }
    return (int)cudaGetLastError();
}
