// Kernel M: the Galois automorphism x -> x^elt as a gather over the
// coefficients.
//
// Replaces troy_tpu/evaluator.py:785 _apply_permutation_signed (coefficient
// domain: out[j] = in[src[j]], negated mod q where the index wrapped past
// x^n = -1, and 0 stays 0) and :796 _apply_permutation (NTT domain: a plain
// gather of the bit-reversed evaluations), one kernel with keep = NULL for
// the unsigned form. The index tables come from utils/galois.py.
//
// A second entry point takes one table per leading batch index (tables
// (m, n), rows_per_table rows each): the hoisted Galois path's output
// permutation, one element per ciphertext
// (troy_tpu/evaluator.py:463 _hoisted_galois_core), in one launch. It can
// also write component-major ((c, b) for input (b, c)), which gives the
// batched fold (:442 _batched_galois_fold) its c0s and c1s as two
// contiguous stacks.
//
// What bounds it on the H100: at n = 16384 the launch (2.7 MB for both
// components of a 5-limb ciphertext). Design: one thread per output word,
// so writes are coalesced and the gathered reads stay inside one row of
// 128 KiB (L2-resident); every row of every component in one launch, row r
// using modulus q_{r % k}.

#include "u64.cuh"

using namespace troy;

namespace {

// rows_per_table 0: one table for every row; else row r reads table
// r / rows_per_table. comps > 0: the input rows are (b, c, i) with c <
// comps and i < k, written to output row (c, b, i).
__global__ void galois_permute_kernel(uint64_t *__restrict__ out,
                                      const uint64_t *__restrict__ in,
                                      const int64_t *__restrict__ src,
                                      const bool *__restrict__ keep,
                                      int64_t rows, int k, int log_n,
                                      const uint64_t *__restrict__ moduli,
                                      int64_t rows_per_table, int comps) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = rows << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t r = idx >> log_n;
        const int64_t j = idx & (n - 1);
        const int64_t t =
            (rows_per_table > 0 ? r / rows_per_table : 0) << log_n;
        uint64_t v = in[(r << log_n) + src[t + j]];
        if (keep != nullptr && !keep[t + j]) {
            v = neg_mod(v, moduli[r % k]);
        }
        int64_t o = r;
        if (comps > 0) {
            const int64_t per = static_cast<int64_t>(comps) * k;
            const int64_t b = r / per, c = (r / k) % comps, i = r % k;
            o = (c * (rows / per) + b) * k + i;
        }
        out[(o << log_n) + j] = v;
    }
}

int permute(void *out, const void *in, const void *src, const void *keep,
            long long rows, int k, int log_n, const void *moduli,
            long long rows_per_table, int comps, void *stream) {
    if (k < 1 || (keep != nullptr && moduli == nullptr) || comps < 0 ||
        (comps > 0 && rows % (static_cast<long long>(comps) * k) != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    galois_permute_kernel<<<grid_blocks(rows << log_n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        static_cast<const int64_t *>(src), static_cast<const bool *>(keep),
        rows, k, log_n, static_cast<const uint64_t *>(moduli),
        rows_per_table, comps);
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// in, out: (rows, 2^log_n); src: (2^log_n,) int64 source indices; keep:
// (2^log_n,) bool, or NULL for the unsigned gather; moduli: (k,) (unused
// when keep is NULL).
extern "C" int troy_galois_permute(void *out, const void *in, const void *src,
                                   const void *keep, long long rows, int k,
                                   int log_n, const void *moduli,
                                   void *stream) {
    return permute(out, in, src, keep, rows, k, log_n, moduli, 0, 0, stream);
}

// The batched form: src, keep: (rows / rows_per_table, 2^log_n), one table
// per leading batch index; comps > 0 writes component-major (above).
extern "C" int troy_galois_permute_batched(void *out, const void *in,
                                           const void *src, const void *keep,
                                           long long rows, int k, int log_n,
                                           const void *moduli,
                                           long long rows_per_table,
                                           int comps, void *stream) {
    return permute(out, in, src, keep, rows, k, log_n, moduli,
                   rows_per_table, comps, stream);
}
