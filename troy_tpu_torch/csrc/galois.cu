// Kernel M: the Galois automorphism x -> x^elt as a gather over the
// coefficients.
//
// Replaces troy_tpu/evaluator.py:785 _apply_permutation_signed (coefficient
// domain: out[j] = in[src[j]], negated mod q where the index wrapped past
// x^n = -1, and 0 stays 0) and :796 _apply_permutation (NTT domain: a plain
// gather of the bit-reversed evaluations), one kernel with keep = NULL for
// the unsigned form. The index tables come from utils/galois.py.
//
// What bounds it on the H100: at n = 16384 the launch (2.7 MB for both
// components of a 5-limb ciphertext). Design: one thread per output word,
// so writes are coalesced and the gathered reads stay inside one row of
// 128 KiB (L2-resident); every row of every component in one launch, row r
// using modulus q_{r % k}.

#include "u64.cuh"

using namespace troy;

namespace {

__global__ void galois_permute_kernel(uint64_t *__restrict__ out,
                                      const uint64_t *__restrict__ in,
                                      const int64_t *__restrict__ src,
                                      const bool *__restrict__ keep,
                                      int64_t rows, int k, int log_n,
                                      const uint64_t *__restrict__ moduli) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = rows << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t r = idx >> log_n;
        const int64_t j = idx & (n - 1);
        uint64_t v = in[(r << log_n) + src[j]];
        if (keep != nullptr && !keep[j]) {
            v = neg_mod(v, moduli[r % k]);
        }
        out[idx] = v;
    }
}

}  // namespace

// in, out: (rows, 2^log_n); src: (2^log_n,) int64 source indices; keep:
// (2^log_n,) bool, or NULL for the unsigned gather; moduli: (k,) (unused
// when keep is NULL).
extern "C" int troy_galois_permute(void *out, const void *in, const void *src,
                                   const void *keep, long long rows, int k,
                                   int log_n, const void *moduli,
                                   void *stream) {
    if (k < 1 || (keep != nullptr && moduli == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    galois_permute_kernel<<<grid_blocks(rows << log_n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        static_cast<const int64_t *>(src), static_cast<const bool *>(keep),
        rows, k, log_n, static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}
