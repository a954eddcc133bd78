// Kernel X: the exact CRT conversion q -> t of the BGV decrypt, with the
// inverse correction factor fused in.
//
// Replaces troy_tpu/ops/rns.py:67 exact_convert and :189 decrypt_mod_t, and
// the multiply by the inverse correction factor after them
// (troy_tpu/decryptor.py:64-66). Per coefficient of each component, over
// the k limbs of the phase x:
//
//   temp_i = x_i (Q/q_i)^-1 mod q_i                           (Shoup)
//   alpha  = round(sum_i temp_i / q_i) in Q.64 fixed point: each term is
//            mulhi(temp_i, w_lo_i) + temp_i w_hi_i with w = floor(2^128/q_i),
//            summed in 128 bits; alpha = hi + (lo >> 63)
//   out    = ((sum_i temp_i (Q/q_i mod t)) mod t - (alpha mod t)(Q mod t))
//            mod t, then times cf^-1 mod t
//
// The JAX package's fixed point, not the doubles of troy's C++
// exactConvertArray, so the words are troy_tpu's; the 128-bit sums carry
// as in ops/u64ops.add_u128. cf^-1 = 1 leaves the words as they are (a
// Shoup product by 1 of a reduced word is the word).
//
// What bounds it on the H100: at n = 16384 and k = 5 the launch (0.8 MB
// of words in and out). Design: one thread per coefficient, the k limbs
// read down a column (coalesced across the warp), the 6k + 5 constants in
// shared memory.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;
constexpr int THREADS = 256;

// consts: q, (Q/q_i)^-1 mod q_i, its Shoup words, floor(2^128/q_i) low and
// high words, (Q/q_i) mod t (k each); t, floor(2^128/t) low and high words,
// Q mod t and its Shoup word.
__global__ void exact_convert_kernel(uint64_t *__restrict__ out,
                                     const uint64_t *__restrict__ x,
                                     int64_t comps, int k, int log_n,
                                     const uint64_t *__restrict__ consts,
                                     uint64_t inv_cf, uint64_t inv_cf_shoup) {
    __shared__ uint64_t c[6 * MAX_LIMBS + 5];
    for (int j = threadIdx.x; j < 6 * k + 5; j += blockDim.x) c[j] = consts[j];
    __syncthreads();
    const uint64_t *q = c, *invp = c + k, *invp_shoup = c + 2 * k,
                   *w_lo = c + 3 * k, *w_hi = c + 4 * k, *mat = c + 5 * k;
    const uint64_t t = c[6 * k], cr_lo = c[6 * k + 1], cr_hi = c[6 * k + 2],
                   q_mod = c[6 * k + 3], q_mod_shoup = c[6 * k + 4];
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = comps << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t comp = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = x + ((comp * k) << log_n) + i;
        uint64_t frac_lo = 0, frac_hi = 0, acc_lo = 0, acc_hi = 0;
        for (int j = 0; j < k; ++j) {
            const uint64_t temp = mul_mod_shoup(
                src[static_cast<int64_t>(j) << log_n], invp[j], invp_shoup[j],
                q[j]);
            uint64_t lo, hi;
            mul128(temp, w_hi[j], lo, hi);
            const uint64_t term_lo = mulhi64(temp, w_lo[j]) + lo;
            const uint64_t term_hi = hi + (term_lo < lo);
            frac_lo += term_lo;
            frac_hi += term_hi + (frac_lo < term_lo);
            mul128(temp, mat[j], lo, hi);
            acc_lo += lo;
            acc_hi += hi + (acc_lo < lo);
        }
        const uint64_t alpha = frac_hi + (frac_lo >> 63);   // round half up
        const uint64_t sum = barrett_reduce_128(acc_lo, acc_hi, t, cr_lo,
                                                cr_hi);
        const uint64_t alpha_q = mul_mod_shoup(
            barrett_reduce_64(alpha, t, cr_hi), q_mod, q_mod_shoup, t);
        out[idx] = mul_mod_shoup(sub_mod(sum, alpha_q, t), inv_cf,
                                 inv_cf_shoup, t);
    }
}

}  // namespace

// x: (comps, k, 2^log_n) below q_i; out: (comps, 2^log_n) mod t.
extern "C" int troy_exact_convert(void *out, const void *x, long long comps,
                                  int k, int log_n, const void *consts,
                                  unsigned long long inv_cf,
                                  unsigned long long inv_cf_shoup,
                                  void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    exact_convert_kernel<<<grid_blocks(comps << log_n, THREADS), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(x), comps,
        k, log_n, static_cast<const uint64_t *>(consts), inv_cf,
        inv_cf_shoup);
    TROY_RETURN_LAUNCH_STATUS();
}
