// Kernel G: the BFV plain embedding, c0 +/- round(Q m / t) per limb.
//
// Replaces troy_tpu/ops/poly.py:98 bfv_multiply_add_plain (used by
// troy_tpu/encryptor.py:29 to embed the message in a fresh ciphertext).
// round(Q m / t) = m floor(Q/t) + fix with fix = floor((m (Q mod t) +
// (t+1)/2) / t); the 128/64 division is exact: subtract the Barrett-128
// remainder, shift out the power of two of t, multiply by the inverse of
// t's odd part mod 2^64 (a wrapping 64-bit product, exact because the
// quotient is below 2^64). Step for step the plain version in
// troy_tpu_torch/ops/poly.py.
//
// What bounds it on the H100: at n = 16384 the launch (1.4 MB of words).
// Design: one thread per coefficient computes fix once and writes all k
// limbs; the constants (7 + 4k words) in shared memory.
//
// Kernel G': the plain lift mod t -> RNS, troy_plain_lift below.
// Replaces troy_tpu/ops/poly.py:71 plain_lift (called by the BFV and BGV
// multiply_plain, troy_tpu/evaluator.py:708, the BGV add_plain, :761, with
// its m * cf mod t, :767-768, and the BGV encrypt, troy_tpu/encryptor.py:47).
// Per coefficient m < t: m <- m cf mod t (Shoup; skipped for cf = 1), then
// per limb m_j = m mod q_j (Barrett when t > q_j, else m) and
// out_j = m >= threshold ? (m_j + (Q - t) mod q_j) mod q_j : m_j.
// The threshold is (t+1)/2 for the centred lift of the plain ops and t
// (never reached) for the BGV encrypt's raw residues. Output below q_j,
// ready for kernel A. Bound: the launch (k + 1 rows of words); one thread
// per coefficient writes its k limbs (coalesced across the warp); the
// 1 + 3k constants in shared memory. The per-word arithmetic is
// plain_lift.cuh's, shared with AGp (csrc/ntt.cu troy_ntt_forward_lift),
// which runs the lift inside A's first forward pass on A's route: this
// kernel runs where the transforms are J's (n > 131072, use_mxu=True) or
// the tables hold none (a pointwise view). At the launch floor there
// (1.8 us a launch at (1, n) -> (5, n) on the H100, PERF.md), it is left
// as it was.

#include "plain_lift.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;

// consts: t, (t+1)/2, floor(2^128/t) low and high words, the power-of-two
// exponent s of t, (t >> s)^-1 mod 2^64, Q mod t; then q (k), cr_hi (k),
// floor(Q/t) mod q (k) and its Shoup words (k).
__global__ void plain_embed_kernel(uint64_t *__restrict__ out,
                                   const uint64_t *__restrict__ m,
                                   const uint64_t *__restrict__ c0,
                                   int64_t batch, int k, int log_n,
                                   int subtract,
                                   const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[7 + 4 * MAX_LIMBS];
    for (int j = threadIdx.x; j < 7 + 4 * k; j += blockDim.x) c[j] = consts[j];
    __syncthreads();
    const uint64_t t = c[0], half = c[1], ratio_lo = c[2], ratio_hi = c[3];
    const int shift = static_cast<int>(c[4]);
    const uint64_t inv_odd = c[5], q_mod_t = c[6];
    const uint64_t *q = c + 7, *cr_hi = q + k, *d = cr_hi + k,
                   *d_shoup = d + k;

    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t mv = m[idx];
        uint64_t lo, hi;
        mul128(mv, q_mod_t, lo, hi);
        const uint64_t lo2 = lo + half;
        const uint64_t hi2 = hi + (lo2 < lo);
        const uint64_t r = barrett_reduce_128(lo2, hi2, t, ratio_lo, ratio_hi);
        uint64_t lo3 = lo2 - r;
        const uint64_t hi3 = hi2 - (lo2 < r);
        if (shift) lo3 = (lo3 >> shift) | (hi3 << (64 - shift));
        const uint64_t fix = lo3 * inv_odd;
        const int64_t base = ((poly * k) << log_n) + i;
        for (int j = 0; j < k; ++j) {
            const int64_t at = base + (static_cast<int64_t>(j) << log_n);
            const uint64_t term = barrett_reduce_64(
                mul_mod_shoup(mv, d[j], d_shoup[j], q[j]) + fix, q[j],
                cr_hi[j]);
            out[at] = subtract ? sub_mod(c0[at], term, q[j])
                               : add_mod(c0[at], term, q[j]);
        }
    }
}

// consts: t, then q (k), the high Barrett words (k), (Q - t) mod q (k)
// (LiftLayout).
__global__ void plain_lift_kernel(uint64_t *__restrict__ out,
                                  const uint64_t *__restrict__ m,
                                  int64_t batch, int k, int log_n,
                                  uint64_t threshold, uint64_t cf,
                                  uint64_t cf_shoup,
                                  const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[1 + 3 * MAX_LIMBS];
    const LiftLayout L{k};
    for (int j = threadIdx.x; j < L.words(); j += blockDim.x) c[j] = consts[j];
    __syncthreads();
    const uint64_t t = c[L.t()];
    const uint64_t *q = c + L.q(), *cr_hi = c + L.cr_hi(), *inc = c + L.inc();
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t mv = lift_scale(m[idx], t, cf, cf_shoup);
        const bool upper = mv >= threshold;
        const int64_t base = ((poly * k) << log_n) + i;
        for (int j = 0; j < k; ++j) {
            out[base + (static_cast<int64_t>(j) << log_n)] =
                lift_limb(mv, upper, t, q[j], cr_hi[j], inc[j]);
        }
    }
}

}  // namespace

// m: (batch, 2^log_n) mod t; c0, out: (batch, k, 2^log_n); consts: above.
extern "C" int troy_bfv_plain_embed(void *out, const void *m, const void *c0,
                                    long long batch, int k, int log_n,
                                    int subtract, const void *consts,
                                    void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    plain_embed_kernel<<<grid_blocks(batch << log_n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(m),
        static_cast<const uint64_t *>(c0), batch, k, log_n, subtract,
        static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}

// m: (batch, 2^log_n) mod t; out: (batch, k, 2^log_n); consts: above.
extern "C" int troy_plain_lift(void *out, const void *m, long long batch,
                               int k, int log_n, unsigned long long threshold,
                               unsigned long long cf,
                               unsigned long long cf_shoup,
                               const void *consts, void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    plain_lift_kernel<<<grid_blocks(batch << log_n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(m), batch,
        k, log_n, threshold, cf, cf_shoup,
        static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}
