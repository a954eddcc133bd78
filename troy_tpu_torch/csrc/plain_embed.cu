// Kernel G': the plain lift mod t -> RNS, troy_plain_lift below. (Kernel
// G, the BFV plain embedding c0 +/- round(Q m / t), runs on kernel D's
// grid: rns_elementwise.cu troy_bfv_plain_embed, and DG, folded into D's
// zero-encryption finish; its arithmetic is plain_embed.cuh's.)
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
// (1.8 us a launch at (1, n) -> (5, n) on the H100 80GB HBM3 at 700 W,
// PERF.md), it is left as it was.

#include "plain_lift.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;

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
