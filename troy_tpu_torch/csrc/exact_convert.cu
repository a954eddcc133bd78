// Kernel X: the exact CRT conversion q -> t of the BGV decrypt, with the
// inverse correction factor fused in.
//
// Replaces troy_tpu/ops/rns.py:67 exact_convert and :189 decrypt_mod_t, and
// the multiply by the inverse correction factor after them
// (troy_tpu/decryptor.py:64-66). The per-coefficient arithmetic (the
// Q.64 fixed-point alpha, the 128-bit sums, Barrett mod t) is
// decrypt.cuh's, shared with AXi, the decrypt folded into kernel A's last
// inverse pass (ntt.cu), which A's route runs; this kernel runs where the
// phase comes from kernel J (use_mxu) or the fused pass cannot hold the
// level's limbs.
//
// What bounds it on the H100: at n = 16384 and k = 5 the launch (0.8 MB
// of words in and out) and the latency of each coefficient's k loads; at
// larger n the 64-bit products (about 9 a limb and 15 a coefficient, each
// several 32-bit multiply-adds).
// Design: one thread per coefficient in blocks of 128 threads, so that a
// single decrypt at n = 16384 is 128 blocks over the 132 SMs; a kernel
// compiled for each limb count up to kMaxCompiled loads all of a
// coefficient's limbs before any of their arithmetic, down a column
// (coalesced across the warp), with no guard to run past (a guarded loop
// unrolled to a fixed bound issued the skipped limbs' instructions too:
// 1.15 and 1.5 times the previous kernel's time at (1, 5, 16384) and (1,
// 2, 262144) on the H100); more limbs take the run-time kernel, one limb
// at a time. The 6k + 5 constants sit in shared memory.

#include "decrypt.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;
constexpr int THREADS = 128;
// the most limbs a compiled kernel takes (SEAL's n = 32768 data level has
// 15)
constexpr int kMaxCompiled = 16;

// kLimbs: the limb count k, compiled (1..kMaxCompiled), or 0 (run time);
// consts in ExactLayout{k}.
template <int kLimbs>
__global__ void exact_convert_kernel(uint64_t *__restrict__ out,
                                     const uint64_t *__restrict__ x,
                                     int64_t comps, int k_run, int log_n,
                                     const uint64_t *__restrict__ consts,
                                     uint64_t inv_cf, uint64_t inv_cf_shoup) {
    const int k = kLimbs > 0 ? kLimbs : k_run;
    __shared__ uint64_t c[6 * MAX_LIMBS + 5];
    for (int j = threadIdx.x; j < ExactLayout{k}.words(); j += blockDim.x) {
        c[j] = consts[j];
    }
    __syncthreads();
    const int64_t idx =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= comps << log_n) return;
    const int64_t n = int64_t(1) << log_n;
    const uint64_t *src =
        x + (((idx >> log_n) * k) << log_n) + (idx & (n - 1));
    ExactSum s = {};
    if constexpr (kLimbs > 0) {
        uint64_t v[kLimbs];
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
            v[j] = __ldg(src + (static_cast<int64_t>(j) << log_n));
        }
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) exact_add(s, v[j], c, kLimbs, j);
    } else {
        for (int j = 0; j < k; ++j) {
            exact_add(s, __ldg(src + (static_cast<int64_t>(j) << log_n)), c,
                      k, j);
        }
    }
    out[idx] = exact_finish(s, c, k, inv_cf, inv_cf_shoup);
}

typedef void (*ExactKernel)(uint64_t *, const uint64_t *, int64_t, int, int,
                            const uint64_t *, uint64_t, uint64_t);

// The kernel compiled for k limbs (kLimbs down to 1), else the run-time
// one.
template <int kLimbs>
ExactKernel exact_kernel_for(int k) {
    if constexpr (kLimbs == 0) {
        return exact_convert_kernel<0>;
    } else {
        return k == kLimbs ? exact_convert_kernel<kLimbs>
                           : exact_kernel_for<kLimbs - 1>(k);
    }
}

}  // namespace

// x: (comps, k, 2^log_n) below q_i; out: (comps, 2^log_n) mod t.
extern "C" int troy_exact_convert(void *out, const void *x, long long comps,
                                  int k, int log_n, const void *consts,
                                  unsigned long long inv_cf,
                                  unsigned long long inv_cf_shoup,
                                  void *stream) {
    const long long blocks = ((comps << log_n) + THREADS - 1) / THREADS;
    if (k < 1 || k > MAX_LIMBS || blocks < 1 || blocks > 0x7FFFFFFFLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    exact_kernel_for<kMaxCompiled>(k)<<<static_cast<unsigned>(blocks),
                                        THREADS, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(x), comps,
        k, log_n, static_cast<const uint64_t *>(consts), inv_cf,
        inv_cf_shoup);
    TROY_RETURN_LAUNCH_STATUS();
}
