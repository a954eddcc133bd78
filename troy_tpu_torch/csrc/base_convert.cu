// Kernel C: fast (approximate) RNS base conversion, BEHZ fastConvertArray.
//
// Replaces troy_tpu/ops/rns.py:44 fast_convert. Per coefficient:
//   temp_i = x_i * inv_punctured_i mod q_i            (Shoup, fully reduced)
//   out_o  = (sum_i temp_i * M[o][i]) mod p_o          (128-bit sum, Barrett)
// with M[o][i] = (Q / q_i) mod p_o. The result may overshoot by a multiple
// of Q, exactly as the reference's conversion does.
//
// Input (batch, k_in, n), output (batch, k_out, n). The constants of one
// converter are one small int64 tensor, uploaded once per context, in
// decrypt.cuh's ConvertLayout:
//   [q_in(k_in), inv_punctured(k_in), inv_punctured_shoup(k_in),
//    p_out(k_out), cr_lo(k_out), cr_hi(k_out), M(k_out x k_in)]
// On the card the port converts only the BFV decrypt's phase (q -> {t,
// gamma}, then kernel E's rounding); on A's route ACi does both inside
// kernel A's last inverse pass (ntt.cu) with decrypt.cuh's arithmetic, so
// this kernel runs where the phase comes from kernel J (use_mxu) or the
// fused pass cannot hold the level's limbs.
//
// What bounds it on the H100: bytes and latency. Each coefficient reads
// k_in words and writes k_out words and does k_in * (k_out + 1) products.
// Design: one thread per coefficient of one polynomial in blocks of 128
// threads (a single decrypt at n = 16384 is 128 blocks over the 132 SMs),
// a kernel compiled for each k_in up to MAX_IN: all k_in loads in flight
// before any Shoup product, the k_in products kept in registers for all
// k_out outputs, no guard to run past (a guarded loop unrolled to MAX_IN
// issues the skipped limbs' instructions too); the constants go to shared
// memory once per block; one launch covers every output limb and every
// polynomial of the batch.

#include "decrypt.cuh"

using namespace troy;

namespace {

// 20 covers every base of SEAL's n = 32768 chain (bfv_default(32768): 16
// primes of q; Bsk and the m~ extension 18 at the key level)
constexpr int MAX_IN = 20;
constexpr int MAX_OUT = 20;
constexpr int MAX_CONSTS = 3 * MAX_IN + 3 * MAX_OUT + MAX_IN * MAX_OUT;
constexpr int THREADS = 128;

template <int kIn>
__global__ void base_convert_kernel(uint64_t *__restrict__ out,
                                    const uint64_t *__restrict__ in,
                                    int64_t batch, int k_out, int log_n,
                                    const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[MAX_CONSTS];
    const ConvertLayout L{kIn, k_out};
    for (int i = threadIdx.x; i < L.words(); i += blockDim.x) c[i] = consts[i];
    __syncthreads();
    const uint64_t *q_in = c + L.q_in();
    const uint64_t *invp = c + L.invp();
    const uint64_t *invp_shoup = c + L.invp_shoup();
    const uint64_t *p_out = c + L.p_out();
    const uint64_t *cr_lo = c + L.cr_lo();
    const uint64_t *cr_hi = c + L.cr_hi();
    const uint64_t *mat = c + L.mat();

    const int64_t idx =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= batch << log_n) return;
    const int64_t n = int64_t(1) << log_n;
    const int64_t poly = idx >> log_n;
    const int64_t i = idx & (n - 1);
    const uint64_t *src = in + ((poly * kIn) << log_n) + i;
    uint64_t *dst = out + ((poly * k_out) << log_n) + i;
    uint64_t temp[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
        temp[j] = __ldg(src + (static_cast<int64_t>(j) << log_n));
    }
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
        temp[j] = mul_mod_shoup(temp[j], invp[j], invp_shoup[j], q_in[j]);
    }
    for (int o = 0; o < k_out; ++o) {
        const uint64_t *row = mat + o * kIn;
        u128 acc = 0;
#pragma unroll
        for (int j = 0; j < kIn; ++j) {
            acc += static_cast<u128>(temp[j]) * row[j];
        }
        dst[static_cast<int64_t>(o) << log_n] = barrett_reduce_128(
            static_cast<uint64_t>(acc), static_cast<uint64_t>(acc >> 64),
            p_out[o], cr_lo[o], cr_hi[o]);
    }
}

typedef void (*ConvertKernel)(uint64_t *, const uint64_t *, int64_t, int,
                              int, const uint64_t *);

// The kernel compiled for k_in (1..kIn).
template <int kIn>
ConvertKernel convert_kernel_for(int k_in) {
    if constexpr (kIn == 1) {
        return base_convert_kernel<1>;
    } else {
        return k_in == kIn ? base_convert_kernel<kIn>
                           : convert_kernel_for<kIn - 1>(k_in);
    }
}

}  // namespace

// in: (batch, k_in, 2^log_n), out: (batch, k_out, 2^log_n); k_in, k_out
// at most 20.
extern "C" int troy_base_convert(void *out, const void *in, long long batch,
                                 int k_in, int k_out, int log_n,
                                 const void *consts, void *stream) {
    const long long blocks = ((batch << log_n) + THREADS - 1) / THREADS;
    if (k_in < 1 || k_in > MAX_IN || k_out < 1 || k_out > MAX_OUT ||
        blocks < 1 || blocks > 0x7FFFFFFFLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    convert_kernel_for<MAX_IN>(k_in)<<<static_cast<unsigned>(blocks),
                                       THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        batch, k_out, log_n, static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}
