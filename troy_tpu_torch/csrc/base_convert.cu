// Kernel C: fast (approximate) RNS base conversion, BEHZ fastConvertArray.
//
// Replaces troy_tpu/ops/rns.py:44 fast_convert. Per coefficient:
//   temp_i = x_i * inv_punctured_i mod q_i            (Shoup, fully reduced)
//   out_o  = (sum_i temp_i * M[o][i]) mod p_o          (128-bit sum, Barrett)
// with M[o][i] = (Q / q_i) mod p_o. The result may overshoot by a multiple
// of Q, exactly as the reference's conversion does.
//
// Input (batch, k_in, n), output (batch, k_out, n). The constants of one
// converter are one small int64 tensor, uploaded once per context:
//   [q_in(k_in), inv_punctured(k_in), inv_punctured_shoup(k_in),
//    p_out(k_out), cr_lo(k_out), cr_hi(k_out), M(k_out x k_in)]
//
// What bounds it on the H100: bytes and latency. Each coefficient reads
// k_in words and writes k_out words and does k_in * (k_out + 1) products.
// Design: one thread per coefficient of one polynomial, so the k_in Shoup
// products are computed once and kept in registers (the loops unroll to
// MAX_IN with a guard) for all k_out outputs; the constants go to shared
// memory once per block; one launch covers every output limb and every
// polynomial of the batch.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int MAX_IN = 16;
constexpr int MAX_OUT = 16;
constexpr int MAX_CONSTS = 3 * MAX_IN + 3 * MAX_OUT + MAX_IN * MAX_OUT;

__global__ void base_convert_kernel(uint64_t *__restrict__ out,
                                    const uint64_t *__restrict__ in,
                                    int64_t batch, int k_in, int k_out,
                                    int log_n,
                                    const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[MAX_CONSTS];
    const int n_consts = 3 * k_in + 3 * k_out + k_in * k_out;
    for (int i = threadIdx.x; i < n_consts; i += blockDim.x) c[i] = consts[i];
    __syncthreads();
    const uint64_t *q_in = c;
    const uint64_t *invp = c + k_in;
    const uint64_t *invp_shoup = c + 2 * k_in;
    const uint64_t *p_out = c + 3 * k_in;
    const uint64_t *cr_lo = p_out + k_out;
    const uint64_t *cr_hi = cr_lo + k_out;
    const uint64_t *mat = cr_hi + k_out;

    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = in + ((poly * k_in) << log_n) + i;
        uint64_t *dst = out + ((poly * k_out) << log_n) + i;
        uint64_t temp[MAX_IN];
#pragma unroll
        for (int j = 0; j < MAX_IN; ++j) {
            if (j < k_in) {
                temp[j] = mul_mod_shoup(src[j << log_n], invp[j],
                                        invp_shoup[j], q_in[j]);
            }
        }
        for (int o = 0; o < k_out; ++o) {
            const uint64_t *row = mat + o * k_in;
            u128 acc = 0;
#pragma unroll
            for (int j = 0; j < MAX_IN; ++j) {
                if (j < k_in) acc += static_cast<u128>(temp[j]) * row[j];
            }
            dst[static_cast<int64_t>(o) << log_n] = barrett_reduce_128(
                static_cast<uint64_t>(acc), static_cast<uint64_t>(acc >> 64),
                p_out[o], cr_lo[o], cr_hi[o]);
        }
    }
}

}  // namespace

// in: (batch, k_in, 2^log_n), out: (batch, k_out, 2^log_n); k_in, k_out
// at most 16.
extern "C" int troy_base_convert(void *out, const void *in, long long batch,
                                 int k_in, int k_out, int log_n,
                                 const void *consts, void *stream) {
    if (k_in > MAX_IN || k_out > MAX_OUT) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    const long long total = batch << log_n;
    long long blocks = (total + threads - 1) / threads;
    blocks = blocks > 132 * 32 ? 132 * 32 : blocks;
    base_convert_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        batch, k_in, k_out, log_n, static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}
