// Kernel D: per-limb modular add, sub, negate and Shoup scalar multiply.
//
// Replaces troy_tpu/ops/poly.py:36 rns_add, :42 rns_sub, :48 rns_neg and
// :53 rns_scalar_mul (with :65 rns_broadcast_scalar_mul on top). Data
// (rows, n), row r belongs to limb r % k; the per-limb modulus and, for the
// scalar multiply, the constant and its Shoup quotient are (k,) tensors.
//
// What bounds it on the H100: bytes; one or two words in, one out, a few
// integer operations each. Design: one kernel with an op code, one thread
// per word in a grid-stride loop, coalesced loads, and the whole batch of
// polynomials and limbs in one launch.

#include "u64.cuh"

using namespace troy;

namespace {

enum Op { kAdd = 0, kSub = 1, kNeg = 2, kScalarMul = 3 };

__global__ void rns_elementwise_kernel(uint64_t *__restrict__ out,
                                       const uint64_t *__restrict__ a,
                                       const uint64_t *__restrict__ b, int op,
                                       int64_t rows, int log_n, int k,
                                       const uint64_t *__restrict__ moduli,
                                       const uint64_t *__restrict__ w,
                                       const uint64_t *__restrict__ w_shoup) {
    const int64_t total = rows << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int limb = static_cast<int>((idx >> log_n) % k);
        const uint64_t q = moduli[limb];
        const uint64_t x = a[idx];
        uint64_t r;
        switch (op) {
            case kAdd: r = add_mod(x, b[idx], q); break;
            case kSub: r = sub_mod(x, b[idx], q); break;
            case kNeg: r = neg_mod(x, q); break;
            default: r = mul_mod_shoup(x, w[limb], w_shoup[limb], q); break;
        }
        out[idx] = r;
    }
}

}  // namespace

// out, a, b: (rows, 2^log_n) (b unused for neg and scalar multiply, w and
// w_shoup unused but for scalar multiply); moduli, w, w_shoup: (k,).
extern "C" int troy_rns_elementwise(void *out, const void *a, const void *b,
                                    int op, long long rows, int log_n, int k,
                                    const void *moduli, const void *w,
                                    const void *w_shoup, void *stream) {
    if (op < kAdd || op > kScalarMul) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    const long long total = rows << log_n;
    long long blocks = (total + threads - 1) / threads;
    blocks = blocks > 132 * 32 ? 132 * 32 : blocks;
    rns_elementwise_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(b), op, rows, log_n, k,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w),
        static_cast<const uint64_t *>(w_shoup));
    TROY_RETURN_LAUNCH_STATUS();
}
