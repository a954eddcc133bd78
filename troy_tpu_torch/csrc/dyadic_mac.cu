// Kernel B: the dyadic 128-bit multiply-accumulate.
//
// out[r, i] = (sum_j a[j, r % ra, i] * b[j, r, i]) mod q_{r % k}
//
// Replaces troy_tpu/ops/ntt.py:428 rns_dyadic_mul (J = 1), the key-switch
// inner product troy_tpu/evaluator.py:262 _switch_key_inner_product
// (J = k data limbs; a is the decomposed target, broadcast over the two
// key components that b stacks), and the sums of the ciphertext-degree
// convolution (evaluator.py:60) and of the decrypt phase (decryptor.py:36).
// The sum runs in 128 bits (with q < 2^61 a product of reduced words is
// below 2^122, so 64 terms fit; of lazy words below 4q, four) and is
// reduced once with Barrett-128 against the limb's ratio words
// (troy_tpu/ops/u64ops.py:123-138), so the result is the canonical residue
// whatever the lazy ranges of the inputs.
//
// What bounds it on the H100: bytes. Each output word reads 2J words and
// does J 64x64->128 products, far below the integer rate, and the working
// set sits in L2. Design: one thread per output word, neighbouring threads
// on neighbouring coefficients so every load is coalesced, a grid-stride
// loop, and nothing stored between the J terms.

#include "u64.cuh"

using namespace troy;

namespace {

// rin 0: b row r of term j is j rb + r; else (r / ra) J rin + j rin +
// r % rin (the batched layout).
__global__ void dyadic_mac_kernel(uint64_t *__restrict__ out,
                                  const uint64_t *__restrict__ a,
                                  const uint64_t *__restrict__ b, int terms,
                                  int64_t ra, int64_t rb, int log_n, int k,
                                  const uint64_t *__restrict__ moduli,
                                  const uint64_t *__restrict__ cr_lo,
                                  const uint64_t *__restrict__ cr_hi,
                                  int64_t rin) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = rb << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t r = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const int64_t row_a = r % ra;
        const int limb = static_cast<int>(r % k);
        const int64_t b0 = rin > 0 ? (r / ra) * terms * rin + r % rin : r;
        const int64_t b_step = rin > 0 ? rin : rb;
        u128 acc = 0;
        for (int j = 0; j < terms; ++j) {
            acc += static_cast<u128>(a[((j * ra + row_a) << log_n) + i]) *
                   b[((b0 + j * b_step) << log_n) + i];
        }
        out[idx] = barrett_reduce_128(static_cast<uint64_t>(acc),
                                      static_cast<uint64_t>(acc >> 64),
                                      moduli[limb], cr_lo[limb], cr_hi[limb]);
    }
}

int dyadic_mac(void *out, const void *a, const void *b, int terms,
               long long ra, long long rows, int log_n, int k,
               const void *moduli, const void *cr_lo, const void *cr_hi,
               long long rin, void *stream) {
    if (terms < 1 || ra < 1 || k < 1 || rows % ra != 0 || ra % k != 0 ||
        (rin > 0 && (ra % rin != 0 || rin % k != 0))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    dyadic_mac_kernel<<<grid_blocks(rows << log_n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(b), terms, ra, rows, log_n, k,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi), rin);
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// a: (terms, ra, n), b: (terms, rb, n), out: (rb, n), with ra dividing rb
// and k dividing ra; moduli, cr_lo, cr_hi: (k,).
extern "C" int troy_dyadic_mac(void *out, const void *a, const void *b,
                               int terms, long long ra, long long rb,
                               int log_n, int k, const void *moduli,
                               const void *cr_lo, const void *cr_hi,
                               void *stream) {
    return dyadic_mac(out, a, b, terms, ra, rb, log_n, k, moduli, cr_lo,
                      cr_hi, 0, stream);
}

// The batched form: a (terms, ra, n) the key, ra = comps rin; b (m, terms,
// rin, n) the targets; out (m, comps, rin, n), rows = m ra.
extern "C" int troy_dyadic_mac_batched(void *out, const void *a,
                                       const void *b, int terms, long long ra,
                                       long long rows, long long rin,
                                       int log_n, int k, const void *moduli,
                                       const void *cr_lo, const void *cr_hi,
                                       void *stream) {
    if (rin < 1) return static_cast<int>(cudaErrorInvalidValue);
    return dyadic_mac(out, a, b, terms, ra, rows, log_n, k, moduli, cr_lo,
                      cr_hi, rin, stream);
}
