// Kernel I: device sampling. threefry2x32 streams into RNS residues.
//
// Replaces troy_tpu/rlwe.py:57 sample_uniform_rns_dev, :71 sample_cbd_dev,
// :83 sample_ternary_dev and :90 _lift_centered_i64 (with the BGV noise
// scaling of :121-122 fused), the samplers under the zero encryptions of
// :111 _zero_sym_core, :260 _zero_sym_batch_core, :284 _expand_seed_core
// and :307 _zero_asym_core.
//
// The words are those of jax.random.bits(jax.random.PRNGKey(seed), shape,
// uint64) with jax_threefry_partitionable (JAX's default): the key is
// (seed >> 32, seed mod 2^32), flat element idx of the draw is
// threefry2x32(key, (idx >> 32, idx mod 2^32)) = (y0, y1) and the word is
// (y0 << 32) | y1. So a seed gives the same words here as in troy_tpu.
//
// Three entry points, each one thread per output word over (batch, limb,
// coefficient); the seed is a scalar argument, or one per batch element
// from a device array:
//   I1 uniform: draw (2, k, n); word0 = element i n + c, word1 = element
//      (k + i) n + c; the residue is Barrett-128 of (word1:word0) mod q_i.
//   I2 CBD: draw (n,); noise popcount(w & (2^21-1)) - popcount((w >> 21) &
//      (2^21-1)) lifted centred into every q_i, times t mod q_i for BGV.
//   I3 ternary: draw (n,); (w mod 3) - 1 (unsigned mod) lifted into q_i.
//
// What bounds it on the H100: integer operations against bytes about
// evenly. One word written per thread (k n 8 bytes, 0.79 MB at the key
// level), and two threefry blocks of 20 rounds (about 80 32-bit additions,
// rotations and xors each) plus a 128-bit Barrett reduction per uniform
// word. Design: the threefry block is recomputed for each limb of a CBD or
// ternary coefficient (k times the work, no shared memory, no second
// pass); rotations are funnel shifts; no table is read but the per-limb
// moduli and ratio words.

#include "u64.cuh"

using namespace troy;

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

// Word idx of the threefry2x32 draw keyed by seed (20 rounds, JAX's
// rotations and key schedule, the injection "+ i + 1").
__device__ __forceinline__ uint64_t threefry_word(uint64_t seed,
                                                  uint64_t idx) {
    const uint32_t ks[3] = {static_cast<uint32_t>(seed >> 32),
                            static_cast<uint32_t>(seed),
                            static_cast<uint32_t>(seed >> 32) ^
                                static_cast<uint32_t>(seed) ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = static_cast<uint32_t>(idx >> 32) + ks[0];
    uint32_t x1 = static_cast<uint32_t>(idx) + ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
    return (static_cast<uint64_t>(x0) << 32) | x1;
}

// A small signed value v lifted into [0, q) (Python's floor mod).
__device__ __forceinline__ uint64_t lift_centered(int64_t v, uint64_t q) {
    int64_t r = v % static_cast<int64_t>(q);
    return static_cast<uint64_t>(r < 0 ? r + static_cast<int64_t>(q) : r);
}

enum Dist { kCbd = 0, kTernary = 1 };

__global__ void uniform_kernel(uint64_t *__restrict__ out,
                               const uint64_t *__restrict__ seeds,
                               uint64_t seed, int64_t batch, int k, int log_n,
                               const uint64_t *__restrict__ moduli,
                               const uint64_t *__restrict__ cr_lo,
                               const uint64_t *__restrict__ cr_hi) {
    const int64_t per = static_cast<int64_t>(k) << log_n;
    const int64_t total = batch * per;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t b = idx / per;
        const int64_t rem = idx - b * per;  // i n + c
        const int i = static_cast<int>(rem >> log_n);
        const uint64_t s = seeds ? seeds[b] : seed;
        const uint64_t lo = threefry_word(s, static_cast<uint64_t>(rem));
        const uint64_t hi = threefry_word(s, static_cast<uint64_t>(rem + per));
        out[idx] = barrett_reduce_128(lo, hi, moduli[i], cr_lo[i], cr_hi[i]);
    }
}

// CBD (times w_i mod q_i when w is given) or ternary, lifted into every
// limb.
__global__ void small_kernel(uint64_t *__restrict__ out,
                             const uint64_t *__restrict__ seeds,
                             uint64_t seed, int64_t batch, int k, int log_n,
                             const uint64_t *__restrict__ moduli,
                             const uint64_t *__restrict__ w,
                             const uint64_t *__restrict__ w_shoup, int dist) {
    const int64_t per = static_cast<int64_t>(k) << log_n;
    const int64_t total = batch * per;
    const int64_t n_mask = (int64_t{1} << log_n) - 1;
    const uint64_t cbd_mask = (uint64_t{1} << 21) - 1;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t b = idx / per;
        const int i = static_cast<int>((idx - b * per) >> log_n);
        const uint64_t s = seeds ? seeds[b] : seed;
        const uint64_t word =
            threefry_word(s, static_cast<uint64_t>(idx & n_mask));
        const uint64_t q = moduli[i];
        uint64_t r;
        if (dist == kCbd) {
            const int v = __popcll(word & cbd_mask) -
                          __popcll((word >> 21) & cbd_mask);
            r = lift_centered(v, q);
            if (w) r = mul_mod_shoup(r, w[i], w_shoup[i], q);
        } else {
            // 2^32 = 1 mod 3, so w mod 3 = (hi + lo) mod 3
            const uint64_t v = ((word >> 32) + (word & 0xFFFFFFFFull)) % 3;
            r = lift_centered(static_cast<int64_t>(v) - 1, q);
        }
        out[idx] = r;
    }
}

}  // namespace

// out: (batch, k, 2^log_n) residues; seeds: (batch,) seeds, or NULL to use
// `seed` (batch 1); moduli, cr_lo, cr_hi: (k,), cr = floor(2^128 / q_i).
extern "C" int troy_sample_uniform_rns(void *out, const void *seeds,
                                       unsigned long long seed,
                                       long long batch, int k, int log_n,
                                       const void *moduli, const void *cr_lo,
                                       const void *cr_hi, void *stream) {
    const int threads = 256;
    uniform_kernel<<<grid_blocks((batch * k) << log_n, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, batch, k, log_n, static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi));
    TROY_RETURN_LAUNCH_STATUS();
}

// As above; w, w_shoup: (k,) the BGV scale t mod q_i and its Shoup
// quotient, or NULL for none.
extern "C" int troy_sample_cbd_rns(void *out, const void *seeds,
                                   unsigned long long seed, long long batch,
                                   int k, int log_n, const void *moduli,
                                   const void *w, const void *w_shoup,
                                   void *stream) {
    const int threads = 256;
    small_kernel<<<grid_blocks((batch * k) << log_n, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, batch, k, log_n, static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w),
        static_cast<const uint64_t *>(w_shoup), kCbd);
    TROY_RETURN_LAUNCH_STATUS();
}

extern "C" int troy_sample_ternary_rns(void *out, const void *seeds,
                                       unsigned long long seed,
                                       long long batch, int k, int log_n,
                                       const void *moduli, void *stream) {
    const int threads = 256;
    small_kernel<<<grid_blocks((batch * k) << log_n, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, batch, k, log_n, static_cast<const uint64_t *>(moduli), nullptr,
        nullptr, kTernary);
    TROY_RETURN_LAUNCH_STATUS();
}
