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
// Every draw here has fewer than 2^32 elements (the wrappers check), so
// the counter's high word is 0.
//
// Five entry points. The single draws, for one host seed or a device
// array of seeds:
//   uniform: draw (2, k, n); word0 = element i n + c, word1 = element
//      (k + i) n + c; the residue is Barrett-128 of (word1:word0) mod q_i;
//   CBD: draw (n,); noise popcount(w & (2^21-1)) - popcount((w >> 21) &
//      (2^21-1)) lifted centred into every q_i, times t mod q_i for BGV;
//   ternary: draw (n,); (w mod 3) - 1 (unsigned mod) lifted into q_i.
// And one launch for all the randomness of a zero encryption:
//   zero_sym: e (CBD, times t for BGV) and a (uniform) of one seed pair,
//      or of B seed pairs from device arrays;
//   zero_asym: u (ternary) and e_0 .. e_{size-1} (CBD, times t for BGV),
//      their seeds passed by value in the launch's parameters.
//
// What bounds it on the H100: integer operations (80 32-bit additions,
// rotations and xors a threefry block), at the headline's shapes far below
// the launch's own latency. Design: a 2-D grid, coefficients along x and
// the row (limb of a uniform draw, or one small draw) along y, the seed
// index along z, so no thread divides; a small draw's thread computes its
// coefficient's block once and lifts the value into every limb with a
// compare and an add (|v| <= 21 < q), BGV's t as one Shoup product a limb,
// its k stores coalesced across the warp; the ternary mod 3 on 32-bit
// halves. The zero encryptions' launches carry every draw of the
// encryption, written where the caller's ciphertext wants them.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAsymRows = 16;     // u and up to 15 components' e

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

// Word ctr (< 2^32) of the threefry2x32 draw keyed by seed (20 rounds,
// JAX's rotations and key schedule, the injection "+ i + 1").
__device__ __forceinline__ uint64_t threefry_word(uint64_t seed,
                                                  uint32_t ctr) {
    const uint32_t k0 = static_cast<uint32_t>(seed >> 32);
    const uint32_t k1 = static_cast<uint32_t>(seed);
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = ks[0];
    uint32_t x1 = ctr + ks[1];
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

// A small signed value |v| <= 21 lifted into [0, q) (Python's floor mod):
// a compare and an add where q > 21, the remainder otherwise.
__device__ __forceinline__ uint64_t lift_small(int v, uint64_t q) {
    if (q > 21) {
        return v < 0 ? q - static_cast<uint64_t>(-v)
                     : static_cast<uint64_t>(v);
    }
    const int64_t r = v % static_cast<int64_t>(q);
    return static_cast<uint64_t>(r < 0 ? r + static_cast<int64_t>(q) : r);
}

enum Dist { kCbd = 0, kTernary = 1 };

// The small value of one word: CBD's two 21-bit popcounts, or the
// ternary (w mod 3) - 1 with w mod 3 = (hi mod 3 + lo mod 3) mod 3, as
// 2^32 = 1 mod 3.
__device__ __forceinline__ int small_value(uint64_t word, int dist) {
    const uint32_t lo = static_cast<uint32_t>(word);
    const uint32_t hi = static_cast<uint32_t>(word >> 32);
    if (dist == kCbd) {
        const uint32_t mask = (1u << 21) - 1;
        return __popc(lo & mask) -
               __popc((lo >> 21) | ((hi & 0x3FFu) << 11));
    }
    uint32_t r = hi % 3u + lo % 3u;
    r = r >= 3u ? r - 3u : r;
    return static_cast<int>(r) - 1;
}

// Residue of limb i, coefficient c of a uniform draw keyed by s.
__device__ __forceinline__ uint64_t uniform_word(
        uint64_t s, int i, uint32_t c, int k, int log_n,
        const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    const uint32_t at = (static_cast<uint32_t>(i) << log_n) + c;
    const uint64_t lo = threefry_word(s, at);
    const uint64_t hi =
        threefry_word(s, at + (static_cast<uint32_t>(k) << log_n));
    return barrett_reduce_128(lo, hi, __ldg(moduli + i), __ldg(cr_lo + i),
                              __ldg(cr_hi + i));
}

// Coefficient c of a small draw keyed by s, lifted into every limb of
// row (k, n) `out`, times w_i (Shoup) where w is given.
__device__ __forceinline__ void small_coeff(
        uint64_t *__restrict__ out, uint64_t s, int dist, uint32_t c, int k,
        int log_n, const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ w, const uint64_t *__restrict__ w_shoup) {
    const int v = small_value(threefry_word(s, c), dist);
    for (int i = 0; i < k; ++i) {
        const uint64_t q = __ldg(moduli + i);
        uint64_t r = lift_small(v, q);
        if (w) r = mul_mod_shoup(r, __ldg(w + i), __ldg(w_shoup + i), q);
        out[(static_cast<int64_t>(i) << log_n) + c] = r;
    }
}

// grid (coefficient tiles, k limbs, batch): out (batch, k, n).
__global__ void uniform_kernel(uint64_t *__restrict__ out,
                               const uint64_t *__restrict__ seeds,
                               uint64_t seed, int k, int log_n,
                               const uint64_t *__restrict__ moduli,
                               const uint64_t *__restrict__ cr_lo,
                               const uint64_t *__restrict__ cr_hi) {
    const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (1u << log_n)) return;
    const int i = blockIdx.y;
    const int64_t b = blockIdx.z;
    const uint64_t s = seeds ? __ldg(seeds + b) : seed;
    out[((b * k + i) << log_n) + c] =
        uniform_word(s, i, c, k, log_n, moduli, cr_lo, cr_hi);
}

// grid (coefficient tiles, 1, batch): out (batch, k, n).
__global__ void small_kernel(uint64_t *__restrict__ out,
                             const uint64_t *__restrict__ seeds,
                             uint64_t seed, int dist, int k, int log_n,
                             const uint64_t *__restrict__ moduli,
                             const uint64_t *__restrict__ w,
                             const uint64_t *__restrict__ w_shoup) {
    const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (1u << log_n)) return;
    const int64_t b = blockIdx.z;
    const uint64_t s = seeds ? __ldg(seeds + b) : seed;
    small_coeff(out + ((b * k) << log_n), s, dist, c, k, log_n, moduli, w,
                w_shoup);
}

// grid (coefficient tiles, k + 1, batch): rows 0 .. k-1 the limbs of a,
// row k the CBD draw e; e_out and a_out (batch, k, n).
__global__ void zero_sym_kernel(uint64_t *__restrict__ e_out,
                                uint64_t *__restrict__ a_out,
                                const uint64_t *__restrict__ a_seeds,
                                uint64_t a_seed,
                                const uint64_t *__restrict__ e_seeds,
                                uint64_t e_seed, int k, int log_n,
                                const uint64_t *__restrict__ moduli,
                                const uint64_t *__restrict__ cr_lo,
                                const uint64_t *__restrict__ cr_hi,
                                const uint64_t *__restrict__ w,
                                const uint64_t *__restrict__ w_shoup) {
    const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (1u << log_n)) return;
    const int row = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t base = (b * k) << log_n;
    if (row < k) {
        const uint64_t s = a_seeds ? __ldg(a_seeds + b) : a_seed;
        a_out[base + (static_cast<int64_t>(row) << log_n) + c] =
            uniform_word(s, row, c, k, log_n, moduli, cr_lo, cr_hi);
    } else {
        const uint64_t s = e_seeds ? __ldg(e_seeds + b) : e_seed;
        small_coeff(e_out + base, s, kCbd, c, k, log_n, moduli, w, w_shoup);
    }
}

struct AsymSeeds {
    uint64_t s[kMaxAsymRows];
};

// grid (coefficient tiles, rows): row 0 the ternary u, row r >= 1 the CBD
// e_{r-1} (times w); out (rows, k, n). The seeds are read in place from
// the launch's parameters (__grid_constant__: no copy to local memory).
__global__ void zero_asym_kernel(uint64_t *__restrict__ out,
                                 const __grid_constant__ AsymSeeds seeds,
                                 int k, int log_n,
                                 const uint64_t *__restrict__ moduli,
                                 const uint64_t *__restrict__ w,
                                 const uint64_t *__restrict__ w_shoup) {
    const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= (1u << log_n)) return;
    const int row = blockIdx.y;
    small_coeff(out + ((static_cast<int64_t>(row) * k) << log_n),
                seeds.s[row], row == 0 ? kTernary : kCbd, c, k, log_n,
                moduli, row == 0 ? nullptr : w, w_shoup);
}

dim3 grid(int log_n, int rows, long long batch) {
    return dim3(static_cast<unsigned>(((1ll << log_n) + kThreads - 1) /
                                      kThreads),
                static_cast<unsigned>(rows), static_cast<unsigned>(batch));
}

bool bad_batch(long long batch) { return batch < 1 || batch > 65535; }

}  // namespace

// out: (batch, k, 2^log_n) residues; seeds: (batch,) seeds, or NULL to use
// `seed` (batch 1); moduli, cr_lo, cr_hi: (k,), cr = floor(2^128 / q_i).
extern "C" int troy_sample_uniform_rns(void *out, const void *seeds,
                                       unsigned long long seed,
                                       long long batch, int k, int log_n,
                                       const void *moduli, const void *cr_lo,
                                       const void *cr_hi, void *stream) {
    if (bad_batch(batch)) return static_cast<int>(cudaErrorInvalidValue);
    uniform_kernel<<<grid(log_n, k, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, k, log_n, static_cast<const uint64_t *>(moduli),
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
    if (bad_batch(batch)) return static_cast<int>(cudaErrorInvalidValue);
    small_kernel<<<grid(log_n, 1, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, kCbd, k, log_n, static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w),
        static_cast<const uint64_t *>(w_shoup));
    TROY_RETURN_LAUNCH_STATUS();
}

extern "C" int troy_sample_ternary_rns(void *out, const void *seeds,
                                       unsigned long long seed,
                                       long long batch, int k, int log_n,
                                       const void *moduli, void *stream) {
    if (bad_batch(batch)) return static_cast<int>(cudaErrorInvalidValue);
    small_kernel<<<grid(log_n, 1, batch), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(seeds),
        seed, kTernary, k, log_n, static_cast<const uint64_t *>(moduli),
        nullptr, nullptr);
    TROY_RETURN_LAUNCH_STATUS();
}

// e_out, a_out: (batch, k, 2^log_n) each; a_seeds and e_seeds: (batch,)
// device seeds, or NULL to use a_seed and e_seed (batch 1); w, w_shoup as
// for troy_sample_cbd_rns.
extern "C" int troy_sample_zero_sym(void *e_out, void *a_out,
                                    const void *a_seeds,
                                    unsigned long long a_seed,
                                    const void *e_seeds,
                                    unsigned long long e_seed,
                                    long long batch, int k, int log_n,
                                    const void *moduli, const void *cr_lo,
                                    const void *cr_hi, const void *w,
                                    const void *w_shoup, void *stream) {
    if (bad_batch(batch)) return static_cast<int>(cudaErrorInvalidValue);
    zero_sym_kernel<<<grid(log_n, k + 1, batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(e_out), static_cast<uint64_t *>(a_out),
        static_cast<const uint64_t *>(a_seeds), a_seed,
        static_cast<const uint64_t *>(e_seeds), e_seed, k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi),
        static_cast<const uint64_t *>(w),
        static_cast<const uint64_t *>(w_shoup));
    TROY_RETURN_LAUNCH_STATUS();
}

// out: (rows, k, 2^log_n): u, then e_0 .. e_{rows-2}; seeds: rows host
// words in that order (copied into the launch's parameters); w, w_shoup
// as for troy_sample_cbd_rns (the e rows only).
extern "C" int troy_sample_zero_asym(void *out, const void *seeds, int rows,
                                     int k, int log_n, const void *moduli,
                                     const void *w, const void *w_shoup,
                                     void *stream) {
    if (rows < 2 || rows > kMaxAsymRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    AsymSeeds s = {};
    for (int r = 0; r < rows; ++r) {
        s.s[r] = static_cast<const unsigned long long *>(seeds)[r];
    }
    zero_asym_kernel<<<grid(log_n, rows, 1), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), s, k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w),
        static_cast<const uint64_t *>(w_shoup));
    TROY_RETURN_LAUNCH_STATUS();
}
