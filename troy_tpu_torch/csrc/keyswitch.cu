// Kernels F and K: the key switch's per-coefficient glue and the BFV
// divide-and-round by the last prime.
//
// F replaces the word arithmetic of troy_tpu/evaluator.py:179
// _switch_key_decompose (each RNS digit Barrett-reduced into every prime of
// the working base, before kernel A's NTT) and of :290 _switch_key_contract
// (the rounding divide by the special prime p after kernel B's inner product
// and kernel A's inverse NTT). K replaces troy_tpu/ops/rns.py:194
// divide_and_round_q_last, the BFV mod switch, which is the same divide with
// p = the level's last prime. F and K call one device function through two
// entry points, so each keeps its own launch count.
//
//   digits:        out[r, j, i] = x[r, i] mod p_j        (Barrett-64)
//                  (on kernel J's route and the coefficient-sharded key
//                  switch; on A's route the digits are reduced in A's
//                  first pass, csrc/ntt.cu troy_ntt_forward_digits)
//   divide-round:  last  = x[c, k, i] + floor(p/2) mod p
//                  out[c, j, i] = (x[c, j, i] - (last mod q_j - floor(p/2)
//                                 mod q_j)) * p^-1 mod q_j   (+ acc[c, j, i])
//                  (K, J's route and the coefficient-sharded key switch;
//                  on A's route the key switch's divide runs in A's last
//                  inverse pass, csrc/ntt.cu troy_ntt_inverse_keyswitch;
//                  the word arithmetic is divide_round.cuh's, shared)
//
// with an optional accumulator: the components come in groups of `group`,
// and acc[g % acc_groups, h] is added onto component h < acc_comps of
// group g: (c0, c1) for relinearization (one group), c0 alone for a Galois
// automorphism, the permuted c0 of each ciphertext for the batched fold
// (groups of 2, one acc row each) and the one c0 of the hoisted Galois path
// (groups of 2, one acc row for all).
//
// K'' replaces troy_tpu/ops/rns.py:281 mod_t_and_divide_q_last, the BGV
// divide in the coefficient domain: it subtracts from x a multiple of the
// plain modulus tt that makes row k divisible by its prime p, then divides
// (rns.cpp:1097-1140):
//
//   neg_k        = (-(last mod tt)) p^-1 mod tt               (0 stays 0)
//   out[c, j, i] = (x[c, j, i] + 2 q_j - (last mod q_j)
//                   - (neg_k mod q_j)(p mod q_j)) p^-1 mod q_j (+ acc)
//
// with last = x[c, k, i]. The lazy sum stays below 3 q_j < 2^63 (every
// modulus is below 2^61), where the Shoup product is exact. With p the
// level's last prime it is the BGV mod switch in the coefficient domain;
// with p the special prime, the BGV key switch of a coefficient-form
// ciphertext (the JAX package divides in the NTT domain there whatever the
// ciphertext's form). Its constants are K'-BGV's
// (ops/keyswitch.py bgv_divide_consts).
//
// What bounds it on the H100: at n = 16384 the launch and one round trip
// to memory (under 5 MB of words, a handful of 64-bit products per word).
// The divides (K, F's divide off A's route, and K'') are built around
// that round trip, one body for both (divide_body):
//  - a 3-D grid: coefficient pairs on x, the component on y (a launch
//    for each 65535), the data limbs in groups on z (K: kDivideGroup,
//    K'': kBgvDivideGroup, measured: at the headline's folds of 8 and 4
//    pairs, groups of three took 12.3 and 7.1 us a launch against 12.9
//    and 7.4 for groups of two and 12.6 and 7.0 for the grid-stride
//    form; groups of five 12.0 and 7.1 but 3.4 against 3.1 at one pair),
//    so no thread divides by n and the accumulator row is formed once a
//    block, in 32-bit quotients (and not at all without an accumulator);
//  - two coefficients a thread through 16-byte loads and streaming stores
//    (the output is read only by a later op), in blocks of kDivideThreads;
//  - a thread issues the loads of its group's rows, of row k, of the
//    accumulator's rows and of its constants (K: 2 + 5 a limb, K'': 4 +
//    6 a limb) before any product (one round trip for all; the constants
//    are the same words across a block, so they come from L1 after the
//    first warp, and the block needs no barrier); row k is
//    read by every group of a component, from L2 after the first, and
//    K'' forms neg_k from it in every group.
// A thread holding all k + 1 rows (a kernel compiled for each k, 128
// blocks at (2, 5, 16384)), or the block's constants copied into shared
// memory behind a barrier, were slower at the headline's level and at
// SEAL's n = 32768 than groups of two limbs reading their own constants,
// which give the card 3 and 8 times the blocks there, no spilled
// registers and one kernel for every k (PERF.md); K'' had the grid-stride
// form (one thread a coefficient of all k limbs, constants in shared
// memory, 8-byte accesses) until it took K's. The digits keep it: one
// thread per coefficient of one component, coalesced across the warp, the
// constants in shared memory.

#include "divide_round.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;
// the divide's threads a block (two coefficients each; 128 measured
// against 64 and 256, PERF.md) and the data limbs a thread takes
constexpr int kDivideThreads = 128;
constexpr int kDivideGroup = 2;
constexpr int kBgvDivideGroup = 3;       // K'''s (PERF.md)
constexpr long long kMaxGrid = 65535;

__device__ __forceinline__ ulonglong2 load16(const uint64_t *p) {
    return __ldg(reinterpret_cast<const ulonglong2 *>(p));
}

__device__ __forceinline__ void store16_stream(uint64_t *p, uint64_t a,
                                               uint64_t b) {
    __stcs(reinterpret_cast<ulonglong2 *>(p), make_ulonglong2(a, b));
}

__global__ void keyswitch_digits_kernel(uint64_t *__restrict__ out,
                                        const uint64_t *__restrict__ in,
                                        int64_t rows, int used, int log_n,
                                        const uint64_t *__restrict__ moduli,
                                        const uint64_t *__restrict__ cr_hi) {
    __shared__ uint64_t p[MAX_LIMBS], ratio[MAX_LIMBS];
    for (int j = threadIdx.x; j < used; j += blockDim.x) {
        p[j] = moduli[j];
        ratio[j] = cr_hi[j];
    }
    __syncthreads();
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = rows << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t r = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t x = in[idx];
        uint64_t *dst = out + ((r * used) << log_n) + i;
        for (int j = 0; j < used; ++j) {
            dst[static_cast<int64_t>(j) << log_n] =
                barrett_reduce_64(x, p[j], ratio[j]);
        }
    }
}

// K's and F's divide (kBgv false; consts: q (k), cr_hi (k), floor(p/2)
// mod q (k), p^-1 mod q (k) and its Shoup words (k), then p and floor(p/2))
// and K'' (kBgv true; consts: K'-BGV's 7k + 6 words, ops/keyswitch.py
// bgv_divide_consts: those, then tt, tt's high Barrett word, p^-1 mod tt,
// its Shoup word, p mod q (k) and its Shoup words (k)); DivideLayout.
// Block (coefficient pairs blockIdx.x; component comp0 + blockIdx.y; data
// limbs kDivideGroup blockIdx.z onwards). A thread reads its constants
// itself (the same words across the block, from L1), in flight with its
// data; K'' forms neg_k from the special row in every group (the row from
// L2 after the first).
template <bool kBgv, int G>
__device__ __forceinline__ void divide_body(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ x,
        const uint64_t *__restrict__ acc, int comp0, int acc_comps,
        int group, int acc_groups, int k, int log_n,
        const uint64_t *__restrict__ consts) {
    const int comp = comp0 + static_cast<int>(blockIdx.y);
    const int j0 = static_cast<int>(blockIdx.z) * G;
    const int64_t i =
        2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
    const int64_t row = int64_t(1) << log_n;
    if (i >= row) return;
    const DivideLayout L{k};
    const uint64_t *src = x + static_cast<int64_t>(comp) * (k + 1) * row + i;
    const int arow = acc_comps > 0
        ? accumulator_row(comp, group, acc_comps, acc_groups) : -1;
    // the group's rows, row k, the accumulator's rows and the constants,
    // all in flight before any product
    ulonglong2 xv[G], av[G];
    uint64_t q[G], ratio[G], inv[G],
        inv_shoup[G], e[G], e_shoup[G];
    const ulonglong2 xk = load16(src + k * row);
#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (j0 + g < k) xv[g] = load16(src + (j0 + g) * row);
    }
    if (arow >= 0) {
        const uint64_t *ap = acc + static_cast<int64_t>(arow) * k * row + i;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (j0 + g < k) av[g] = load16(ap + (j0 + g) * row);
        }
    }
    // K: p and floor(p/2); K'': tt, its high Barrett word, p^-1 mod tt and
    // its Shoup word
    const uint64_t w0 = __ldg(consts + (kBgv ? L.tt() : L.p()));
    const uint64_t w1 = __ldg(consts + (kBgv ? L.tt_hi() : L.half()));
    const uint64_t w2 = kBgv ? __ldg(consts + L.inv_t()) : 0;
    const uint64_t w3 = kBgv ? __ldg(consts + L.inv_t_shoup()) : 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const int j = j0 + g < k ? j0 + g : j0;
        q[g] = __ldg(consts + L.q() + j);
        ratio[g] = __ldg(consts + L.ratio() + j);
        inv[g] = __ldg(consts + L.inv() + j);
        inv_shoup[g] = __ldg(consts + L.inv_shoup() + j);
        // K: floor(p/2) mod q; K'': p mod q and its Shoup word
        e[g] = __ldg(consts + (kBgv ? L.pm() : L.half_mod()) + j);
        e_shoup[g] = kBgv ? __ldg(consts + L.pm_shoup() + j) : 0;
    }
    // a coefficient's word of row k: K's last + floor(p/2) mod p, K'''s
    // neg_k
    const uint64_t last0 = kBgv ? bgv_neg_k(xk.x, w0, w1, w2, w3)
                                : divide_round_last(xk.x, w0, w1);
    const uint64_t last1 = kBgv ? bgv_neg_k(xk.y, w0, w1, w2, w3)
                                : divide_round_last(xk.y, w0, w1);
    uint64_t *dst = out + static_cast<int64_t>(comp) * k * row + i;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const int j = j0 + g;
        if (j >= k) break;
        uint64_t r0, r1;
        if (kBgv) {
            r0 = bgv_divide_word(xv[g].x, xk.x, last0, q[g], ratio[g], e[g],
                                 e_shoup[g], inv[g], inv_shoup[g]);
            r1 = bgv_divide_word(xv[g].y, xk.y, last1, q[g], ratio[g], e[g],
                                 e_shoup[g], inv[g], inv_shoup[g]);
        } else {
            r0 = divide_round_word(xv[g].x, last0, q[g], ratio[g], e[g],
                                   inv[g], inv_shoup[g]);
            r1 = divide_round_word(xv[g].y, last1, q[g], ratio[g], e[g],
                                   inv[g], inv_shoup[g]);
        }
        if (arow >= 0) {
            r0 = add_mod(av[g].x, r0, q[g]);
            r1 = add_mod(av[g].y, r1, q[g]);
        }
        store16_stream(dst + j * row, r0, r1);
    }
}

__global__ void __launch_bounds__(kDivideThreads)
divide_round_kernel(uint64_t *__restrict__ out,
                    const uint64_t *__restrict__ x,
                    const uint64_t *__restrict__ acc, int comp0,
                    int acc_comps, int group, int acc_groups, int k,
                    int log_n, const uint64_t *__restrict__ consts) {
    divide_body<false, kDivideGroup>(out, x, acc, comp0, acc_comps, group,
                                     acc_groups, k, log_n, consts);
}

__global__ void __launch_bounds__(kDivideThreads)
bgv_divide_kernel(uint64_t *__restrict__ out, const uint64_t *__restrict__ x,
                  const uint64_t *__restrict__ acc, int comp0, int acc_comps,
                  int group, int acc_groups, int k, int log_n,
                  const uint64_t *__restrict__ consts) {
    divide_body<true, kBgvDivideGroup>(out, x, acc, comp0, acc_comps, group,
                                       acc_groups, k, log_n, consts);
}

int divide(bool bgv, void *out, const void *x, const void *acc,
           long long comps, int acc_comps, long long group,
           long long acc_groups, int k, int log_n, const void *consts,
           void *stream) {
    // two coefficients a thread: n even, every pointer 16-byte aligned;
    // components fewer than 2^30 (the 32-bit accumulator rows), 65535 a
    // launch (the grid's y)
    if (k < 1 || k > MAX_LIMBS || (acc_comps > 0 && acc == nullptr) ||
        group < 1 || acc_groups < 1 || acc_comps > group || log_n < 1 ||
        comps < 1 || comps >= (1LL << 30) || group >= (1LL << 30) ||
        acc_groups >= (1LL << 30)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(x) |
         reinterpret_cast<uintptr_t>(acc)) & 15) {
        return static_cast<int>(cudaErrorMisalignedAddress);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long pairs = 1LL << (log_n - 1);
    const int group_size = bgv ? kBgvDivideGroup : kDivideGroup;
    for (long long c0 = 0; c0 < comps; c0 += kMaxGrid) {
        const long long cy = comps - c0 < kMaxGrid ? comps - c0 : kMaxGrid;
        const dim3 grid(static_cast<unsigned>((pairs + kDivideThreads - 1) /
                                              kDivideThreads),
                        static_cast<unsigned>(cy),
                        static_cast<unsigned>((k + group_size - 1) /
                                              group_size));
        const auto kernel = bgv ? &bgv_divide_kernel : &divide_round_kernel;
        kernel<<<grid, kDivideThreads, 0, s>>>(
            static_cast<uint64_t *>(out), static_cast<const uint64_t *>(x),
            static_cast<const uint64_t *>(acc), static_cast<int>(c0),
            acc_comps, static_cast<int>(group), static_cast<int>(acc_groups),
            k, log_n, static_cast<const uint64_t *>(consts));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

// in: (rows, 2^log_n), out: (rows, used, 2^log_n); moduli, cr_hi: (used,).
extern "C" int troy_keyswitch_digits(void *out, const void *in,
                                     long long rows, int used, int log_n,
                                     const void *moduli, const void *cr_hi,
                                     void *stream) {
    if (used < 1 || used > MAX_LIMBS) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    keyswitch_digits_kernel<<<grid_blocks(rows << log_n, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), rows,
        used, log_n, static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_hi));
    TROY_RETURN_LAUNCH_STATUS();
}

// x: (comps, k + 1, 2^log_n) in the coefficient domain, row k the one to
// divide by; out: (comps, k, 2^log_n); acc: (acc_groups, acc_comps, k,
// 2^log_n) or NULL with acc_comps = 0, added onto components h <
// acc_comps of each group of `group` (above); consts: 5k + 2 words. Every
// pointer 16-byte aligned, n at least 2.
extern "C" int troy_keyswitch_divide_round(void *out, const void *x,
                                           const void *acc, long long comps,
                                           int acc_comps, long long group,
                                           long long acc_groups, int k,
                                           int log_n, const void *consts,
                                           void *stream) {
    return divide(false, out, x, acc, comps, acc_comps, group, acc_groups, k,
                  log_n, consts, stream);
}

// The same divide for the BFV mod switch: p is the level's last prime.
extern "C" int troy_mod_switch_divide_round(void *out, const void *x,
                                            const void *acc, long long comps,
                                            int acc_comps, long long group,
                                            long long acc_groups, int k,
                                            int log_n, const void *consts,
                                            void *stream) {
    return divide(false, out, x, acc, comps, acc_comps, group, acc_groups, k,
                  log_n, consts, stream);
}

// K'': the t-corrected divide, coefficient domain; the layout of
// troy_keyswitch_divide_round, consts of 7k + 6 words.
extern "C" int troy_bgv_divide_coeff(void *out, const void *x,
                                     const void *acc, long long comps,
                                     int acc_comps, long long group,
                                     long long acc_groups, int k, int log_n,
                                     const void *consts, void *stream) {
    return divide(true, out, x, acc, comps, acc_comps, group, acc_groups, k,
                  log_n, consts, stream);
}
