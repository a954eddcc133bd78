// Kernel K': the divide by the last prime with rounding, in the NTT domain.
//
// Replaces troy_tpu/ops/rns.py:213 divide_and_round_q_last_ntt (the CKKS
// rescale) and the NTT-form branch of troy_tpu/evaluator.py:337-351 (the key
// switch's divide by the special prime for CKKS, is_ntt_scheme). Both
// divide x (NTT form over q_0..q_{k-1} plus the prime p in row k) by p:
//
//   temps:   last = INTT_p(x[c, k]) (kernel A, before this launch)
//            temp[c, j, i] = ((last + floor(p/2)) mod p) mod q_j + q_j
//                            - (floor(p/2) mod q_j)          (< 2 q_j)
//   (kernel A: the forward NTT of temp over q_0..q_{k-1}, lazy, < 4 q_j)
//   finish:  out[c, j, i] = (x[c, j, i] + 4 q_j - temp[c, j, i]) p^-1 mod q_j
//                           (+ acc on the first acc_comps components of
//                           each group: (c0, c1) for relinearization, c0
//                           for a Galois automorphism, c0 of each
//                           ciphertext of a batch)
//
// These are the words of the JAX package's fully reduced chain (subtract,
// NTT, subtract, multiply), since the final Shoup product reduces fully.
// The rescale and the key switch call the same device functions through
// their own entry points, so each keeps its own launch count (as F and K
// do).
//
// K'-BGV, the BGV members (troy_tpu/ops/rns.py:246
// mod_t_and_divide_q_last_ntt and the BGV branch of
// troy_tpu/evaluator.py:320-336), subtract from x a multiple of the plain
// modulus tt that makes row k divisible by p, then divide; only the temps
// differ:
//
//   bgv temps: neg_k = (-(last mod tt)) p^-1 mod tt          (0 stays 0)
//              temp[c, j, i] = (neg_k mod q_j)(p mod q_j) + (last mod q_j)
//                              mod q_j                       (< q_j)
//
// and the finish is K''s. The JAX package reduces fully between these
// steps; so does the finish, so the words agree. The BGV mod switch has its
// own finish entry (its launches count apart, as the rescale's do); the
// BGV key switch shares K''s key-switch finish.
//
// What bounds it on the H100: at n = 16384 the launches (under 3 MB of
// words). Design: one thread per coefficient of one component for the
// temps (one read of the special row for all k limbs), one per output word
// for the finish; coalesced; the constants (5k + 2 words, the layout of
// ops/keyswitch.py divide_round_consts) in shared memory. The per-word
// arithmetic is divide_round.cuh's, shared with kernel A's fused forward
// (ntt.cu), which runs the temps in A's first pass and the finish in its
// last on A's route; these kernels serve J's route (use_mxu, n > 131072,
// the coefficient-sharded key switch).

#include "divide_round.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = kDivideMaxLimbs;
constexpr int THREADS = 256;

// last: (comps, n) coefficient form below p; out: (comps, k, n).
__global__ void temps_kernel(uint64_t *__restrict__ out,
                             const uint64_t *__restrict__ last, int64_t comps,
                             int k, int log_n,
                             const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[5 * MAX_LIMBS + 2];
    const DivideLayout L{k};
    for (int j = threadIdx.x; j < L.words(false); j += blockDim.x) {
        c[j] = consts[j];
    }
    __syncthreads();
    const uint64_t *q = c + L.q(), *ratio = c + L.ratio();
    const uint64_t *half_mod = c + L.half_mod();
    const uint64_t p = c[L.p()], half = c[L.half()];
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = comps << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t comp = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t l = last[idx];
        uint64_t *dst = out + ((comp * k) << log_n) + i;
        for (int j = 0; j < k; ++j) {
            dst[static_cast<int64_t>(j) << log_n] =
                divide_temp(l, p, half, q[j], ratio[j], half_mod[j]);
        }
    }
}

// The BGV temps. consts: K''s 5k + 2 words, then tt, tt's high Barrett
// word, p^-1 mod tt, its Shoup word, p mod q_j (k) and their Shoup words
// (k) (ops/keyswitch.py bgv_divide_consts; DivideLayout).
__global__ void bgv_temps_kernel(uint64_t *__restrict__ out,
                                 const uint64_t *__restrict__ last,
                                 int64_t comps, int k, int log_n,
                                 const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[7 * MAX_LIMBS + 6];
    const DivideLayout L{k};
    for (int j = threadIdx.x; j < L.words(true); j += blockDim.x) {
        c[j] = consts[j];
    }
    __syncthreads();
    const uint64_t *q = c + L.q(), *ratio = c + L.ratio();
    const uint64_t tt = c[L.tt()], tt_hi = c[L.tt_hi()];
    const uint64_t inv = c[L.inv_t()], inv_shoup = c[L.inv_t_shoup()];
    const uint64_t *pm = c + L.pm(), *pm_shoup = c + L.pm_shoup();
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = comps << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t comp = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t l = last[idx];
        const uint64_t neg_k = bgv_neg_k(l, tt, tt_hi, inv, inv_shoup);
        uint64_t *dst = out + ((comp * k) << log_n) + i;
        for (int j = 0; j < k; ++j) {
            dst[static_cast<int64_t>(j) << log_n] =
                bgv_divide_temp(l, neg_k, q[j], ratio[j], pm[j], pm_shoup[j]);
        }
    }
}

// x: (comps, k + 1, n), rows 0..k-1 read; temps, out: (comps, k, n); acc:
// (acc_groups, acc_comps, k, n) or NULL: acc[g % acc_groups, h] is added
// onto component h < acc_comps of each group g of `group` components (the
// layout of csrc/keyswitch.cu's divide).
__global__ void finish_kernel(uint64_t *__restrict__ out,
                              const uint64_t *__restrict__ x,
                              const uint64_t *__restrict__ temps,
                              const uint64_t *__restrict__ acc,
                              int64_t comps, int acc_comps, int64_t group,
                              int64_t acc_groups, int k, int log_n,
                              const uint64_t *__restrict__ consts) {
    __shared__ uint64_t c[5 * MAX_LIMBS + 2];
    const DivideLayout L{k};
    for (int j = threadIdx.x; j < L.words(false); j += blockDim.x) {
        c[j] = consts[j];
    }
    __syncthreads();
    const uint64_t *q = c + L.q(), *inv = c + L.inv();
    const uint64_t *inv_shoup = c + L.inv_shoup();
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (comps * k) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t row = idx >> log_n;
        const int64_t comp = row / k;
        const int j = static_cast<int>(row - comp * k);
        const int64_t i = idx & (n - 1);
        const uint64_t xv = x[((row + comp) << log_n) + i];  // row j of k+1
        uint64_t r = divide_finish(xv, temps[idx], q[j], inv[j], inv_shoup[j]);
        const int64_t arow = accumulator_row(
            static_cast<int>(comp), static_cast<int>(group), acc_comps,
            static_cast<int>(acc_groups));
        if (arow >= 0) {
            r = add_mod(acc[((arow * k + j) << log_n) + i], r, q[j]);
        }
        out[idx] = r;
    }
}

int temps(void *out, const void *last, long long comps, int k, int log_n,
          const void *consts, void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    temps_kernel<<<grid_blocks(comps << log_n, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(last),
        comps, k, log_n, static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}

int bgv_temps(void *out, const void *last, long long comps, int k, int log_n,
              const void *consts, void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    bgv_temps_kernel<<<grid_blocks(comps << log_n, THREADS), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(last),
        comps, k, log_n, static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}

int finish(void *out, const void *x, const void *temps_in, const void *acc,
           long long comps, int acc_comps, long long group,
           long long acc_groups, int k, int log_n, const void *consts,
           void *stream) {
    if (k < 1 || k > MAX_LIMBS || (acc_comps > 0 && acc == nullptr) ||
        group < 1 || acc_groups < 1 || acc_comps > group) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    finish_kernel<<<grid_blocks((comps * k) << log_n, THREADS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(x),
        static_cast<const uint64_t *>(temps_in),
        static_cast<const uint64_t *>(acc), comps, acc_comps, group,
        acc_groups, k, log_n, static_cast<const uint64_t *>(consts));
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// The CKKS rescale: p = the level's last prime, no accumulator.
extern "C" int troy_rescale_ntt_temps(void *out, const void *last,
                                      long long comps, int k, int log_n,
                                      const void *consts, void *stream) {
    return temps(out, last, comps, k, log_n, consts, stream);
}

extern "C" int troy_rescale_ntt_finish(void *out, const void *x,
        const void *temps_in, const void *acc, long long comps,
        int acc_comps, long long group, long long acc_groups, int k,
        int log_n, const void *consts, void *stream) {
    return finish(out, x, temps_in, acc, comps, acc_comps, group, acc_groups,
                  k, log_n, consts, stream);
}

// The NTT-form key switch: p = the special prime, accumulator (c0, c1) or c0.
extern "C" int troy_keyswitch_ntt_temps(void *out, const void *last,
                                        long long comps, int k, int log_n,
                                        const void *consts, void *stream) {
    return temps(out, last, comps, k, log_n, consts, stream);
}

extern "C" int troy_keyswitch_ntt_finish(void *out, const void *x,
        const void *temps_in, const void *acc, long long comps,
        int acc_comps, long long group, long long acc_groups, int k,
        int log_n, const void *consts, void *stream) {
    return finish(out, x, temps_in, acc, comps, acc_comps, group, acc_groups,
                  k, log_n, consts, stream);
}

// The BGV mod switch: p = the level's last prime, no accumulator.
extern "C" int troy_bgv_mod_switch_ntt_temps(void *out, const void *last,
                                             long long comps, int k,
                                             int log_n, const void *consts,
                                             void *stream) {
    return bgv_temps(out, last, comps, k, log_n, consts, stream);
}

extern "C" int troy_bgv_mod_switch_ntt_finish(void *out, const void *x,
        const void *temps_in, const void *acc, long long comps,
        int acc_comps, long long group, long long acc_groups, int k,
        int log_n, const void *consts, void *stream) {
    return finish(out, x, temps_in, acc, comps, acc_comps, group, acc_groups,
                  k, log_n, consts, stream);
}

// The BGV key switch: p = the special prime; its finish is
// troy_keyswitch_ntt_finish.
extern "C" int troy_bgv_keyswitch_ntt_temps(void *out, const void *last,
                                            long long comps, int k, int log_n,
                                            const void *consts, void *stream) {
    return bgv_temps(out, last, comps, k, log_n, consts, stream);
}
