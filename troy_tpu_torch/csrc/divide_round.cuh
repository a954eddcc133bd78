// Shared __device__ layer of the divide by the last prime: in the NTT
// domain (kernel K' and K'-BGV) the per-word arithmetic of the temps and
// the finish, in the coefficient domain (kernel F's divide) the rounding
// divide of one word, and the layout of their constants and accumulator.
// K''s own kernels (divide_round_ntt.cu, J's route) and kernel A's fused
// forward passes (ntt.cu, A's route) both run through these functions, as
// do F's own kernel (keyswitch.cu divide_round_kernel: K, J's route, the
// coefficient-sharded key switch) and A's fused inverse pass (ntt.cu,
// AFi), so each pair of routes gives the same words.
//
// x (comps, k + 1, n) holds NTT-form rows over q_0..q_{k-1} and, in row k,
// the prime p to divide by; last = INTT_p(x[c, k]), below p. Then
//
//   temp[c, j, i] = ((last + floor(p/2)) mod p) mod q_j + q_j
//                   - (floor(p/2) mod q_j)                    (< 2 q_j)
//   K'-BGV:  neg_k = (-(last mod tt)) p^-1 mod tt             (0 stays 0)
//            temp[c, j, i] = (neg_k mod q_j)(p mod q_j) + (last mod q_j)
//                            mod q_j                          (< q_j)
//   v = the forward NTT of temp over q_j, lazy (< 4 q_j)
//   out[c, j, i] = (x[c, j, i] + 4 q_j - v) p^-1 mod q_j
//                  + acc[(g % acc_groups) acc_comps + h, j, i]
//
// the accumulator term only for h < acc_comps, where component c is member
// h of group g of `group` components.
#pragma once

#include "u64.cuh"

namespace troy {

// The most limbs a divide takes (K''s constants sit in a fixed
// shared-memory block; ops/keyswitch.py MAX_KERNEL_LIMBS).
constexpr int kDivideMaxLimbs = 64;

// Offsets into the constants of ops/keyswitch.py divide_round_consts (5k +
// 2 words) and bgv_divide_consts (those, then 2k + 4 more), for k limbs.
struct DivideLayout {
    int k;
    __host__ __device__ int q() const { return 0; }
    __host__ __device__ int ratio() const { return k; }      // high Barrett
    __host__ __device__ int half_mod() const { return 2 * k; }
    __host__ __device__ int inv() const { return 3 * k; }    // p^-1 mod q
    __host__ __device__ int inv_shoup() const { return 4 * k; }
    __host__ __device__ int p() const { return 5 * k; }
    __host__ __device__ int half() const { return 5 * k + 1; }
    __host__ __device__ int tt() const { return 5 * k + 2; }
    __host__ __device__ int tt_hi() const { return 5 * k + 3; }
    __host__ __device__ int inv_t() const { return 5 * k + 4; }  // p^-1 mod tt
    __host__ __device__ int inv_t_shoup() const { return 5 * k + 5; }
    __host__ __device__ int pm() const { return 5 * k + 6; }     // p mod q
    __host__ __device__ int pm_shoup() const { return 6 * k + 6; }
    __host__ __device__ int words(bool bgv) const {
        return bgv ? 7 * k + 6 : 5 * k + 2;
    }
};

// K''s temp of one limb from last (< p).
__device__ __forceinline__ uint64_t divide_temp(uint64_t last, uint64_t p,
                                                uint64_t half, uint64_t q,
                                                uint64_t ratio,
                                                uint64_t half_mod) {
    return barrett_reduce_64(add_mod(last, half, p), q, ratio) + q - half_mod;
}

// K'-BGV's multiple of tt for one coefficient: -(last mod tt) p^-1 mod tt.
__device__ __forceinline__ uint64_t bgv_neg_k(uint64_t last, uint64_t tt,
                                              uint64_t tt_hi, uint64_t inv,
                                              uint64_t inv_shoup) {
    return mul_mod_shoup(neg_mod(barrett_reduce_64(last, tt, tt_hi), tt), inv,
                         inv_shoup, tt);
}

// K'-BGV's temp of one limb from last and bgv_neg_k(last).
__device__ __forceinline__ uint64_t bgv_divide_temp(uint64_t last,
                                                    uint64_t neg_k,
                                                    uint64_t q,
                                                    uint64_t ratio,
                                                    uint64_t pm,
                                                    uint64_t pm_shoup) {
    const uint64_t delta = mul_mod_shoup(barrett_reduce_64(neg_k, q, ratio),
                                         pm, pm_shoup, q);
    return add_mod(delta, barrett_reduce_64(last, q, ratio), q);
}

// K'''s divide of one word in the coefficient domain (x < q) from last,
// word i of row k, and bgv_neg_k(last): (x + 2 q - (last mod q) -
// (neg_k mod q)(p mod q)) p^-1 mod q; the lazy sum stays below 3 q < 2^63,
// where the Shoup product is exact.
__device__ __forceinline__ uint64_t bgv_divide_word(
        uint64_t x, uint64_t last, uint64_t neg_k, uint64_t q, uint64_t ratio,
        uint64_t pm, uint64_t pm_shoup, uint64_t inv, uint64_t inv_shoup) {
    const uint64_t delta = mul_mod_shoup(barrett_reduce_64(neg_k, q, ratio),
                                         pm, pm_shoup, q);
    return mul_mod_shoup(x + (2 * q - barrett_reduce_64(last, q, ratio) -
                              delta),
                         inv, inv_shoup, q);
}

// The finish of one word: x < q, v the lazy forward transform (< 4 q).
__device__ __forceinline__ uint64_t divide_finish(uint64_t x, uint64_t v,
                                                  uint64_t q, uint64_t inv,
                                                  uint64_t inv_shoup) {
    return mul_mod_shoup(x + 4 * q - v, inv, inv_shoup, q);
}

// F's divide, coefficient domain: x_k, word i of row k (below p), offset
// by floor(p/2) once for all limbs ...
__device__ __forceinline__ uint64_t divide_round_last(uint64_t x_k,
                                                      uint64_t p,
                                                      uint64_t half) {
    return add_mod(x_k, half, p);
}

// ... then word i of row j (x < q): (x - (last mod q - floor(p/2) mod q))
// p^-1 mod q.
__device__ __forceinline__ uint64_t divide_round_word(uint64_t x,
                                                      uint64_t last,
                                                      uint64_t q,
                                                      uint64_t ratio,
                                                      uint64_t half_mod,
                                                      uint64_t inv,
                                                      uint64_t inv_shoup) {
    const uint64_t temp =
        sub_mod(barrett_reduce_64(last, q, ratio), half_mod, q);
    return mul_mod_shoup(sub_mod(x, temp, q), inv, inv_shoup, q);
}

// The accumulator row added onto component `comp`, or -1 for none (32-bit
// quotients: the kernels take fewer than 2^30 rows).
__device__ __forceinline__ int accumulator_row(int comp, int group,
                                               int acc_comps, int acc_groups) {
    const int g = comp / group, h = comp - g * group;
    return h < acc_comps ? (g % acc_groups) * acc_comps + h : -1;
}

}  // namespace troy
