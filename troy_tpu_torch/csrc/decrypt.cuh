// Shared __device__ layer of the decrypt's last step, the phase's k residues
// of one coefficient to one word mod t:
//
//   * kernel X's exact conversion q -> t with the inverse correction factor
//     (BGV; exact_convert.cu, and AXi, A's last inverse pass, ntt.cu);
//   * kernel C's conversion q -> {t, gamma} (base_convert.cu: its layout;
//     ACi: the two sums of one coefficient) and kernel E's gamma rounding
//     of its two words (BFV; behz.cu's behz_decrypt_round_kernel, and
//     ACi).
//
// Each pair of routes runs these functions, so a fused pass and the
// composition it replaces give the same words.
//
// X, per coefficient (troy_tpu/ops/rns.py:67-108, then the multiply by
// the inverse correction factor, troy_tpu/decryptor.py:64-66):
//
//   temp_i = x_i (Q/q_i)^-1 mod q_i                           (Shoup)
//   alpha  = round(sum_i temp_i / q_i) in Q.64 fixed point: each term is
//            mulhi(temp_i, w_lo_i) + temp_i w_hi_i with w = floor(2^128/q_i),
//            summed in 128 bits; alpha = hi + (lo >> 63)
//   out    = ((sum_i temp_i (Q/q_i mod t)) mod t - (alpha mod t)(Q mod t))
//            mod t, then times cf^-1 mod t
//
// the JAX package's fixed point, not the doubles of troy's C++
// exactConvertArray, so the words are troy_tpu's; the 128-bit sums carry
// as in ops/u64ops.add_u128. cf^-1 = 1 leaves the words as they are (a
// Shoup product by 1 of a reduced word is the word).
//
// C then E (troy_tpu/ops/rns.py:169 decrypt_scale_and_round, the phase
// times t gamma folded into C's constants):
//
//   temp_i = x_i invp_i mod q_i                               (Shoup)
//   x_t    = sum_i temp_i (Q/q_i mod t) mod t, x_g the same mod gamma
//            (128-bit sums, Barrett-128)
//   v_t, v_g = x_t (-Q^-1) mod t, x_g (-Q^-1) mod gamma
//   out    = (v_t +/- (v_g or gamma - v_g) mod t) gamma^-1 mod t
#pragma once

#include "u64.cuh"

namespace troy {

// Offsets into X's constants (ops/rns.py ExactConverter, 6k + 5 words): q,
// (Q/q_i)^-1 mod q_i, its Shoup words, floor(2^128/q_i) low and high words,
// (Q/q_i) mod t (k each); t, floor(2^128/t) low and high words, Q mod t and
// its Shoup word.
struct ExactLayout {
    int k;
    __host__ __device__ int q() const { return 0; }
    __host__ __device__ int invp() const { return k; }
    __host__ __device__ int invp_shoup() const { return 2 * k; }
    __host__ __device__ int w_lo() const { return 3 * k; }
    __host__ __device__ int w_hi() const { return 4 * k; }
    __host__ __device__ int mat() const { return 5 * k; }
    __host__ __device__ int t() const { return 6 * k; }
    __host__ __device__ int cr_lo() const { return 6 * k + 1; }
    __host__ __device__ int cr_hi() const { return 6 * k + 2; }
    __host__ __device__ int q_mod() const { return 6 * k + 3; }
    __host__ __device__ int q_mod_shoup() const { return 6 * k + 4; }
    __host__ __device__ int words() const { return 6 * k + 5; }
};

// Offsets into one converter's constants (ops/rns.py DeviceConverter):
// q_in, inv_punctured, its Shoup words (k_in each); p_out, the low and
// high Barrett-128 words (k_out each); M (k_out x k_in), M[o][i] = (Q/q_i)
// mod p_o.
struct ConvertLayout {
    int k_in, k_out;
    __host__ __device__ int q_in() const { return 0; }
    __host__ __device__ int invp() const { return k_in; }
    __host__ __device__ int invp_shoup() const { return 2 * k_in; }
    __host__ __device__ int p_out() const { return 3 * k_in; }
    __host__ __device__ int cr_lo() const { return 3 * k_in + k_out; }
    __host__ __device__ int cr_hi() const { return 3 * k_in + 2 * k_out; }
    __host__ __device__ int mat() const { return 3 * k_in + 3 * k_out; }
    __host__ __device__ int words() const {
        return 3 * k_in + 3 * k_out + k_in * k_out;
    }
};

// The rounding's constants (ops/rns.py DeviceRnsTool.decrypt_consts).
constexpr int kRoundConsts = 9;

// X's running sums of one coefficient.
struct ExactSum {
    uint64_t frac_lo, frac_hi, acc_lo, acc_hi;
};

// Limb j's term of one coefficient: x below q_j, c in ExactLayout{k}.
__device__ __forceinline__ void exact_add(ExactSum &s, uint64_t x,
                                          const uint64_t *c, int k, int j) {
    const ExactLayout L{k};
    const uint64_t temp = mul_mod_shoup(x, c[L.invp() + j],
                                        c[L.invp_shoup() + j], c[L.q() + j]);
    uint64_t lo, hi;
    mul128(temp, c[L.w_hi() + j], lo, hi);
    const uint64_t term_lo = mulhi64(temp, c[L.w_lo() + j]) + lo;
    const uint64_t term_hi = hi + (term_lo < lo);
    s.frac_lo += term_lo;
    s.frac_hi += term_hi + (s.frac_lo < term_lo);
    mul128(temp, c[L.mat() + j], lo, hi);
    s.acc_lo += lo;
    s.acc_hi += hi + (s.acc_lo < lo);
}

// The coefficient's word mod t from its k terms, times cf^-1.
__device__ __forceinline__ uint64_t exact_finish(const ExactSum &s,
                                                 const uint64_t *c, int k,
                                                 uint64_t inv_cf,
                                                 uint64_t inv_cf_shoup) {
    const ExactLayout L{k};
    const uint64_t t = c[L.t()], cr_hi = c[L.cr_hi()];
    const uint64_t alpha = s.frac_hi + (s.frac_lo >> 63);   // round half up
    const uint64_t sum =
        barrett_reduce_128(s.acc_lo, s.acc_hi, t, c[L.cr_lo()], cr_hi);
    const uint64_t alpha_q = mul_mod_shoup(barrett_reduce_64(alpha, t, cr_hi),
                                           c[L.q_mod()], c[L.q_mod_shoup()],
                                           t);
    return mul_mod_shoup(sub_mod(sum, alpha_q, t), inv_cf, inv_cf_shoup, t);
}

// E's rounding of one coefficient's residues x_t mod t and x_g mod gamma;
// c: the kRoundConsts words (-Q^-1 mod t and mod gamma with their Shoup
// words, the high Barrett word of t, gamma^-1 mod t with its Shoup word,
// t, gamma).
__device__ __forceinline__ uint64_t decrypt_round(uint64_t xt, uint64_t xg,
                                                  const uint64_t *c) {
    const uint64_t t = c[7], gamma = c[8];
    const uint64_t vt = mul_mod_shoup(xt, c[0], c[1], t);
    const uint64_t vg = mul_mod_shoup(xg, c[2], c[3], gamma);
    const uint64_t corrected =
        vg > (gamma >> 1)
            ? add_mod(vt, barrett_reduce_64(gamma - vg, t, c[4]), t)
            : sub_mod(vt, barrett_reduce_64(vg, t, c[4]), t);
    return mul_mod_shoup(corrected, c[5], c[6], t);
}

// C's two sums of one coefficient, into {t, gamma}.
struct TGammaSum {
    u128 t, gamma;
};

// Limb j's term: x below q_j (any word: Shoup), c in ConvertLayout{k, 2}.
__device__ __forceinline__ void t_gamma_add(TGammaSum &s, uint64_t x,
                                            const uint64_t *c, int k, int j) {
    const ConvertLayout L{k, 2};
    const uint64_t temp = mul_mod_shoup(x, c[L.invp() + j],
                                        c[L.invp_shoup() + j],
                                        c[L.q_in() + j]);
    s.t += static_cast<u128>(temp) * c[L.mat() + j];
    s.gamma += static_cast<u128>(temp) * c[L.mat() + k + j];
}

// The coefficient's word mod t: C's two sums reduced, then E's rounding
// with rc (kRoundConsts words).
__device__ __forceinline__ uint64_t t_gamma_round(const TGammaSum &s,
                                                  const uint64_t *c, int k,
                                                  const uint64_t *rc) {
    const ConvertLayout L{k, 2};
    const uint64_t xt = barrett_reduce_128(
        static_cast<uint64_t>(s.t), static_cast<uint64_t>(s.t >> 64),
        c[L.p_out()], c[L.cr_lo()], c[L.cr_hi()]);
    const uint64_t xg = barrett_reduce_128(
        static_cast<uint64_t>(s.gamma), static_cast<uint64_t>(s.gamma >> 64),
        c[L.p_out() + 1], c[L.cr_lo() + 1], c[L.cr_hi() + 1]);
    return decrypt_round(xt, xg, rc);
}

}  // namespace troy
