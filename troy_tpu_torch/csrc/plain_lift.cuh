// Shared __device__ layer of the plain lift mod t -> RNS: kernel G'
// (plain_embed.cu troy_plain_lift) and its fold into kernel A's first
// forward pass (ntt.cu troy_ntt_forward_lift, AGp) run every word through
// these functions, so both give the words of troy_tpu/ops/poly.py:71
// plain_lift (after the BGV add_plain's m * cf mod t,
// troy_tpu/evaluator.py:767-768), step for step the plain version in
// troy_tpu_torch/ops/poly.py.
//
// The constants (ops/poly.py plain_lift_consts, LiftLayout below): t, then
// the k moduli q_j, their high Barrett words and (Q - t) mod q_j.
#pragma once

#include "u64.cuh"

namespace troy {

struct LiftLayout {
    int k;
    __host__ __device__ int t() const { return 0; }
    __host__ __device__ int q() const { return 1; }
    __host__ __device__ int cr_hi() const { return 1 + k; }
    __host__ __device__ int inc() const { return 1 + 2 * k; }
    __host__ __device__ int words() const { return 1 + 3 * k; }
};

// m < t times the correction factor mod t (Shoup), the word itself at
// cf = 1.
__device__ __forceinline__ uint64_t lift_scale(uint64_t m, uint64_t t,
                                               uint64_t cf,
                                               uint64_t cf_shoup) {
    return cf != 1 ? mul_mod_shoup(m, cf, cf_shoup, t) : m;
}

// A scaled coefficient mv < t in limb q: mv mod q (Barrett where t > q),
// plus (Q - t) mod q (inc) where mv is at or above the threshold (upper),
// i.e. the residue of mv - t.
__device__ __forceinline__ uint64_t lift_limb(uint64_t mv, bool upper,
                                              uint64_t t, uint64_t q,
                                              uint64_t cr_hi, uint64_t inc) {
    const uint64_t mj = t <= q ? mv : barrett_reduce_64(mv, q, cr_hi);
    return upper ? add_mod(mj, inc, q) : mj;
}

}  // namespace troy
