// Shared __device__ layer of the BFV plain embedding round(Q m / t) into
// limb q_j: kernel G (rns_elementwise.cu troy_bfv_plain_embed, c0 +-
// round(Q m / t)) and its fold into kernel D's zero-encryption finish (DG,
// troy_rns_zero_embed) run every word through these functions, so both
// give the words of troy_tpu/ops/poly.py:98 bfv_multiply_add_plain and of
// its plain version in troy_tpu_torch/ops/poly.py.
//
// round(Q m / t) = m floor(Q/t) + fix with fix = floor((m (Q mod t) +
// (t+1)/2) / t) (scalingvariant.cpp multiplyAddPlainWithScalingVariant).
// The plain version (troy_tpu's steps) divides the 128-bit m (Q mod t) +
// (t+1)/2 exactly through a Barrett-128 remainder, a shift out of t's
// power of two and the inverse of its odd part. The kernels divide by t
// through the Shoup word of w = Q mod t instead: quo = floor(m w' / 2^64)
// with w' = floor(w 2^64 / t) leaves m w - quo t in [0, 2t) (m, w < t <
// 2^61), one conditional subtract makes it the remainder r, and fix =
// quo + (r + (t+1)/2 >= t), since r + (t+1)/2 < 2t. The same integer, so
// the same words, for three 64-bit products where the 128-bit division
// took about ten (the Barrett-128 form cost 2.60 us a launch at m (n) onto
// c0 (5, n), and 7.7 at a batch of 8, on an H100 80GB HBM3 at 700 W,
// PERF.md). A limb's term m floor(Q/t) + fix is reduced by two
// conditional subtracts where t <= q (it is below 3q), else by Barrett.
//
// The constants (ops/poly.py _plain_embed_consts, EmbedLayout below): t,
// (t+1)/2, w = Q mod t and its Shoup word w'; then per limb q (k), the
// high Barrett words (k), floor(Q/t) mod q (k) and its Shoup words (k).
#pragma once

#include "u64.cuh"

namespace troy {

struct EmbedLayout {
    int k;
    static constexpr int kTWords = 4;
    __host__ __device__ int q() const { return kTWords; }
    __host__ __device__ int cr_hi() const { return kTWords + k; }
    __host__ __device__ int d() const { return kTWords + 2 * k; }
    __host__ __device__ int d_shoup() const { return kTWords + 3 * k; }
    __host__ __device__ int words() const { return kTWords + 4 * k; }
};

// The t-side constants, read from the first EmbedLayout::kTWords words.
struct EmbedT {
    uint64_t t, half, w, w_shoup;
};

__device__ __forceinline__ EmbedT embed_t(const uint64_t *consts) {
    return {__ldg(consts), __ldg(consts + 1), __ldg(consts + 2),
            __ldg(consts + 3)};
}

// fix = floor((m (Q mod t) + (t+1)/2) / t) of a coefficient m < t.
__device__ __forceinline__ uint64_t embed_fix(uint64_t m, const EmbedT &e) {
    uint64_t quo = __umul64hi(m, e.w_shoup);
    uint64_t r = m * e.w - quo * e.t;
    if (r >= e.t) {
        r -= e.t;
        ++quo;
    }
    return quo + (r + e.half >= e.t ? 1 : 0);
}

// round(Q m / t) mod q: m floor(Q/t) mod q (lazy Shoup, in [0, 2q) for
// any m) plus fix < t, reduced to [0, q): by two conditional subtracts
// where t <= q (small, uniform over a block), else by Barrett.
__device__ __forceinline__ uint64_t embed_limb(uint64_t m, uint64_t fix,
                                               uint64_t q, uint64_t cr_hi,
                                               uint64_t d, uint64_t d_shoup,
                                               bool small) {
    const uint64_t s = mul_mod_shoup_lazy(m, d, d_shoup, q) + fix;
    return small ? reduce_4q(s, q) : barrett_reduce_64(s, q, cr_hi);
}

}  // namespace troy
