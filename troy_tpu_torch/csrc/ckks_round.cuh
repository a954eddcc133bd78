// Shared __device__ layer of the CKKS encode's exact rounding into RNS:
// kernel O2 (and O4) of embedding.cu (round_kernel) and its fold into
// kernel A's first forward pass (ntt.cu troy_ntt_forward_round, AO2p) run
// every word through these functions, so both give the words of the plain
// version (troy_tpu_torch/ops/embedding.py untwist_round_to_rns_plain),
// and so of troy_tpu/ops/embedding.py:425 round_to_rns_device wherever
// that one rounds exactly.
//
// A word: v = rint(Re(u * untwist) * scale) (the slot encode) or
// rint(c * scale) (the polynomial encode's real coefficients), split as
// |v| = m 2^e with m < 2^53 an integer (exact at any magnitude), then
// into limb q: (m mod q) (2^e mod q) mod q, negated where v < 0.
//
// Floating point: each f64 step is written with __dmul_rn / __dsub_rn,
// which nvcc never contracts into a fused multiply-add (it contracts
// a * b - c * d by default), so the bits are the plain version's.
//
// The constants (ops/embedding.py make_rns_round_tables, RoundLayout
// below): q (k), the high Barrett words (k), 2^e mod q (k x E) and their
// Shoup words (k x E), E the exponents 0..E-1 a word may need.
#pragma once

#include "u64.cuh"

namespace troy {

struct RoundLayout {
    int k, E;
    __host__ __device__ int q() const { return 0; }
    __host__ __device__ int ratio() const { return k; }
    __host__ __device__ int pow2() const { return 2 * k; }
    __host__ __device__ int pow2_shoup() const { return 2 * k + k * E; }
};

// Re(x * t), uncontracted.
__device__ __forceinline__ double untwisted_re(double2 x, double2 t) {
    return __dsub_rn(__dmul_rn(x.x, t.x), __dmul_rn(x.y, t.y));
}

// A rounded value's sign and |v| = m 2^e, e clamped to 0..E-1.
struct RoundedWord {
    uint64_t m;
    int e;
    bool neg;
};

// rint(re * scale) split; |v| for the statistic of O4 through `a`. The
// exponent comes from a's bits (a = 1.f 2^(b - 1023), b its biased
// exponent): e = b - 1075, and m = 1.f 2^52, the mantissa with its hidden
// bit, where 0 < e < E; below 2^53 (e <= 0) m = a, converted exactly; past
// 2^(52 + E) (not a value of the encoder: E = bits(Q) - 52, so E < 973
// there) e = E - 1 and m = a 2^-e, a scaling by a power of two, as the
// plain version clamps. The same m and e as frexp and ldexp give. Every
// case is computed and one selected, with no branch, so that the words of
// a thread interleave their arithmetic.
__device__ __forceinline__ RoundedWord round_split(double re, double scale,
                                                   int E, double &a) {
    const double v = rint(__dmul_rn(re, scale));
    a = fabs(v);
    const uint64_t bits = static_cast<uint64_t>(__double_as_longlong(a));
    const int e = static_cast<int>(bits >> 52) - 1075;
    const double down = __longlong_as_double(
        static_cast<long long>(E < 1024 ? 1024 - E : 1) << 52);  // 2^(1-E)
    const uint64_t m =
        e <= 0 ? static_cast<uint64_t>(a)
        : e < E ? (bits & ((uint64_t(1) << 52) - 1)) | (uint64_t(1) << 52)
                : static_cast<uint64_t>(__dmul_rn(a, down));
    return {m, e <= 0 ? 0 : (e < E ? e : E - 1), v < 0.0};
}

// One limb's word of a split value: pow2 and pow2_shoup the limb's rows of
// 2^e mod q and its Shoup words, read and multiplied only where e > 0
// (2^0 mod q = 1, whose Shoup product gives the word back).
__device__ __forceinline__ uint64_t round_limb(const RoundedWord &w,
                                               uint64_t q, uint64_t ratio,
                                               const uint64_t *pow2,
                                               const uint64_t *pow2_shoup) {
    uint64_t r = barrett_reduce_64(w.m, q, ratio);
    if (w.e > 0) {
        r = mul_mod_shoup(r, __ldg(pow2 + w.e), __ldg(pow2_shoup + w.e), q);
    }
    return w.neg ? neg_mod(r, q) : r;
}

}  // namespace troy
