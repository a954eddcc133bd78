// Shared __device__ layer of the butterfly transforms: kernel A (ntt.cu,
// the negacyclic NTT of a whole row) and kernel J (ntt_mxu.cu, the short
// transforms of the 4-step stages) run their rounds through these
// functions, so both give the butterfly network's words.
//
// A 2^log_line-point transform runs log_line rounds; round rho joins the
// words whose indices differ in bit log_line - 1 - rho, and its butterfly
// at word index i takes the twiddle w_tab[2^rho + (i >> (log_line - rho))]
// with its Shoup word from wq_tab (the bit-reversed root-power layout of
// ops/ntt.py). Forward: Harvey lazy Cooley-Tukey, words in [0, 4q) stay
// in [0, 4q). Inverse: Gentleman-Sande in the reverse round order, words
// in [0, 2q) stay in [0, 2q); neither scales by the length's inverse.
#pragma once

#include "u64.cuh"

namespace troy {

// Rounds rho0 .. rho0 + R - 1 (forward in that order, inverse in the
// reverse) on the 2^R words v[j] = word base + (j << log_h) of one line,
// in registers.
template <int R, bool kInverse>
__device__ __forceinline__ void butterfly_rounds(uint64_t (&v)[1 << R],
                                                 const uint64_t *w_tab,
                                                 const uint64_t *wq_tab,
                                                 int base, int log_h,
                                                 int rho0, int log_line,
                                                 uint64_t q) {
    const uint64_t q2 = 2 * q;
#pragma unroll
    for (int s = 0; s < R; ++s) {
        const int t = kInverse ? R - 1 - s : s;
        const int rho = rho0 + t;
        const int d = 1 << (R - 1 - t);
#pragma unroll
        for (int j = 0; j < (1 << R); ++j) {
            if (j & d) continue;
            const int blk = (base + (j << log_h)) >> (log_line - rho);
            const int idx = (1 << rho) + blk;
            const uint64_t w = w_tab[idx];
            const uint64_t wq = wq_tab[idx];
            if (!kInverse) {
                uint64_t a = v[j];
                a = a >= q2 ? a - q2 : a;
                const uint64_t bw = mul_mod_shoup_lazy(v[j + d], w, wq, q);
                v[j] = a + bw;
                v[j + d] = a - bw + q2;
            } else {
                const uint64_t a = v[j];
                const uint64_t c = v[j + d];
                uint64_t sum = a + c;
                sum = sum >= q2 ? sum - q2 : sum;
                v[j] = sum;
                v[j + d] = mul_mod_shoup_lazy(a - c + q2, w, wq, q);
            }
        }
    }
}

// The rounds of stage s of a line's ceil(log_line / 3) stages (in reverse
// for the inverse), as even as they go, three at most: R of them from
// round rho0.
__device__ __forceinline__ void stage_plan(int s, int log_line, bool inverse,
                                           int &R, int &rho0) {
    const int stages = (log_line + 2) / 3;
    const int si = inverse ? stages - 1 - s : s;
    const int small = log_line / stages, extra = log_line % stages;
    R = small + (si < extra ? 1 : 0);
    rho0 = si * small + (si < extra ? si : extra);
}

}  // namespace troy
