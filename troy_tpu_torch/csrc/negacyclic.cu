// Kernels N1 and N2: the negacyclic shift family and the pack-tree prepare.
//
// N1 multiplies by x^s mod x^n + 1: a roll of the coefficients with the
// wrapped part negated mod q_i, 0 staying 0. It replaces
// troy_tpu/ops/poly.py:146 negacyclic_shift and, through two more entry
// points on the same device function, troy_tpu/evaluator.py:647
// _extract_lwe_many_core and :674 _pack_assemble_core:
//
//   shift:    out[b, r, (p + s_b) mod n] = +-x[b, r, p]
//   extract:  c1s[b, i, (p + s_b) mod n] = +-c1[i, p]    for every b, and
//             c0s[b, i] = c0[i, term_b], term_b = (2n - s_b) mod 2n
//   assemble: out[b, 1, i, (p + s_b) mod n] = +-c1s[b, i, p] * w_i, and
//             out[b, 0, i, j] = (j == s_b) ? c0s[b, i] * w_i : 0
//
// with the sign - where p + s_b lies in [n, 2n) (x^n = -1), s_b in [0, 2n)
// from a device int64 array or one scalar, and w_i an optional per-limb
// Shoup scalar of the assemble (its n^-1 mod q_i). The words are the JAX
// package's: negation and the Shoup product are fully reduced, so their
// order does not matter.
//
// N2 replaces troy_tpu/evaluator.py:573 _pack_fold_prepare (coefficient
// domain): from cur (2m, 2, k, n) it writes even + x^s odd and
// even - x^s odd in one pass, two reads and two writes per word.
//
// What bounds them on the H100: bytes. Design: one thread per SOURCE word,
// which computes its destination; a warp's 32 consecutive source words
// land on 32 consecutive destinations (one wrap point at most), so loads
// and stores are coalesced. The extract reads c1 once in all: each thread
// keeps its word in a register and writes it for every shift of the batch.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 64;
constexpr int THREADS = 256;

// Destination of source coefficient p under x^s, s any int64 (taken mod
// 2n), and whether it is negated: p + s (mod 2n) lands in [n, 2n).
__device__ __forceinline__ int64_t shift_dest(int64_t p, int64_t s, int log_n,
                                              bool &neg) {
    const int64_t e = p + (s & ((int64_t(2) << log_n) - 1));  // < 3n
    neg = ((e >> log_n) & 1) != 0;
    return e & ((int64_t(1) << log_n) - 1);
}

__device__ __forceinline__ uint64_t signed_scaled(uint64_t v, bool neg,
                                                  uint64_t q,
                                                  const uint64_t *w,
                                                  const uint64_t *wq, int i) {
    if (neg) v = neg_mod(v, q);
    if (w != nullptr) v = mul_mod_shoup(v, w[i], wq[i], q);
    return v;
}

// x, out: (batch, rows, n), row r of limb r % k.
__global__ void shift_kernel(uint64_t *__restrict__ out,
                             const uint64_t *__restrict__ x,
                             const int64_t *__restrict__ shifts, int64_t shift,
                             int64_t batch, int rows, int k, int log_n,
                             const uint64_t *__restrict__ moduli) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (batch * rows) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t row = idx >> log_n;                  // b * rows + r
        const int limb = static_cast<int>((row % rows) % k);
        const int64_t s = shifts != nullptr ? shifts[row / rows] : shift;
        bool neg;
        const int64_t j = shift_dest(idx & (n - 1), s, log_n, neg);
        const uint64_t v = x[idx];
        out[(row << log_n) + j] = neg ? neg_mod(v, moduli[limb]) : v;
    }
}

// data: (2, k, n), a ciphertext; c1s: (batch, k, n); c0s: (batch, k).
__global__ void extract_kernel(uint64_t *__restrict__ c1s,
                               uint64_t *__restrict__ c0s,
                               const uint64_t *__restrict__ data,
                               const int64_t *__restrict__ shifts,
                               int64_t batch, int k, int log_n,
                               const uint64_t *__restrict__ moduli) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = static_cast<int64_t>(k) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
    const uint64_t *c1 = data + total;
    for (int64_t idx = first; idx < total; idx += stride) {
        const int i = static_cast<int>(idx >> log_n);
        const int64_t p = idx & (n - 1);
        const uint64_t v = c1[idx];
        const uint64_t q = moduli[i];
        for (int64_t b = 0; b < batch; ++b) {
            bool neg;
            const int64_t j = shift_dest(p, shifts[b], log_n, neg);
            c1s[((b * k + i) << log_n) + j] = neg ? neg_mod(v, q) : v;
        }
    }
    for (int64_t idx = first; idx < batch * k; idx += stride) {
        const int64_t b = idx / k;
        const int i = static_cast<int>(idx - b * k);
        const int64_t term = (2 * n - shifts[b]) & (2 * n - 1);
        c0s[idx] = data[(static_cast<int64_t>(i) << log_n) + term];
    }
}

// c1s: (batch, k, n); c0s: (batch, k); out: (batch, 2, k, n).
__global__ void assemble_kernel(uint64_t *__restrict__ out,
                                const uint64_t *__restrict__ c1s,
                                const uint64_t *__restrict__ c0s,
                                const int64_t *__restrict__ shifts,
                                int64_t shift, int64_t batch, int k,
                                int log_n,
                                const uint64_t *__restrict__ moduli,
                                const uint64_t *__restrict__ w,
                                const uint64_t *__restrict__ wq) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (batch * k) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t row = idx >> log_n;                  // b * k + i
        const int64_t b = row / k;
        const int i = static_cast<int>(row - b * k);
        const int64_t p = idx & (n - 1);
        const int64_t s = shifts != nullptr ? shifts[b] : shift;
        const uint64_t q = moduli[i];
        bool neg;
        const int64_t j = shift_dest(p, s, log_n, neg);
        uint64_t *c0_row = out + (((b * 2) * k + i) << log_n);
        uint64_t *c1_row = out + (((b * 2 + 1) * k + i) << log_n);
        c1_row[j] = signed_scaled(c1s[idx], neg, q, w, wq, i);
        c0_row[p] = p == (s & (2 * n - 1))
                        ? signed_scaled(c0s[row], false, q, w, wq, i)
                        : 0;
    }
}

// cur: (2m, 2, k, n); even_out, folded: (m, 2, k, n).
__global__ void pack_prepare_kernel(uint64_t *__restrict__ even_out,
                                    uint64_t *__restrict__ folded,
                                    const uint64_t *__restrict__ cur,
                                    int64_t shift, int64_t pairs, int k,
                                    int log_n,
                                    const uint64_t *__restrict__ moduli) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t rows = 2 * k;                     // of one ciphertext
    const int64_t total = (pairs * rows) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t row = idx >> log_n;           // pair * rows + r
        const int64_t pair = row / rows;
        const int64_t r = row - pair * rows;
        const uint64_t q = moduli[r % k];
        const uint64_t *even = cur + (((2 * pair) * rows + r) << log_n);
        const uint64_t *odd = cur + (((2 * pair + 1) * rows + r) << log_n);
        bool neg;
        const int64_t j = shift_dest(idx & (n - 1), shift, log_n, neg);
        const uint64_t v = odd[idx & (n - 1)];
        const uint64_t temp = neg ? neg_mod(v, q) : v;
        const uint64_t e = even[j];
        even_out[(row << log_n) + j] = add_mod(e, temp, q);
        folded[(row << log_n) + j] = sub_mod(e, temp, q);
    }
}

}  // namespace

// x, out: (batch, rows, 2^log_n) with row r of limb r % k; shifts: (batch,)
// int64 or NULL for the one shift `shift`. out must not overlap x.
extern "C" int troy_negacyclic_shift(void *out, const void *x,
                                     const void *shifts, long long shift,
                                     long long batch, int rows, int k,
                                     int log_n, const void *moduli,
                                     void *stream) {
    if (k < 1 || rows % k != 0) return static_cast<int>(cudaErrorInvalidValue);
    shift_kernel<<<grid_blocks((batch * rows) << log_n, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(x),
        static_cast<const int64_t *>(shifts), shift, batch, rows, k, log_n,
        static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}

// data: (2, k, 2^log_n) coefficient form; shifts: (batch,) int64, the
// shift 2n - term (0 for term 0) of each extracted term; c1s: (batch, k,
// 2^log_n); c0s: (batch, k).
extern "C" int troy_extract_lwe(void *c1s, void *c0s, const void *data,
                                const void *shifts, long long batch, int k,
                                int log_n, const void *moduli, void *stream) {
    if (k < 1 || batch < 1 || shifts == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long words = static_cast<long long>(k) << log_n;
    extract_kernel<<<grid_blocks(words > batch * k ? words : batch * k,
                                 THREADS),
                     THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(c1s), static_cast<uint64_t *>(c0s),
        static_cast<const uint64_t *>(data),
        static_cast<const int64_t *>(shifts), batch, k, log_n,
        static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}

// c1s: (batch, k, 2^log_n); c0s: (batch, k); shifts: (batch,) int64 terms
// in [0, n), or NULL for the one term `shift`; out: (batch, 2, k, 2^log_n);
// w, wq: (k,) or NULL.
extern "C" int troy_assemble_lwe(void *out, const void *c1s, const void *c0s,
                                 const void *shifts, long long shift,
                                 long long batch, int k, int log_n,
                                 const void *moduli, const void *w,
                                 const void *wq, void *stream) {
    if (k < 1 || (w == nullptr) != (wq == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    assemble_kernel<<<grid_blocks((batch * k) << log_n, THREADS), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(c1s),
        static_cast<const uint64_t *>(c0s),
        static_cast<const int64_t *>(shifts), shift, batch, k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w), static_cast<const uint64_t *>(wq));
    TROY_RETURN_LAUNCH_STATUS();
}

// cur: (2 pairs, 2, k, 2^log_n) coefficient form; even_out, folded:
// (pairs, 2, k, 2^log_n).
extern "C" int troy_pack_fold_prepare(void *even_out, void *folded,
                                      const void *cur, long long shift,
                                      long long pairs, int k, int log_n,
                                      const void *moduli, void *stream) {
    if (k < 1 || k > MAX_LIMBS) return static_cast<int>(cudaErrorInvalidValue);
    pack_prepare_kernel<<<grid_blocks((pairs * 2 * k) << log_n, THREADS),
                          THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(even_out), static_cast<uint64_t *>(folded),
        static_cast<const uint64_t *>(cur), shift, pairs, k, log_n,
        static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}
