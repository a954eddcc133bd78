// Kernel B: the dyadic 128-bit multiply-accumulate, and the ciphertext
// product's convolution.
//
//   mac:       out[g, c, r, i] = (add[g, c, r, i]
//                                 + sum_j a[g, j, r, i] b[g, j, c, r', i])
//                                mod q_r
//   convolve:  out[z, m, r, i] = sum_{s + s' = m} a[z, s, r, i]
//                                b[z, s', r, i] mod q_r
//
// The mac replaces troy_tpu/ops/ntt.py:428 rns_dyadic_mul (one term), the
// key-switch inner product troy_tpu/evaluator.py:262
// _switch_key_inner_product (the terms are the level's data limbs; a is
// the decomposed target, broadcast over the key's components c, and r' is
// r but for the last row, which reads the key's special row b_last) and
// the decrypt phase troy_tpu/decryptor.py:36/71 (c0 the addend, the
// components against the secret key's powers); g runs over a's row groups
// or over the batch of the batched form (the fold, decrypt_many, the
// sharded key switch), where the key b has no group pitch. The convolve
// entry replaces troy_tpu/evaluator.py:60 _dyadic_convolution: all s1 +
// s2 - 1 output components of a ciphertext product (or of each of a batch
// z) in one launch, b = a for a square.
//
// The sum runs in 128 bits (with q < 2^61 a product of reduced words is
// below 2^122, so 64 terms fit; of lazy words below 4q, four; the addend,
// a word below 2^63, fits beside either) and is reduced once with
// Barrett-128 against the row's ratio words (troy_tpu/ops/u64ops.py:123-
// 138), so the result is the canonical residue whatever the lazy ranges
// of the inputs, and adding c0 in the sum gives the words of an add after
// it.
//
// What bounds it on the H100: bytes (two 64-bit products a term and a
// Barrett-128 a word, far below the integer rate). The first kernel, one
// output word a thread in a grid-stride loop, with three to four 64-bit
// divisions a word, 8-byte loads and a broadcast operand read once per
// output row, streamed at 25-40 % of the byte bound at the headline's
// shapes, and the convolution took one launch an output component after
// a copy of b's flipped components. Design (K's, csrc/keyswitch.cu):
//  - a 3-D grid: coefficient pairs on x (with the component chunk above
//    them, a power-of-two split), the row on y, the group on z (a launch
//    for each 65535), so no thread divides by a run-time value;
//  - 128 threads a block, two coefficients a thread through 16-byte loads
//    and streaming stores (only a later kernel reads the output);
//  - a thread issues the row's three constant words and the loads of up
//    to kTermBatch terms before any product, the terms in as few equal
//    batches as that allows (the batch a compile-time size, so a thread
//    holds the registers of its batch alone: at the headline's five-term
//    key switch, 8 terms' 189 registers took 6.15 us against 4.7 with 5
//    terms' 124); where a is broadcast over b's components and the sum
//    has more than one term, a thread takes two of them, so a is read
//    once for both (the key switch's two key components); a one-term
//    product takes one component a thread, twice the blocks (at the
//    headline's (1,5,n) x (1,2,5,n), 2.57 us against 2.72; PERF.md);
//  - the convolution's thread loads each a and b word once (its sizes
//    compile-time, 1-4 a side, beyond that a loop that reads its words
//    again) and writes every output component straight into the (...,
//    s1 + s2 - 1, R, n) tensor;
//  - every operand by pitches in words, so a level's slice of a key (the
//    decrypt's secret-key powers, the public key, the switching key's rows
//    below the first level) is read in place.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int kThreads = 128;       // two coefficients each
constexpr int kLogBlockWords = 8;   // log2(2 kThreads): a block's words
constexpr int kTermBatch = 8;       // the mac's terms loaded together
constexpr int kMaxComps = 4;        // the convolution's compiled sizes
constexpr int kMaxTerms = 64;       // reduced words; lazy: 4
constexpr long long kMaxGrid = 65535;

__device__ __forceinline__ ulonglong2 load16(const uint64_t *p) {
    return __ldg(reinterpret_cast<const ulonglong2 *>(p));
}

__device__ __forceinline__ void mac(u128 &s0, u128 &s1, ulonglong2 x,
                                    ulonglong2 y) {
    s0 += static_cast<u128>(x.x) * y.x;
    s1 += static_cast<u128>(x.y) * y.y;
}

__device__ __forceinline__ void store_reduced(uint64_t *p, u128 s0, u128 s1,
                                              uint64_t q, uint64_t lo,
                                              uint64_t hi) {
    __stcs(reinterpret_cast<ulonglong2 *>(p),
           make_ulonglong2(
               barrett_reduce_128(static_cast<uint64_t>(s0),
                                  static_cast<uint64_t>(s0 >> 64), q, lo, hi),
               barrett_reduce_128(static_cast<uint64_t>(s1),
                                  static_cast<uint64_t>(s1 >> 64), q, lo,
                                  hi)));
}

// The mac's operands: pitches in words (a group's, a term's, a
// component's), and the row of b read for the last row.
struct MacLayout {
    long long a_term, a_group;
    long long b_term, b_comp, b_group;
    long long add_comp, add_group;
    long long o_comp, o_group;
    int b_last;
};

// Block: coefficient pairs (blockIdx.x low log_cblocks bits), components
// CC (blockIdx.x >> log_cblocks) onwards, row blockIdx.y, group g0 +
// blockIdx.z; the terms in batches of TB.
template <int CC, int TB>
__global__ void __launch_bounds__(kThreads) dyadic_mac_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ b, const uint64_t *__restrict__ add,
        int terms, int comps, int rows, int log_n, int log_cblocks,
        long long g0, MacLayout L, const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    const long long cb = blockIdx.x & ((1u << log_cblocks) - 1);
    const int c0 = static_cast<int>(blockIdx.x >> log_cblocks) * CC;
    const int r = blockIdx.y;
    const long long g = g0 + blockIdx.z;
    const long long i = 2 * (cb * kThreads + threadIdx.x);
    if (i >= (1LL << log_n)) return;
    const long long at = (static_cast<long long>(r) << log_n) + i;
    const uint64_t *ap = a + g * L.a_group + at;
    const uint64_t *bp =
        b + g * L.b_group + c0 * L.b_comp +
        (static_cast<long long>(r == rows - 1 ? L.b_last : r) << log_n) + i;
    const uint64_t q = __ldg(moduli + r), lo = __ldg(cr_lo + r),
                   hi = __ldg(cr_hi + r);
    u128 s[CC][2];
#pragma unroll
    for (int c = 0; c < CC; ++c) {
        s[c][0] = s[c][1] = 0;
        if (add != nullptr && c0 + c < comps) {
            const ulonglong2 v = load16(add + g * L.add_group +
                                        (c0 + c) * L.add_comp + at);
            s[c][0] = v.x;
            s[c][1] = v.y;
        }
    }
    for (int j0 = 0; j0 < terms; j0 += TB) {
        ulonglong2 av[TB], bv[TB][CC];
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            if (j0 + t < terms) {
                av[t] = load16(ap + (j0 + t) * L.a_term);
#pragma unroll
                for (int c = 0; c < CC; ++c) {
                    if (c0 + c < comps) {
                        bv[t][c] =
                            load16(bp + (j0 + t) * L.b_term + c * L.b_comp);
                    }
                }
            }
        }
#pragma unroll
        for (int t = 0; t < TB; ++t) {
            if (j0 + t < terms) {
#pragma unroll
                for (int c = 0; c < CC; ++c) {
                    if (c0 + c < comps) mac(s[c][0], s[c][1], av[t], bv[t][c]);
                }
            }
        }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) {
        if (c0 + c < comps) {
            store_reduced(out + g * L.o_group + (c0 + c) * L.o_comp + at,
                          s[c][0], s[c][1], q, lo, hi);
        }
    }
}

// Block: coefficient pairs blockIdx.x, row blockIdx.y, product z0 +
// blockIdx.z; each a and b word loaded once (a square reads a alone).
template <int S1, int S2>
__global__ void __launch_bounds__(kThreads) dyadic_convolve_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ b, int square, int R, int log_n,
        long long a_batch, long long b_batch, long long z0,
        const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    constexpr int SO = S1 + S2 - 1;
    const int r = blockIdx.y;
    const long long z = z0 + blockIdx.z;
    const long long i =
        2 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
    if (i >= (1LL << log_n)) return;
    const long long row = static_cast<long long>(R) << log_n;  // a component
    const long long at = (static_cast<long long>(r) << log_n) + i;
    ulonglong2 av[S1], bv[S2];
#pragma unroll
    for (int s = 0; s < S1; ++s) av[s] = load16(a + z * a_batch + s * row + at);
#pragma unroll
    for (int s = 0; s < S2; ++s) {
        bv[s] = square ? av[s < S1 ? s : 0]
                       : load16(b + z * b_batch + s * row + at);
    }
    const uint64_t q = __ldg(moduli + r), lo = __ldg(cr_lo + r),
                   hi = __ldg(cr_hi + r);
    uint64_t *o = out + z * SO * row + at;
#pragma unroll
    for (int m = 0; m < SO; ++m) {
        u128 s0 = 0, s1 = 0;
#pragma unroll
        for (int s = 0; s < S1; ++s) {
            if (m - s >= 0 && m - s < S2) mac(s0, s1, av[s], bv[m - s]);
        }
        store_reduced(o + m * row, s0, s1, q, lo, hi);
    }
}

// Sizes past kMaxComps: the same sums, each word read again for every
// output component it meets (from L1 or L2).
__global__ void __launch_bounds__(kThreads) dyadic_convolve_any_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ b, int s1, int s2, int R, int log_n,
        long long a_batch, long long b_batch, long long z0,
        const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    const int r = blockIdx.y;
    const long long z = z0 + blockIdx.z;
    const long long i =
        2 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
    if (i >= (1LL << log_n)) return;
    const long long row = static_cast<long long>(R) << log_n;
    const long long at = (static_cast<long long>(r) << log_n) + i;
    const uint64_t *ap = a + z * a_batch + at, *bp = b + z * b_batch + at;
    const uint64_t q = __ldg(moduli + r), lo = __ldg(cr_lo + r),
                   hi = __ldg(cr_hi + r);
    uint64_t *o = out + z * (s1 + s2 - 1) * row + at;
    for (int m = 0; m < s1 + s2 - 1; ++m) {
        u128 s0 = 0, s1w = 0;
        const int first = m - s2 + 1 > 0 ? m - s2 + 1 : 0;
        const int last = m < s1 - 1 ? m : s1 - 1;
        for (int s = first; s <= last; ++s) {
            mac(s0, s1w, load16(ap + s * row), load16(bp + (m - s) * row));
        }
        store_reduced(o + m * row, s0, s1w, q, lo, hi);
    }
}

bool misaligned(const void *p) {
    return reinterpret_cast<uintptr_t>(p) & 15;
}

// coefficient blocks of a row: 2 kThreads words each
int log_cblocks(int log_n) {
    return log_n > kLogBlockWords ? log_n - kLogBlockWords : 0;
}

}  // namespace

// The mac. a: terms of `rows` rows a group; b: terms of `comps` components
// of rows (the last row read at row b_last); add (or NULL) and out: comps
// components of rows a group; every pitch in words and even, every pointer
// 16-byte aligned, n at least 2; moduli, cr_lo, cr_hi: (rows,).
extern "C" int troy_dyadic_mac(
        void *out, const void *a, const void *b, const void *add, int terms,
        int comps, long long groups, int rows, int log_n, long long a_term,
        long long a_group, long long b_term, long long b_comp,
        long long b_group, int b_last, long long add_comp,
        long long add_group, long long o_comp, long long o_group,
        const void *moduli, const void *cr_lo, const void *cr_hi,
        void *stream) {
    const MacLayout L{a_term, a_group, b_term,   b_comp, b_group,
                      add_comp, add_group, o_comp, o_group, b_last};
    if (terms < 1 || terms > kMaxTerms || comps < 1 || groups < 1 ||
        rows < 1 || rows > kMaxGrid || log_n < 1 || b_last < rows - 1 ||
        ((a_term | a_group | b_term | b_comp | b_group | add_comp |
          add_group | o_comp | o_group) & 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (misaligned(out) || misaligned(a) || misaligned(b) ||
        misaligned(add)) {
        return static_cast<int>(cudaErrorMisalignedAddress);
    }
    typedef void (*Kernel)(uint64_t *, const uint64_t *, const uint64_t *,
                           const uint64_t *, int, int, int, int, int,
                           long long, MacLayout, const uint64_t *,
                           const uint64_t *, const uint64_t *);
    static const Kernel kernels[2][kTermBatch] = {
        {dyadic_mac_kernel<1, 1>, dyadic_mac_kernel<1, 2>,
         dyadic_mac_kernel<1, 3>, dyadic_mac_kernel<1, 4>,
         dyadic_mac_kernel<1, 5>, dyadic_mac_kernel<1, 6>,
         dyadic_mac_kernel<1, 7>, dyadic_mac_kernel<1, 8>},
        {dyadic_mac_kernel<2, 1>, dyadic_mac_kernel<2, 2>,
         dyadic_mac_kernel<2, 3>, dyadic_mac_kernel<2, 4>,
         dyadic_mac_kernel<2, 5>, dyadic_mac_kernel<2, 6>,
         dyadic_mac_kernel<2, 7>, dyadic_mac_kernel<2, 8>}};
    const int cc = comps > 1 && terms > 1 ? 2 : 1;
    const int batches = (terms + kTermBatch - 1) / kTermBatch;
    const Kernel kernel = kernels[cc - 1][(terms + batches - 1) / batches - 1];
    const long long chunks = (comps + cc - 1) / cc;
    const int lc = log_cblocks(log_n);
    if ((chunks << lc) >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (long long g0 = 0; g0 < groups; g0 += kMaxGrid) {
        const dim3 grid(static_cast<unsigned>(chunks << lc),
                        static_cast<unsigned>(rows),
                        static_cast<unsigned>(groups - g0 < kMaxGrid
                                                  ? groups - g0
                                                  : kMaxGrid));
        kernel<<<grid, kThreads, 0, s>>>(
            static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
            static_cast<const uint64_t *>(b),
            static_cast<const uint64_t *>(add), terms, comps, rows, log_n, lc,
            g0, L, static_cast<const uint64_t *>(moduli),
            static_cast<const uint64_t *>(cr_lo),
            static_cast<const uint64_t *>(cr_hi));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The convolution of `batch` products. a: (batch, s1, R, n) with a
// product's pitch a_batch words, b: (batch, s2, R, n) with b_batch (square:
// b is a); out: (batch, s1 + s2 - 1, R, n); moduli, cr_lo, cr_hi: (R,);
// pitches even, pointers 16-byte aligned, n at least 2.
extern "C" int troy_dyadic_convolve(void *out, const void *a, const void *b,
                                    int square, long long batch, int s1,
                                    int s2, int R, int log_n,
                                    long long a_batch, long long b_batch,
                                    const void *moduli, const void *cr_lo,
                                    const void *cr_hi, void *stream) {
    if (batch < 1 || s1 < 1 || s2 < 1 ||
        (s1 < s2 ? s1 : s2) > kMaxTerms || R < 1 || R > kMaxGrid ||
        log_n < 1 || ((a_batch | b_batch) & 1) ||
        (square && (a != b || s1 != s2 || a_batch != b_batch))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (misaligned(out) || misaligned(a) || misaligned(b)) {
        return static_cast<int>(cudaErrorMisalignedAddress);
    }
    typedef void (*Kernel)(uint64_t *, const uint64_t *, const uint64_t *,
                           int, int, int, long long, long long, long long,
                           const uint64_t *, const uint64_t *,
                           const uint64_t *);
    static const Kernel kernels[kMaxComps][kMaxComps] = {
        {dyadic_convolve_kernel<1, 1>, dyadic_convolve_kernel<1, 2>,
         dyadic_convolve_kernel<1, 3>, dyadic_convolve_kernel<1, 4>},
        {dyadic_convolve_kernel<2, 1>, dyadic_convolve_kernel<2, 2>,
         dyadic_convolve_kernel<2, 3>, dyadic_convolve_kernel<2, 4>},
        {dyadic_convolve_kernel<3, 1>, dyadic_convolve_kernel<3, 2>,
         dyadic_convolve_kernel<3, 3>, dyadic_convolve_kernel<3, 4>},
        {dyadic_convolve_kernel<4, 1>, dyadic_convolve_kernel<4, 2>,
         dyadic_convolve_kernel<4, 3>, dyadic_convolve_kernel<4, 4>}};
    const bool compiled = s1 <= kMaxComps && s2 <= kMaxComps;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (long long z0 = 0; z0 < batch; z0 += kMaxGrid) {
        const dim3 grid(1u << log_cblocks(log_n), static_cast<unsigned>(R),
                        static_cast<unsigned>(batch - z0 < kMaxGrid
                                                  ? batch - z0
                                                  : kMaxGrid));
        const uint64_t *pa = static_cast<const uint64_t *>(a);
        const uint64_t *pb = static_cast<const uint64_t *>(b);
        const uint64_t *pq = static_cast<const uint64_t *>(moduli);
        const uint64_t *plo = static_cast<const uint64_t *>(cr_lo);
        const uint64_t *phi = static_cast<const uint64_t *>(cr_hi);
        if (compiled) {
            kernels[s1 - 1][s2 - 1]<<<grid, kThreads, 0, s>>>(
                static_cast<uint64_t *>(out), pa, pb, square, R, log_n,
                a_batch, b_batch, z0, pq, plo, phi);
        } else {
            dyadic_convolve_any_kernel<<<grid, kThreads, 0, s>>>(
                static_cast<uint64_t *>(out), pa, pb, s1, s2, R, log_n,
                a_batch, b_batch, z0, pq, plo, phi);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
