// Kernels P1-P3: the tile contractions of the coefficient-packed matmul and
// conv2d app layer (troy_tpu/app/linear.py).
//
// P1 troy_tile_contract replaces linear.py:43 _matmul_tiles_core: the ct x pt
// tile fan-out out[x, y, c, l, j] = sum_i a[x, i, c, l, j] w[i, y, l, j]
// mod q_l on NTT-form words, which the JAX package writes as one
// rns_dyadic_mul and one rns_add per inner index i. Here the products of up
// to 63 terms are summed in 128 bits (reduced words are below 2^61, so a
// product is below 2^122 and 63 of them plus a reduced carry fit 128 bits),
// folded by Barrett-128 and summed on; the output is fully reduced, the same
// canonical residue as the JAX chain. What bounds it on the H100: bytes. The
// weight tiles are the big operand (at the conv2d configuration 64 x 52 tiles
// of 2 limbs, 872 MB, against 33.5 MB of ciphertext tiles), so one thread
// owns one (x, y, l, j) and all C ciphertext components: each weight word is
// read once, and the ciphertext words, re-read for every y, stay in L2.
// Neighbouring threads take neighbouring coefficients, so every load is
// coalesced.
//
// P2 troy_tile_pair_convolve replaces the per-pair ciphertext convolution of
// linear.py:133 _matmul_cipher_pairs_core (the dyadic step of
// evaluator.py _bfv_multiply and _ntt_form_multiply, vmapped over an X x Yc
// grid): out[x, y, m, r, j] = sum_{i + i' = m} a[x, i, r, j] w[y, i', r, j]
// mod q_r over R rows, each with its own modulus (q u Bsk for BFV, q for
// CKKS and BGV). Inputs may be lazy below 4q < 2^63: a product is below
// 2^126 and at most four terms meet in one output (sizes up to 4), so the
// sum fits 128 bits before its one Barrett reduction. Bytes bound it too:
// one thread per (x, y, r, j) loads the s1 + s2 words once into registers
// and writes all s1 + s2 - 1 outputs.
//
// P3 troy_pack_group_fold replaces linear.py:237 _pack_group_fold_core: each
// group of P traced ciphertexts folded into one with per-member monomial
// shifts, out[g, c, l, j] = sum_{s < P, gP + s < m} +-data[gP + s, c, l,
// (j - s) mod n], minus where j < s (x^s wraps negacyclically); the members
// a ragged last group lacks count as zero, as the JAX package's zero padding
// does. The JAX package runs P - 1 shifts and P - 1 adds; here one thread
// per output word walks the P members with a modular add each, so the sum
// never leaves [0, q) (P = 16 terms of 61-bit words would overflow 64 bits
// unreduced). One read of the batch, one write of the result: bytes bound
// it, and the shifted reads of a warp stay contiguous but for one wrap.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int MAX_COMPS = 4;       // ciphertext components a kernel takes
constexpr int FOLD_TERMS = 63;     // 128-bit terms between Barrett folds

__global__ void tile_contract_kernel(uint64_t *__restrict__ out,
                                     const uint64_t *__restrict__ a,
                                     const uint64_t *__restrict__ w,
                                     int64_t X, int64_t I, int64_t Y, int C,
                                     int k, int log_n,
                                     const uint64_t *__restrict__ moduli,
                                     const uint64_t *__restrict__ cr_lo,
                                     const uint64_t *__restrict__ cr_hi) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (X * Y * k) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t j = idx & (n - 1);
        int64_t r = idx >> log_n;
        const int l = static_cast<int>(r % k);
        r /= k;
        const int64_t y = r % Y;
        const int64_t x = r / Y;
        const uint64_t q = moduli[l], lo = cr_lo[l], hi = cr_hi[l];
        u128 acc[MAX_COMPS];
#pragma unroll
        for (int c = 0; c < MAX_COMPS; ++c) acc[c] = 0;
        int pending = 0;
        for (int64_t i = 0; i < I; ++i) {
            const uint64_t wv = w[(((i * Y + y) * k + l) << log_n) + j];
            const uint64_t *ai = a + (((x * I + i) * C * k + l) << log_n) + j;
#pragma unroll
            for (int c = 0; c < MAX_COMPS; ++c) {
                if (c < C) {
                    acc[c] += static_cast<u128>(ai[(int64_t(c) * k) << log_n])
                              * wv;
                }
            }
            if (++pending == FOLD_TERMS) {
#pragma unroll
                for (int c = 0; c < MAX_COMPS; ++c) {
                    if (c < C) {
                        acc[c] = barrett_reduce_128(
                            static_cast<uint64_t>(acc[c]),
                            static_cast<uint64_t>(acc[c] >> 64), q, lo, hi);
                    }
                }
                pending = 0;
            }
        }
        uint64_t *o = out + (((x * Y + y) * C * k + l) << log_n) + j;
#pragma unroll
        for (int c = 0; c < MAX_COMPS; ++c) {
            if (c < C) {
                o[(int64_t(c) * k) << log_n] = barrett_reduce_128(
                    static_cast<uint64_t>(acc[c]),
                    static_cast<uint64_t>(acc[c] >> 64), q, lo, hi);
            }
        }
    }
}

__global__ void tile_pair_convolve_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ w, int64_t X, int64_t Y, int s1, int s2,
        int R, int log_n, const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (X * Y * R) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int so = s1 + s2 - 1;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t j = idx & (n - 1);
        int64_t rr = idx >> log_n;
        const int r = static_cast<int>(rr % R);
        rr /= R;
        const int64_t y = rr % Y;
        const int64_t x = rr / Y;
        uint64_t av[MAX_COMPS], wv[MAX_COMPS];
#pragma unroll
        for (int i = 0; i < MAX_COMPS; ++i) {
            av[i] = i < s1 ? a[(((x * s1 + i) * R + r) << log_n) + j] : 0;
            wv[i] = i < s2 ? w[(((y * s2 + i) * R + r) << log_n) + j] : 0;
        }
        const uint64_t q = moduli[r], lo = cr_lo[r], hi = cr_hi[r];
        uint64_t *o = out + ((((x * Y + y) * so) * R + r) << log_n) + j;
        // both loops unrolled, so every register index is a constant
#pragma unroll
        for (int m = 0; m < 2 * MAX_COMPS - 1; ++m) {
            if (m < so) {
                u128 acc = 0;
#pragma unroll
                for (int i = 0; i < MAX_COMPS; ++i) {
                    const int i2 = m - i;
                    if (i2 >= 0 && i2 < MAX_COMPS && i < s1 && i2 < s2) {
                        acc += static_cast<u128>(av[i]) * wv[i2];
                    }
                }
                o[(int64_t(m) * R) << log_n] = barrett_reduce_128(
                    static_cast<uint64_t>(acc),
                    static_cast<uint64_t>(acc >> 64), q, lo, hi);
            }
        }
    }
}

__global__ void pack_group_fold_kernel(uint64_t *__restrict__ out,
                                       const uint64_t *__restrict__ data,
                                       int64_t m, int P, int64_t groups,
                                       int C, int k, int log_n,
                                       const uint64_t *__restrict__ moduli) {
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = (groups * C * k) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t member = (int64_t(C) * k) << log_n;   // words a ciphertext
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t j = idx & (n - 1);
        const int64_t row = idx >> log_n;               // (g, c, l)
        const int l = static_cast<int>(row % k);
        const int64_t g = row / (int64_t(C) * k);
        const int64_t row_in = row - g * C * k;         // (c, l)
        const uint64_t q = moduli[l];
        const int64_t first = g * P;
        const int64_t count = m - first < P ? m - first : P;
        const uint64_t *src = data + first * member + (row_in << log_n);
        uint64_t acc = 0;
        for (int s = 0; s < count; ++s) {
            uint64_t v = src[s * member + ((j - s) & (n - 1))];
            if (j < s) v = neg_mod(v, q);
            acc = add_mod(acc, v, q);
        }
        out[idx] = acc;
    }
}

}  // namespace

// a: (X, I, C, k, n), w: (I, Y, k, n), out: (X, Y, C, k, n), words below q;
// moduli, cr_lo, cr_hi: (k,).
extern "C" int troy_tile_contract(void *out, const void *a, const void *w,
                                  long long X, long long I, long long Y,
                                  int C, int k, int log_n, const void *moduli,
                                  const void *cr_lo, const void *cr_hi,
                                  void *stream) {
    if (X < 1 || I < 1 || Y < 1 || C < 1 || C > MAX_COMPS || k < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    tile_contract_kernel<<<grid_blocks((X * Y * k) << log_n, threads),
                           threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(w), X, I, Y, C, k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi));
    TROY_RETURN_LAUNCH_STATUS();
}

// a: (X, s1, R, n), w: (Y, s2, R, n), words below 4q; out: (X, Y, s1 + s2
// - 1, R, n); moduli, cr_lo, cr_hi: (R,), one modulus per row.
extern "C" int troy_tile_pair_convolve(void *out, const void *a,
                                       const void *w, long long X,
                                       long long Y, int s1, int s2, int R,
                                       int log_n, const void *moduli,
                                       const void *cr_lo, const void *cr_hi,
                                       void *stream) {
    if (X < 1 || Y < 1 || s1 < 1 || s2 < 1 || s1 > MAX_COMPS ||
        s2 > MAX_COMPS || R < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    tile_pair_convolve_kernel<<<grid_blocks((X * Y * R) << log_n, threads),
                                threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(w), X, Y, s1, s2, R, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi));
    TROY_RETURN_LAUNCH_STATUS();
}

// data: (m, C, k, n) words below q; out: (ceil(m / P), C, k, n); P <= n;
// moduli: (k,).
extern "C" int troy_pack_group_fold(void *out, const void *data, long long m,
                                    int P, int C, int k, int log_n,
                                    const void *moduli, void *stream) {
    if (m < 1 || P < 1 || C < 1 || k < 1 || P > (1 << log_n)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long groups = (m + P - 1) / P;
    const int threads = 256;
    pack_group_fold_kernel<<<grid_blocks((groups * C * k) << log_n, threads),
                             threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(data), m,
        P, groups, C, k, log_n, static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}
