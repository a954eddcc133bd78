// Kernels O1-O3: the CKKS canonical embedding in FP64 and the exact
// conversions between its f64 coefficients and RNS words.
//
// O1 replaces troy_tpu/ops/embedding.py:257 _four_step with its callers
// :278 embed_inverse, :286 embed_forward and :296 scatter_slots (the TPU
// runs the length-n complex transform as int8 digit-plane matmuls on the
// MXU; the H100 has native FP64). O2 replaces :425 round_to_rns_device and
// :443 round_to_rns_scaled (exact rounding at any magnitude), O3 :550
// compose_centered_device (CRT composition to the centred value).
//
//   O1 encode: u = FFT(V) / n, with V the conjugate-symmetric vector of the
//              slots (V[idx_i] = v_i, V[n-1-idx_i] = conj(v_i), 0 past the
//              given count), the scatter fused into the first pass's loads;
//   O1 decode: V = conj-FFT(c * twist), c the real coefficients, the twist
//              fused into the loads and the slot gather into the stores;
//   O2:        round(Re(u * untwist) * scale) mod q_i for every limb;
//   O3:        the centred CRT composition of (k, n) residues, as f64, times
//              1/scale.
//
// O1 is the 4-step transform of the JAX package: n = A x B, x[a*B + b],
//   s[p1, b]        = tw[p1, b] * sum_a w1[p1, a] x[a, b]   (pass 1)
//   out[p2*A + p1]  = sum_b s[p1, b] w2[b, p2]              (pass 2)
// with the (A, A), (A, B) and (B, B) complex tables of ops/embedding.py.
// A row of 16384 complex doubles (256 KiB) does not fit a block's shared
// memory (227 KB), so each pass stages a few columns (pass 1) or rows
// (pass 2) of 128 entries in shared memory and runs direct length-A or
// length-B sums over them; the (n,) intermediate goes through device memory
// (L2) between the two launches.
//
// What bounds them on the H100: at n = 16384 O1 moves about 1.3 MB
// (tables included) for 33.5 MFLOP of direct sums (1.15 MFLOP for an FFT):
// the launch and the few blocks (n / (A * COLS) per pass) bound it, not
// bandwidth; a radix-2 pass per block and more rows per block are later
// work. O2 and O3 are one thread per coefficient with k limbs (O3: W
// 64-bit words of accumulator in registers), bound by their k*n words.
//
// Floating point: O2 and O3 must give the plain PyTorch versions' bits, so
// every f64 step that feeds a rounding is written with __dmul_rn /
// __dadd_rn / __dsub_rn, which nvcc never contracts into a fused
// multiply-add (it does contract a*b + c by default). O1 is held to
// 2^-44 max|x| of its plain version and lets nvcc contract.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int COLS = 4;          // columns per block, pass 1
constexpr int ROWS = 4;          // rows per block, pass 2
constexpr int THREADS = 256;
constexpr int MAX_WORDS = 16;    // O3 accumulator words (Q < 2^960)
constexpr int MAX_LIMBS = 64;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Pass 1 over columns b0 .. b0+cols-1. kEncode: x[j] is the slot scatter of
// `in` (complex, `count` values) by `index` (i, or ~i for the conjugate);
// otherwise x[j] = in[j] (real) * twist[j].
template <bool kEncode>
__global__ void fft_cols_kernel(double2 *__restrict__ s,
                                const void *__restrict__ in,
                                const int *__restrict__ index,
                                long long count,
                                const double2 *__restrict__ twist,
                                const double2 *__restrict__ w1,
                                const double2 *__restrict__ tw, int A, int B,
                                int cols) {
    extern __shared__ double2 tile[];                  // (A, cols)
    const int b0 = blockIdx.x * cols;
    for (int idx = threadIdx.x; idx < A * cols; idx += blockDim.x) {
        const int a = idx / cols;
        const int j = a * B + b0 + idx % cols;
        double2 v;
        if (kEncode) {
            const int src = index[j];
            const int i = src >= 0 ? src : ~src;
            if (i < count) {
                v = static_cast<const double2 *>(in)[i];
                if (src < 0) v.y = -v.y;
            } else {
                v = make_double2(0.0, 0.0);
            }
        } else {
            const double c = static_cast<const double *>(in)[j];
            const double2 t = twist[j];
            v = make_double2(c * t.x, c * t.y);
        }
        tile[idx] = v;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < A * cols; idx += blockDim.x) {
        const int p1 = idx / cols;
        const int c = idx % cols;
        const double2 *row = w1 + static_cast<int64_t>(p1) * A;
        double2 acc = make_double2(0.0, 0.0);
        for (int a = 0; a < A; ++a) {
            const double2 w = row[a];
            const double2 x = tile[a * cols + c];
            acc.x += w.x * x.x - w.y * x.y;
            acc.y += w.x * x.y + w.y * x.x;
        }
        const int64_t at = static_cast<int64_t>(p1) * B + b0 + c;
        s[at] = cmul(acc, tw[at]);
    }
}

// Pass 2 over rows p1_0 .. p1_0+rows-1. kEncode: out[k] = sum * out_scale
// (complex, n); otherwise out[slot_of[k]] = sum where slot_of[k] >= 0.
template <bool kEncode>
__global__ void fft_rows_kernel(double2 *__restrict__ out,
                                const double2 *__restrict__ s,
                                const int *__restrict__ slot_of,
                                const double2 *__restrict__ w2, int A, int B,
                                int rows, double out_scale) {
    extern __shared__ double2 tile[];                  // (rows, B + 1)
    const int p1_0 = blockIdx.x * rows;
    const int stride = B + 1;                          // no bank conflicts
    for (int idx = threadIdx.x; idx < rows * B; idx += blockDim.x) {
        tile[(idx / B) * stride + idx % B] =
            s[static_cast<int64_t>(p1_0) * B + idx];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * B; idx += blockDim.x) {
        const int r = idx % rows;
        const int p2 = idx / rows;
        const double2 *row = tile + r * stride;
        double2 acc = make_double2(0.0, 0.0);
        for (int b = 0; b < B; ++b) {
            const double2 w = w2[static_cast<int64_t>(b) * B + p2];
            const double2 x = row[b];
            acc.x += x.x * w.x - x.y * w.y;
            acc.y += x.x * w.y + x.y * w.x;
        }
        const int64_t k = static_cast<int64_t>(p2) * A + p1_0 + r;
        if (kEncode) {
            out[k] = make_double2(acc.x * out_scale, acc.y * out_scale);
        } else {
            const int slot = slot_of[k];
            if (slot >= 0) out[slot] = acc;
        }
    }
}

template <bool kEncode>
int fft(double2 *out, const void *in, double2 *scratch, const int *index,
        long long count, const double2 *twist, const double2 *w1,
        const double2 *tw, const double2 *w2, int A, int B,
        double out_scale, cudaStream_t stream) {
    if (A < 1 || B < 1 || (A & (A - 1)) || (B & (B - 1))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cols = B < COLS ? B : COLS;
    const int rows = A < ROWS ? A : ROWS;
    const size_t smem1 = static_cast<size_t>(A) * cols * sizeof(double2);
    const size_t smem2 = static_cast<size_t>(rows) * (B + 1) * sizeof(double2);
    if (smem1 > 48 * 1024 || smem2 > 48 * 1024) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    fft_cols_kernel<kEncode><<<B / cols, THREADS, smem1, stream>>>(
        scratch, in, index, count, twist, w1, tw, A, B, cols);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fft_rows_kernel<kEncode><<<A / rows, THREADS, smem2, stream>>>(
        out, scratch, index, w2, A, B, rows, out_scale);
    TROY_RETURN_LAUNCH_STATUS();
}

// consts: q (k), cr_hi (k), 2^e mod q (k x E), their Shoup words (k x E).
__global__ void round_kernel(uint64_t *__restrict__ out,
                             const double2 *__restrict__ u,
                             const double2 *__restrict__ untwist,
                             double scale, int k, int log_n,
                             const uint64_t *__restrict__ consts, int E) {
    __shared__ uint64_t q[MAX_LIMBS], ratio[MAX_LIMBS];
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
        q[j] = consts[j];
        ratio[j] = consts[k + j];
    }
    __syncthreads();
    const uint64_t *pow2 = consts + 2 * k;
    const uint64_t *pow2_shoup = pow2 + static_cast<int64_t>(k) * E;
    const int64_t n = int64_t(1) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
        const double2 x = u[i];
        const double2 t = untwist[i];
        const double re = __dsub_rn(__dmul_rn(x.x, t.x), __dmul_rn(x.y, t.y));
        const double v = rint(__dmul_rn(re, scale));
        const bool neg = v < 0.0;
        const double a = fabs(v);
        // a = m * 2^e with m < 2^53 an integer: exact at any magnitude
        int ex;
        frexp(a, &ex);
        int e = ex - 53;
        e = e < 0 ? 0 : (e > E - 1 ? E - 1 : e);
        const uint64_t m = static_cast<uint64_t>(ldexp(a, -e));
        for (int j = 0; j < k; ++j) {
            const int64_t at = static_cast<int64_t>(j) * E + e;
            uint64_t r = barrett_reduce_64(m, q[j], ratio[j]);
            r = mul_mod_shoup(r, pow2[at], pow2_shoup[at], q[j]);
            out[(static_cast<int64_t>(j) << log_n) + i] =
                neg ? neg_mod(r, q[j]) : r;
        }
    }
}

// consts: q (k), invp (k), invp Shoup (k), punctured products (k x W
// words), Q (W words), (Q + 1) / 2 (W words); words little-endian.
__global__ void compose_kernel(double *__restrict__ out,
                               const uint64_t *__restrict__ res, int k,
                               int log_n, int W,
                               const uint64_t *__restrict__ consts,
                               double inv_scale) {
    extern __shared__ uint64_t c[];
    const int size = 3 * k + k * W + 2 * W;
    for (int j = threadIdx.x; j < size; j += blockDim.x) c[j] = consts[j];
    __syncthreads();
    const uint64_t *q = c, *invp = c + k, *invp_shoup = c + 2 * k;
    const uint64_t *punct = c + 3 * k, *q_words = punct + k * W;
    const uint64_t *qhalf_words = q_words + W;
    const int64_t n = int64_t(1) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
        uint64_t acc[MAX_WORDS];
#pragma unroll
        for (int w = 0; w < MAX_WORDS; ++w) acc[w] = 0;
        // acc = sum_j (r_j * invp_j mod q_j) * P_j
        for (int j = 0; j < k; ++j) {
            const uint64_t x =
                mul_mod_shoup(res[(static_cast<int64_t>(j) << log_n) + i],
                              invp[j], invp_shoup[j], q[j]);
            const uint64_t *pw = punct + j * W;
            uint64_t carry = 0;
#pragma unroll
            for (int w = 0; w < MAX_WORDS; ++w) {
                if (w < W) {
                    const uint64_t lo = x * pw[w];
                    const uint64_t hi = __umul64hi(x, pw[w]);
                    const uint64_t s1 = acc[w] + lo;
                    const uint64_t c1 = s1 < lo;
                    const uint64_t s2 = s1 + carry;
                    const uint64_t c2 = s2 < carry;
                    acc[w] = s2;
                    carry = hi + c1 + c2;
                }
            }
        }
        // reduce mod Q: acc < k Q, so k - 1 conditional subtracts
        for (int t = 0; t < k - 1; ++t) {
            uint64_t diff[MAX_WORDS];
            uint64_t borrow = 0;
#pragma unroll
            for (int w = 0; w < MAX_WORDS; ++w) {
                if (w < W) {
                    const uint64_t d1 = acc[w] - q_words[w];
                    const uint64_t b1 = acc[w] < q_words[w];
                    diff[w] = d1 - borrow;
                    borrow = b1 + (d1 < borrow);
                }
            }
            if (borrow == 0) {
#pragma unroll
                for (int w = 0; w < MAX_WORDS; ++w) {
                    if (w < W) acc[w] = diff[w];
                }
            }
        }
        // centre: acc >= (Q + 1) / 2 stands for acc - Q
        uint64_t borrow = 0;
#pragma unroll
        for (int w = 0; w < MAX_WORDS; ++w) {
            if (w < W) {
                const uint64_t d1 = acc[w] - qhalf_words[w];
                const uint64_t b1 = acc[w] < qhalf_words[w];
                borrow = b1 + (d1 < borrow);
            }
        }
        const bool neg = borrow == 0;
        if (neg) {
            borrow = 0;
#pragma unroll
            for (int w = 0; w < MAX_WORDS; ++w) {
                if (w < W) {
                    const uint64_t d1 = q_words[w] - acc[w];
                    const uint64_t b1 = q_words[w] < acc[w];
                    acc[w] = d1 - borrow;
                    borrow = b1 + (d1 < borrow);
                }
            }
        }
        // top-down f64 conversion, in the plain version's order
        double f = 0.0;
#pragma unroll
        for (int w = MAX_WORDS - 1; w >= 0; --w) {
            if (w < W) {
                const double hi = static_cast<double>(
                    static_cast<uint32_t>(acc[w] >> 32));
                const double lo = static_cast<double>(
                    static_cast<uint32_t>(acc[w]));
                f = __dadd_rn(__dadd_rn(__dmul_rn(f, 0x1p64),
                                        __dmul_rn(hi, 0x1p32)),
                              lo);
            }
        }
        out[i] = __dmul_rn(neg ? -f : f, inv_scale);
    }
}

}  // namespace

// O1, encode: values (count,) complex -> u (n,) complex = FFT(V) / n.
// scratch (n,) complex; scatter (n,) int32; w1 (A, A), tw (A, B),
// w2 (B, B) complex, row-major.
extern "C" int troy_ckks_fft_encode(void *out, const void *values,
                                    void *scratch, const void *scatter,
                                    long long count, const void *w1,
                                    const void *tw, const void *w2, int A,
                                    int B, double inv_n, void *stream) {
    return fft<true>(static_cast<double2 *>(out), values,
                     static_cast<double2 *>(scratch),
                     static_cast<const int *>(scatter), count, nullptr,
                     static_cast<const double2 *>(w1),
                     static_cast<const double2 *>(tw),
                     static_cast<const double2 *>(w2), A, B, inv_n,
                     static_cast<cudaStream_t>(stream));
}

// O1, decode: coeffs (n,) f64 -> slots (n/2,) complex = conj-FFT(c twist)
// at the slot positions. slot_of (n,) int32 (-1 off the slots); twist (n,)
// complex; the tables are the conjugate direction's.
extern "C" int troy_ckks_fft_decode(void *out, const void *coeffs,
                                    void *scratch, const void *slot_of,
                                    const void *twist, const void *w1,
                                    const void *tw, const void *w2, int A,
                                    int B, void *stream) {
    return fft<false>(static_cast<double2 *>(out), coeffs,
                      static_cast<double2 *>(scratch),
                      static_cast<const int *>(slot_of), 0,
                      static_cast<const double2 *>(twist),
                      static_cast<const double2 *>(w1),
                      static_cast<const double2 *>(tw),
                      static_cast<const double2 *>(w2), A, B, 1.0,
                      static_cast<cudaStream_t>(stream));
}

// O2: u (n,) complex, untwist (n,) complex -> out (k, n) words.
extern "C" int troy_ckks_round(void *out, const void *u, const void *untwist,
                               double scale, int k, int log_n,
                               const void *consts, int E, void *stream) {
    if (k < 1 || k > MAX_LIMBS || E < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    round_kernel<<<grid_blocks(1LL << log_n, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const double2 *>(u),
        static_cast<const double2 *>(untwist), scale, k, log_n,
        static_cast<const uint64_t *>(consts), E);
    TROY_RETURN_LAUNCH_STATUS();
}

// O3: residues (k, n) words -> out (n,) f64.
extern "C" int troy_ckks_compose(void *out, const void *residues, int k,
                                 int log_n, int W, const void *consts,
                                 double inv_scale, void *stream) {
    if (k < 1 || k > MAX_LIMBS || W < 1 || W > MAX_WORDS) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = static_cast<size_t>(3 * k + k * W + 2 * W) *
                        sizeof(uint64_t);
    compose_kernel<<<grid_blocks(1LL << log_n, THREADS), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<double *>(out), static_cast<const uint64_t *>(residues),
        k, log_n, W, static_cast<const uint64_t *>(consts), inv_scale);
    TROY_RETURN_LAUNCH_STATUS();
}
