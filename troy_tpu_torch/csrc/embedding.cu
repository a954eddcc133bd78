// Kernels O1-O5: the CKKS canonical embedding in FP64, the exact
// conversions between its f64 coefficients and RNS words, and the two
// statistics of troy's device encode and decode.
//
// O1 replaces troy_tpu/ops/embedding.py:257 _four_step with its callers
// :278 embed_inverse, :286 embed_forward and :296 scatter_slots (the TPU
// runs the length-n complex transform as int8 digit-plane matmuls on the
// MXU; the H100 has native FP64). O2 replaces :425 round_to_rns_device and
// :443 round_to_rns_scaled (exact rounding at any magnitude), O3 :550
// compose_centered_device (CRT composition to the centred value). O4
// replaces :611 encode_stats_pipeline's statistic max |rint(c s)| (troy's
// gMaxReal, ckks_cuda.cu:178-209, read at :386-407 for the exact magnitude
// check), O5 :637 decode_stats_pipeline's conjugate-symmetry residual.
//
//   O1 encode: u = FFT(V) / n, with V the conjugate-symmetric vector of the
//              slots (V[idx_i] = v_i, V[n-1-idx_i] = conj(v_i), 0 past the
//              given count), the scatter fused into the first pass's loads;
//   O1 decode: V = conj-FFT(c * twist), c the real coefficients, the twist
//              fused into the loads and the slot gather into the stores;
//   O2:        round(Re(u * untwist) * scale) mod q_i for every limb;
//   O3:        the centred CRT composition of (k, n) residues, as f64, times
//              1/scale;
//   O4:        O2, and max |rint(Re(u * untwist) * scale)| over the n
//              coefficients into one f64 word;
//   O5:        O1 decode, and max(|Re V[j] - Re V[n-1-j]|, |Im V[j] +
//              Im V[n-1-j]|) over the slots j into one f64 word: the
//              partners n-1-idx_i are exactly the positions that are not
//              slots, so the rows pass stores them to a second buffer, and
//              one small launch over n/2 reduces the residual.
//
// Both statistics are maxima of values >= 0, reduced in a block (warp
// shuffles, then shared memory) and across blocks by atomicMax on the u64
// bit pattern of the double, which orders non-negative doubles as their
// values: the result does not depend on the order of the blocks. The word
// is zeroed on the launch's stream (cudaMemsetAsync) just before. O4 adds
// no launch to O2 and no pass over memory; O5 adds the n/2 partner values
// (stored and read once) and the reduction launch to O1's two passes.
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

// max over the block of v >= 0, atomically into the u64 bit pattern at
// word. Every thread of the block calls it.
__device__ void block_max_to(double v, unsigned long long *word) {
    __shared__ double warp_max[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1) {
        v = fmax(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_max[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < static_cast<int>(blockDim.x >> 5) ? warp_max[lane] : 0.0;
        for (int off = 16; off > 0; off >>= 1) {
            v = fmax(v, __shfl_down_sync(0xffffffffu, v, off));
        }
        if (lane == 0) {
            atomicMax(word, static_cast<unsigned long long>(
                                __double_as_longlong(v)));
        }
    }
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
// (complex, n); otherwise out[scatter[k]] = sum where scatter[k] >= 0 (the
// slots, scatter[idx_i] = i) and, with kPartners, partner[~scatter[k]] =
// sum elsewhere (their partners, scatter[n-1-idx_i] = ~i).
template <bool kEncode, bool kPartners = false>
__global__ void fft_rows_kernel(double2 *__restrict__ out,
                                const double2 *__restrict__ s,
                                const int *__restrict__ scatter,
                                const double2 *__restrict__ w2, int A, int B,
                                int rows, double out_scale,
                                double2 *__restrict__ partner = nullptr) {
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
            const int slot = scatter[k];
            if (slot >= 0) {
                out[slot] = acc;
            } else if (kPartners) {
                partner[~slot] = acc;
            }
        }
    }
}

template <bool kEncode, bool kPartners = false>
int fft(double2 *out, const void *in, double2 *scratch, const int *index,
        long long count, const double2 *twist, const double2 *w1,
        const double2 *tw, const double2 *w2, int A, int B,
        double out_scale, cudaStream_t stream,
        double2 *partner = nullptr) {
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
    fft_rows_kernel<kEncode, kPartners><<<A / rows, THREADS, smem2,
                                          stream>>>(
        out, scratch, index, w2, A, B, rows, out_scale, partner);
    TROY_RETURN_LAUNCH_STATUS();
}

// O5's reduction: max over j < half of max(|Re v_j - Re p_j|, |Im v_j +
// Im p_j|), v the slots and p their conjugate partners.
__global__ void conj_residual_kernel(const double2 *__restrict__ slots,
                                     const double2 *__restrict__ partner,
                                     int64_t half,
                                     unsigned long long *__restrict__ err) {
    double m = 0.0;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         j < half; j += stride) {
        const double2 v = slots[j];
        const double2 p = partner[j];
        m = fmax(m, fmax(fabs(v.x - p.x), fabs(v.y + p.y)));
    }
    block_max_to(m, err);
}

// consts: q (k), cr_hi (k), 2^e mod q (k x E), their Shoup words (k x E).
// kStats (O4): also max |rint(...)| into the bit pattern at stat.
template <bool kStats>
__global__ void round_kernel(uint64_t *__restrict__ out,
                             const double2 *__restrict__ u,
                             const double2 *__restrict__ untwist,
                             double scale, int k, int log_n,
                             const uint64_t *__restrict__ consts, int E,
                             unsigned long long *__restrict__ stat) {
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
    double largest = 0.0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
        const double2 x = u[i];
        const double2 t = untwist[i];
        const double re = __dsub_rn(__dmul_rn(x.x, t.x), __dmul_rn(x.y, t.y));
        const double v = rint(__dmul_rn(re, scale));
        const bool neg = v < 0.0;
        const double a = fabs(v);
        if (kStats) largest = fmax(largest, a);
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
    if (kStats) block_max_to(largest, stat);
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
// at the slot positions. scatter (n,) int32 (i at slot i, ~i at its
// partner); twist (n,) complex; the tables are the conjugate direction's.
extern "C" int troy_ckks_fft_decode(void *out, const void *coeffs,
                                    void *scratch, const void *scatter,
                                    const void *twist, const void *w1,
                                    const void *tw, const void *w2, int A,
                                    int B, void *stream) {
    return fft<false>(static_cast<double2 *>(out), coeffs,
                      static_cast<double2 *>(scratch),
                      static_cast<const int *>(scatter), 0,
                      static_cast<const double2 *>(twist),
                      static_cast<const double2 *>(w1),
                      static_cast<const double2 *>(tw),
                      static_cast<const double2 *>(w2), A, B, 1.0,
                      static_cast<cudaStream_t>(stream));
}

// O5, decode with the residual: O1 decode into out (n/2,) complex, the
// partners into partner (n/2,) complex, the residual into err (one f64
// word); scratch (n,) complex.
extern "C" int troy_ckks_fft_decode_stats(void *out, void *partner, void *err,
                                          const void *coeffs, void *scratch,
                                          const void *scatter,
                                          const void *twist, const void *w1,
                                          const void *tw, const void *w2,
                                          int A, int B, void *stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaMemsetAsync(err, 0, sizeof(uint64_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int status = fft<false, true>(
        static_cast<double2 *>(out), coeffs, static_cast<double2 *>(scratch),
        static_cast<const int *>(scatter), 0,
        static_cast<const double2 *>(twist),
        static_cast<const double2 *>(w1), static_cast<const double2 *>(tw),
        static_cast<const double2 *>(w2), A, B, 1.0, st,
        static_cast<double2 *>(partner));
    if (status != 0) return status;
    const int64_t half = static_cast<int64_t>(A) * B / 2;
    conj_residual_kernel<<<grid_blocks(half, THREADS), THREADS, 0, st>>>(
        static_cast<const double2 *>(out),
        static_cast<const double2 *>(partner), half,
        static_cast<unsigned long long *>(err));
    TROY_RETURN_LAUNCH_STATUS();
}

template <bool kStats>
static int round_launch(void *out, const void *u, const void *untwist,
                        double scale, int k, int log_n, const void *consts,
                        int E, void *stat, cudaStream_t stream) {
    if (k < 1 || k > MAX_LIMBS || E < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (kStats) {
        cudaError_t e = cudaMemsetAsync(stat, 0, sizeof(uint64_t), stream);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    round_kernel<kStats><<<grid_blocks(1LL << log_n, THREADS), THREADS, 0,
                           stream>>>(
        static_cast<uint64_t *>(out), static_cast<const double2 *>(u),
        static_cast<const double2 *>(untwist), scale, k, log_n,
        static_cast<const uint64_t *>(consts), E,
        static_cast<unsigned long long *>(stat));
    TROY_RETURN_LAUNCH_STATUS();
}

// O2: u (n,) complex, untwist (n,) complex -> out (k, n) words.
extern "C" int troy_ckks_round(void *out, const void *u, const void *untwist,
                               double scale, int k, int log_n,
                               const void *consts, int E, void *stream) {
    return round_launch<false>(out, u, untwist, scale, k, log_n, consts, E,
                               nullptr, static_cast<cudaStream_t>(stream));
}

// O4: O2 and max |rint(Re(u * untwist) * scale)| into stat (one f64 word).
extern "C" int troy_ckks_round_stats(void *out, void *stat, const void *u,
                                     const void *untwist, double scale,
                                     int k, int log_n, const void *consts,
                                     int E, void *stream) {
    return round_launch<true>(out, u, untwist, scale, k, log_n, consts, E,
                              stat, static_cast<cudaStream_t>(stream));
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
