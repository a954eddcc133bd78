// Kernel J: the negacyclic NTT as two exact int8 matrix products on the
// tensor cores (the 4-step transform n = A x B).
//
// Replaces troy_tpu/ops/ntt_mxu.py:263 _mod_matmul with its callers :377
// ntt_forward_mxu and :404 ntt_inverse_mxu (and the dispatch of
// troy_tpu/ops/ntt.py:317-379 to them). Forward: Y = (W1 @ C) * Tw, then
// Z = Y @ W2; inverse: Y = (Z @ V2) * iTw, then C = V1 @ Y; C is a row of n
// words read as an (A, B) array, all mod q (ops/ntt_mxu.py documents the
// algebra). One launch is one stage for every row of the batch: the
// "left" kernel contracts X's rows (W @ X: W1, V1), the "right" kernel its
// columns (X @ W: W2, V2, whose planes the tables keep transposed so that
// every matrix is read with its contraction axis last).
//
// Exactness: W and X are split into biased byte planes (byte - 128 as
// int8; D planes of W for a D-byte modulus, Dx of X); each plane pair
// (i, j) is one int8 product with int32 accumulation on the tensor cores
// (mma.sync m16n8k32 s8.s8.s32), and the pairs of one digit sum s = i + j
// accumulate in the same int32 registers: D + Dx - 1 accumulators, not
// D * Dx. The epilogue, in registers, adds the bias terms
// 128 (sum of W's plane sums) + 128 (sum of X's plane sums) + 128^2 K
// npairs(s), regroups the sums in radix 2^32 with the static offset m_off
// (a multiple of q above any |group|), folds group g by 2^(32 g) mod q
// with Shoup, adds mod q, and (first stage) multiplies by the twiddle.
// |sum| <= min(D, Dx) 4 128^2 K < 2^31 for K <= 512
// (troy_tpu/ops/ntt_mxu.py:355-357).
//
// Tiles: a block of 4 warps computes 32 W rows x 32 X vectors of one
// row's matrix; each warp 16 x 16 (two m16n8 tiles) for every digit sum.
// The contraction runs in steps of 64: the W planes of the step are
// copied to shared memory, the X words are loaded, Barrett-reduced (unless
// the caller bounds them, x_planes) and split into planes in shared
// memory (8 planes x 64 x 32 bytes; 8 x 512 x 64 bytes would not fit at
// K = 512), and X's plane sums over the contraction accumulate per step.
// Row r uses limb r % k; each limb's tables are found through a pointer
// table (ops/ntt_mxu.py MxuNttTables.pointers), so D varies by limb.
//
// What bounds it on the H100: the larger of its bytes (X read once, the
// output written once, each limb's planes and twiddles once) over 3.35
// TB/s and its int8 operations, 2 M N K D Dx per stage, over 1979 TOPS.
// At n = 16384 with 60-bit primes a stage is 2 * 128^3 * 64 = 268 M
// operations a row (0.14 us at the peak) against 256 KB of words a row
// (0.08 us): neither is near what mma.sync, the per-element epilogue and
// the byte-plane split cost here. wgmma and TMA, and keeping X's planes
// across both stages, are later work.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int BM = 32;           // W rows per block (an output axis)
constexpr int BN = 32;           // X vectors per block (the other one)
constexpr int KT = 64;           // contraction per shared-memory step
constexpr int ROW = KT + 16;     // bytes per shared row: 20 words, so the
                                 // fragment loads of 8 rows x 4 threads
                                 // fall in 32 different banks
constexpr int MAXD = 8;          // planes of a 61-bit residue
constexpr int NSUM = 2 * MAXD - 1;
constexpr int THREADS = 128;
constexpr int PTRS = 16;         // pointer-table words per limb
// pointer-table slots (ops/ntt_mxu.py MxuNttTables.pointers): matrix m's
// planes at 2 m and its plane sums at 2 m + 1 (W1, W2^T, V1, V2^T), the
// twiddle grid t at 8 + 2 t with its Shoup words at 9 + 2 t (Tw, iTw),
// the constants at 12
constexpr int CONSTS = 12;

__device__ __forceinline__ uint32_t ld32(const int8_t *p) {
    return *reinterpret_cast<const uint32_t *>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage over one 32 x 32 output tile of one row's (A, B) matrix.
// kLeft: out[m][v] = sum_k W[m][k] X[k][v] (X's columns are the vectors);
// otherwise out[v][m] = sum_k X[v][k] W^T[m][k] (X's rows are).
template <bool kLeft>
__global__ void __launch_bounds__(THREADS)
ntt_mxu_kernel(uint64_t *__restrict__ out, const uint64_t *__restrict__ in,
               int k, int log_a, int log_b,
               const uint64_t *__restrict__ ptrs, int mat, int tsel,
               int reduce_in, int x_planes) {
    __shared__ __align__(16) int8_t ws[MAXD][BM][ROW];
    __shared__ __align__(16) int8_t xs[MAXD][BN][ROW];
    __shared__ int wpre[MAXD + 1][BM];   // prefix sums over W's planes
    __shared__ int xpre[MAXD + 1][BN];   // and over X's

    const int64_t row = blockIdx.x;
    const uint64_t *p = ptrs + static_cast<int64_t>(row % k) * PTRS;
    const int8_t *wd = reinterpret_cast<const int8_t *>(p[2 * mat]);
    const int *wsum = reinterpret_cast<const int *>(p[2 * mat + 1]);
    const uint64_t *c = reinterpret_cast<const uint64_t *>(p[CONSTS]);
    const uint64_t q = c[0], cr_hi = c[1];
    const int D = static_cast<int>(c[2]);
    const bool bounded = x_planes > 0 && x_planes <= D;
    const int Dx = bounded ? x_planes : D;
    const bool barrett = reduce_in && !bounded;

    const int log_k = kLeft ? log_a : log_b;   // W is K x K
    const int K = 1 << log_k;
    const int m0 = blockIdx.z * BM;
    const int v0 = blockIdx.y * BN;
    const int64_t base = row << (log_a + log_b);
    const uint64_t *x = in + base;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;

    if (tid < BM) {
        int s = 0;
        wpre[0][tid] = 0;
        for (int i = 0; i < D; ++i) {
            s += wsum[i * K + m0 + tid];
            wpre[i + 1][tid] = s;
        }
    }

    int acc[NSUM][2][4];
#pragma unroll
    for (int s = 0; s < NSUM; ++s)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0;
    int xsum[2] = {0, 0};   // (plane, vector) pairs tid and tid + 128

    for (int k0 = 0; k0 < K; k0 += KT) {
        const int kt = K - k0 < KT ? K - k0 : KT;   // 64, or 32 at K = 32
        // W's planes of this step: D x 32 rows x kt bytes, 16 at a time
        const int chunks = kt >> 4;
        for (int i = tid; i < D * BM * chunks; i += THREADS) {
            const int pl = i / (BM * chunks);
            const int r = (i / chunks) % BM;
            const int ch = i % chunks;
            *reinterpret_cast<uint4 *>(&ws[pl][r][ch * 16]) =
                *reinterpret_cast<const uint4 *>(
                    wd + (static_cast<int64_t>(pl) * K + m0 + r) * K + k0 +
                    ch * 16);
        }
        // X's words of this step in quads of 4 along the contraction, each
        // split into Dx biased planes (byte ^ 0x80 is byte - 128 as int8)
        const int quads = kt >> 2;
        for (int i = tid; i < BN * quads; i += THREADS) {
            // consecutive threads read consecutive addresses
            const int vec = kLeft ? i % BN : i / quads;
            const int qd = kLeft ? i / BN : i % quads;
            uint64_t e[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kk = k0 + qd * 4 + j;
                const int64_t off =
                    kLeft ? (static_cast<int64_t>(kk) << log_b) + v0 + vec
                          : (static_cast<int64_t>(v0 + vec) << log_b) + kk;
                const uint64_t w = x[off];
                e[j] = barrett ? barrett_reduce_64(w, q, cr_hi) : w;
            }
#pragma unroll
            for (int pl = 0; pl < MAXD; ++pl) {
                if (pl < Dx) {
                    uint32_t word = 0;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        word |= ((static_cast<uint32_t>(e[j] >> (8 * pl)) &
                                  0xFFu) ^ 0x80u) << (8 * j);
                    }
                    *reinterpret_cast<uint32_t *>(&xs[pl][vec][qd * 4]) =
                        word;
                }
            }
        }
        __syncthreads();

        // X's plane sums over this step (the device half of the bias)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int pair = tid + h * THREADS;
            const int pl = pair / BN, vec = pair % BN;
            if (pl < Dx) {
                int s = 0;
                for (int w = 0; w < kt; w += 4) {
                    s = __dp4a(static_cast<int>(ld32(&xs[pl][vec][w])),
                               0x01010101, s);
                }
                xsum[h] += s;
            }
        }

        for (int ks = 0; ks < kt; ks += 32) {
            uint32_t af[MAXD][4];
#pragma unroll
            for (int i = 0; i < MAXD; ++i) {
                if (i < D) {
                    af[i][0] = ld32(&ws[i][wm + g][ks + 4 * t4]);
                    af[i][1] = ld32(&ws[i][wm + g + 8][ks + 4 * t4]);
                    af[i][2] = ld32(&ws[i][wm + g][ks + 16 + 4 * t4]);
                    af[i][3] = ld32(&ws[i][wm + g + 8][ks + 16 + 4 * t4]);
                }
            }
#pragma unroll
            for (int j = 0; j < MAXD; ++j) {
                if (j < Dx) {
                    uint32_t bf[2][2];
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        bf[nt][0] = ld32(&xs[j][wn + nt * 8 + g][ks + 4 * t4]);
                        bf[nt][1] =
                            ld32(&xs[j][wn + nt * 8 + g][ks + 16 + 4 * t4]);
                    }
#pragma unroll
                    for (int i = 0; i < MAXD; ++i) {
                        if (i < D) {
                            mma_s8(acc[i + j][0], af[i], bf[0]);
                            mma_s8(acc[i + j][1], af[i], bf[1]);
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int pair = tid + h * THREADS;
        const int pl = pair / BN, vec = pair % BN;
        if (pl < Dx) xpre[pl + 1][vec] = xsum[h];
    }
    __syncthreads();
    if (tid < BN) {
        xpre[0][tid] = 0;
        for (int pl = 0; pl < Dx; ++pl) xpre[pl + 1][tid] += xpre[pl][tid];
    }
    __syncthreads();

    const uint64_t m_off = c[kLeft ? 3 : 4];
    const uint64_t *tw =
        tsel >= 0 ? reinterpret_cast<const uint64_t *>(p[8 + 2 * tsel])
                  : nullptr;
    const uint64_t *tws =
        tsel >= 0 ? reinterpret_cast<const uint64_t *>(p[9 + 2 * tsel])
                  : nullptr;
    const int nsum = D + Dx - 1;
    const int bias_k = 128 * 128 * K;
    uint64_t *y = out + base;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            // the m16n8 accumulator layout: rows g and g + 8, columns
            // 2 t4 and 2 t4 + 1
            const int ml = wm + g + ((e >> 1) << 3);
            const int vl = wn + nt * 8 + 2 * t4 + (e & 1);
            int64_t grp[4] = {0, 0, 0, 0};
#pragma unroll
            for (int s = 0; s < NSUM; ++s) {
                if (s < nsum) {
                    const int lo = s - Dx + 1 > 0 ? s - Dx + 1 : 0;
                    const int hi = s < D - 1 ? s : D - 1;
                    const int wc = wpre[hi + 1][ml] - wpre[lo][ml];
                    const int xc = xpre[s - lo + 1][vl] - xpre[s - hi][vl];
                    const int sum = acc[s][nt][e] + 128 * wc + 128 * xc +
                                    bias_k * (hi - lo + 1);
                    grp[s >> 2] += static_cast<int64_t>(sum) *
                                   (int64_t(1) << (8 * (s & 3)));
                }
            }
            uint64_t r = 0;
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) {
                if (4 * gi < nsum) {
                    // m_off + grp is in [0, 2^63): the signed-to-unsigned
                    // step is exact
                    const uint64_t av =
                        m_off + static_cast<uint64_t>(grp[gi]);
                    const uint64_t term =
                        mul_mod_shoup(av, c[5 + gi], c[9 + gi], q);
                    r = gi == 0 ? term : add_mod(r, term, q);
                }
            }
            const int64_t off =
                kLeft ? (static_cast<int64_t>(m0 + ml) << log_b) + v0 + vl
                      : (static_cast<int64_t>(v0 + vl) << log_b) + m0 + ml;
            if (tw != nullptr) r = mul_mod_shoup(r, tw[off], tws[off], q);
            y[off] = r;
        }
    }
}

}  // namespace

// One stage of J over `rows` rows of (2^log_a, 2^log_b) words (row r uses
// limb r % k of the (k, 16) pointer table): left = 1 contracts the rows
// (W @ X), 0 the columns (X @ W); mat the matrix (0 W1, 1 W2^T, 2 V1,
// 3 V2^T); tsel the twiddle grid of the epilogue (-1 none, 0 Tw, 1 iTw);
// reduce_in = 1 Barrett-reduces the input words unless x_planes (1-8)
// bounds them for a limb whose modulus is at least as wide.
extern "C" int troy_ntt_mxu(void *out, const void *in, long long rows, int k,
                            int log_a, int log_b, const void *ptrs, int left,
                            int mat, int tsel, int reduce_in, int x_planes,
                            void *stream) {
    if (rows < 1 || rows > 0x7FFFFFFFLL || k < 1 || log_a < 5 || log_b < 5 ||
        log_a > 9 || log_b > 9 || mat < 0 || mat > 3 || tsel < -1 ||
        tsel > 1 || x_planes < 0 || x_planes > MAXD) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int log_m = left ? log_a : log_b;      // W's rows
    const int log_v = left ? log_b : log_a;      // X's vectors
    const dim3 grid(static_cast<unsigned>(rows), 1u << (log_v - 5),
                    1u << (log_m - 5));
    auto kernel = left ? ntt_mxu_kernel<true> : ntt_mxu_kernel<false>;
    kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), k,
        log_a, log_b, static_cast<const uint64_t *>(ptrs), mat, tsel,
        reduce_in, x_planes);
    TROY_RETURN_LAUNCH_STATUS();
}
