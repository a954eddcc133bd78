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
//              1/scale (redesigned for the H100: see below);
//   O4:        O2, and max |rint(Re(u * untwist) * scale)| over the n
//              coefficients into one f64 word;
//   O5:        O1 decode, and max(|Re V[j] - Re V[n-1-j]|, |Im V[j] +
//              Im V[n-1-j]|) over the slots j into one f64 word: the
//              partners n-1-idx_i are exactly the positions that are not
//              slots, so the rows pass stores them to a second buffer and
//              reduces the residual of the slots it holds.
//
// Both statistics are maxima of values >= 0, reduced in a block (warp
// shuffles, then shared memory) and across blocks by atomicMax on the u64
// bit pattern of the double, which orders non-negative doubles as their
// values: the result does not depend on the order of the blocks. O4's word
// is zeroed on the launch's stream (cudaMemsetAsync) just before; O5's by
// the first block of O1's columns pass, which runs before its rows pass on
// the same stream. O4 adds no launch to O2 and no pass over memory; O5 adds
// the n/2 partner values (stored once) to O1's two passes, and no launch.
//
// O1 is the 4-step transform of the JAX package: n = A x B, x[a*B + b],
//   s[p1, b]        = tw[p1, b] * sum_a w^(B p1 a) x[a, b]     (pass 1)
//   out[p2*A + p1]  = sum_b w^(A b p2) s[p1, b]                (pass 2)
// (w = exp(-2 pi i / n) for the encode, its conjugate for the decode), so
// pass 1 is a length-A DFT of every column and pass 2 a length-B DFT of
// every row. Each pass runs them as radix-2 decimation-in-frequency FFTs in
// shared memory: a block copies its lines (COLS columns in pass 1; in pass
// 2 the rows p1 and A-1-p1, which hold every slot's partner: n-1-(p2 A +
// p1) = (B-1-p2) A + (A-1-p1)) into a line-major tile padded by one word
// in eight against bank conflicts, and copies the line length's root table
// (round r's L/2^(r+1) roots W^(j 2^r) one after another, W = w^B or w^A,
// made on the host with the angle reduced mod n: ops/embedding.py
// line_roots). The log2(L) rounds run in stages of up to LOG_RADIX in
// registers (a thread takes 2^R words of one line), a barrier between
// stages; round r joins the words L/2^(r+1) apart and multiplies their
// difference by root j 2^r, j the index mod L/2^(r+1). Word i of a line
// then holds output brv(i): pass 1 stores it times the tw grid, pass 2
// times 1/n (encode) or through the slot scatter (decode), and O5's
// residual is read off the two rows of the block before it reduces. The
// (n,) intermediate goes through device memory (L2) between the launches.
// tests/test_torch_embedding_fft.py emulates both passes in plain PyTorch.
//
// What bounds them on the H100: at n = 16384 an FFT is 1.15 MFLOP and the
// function moves about 0.4 MB (0.117 us at 3.35 TB/s): far below a launch,
// so latency bounds O1 (two launches, each an L2 round trip and
// log2(L) / LOG_RADIX barriers; about 2.5 us a launch there, 64 blocks of
// 64 threads). Radix 4 with two columns a block ran the fastest of radix
// 2, 4 and 8 with one, two and four columns at n = 4096-131072 on the
// H100. The direct sums this replaces did 33.5 MFLOP over
// dense (A, A) and (B, B) matrices in 32 blocks a pass. O2 is one thread
// per coefficient with k limbs, bound by its k*n words. Its per-word
// arithmetic is ckks_round.cuh's, shared with AO2p (ntt.cu
// troy_ntt_forward_round), which runs the rounding inside kernel A's
// first forward pass on A's route: O2's own kernel runs where the
// transforms are J's (n > 131072, use_mxu=True), and as O4 (the
// statistic) on either route.
//
// O3 moves k*n words in and n out (0.2 us at the CKKS headline's n =
// 16384, k = 5), so latency bounds it: a launch and one round trip to
// memory. Its design keeps that round trip the only wait:
//  - a thread issues all its residue loads (up to kComposeChunk) first,
//    and the block copies the constants (q, invp, P_j, Q, 1/q_j: at most
//    10.5 KB) into shared memory while they are in flight (a global load
//    of each limb's constants after the previous limb's arithmetic cost
//    about 0.45 us a limb at n = 16384 on the H100, PERF.md);
//  - one thread a coefficient in 128-thread blocks (one block an SM at
//    n = 16384): two or four lanes a coefficient joined by warp shuffles
//    were no faster at n <= 32768 and 1.4-2.9 times slower at 262144;
//  - the kernel is compiled for each W (2-16), so no word is predicated;
//  - one multiple of Q instead of k - 1 serial W-word subtracts: with
//    x_j = r_j invp_j mod q_j, acc = sum_j x_j P_j = S Q for S = sum_j
//    x_j / q_j, so v = acc - rint(S) Q is the centred value directly
//    (CKKS coefficients are tiny against Q: S lies next to an integer,
//    where a floor would be one off for every negative value). S is
//    summed in f64, which is off by less than 2^-40 for 64 limbs; only
//    where S is within kComposeTieMargin of a half-integer (|v| near Q/2)
//    is |v| compared with (Q + 1)/2 and, past it, replaced by Q - |v| of
//    the other sign.
// The magnitude is exact either way, so the top-down f64 conversion gives
// the plain version's bits. tests/test_torch_compose.py emulates these
// steps on the CPU.
//
// Floating point: O2 and O3 must give the plain PyTorch versions' bits, so
// every f64 step that feeds a rounding is written with __dmul_rn /
// __dadd_rn / __dsub_rn (O2's in ckks_round.cuh), which nvcc never
// contracts into a fused multiply-add (it does contract a*b + c by
// default). O1 is held to 2^-44 max|x| of its plain version and lets nvcc
// contract; O5 runs O1's decode passes themselves, so its slots are O1's
// bits.

#include "ckks_round.cuh"

using namespace troy;

namespace {

constexpr int LOG_RADIX = 2;     // FFT rounds a stage keeps in registers
constexpr int COLS = 2;          // columns a block, pass 1 (A >= 4)
constexpr int MAX_LOG_LINE = 9;  // lines of up to 512 words (n <= 2^18)
constexpr int THREADS = 256;
constexpr int MAX_WORDS = 16;    // O3 accumulator words (Q < 2^960)
constexpr int MAX_LIMBS = 64;
// O3: residues a thread loads before their arithmetic, threads a block, and
// the distance from a half-integer below which S's f64 error (under
// 2^-40 for 64 limbs: a rounding in each conversion, product and sum)
// could put e on the wrong side, where the exact correction runs
constexpr int kComposeChunk = 8;
constexpr int kComposeThreads = 128;
constexpr double kComposeTieMargin = 0x1p-30;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// max over the block of v >= 0, atomically into the u64 bit pattern at
// word. Every thread of the block calls it; blockDim.x is a multiple of 32.
__device__ void block_max_to(double v, unsigned long long *word) {
    __shared__ double warp_max[32];
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

// Columns a block of pass 1 (lines of 2^log_a words).
__host__ __device__ constexpr int cols_of(int log_a) {
    return log_a >= 2 ? COLS : 1;
}

// Threads of a block of `lines` lines of 2^log_line words: one a group of
// 2^LOG_RADIX words, whole warps.
__host__ __device__ constexpr int threads_of(int log_line, int lines) {
    return ((lines << log_line) >> (log_line < LOG_RADIX ? log_line
                                                          : LOG_RADIX)) < 32
               ? 32
               : (lines << log_line) >> LOG_RADIX;
}

// Shared-memory position of word f of a line-major tile: one pad word in
// eight, so that words 2^R apart (R <= 3) fall in different banks.
__device__ __forceinline__ int spos(int f) { return f + (f >> 3); }

__device__ __forceinline__ int bit_reverse(int i, int log_line) {
    return log_line ? static_cast<int>(__brev(static_cast<unsigned>(i)) >>
                                       (32 - log_line))
                    : 0;
}

// Stage s of a line's ceil(log_line / LOG_RADIX) stages: R rounds from
// round rho0, as even as they go.
__device__ __forceinline__ void fft_stage_plan(int s, int log_line, int &R,
                                               int &rho0) {
    const int stages = (log_line + LOG_RADIX - 1) / LOG_RADIX;
    const int small = log_line / stages, extra = log_line % stages;
    R = small + (s < extra ? 1 : 0);
    rho0 = s * small + (s < extra ? s : extra);
}

// Rounds rho0 .. rho0 + R - 1 on the 2^R words v[m] = line[base + (m <<
// log_h)] of one line of 2^kLogLine words; roots: the round-major table.
template <int R, int kLogLine>
__device__ __forceinline__ void fft_rounds(double2 (&v)[1 << R],
                                           const double2 *roots, int base,
                                           int log_h, int rho0) {
    const int low = base & ((1 << log_h) - 1);
#pragma unroll
    for (int t = 0; t < R; ++t) {
        const int rho = rho0 + t;
        const int d = 1 << (R - 1 - t);
        // round rho's roots start at L - L / 2^rho
        const double2 *run = roots + ((1 << kLogLine) -
                                      ((1 << kLogLine) >> rho));
#pragma unroll
        for (int m = 0; m < (1 << R); ++m) {
            if (m & d) continue;
            // the index mod L / 2^(rho+1): base's low bits, m's below d
            const double2 w = run[low | ((m & (d - 1)) << log_h)];
            const double2 a = v[m], b = v[m + d];
            v[m] = make_double2(a.x + b.x, a.y + b.y);
            v[m + d] = cmul(make_double2(a.x - b.x, a.y - b.y), w);
        }
    }
}

// The stages with R rounds from rho0 on every line of a line-major tile.
template <int R, int kLogLine, int kLines, int kThreads>
__device__ __forceinline__ void fft_stage(double2 *x_s,
                                          const double2 *roots, int rho0) {
    constexpr int log_groups = kLogLine - R;           // groups a line
    constexpr int items = kLines << log_groups;
    const int log_h = kLogLine - rho0 - R;             // the stage's gap
#pragma unroll
    for (int rep = 0; rep < (items + kThreads - 1) / kThreads; ++rep) {
        const int it = threadIdx.x + rep * kThreads;
        if (items % kThreads != 0 && it >= items) break;
        const int l = it >> log_groups;
        const int g = it & ((1 << log_groups) - 1);
        const int base = (l << kLogLine) |
                         ((g >> log_h) << (kLogLine - rho0)) |
                         (g & ((1 << log_h) - 1));
        double2 v[1 << R];
#pragma unroll
        for (int m = 0; m < (1 << R); ++m) {
            v[m] = x_s[spos(base + (m << log_h))];
        }
        fft_rounds<R, kLogLine>(v, roots, base, log_h, rho0);
#pragma unroll
        for (int m = 0; m < (1 << R); ++m) {
            x_s[spos(base + (m << log_h))] = v[m];
        }
    }
}

// Every line of the tile transformed in place (word i holds output
// brv(i)); the tile and the roots are loaded, and the caller syncs after.
template <int kLogLine, int kLines, int kThreads>
__device__ __forceinline__ void fft_lines(double2 *x_s,
                                          const double2 *roots) {
#pragma unroll
    for (int s = 0; s < (kLogLine + LOG_RADIX - 1) / LOG_RADIX; ++s) {
        int R, rho0;
        fft_stage_plan(s, kLogLine, R, rho0);
        if (R == 3) {
            if constexpr (LOG_RADIX >= 3 && kLogLine >= 3) {
                fft_stage<3, kLogLine, kLines, kThreads>(x_s, roots, rho0);
            }
        } else if (R == 2) {
            if constexpr (LOG_RADIX >= 2 && kLogLine >= 2) {
                fft_stage<2, kLogLine, kLines, kThreads>(x_s, roots, rho0);
            }
        } else {
            if constexpr (kLogLine >= 1) {
                fft_stage<1, kLogLine, kLines, kThreads>(x_s, roots, rho0);
            }
        }
        __syncthreads();
    }
}

// Pass 1 over columns b0 .. b0 + COLS - 1 (lines of A = 2^kLogA words):
// s[p1, b] = tw[p1, b] * FFT(x[., b])[p1]. Encode: x[j] is the slot
// scatter of `in` (complex, `count` values) by `index` (i, or ~i for the
// conjugate); decode: x[j] = in[j] (real) * twist[j]. The first block
// zeroes *err where it is given (O5's residual word).
template <int kLogA>
__global__ void __launch_bounds__(threads_of(kLogA, cols_of(kLogA)))
fft_cols_kernel(double2 *__restrict__ s, const void *__restrict__ in,
                const int *__restrict__ index, long long count,
                const double2 *__restrict__ twist,
                const double2 *__restrict__ roots,
                const double2 *__restrict__ tw, int log_b, bool encode,
                unsigned long long *__restrict__ err) {
    constexpr int L = 1 << kLogA, C = cols_of(kLogA), W = L * C;
    constexpr int T = threads_of(kLogA, C), PER = (W + T - 1) / T;
    __shared__ __align__(16) double2 x_s[W + W / 8];
    __shared__ __align__(16) double2 r_s[L];
    const int b0 = blockIdx.x * C;
    if (err != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *err = 0;
    // word f = rep T + thread of the tile stores output brv(f / C) of
    // column f % C: its grid entry, read while the tile loads
    auto out_at = [&](int f) {
        return (static_cast<int64_t>(bit_reverse(f / C, kLogA)) << log_b) +
               b0 + (f & (C - 1));
    };
    double2 tw_r[PER];
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (W % T == 0 || f < W) tw_r[rep] = tw[out_at(f)];
    }
    for (int f = threadIdx.x; f < L - 1; f += T) r_s[f] = roots[f];
    // consecutive threads, consecutive columns of a row
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (W % T != 0 && f >= W) break;
        const int l = f & (C - 1), a = f / C;
        const int64_t j = (static_cast<int64_t>(a) << log_b) + b0 + l;
        double2 v;
        if (encode) {
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
        x_s[spos(l * L + a)] = v;
    }
    __syncthreads();
    fft_lines<kLogA, C, T>(x_s, r_s);
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (W % T == 0 || f < W) {
            s[out_at(f)] =
                cmul(x_s[spos((f & (C - 1)) * L + f / C)], tw_r[rep]);
        }
    }
}

// Pass 2 over rows p1 = blockIdx.x and A-1-p1 (lines of B = 2^kLogB
// words): out[p2*A + p1] = FFT(s[p1, .])[p2]. Encode: out[k] = that times
// out_scale (complex, n); decode: out[scatter[k]] = it where scatter[k] >=
// 0 (the slots, scatter[idx_i] = i) and, with partner, partner[~scatter[k]]
// = it elsewhere (their partners, scatter[n-1-idx_i] = ~i), and the
// block's residual max(|Re v - Re p|, |Im v + Im p|) over its slots v and
// their partners p (the other row's word at B-1-p2) into *err.
template <int kLogB>
__global__ void __launch_bounds__(threads_of(kLogB, 2))
fft_rows_kernel(double2 *__restrict__ out, const double2 *__restrict__ s,
                const int *__restrict__ scatter,
                const double2 *__restrict__ roots, int log_a,
                double out_scale, bool encode,
                double2 *__restrict__ partner,
                unsigned long long *__restrict__ err) {
    constexpr int L = 1 << kLogB, W = 2 * L;
    constexpr int T = threads_of(kLogB, 2), PER = (W + T - 1) / T;
    __shared__ __align__(16) double2 x_s[W + W / 8];
    __shared__ __align__(16) double2 r_s[L];
    // line l holds row p1_of(l); word f = rep T + thread of the tile stores
    // output k = out_at(f), through the scatter entry read while the tile
    // loads (decode)
    const int p1 = blockIdx.x, p1_pair = (1 << log_a) - 1 - p1;
    auto p1_of = [&](int l) { return l ? p1_pair : p1; };
    auto out_at = [&](int f) {
        return (static_cast<int64_t>(bit_reverse(f & (L - 1), kLogB))
                << log_a) + p1_of(f >> kLogB);
    };
    int slot_r[PER];
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (!encode && (W % T == 0 || f < W)) {
            slot_r[rep] = scatter[out_at(f)];
        }
    }
    for (int f = threadIdx.x; f < L - 1; f += T) r_s[f] = roots[f];
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (W % T != 0 && f >= W) break;
        x_s[spos(f)] =
            s[(static_cast<int64_t>(p1_of(f >> kLogB)) << kLogB) +
              (f & (L - 1))];
    }
    __syncthreads();
    fft_lines<kLogB, 2, T>(x_s, r_s);
    double m = 0.0;
#pragma unroll
    for (int rep = 0; rep < PER; ++rep) {
        const int f = threadIdx.x + rep * T;
        if (W % T != 0 && f >= W) break;
        const int l = f >> kLogB, i = f & (L - 1);
        const double2 v = x_s[spos(f)];
        if (encode) {
            out[out_at(f)] = make_double2(v.x * out_scale, v.y * out_scale);
            continue;
        }
        const int slot = slot_r[rep];
        if (slot >= 0) {
            out[slot] = v;
            if (partner != nullptr) {
                // n-1-k: row A-1-p1 (the other line), word B-1-p2
                const double2 p = x_s[spos(((l ^ 1) << kLogB) + (L - 1 - i))];
                m = fmax(m, fmax(fabs(v.x - p.x), fabs(v.y + p.y)));
            }
        } else if (partner != nullptr) {
            partner[~slot] = v;
        }
    }
    if (err != nullptr) block_max_to(m, err);
}

typedef void (*ColsKernel)(double2 *, const void *, const int *, long long,
                           const double2 *, const double2 *,
                           const double2 *, int, bool, unsigned long long *);
typedef void (*RowsKernel)(double2 *, const double2 *, const int *,
                           const double2 *, int, double, bool, double2 *,
                           unsigned long long *);

template <int kLog>
void kernels_for(int log_a, int log_b, ColsKernel &cols, RowsKernel &rows) {
    if constexpr (kLog >= 1) {
        if (log_a == kLog) cols = fft_cols_kernel<kLog>;
    }
    if (log_b == kLog) rows = fft_rows_kernel<kLog>;
    if constexpr (kLog < MAX_LOG_LINE) {
        kernels_for<kLog + 1>(log_a, log_b, cols, rows);
    }
}

int log2_of(int v) { return 31 - __builtin_clz(static_cast<unsigned>(v)); }

// The split O1 takes: A = 2^1 .. 2^9 and B = 2^0 .. 2^9, with B >=
// cols_of(log2 A).
bool takes(int A, int B) {
    return A >= 2 && B >= 1 && !(A & (A - 1)) && !(B & (B - 1)) &&
           A <= (1 << MAX_LOG_LINE) && B <= (1 << MAX_LOG_LINE) &&
           B >= cols_of(log2_of(A));
}

// O1 (and O5 with partner and err); a split it does not take is refused.
int fft(double2 *out, const void *in, double2 *scratch, const int *index,
        long long count, const double2 *twist, const double2 *roots_a,
        const double2 *tw, const double2 *roots_b, int A, int B,
        double out_scale, bool encode, cudaStream_t stream,
        double2 *partner = nullptr, unsigned long long *err = nullptr) {
    if (!takes(A, B)) return static_cast<int>(cudaErrorInvalidValue);
    const int log_a = log2_of(A), log_b = log2_of(B);
    const int cols = cols_of(log_a);
    ColsKernel cols_kernel = nullptr;
    RowsKernel rows_kernel = nullptr;
    kernels_for<0>(log_a, log_b, cols_kernel, rows_kernel);
    cols_kernel<<<B / cols, threads_of(log_a, cols), 0, stream>>>(
        scratch, in, index, count, twist, roots_a, tw, log_b, encode, err);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rows_kernel<<<A / 2, threads_of(log_b, 2), 0, stream>>>(
        out, scratch, index, roots_b, log_a, out_scale, encode, partner,
        err);
    TROY_RETURN_LAUNCH_STATUS();
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
    const RoundLayout L{k, E};
    const int64_t n = int64_t(1) << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    double largest = 0.0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
        double a;
        const RoundedWord w =
            round_split(untwisted_re(u[i], untwist[i]), scale, E, a);
        if (kStats) largest = fmax(largest, a);
        for (int j = 0; j < k; ++j) {
            const int64_t row = static_cast<int64_t>(j) * E;
            out[(static_cast<int64_t>(j) << log_n) + i] =
                round_limb(w, q[j], ratio[j], consts + L.pow2() + row,
                           consts + L.pow2_shoup() + row);
        }
    }
    if (kStats) block_max_to(largest, stat);
}

// O3. consts: q (k), invp (k), invp Shoup (k), punctured products P_j
// (k x W words), Q (W words), (Q + 1) / 2 (W words), then 1/q_j as f64
// bit patterns (k); words little-endian (ops/embedding.py
// make_rns_round_tables). One thread a coefficient; W, the accumulator's
// words, is compiled for (2..16).
template <int W>
__global__ void compose_kernel(double *__restrict__ out,
                               const uint64_t *__restrict__ res, int k,
                               int log_n,
                               const uint64_t *__restrict__ consts,
                               double inv_scale) {
    extern __shared__ uint64_t c_s[];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    const bool valid = i < (int64_t(1) << log_n);
    // the first residues, in flight while the block copies the constants
    // into shared memory (one round trip for both)
    uint64_t r[kComposeChunk];
#pragma unroll
    for (int t = 0; t < kComposeChunk; ++t) {
        r[t] = valid && t < k
            ? __ldg(res + (static_cast<int64_t>(t) << log_n) + i) : 0;
    }
    for (int x = threadIdx.x; x < 4 * k + k * W + 2 * W; x += blockDim.x) {
        c_s[x] = __ldg(consts + x);
    }
    __syncthreads();
    if (!valid) return;
    const uint64_t *q = c_s, *invp = c_s + k, *invp_shoup = c_s + 2 * k,
                   *punct = c_s + 3 * k;
    const uint64_t *q_words = punct + k * W, *qhalf_words = q_words + W;
    const uint64_t *inv_q = qhalf_words + W;

    // acc = sum_j x_j P_j exactly (W words) and S = sum_j x_j / q_j in f64,
    // x_j = r_j invp_j mod q_j: acc = S Q. A chunk's residues are all
    // loaded before its arithmetic.
    uint64_t acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0;
    double s = 0.0;
    for (int c = 0; c < k; c += kComposeChunk) {
        if (c > 0) {
#pragma unroll
            for (int t = 0; t < kComposeChunk; ++t) {
                r[t] = c + t < k
                    ? __ldg(res + (static_cast<int64_t>(c + t) << log_n) + i)
                    : 0;
            }
        }
#pragma unroll
        for (int t = 0; t < kComposeChunk; ++t) {
            const int j = c + t;
            if (j >= k) break;
            const uint64_t qj = q[j];
            const uint64_t x = mul_mod_shoup(r[t], invp[j], invp_shoup[j],
                                             qj);
            s = __dadd_rn(s, __dmul_rn(__ull2double_rn(x),
                                       __longlong_as_double(
                                           static_cast<long long>(inv_q[j]))));
            const uint64_t *pw = punct + j * W;
            uint64_t carry = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const uint64_t p = pw[w];
                const uint64_t lo = x * p;
                const uint64_t hi = __umul64hi(x, p);
                const uint64_t s1 = acc[w] + lo;
                const uint64_t c1 = s1 < lo;
                const uint64_t s2 = s1 + carry;
                const uint64_t c2 = s2 < carry;
                acc[w] = s2;
                carry = hi + c1 + c2;
            }
        }
    }

    // v = acc - e Q with e the integer nearest S: the centred value, in
    // two's complement (|v| < Q, so the top word is all sign)
    const double e_f = rint(s);
    const uint64_t e = static_cast<uint64_t>(e_f);
    uint64_t carry = 0, borrow = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const uint64_t qw = q_words[w];
        const uint64_t lo = e * qw;
        const uint64_t m = lo + carry;
        carry = __umul64hi(e, qw) + (m < lo);
        const uint64_t d = acc[w] - m;
        const uint64_t b1 = acc[w] < m;
        acc[w] = d - borrow;
        borrow = b1 + (d < borrow);
    }
    bool neg = static_cast<int64_t>(acc[W - 1]) < 0;
    if (neg) {       // |v| = -v
        uint64_t c = 1;
#pragma unroll
        for (int w = 0; w < W; ++w) {
            acc[w] = ~acc[w] + c;
            c = c && acc[w] == 0;
        }
    }
    // S within the f64 error of a half-integer: e may be one off, and |v|
    // then reaches (Q + 1) / 2; Q - |v| of the other sign is the value
    if (fabs(__dsub_rn(s, e_f)) > 0.5 - kComposeTieMargin) {
        uint64_t b = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const uint64_t hw = qhalf_words[w];
            const uint64_t d1 = acc[w] - hw;
            b = (acc[w] < hw) + (d1 < b);
        }
        if (b == 0) {
            b = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const uint64_t qw = q_words[w];
                const uint64_t d1 = qw - acc[w];
                const uint64_t b1 = qw < acc[w];
                acc[w] = d1 - b;
                b = b1 + (d1 < b);
            }
            neg = !neg;
        }
    }
    // top-down f64 conversion, in the plain version's order
    double f = 0.0;
#pragma unroll
    for (int w = W - 1; w >= 0; --w) {
        const double hi = static_cast<double>(
            static_cast<uint32_t>(acc[w] >> 32));
        const double lo = static_cast<double>(static_cast<uint32_t>(acc[w]));
        f = __dadd_rn(__dadd_rn(__dmul_rn(f, 0x1p64), __dmul_rn(hi, 0x1p32)),
                      lo);
    }
    out[i] = __dmul_rn(neg ? -f : f, inv_scale);
}

template <int W>
int compose_launch(double *out, const uint64_t *res, int k, int log_n,
                   const uint64_t *consts, double inv_scale,
                   cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>(
        ((1LL << log_n) + kComposeThreads - 1) / kComposeThreads);
    const size_t smem = sizeof(uint64_t) * (4 * k + k * W + 2 * W);
    compose_kernel<W><<<blocks, kComposeThreads, smem, stream>>>(
        out, res, k, log_n, consts, inv_scale);
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// O1, encode: values (count,) complex -> u (n,) complex = FFT(V) / n.
// scratch (n,) complex; scatter (n,) int32; roots_a (A - 1) and roots_b
// (B - 1) the line lengths' round-major root tables, tw (A, B) the grid,
// complex, of the encode direction.
extern "C" int troy_ckks_fft_encode(void *out, const void *values,
                                    void *scratch, const void *scatter,
                                    long long count, const void *roots_a,
                                    const void *tw, const void *roots_b,
                                    int A, int B, double inv_n,
                                    void *stream) {
    return fft(static_cast<double2 *>(out), values,
               static_cast<double2 *>(scratch),
               static_cast<const int *>(scatter), count, nullptr,
               static_cast<const double2 *>(roots_a),
               static_cast<const double2 *>(tw),
               static_cast<const double2 *>(roots_b), A, B, inv_n, true,
               static_cast<cudaStream_t>(stream));
}

// O1, decode: coeffs (n,) f64 -> slots (n/2,) complex = conj-FFT(c twist)
// at the slot positions. scatter (n,) int32 (i at slot i, ~i at its
// partner); twist (n,) complex; the tables are the conjugate direction's.
extern "C" int troy_ckks_fft_decode(void *out, const void *coeffs,
                                    void *scratch, const void *scatter,
                                    const void *twist, const void *roots_a,
                                    const void *tw, const void *roots_b,
                                    int A, int B, void *stream) {
    return fft(static_cast<double2 *>(out), coeffs,
               static_cast<double2 *>(scratch),
               static_cast<const int *>(scatter), 0,
               static_cast<const double2 *>(twist),
               static_cast<const double2 *>(roots_a),
               static_cast<const double2 *>(tw),
               static_cast<const double2 *>(roots_b), A, B, 1.0, false,
               static_cast<cudaStream_t>(stream));
}

// O5, decode with the residual: O1 decode into out (n/2,) complex, the
// partners into partner (n/2,) complex, the residual into err (one f64
// word, zeroed by the columns pass); scratch (n,) complex.
extern "C" int troy_ckks_fft_decode_stats(void *out, void *partner, void *err,
                                          const void *coeffs, void *scratch,
                                          const void *scatter,
                                          const void *twist,
                                          const void *roots_a,
                                          const void *tw,
                                          const void *roots_b, int A, int B,
                                          void *stream) {
    return fft(static_cast<double2 *>(out), coeffs,
               static_cast<double2 *>(scratch),
               static_cast<const int *>(scatter), 0,
               static_cast<const double2 *>(twist),
               static_cast<const double2 *>(roots_a),
               static_cast<const double2 *>(tw),
               static_cast<const double2 *>(roots_b), A, B, 1.0, false,
               static_cast<cudaStream_t>(stream),
               static_cast<double2 *>(partner),
               static_cast<unsigned long long *>(err));
}

// The blocks and threads of O1's two launches at (A, B), columns then
// rows, into geometry[0..3]: 2, or 0 for a split the kernel refuses. No
// launch: what the profiler's kernels are measured against.
extern "C" int troy_ckks_fft_geometry(int A, int B, long long *geometry) {
    if (!takes(A, B)) return 0;
    const int log_a = log2_of(A), log_b = log2_of(B);
    geometry[0] = B / cols_of(log_a);
    geometry[1] = threads_of(log_a, cols_of(log_a));
    geometry[2] = A / 2;
    geometry[3] = threads_of(log_b, 2);
    return 2;
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
    if (k < 1 || k > MAX_LIMBS || W < 2 || W > MAX_WORDS) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    double *o = static_cast<double *>(out);
    const uint64_t *r = static_cast<const uint64_t *>(residues);
    const uint64_t *c = static_cast<const uint64_t *>(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (W) {
#define TROY_COMPOSE_W(w) \
    case w: return compose_launch<w>(o, r, k, log_n, c, inv_scale, s);
    TROY_COMPOSE_W(2) TROY_COMPOSE_W(3) TROY_COMPOSE_W(4) TROY_COMPOSE_W(5)
    TROY_COMPOSE_W(6) TROY_COMPOSE_W(7) TROY_COMPOSE_W(8) TROY_COMPOSE_W(9)
    TROY_COMPOSE_W(10) TROY_COMPOSE_W(11) TROY_COMPOSE_W(12)
    TROY_COMPOSE_W(13) TROY_COMPOSE_W(14) TROY_COMPOSE_W(15)
    TROY_COMPOSE_W(16)
#undef TROY_COMPOSE_W
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
