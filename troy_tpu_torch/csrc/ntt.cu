// Kernel A: negacyclic NTT and inverse NTT over a batch of rows.
//
// Replaces troy_tpu/ops/ntt.py:318 rns_ntt_forward and :372 rns_ntt_inverse
// (and their single-modulus forms :227 ntt_forward, :260 ntt_inverse, the
// per-limb :411/:419 and the MXU 4-step ops/ntt_mxu.py:377/:404, which give
// the same words). Forward: Harvey lazy Cooley-Tukey, natural order in,
// bit-reversed order out, values in [0, 4q) between rounds. Inverse:
// Gentleman-Sande with n^-1 folded in at the end, lazy in [0, 2q).
// With lazy=1 the forward output is left in [0, 4q) and the inverse output
// in [0, 2q), as in the butterfly path of the JAX package.
//
// Input (rows, n) u64 words, row r uses table row (r % k): the leading axes
// of a (..., k, n) tensor flatten into rows, so one call covers every
// polynomial and limb. Round r of the forward transform reads its twiddles
// as root_powers[m : 2m] with their Shoup words (ops/ntt.py:353-361).
//
// What bounds it on the H100: the instructions of the 64-bit butterflies
// (three 64-bit products each, emulated in 32-bit multiply-adds) and the
// index arithmetic around them, not the bytes: a mult+relin's few MB stay
// in the 50 MB L2. One 16384-point row is 14 rounds of 8192 butterflies.
//
// Design: every round's butterflies join words whose indices differ in one
// bit, so the log2(n) = a + b rounds split into two passes, each a set of
// independent short transforms ("lines") that fill the card whatever the
// row count:
//  - the strided pass: the a rounds whose gaps are >= 2^b (the forward's
//    first, the inverse's last), on the columns c of the row seen as a
//    (2^a, 2^b) matrix: line c holds words c + 2^b i, a 2^a-point transform
//    whose round-r twiddle is root_powers[2^r + (i >> (a - r))], the first
//    2^a entries of the table; a block takes 2^log_lines consecutive
//    columns, so its loads and stores are coalesced;
//  - the contiguous pass: the b rounds with gaps < 2^b, on the chunks j of
//    2^b consecutive words: chunk j is a 2^b-point transform whose round-r
//    twiddle is root_powers[(2^a + j) 2^r + blk], several chunks a block.
// At n = 16384, a = b = 7 and 1024-word tiles: 16 blocks a row a pass, 480
// at the headline's (5, 6, n) where one block a row gave 30. Rings below
// 2^kSplitLogN keep one pass over whole rows ("rows" mode), 2^log_lines
// rows a block; the crossover was measured on the H100 (PERF.md).
// A block first copies its lines' twiddles into shared memory beside its
// words (one table for all columns of the strided pass: root_powers[1 :
// 2^a]), so no round waits on a global load; words and twiddles take at
// most 96 KiB (n = 2^24).
// Inside a block the line's rounds run in stages of up to three: a thread
// loads the 8 (4, 2) words that three (two, one) consecutive rounds join
// from shared memory into registers, runs those rounds there
// (butterfly.cuh, shared with kernel J), and writes them back; stages are
// separated by __syncthreads(). Every butterfly is
// the one-row-per-block kernel's, word for word (the same `a >= 2q`
// correction and Shoup product, reduce_4q / n^-1 and reduce_2q only at the
// end), so the split changes no word. Shared memory of the contiguous
// layouts is XOR-swizzled in 16-word groups, so the stages' 8-word strides
// do not meet in one bank.
// The two passes of 1024-word tiles (n = 2048-65536) run kernels compiled
// for their geometry (line and tile sizes and thread count as constants),
// so the index arithmetic folds away; other plans run one kernel that
// reads its geometry at run time.
//
// troy_ntt_forward_digits folds the key switch's digits (kernel F's
// troy_keyswitch_digits, troy_tpu/evaluator.py:179 _switch_key_decompose)
// into the forward transform: output row r of (rows, n) is the NTT of
// source row r / k reduced mod q[r % k] (Barrett-64 on the high ratio
// word, F's arithmetic), so the first pass (the strided one, or the one
// pass over whole rows) reads the source row and reduces each word as it
// loads it. The butterflies, twiddles, passes and geometry are A's, so the
// words are those of F's digits then A's forward; the (k, k+1, n)
// intermediate and F's launch are gone (at the headline's (5, n) -> (5, 6,
// n), 3.9 MB written and read again a key switch).

#include "butterfly.cuh"

using namespace troy;

namespace {

// How a pass maps lines onto a row.
enum Mode { kRows = 0, kCols = 1, kChunks = 2 };

constexpr int kLogTile = 10;    // the words a block of the two-pass form
constexpr int kSplitLogN = 10;  // the least log2(n) that takes two passes

struct Pass {
    int mode;
    int log_line;   // words of a line: 2^log_line
    int log_lines;  // lines a block: 2^log_lines
    int finish;     // the last pass: reduce (forward) or n^-1 (inverse)
    unsigned blocks;
};

// A block's geometry: constants in a kernel compiled for it.
struct Geo {
    int mode, log_line, log_lines, threads;
};

// The block's row, first line and limb in the strided and contiguous
// passes (one row a block), from blockIdx once.
struct Block {
    int64_t row_base;
    int first;
    int limb;
};

// Where line l of this block lies: its first word, the stride between its
// words, its twiddle offset o (round r, block b reads root_powers[o 2^r +
// b]) and its row's limb (< 0: past the last row).
struct Line {
    int64_t base;
    int stride;
    int o;
    int limb;
};

__device__ __forceinline__ Block block_of(const Geo &g, int log_n, int k) {
    Block b = {0, 0, 0};
    if (g.mode != kRows) {
        const int log_per_row = log_n - g.log_line - g.log_lines;
        const int row = blockIdx.x >> log_per_row;
        b.row_base = static_cast<int64_t>(row) << log_n;
        b.first = (blockIdx.x & ((1 << log_per_row) - 1)) << g.log_lines;
        b.limb = row % k;
    }
    return b;
}

__device__ __forceinline__ Line line_of(const Geo &g, const Block &b, int l,
                                        int log_n, int rows, int k) {
    Line ln;
    if (g.mode == kRows) {
        const int row = (blockIdx.x << g.log_lines) + l;
        ln.base = static_cast<int64_t>(row) << log_n;
        ln.stride = 1;
        ln.o = 1;
        ln.limb = row < rows ? row % k : -1;
    } else if (g.mode == kCols) {
        ln.base = b.row_base + b.first + l;
        ln.stride = 1 << (log_n - g.log_line);
        ln.o = 1;
        ln.limb = b.limb;
    } else {
        ln.base = b.row_base + (static_cast<int64_t>(b.first + l)
                                << g.log_line);
        ln.stride = 1;
        ln.o = (1 << (log_n - g.log_line)) + b.first + l;
        ln.limb = b.limb;
    }
    return ln;
}

// The first word of the digits' source row of the output row that starts
// at word `base`: output row r holds source row r / k reduced into limb r % k.
__device__ __forceinline__ int64_t digit_row(int64_t base, int log_n, int k) {
    return static_cast<int64_t>(static_cast<int>(base >> log_n) / k) << log_n;
}

// Shared-memory position of word i of local line l: column-major for the
// strided pass (consecutive columns side by side), else line-major with
// the low 4 bits of i XORed by the next 4 (a bijection within each line).
__device__ __forceinline__ int smem_pos(const Geo &g, int l, int i) {
    if (g.mode == kCols) return (i << g.log_lines) + l;
    return (l << g.log_line) + (i ^ ((i >> 4) & 15));
}

// Rounds rho0 .. rho0 + R - 1 of every line of the tile (forward in that
// order, inverse in the reverse), R in registers per thread. Twiddles from
// tw_s: each line's own table of 2^log_line words and Shoup words, indexed
// as a table of one line-sized transform; one table for all columns.
template <int R, bool kInverse>
__device__ __forceinline__ void stage(uint64_t *v_s, const uint64_t *tw_s,
                                      const Geo &geo, const Block &blk_info,
                                      int log_n, int rows, int k, int rho0,
                                      const uint64_t *__restrict__ moduli) {
    constexpr int W = 1 << R;
    const int log_line = geo.log_line, log_lines = geo.log_lines;
    const int log_groups = log_line - R;              // groups a line
    const int log_h = log_line - rho0 - R;            // the stage's least gap
    const int items = 1 << (log_groups + log_lines);
    for (int it = threadIdx.x; it < items; it += geo.threads) {
        int l, g;
        if (geo.mode == kCols) {
            l = it & ((1 << log_lines) - 1);
            g = it >> log_lines;
        } else {
            g = it & ((1 << log_groups) - 1);
            l = it >> log_groups;
        }
        const Line ln = line_of(geo, blk_info, l, log_n, rows, k);
        if (ln.limb < 0) continue;
        const uint64_t q = moduli[ln.limb];
        const uint64_t *w_tab =
            tw_s + ((geo.mode == kCols ? 0 : 2 * l) << log_line);
        const uint64_t *wq_tab = w_tab + (1 << log_line);
        const int base = ((g >> log_h) << (log_line - rho0)) |
                         (g & ((1 << log_h) - 1));
        uint64_t v[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            v[j] = v_s[smem_pos(geo, l, base + (j << log_h))];
        }
        butterfly_rounds<R, kInverse>(v, w_tab, wq_tab, base, log_h, rho0,
                                      log_line, q);
#pragma unroll
        for (int j = 0; j < W; ++j) {
            v_s[smem_pos(geo, l, base + (j << log_h))] = v[j];
        }
    }
}

// Stage s of the pass's ceil(log_line / 3) (in reverse for the inverse):
// its rounds as even as they go, three at most.
template <bool kInverse>
__device__ __forceinline__ void run_stage(int s, uint64_t *v_s,
                                          const uint64_t *tw_s,
                                          const Geo &geo, const Block &blk,
                                          int log_n, int rows, int k,
                                          const uint64_t *moduli) {
    int R, rho0;
    stage_plan(s, geo.log_line, kInverse, R, rho0);
    if (R == 3) {
        stage<3, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli);
    } else if (R == 2) {
        stage<2, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli);
    } else {
        stage<1, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli);
    }
    __syncthreads();
}

// One pass. kLogLine > 0: compiled for a strided or contiguous pass of
// 2^kLogLine-word lines, 2^(kLogTile - kLogLine) a block, a thread per 8
// words; kLogLine = 0: the geometry of `pass`. The second pass runs in
// place (in == out): each block reads its whole tile before it writes.
template <bool kInverse, int kMode, int kLogLine, bool kDigits>
__global__ void ntt_pass_kernel(uint64_t *out, const uint64_t *in,
                                int rows, int log_n, int k,
                                const uint64_t *__restrict__ roots,
                                const uint64_t *__restrict__ roots_shoup,
                                const uint64_t *__restrict__ moduli,
                                const uint64_t *__restrict__ cr_hi,
                                const uint64_t *__restrict__ inv_degree,
                                const uint64_t *__restrict__ inv_degree_shoup,
                                Pass pass, int lazy) {
    extern __shared__ uint64_t v_s[];
    const Geo geo = kLogLine > 0
        ? Geo{kMode, kLogLine, kLogTile - kLogLine, 1 << (kLogTile - 3)}
        : Geo{pass.mode, pass.log_line, pass.log_lines,
              static_cast<int>(blockDim.x)};
    const int log_line = geo.log_line, log_lines = geo.log_lines;
    const int words = 1 << (log_line + log_lines);
    const int line_mask = (1 << log_line) - 1;
    const Block blk = block_of(geo, log_n, k);

    // each line's twiddles (entry e = 2^r + b of its round-r table: the
    // global root_powers[o 2^r + b]), copied beside the data
    uint64_t *tw_s = v_s + words;
    const int tables = geo.mode == kCols ? 1 : 1 << log_lines;
    for (int f = threadIdx.x; f < tables << log_line; f += geo.threads) {
        const int l = f >> log_line, e = f & line_mask;
        const Line ln = line_of(geo, blk, l, log_n, rows, k);
        if (e == 0 || ln.limb < 0) continue;
        const int r = 31 - __clz(e);
        const int64_t g = (static_cast<int64_t>(ln.limb) << log_n) +
                          (ln.o << r) + (e - (1 << r));
        tw_s[(2 * l << log_line) + e] = __ldg(roots + g);
        tw_s[((2 * l + 1) << log_line) + e] = __ldg(roots_shoup + g);
    }
    // the digits' source row of a strided or contiguous block (one row a
    // block), as an offset from its output row
    const int64_t shift = kDigits && geo.mode != kRows
        ? digit_row(blk.row_base, log_n, k) - blk.row_base : 0;
    for (int f = threadIdx.x; f < words; f += geo.threads) {
        const int l = geo.mode == kCols ? f & ((1 << log_lines) - 1)
                                        : f >> log_line;
        const int i = geo.mode == kCols ? f >> log_lines : f & line_mask;
        const Line ln = line_of(geo, blk, l, log_n, rows, k);
        if (ln.limb < 0) continue;
        const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
        if (kDigits) {
            const int64_t src = geo.mode == kRows
                ? digit_row(ln.base, log_n, k) + i : at + shift;
            v_s[smem_pos(geo, l, i)] = barrett_reduce_64(
                in[src], __ldg(moduli + ln.limb), __ldg(cr_hi + ln.limb));
        } else {
            v_s[smem_pos(geo, l, i)] = in[at];
        }
    }
    __syncthreads();

    if (kLogLine > 0) {
#pragma unroll
        for (int s = 0; s < (kLogLine + 2) / 3; ++s) {
            run_stage<kInverse>(s, v_s, tw_s, geo, blk, log_n, rows, k,
                                moduli);
        }
    } else {
        for (int s = 0; s < (log_line + 2) / 3; ++s) {
            run_stage<kInverse>(s, v_s, tw_s, geo, blk, log_n, rows, k,
                                moduli);
        }
    }

    for (int f = threadIdx.x; f < words; f += geo.threads) {
        const int l = geo.mode == kCols ? f & ((1 << log_lines) - 1)
                                        : f >> log_line;
        const int i = geo.mode == kCols ? f >> log_lines : f & line_mask;
        const Line ln = line_of(geo, blk, l, log_n, rows, k);
        if (ln.limb < 0) continue;
        uint64_t x = v_s[smem_pos(geo, l, i)];
        if (pass.finish) {
            const uint64_t q = moduli[ln.limb];
            if (!kInverse) {
                x = lazy ? x : reduce_4q(x, q);
            } else {
                x = mul_mod_shoup_lazy(x, inv_degree[ln.limb],
                                       inv_degree_shoup[ln.limb], q);
                x = lazy ? x : reduce_2q(x, q);
            }
        }
        out[ln.base + static_cast<int64_t>(i) * ln.stride] = x;
    }
}

typedef void (*PassKernel)(uint64_t *, const uint64_t *, int, int, int,
                           const uint64_t *, const uint64_t *,
                           const uint64_t *, const uint64_t *,
                           const uint64_t *, const uint64_t *, Pass, int);

// The kernel of a pass: compiled for its geometry where one is, else the
// run-time one.
template <bool kInverse>
PassKernel kernel_for(const Pass &p) {
    if (p.mode != kRows && p.log_line + p.log_lines == kLogTile) {
        const bool cols = p.mode == kCols;
        switch (p.log_line) {
        case 5: return cols ? ntt_pass_kernel<kInverse, kCols, 5, false>
                            : ntt_pass_kernel<kInverse, kChunks, 5, false>;
        case 6: return cols ? ntt_pass_kernel<kInverse, kCols, 6, false>
                            : ntt_pass_kernel<kInverse, kChunks, 6, false>;
        case 7: return cols ? ntt_pass_kernel<kInverse, kCols, 7, false>
                            : ntt_pass_kernel<kInverse, kChunks, 7, false>;
        case 8: return cols ? ntt_pass_kernel<kInverse, kCols, 8, false>
                            : ntt_pass_kernel<kInverse, kChunks, 8, false>;
        default: break;
        }
    }
    return ntt_pass_kernel<kInverse, kRows, 0, false>;
}

// The forward transform's first pass with the digits' load: the strided
// pass (or the one pass over whole rows below 2^kSplitLogN), compiled for
// the same geometries as kernel_for's.
PassKernel digits_kernel_for(const Pass &p) {
    if (p.mode == kCols && p.log_line + p.log_lines == kLogTile) {
        switch (p.log_line) {
        case 5: return ntt_pass_kernel<false, kCols, 5, true>;
        case 6: return ntt_pass_kernel<false, kCols, 6, true>;
        case 7: return ntt_pass_kernel<false, kCols, 7, true>;
        case 8: return ntt_pass_kernel<false, kCols, 8, true>;
        default: break;
        }
    }
    return ntt_pass_kernel<false, kRows, 0, true>;
}

// Shared memory of a pass: its words and twiddles (one table of the
// columns; one a line otherwise).
size_t smem_bytes(const Pass &p) {
    const int tables = p.mode == kCols ? 1 : 1 << p.log_lines;
    return sizeof(uint64_t) * ((size_t(1) << (p.log_line + p.log_lines)) +
                               (size_t(2 * tables) << p.log_line));
}

// The passes of one transform: one over whole rows below 2^kSplitLogN,
// 2^(kLogTile - log_n) rows a block, else the strided and the contiguous
// pass (in that order forward, the reverse inverse), each block holding
// 2^kLogTile words where the lines allow it.
int plan(long long rows, int log_n, int inverse, Pass *passes) {
    if (log_n < kSplitLogN) {
        const int lines = kLogTile - log_n;
        passes[0] = {kRows, log_n, lines, 1,
                     static_cast<unsigned>((rows + (1LL << lines) - 1) >>
                                           lines)};
        return 1;
    }
    const int a = log_n / 2, b = log_n - a;
    auto clamp = [](int x, int hi) { return x < 0 ? 0 : x > hi ? hi : x; };
    const int cols = clamp(kLogTile - a, b);
    const int chunks = clamp(kLogTile - b, a);
    const Pass strided = {kCols, a, cols, 0,
                          static_cast<unsigned>(rows << (b - cols))};
    const Pass contiguous = {kChunks, b, chunks, 0,
                             static_cast<unsigned>(rows << (a - chunks))};
    passes[0] = inverse ? contiguous : strided;
    passes[1] = inverse ? strided : contiguous;
    passes[1].finish = 1;
    return 2;
}

// A thread per eight words (one three-round group), at least a warp and
// at most 512: the compiled geometries' 128.
int threads_for(const Pass &p) {
    const int t = (1 << (p.log_line + p.log_lines)) / 8;
    return t < 32 ? 32 : t > 512 ? 512 : t;
}

// One transform's launches; with cr_hi (the digits' entry) the first
// forward pass reads source row r / k of `in` for output row r and reduces
// each word into the row's prime q[r % k] as it loads it.
int run(void *out, const void *in, long long rows, int log_n, int k,
        const void *roots, const void *roots_shoup, const void *moduli,
        const void *cr_hi, const void *inv_degree,
        const void *inv_degree_shoup, int inverse, int lazy, void *stream) {
    if (rows < 1 || rows > (1LL << 30) || k < 1 || log_n < 1 || log_n > 24) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Pass passes[2];
    const int count = plan(rows, log_n, inverse, passes);
    const void *src = in;
    for (int p = 0; p < count; ++p) {
        const PassKernel kernel = cr_hi != nullptr && p == 0
            ? digits_kernel_for(passes[p])
            : inverse ? kernel_for<true>(passes[p])
                      : kernel_for<false>(passes[p]);
        // above the default 48 KiB (n >= 2^23, the run-time kernel): the
        // limit is raised on the current device at each such call
        const size_t smem = smem_bytes(passes[p]);
        if (smem > (48 << 10)) {
            const cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        kernel<<<passes[p].blocks, threads_for(passes[p]), smem,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<uint64_t *>(out), static_cast<const uint64_t *>(src),
            static_cast<int>(rows), log_n, k,
            static_cast<const uint64_t *>(roots),
            static_cast<const uint64_t *>(roots_shoup),
            static_cast<const uint64_t *>(moduli),
            static_cast<const uint64_t *>(cr_hi),
            static_cast<const uint64_t *>(inv_degree),
            static_cast<const uint64_t *>(inv_degree_shoup), passes[p], lazy);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        src = out;
    }
    return 0;
}

}  // namespace

// out, in: (rows, 2^log_n); tables: (k, n) roots (inverse roots for
// inverse=1) and Shoup words; moduli, inv_degree(_shoup): (k,).
extern "C" int troy_ntt(void *out, const void *in, long long rows, int log_n,
                        int k, const void *roots, const void *roots_shoup,
                        const void *moduli, const void *inv_degree,
                        const void *inv_degree_shoup, int inverse, int lazy,
                        void *stream) {
    return run(out, in, rows, log_n, k, roots, roots_shoup, moduli, nullptr,
               inv_degree, inv_degree_shoup, inverse, lazy, stream);
}

// The key switch's digits and their forward transform in one call (F's
// digits folded into A's first pass): in (rows / k, 2^log_n) any u64
// words, out (rows, 2^log_n), row r the forward NTT of source row r / k
// reduced mod q[r % k] (Barrett-64 with the high ratio words cr_hi: (k,)),
// fully reduced.
extern "C" int troy_ntt_forward_digits(void *out, const void *in,
                                       long long rows, int log_n, int k,
                                       const void *roots,
                                       const void *roots_shoup,
                                       const void *moduli, const void *cr_hi,
                                       void *stream) {
    if (cr_hi == nullptr || k < 1 || rows % k != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return run(out, in, rows, log_n, k, roots, roots_shoup, moduli, cr_hi,
               nullptr, nullptr, 0, 0, stream);
}

// The blocks of each launch of one troy_ntt call (0 for a pass it does not
// make): what the profiler's kernels per call are measured against.
extern "C" int troy_ntt_blocks(long long rows, int log_n, int inverse,
                               long long *blocks) {
    Pass passes[2];
    const int count = plan(rows, log_n, inverse, passes);
    for (int p = 0; p < 2; ++p) blocks[p] = p < count ? passes[p].blocks : 0;
    return count;
}
