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
//
// The troy_ntt_forward_{rescale,keyswitch,bgv_mod_switch,bgv_keyswitch}
// entries fold kernel K' (and K'-BGV) into the forward transform of the
// divide by the last prime (csrc/divide_round_ntt.cu; troy_tpu/ops/rns.py
// :213 divide_and_round_q_last_ntt, :246 mod_t_and_divide_q_last_ntt, the
// NTT-form divide of troy_tpu/evaluator.py:320-351): given last (comps, n),
// row k's inverse transform, output row r = comp k + j loads word i of
// last row r / k (the digits' map) and forms K''s temp for limb j as it
// loads it (K'-BGV's: neg_k first; which one is a run-time flag, uniform
// over the grid); the last pass (the contiguous one, or the one pass)
// leaves the butterflies' output lazy and stores (x[comp, j, i] + 4 q_j -
// v) p^-1 mod q_j plus the accumulator word, reading x and acc at the
// stored word's index. The per-word arithmetic is divide_round.cuh's,
// K''s own. A divide on A's route is then A's inverse of row k and this
// forward: K''s two launches, their wrapper calls and the (comps, k, n)
// temps written and read again are gone. A strided or contiguous block
// holds one row, so it reads its limb's constants once into registers.
// What bounds these passes at n = 16384 is latency (about one block an
// SM), so the first pass issues all its loads of last before it forms
// any temp, and the last loads its x and accumulator words before the
// butterflies.
//
// troy_ntt_inverse_keyswitch (AFi) folds kernel F's divide by the special
// prime (csrc/keyswitch.cu troy_keyswitch_divide_round; troy_tpu/
// evaluator.py:290 _switch_key_contract, coefficient domain: BFV) into
// A's inverse: (comps, k + 1, n) NTT-form products -> (comps, k, n)
// coefficient form, plus the accumulator. Output word i of row j needs
// word i of row k (the special prime's) finished, and another block of
// A's last pass holds it; blocks may not wait on each other (nothing
// keeps them resident together), so a block of the fused last pass holds
// one column set of all k + 1 rows of a component (plan_inverse: fewer
// columns than A's strided pass, so that the grid still fills the card;
// with very many limbs, groups of output rows, each with its own copy of
// row k), each tile transformed by its own threads, held line-major
// (kColLines) so that narrow column sets meet no bank conflicts. Every
// word the block reads (tiles, twiddles, accumulator, constants) is
// copied into shared memory by cp.async, all in flight together, with no
// register holding it. The finish applies n^-1 and reduce_2q as A's last
// pass does, turns the special tile into F's offset last + floor(p/2) mod
// p once for all rows, then runs F's word arithmetic (divide_round.cuh,
// shared with F's kernel) and adds the accumulator word. A's first
// inverse pass is unchanged. The key switch then takes two launches where
// A's inverse and F took three, and A's last pass no longer writes the
// (comps, k + 1, n) coefficient rows for F to read back (at a batched
// fold of 128, (256, 6, n): 201 MB each way).
// What bounds it: at (2, 6, n) latency, as for A; at the folds F's
// arithmetic (about 70 instructions a word, as much as a pass of
// butterflies) runs inside a pass that already uses the SMs poorly (A's
// strided pass moves its bytes at about half the memory rate), so the
// fused pass costs about A's last pass plus F's kernel there. A block
// per output row with its own copy of row k did twice A's work on the
// busiest SM at (2, 6, n) and 1.67 times its butterflies at the folds;
// wider column sets in larger blocks, registers capped by launch bounds,
// and loads gathered in registers were each slower on the H100 (PERF.md).
//
// troy_ntt_inverse_decrypt_bgv (AXi) and troy_ntt_inverse_decrypt_bfv
// (ACi) fold the decrypt's last step into A's inverse: kernel X's exact
// conversion of the phase to t (exact_convert.cu; troy_tpu/ops/rns.py:189
// decrypt_mod_t), or kernel C's conversion to {t, gamma} and kernel E's
// gamma rounding (base_convert.cu, behz.cu; :169 decrypt_scale_and_round),
// (comps, k, n) NTT-form phases -> (comps, n) words mod t. The finish of a
// coefficient needs its k residues, so AFi's last pass serves again,
// without the special tile: a block holds one column set of all k rows of
// a component (plan_inverse: the same rule with caps of its own, one-
// column sets allowed, so that a single decrypt fills the card),
// transforms each tile with its own threads, then each thread finishes
// whole coefficients across the k tiles, two at a time, with decrypt.cuh's
// arithmetic (shared with the standalone kernels; n^-1 folded into its
// first Shoup product) and stores one word a coefficient. The decrypt
// then ends in A's two inverse launches: X's or C's and E's launches are
// gone, and A's last pass no longer writes the (comps, k, n) coefficient
// rows for them to read back. A level whose rows one block cannot hold
// takes A's inverse and the standalone kernels (the decryptor routes by
// shape before any launch, ops/rns.py decrypt_fused, from the plan that
// troy_ntt_inverse_decrypt_plan reports).
// What bounds it: at a single decrypt latency, as for A; with larger
// batches X's or C's 64-bit products, which cost inside the pass about
// what they cost in X's or C's own kernel (PERF.md).
//
// troy_ntt_forward_lift (AGp) folds kernel G''s plain lift (plain_embed.cu
// troy_plain_lift; troy_tpu/ops/poly.py:71 plain_lift, with the BGV
// add_plain's m * cf mod t, troy_tpu/evaluator.py:708 _plain_to_ntt and
// :767-768, and troy_tpu/encryptor.py:44-48) into the forward transform,
// as the digits' entry folds F's digits: output row r of (rows, n) is the
// NTT of source row r / k lifted into q[r % k] as the first pass loads
// it (plain_lift.cuh's arithmetic, shared with G'). The (..., k, n) lifted
// rows, written by G' only for A's first pass to read back, and G''s
// launch are gone. The k output rows of one source row are adjacent in
// the grid (a strided block holds one row, the blocks of a row are
// consecutive, output rows r and r + 1 of one source row follow each
// other), so the source is read from DRAM about once and its k - 1 other
// reads hit L2: at the app's conv2d, (3328, n) mod t -> (3328, 2, n),
// 436 MB read where A's first pass read the 872 MB G' wrote.
//
// troy_ntt_inverse_pair_convolve (AP2i) folds kernel P2 (tiles.cu
// troy_tile_pair_convolve; troy_tpu/app/linear.py:133
// _matmul_cipher_pairs_core, BFV) into A's inverse: a (X, s1, R, n) and
// w (Y, s2, R, n), NTT-form words below 4q, -> the inverse transform of
// every pair's convolution, (X, Y, s1 + s2 - 1, R, n), fully reduced. A
// block of the first inverse pass (A's contiguous lines, half A's tile;
// below 2^kSplitLogN the one pass, a whole row) holds the same chunks of
// all s1 + s2 - 1 output rows of one pair and row r: it reads each of the
// pair's s1 + s2 words at a place once, forms the products as it loads
// them (up to four terms summed in 128 bits, one Barrett-128: P2's
// arithmetic, so the words are P2's), then each tile's threads run A's
// butterflies on it. A's last pass is A's own, in place. P2's launch and
// its (X, Y, s1 + s2 - 1, R, n) output, written only for A's first pass
// to read back, are gone: at the app's X = 1, Y = 16, 6 rows, 26.8 MB
// read where P2 moved 64.5 MB and A's first pass read 37.7 MB. What bounds
// it there: latency, as for A's passes (which move their bytes at about
// half the memory rate), so the block keeps its registers to A's own
// (launch bounds) and its tiles small, for four blocks an SM: with one
// block an SM (114 registers a thread, A's 1024-word tiles) the fused
// call was slower than P2 and A's inverse apart on the H100 (PERF.md).
//
// troy_ntt_forward_round (AO2p) folds kernel O2's exact rounding
// (embedding.cu troy_ckks_round; troy_tpu/ops/embedding.py:425
// round_to_rns_device, in :589 encode_pipeline and :601
// encode_polynomial_pipeline) into the forward transform: output row r of
// (rows, n) is the NTT of rint(Re(u untwist) scale) (the slot encode) or
// rint(c scale) (the polynomial encode's float64 words, read as they are:
// no complex copy, no unit untwist) of source row r / k, rounded into
// q[r % k] as the first pass loads it (ckks_round.cuh's arithmetic,
// shared with O2). The (k, n) rounded rows, written by O2 only for A's
// first pass to read back, and O2's launch are gone. As for AGp, the k
// output rows of the source are adjacent in the grid, so the source is
// read from DRAM about once: a thread loads all its source words (16
// bytes each and 16 of the untwist, or 8) before it rounds any; a strided
// block reads its limb's q, Barrett word and 2^e rows once, and a word
// reads 2^e mod q only where e > 0 (|v| at or above 2^53). The rounding
// is a chain of dependent FP64 and 64-bit integer steps a word, which
// with A's 8 words a thread cost the pass more than its loads; the pass
// runs twice A's threads (kRoundSpread), 4 words a thread, and rounds
// every slot with no branch between the words, so that more of the
// chains run at once (PERF.md).
//
// troy_ntt_forward_round_stats (AO4p) is AO2p with kernel O4's statistic
// (embedding.cu troy_ckks_round_stats; troy_tpu/ops/embedding.py:611
// encode_stats_pipeline, the encode's exact magnitude check of
// troy_tpu/ckks.py:134-149 and :187): max |rint(Re(u untwist) scale)|,
// the largest rounded coefficient, as an f64 bit pattern. A slot rounds
// to the same value in every limb, so only the first pass's blocks of
// row 0 (limb 0 of the one source row) reduce it: each writes its block
// maximum into a small buffer, and the last pass's first block, which
// the stream orders after them, reduces the buffer into the statistic.
// Below 2^kSplitLogN the one pass's first block holds all of row 0 and
// writes it. O4's memset, its launch and A's forward after it become
// AO2p's two launches; a maximum is exact in any order, so the word is
// O4's bit for bit. AO2p's own instances are left as they were: the
// statistic is a load mode of its own (kLoadRoundStats, and
// kLoadPlainReduce for the last pass).

#include "butterfly.cuh"
#include "ckks_round.cuh"
#include "decrypt.cuh"
#include "divide_round.cuh"
#include "plain_lift.cuh"

using namespace troy;

namespace {

// How a pass maps lines onto a row. kColLines: the strided pass's
// columns (AFi's narrow column sets), held line-major in shared memory as
// the contiguous pass holds its chunks, so that a stage's words do not
// meet in one bank however few the columns.
enum Mode { kRows = 0, kCols = 1, kChunks = 2, kColLines = 3 };

__host__ __device__ constexpr bool columns(int mode) {
    return mode == kCols || mode == kColLines;
}

// What the first forward pass computes from each word it loads: the word
// itself, the key switch's digit (Barrett-64 into the row's prime), K''s
// temp of the divide's last row, or the plain lift of a word mod t into
// the row's prime (G''s), or the CKKS encode's exact rounding of an f64
// word into the row's prime (O2's), also reducing the largest rounded
// |value| of the rows of limb 0 into a block maximum (AO4p's first pass,
// O4's statistic). kLoadPlainReduce is AO4p's last pass: A's plain load,
// and its first block reduces the first pass's block maxima into the
// statistic.
enum Load { kLoadPlain = 0, kLoadDigits = 1, kLoadDivide = 2,
            kLoadLift = 3, kLoadRound = 4, kLoadRoundStats = 5,
            kLoadPlainReduce = 6 };

__host__ __device__ constexpr bool rounds(int load) {
    return load == kLoadRound || load == kLoadRoundStats;
}

constexpr int kLogTile = 10;    // the words a block of the two-pass form
constexpr int kSplitLogN = 10;  // the least log2(n) that takes two passes
// the most words of a tile a thread loads or stores (threads_for: 8 or
// fewer): the divide's passes hold that many words a thread in registers
constexpr int kWordsPerThread = 8;
// AO2p's first pass takes this many times A's threads (4 words a thread
// in a compiled geometry): its rounding is a long chain of FP64 and
// 64-bit integer steps a word, which more warps hide better (PERF.md)
constexpr int kRoundSpread = 2;

struct Pass {
    int mode;
    int log_line;   // words of a line: 2^log_line
    int log_lines;  // lines a block: 2^log_lines
    int finish;     // the last pass: reduce (forward) or n^-1 (inverse)
    unsigned blocks;
};

// The divide's operands (the fused forward of K'; null otherwise): x
// (comps, k + 1, n), the accumulator (acc_groups, acc_comps, k, n) or null,
// the constants in DivideLayout, K'-BGV's temps if bgv.
struct Divide {
    const uint64_t *x;
    const uint64_t *acc;
    const uint64_t *consts;
    long long group, acc_groups;
    int acc_comps;
    int bgv;
};

// The plain lift's operands (AGp; null consts otherwise): G''s constants
// in LiftLayout, the threshold and the correction factor with its Shoup
// word (cf = 1: none).
struct Lift {
    const uint64_t *consts;
    uint64_t threshold, cf, cf_shoup;
};

// One limb's constants of the lift: its modulus, high Barrett word and
// (Q - t) mod q.
struct LiftRow {
    uint64_t q, cr_hi, inc;
};

__device__ __forceinline__ LiftRow lift_row(const Lift &lf,
                                            const LiftLayout &L, int limb) {
    return {__ldg(lf.consts + L.q() + limb),
            __ldg(lf.consts + L.cr_hi() + limb),
            __ldg(lf.consts + L.inc() + limb)};
}

// The rounding's operands (AO2p; null consts otherwise): the untwist (n,)
// complex or null (the source is then real: (rows / k, n) f64, else
// complex), O2's constants in RoundLayout, its exponent count and the
// scale; AO4p's statistic (null otherwise) as an f64 bit pattern, and the
// first pass's block maxima (maxima_count of them) that its last pass
// reduces into it.
struct Round {
    const double2 *untwist;
    const uint64_t *consts;
    int E;
    double scale;
    unsigned long long *stat, *maxima;
    int maxima_count;
};

// The largest v of a warp's lanes, in every lane.
__device__ __forceinline__ double warp_max(double v) {
    for (int off = 16; off > 0; off >>= 1) {
        v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    return v;
}

// AO4p's first pass: each warp's largest rounded |value|, in shared memory
// that only the instances calling this hold.
__device__ __forceinline__ double *warp_maxima() {
    __shared__ double maxima[32];
    return maxima;
}

__device__ __forceinline__ unsigned long long f64_bits(double v) {
    return static_cast<unsigned long long>(__double_as_longlong(v));
}

// One limb's constants of the rounding: its modulus, high Barrett word and
// rows of 2^e mod q and their Shoup words.
struct RoundRow {
    uint64_t q, ratio;
    const uint64_t *pow2, *pow2_shoup;
};

__device__ __forceinline__ RoundRow round_row(const Round &rd,
                                              const RoundLayout &L,
                                              int limb) {
    const int64_t row = static_cast<int64_t>(limb) * L.E;
    return {__ldg(rd.consts + L.q() + limb),
            __ldg(rd.consts + L.ratio() + limb),
            rd.consts + L.pow2() + row, rd.consts + L.pow2_shoup() + row};
}

// One limb's constants of the temps (K''s or K'-BGV's fields).
struct TempConsts {
    uint64_t q, ratio, half_mod, p, half, pm, pm_shoup, tt, tt_hi, inv_t,
        inv_t_shoup;
};

// What the finish of one output row reads: its x row and accumulator row
// as offsets from the output row's words, and its limb's constants.
struct FinishRow {
    int64_t x_off, acc_off;
    bool acc;
    uint64_t q, inv, inv_shoup;
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
    } else if (columns(g.mode)) {
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

__device__ __forceinline__ TempConsts temp_consts(const Divide &dv, int k,
                                                  int limb) {
    const DivideLayout L{k};
    const uint64_t *c = dv.consts;
    TempConsts t = {};
    t.q = __ldg(c + L.q() + limb);
    t.ratio = __ldg(c + L.ratio() + limb);
    if (dv.bgv) {
        t.pm = __ldg(c + L.pm() + limb);
        t.pm_shoup = __ldg(c + L.pm_shoup() + limb);
        t.tt = __ldg(c + L.tt());
        t.tt_hi = __ldg(c + L.tt_hi());
        t.inv_t = __ldg(c + L.inv_t());
        t.inv_t_shoup = __ldg(c + L.inv_t_shoup());
    } else {
        t.half_mod = __ldg(c + L.half_mod() + limb);
        t.p = __ldg(c + L.p());
        t.half = __ldg(c + L.half());
    }
    return t;
}

__device__ __forceinline__ uint64_t temp_word(const TempConsts &t, int bgv,
                                              uint64_t last) {
    if (bgv) {
        return bgv_divide_temp(
            last, bgv_neg_k(last, t.tt, t.tt_hi, t.inv_t, t.inv_t_shoup),
            t.q, t.ratio, t.pm, t.pm_shoup);
    }
    return divide_temp(last, t.p, t.half, t.q, t.ratio, t.half_mod);
}

// Output row `row` = comp k + j: x row row + comp, accumulator row
// accumulator_row(comp) (ops/keyswitch.py's layout), limb j.
__device__ __forceinline__ FinishRow finish_row(const Divide &dv,
                                                int64_t row, int k,
                                                int log_n) {
    const DivideLayout L{k};
    // 32-bit quotients: rows < 2^30 (run() refuses more)
    const int comp = static_cast<int>(row) / k;
    const int j = static_cast<int>(row) - comp * k;
    const int64_t arow = accumulator_row(
        comp, static_cast<int>(dv.group), dv.acc_comps,
        static_cast<int>(dv.acc_groups));
    FinishRow f;
    f.x_off = static_cast<int64_t>(comp) << log_n;
    f.acc = arow >= 0;
    f.acc_off = (arow - comp) * k * (int64_t(1) << log_n);  // may be < 0
    f.q = __ldg(dv.consts + L.q() + j);
    f.inv = __ldg(dv.consts + L.inv() + j);
    f.inv_shoup = __ldg(dv.consts + L.inv_shoup() + j);
    return f;
}

// Word f of a block's tile: its local line l and its index i in the line
// (the strided pass walks consecutive columns first, so loads coalesce).
__device__ __forceinline__ void tile_word(const Geo &g, int f, int &l,
                                          int &i) {
    if (columns(g.mode)) {
        l = f & ((1 << g.log_lines) - 1);
        i = f >> g.log_lines;
    } else {
        l = f >> g.log_line;
        i = f & ((1 << g.log_line) - 1);
    }
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
                                      const uint64_t *__restrict__ moduli,
                                      int tid) {
    constexpr int W = 1 << R;
    const int log_line = geo.log_line, log_lines = geo.log_lines;
    const int log_groups = log_line - R;              // groups a line
    const int log_h = log_line - rho0 - R;            // the stage's least gap
    const int items = 1 << (log_groups + log_lines);
    for (int it = tid; it < items; it += geo.threads) {
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
            tw_s + ((columns(geo.mode) ? 0 : 2 * l) << log_line);
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
// its rounds as even as they go, three at most; tid: the thread's index
// among the geo.threads that share the tile.
template <bool kInverse>
__device__ __forceinline__ void run_stage(int s, uint64_t *v_s,
                                          const uint64_t *tw_s,
                                          const Geo &geo, const Block &blk,
                                          int log_n, int rows, int k,
                                          const uint64_t *moduli,
                                          int tid = threadIdx.x) {
    int R, rho0;
    stage_plan(s, geo.log_line, kInverse, R, rho0);
    if (R == 3) {
        stage<3, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli, tid);
    } else if (R == 2) {
        stage<2, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli, tid);
    } else {
        stage<1, kInverse>(v_s, tw_s, geo, blk, log_n, rows, k, rho0,
                           moduli, tid);
    }
    __syncthreads();
}

// One pass. kLogLine > 0: compiled for a strided or contiguous pass of
// 2^kLogLine-word lines, 2^(kLogTile - kLogLine) a block, a thread per 8
// words; kLogLine = 0: the geometry of `pass`. The second pass runs in
// place (in == out): each block reads its whole tile before it writes.
// kLoad: what the (first forward) pass loads; kFinish: the (last forward)
// pass stores K''s finish of its lazy words.
template <bool kInverse, int kMode, int kLogLine, int kLoad, bool kFinish>
__global__ void ntt_pass_kernel(uint64_t *out, const uint64_t *in,
                                int rows, int log_n, int k,
                                const uint64_t *__restrict__ roots,
                                const uint64_t *__restrict__ roots_shoup,
                                const uint64_t *__restrict__ moduli,
                                const uint64_t *__restrict__ cr_hi,
                                const uint64_t *__restrict__ inv_degree,
                                const uint64_t *__restrict__ inv_degree_shoup,
                                Pass pass, int lazy, Divide dv, Lift lf,
                                Round rd) {
    extern __shared__ uint64_t v_s[];
    const Geo geo = kLogLine > 0
        ? Geo{kMode, kLogLine, kLogTile - kLogLine,
              (rounds(kLoad) ? kRoundSpread : 1) << (kLogTile - 3)}
        : Geo{pass.mode, pass.log_line, pass.log_lines,
              static_cast<int>(blockDim.x)};
    const int log_line = geo.log_line, log_lines = geo.log_lines;
    const int words = 1 << (log_line + log_lines);
    const int line_mask = (1 << log_line) - 1;
    const Block blk = block_of(geo, log_n, k);

    // AO4p's last pass: the first block's first warp loads the first
    // pass's block maxima now and reduces them into the statistic at the
    // end (a maximum of non-negative f64 values, exact in any order); no
    // other thread waits for it
    double stat_v = 0.0;
    if constexpr (kLoad == kLoadPlainReduce) {
        if (blockIdx.x == 0 && threadIdx.x < 32) {
            for (int b = threadIdx.x; b < rd.maxima_count; b += 32) {
                stat_v = fmax(stat_v, __longlong_as_double(
                                          static_cast<long long>(
                                              rd.maxima[b])));
            }
        }
    }
    // AO4p's first pass: the blocks of limb 0 (the one pass over whole
    // rows: block 0, which holds row 0) reduce the statistic's maxima
    const bool stat_block = kLoad == kLoadRoundStats &&
        (geo.mode == kRows ? blockIdx.x == 0 : blk.limb == 0);

    // the finish's x and accumulator words of this thread's words, loaded
    // first so that their latency passes under the transform's
    FinishRow fr = {};
    uint64_t xw[kWordsPerThread] = {}, aw[kWordsPerThread] = {};
    if constexpr (kFinish) {
        if (geo.mode != kRows) {
            fr = finish_row(dv, blk.row_base >> log_n, k, log_n);
        }
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const int f = threadIdx.x + w * geo.threads;
            if (f >= words) break;
            int l, i;
            tile_word(geo, f, l, i);
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            const FinishRow r = geo.mode == kRows
                ? finish_row(dv, ln.base >> log_n, k, log_n) : fr;
            xw[w] = __ldg(dv.x + at + r.x_off);
            if (r.acc) aw[w] = __ldg(dv.acc + at + r.acc_off);
        }
    }

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
    // the source row of the digits' or the temps' loads of a strided or
    // contiguous block (one row a block), as an offset from its output row
    const int64_t shift =
        kLoad != kLoadPlain && kLoad != kLoadPlainReduce && geo.mode != kRows
        ? digit_row(blk.row_base, log_n, k) - blk.row_base : 0;
    if constexpr (kLoad == kLoadDivide) {
        // this thread's words of last first, all in flight together, then
        // their temps (loaded and reduced in turn, each load waited for:
        // with 64-bit quotients in the finish, the fused forward took
        // about 1.4 us longer at n = 16384 on the H100, PERF.md)
        const TempConsts tc = geo.mode != kRows
            ? temp_consts(dv, k, blk.limb) : TempConsts{};
        uint64_t lw[kWordsPerThread];
        int pos[kWordsPerThread], limb[kWordsPerThread];
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) pos[w] = -1;
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const int f = threadIdx.x + w * geo.threads;
            if (f >= words) break;
            int l, i;
            tile_word(geo, f, l, i);
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            lw[w] = __ldg(in + (geo.mode == kRows
                                    ? digit_row(ln.base, log_n, k) + i
                                    : at + shift));
            pos[w] = smem_pos(geo, l, i);
            limb[w] = ln.limb;
        }
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            if (pos[w] < 0) continue;
            const TempConsts t = geo.mode == kRows
                ? temp_consts(dv, k, limb[w]) : tc;
            v_s[pos[w]] = temp_word(t, dv.bgv, lw[w]);
        }
    } else if constexpr (kLoad == kLoadLift) {
        // this thread's source words first, all in flight together, then
        // their lifts; a strided block's row constants read once
        const LiftLayout L{k};
        const uint64_t t = __ldg(lf.consts + L.t());
        const LiftRow lr = geo.mode != kRows ? lift_row(lf, L, blk.limb)
                                             : LiftRow{};
        uint64_t lw[kWordsPerThread];
        int pos[kWordsPerThread], limb[kWordsPerThread];
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) pos[w] = -1;
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const int f = threadIdx.x + w * geo.threads;
            if (f >= words) break;
            int l, i;
            tile_word(geo, f, l, i);
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            lw[w] = __ldg(in + (geo.mode == kRows
                                    ? digit_row(ln.base, log_n, k) + i
                                    : at + shift));
            pos[w] = smem_pos(geo, l, i);
            limb[w] = ln.limb;
        }
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            if (pos[w] < 0) continue;
            const LiftRow r = geo.mode == kRows ? lift_row(lf, L, limb[w])
                                                : lr;
            const uint64_t mv = lift_scale(lw[w], t, lf.cf, lf.cf_shoup);
            v_s[pos[w]] = lift_limb(mv, mv >= lf.threshold, t, r.q, r.cr_hi,
                                    r.inc);
        }
    } else if constexpr (rounds(kLoad)) {
        // this thread's source words (and their untwist words; without an
        // untwist, (1, 0): Re(c 1) = c exactly) first, all in flight
        // together, then their roundings, every slot rounded (an empty
        // one a zero) and stored where it holds a word, with no branch
        // between the words; a strided block's limb constants read once;
        // AO4p's warps reduce their largest |rounded value|
        const RoundLayout L{k, rd.E};
        const RoundRow rr = geo.mode != kRows ? round_row(rd, L, blk.limb)
                                              : RoundRow{};
        const int64_t in_row = (int64_t(1) << log_n) - 1;
        double2 uw[kWordsPerThread], tw[kWordsPerThread];
        int pos[kWordsPerThread], limb[kWordsPerThread];
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            uw[w] = make_double2(0.0, 0.0);
            tw[w] = make_double2(1.0, 0.0);
            pos[w] = -1;
            limb[w] = 0;
        }
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const int f = threadIdx.x + w * geo.threads;
            if (f >= words) break;
            int l, i;
            tile_word(geo, f, l, i);
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            const int64_t src = geo.mode == kRows
                ? digit_row(ln.base, log_n, k) + i : at + shift;
            if (rd.untwist != nullptr) {
                uw[w] = __ldg(reinterpret_cast<const double2 *>(in) + src);
                tw[w] = __ldg(rd.untwist + (src & in_row));
            } else {
                uw[w].x = __ldg(reinterpret_cast<const double *>(in) + src);
            }
            pos[w] = smem_pos(geo, l, i);
            limb[w] = ln.limb;
        }
        double largest = 0.0;
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const RoundRow r = geo.mode == kRows ? round_row(rd, L, limb[w])
                                                 : rr;
            double a;
            const uint64_t v = round_limb(
                round_split(untwisted_re(uw[w], tw[w]), rd.scale, rd.E, a),
                r.q, r.ratio, r.pow2, r.pow2_shoup);
            if (pos[w] >= 0) v_s[pos[w]] = v;
            if constexpr (kLoad == kLoadRoundStats) {
                if (limb[w] == 0) largest = fmax(largest, a);
            }
        }
        if constexpr (kLoad == kLoadRoundStats) {
            largest = warp_max(largest);
            if ((threadIdx.x & 31) == 0) {
                warp_maxima()[threadIdx.x >> 5] = largest;
            }
        }
    } else {
        for (int f = threadIdx.x; f < words; f += geo.threads) {
            const int l = geo.mode == kCols ? f & ((1 << log_lines) - 1)
                                            : f >> log_line;
            const int i = geo.mode == kCols ? f >> log_lines : f & line_mask;
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            if (kLoad == kLoadDigits) {
                const int64_t src = geo.mode == kRows
                    ? digit_row(ln.base, log_n, k) + i : at + shift;
                v_s[smem_pos(geo, l, i)] = barrett_reduce_64(
                    in[src], __ldg(moduli + ln.limb),
                    __ldg(cr_hi + ln.limb));
            } else {
                v_s[smem_pos(geo, l, i)] = in[at];
            }
        }
    }
    __syncthreads();
    if constexpr (kLoad == kLoadRoundStats) {
        // a block of limb 0 writes its maximum (the one pass: the
        // statistic)
        if (stat_block && threadIdx.x == 0) {
            double v = 0.0;
            for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
                v = fmax(v, warp_maxima()[w]);
            }
            *(geo.mode == kRows ? rd.stat : rd.maxima + blockIdx.x) =
                f64_bits(v);
        }
    }

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

    if constexpr (kFinish) {
#pragma unroll
        for (int w = 0; w < kWordsPerThread; ++w) {
            const int f = threadIdx.x + w * geo.threads;
            if (f >= words) break;
            int l, i;
            tile_word(geo, f, l, i);
            const Line ln = line_of(geo, blk, l, log_n, rows, k);
            if (ln.limb < 0) continue;
            const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
            const FinishRow r = geo.mode == kRows
                ? finish_row(dv, ln.base >> log_n, k, log_n) : fr;
            uint64_t x = divide_finish(xw[w], v_s[smem_pos(geo, l, i)], r.q,
                                       r.inv, r.inv_shoup);
            if (r.acc) x = add_mod(aw[w], x, r.q);
            out[at] = x;
        }
        return;
    }
    for (int f = threadIdx.x; f < words; f += geo.threads) {
        const int l = geo.mode == kCols ? f & ((1 << log_lines) - 1)
                                        : f >> log_line;
        const int i = geo.mode == kCols ? f >> log_lines : f & line_mask;
        const Line ln = line_of(geo, blk, l, log_n, rows, k);
        if (ln.limb < 0) continue;
        const int64_t at = ln.base + static_cast<int64_t>(i) * ln.stride;
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
        out[at] = x;
    }
    if constexpr (kLoad == kLoadPlainReduce) {
        if (blockIdx.x == 0 && threadIdx.x < 32) {
            stat_v = warp_max(stat_v);
            if (threadIdx.x == 0) *rd.stat = f64_bits(stat_v);
        }
    }
}

// An 8-byte copy from device to shared memory that does not pass through
// a register (sm_80+): the copies of a thread are all in flight until
// cp.async.wait_all.
__device__ __forceinline__ void cp_async8(uint64_t *smem,
                                          const uint64_t *gmem) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem));
}

// The fused last inverse passes (AFi's, AXi's, ACi's): a block holds the
// same column set (2^log_cols columns of 2^log_line words: the strided
// pass's lines, or one whole row below 2^kSplitLogN) of `group` rows j0 ..
// j0 + group - 1 of one component and, with `special` (AFi), of its
// special row k; tile t has 2^log_tile_threads threads, and the block
// `special` tiles more than the group.
struct InversePlan {
    int log_line, log_cols, group, log_tile_threads, special;
    unsigned blocks;
};

// What a fused last pass holds in shared memory beside its group's tiles,
// and the column sets it may take: `special` tiles more (AFi's special
// row), each row's accumulator words (a tile's words: AFi's) and
// row_consts constants, block_consts constants a block; column sets down
// to 2^min_cols columns, tiles of at most 2^max_log_words words where a
// narrower set exists, and the blocks a plan should give the card.
struct InverseNeeds {
    int special, acc, row_consts, block_consts, min_cols, min_blocks,
        max_log_words;
};

// Their caps: the threads and shared memory a block may take unless one
// row (and the special row) alone need more, the blocks a plan should
// give the card (about one an SM), and the words a thread finishes in AFi
// (a tile's words over the block's threads: below 8).
constexpr int kInverseThreads = 512;
constexpr int kInverseSmem = 64 << 10;
constexpr int kInverseMinBlocks = 128;
constexpr int kInverseFinishWords = kWordsPerThread;
// an output row's constants in shared memory: q, n^-1 and its Shoup
// word, the high Barrett word, floor(p/2) mod q, p^-1 and its Shoup word
constexpr int kInverseConsts = 7;
// AFi: the special tile, an accumulator tile and kInverseConsts a row;
// column sets of 2 columns (16 bytes of a row) or more, A's tiles
constexpr InverseNeeds kAfiNeeds = {1, 1, kInverseConsts, 0, 1,
                                    kInverseMinBlocks, kLogTile};

// One thread's place in a fused last pass: its block's component, first
// row j0, rows and column set, its tile and its index in the tile, the
// tile's source row (limb j0 + tile, k for the special tile, < 0 for an
// idle tile past the rows), and the geometry stage() reads.
struct InverseTile {
    int comp, j0, first, rows_here, tile, tid, limb;
    int log_words, words, stride_shift, tile_size;
    Geo geo;
    Block blk;
};

__device__ __forceinline__ InverseTile inverse_tile(const InversePlan &plan,
                                                    int log_line, int log_n,
                                                    int k) {
    InverseTile b;
    const int log_tt = plan.log_tile_threads;
    const int group = plan.group;
    b.geo = {kColLines, log_line, plan.log_cols, 1 << log_tt};
    b.log_words = log_line + plan.log_cols;
    b.words = 1 << b.log_words;
    b.stride_shift = log_n - log_line;
    const int log_sets = log_n - b.log_words;
    const int groups = (k + group - 1) / group;
    // 32-bit quotients: rows < 2^30 (the entries refuse more)
    const int set = blockIdx.x & ((1 << log_sets) - 1);
    const int cg = static_cast<int>(blockIdx.x >> log_sets);
    b.comp = cg / groups;
    b.j0 = (cg - b.comp * groups) * group;
    b.first = set << plan.log_cols;
    b.rows_here = min(group, k - b.j0);
    b.tile = threadIdx.x >> log_tt;
    b.tid = threadIdx.x & ((1 << log_tt) - 1);
    b.limb = b.tile == group ? k : b.tile < b.rows_here ? b.j0 + b.tile : -1;
    b.tile_size = b.words + (2 << log_line);
    b.blk = {static_cast<int64_t>(b.comp * (k + plan.special) +
                                  (b.limb < 0 ? 0 : b.limb))
                 << log_n,
             b.first, b.limb};
    return b;
}

// The thread's words of its tile and the tile's twiddles (one table for
// the tile's columns: entry e of round r's table is roots[limb n + e], as
// in the strided pass), copied into shared memory by cp.async, in flight
// until the caller waits.
__device__ __forceinline__ void inverse_load(const InverseTile &b,
                                             uint64_t *v_s,
                                             const uint64_t *in,
                                             const uint64_t *roots,
                                             const uint64_t *roots_shoup,
                                             int log_n) {
    if (b.limb < 0) return;
    uint64_t *tile_s = v_s + b.tile * b.tile_size;
    uint64_t *tw_s = tile_s + b.words;
    const int log_line = b.geo.log_line;
    for (int f = b.tid; f < b.words; f += b.geo.threads) {
        int l, i;
        tile_word(b.geo, f, l, i);
        cp_async8(tile_s + smem_pos(b.geo, l, i),
                  in + b.blk.row_base + b.first + l +
                      (static_cast<int64_t>(i) << b.stride_shift));
    }
    for (int e = b.tid; e < (1 << log_line); e += b.geo.threads) {
        const int64_t g = (static_cast<int64_t>(b.limb) << log_n) + e;
        cp_async8(tw_s + e, roots + g);
        cp_async8(tw_s + (1 << log_line) + e, roots_shoup + g);
    }
}

// The inverse rounds of every tile, each by its own threads (stage(), in
// lock step: one barrier a stage), lazy; table_rows: the rows of the
// tables. kLogLine: 5-8 compiled, 0 run time.
template <int kLogLine>
__device__ __forceinline__ void inverse_rounds(const InverseTile &b,
                                               uint64_t *v_s, int log_n,
                                               int table_rows,
                                               const uint64_t *moduli) {
    uint64_t *tile_s = v_s + b.tile * b.tile_size;
    const uint64_t *tw_s = tile_s + b.words;
    if (kLogLine > 0) {
#pragma unroll
        for (int s = 0; s < (kLogLine + 2) / 3; ++s) {
            run_stage<true>(s, tile_s, tw_s, b.geo, b.blk, log_n, 0,
                            table_rows, moduli, b.tid);
        }
    } else {
        for (int s = 0; s < (b.geo.log_line + 2) / 3; ++s) {
            run_stage<true>(s, tile_s, tw_s, b.geo, b.blk, log_n, 0,
                            table_rows, moduli, b.tid);
        }
    }
}

// AFi, the last inverse pass with F's divide. Block b of component comp
// and row group g (j0 = g group) transforms tile t < group: the columns
// first .. of source row comp (k + 1) + j0 + t (limb j0 + t; none past
// k - 1) and tile group: those of comp (k + 1) + k (the special prime);
// each applies n^-1 and reduce_2q as A's last pass does. Then every
// thread finishes its words of the group's tiles: F's rounding divide of
// tile t's word by the special tile's word at the same place, plus the
// accumulator word (copied in before the butterflies), stored to output
// row comp k + j0 + t. The tables are those of the k + 1 primes.
template <int kLogLine>
__global__ void inverse_divide_kernel(uint64_t *out, const uint64_t *in,
                                      int log_n, int k,
                                      const uint64_t *__restrict__ roots,
                                      const uint64_t *__restrict__ roots_shoup,
                                      const uint64_t *__restrict__ moduli,
                                      const uint64_t *__restrict__ inv_degree,
                                      const uint64_t *__restrict__
                                          inv_degree_shoup,
                                      InversePlan plan, Divide dv) {
    extern __shared__ uint64_t v_s[];
    const InverseTile b = inverse_tile(
        plan, kLogLine > 0 ? kLogLine : plan.log_line, log_n, k);
    const int group = plan.group, log_words = b.log_words, words = b.words;
    uint64_t *acc_s = v_s + (group + 1) * b.tile_size;  // the finish's order
    uint64_t *c_s = acc_s + (group << log_words);      // kInverseConsts a row
    const int finish_words = b.rows_here << log_words;

    // every word the block reads, copied straight into shared memory and
    // all in flight together (no register holds them): the tiles' words
    // and twiddles, the accumulator words of each thread's finish, each
    // output row's constants
    inverse_load(b, v_s, in, roots, roots_shoup, log_n);
    const int arow = accumulator_row(b.comp, static_cast<int>(dv.group),
                                     dv.acc_comps,
                                     static_cast<int>(dv.acc_groups));
    const uint64_t *acc_rows =
        arow >= 0 ? dv.acc + ((static_cast<int64_t>(arow) * k + b.j0)
                              << log_n) : nullptr;
    if (acc_rows != nullptr) {
        for (int F = threadIdx.x; F < finish_words; F += blockDim.x) {
            int l, i;
            tile_word(b.geo, F & (words - 1), l, i);
            cp_async8(acc_s + F,
                      acc_rows + (static_cast<int64_t>(F >> log_words)
                                  << log_n) + b.first + l +
                          (static_cast<int64_t>(i) << b.stride_shift));
        }
    }
    const DivideLayout L{k};
    if (threadIdx.x < b.rows_here) {
        const int j = b.j0 + threadIdx.x;
        uint64_t *c = c_s + threadIdx.x * kInverseConsts;
        cp_async8(c + 0, moduli + j);
        cp_async8(c + 1, inv_degree + j);
        cp_async8(c + 2, inv_degree_shoup + j);
        cp_async8(c + 3, dv.consts + L.ratio() + j);
        cp_async8(c + 4, dv.consts + L.half_mod() + j);
        cp_async8(c + 5, dv.consts + L.inv() + j);
        cp_async8(c + 6, dv.consts + L.inv_shoup() + j);
    }
    // the special prime's constants in registers
    const uint64_t p = __ldg(moduli + k);
    const uint64_t np = __ldg(inv_degree + k),
                   np_shoup = __ldg(inv_degree_shoup + k);
    const uint64_t half = __ldg(dv.consts + L.half());
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    inverse_rounds<kLogLine>(b, v_s, log_n, k + 1, moduli);

    // the special tile's words, finished once for all its rows: n^-1,
    // reduce_2q, then the offset of F's divide
    uint64_t *special = v_s + group * b.tile_size;
    for (int f = threadIdx.x; f < words; f += blockDim.x) {
        special[f] = divide_round_last(
            reduce_2q(mul_mod_shoup_lazy(special[f], np, np_shoup, p), p), p,
            half);
    }
    __syncthreads();
    uint64_t *dst = out + ((static_cast<int64_t>(b.comp) * k + b.j0)
                           << log_n) + b.first;
#pragma unroll
    for (int w = 0; w < kInverseFinishWords; ++w) {
        const int F = threadIdx.x + w * blockDim.x;
        if (F >= finish_words) break;
        const int t = F >> log_words;
        int l, i;
        tile_word(b.geo, F & (words - 1), l, i);
        const int pos = smem_pos(b.geo, l, i);
        const uint64_t *c = c_s + t * kInverseConsts;
        const uint64_t q = c[0];
        const uint64_t x = reduce_2q(
            mul_mod_shoup_lazy(v_s[t * b.tile_size + pos], c[1], c[2], q), q);
        uint64_t r =
            divide_round_word(x, special[pos], q, c[3], c[4], c[5], c[6]);
        if (acc_rows != nullptr) r = add_mod(acc_s[F], r, q);
        dst[(static_cast<int64_t>(t) << log_n) + l +
            (static_cast<int64_t>(i) << b.stride_shift)] = r;
    }
}

// What AXi's and ACi's last pass computes from a coefficient's k words.
enum DecryptFinish { kDecryptExact = 0, kDecryptRound = 1 };

// Their blocks' needs beside the tiles (InverseNeeds): X's 6 constants a
// limb and 5 others (decrypt.cuh ExactLayout); C's 5 a limb (q, the
// scaled punctured inverse and its Shoup word, M's two entries), C's 6
// others (ConvertLayout{k, 2}) and E's kRoundConsts; no special tile, no
// accumulator. One-column sets (a single decrypt at n = 16384: 128 blocks
// of one column against 64 of two), 96 blocks and tiles of 512 words at
// most were each the faster on the H100 (PERF.md: (3, 5, 16384) and the
// batch of 52 at (2, 16384) take 4 columns a block where the rule of AFi
// gave 2 and 8).
constexpr InverseNeeds kDecryptNeeds[2] = {
    {0, 0, 6, 5, 0, 96, 9}, {0, 0, 5, 6 + kRoundConsts, 0, 96, 9}};

// Two coefficients' words mod t from their k lazy words each (v0, v1: the
// first tile's; the next limb's a tile further), their chains interleaved:
// X's conversion times cf^-1, or C's conversion and E's rounding. c: the
// block's constants, n^-1 folded into the punctured inverses, so that the
// lazy word (below 2q) goes straight into the Shoup product of X's or C's
// temp, which reduces it as A's n^-1 and reduce_2q would have.
template <int kFinish>
__device__ __forceinline__ void decrypt_pair(const uint64_t *v0,
                                             const uint64_t *v1, int stride,
                                             const uint64_t *c, int k,
                                             uint64_t inv_cf,
                                             uint64_t inv_cf_shoup,
                                             uint64_t &r0, uint64_t &r1) {
    if constexpr (kFinish == kDecryptExact) {
        ExactSum s0 = {}, s1 = {};
        for (int j = 0; j < k; ++j) {
            exact_add(s0, v0[j * stride], c, k, j);
            exact_add(s1, v1[j * stride], c, k, j);
        }
        r0 = exact_finish(s0, c, k, inv_cf, inv_cf_shoup);
        r1 = exact_finish(s1, c, k, inv_cf, inv_cf_shoup);
    } else {
        const uint64_t *rc = c + ConvertLayout{k, 2}.words();
        TGammaSum s0 = {}, s1 = {};
        for (int j = 0; j < k; ++j) {
            t_gamma_add(s0, v0[j * stride], c, k, j);
            t_gamma_add(s1, v1[j * stride], c, k, j);
        }
        r0 = t_gamma_round(s0, c, k, rc);
        r1 = t_gamma_round(s1, c, k, rc);
    }
}

// AXi and ACi, the last inverse pass with the decrypt's conversion. Block
// b of component comp transforms tile t < k, the columns first .. of row
// comp k + t (limb t), each with its tile's threads. Then every thread
// finishes whole coefficients across the k tiles, two at a time
// (decrypt_pair: consts in ExactLayout{k} for kDecryptExact, in
// ConvertLayout{k, 2} then round_consts' kRoundConsts words for
// kDecryptRound, copied into shared memory with the tiles), and stores
// each at its place in output row comp.
template <int kLogLine, int kFinish>
__global__ void inverse_decrypt_kernel(uint64_t *out, const uint64_t *in,
                                       int log_n, int k,
                                       const uint64_t *__restrict__ roots,
                                       const uint64_t *__restrict__
                                           roots_shoup,
                                       const uint64_t *__restrict__ moduli,
                                       InversePlan plan,
                                       const uint64_t *__restrict__ consts,
                                       const uint64_t *__restrict__
                                           round_consts,
                                       uint64_t inv_cf,
                                       uint64_t inv_cf_shoup) {
    extern __shared__ uint64_t v_s[];
    const InverseTile b = inverse_tile(
        plan, kLogLine > 0 ? kLogLine : plan.log_line, log_n, k);
    const int conv_words = kFinish == kDecryptExact
                               ? ExactLayout{k}.words()
                               : ConvertLayout{k, 2}.words();
    const int n_consts =
        conv_words + (kFinish == kDecryptExact ? 0 : kRoundConsts);
    uint64_t *c_s = v_s + k * b.tile_size;
    inverse_load(b, v_s, in, roots, roots_shoup, log_n);
    for (int j = threadIdx.x; j < n_consts; j += blockDim.x) {
        cp_async8(c_s + j, j < conv_words ? consts + j
                                          : round_consts + (j - conv_words));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    inverse_rounds<kLogLine>(b, v_s, log_n, k, moduli);

    // one coefficient a thread left the finish latency-bound: its chain of
    // dependent 64-bit products, k limbs long, is all a thread has to do
    uint64_t *dst = out + (static_cast<int64_t>(b.comp) << log_n) + b.first;
    for (int f0 = threadIdx.x; f0 < b.words; f0 += 2 * blockDim.x) {
        const int f1 = f0 + static_cast<int>(blockDim.x) < b.words
                           ? f0 + static_cast<int>(blockDim.x) : f0;
        int l0, i0, l1, i1;
        tile_word(b.geo, f0, l0, i0);
        tile_word(b.geo, f1, l1, i1);
        uint64_t r0, r1;
        decrypt_pair<kFinish>(v_s + smem_pos(b.geo, l0, i0),
                              v_s + smem_pos(b.geo, l1, i1), b.tile_size,
                              c_s, k, inv_cf, inv_cf_shoup, r0, r1);
        dst[l0 + (static_cast<int64_t>(i0) << b.stride_shift)] = r0;
        if (f1 != f0) {
            dst[l1 + (static_cast<int64_t>(i1) << b.stride_shift)] = r1;
        }
    }
}

// AP2i's sizes: ciphertext components a side (P2's); the words of a
// block's tile (half A's 2^kLogTile: with s1 + s2 - 1 tiles a block, the
// smaller tile keeps more blocks on an SM), and the threads a block may
// take, which with the registers a thread is held to (launch bounds)
// keep four blocks an SM.
constexpr int kPairMaxComps = 4;
constexpr int kPairLogTile = kLogTile - 1;
constexpr int kPairThreads = 256;
constexpr int kPairMinBlocks = 4;

// AP2i's first inverse pass. Block (pair p = x Y + y, chunk set) of row r
// (blockIdx.y) holds the set's 2^log_lines chunks of 2^log_line words
// (A's contiguous lines; below 2^kSplitLogN one chunk, the whole row) of
// output rows (p, m, r), m < s1 + s2 - 1, as tiles side by side in shared
// memory, and one copy of the chunks' twiddles (the same for every tile).
// The block's threads form the tiles word by word: a thread loads a[x, i,
// r] and w[y, i', r] at a word (each once for the block), sums the
// products of each i + i' = m in 128 bits and reduces the sum by Barrett-
// 128 (P2's words). Then tile m's threads run A's inverse rounds on it and
// store it lazy to output row (p, m, r), or, where this is the only pass,
// with n^-1 and reduce_2q (A's last pass's finish).
template <int kLogLine>
__global__ void __launch_bounds__(kPairThreads, kPairMinBlocks)
inverse_pair_kernel(uint64_t *out, const uint64_t *a, const uint64_t *w,
                    int log_n, int R, int Y, int s1, int s2,
                    const uint64_t *__restrict__ roots,
                    const uint64_t *__restrict__ roots_shoup,
                    const uint64_t *__restrict__ moduli,
                    const uint64_t *__restrict__ cr_lo,
                    const uint64_t *__restrict__ cr_hi,
                    const uint64_t *__restrict__ inv_degree,
                    const uint64_t *__restrict__ inv_degree_shoup, Pass pass,
                    int tile_threads) {
    extern __shared__ uint64_t v_s[];
    const int log_line = kLogLine > 0 ? kLogLine : pass.log_line;
    const int log_lines = kLogLine > 0 ? kPairLogTile - kLogLine
                                       : pass.log_lines;
    const Geo geo = {kChunks, log_line, log_lines, tile_threads};
    const int log_words = log_line + log_lines;
    const int words = 1 << log_words;
    const int line_mask = (1 << log_line) - 1;
    const int so = s1 + s2 - 1;
    const int r = blockIdx.y;
    const int log_sets = log_n - log_words;
    const int set = blockIdx.x & ((1 << log_sets) - 1);
    const int pair = static_cast<int>(blockIdx.x >> log_sets);
    const int x = pair / Y, y = pair - x * Y;
    const Block blk = {0, set << log_lines, r};
    uint64_t *tw_s = v_s + so * words;

    // the chunks' twiddles (entry e = 2^rho + b of line l's round-rho
    // table: the global root_powers[o 2^rho + b]), as A's contiguous pass
    for (int f = threadIdx.x; f < words; f += blockDim.x) {
        const int l = f >> log_line, e = f & line_mask;
        if (e == 0) continue;
        const Line ln = line_of(geo, blk, l, log_n, 0, R);
        const int rho = 31 - __clz(e);
        const int64_t g = (static_cast<int64_t>(r) << log_n) +
                          (ln.o << rho) + (e - (1 << rho));
        tw_s[(2 * l << log_line) + e] = __ldg(roots + g);
        tw_s[((2 * l + 1) << log_line) + e] = __ldg(roots_shoup + g);
    }

    // the products at word f of the block's chunks (word pos0 + f of a
    // row), every term's words loaded once
    const int64_t comp = static_cast<int64_t>(R) << log_n;
    const int64_t pos0 = static_cast<int64_t>(set) << log_words;
    const uint64_t *ap = a + static_cast<int64_t>(x) * s1 * comp +
                         (static_cast<int64_t>(r) << log_n) + pos0;
    const uint64_t *wp = w + static_cast<int64_t>(y) * s2 * comp +
                         (static_cast<int64_t>(r) << log_n) + pos0;
    const uint64_t q = moduli[r], lo = cr_lo[r], hi = cr_hi[r];
    for (int f = threadIdx.x; f < words; f += blockDim.x) {
        uint64_t av[kPairMaxComps], wv[kPairMaxComps];
#pragma unroll
        for (int i = 0; i < kPairMaxComps; ++i) {
            if (i < s1) av[i] = __ldg(ap + i * comp + f);
            if (i < s2) wv[i] = __ldg(wp + i * comp + f);
        }
        const int at = smem_pos(geo, f >> log_line, f & line_mask);
        // both loops unrolled, so every register index is a constant
#pragma unroll
        for (int m = 0; m < 2 * kPairMaxComps - 1; ++m) {
            if (m < so) {
                u128 c = 0;
#pragma unroll
                for (int i = 0; i < kPairMaxComps; ++i) {
                    const int i2 = m - i;
                    if (i2 >= 0 && i2 < kPairMaxComps && i < s1 && i2 < s2) {
                        c += static_cast<u128>(av[i]) * wv[i2];
                    }
                }
                v_s[m * words + at] = barrett_reduce_128(
                    static_cast<uint64_t>(c), static_cast<uint64_t>(c >> 64),
                    q, lo, hi);
            }
        }
    }
    __syncthreads();

    // A's inverse rounds on each tile, by its own threads (lock step)
    const int tile = threadIdx.x / tile_threads;
    const int tid = threadIdx.x - tile * tile_threads;
    uint64_t *tile_s = v_s + tile * words;
    if (kLogLine > 0) {
#pragma unroll
        for (int st = 0; st < (kLogLine + 2) / 3; ++st) {
            run_stage<true>(st, tile_s, tw_s, geo, blk, log_n, 0, R, moduli,
                            tid);
        }
    } else {
        for (int st = 0; st < (log_line + 2) / 3; ++st) {
            run_stage<true>(st, tile_s, tw_s, geo, blk, log_n, 0, R, moduli,
                            tid);
        }
    }
    uint64_t *dst = out + ((((static_cast<int64_t>(pair) * so + tile) * R +
                             r) << log_n) + pos0);
    for (int f = tid; f < words; f += tile_threads) {
        uint64_t v = tile_s[smem_pos(geo, f >> log_line, f & line_mask)];
        if (pass.finish) {
            v = reduce_2q(mul_mod_shoup_lazy(v, inv_degree[r],
                                             inv_degree_shoup[r], q), q);
        }
        dst[f] = v;
    }
}

typedef void (*PassKernel)(uint64_t *, const uint64_t *, int, int, int,
                           const uint64_t *, const uint64_t *,
                           const uint64_t *, const uint64_t *,
                           const uint64_t *, const uint64_t *, Pass, int,
                           Divide, Lift, Round);

// The kernel compiled for the geometry of p (2^kLogTile-word tiles of
// 2^5-2^8-word lines) in mode kMode, or null.
template <bool kInverse, int kMode, int kLoad, bool kFinish>
PassKernel compiled_for(const Pass &p) {
    if (p.mode != kMode || p.log_line + p.log_lines != kLogTile) {
        return nullptr;
    }
    switch (p.log_line) {
    case 5: return ntt_pass_kernel<kInverse, kMode, 5, kLoad, kFinish>;
    case 6: return ntt_pass_kernel<kInverse, kMode, 6, kLoad, kFinish>;
    case 7: return ntt_pass_kernel<kInverse, kMode, 7, kLoad, kFinish>;
    case 8: return ntt_pass_kernel<kInverse, kMode, 8, kLoad, kFinish>;
    default: return nullptr;
    }
}

// The kernel of a pass: compiled for its geometry where one is, else the
// run-time one. A load other than the plain one is a forward transform's
// first pass (strided, or the one pass over whole rows), a finish its last
// (contiguous, or the one pass), so only those modes are compiled for
// them; a pass that takes both is the one pass (run-time).
template <bool kInverse, int kLoad, bool kFinish>
PassKernel kernel_for(const Pass &p) {
    PassKernel kernel = nullptr;
    if constexpr (kLoad == kLoadPlain && !kFinish) {
        kernel = compiled_for<kInverse, kCols, kLoad, kFinish>(p);
        if (kernel == nullptr) {
            kernel = compiled_for<kInverse, kChunks, kLoad, kFinish>(p);
        }
    } else if constexpr (kLoad == kLoadPlainReduce) {
        kernel = compiled_for<kInverse, kChunks, kLoad, kFinish>(p);
    } else if constexpr (!kFinish) {
        kernel = compiled_for<kInverse, kCols, kLoad, kFinish>(p);
    } else if constexpr (kLoad == kLoadPlain) {
        kernel = compiled_for<kInverse, kChunks, kLoad, kFinish>(p);
    }
    return kernel != nullptr ? kernel
                             : ntt_pass_kernel<kInverse, kRows, 0, kLoad,
                                               kFinish>;
}

// The kernel of pass p of `count`: A's own, or with the digits' load
// (cr_hi), the lift's (lf), the rounding's (rd; with its statistic, the
// last pass's reduction too) or the divide's load and finish (dv) in a
// forward transform.
PassKernel pass_kernel(const Pass &pass, int p, int count, int inverse,
                       const void *cr_hi, const Divide *dv, const Lift *lf,
                       const Round *rd) {
    const bool first = p == 0, last = p == count - 1;
    if (inverse) return kernel_for<true, kLoadPlain, false>(pass);
    if (dv != nullptr) {
        if (first && last) return kernel_for<false, kLoadDivide, true>(pass);
        if (first) return kernel_for<false, kLoadDivide, false>(pass);
        return kernel_for<false, kLoadPlain, true>(pass);
    }
    if (cr_hi != nullptr && first) {
        return kernel_for<false, kLoadDigits, false>(pass);
    }
    if (lf != nullptr && first) {
        return kernel_for<false, kLoadLift, false>(pass);
    }
    if (rd != nullptr && rd->stat != nullptr) {
        return first ? kernel_for<false, kLoadRoundStats, false>(pass)
                     : kernel_for<false, kLoadPlainReduce, false>(pass);
    }
    if (rd != nullptr && first) {
        return kernel_for<false, kLoadRound, false>(pass);
    }
    return kernel_for<false, kLoadPlain, false>(pass);
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
// each word into the row's prime q[r % k] as it loads it; with lf (the
// lift's entry) it lifts that word mod t into q[r % k]; with rd (the
// rounding's entry) it rounds that f64 word into q[r % k]; with dv (the
// divide's entries) it forms K''s temp of that word instead, and the last
// pass stores K''s finish.
int run(void *out, const void *in, long long rows, int log_n, int k,
        const void *roots, const void *roots_shoup, const void *moduli,
        const void *cr_hi, const void *inv_degree,
        const void *inv_degree_shoup, int inverse, int lazy,
        const Divide *dv, void *stream, const Lift *lf = nullptr,
        const Round *rd = nullptr) {
    if (rows < 1 || rows > (1LL << 30) || k < 1 || log_n < 1 || log_n > 24) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Pass passes[2];
    const int count = plan(rows, log_n, inverse, passes);
    const void *src = in;
    for (int p = 0; p < count; ++p) {
        const PassKernel kernel = pass_kernel(passes[p], p, count, inverse,
                                              cr_hi, dv, lf, rd);
        if ((dv != nullptr || lf != nullptr || rd != nullptr) &&
            (1 << (passes[p].log_line + passes[p].log_lines)) >
                kWordsPerThread * threads_for(passes[p])) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        // the rounding's first pass spreads its words over more threads,
        // up to 512 (registers)
        const int threads = threads_for(passes[p]) *
            (rd != nullptr && p == 0 && threads_for(passes[p]) <= 256
                 ? kRoundSpread : 1);
        // above the default 48 KiB (n >= 2^23, the run-time kernel): the
        // limit is raised on the current device at each such call
        const size_t smem = smem_bytes(passes[p]);
        if (smem > (48 << 10)) {
            const cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        kernel<<<passes[p].blocks, threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<uint64_t *>(out), static_cast<const uint64_t *>(src),
            static_cast<int>(rows), log_n, k,
            static_cast<const uint64_t *>(roots),
            static_cast<const uint64_t *>(roots_shoup),
            static_cast<const uint64_t *>(moduli),
            static_cast<const uint64_t *>(cr_hi),
            static_cast<const uint64_t *>(inv_degree),
            static_cast<const uint64_t *>(inv_degree_shoup), passes[p], lazy,
            dv != nullptr ? *dv : Divide{}, lf != nullptr ? *lf : Lift{},
            rd != nullptr ? *rd : Round{});
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
               inv_degree, inv_degree_shoup, inverse, lazy, nullptr, stream);
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
               nullptr, nullptr, 0, 0, nullptr, stream);
}

// The plain lift and its forward transform in one call (G''s lift folded
// into A's first pass, AGp): m (rows / k, 2^log_n) words mod t, out
// (rows, 2^log_n), row r the forward NTT of source row r / k lifted into
// q[r % k] (times cf mod t first where cf != 1; centred at the threshold:
// (t+1)/2 for the plain ops, t for the BGV encrypt's raw residues); consts
// G''s (ops/poly.py plain_lift_consts, LiftLayout); fully reduced.
extern "C" int troy_ntt_forward_lift(void *out, const void *m, long long rows,
                                     int log_n, int k, const void *roots,
                                     const void *roots_shoup,
                                     const void *moduli, const void *consts,
                                     unsigned long long threshold,
                                     unsigned long long cf,
                                     unsigned long long cf_shoup,
                                     void *stream) {
    if (consts == nullptr || k < 1 || rows % k != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Lift lf = {static_cast<const uint64_t *>(consts), threshold, cf,
                     cf_shoup};
    return run(out, m, rows, log_n, k, roots, roots_shoup, moduli, nullptr,
               nullptr, nullptr, 0, 0, nullptr, stream, &lf);
}

// The CKKS encode's exact rounding and its forward transform in one call
// (O2's rounding folded into A's first pass, AO2p): u (rows / k,
// 2^log_n) complex (untwist (2^log_n,) complex: the slot encode) or f64
// (untwist null: the polynomial encode's real coefficients), out (rows,
// 2^log_n), row r the forward NTT of rint(Re(u untwist) scale), or
// rint(u scale), of source row r / k in q[r % k]; consts O2's
// (ops/embedding.py make_rns_round_tables, RoundLayout) with E exponents;
// fully reduced.
extern "C" int troy_ntt_forward_round(void *out, const void *u,
                                      const void *untwist, long long rows,
                                      int log_n, int k, const void *roots,
                                      const void *roots_shoup,
                                      const void *moduli, const void *consts,
                                      int E, double scale, void *stream) {
    if (consts == nullptr || k < 1 || E < 1 || rows % k != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Round rd = {static_cast<const double2 *>(untwist),
                      static_cast<const uint64_t *>(consts), E, scale,
                      nullptr, nullptr, 0};
    return run(out, u, rows, log_n, k, roots, roots_shoup, moduli, nullptr,
               nullptr, nullptr, 0, 0, nullptr, stream, nullptr, &rd);
}

// AO2p with O4's statistic (AO4p): the same words from one source row
// (rows = k), and max |rint(Re(u untwist) scale)| (or |rint(u scale)|) as
// an f64 bit pattern at stat. From 2^kSplitLogN the first pass's blocks of
// row 0 write their maxima into `maxima` (room for maxima_room words:
// 2^log_n / 2^kLogTile suffice), which the last pass's first block
// reduces; below, the one pass's first block (which holds row 0) writes
// the statistic. No memset and no third launch.
extern "C" int troy_ntt_forward_round_stats(
        void *out, void *stat, void *maxima, long long maxima_room,
        const void *u, const void *untwist, long long rows, int log_n, int k,
        const void *roots, const void *roots_shoup, const void *moduli,
        const void *consts, int E, double scale, void *stream) {
    if (consts == nullptr || stat == nullptr || k < 1 || E < 1 ||
        rows != k || log_n < 1 || log_n > 24) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Pass passes[2];
    const int count = plan(rows, log_n, 0, passes);
    const long long per_row = count == 2 ? passes[0].blocks / rows : 0;
    if (per_row > maxima_room || (per_row > 0 && maxima == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Round rd = {static_cast<const double2 *>(untwist),
                      static_cast<const uint64_t *>(consts), E, scale,
                      static_cast<unsigned long long *>(stat),
                      static_cast<unsigned long long *>(maxima),
                      static_cast<int>(per_row)};
    return run(out, u, rows, log_n, k, roots, roots_shoup, moduli, nullptr,
               nullptr, nullptr, 0, 0, nullptr, stream, nullptr, &rd);
}

namespace {

// The forward half of a divide by the last prime (K' or K'-BGV folded into
// A's forward): out (comps, k, n) from last (comps, n), x (comps, k + 1,
// n) and acc (acc_groups, acc_comps, k, n) or null, over the tables of
// q_0..q_{k-1}; consts in DivideLayout.
int divide_forward(void *out, const void *last, const void *x,
                   const void *acc, long long comps, int acc_comps,
                   long long group, long long acc_groups, int k, int log_n,
                   const void *roots, const void *roots_shoup,
                   const void *moduli, const void *consts, int bgv,
                   void *stream) {
    if (k < 1 || k > kDivideMaxLimbs || comps < 1 || x == nullptr ||
        consts == nullptr || acc_comps < 0 ||
        (acc_comps > 0 && acc == nullptr) || group < 1 || acc_groups < 1 ||
        acc_comps > group) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Divide dv = {static_cast<const uint64_t *>(x),
                       static_cast<const uint64_t *>(acc),
                       static_cast<const uint64_t *>(consts), group,
                       acc_groups, acc_comps, bgv};
    return run(out, last, comps * k, log_n, k, roots, roots_shoup, moduli,
               nullptr, nullptr, nullptr, 0, 1, &dv, stream);
}

typedef void (*InverseDivideKernel)(uint64_t *, const uint64_t *, int, int,
                                    const uint64_t *, const uint64_t *,
                                    const uint64_t *, const uint64_t *,
                                    const uint64_t *, InversePlan, Divide);
typedef void (*InverseDecryptKernel)(uint64_t *, const uint64_t *, int, int,
                                     const uint64_t *, const uint64_t *,
                                     const uint64_t *, InversePlan,
                                     const uint64_t *, const uint64_t *,
                                     uint64_t, uint64_t);

// Shared memory of a fused last pass: the group's tiles (and the special
// tile) of words and twiddles, then what `need` adds a row and a block.
size_t inverse_smem(const InversePlan &p, const InverseNeeds &need) {
    const size_t words = size_t(1) << (p.log_line + p.log_cols);
    const size_t tile = words + (size_t(2) << p.log_line);
    return sizeof(uint64_t) *
           ((p.group + need.special) * tile +
            p.group * ((need.acc ? words : 0) + need.row_consts) +
            need.block_consts);
}

// A fused last pass over comps components of k rows (and, with
// need.special, their special row): A's strided lines (2^a words,
// a = log_n / 2) from 2^kSplitLogN, whole rows below. Of the column sets
// from A's (or the widest whose tiles have 2^need.max_log_words words, if
// a narrower one exists) down to 2^need.min_cols columns, those whose
// tiles let one block hold every row and the special row within the caps:
// the widest with need.min_blocks blocks, else the narrowest (the most
// blocks); if none holds them all, the narrowest and as many rows a block
// as the caps allow (at least one), the special row transformed once a
// row group.
InversePlan plan_inverse(long long comps, int k, int log_n,
                         const InverseNeeds &need) {
    int log_line = log_n, max_cols = 0;
    if (log_n >= kSplitLogN) {
        const int a = log_n / 2, b = log_n - a;
        log_line = a;
        max_cols = kLogTile - a < 0 ? 0 : kLogTile - a > b ? b : kLogTile - a;
    }
    const int lo = max_cols < need.min_cols ? max_cols : need.min_cols;
    int hi = need.max_log_words - log_line;
    hi = hi < lo ? lo : hi > max_cols ? max_cols : hi;
    InversePlan p = {}, whole = {};
    for (int c = hi; c >= lo; --c) {
        const int log_words = log_line + c;
        p = {log_line, c, k, log_words > 3 ? log_words - 3 : 0, need.special,
             0};
        const int by_threads =
            (kInverseThreads >> p.log_tile_threads) - need.special;
        while (p.group > 1 && (p.group > by_threads ||
                               inverse_smem(p, need) > size_t(kInverseSmem))) {
            --p.group;
        }
        const long long groups = (k + p.group - 1) / p.group;
        p.blocks = static_cast<unsigned>((comps * groups)
                                         << (log_n - log_words));
        if (p.group == k) {
            if (p.blocks >= static_cast<unsigned>(need.min_blocks)) return p;
            whole = p;
        }
    }
    return whole.group == k ? whole : p;
}

// Raises the kernel's dynamic shared memory limit on the current device
// where it needs more than the default 48 KiB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
    if (smem <= (48 << 10)) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
}

// A's first inverse pass of a fused inverse over `rows` rows of the
// tables' `table_rows` limbs, into scratch, where the transform takes two
// passes (from 2^kSplitLogN); src then points at scratch. Below, nothing:
// the fused pass transforms whole rows of x.
int inverse_first_pass(const uint64_t *&src, void *scratch, long long rows,
                       int log_n, int table_rows, const void *roots,
                       const void *roots_shoup, const void *moduli,
                       const void *inv_degree, const void *inv_degree_shoup,
                       cudaStream_t s) {
    Pass passes[2];
    if (plan(rows, log_n, 1, passes) != 2) return 0;
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const PassKernel first = kernel_for<true, kLoadPlain, false>(passes[0]);
    const size_t smem = smem_bytes(passes[0]);
    if (int err = allow_smem(first, smem)) return err;
    first<<<passes[0].blocks, threads_for(passes[0]), smem, s>>>(
        static_cast<uint64_t *>(scratch), src, static_cast<int>(rows), log_n,
        table_rows, static_cast<const uint64_t *>(roots),
        static_cast<const uint64_t *>(roots_shoup),
        static_cast<const uint64_t *>(moduli), nullptr,
        static_cast<const uint64_t *>(inv_degree),
        static_cast<const uint64_t *>(inv_degree_shoup), passes[0], 1,
        Divide{}, Lift{}, Round{});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = static_cast<const uint64_t *>(scratch);
    return 0;
}

// AFi: A's inverse of x (comps, k + 1, n), NTT form, over the tables of
// the k + 1 primes (row k the special prime p), with F's divide in its
// last pass: out (comps, k, n), coefficient form, plus acc
// (acc_groups, acc_comps, k, n) or null in the layout of
// divide_round_kernel; consts in DivideLayout (5k + 2 words). From
// 2^kSplitLogN, A's first inverse pass over all rows into scratch (comps,
// k + 1, n), then the fused strided pass; below, the fused pass alone
// over whole rows.
int inverse_divide(void *out, const void *x, void *scratch, const void *acc,
                   long long comps, int acc_comps, long long group,
                   long long acc_groups, int k, int log_n, const void *roots,
                   const void *roots_shoup, const void *moduli,
                   const void *inv_degree, const void *inv_degree_shoup,
                   const void *consts, void *stream) {
    const long long rows = comps * (k + 1);
    if (k < 1 || k > kDivideMaxLimbs || comps < 1 || rows > (1LL << 30) ||
        log_n < 1 || log_n > 24 || consts == nullptr || acc_comps < 0 ||
        (acc_comps > 0 && acc == nullptr) || group < 1 || acc_groups < 1 ||
        acc_comps > group) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint64_t *src = static_cast<const uint64_t *>(x);
    if (int err = inverse_first_pass(src, scratch, rows, log_n, k + 1, roots,
                                     roots_shoup, moduli, inv_degree,
                                     inv_degree_shoup, s)) {
        return err;
    }
    const InversePlan last = plan_inverse(comps, k, log_n, kAfiNeeds);
    InverseDivideKernel kernel = inverse_divide_kernel<0>;
    switch (last.log_line) {
    case 5: kernel = inverse_divide_kernel<5>; break;
    case 6: kernel = inverse_divide_kernel<6>; break;
    case 7: kernel = inverse_divide_kernel<7>; break;
    case 8: kernel = inverse_divide_kernel<8>; break;
    default: break;
    }
    const size_t smem = inverse_smem(last, kAfiNeeds);
    if (int err = allow_smem(kernel, smem)) return err;
    const Divide dv = {nullptr, static_cast<const uint64_t *>(acc),
                       static_cast<const uint64_t *>(consts), group,
                       acc_groups, acc_comps, 0};
    kernel<<<last.blocks, (last.group + last.special)
                              << last.log_tile_threads,
             smem, s>>>(
        static_cast<uint64_t *>(out), src, log_n, k,
        static_cast<const uint64_t *>(roots),
        static_cast<const uint64_t *>(roots_shoup),
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(inv_degree),
        static_cast<const uint64_t *>(inv_degree_shoup), last, dv);
    TROY_RETURN_LAUNCH_STATUS();
}

template <int kFinish>
InverseDecryptKernel decrypt_kernel_for(int log_line) {
    switch (log_line) {
    case 5: return inverse_decrypt_kernel<5, kFinish>;
    case 6: return inverse_decrypt_kernel<6, kFinish>;
    case 7: return inverse_decrypt_kernel<7, kFinish>;
    case 8: return inverse_decrypt_kernel<8, kFinish>;
    default: return inverse_decrypt_kernel<0, kFinish>;
    }
}

// AXi (finish kDecryptExact) and ACi (kDecryptRound): A's inverse of x
// (comps, k, n), NTT form, over the tables of the level's k primes, with
// the decrypt's conversion in its last pass: out (comps, n) mod t; consts
// X's or C's with n^-1 folded into the punctured inverses. From
// 2^kSplitLogN, A's first inverse pass into scratch (comps, k, n), then
// the fused strided pass; below, the fused pass alone over whole rows.
// A shape whose plan cannot hold the k rows in one block is refused
// before any launch.
int inverse_decrypt(int finish, void *out, const void *x, void *scratch,
                    long long comps, int k, int log_n, const void *roots,
                    const void *roots_shoup, const void *moduli,
                    const void *consts, const void *round_consts,
                    unsigned long long inv_cf,
                    unsigned long long inv_cf_shoup, void *stream) {
    if (k < 1 || comps < 1 || comps * k > (1LL << 30) || log_n < 1 ||
        log_n > 24 || consts == nullptr ||
        (finish == kDecryptRound && round_consts == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const InverseNeeds &need = kDecryptNeeds[finish];
    const InversePlan last = plan_inverse(comps, k, log_n, need);
    if (last.group != k) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint64_t *src = static_cast<const uint64_t *>(x);
    if (int err = inverse_first_pass(src, scratch, comps * k, log_n, k, roots,
                                     roots_shoup, moduli, nullptr, nullptr,
                                     s)) {
        return err;
    }
    const InverseDecryptKernel kernel =
        finish == kDecryptExact ? decrypt_kernel_for<kDecryptExact>(
                                      last.log_line)
                                : decrypt_kernel_for<kDecryptRound>(
                                      last.log_line);
    const size_t smem = inverse_smem(last, need);
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<last.blocks, k << last.log_tile_threads, smem, s>>>(
        static_cast<uint64_t *>(out), src, log_n, k,
        static_cast<const uint64_t *>(roots),
        static_cast<const uint64_t *>(roots_shoup),
        static_cast<const uint64_t *>(moduli), last,
        static_cast<const uint64_t *>(consts),
        static_cast<const uint64_t *>(round_consts), inv_cf, inv_cf_shoup);
    TROY_RETURN_LAUNCH_STATUS();
}

typedef void (*InversePairKernel)(uint64_t *, const uint64_t *,
                                  const uint64_t *, int, int, int, int, int,
                                  const uint64_t *, const uint64_t *,
                                  const uint64_t *, const uint64_t *,
                                  const uint64_t *, const uint64_t *,
                                  const uint64_t *, Pass, int);

// AP2i: out (X, Y, s1 + s2 - 1, R, n), the inverse transform over the
// tables' R rows (q u Bsk) of every pair's convolution of a (X, s1, R, n)
// and w (Y, s2, R, n). From 2^kSplitLogN, the fused first pass (A's
// contiguous lines, 2^kPairLogTile-word tiles where the lines allow it)
// into out, then A's strided last pass in place; below, the fused pass
// alone over whole rows, with A's finish. A tile has threads_for's
// threads, halved until the block's tiles fit kPairThreads. A shape whose
// block would need more shared memory than the card gives one is refused
// before any launch.
int inverse_pair(void *out, const void *a, const void *w, long long X,
                 long long Y, int s1, int s2, int R, int log_n,
                 const void *roots, const void *roots_shoup,
                 const void *moduli, const void *cr_lo, const void *cr_hi,
                 const void *inv_degree, const void *inv_degree_shoup,
                 void *stream) {
    if (X < 1 || Y < 1 || s1 < 1 || s2 < 1 || s1 > kPairMaxComps ||
        s2 > kPairMaxComps || R < 1 || R > 65535 || log_n < 1 ||
        log_n > 24) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int so = s1 + s2 - 1;
    const long long rows = X * Y * so * R;
    if (rows > (1LL << 30) || X * Y > (1LL << 30)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Pass passes[2];
    const int count = plan(rows, log_n, 1, passes);
    Pass first = count == 2 ? passes[0] : Pass{kChunks, log_n, 0, 1, 0};
    if (count == 2 && first.log_line + first.log_lines > kPairLogTile) {
        first.log_lines = kPairLogTile > first.log_line
                              ? kPairLogTile - first.log_line : 0;
    }
    const int log_words = first.log_line + first.log_lines;
    const long long blocks = (X * Y) << (log_n - log_words);
    int tile_threads = threads_for(first);
    while (tile_threads * so > kPairThreads && tile_threads > 1) {
        tile_threads >>= 1;
    }
    const size_t smem = sizeof(uint64_t) * (size_t(so + 2) << log_words);
    if (blocks >= (1LL << 31) || smem > size_t(232448)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    InversePairKernel kernel = inverse_pair_kernel<0>;
    if (count == 2 && log_words == kPairLogTile) {
        switch (first.log_line) {
        case 5: kernel = inverse_pair_kernel<5>; break;
        case 6: kernel = inverse_pair_kernel<6>; break;
        case 7: kernel = inverse_pair_kernel<7>; break;
        case 8: kernel = inverse_pair_kernel<8>; break;
        default: break;
        }
    }
    if (int err = allow_smem(kernel, smem)) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint64_t *u_roots = static_cast<const uint64_t *>(roots);
    const uint64_t *u_shoup = static_cast<const uint64_t *>(roots_shoup);
    const uint64_t *u_moduli = static_cast<const uint64_t *>(moduli);
    const uint64_t *u_inv = static_cast<const uint64_t *>(inv_degree);
    const uint64_t *u_inv_shoup =
        static_cast<const uint64_t *>(inv_degree_shoup);
    kernel<<<dim3(static_cast<unsigned>(blocks), R), so * tile_threads,
             smem, s>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(w), log_n, R, static_cast<int>(Y),
        s1, s2, u_roots, u_shoup, u_moduli,
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi), u_inv, u_inv_shoup, first,
        tile_threads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || count == 1) return static_cast<int>(err);
    // A's last pass, its own, in place
    const PassKernel last = kernel_for<true, kLoadPlain, false>(passes[1]);
    const size_t last_smem = smem_bytes(passes[1]);
    if (int e = allow_smem(last, last_smem)) return e;
    last<<<passes[1].blocks, threads_for(passes[1]), last_smem, s>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(out),
        static_cast<int>(rows), log_n, R, u_roots, u_shoup, u_moduli, nullptr,
        u_inv, u_inv_shoup, passes[1], 0, Divide{}, Lift{}, Round{});
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// The four uses of K', each on its own entry (and launch count): the CKKS
// rescale (p the level's last prime, no accumulator), the NTT-form key
// switch (p the special prime, accumulator (c0, c1), c0 or a batch's c0s),
// the BGV mod switch and the BGV key switch (K'-BGV's temps). Arguments
// as divide_forward's; the tables (k, n) are those of q_0..q_{k-1}.
extern "C" int troy_ntt_forward_rescale(
        void *out, const void *last, const void *x, const void *acc,
        long long comps, int acc_comps, long long group, long long acc_groups,
        int k, int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, void *stream) {
    return divide_forward(out, last, x, acc, comps, acc_comps, group,
                          acc_groups, k, log_n, roots, roots_shoup, moduli,
                          consts, 0, stream);
}

extern "C" int troy_ntt_forward_keyswitch(
        void *out, const void *last, const void *x, const void *acc,
        long long comps, int acc_comps, long long group, long long acc_groups,
        int k, int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, void *stream) {
    return divide_forward(out, last, x, acc, comps, acc_comps, group,
                          acc_groups, k, log_n, roots, roots_shoup, moduli,
                          consts, 0, stream);
}

extern "C" int troy_ntt_forward_bgv_mod_switch(
        void *out, const void *last, const void *x, const void *acc,
        long long comps, int acc_comps, long long group, long long acc_groups,
        int k, int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, void *stream) {
    return divide_forward(out, last, x, acc, comps, acc_comps, group,
                          acc_groups, k, log_n, roots, roots_shoup, moduli,
                          consts, 1, stream);
}

extern "C" int troy_ntt_forward_bgv_keyswitch(
        void *out, const void *last, const void *x, const void *acc,
        long long comps, int acc_comps, long long group, long long acc_groups,
        int k, int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, void *stream) {
    return divide_forward(out, last, x, acc, comps, acc_comps, group,
                          acc_groups, k, log_n, roots, roots_shoup, moduli,
                          consts, 1, stream);
}

// The key switch's divide by the special prime in the coefficient domain
// (BFV), folded into A's inverse (AFi): x (comps, k + 1, n) the NTT-form
// products over q_0..q_{k-1} and p; scratch (comps, k + 1, n), A's first
// pass's words from 2^kSplitLogN (unused below); out (comps, k, n) the
// words of A's inverse then troy_keyswitch_divide_round; acc and its
// layout as there; the
// tables (k + 1, n) the inverse roots of those k + 1 primes, with their
// moduli and n^-1; consts: ops/keyswitch.py divide_round_consts (5k + 2).
extern "C" int troy_ntt_inverse_keyswitch(
        void *out, const void *x, void *scratch, const void *acc,
        long long comps, int acc_comps, long long group, long long acc_groups,
        int k, int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *inv_degree,
        const void *inv_degree_shoup, const void *consts, void *stream) {
    return inverse_divide(out, x, scratch, acc, comps, acc_comps, group,
                          acc_groups, k, log_n, roots, roots_shoup, moduli,
                          inv_degree, inv_degree_shoup, consts, stream);
}

// The BGV decrypt folded into A's inverse (AXi): x (comps, k, n) the
// NTT-form phases over the level's k primes; scratch (comps, k, n), A's
// first pass's words from 2^kSplitLogN (unused below); out (comps, n) the
// words of A's inverse then troy_exact_convert times cf^-1; consts:
// ops/rns.py ExactConverter's 6k + 5 words with n^-1 folded into the
// punctured inverses and their Shoup words (ops/rns.py
// fold_inverse_degree); the tables (k, n) the inverse roots of those
// primes, with their moduli. A shape whose one block cannot hold the k
// rows (troy_ntt_inverse_decrypt_plan) is refused.
extern "C" int troy_ntt_inverse_decrypt_bgv(
        void *out, const void *x, void *scratch, long long comps, int k,
        int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, unsigned long long inv_cf,
        unsigned long long inv_cf_shoup, void *stream) {
    return inverse_decrypt(kDecryptExact, out, x, scratch, comps, k, log_n,
                           roots, roots_shoup, moduli, consts, nullptr,
                           inv_cf, inv_cf_shoup, stream);
}

// The BFV decrypt folded into A's inverse (ACi): as the BGV entry, out
// (comps, n) the words of A's inverse then troy_base_convert into {t,
// gamma} (consts: DeviceRnsTool.q_to_t_gamma_scaled's 5k + 6 words, n^-1
// folded in as for AXi) and troy_behz_decrypt_round (round_consts:
// DeviceRnsTool.decrypt_consts).
extern "C" int troy_ntt_inverse_decrypt_bfv(
        void *out, const void *x, void *scratch, long long comps, int k,
        int log_n, const void *roots, const void *roots_shoup,
        const void *moduli, const void *consts, const void *round_consts,
        void *stream) {
    return inverse_decrypt(kDecryptRound, out, x, scratch, comps, k, log_n,
                           roots, roots_shoup, moduli, consts, round_consts,
                           1, 1, stream);
}

// The BFV ct x ct pair grid's convolution folded into A's inverse (AP2i,
// kernel P2 in A's first inverse pass): a (X, s1, R, n) and w (Y, s2, R,
// n) NTT-form words below 4q (sizes at most 4); out (X, Y, s1 + s2 - 1, R,
// n) the words of troy_tile_pair_convolve then A's inverse, fully reduced;
// the tables (R, n) the inverse roots of the R rows' primes (q u Bsk) with
// their Shoup words, moduli, Barrett words (cr_lo, cr_hi) and n^-1.
extern "C" int troy_ntt_inverse_pair_convolve(
        void *out, const void *a, const void *w, long long X, long long Y,
        int s1, int s2, int R, int log_n, const void *roots,
        const void *roots_shoup, const void *moduli, const void *cr_lo,
        const void *cr_hi, const void *inv_degree,
        const void *inv_degree_shoup, void *stream) {
    return inverse_pair(out, a, w, X, Y, s1, s2, R, log_n, roots,
                        roots_shoup, moduli, cr_lo, cr_hi, inv_degree,
                        inv_degree_shoup, stream);
}

// The plan of AXi's (finish 0) or ACi's (finish 1) last pass over comps
// components of k rows at n = 2^log_n (no launch: a query): plan[0..4]
// the log2 of a line's words and of a block's columns, the rows a block
// holds, the log2 of a tile's threads, the blocks. The entries launch
// only where a block holds the k rows.
extern "C" int troy_ntt_inverse_decrypt_plan(long long comps, int k,
                                             int log_n, int finish,
                                             long long *plan) {
    if (k < 1 || comps < 1 || log_n < 1 || log_n > 24 || plan == nullptr ||
        (finish != kDecryptExact && finish != kDecryptRound)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const InversePlan p = plan_inverse(comps, k, log_n, kDecryptNeeds[finish]);
    const long long fields[5] = {p.log_line, p.log_cols, p.group,
                                 p.log_tile_threads, p.blocks};
    for (int i = 0; i < 5; ++i) plan[i] = fields[i];
    return 0;
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
