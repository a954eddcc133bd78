// Kernel J: one stage of the 4-step negacyclic NTT (n = A x B) as short
// butterfly transforms in shared memory.
//
// Replaces troy_tpu/ops/ntt_mxu.py:263 _mod_matmul with its callers :377
// ntt_forward_mxu and :404 ntt_inverse_mxu (and the dispatch of
// troy_tpu/ops/ntt.py:317-379 to them). A row of n words is read as an
// (A, B) array C; the JAX package computes each stage as an exact int8
// matrix product mod q (forward Y = (W1 @ C) * Tw, then Z = Y @ W2;
// inverse Y = (Z @ V2) * iTw, then C = V1 @ Y; ops/ntt_mxu.py documents
// the algebra). Each factor matrix is a short transform:
//  - W1[r, a] = (psi^B)^(a (2 brv(r) + 1)): the negacyclic A-point NTT with
//    root psi^B and bit-reversed output, kernel A's transform at length A;
//    V1 its inverse with 1/A;
//  - W2[b, p] = (omega^A)^(b brv(p)): the cyclic B-point NTT with
//    bit-reversed output. The butterfly network that evaluates x at the
//    roots of x^B - 1 is the negacyclic one with round r's twiddle
//    2^r + i taken from entry i instead of 2^r + i of the length-B table of
//    psi^A: the tables keep it so laid out (b_roots), and no twist is
//    needed; V2 its inverse, whose 1/B the tables fold into the inverse
//    twiddle grid (itw_b = iTw / B).
// So a stage is, for every row of the batch (row r uses limb r % k):
//   forward_left   length-A NTT of every column, times Tw
//   forward_right  cyclic length-B NTT of every row
//   inverse_right  cyclic length-B inverse of every row, times iTw / B
//   inverse_left   length-A inverse of every column, times 1/A
// with every word of the input reduced first (Barrett, so any u64 word
// goes in) and every output word fully reduced: the words of
// mxu_stage_plain, exactly. The stage's blocks may be a shard's (a column
// block (A, C) for the left stages, a row block (R, B) for the right):
// its twiddle grid has the block's shape (ops/ntt_mxu.py shard_tables).
//
// What bounds it on the H100: like kernel A, the instructions of the 64-bit
// butterflies (a Shoup product is three 64-bit multiplies, emulated in
// 32-bit multiply-adds) and the index arithmetic, not the bytes: a stage
// moves each word in and out once and reads the grid (16 bytes a word)
// from L2. The int8 design this replaces did 64 plane products per word
// pair of a 60-bit prime (2 A B K D^2 int8 operations a stage, about
// 40 us a transform at its own bound at n = 32768) and ran at 15-30 times
// that bound (mma.sync on 32 x 32 tiles, the byte planes split by the same
// warps between barriers, 226 registers); butterflies do log2(K) / 2 Shoup
// products a word.
//
// Design: a block takes one tile of its row's block: for the left stages
// an L x c column tile (L = A, c = 8-32 columns side by side, so each of
// the tile's rows is a coalesced run of c words), for the right stages r
// whole rows of L = B words (r L = 2048). It copies the tile and the
// stage's twiddle table (L words and their Shoup words) into shared memory
// with cp.async, runs the log2(L) rounds in stages of up to three in
// registers (butterfly.cuh, kernel A's rounds), the first stage reducing
// the words it loads, then writes the tile out coalesced with the stage's
// epilogue (the grid product, or 1/A, or the final reduction). Shared
// memory of the row tiles is XOR-swizzled in 16-word groups, as kernel A's
// contiguous pass, so the stages' 8-word strides do not meet in one bank.
// A kernel is compiled for each stage and each L (32-512), its geometry
// constants.

#include "butterfly.cuh"

using namespace troy;

namespace {

constexpr int PTRS = 16;         // pointer-table words per limb
// pointer-table slots (ops/ntt_mxu.py MxuNttTables.pointers): the length-A
// forward roots, their Shoup words, the inverse roots and theirs (0-3),
// the same of the cyclic length-B tables (4-7), the forward grid Tw and
// its Shoup words (8, 9), the inverse grid iTw / B and its Shoup words
// (10, 11), the constants (12)
constexpr int A_ROOTS = 0, B_ROOTS = 4, GRID = 8, CONSTS = 12;
// constants read here: q (0), the high Barrett ratio word (1), 1/A and its
// Shoup word (13, 14)
constexpr int C_Q = 0, C_CR_HI = 1, C_INV_A = 13;

enum Stage { kForwardLeft = 0, kForwardRight = 1, kInverseRight = 2,
             kInverseLeft = 3 };

__host__ __device__ constexpr bool left_of(int stage) {
    return stage == kForwardLeft || stage == kInverseLeft;
}
__host__ __device__ constexpr bool inverse_of(int stage) {
    return stage >= kInverseRight;
}

// Lines a block: columns of a left tile (8-32, 2048 words where that is at
// least 8), rows of a right tile (2048 words).
__host__ __device__ constexpr int log_lines_of(int stage, int log_line) {
    return left_of(stage)
        ? (11 - log_line < 3 ? 3 : 11 - log_line > 5 ? 5 : 11 - log_line)
        : 11 - log_line;
}

// Shared-memory position of word i of local line l: column-major for the
// left tiles (the tile as it lies in the row's block), line-major with the
// low 4 bits of i XORed by the next 4 for the right ones.
template <bool kLeft, int kLogLine, int kLogLines>
__device__ __forceinline__ int smem_pos(int l, int i) {
    if (kLeft) return (i << kLogLines) + l;
    return (l << kLogLine) + (i ^ ((i >> 4) & 15));
}

__device__ __forceinline__ void cp_async8(void *smem, const void *gmem) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Stage s of the line's rounds on every line of the tile; s = 0 reduces
// the words it loads (any u64 word) to [0, q) first.
template <int R, int kStage, int kLogLine, int kLogLines, int kThreads>
__device__ __forceinline__ void rounds(uint64_t *v_s, const uint64_t *w_tab,
                                       const uint64_t *wq_tab, int rho0,
                                       bool first, uint64_t q,
                                       uint64_t cr_hi) {
    constexpr bool kLeft = left_of(kStage);
    constexpr int W = 1 << R;
    constexpr int log_groups = kLogLine - R;       // groups a line
    constexpr int items = 1 << (log_groups + kLogLines);
    const int log_h = kLogLine - rho0 - R;         // the stage's least gap
#pragma unroll
    for (int rep = 0; rep < items / kThreads; ++rep) {
        const int it = threadIdx.x + rep * kThreads;
        int l, g;
        if (kLeft) {
            l = it & ((1 << kLogLines) - 1);
            g = it >> kLogLines;
        } else {
            g = it & ((1 << log_groups) - 1);
            l = it >> log_groups;
        }
        const int base = ((g >> log_h) << (kLogLine - rho0)) |
                         (g & ((1 << log_h) - 1));
        uint64_t v[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            v[j] = v_s[smem_pos<kLeft, kLogLine, kLogLines>(
                l, base + (j << log_h))];
            if (first) v[j] = barrett_reduce_64(v[j], q, cr_hi);
        }
        butterfly_rounds<R, inverse_of(kStage)>(v, w_tab, wq_tab, base,
                                                log_h, rho0, kLogLine, q);
#pragma unroll
        for (int j = 0; j < W; ++j) {
            v_s[smem_pos<kLeft, kLogLine, kLogLines>(l, base + (j << log_h))]
                = v[j];
        }
    }
}

// One stage over one tile. Row `row` of the batch is the (2^log_r,
// 2^log_c) block at in + row 2^(log_r + log_c); the block's tiles follow
// each other along the lines' other axis.
template <int kStage, int kLogLine>
__global__ void __launch_bounds__(
    1 << (kLogLine + log_lines_of(kStage, kLogLine) - 3))
ntt_mxu_kernel(uint64_t *__restrict__ out, const uint64_t *__restrict__ in,
               int k, int log_r, int log_c,
               const uint64_t *__restrict__ ptrs) {
    constexpr bool kLeft = left_of(kStage);
    constexpr bool kInverse = inverse_of(kStage);
    constexpr int kLogLines = log_lines_of(kStage, kLogLine);
    constexpr int kLine = 1 << kLogLine;
    constexpr int kWords = 1 << (kLogLine + kLogLines);
    constexpr int kThreads = kWords / 8;
    __shared__ __align__(16) uint64_t v_s[kWords];
    __shared__ __align__(16) uint64_t tw_s[2 * kLine];

    const int log_tiles = (kLeft ? log_c : log_r) - kLogLines;
    const int64_t row = blockIdx.x >> log_tiles;
    const int first = (blockIdx.x & ((1 << log_tiles) - 1)) << kLogLines;
    const uint64_t *p = ptrs + (row % k) * PTRS;
    const uint64_t *c = reinterpret_cast<const uint64_t *>(p[CONSTS]);
    const int table = (kLeft ? A_ROOTS : B_ROOTS) + (kInverse ? 2 : 0);
    const uint64_t *roots = reinterpret_cast<const uint64_t *>(p[table]);
    const uint64_t *roots_shoup =
        reinterpret_cast<const uint64_t *>(p[table + 1]);
    const int64_t block_base = row << (log_r + log_c);

    // the tile's word (line l, index i) in its row's block
    auto offset = [&](int l, int i) -> int64_t {
        return kLeft ? (static_cast<int64_t>(i) << log_c) + first + l
                     : (static_cast<int64_t>(first + l) << log_c) + i;
    };
    for (int f = threadIdx.x; f < kLine; f += kThreads) {
        cp_async8(&tw_s[f], roots + f);
        cp_async8(&tw_s[kLine + f], roots_shoup + f);
    }
#pragma unroll
    for (int rep = 0; rep < kWords / kThreads; ++rep) {
        // consecutive threads, consecutive global words
        const int f = threadIdx.x + rep * kThreads;
        const int l = kLeft ? f & ((1 << kLogLines) - 1) : f >> kLogLine;
        const int i = kLeft ? f >> kLogLines : f & (kLine - 1);
        cp_async8(&v_s[smem_pos<kLeft, kLogLine, kLogLines>(l, i)],
                  in + block_base + offset(l, i));
    }
    const uint64_t q = c[C_Q], cr_hi = c[C_CR_HI];
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int s = 0; s < (kLogLine + 2) / 3; ++s) {
        int R, rho0;
        stage_plan(s, kLogLine, kInverse, R, rho0);
        if (R == 3) {
            rounds<3, kStage, kLogLine, kLogLines, kThreads>(
                v_s, tw_s, tw_s + kLine, rho0, s == 0, q, cr_hi);
        } else if (R == 2) {
            rounds<2, kStage, kLogLine, kLogLines, kThreads>(
                v_s, tw_s, tw_s + kLine, rho0, s == 0, q, cr_hi);
        } else {
            rounds<1, kStage, kLogLine, kLogLines, kThreads>(
                v_s, tw_s, tw_s + kLine, rho0, s == 0, q, cr_hi);
        }
        __syncthreads();
    }

    const uint64_t *grid = nullptr, *grid_shoup = nullptr;
    if (kStage == kForwardLeft || kStage == kInverseRight) {
        const int g = GRID + (kStage == kInverseRight ? 2 : 0);
        grid = reinterpret_cast<const uint64_t *>(p[g]);
        grid_shoup = reinterpret_cast<const uint64_t *>(p[g + 1]);
    }
    const uint64_t inv_a = c[C_INV_A], inv_a_shoup = c[C_INV_A + 1];
    uint64_t *y = out + block_base;
#pragma unroll
    for (int rep = 0; rep < kWords / kThreads; ++rep) {
        const int f = threadIdx.x + rep * kThreads;
        const int l = kLeft ? f & ((1 << kLogLines) - 1) : f >> kLogLine;
        const int i = kLeft ? f >> kLogLines : f & (kLine - 1);
        const int64_t off = offset(l, i);
        uint64_t x = v_s[smem_pos<kLeft, kLogLine, kLogLines>(l, i)];
        if (kStage == kForwardRight) {
            x = reduce_4q(x, q);
        } else if (kStage == kInverseLeft) {
            x = mul_mod_shoup(x, inv_a, inv_a_shoup, q);
        } else {
            // the grid has the block's shape: the word's own offset
            x = mul_mod_shoup(x, __ldg(grid + off), __ldg(grid_shoup + off),
                              q);
        }
        y[off] = x;
    }
}

typedef void (*StageKernel)(uint64_t *, const uint64_t *, int, int, int,
                            const uint64_t *);

template <int kStage>
StageKernel kernel_for(int log_line) {
    switch (log_line) {
    case 5: return ntt_mxu_kernel<kStage, 5>;
    case 6: return ntt_mxu_kernel<kStage, 6>;
    case 7: return ntt_mxu_kernel<kStage, 7>;
    case 8: return ntt_mxu_kernel<kStage, 8>;
    case 9: return ntt_mxu_kernel<kStage, 9>;
    default: return nullptr;
    }
}

}  // namespace

// One stage of J over `rows` blocks of (2^log_r, 2^log_c) words (block r
// uses limb r % k of the (k, 16) pointer table): stage 0 forward_left,
// 1 forward_right, 2 inverse_right, 3 inverse_left (ops/ntt_mxu.py
// STAGES). The stage's line length (2^log_r for the left stages, 2^log_c
// for the right) is 32-512; the other side must hold a whole tile of
// lines (at least 32 for the left stages, 2048 / L rows for the right).
extern "C" int troy_ntt_mxu(void *out, const void *in, long long rows, int k,
                            int log_r, int log_c, const void *ptrs,
                            int stage, void *stream) {
    if (rows < 1 || k < 1 || stage < 0 || stage > 3) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool left = stage == kForwardLeft || stage == kInverseLeft;
    const int log_line = left ? log_r : log_c;
    const int log_other = left ? log_c : log_r;
    const int log_lines = log_lines_of(stage, log_line);
    if (log_line < 5 || log_line > 9 || log_other < log_lines ||
        (rows << (log_other - log_lines)) > 0x7FFFFFFFLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    StageKernel kernel =
        stage == kForwardLeft    ? kernel_for<kForwardLeft>(log_line)
        : stage == kForwardRight ? kernel_for<kForwardRight>(log_line)
        : stage == kInverseRight ? kernel_for<kInverseRight>(log_line)
                                 : kernel_for<kInverseLeft>(log_line);
    const unsigned blocks =
        static_cast<unsigned>(rows << (log_other - log_lines));
    kernel<<<blocks, 1 << (log_line + log_lines - 3), 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), k,
        log_r, log_c, static_cast<const uint64_t *>(ptrs));
    TROY_RETURN_LAUNCH_STATUS();
}
