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
// of 2 limbs, 872 MB, against 33.5 MB of ciphertext tiles: a 278.6 us
// bound at 3.35 TB/s); the 64 x 128-bit products, about 218 M at conv2d,
// take well under that on the integer units. Design: a block owns one limb,
// 128 consecutive coefficients (a thread each), a tile of kTileY = 4
// consecutive outputs y and one x; a thread keeps the kTileY x C 128-bit
// sums of its coefficient in registers. Each inner index brings kTileY
// weight words (read once from HBM, as the one-thread-an-output kernel
// before it did) and C ciphertext words, which serve all kTileY outputs:
// the ciphertext is read ceil(Y / kTileY) times in all, not Y times, and
// the blocks of one ciphertext tile run side by side, so the re-reads hit
// L2. The words come through a four-slot ring in shared memory by 8-byte
// cp.async, three inner indices ahead, which keeps enough bytes in flight
// to stream HBM at its rate; each thread copies and reads only its own
// words, so the ring needs no barrier. Pointers advance by fixed strides in
// i; the ragged last y tile (Y = 52, 126) and a short coefficient range
// are masked in the kernel. The geometry was measured on the H100 against
// register prefetch and other tile sizes (PERF.md section 6).
//
// P2 troy_tile_pair_convolve replaces the per-pair ciphertext convolution of
// linear.py:133 _matmul_cipher_pairs_core (the dyadic step of
// evaluator.py _bfv_multiply and _ntt_form_multiply, vmapped over an X x Yc
// grid): out[x, y, m, r, j] = sum_{i + i' = m} a[x, i, r, j] w[y, i', r, j]
// mod q_r over R rows, each with its own modulus (q u Bsk for BFV, q for
// CKKS and BGV). Inputs may be lazy below 4q < 2^63: a product is below
// 2^126 and at most four terms meet in one output (sizes up to 4), so the
// sum fits 128 bits before its one Barrett reduction. Bytes bound it too
// (at the app's X = 1, Yc = 16 over q u Bsk, 6 rows: 26.8 MB in, 37.7 MB
// out, 19.25 us at 3.35 TB/s). The first kernel, one thread per (x, y, r,
// j) in a grid-stride loop with four 64-bit divisions and 8-byte accesses,
// streamed about 1.5 TB/s (42.8 us there). Design: a 2-D grid (x, a tile
// of kPairTileY outputs y and a coefficient block on x, the row r on y;
// shifts and one 32-bit division, no 64-bit one), 128 threads, two
// coefficients a thread through 16-byte loads and stores; a thread holds
// its x's s1 words in registers for the whole y tile, issues the tile's
// w loads together before any product, and writes each output by a
// streaming store (only a later kernel reads it). s1 and s2 are template
// parameters (1-4 each), so the convolution unrolls without predicates.
// On A's route the BFV pair grid runs P2 inside A's first inverse pass
// instead (csrc/ntt.cu troy_ntt_inverse_pair_convolve, AP2i); this kernel
// is the route of CKKS and BGV (NTT-form products, no inverse) and of J's.
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

// P1's block: one limb l, kTileJ consecutive coefficients (a thread
// each), kTileY consecutive outputs y and one x, every component c. The
// weight and ciphertext words of inner index i go through a ring of
// kStages slots in shared memory by cp.async; a thread copies and reads
// only its own coefficient's words, so the ring needs no barrier.
constexpr int kTileJ = 128;
constexpr int kTileY = 4;
constexpr int kStages = 4;

__device__ __forceinline__ void cp_async8(uint64_t *smem,
                                          const uint64_t *gmem) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem));
}

template <int C>
__device__ __forceinline__ void fold(u128 (&acc)[kTileY][C], uint64_t q,
                                     uint64_t lo, uint64_t hi) {
#pragma unroll
    for (int t = 0; t < kTileY; ++t) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            acc[t][c] = barrett_reduce_128(
                static_cast<uint64_t>(acc[t][c]),
                static_cast<uint64_t>(acc[t][c] >> 64), q, lo, hi);
        }
    }
}

// Blocks in the order (l, j tile, x, y tile), y tile fastest: the blocks
// that share a ciphertext tile run side by side and find it in L2.
template <int C>
__global__ void __launch_bounds__(kTileJ) tile_contract_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ w, int X, int I, int Y, int k,
        int log_n, int y_tiles, int j_tiles,
        const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    constexpr int kSlot = (kTileY + C) * kTileJ;   // words of one ring slot
    __shared__ uint64_t ring[kStages * kSlot];
    int b = blockIdx.x;
    const int yt = b % y_tiles;
    b /= y_tiles;
    const int x = b % X;
    b /= X;
    const int l = b / j_tiles;
    const int64_t j = static_cast<int64_t>(b - l * j_tiles) * kTileJ +
                      threadIdx.x;
    if (j >= (int64_t(1) << log_n)) return;
    const int y0 = yt * kTileY;
    const int ny = Y - y0 < kTileY ? Y - y0 : kTileY;   // ragged last tile
    const int64_t row = static_cast<int64_t>(k) << log_n;  // one (k, n)
    const int64_t at = (static_cast<int64_t>(l) << log_n) + j;
    // a[x, i, c, l, j] and w[i, y0 + t, l, j] step by fixed strides in i
    const uint64_t *ap = a + static_cast<int64_t>(x) * I * C * row + at;
    const uint64_t *wp = w + y0 * row + at;
    const int64_t a_step = C * row, w_step = Y * row;
    uint64_t *mine = ring + threadIdx.x;

    // inner index i into slot i % kStages (an empty group past the end,
    // so every iteration waits for the same number of groups)
    auto fetch = [&](int i) {
        if (i < I) {
            uint64_t *slot = mine + (i % kStages) * kSlot;
            const uint64_t *wi = wp + i * w_step, *ai = ap + i * a_step;
#pragma unroll
            for (int t = 0; t < kTileY; ++t) {
                if (t < ny) cp_async8(slot + t * kTileJ, wi + t * row);
            }
#pragma unroll
            for (int c = 0; c < C; ++c) {
                cp_async8(slot + (kTileY + c) * kTileJ, ai + c * row);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) fetch(s);

    const uint64_t q = moduli[l], lo = cr_lo[l], hi = cr_hi[l];
    u128 acc[kTileY][C];
#pragma unroll
    for (int t = 0; t < kTileY; ++t) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[t][c] = 0;
    }
    int pending = 0;
    for (int i = 0; i < I; ++i) {
        fetch(i + kStages - 1);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
        const uint64_t *slot = mine + (i % kStages) * kSlot;
        uint64_t av[C];
#pragma unroll
        for (int c = 0; c < C; ++c) av[c] = slot[(kTileY + c) * kTileJ];
#pragma unroll
        for (int t = 0; t < kTileY; ++t) {
            const uint64_t wv = t < ny ? slot[t * kTileJ] : 0;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                acc[t][c] += static_cast<u128>(av[c]) * wv;
            }
        }
        if (++pending == FOLD_TERMS) {
            fold<C>(acc, q, lo, hi);
            pending = 0;
        }
    }
    fold<C>(acc, q, lo, hi);
    uint64_t *o = out + (static_cast<int64_t>(x) * Y + y0) * C * row + at;
#pragma unroll
    for (int t = 0; t < kTileY; ++t) {
        if (t < ny) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                o[(t * C + c) * row] = static_cast<uint64_t>(acc[t][c]);
            }
        }
    }
}

// 16-byte global accesses: a read-only load, a streaming load (a word
// read once) and a streaming store (a word only a later kernel reads).
__device__ __forceinline__ ulonglong2 load16(const uint64_t *p) {
    ulonglong2 v;
    asm volatile("ld.global.nc.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(v.x), "=l"(v.y) : "l"(p));
    return v;
}

__device__ __forceinline__ ulonglong2 load16_stream(const uint64_t *p) {
    ulonglong2 v;
    asm volatile("ld.global.cs.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(v.x), "=l"(v.y) : "l"(p));
    return v;
}

__device__ __forceinline__ void store16_stream(uint64_t *p, uint64_t x,
                                               uint64_t y) {
    asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};\n" ::"l"(p), "l"(x),
                 "l"(y)
                 : "memory");
}

// P2's block: kPairThreads threads, two consecutive coefficients each, of
// row r (blockIdx.y), for one x and a tile of kPairTileY consecutive
// outputs y (blockIdx.x: (x y_tiles + y tile) 2^log_cblocks + coefficient
// block).
constexpr int kPairThreads = 128;
constexpr int kPairTileY = 4;

template <int S1, int S2>
__global__ void __launch_bounds__(kPairThreads) tile_pair_convolve_kernel(
        uint64_t *__restrict__ out, const uint64_t *__restrict__ a,
        const uint64_t *__restrict__ w, int Y, int R, int log_n,
        int log_cblocks, int y_tiles, const uint64_t *__restrict__ moduli,
        const uint64_t *__restrict__ cr_lo,
        const uint64_t *__restrict__ cr_hi) {
    constexpr int SO = S1 + S2 - 1;
    const int cb = blockIdx.x & ((1 << log_cblocks) - 1);
    const int xt = static_cast<int>(blockIdx.x >> log_cblocks);
    const int x = xt / y_tiles;
    const int y0 = (xt - x * y_tiles) * kPairTileY;
    const int r = blockIdx.y;
    const int64_t j = (static_cast<int64_t>(cb) * kPairThreads +
                       threadIdx.x) * 2;
    if (j >= (int64_t(1) << log_n)) return;
    const int ny = Y - y0 < kPairTileY ? Y - y0 : kPairTileY;  // ragged
    const int64_t row = static_cast<int64_t>(R) << log_n;  // a component
    const int64_t at = (static_cast<int64_t>(r) << log_n) + j;
    ulonglong2 av[S1];
#pragma unroll
    for (int i = 0; i < S1; ++i) {
        av[i] = load16(a + (static_cast<int64_t>(x) * S1 + i) * row + at);
    }
    ulonglong2 wv[kPairTileY][S2];
    const uint64_t *wp = w + static_cast<int64_t>(y0) * S2 * row + at;
#pragma unroll
    for (int t = 0; t < kPairTileY; ++t) {
        if (t < ny) {
#pragma unroll
            for (int i = 0; i < S2; ++i) {
                wv[t][i] = load16_stream(wp + (t * S2 + i) * row);
            }
        }
    }
    const uint64_t q = moduli[r], lo = cr_lo[r], hi = cr_hi[r];
    uint64_t *o = out + (static_cast<int64_t>(x) * Y + y0) * SO * row + at;
#pragma unroll
    for (int t = 0; t < kPairTileY; ++t) {
        if (t < ny) {
#pragma unroll
            for (int m = 0; m < SO; ++m) {
                u128 c0 = 0, c1 = 0;
#pragma unroll
                for (int i = 0; i < S1; ++i) {
                    if (m - i >= 0 && m - i < S2) {
                        c0 += static_cast<u128>(av[i].x) * wv[t][m - i].x;
                        c1 += static_cast<u128>(av[i].y) * wv[t][m - i].y;
                    }
                }
                store16_stream(
                    o + (t * SO + m) * row,
                    barrett_reduce_128(static_cast<uint64_t>(c0),
                                       static_cast<uint64_t>(c0 >> 64), q,
                                       lo, hi),
                    barrett_reduce_128(static_cast<uint64_t>(c1),
                                       static_cast<uint64_t>(c1 >> 64), q,
                                       lo, hi));
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

template <int C>
int tile_contract(void *out, const void *a, const void *w, long long X,
                  long long I, long long Y, int k, int log_n,
                  const void *moduli, const void *cr_lo, const void *cr_hi,
                  cudaStream_t stream) {
    const long long y_tiles = (Y + kTileY - 1) / kTileY;
    const long long j_tiles = ((1LL << log_n) + kTileJ - 1) / kTileJ;
    const long long blocks = y_tiles * X * j_tiles * k;
    if (blocks >= (1LL << 31) || I >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    tile_contract_kernel<C><<<static_cast<unsigned>(blocks), kTileJ, 0,
                              stream>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(w), static_cast<int>(X),
        static_cast<int>(I), static_cast<int>(Y), k, log_n,
        static_cast<int>(y_tiles), static_cast<int>(j_tiles),
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(cr_lo),
        static_cast<const uint64_t *>(cr_hi));
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// a: (X, I, C, k, n), w: (I, Y, k, n), out: (X, Y, C, k, n), words below q;
// moduli, cr_lo, cr_hi: (k,).
extern "C" int troy_tile_contract(void *out, const void *a, const void *w,
                                  long long X, long long I, long long Y,
                                  int C, int k, int log_n, const void *moduli,
                                  const void *cr_lo, const void *cr_hi,
                                  void *stream) {
    if (X < 1 || I < 1 || Y < 1 || k < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (C) {
    case 1: return tile_contract<1>(out, a, w, X, I, Y, k, log_n, moduli,
                                    cr_lo, cr_hi, s);
    case 2: return tile_contract<2>(out, a, w, X, I, Y, k, log_n, moduli,
                                    cr_lo, cr_hi, s);
    case 3: return tile_contract<3>(out, a, w, X, I, Y, k, log_n, moduli,
                                    cr_lo, cr_hi, s);
    case 4: return tile_contract<4>(out, a, w, X, I, Y, k, log_n, moduli,
                                    cr_lo, cr_hi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// a: (X, s1, R, n), w: (Y, s2, R, n), words below 4q; out: (X, Y, s1 + s2
// - 1, R, n); moduli, cr_lo, cr_hi: (R,), one modulus per row; a, w and
// out 16-byte aligned.
extern "C" int troy_tile_pair_convolve(void *out, const void *a,
                                       const void *w, long long X,
                                       long long Y, int s1, int s2, int R,
                                       int log_n, const void *moduli,
                                       const void *cr_lo, const void *cr_hi,
                                       void *stream) {
    if (X < 1 || Y < 1 || s1 < 1 || s2 < 1 || s1 > MAX_COMPS ||
        s2 > MAX_COMPS || R < 1 || R > 65535 || log_n < 1 ||
        ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(a) |
          reinterpret_cast<uintptr_t>(w)) & 15)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    // coefficient blocks a row: 2 kPairThreads words each, a power of two
    const int log_block = 1 + 7;  // log2(2 kPairThreads)
    const int log_cblocks = log_n > log_block ? log_n - log_block : 0;
    const long long y_tiles = (Y + kPairTileY - 1) / kPairTileY;
    const long long blocks = (X * y_tiles) << log_cblocks;
    if (blocks >= (1LL << 31) || X * Y >= (1LL << 31)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    typedef void (*Kernel)(uint64_t *, const uint64_t *, const uint64_t *,
                           int, int, int, int, int, const uint64_t *,
                           const uint64_t *, const uint64_t *);
    static const Kernel kernels[MAX_COMPS][MAX_COMPS] = {
        {tile_pair_convolve_kernel<1, 1>, tile_pair_convolve_kernel<1, 2>,
         tile_pair_convolve_kernel<1, 3>, tile_pair_convolve_kernel<1, 4>},
        {tile_pair_convolve_kernel<2, 1>, tile_pair_convolve_kernel<2, 2>,
         tile_pair_convolve_kernel<2, 3>, tile_pair_convolve_kernel<2, 4>},
        {tile_pair_convolve_kernel<3, 1>, tile_pair_convolve_kernel<3, 2>,
         tile_pair_convolve_kernel<3, 3>, tile_pair_convolve_kernel<3, 4>},
        {tile_pair_convolve_kernel<4, 1>, tile_pair_convolve_kernel<4, 2>,
         tile_pair_convolve_kernel<4, 3>, tile_pair_convolve_kernel<4, 4>}};
    kernels[s1 - 1][s2 - 1]<<<dim3(static_cast<unsigned>(blocks), R),
                              kPairThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(a),
        static_cast<const uint64_t *>(w), static_cast<int>(Y), R, log_n,
        log_cblocks, static_cast<int>(y_tiles),
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
