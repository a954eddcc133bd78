// Kernel E: the BEHZ steps of the BFV multiply and of BFV decryption, each
// one pass over the coefficients with every limb in registers.
//
// Replaces troy_tpu/ops/rns.py:111 fastbconv_m_tilde, :122 sm_mrq (the lift),
// :136 fast_floor and :149 fastbconv_sk (the tail), and the rounding of
// :169 decrypt_scale_and_round (whose conversion q -> {t, gamma} is kernel
// C's). Each entry point runs, word for word, the steps of its plain version
// in troy_tpu_torch/ops/rns.py:
//
//   behz_lift (s, k, n) -> (s, |Bsk|, n):
//     temp_i = (x_i * m~ mod q_i) * inv_punctured_i mod q_i     (Shoup, Shoup)
//     c_o    = sum_i temp_i * M[o][i] mod p_o   for p_o in Bsk u {m~}
//     r      = c_m~ * (-Q^-1 mod m~) mod m~
//     out_o  = ((r or r + b_o - m~) * (Q mod b_o) + c_o) * m~^-1 mod b_o
//   behz_tail (s, k + |Bsk|, n) -> (s, k, n), the BFV product's rows in q and
//   Bsk, first scaled by t:
//     floor_o = (x_o t + b_o - conv_q->Bsk(x_q t)_o) * Q^-1 mod b_o
//     alpha   = (conv_B->m_sk(floor_B) + m_sk - floor_m_sk) * B^-1 mod m_sk
//     out_i   = conv_B->q(floor_B)_i + (alpha > m_sk/2 ? (m_sk - alpha) B
//                                                      : alpha (q_i - B)) mod q_i
//   behz_decrypt_round (s, 2, n) -> (s, n) mod t, the gamma trick on the
//   phase's residues mod t and gamma:
//     v_t, v_g = x_t * (-Q^-1) mod t, x_gamma * (-Q^-1) mod gamma
//     out = (v_t +/- (v_g or gamma - v_g) mod t) * gamma^-1 mod t
//
// The constants of one context level are one small tensor per entry point,
// in the order the kernels read them (ops/rns.py DeviceRnsTool documents the
// layout); a block copies them to shared memory once.
//
// What bounds it on the H100: latency. A coefficient's lift or tail is a
// few base conversions, chains of k dependent 64-bit products each, over
// a few hundred bytes; at the headline's (3, 5 + 7, 16384) the tail moves
// 1.2 MB and does 0.6 M products, 1.9 us at the card's rates. One thread a
// coefficient holding every limb in registers (20-word arrays, about 150
// registers) left one block of 8 warps an SM, each running chains of
// about 170 dependent products, 36-43 us.
//
// Design: the lift and the tail are tiled over limbs. A block takes a
// tile of T = 64 coefficients of one polynomial with all its limbs: it
// loads the limbs' rows of the tile coalesced into shared memory (times
// m~ and the punctured inverse for the lift; times t for the tail, the
// q rows also by their punctured inverse), then runs each base conversion
// as small matrix-vector products whose (output limb, coefficient) items
// spread over the block's 256 threads, each step's outputs kept in shared
// memory between barriers:
//   lift: the m~ row and r, once a coefficient -> the Bsk outputs;
//   tail: the floor in Bsk (and its punctured words, in place) -> alpha
//   from the m_sk row, once a coefficient -> the outputs in q with the
//   Shenoy-Kumaresan correction, stored coalesced.
// No thread holds a limb array, so several blocks share an SM and the
// grid is a wave or two deep. The decrypt rounding keeps one thread a
// coefficient (two words in, one out), its arithmetic decrypt.cuh's,
// shared with ACi (C and this rounding in kernel A's last inverse pass,
// ntt.cu), which A's route runs. The Montgomery step's branch (on
// r >= m~/2, with m~ = 2^32 and wrapping u64 words) and Shenoy-Kumaresan's
// (on the value alpha > m_sk/2) are selects on values, as in the plain
// version.

#include "decrypt.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 20;   // per base, m~ included, as kernel C
constexpr int LOG_TILE = 6;     // coefficients a block (fewer if n is)
constexpr int THREADS = 256;

// Reads consecutive runs of constants out of shared memory.
struct Cursor {
    const uint64_t *p;
    __device__ __forceinline__ const uint64_t *take(int count) {
        const uint64_t *r = p;
        p += count;
        return r;
    }
};

// One base converter's constants (ops/rns.py DeviceConverter layout).
struct Converter {
    const uint64_t *q_in, *invp, *invp_shoup, *p_out, *cr_lo, *cr_hi, *mat;
    int k_in;
    __device__ Converter(Cursor &c, int k_in_, int k_out) : k_in(k_in_) {
        q_in = c.take(k_in);
        invp = c.take(k_in);
        invp_shoup = c.take(k_in);
        p_out = c.take(k_out);
        cr_lo = c.take(k_out);
        cr_hi = c.take(k_out);
        mat = c.take(k_out * k_in);
    }
    // temp_j = x * inv_punctured_j mod q_j
    __device__ __forceinline__ uint64_t punctured(uint64_t x, int j) const {
        return mul_mod_shoup(x, invp[j], invp_shoup[j], q_in[j]);
    }
    // sum_j temp_j * M[o][j] mod p_o, temp_j at temp[j * stride]
    __device__ __forceinline__ uint64_t output(const uint64_t *temp,
                                               int stride, int o) const {
        const uint64_t *row = mat + o * k_in;
        u128 acc = 0;
#pragma unroll 4
        for (int j = 0; j < k_in; ++j) {
            acc += static_cast<u128>(temp[j * stride]) * row[j];
        }
        return barrett_reduce_128(static_cast<uint64_t>(acc),
                                  static_cast<uint64_t>(acc >> 64), p_out[o],
                                  cr_lo[o], cr_hi[o]);
    }
};

__device__ __forceinline__ void load_consts(uint64_t *shared,
                                            const uint64_t *consts,
                                            int count) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) shared[i] = consts[i];
}

// The block's polynomial and first coefficient: tiles of 2^log_t words,
// 2^(log_n - log_t) a polynomial.
struct Tile {
    int64_t poly;
    int c0;
};

__device__ __forceinline__ Tile tile_of(int log_n, int log_t) {
    const int per_poly = log_n - log_t;
    return {static_cast<int64_t>(blockIdx.x >> per_poly),
            static_cast<int>(blockIdx.x & ((1u << per_poly) - 1)) << log_t};
}

__global__ void __launch_bounds__(THREADS)
behz_lift_kernel(uint64_t *__restrict__ out, const uint64_t *__restrict__ in,
                 int k, int nb, int log_n, int log_t,
                 const uint64_t *__restrict__ consts, int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    const int T = 1 << log_t;
    uint64_t *s_temp = shared + n_consts;       // k x T punctured temps
    uint64_t *s_r = s_temp + k * T;             // T words: r
    const Tile tile = tile_of(log_n, log_t);
    const uint64_t *src = in + ((tile.poly * k) << log_n) + tile.c0;
    uint64_t *dst = out + ((tile.poly * nb) << log_n) + tile.c0;
    __syncthreads();
    Cursor c{shared};
    const Converter conv(c, k, nb + 1);           // q -> Bsk u {m~}
    const uint64_t *mt = c.take(k), *mt_shoup = c.take(k);
    const uint64_t *ninv = c.take(2);             // -Q^-1 mod m~, Shoup
    const uint64_t *pq = c.take(nb), *pq_shoup = c.take(nb);
    const uint64_t *imt = c.take(nb), *imt_shoup = c.take(nb);
    const uint64_t m_tilde = conv.p_out[nb];

    // the q rows, times m~, times the punctured inverses
    for (int f = threadIdx.x; f < k << log_t; f += THREADS) {
        const int j = f >> log_t, i = f & (T - 1);
        const uint64_t x = mul_mod_shoup(
            src[(static_cast<int64_t>(j) << log_n) + i], mt[j], mt_shoup[j],
            conv.q_in[j]);
        s_temp[f] = conv.punctured(x, j);
    }
    __syncthreads();
    // the m~ row, then r, once a coefficient
    for (int i = threadIdx.x; i < T; i += THREADS) {
        s_r[i] = mul_mod_shoup(conv.output(s_temp + i, T, nb), ninv[0],
                               ninv[1], m_tilde);
    }
    __syncthreads();
    for (int f = threadIdx.x; f < nb << log_t; f += THREADS) {
        const int o = f >> log_t, i = f & (T - 1);
        const uint64_t b = conv.p_out[o];
        const uint64_t r = s_r[i];
        const uint64_t centered = r >= (m_tilde >> 1) ? r + (b - m_tilde) : r;
        const uint64_t d =
            add_mod(mul_mod_shoup(centered, pq[o], pq_shoup[o], b),
                    conv.output(s_temp + i, T, o), b);
        dst[(static_cast<int64_t>(o) << log_n) + i] =
            mul_mod_shoup(d, imt[o], imt_shoup[o], b);
    }
}

__global__ void __launch_bounds__(THREADS)
behz_tail_kernel(uint64_t *__restrict__ out, const uint64_t *__restrict__ in,
                 int k, int nb, int log_n, int log_t,
                 const uint64_t *__restrict__ consts, int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    const int T = 1 << log_t;
    const int n_b = nb - 1;                       // |B|
    uint64_t *s_temp = shared + n_consts;         // k x T, then alpha
    uint64_t *s_b = s_temp + k * T;               // nb x T
    const Tile tile = tile_of(log_n, log_t);
    const uint64_t *src = in + ((tile.poly * (k + nb)) << log_n) + tile.c0;
    uint64_t *dst = out + ((tile.poly * k) << log_n) + tile.c0;
    __syncthreads();
    Cursor c{shared};
    const uint64_t *tq = c.take(k), *tq_shoup = c.take(k);
    const uint64_t *tb = c.take(nb), *tb_shoup = c.take(nb);
    const Converter q_to_bsk(c, k, nb);
    const uint64_t *ipq = c.take(nb), *ipq_shoup = c.take(nb);
    const Converter b_to_q_msk(c, n_b, k + 1);    // B -> q u {m_sk}
    const uint64_t *ipb = c.take(2);              // B^-1 mod m_sk, Shoup
    const uint64_t *pb = c.take(k), *pb_shoup = c.take(k);
    const uint64_t *npb = c.take(k), *npb_shoup = c.take(k);
    const uint64_t m_sk = b_to_q_msk.p_out[k];

    // every row times t; the q rows also times their punctured inverses
    for (int f = threadIdx.x; f < (k + nb) << log_t; f += THREADS) {
        const int j = f >> log_t, i = f & (T - 1);
        const uint64_t w = src[(static_cast<int64_t>(j) << log_n) + i];
        if (j < k) {
            const uint64_t q = q_to_bsk.q_in[j];
            s_temp[f] = q_to_bsk.punctured(
                mul_mod_shoup(w, tq[j], tq_shoup[j], q), j);
        } else {
            const int o = j - k;
            s_b[f - (k << log_t)] =
                mul_mod_shoup(w, tb[o], tb_shoup[o], q_to_bsk.p_out[o]);
        }
    }
    __syncthreads();
    // floor(x t / Q) in Bsk; B's rows then by their punctured inverses
    // (for B -> q u {m_sk}), the m_sk row kept: each item in place
    for (int f = threadIdx.x; f < nb << log_t; f += THREADS) {
        const int o = f >> log_t, i = f & (T - 1);
        const uint64_t b = q_to_bsk.p_out[o];
        const uint64_t diff = s_b[f] + (b - q_to_bsk.output(s_temp + i, T, o));
        const uint64_t floored = mul_mod_shoup(diff, ipq[o], ipq_shoup[o], b);
        s_b[f] = o < n_b ? b_to_q_msk.punctured(floored, o) : floored;
    }
    __syncthreads();
    // alpha from the m_sk row, once a coefficient (over the temps)
    uint64_t *s_alpha = s_temp;
    for (int i = threadIdx.x; i < T; i += THREADS) {
        s_alpha[i] = mul_mod_shoup(
            b_to_q_msk.output(s_b + i, T, k) + (m_sk - s_b[(n_b << log_t) + i]),
            ipb[0], ipb[1], m_sk);
    }
    __syncthreads();
    for (int f = threadIdx.x; f < k << log_t; f += THREADS) {
        const int o = f >> log_t, i = f & (T - 1);
        const uint64_t q = b_to_q_msk.p_out[o];
        const uint64_t alpha = s_alpha[i];
        const uint64_t corr =
            alpha > (m_sk >> 1)
                ? mul_mod_shoup(m_sk - alpha, pb[o], pb_shoup[o], q)
                : mul_mod_shoup(alpha, npb[o], npb_shoup[o], q);
        dst[(static_cast<int64_t>(o) << log_n) + i] =
            add_mod(b_to_q_msk.output(s_b + i, T, o), corr, q);
    }
}

__global__ void behz_decrypt_round_kernel(uint64_t *__restrict__ out,
                                          const uint64_t *__restrict__ in,
                                          int64_t batch, int log_n,
                                          const uint64_t *__restrict__ consts,
                                          int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    __syncthreads();
    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = in + ((poly * 2) << log_n) + i;
        out[idx] = decrypt_round(src[0], src[n], shared);
    }
}

int launch_status_for(int k, int nb) {
    return (k < 1 || k > MAX_LIMBS || nb < 2 || nb + 1 > MAX_LIMBS)
               ? static_cast<int>(cudaErrorInvalidValue)
               : 0;
}

typedef void (*TileKernel)(uint64_t *, const uint64_t *, int, int, int, int,
                           const uint64_t *, int);

// One tiled launch: 2^(log_n - log_t) blocks a polynomial, the constants
// and `rows` words a coefficient of shared memory.
int launch_tiled(TileKernel kernel, void *out, const void *in,
                 long long batch, int k, int nb, int log_n, int rows,
                 const void *consts, int n_consts, void *stream) {
    const int log_t = log_n < LOG_TILE ? log_n : LOG_TILE;
    const long long blocks = batch << (log_n - log_t);
    if (log_n < 0 || log_n > 30 || blocks < 1 || blocks > 0x7FFFFFFFLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem =
        sizeof(uint64_t) * (static_cast<size_t>(n_consts) +
                            (static_cast<size_t>(rows) << log_t));
    if (smem > (48 << 10)) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), k,
        nb, log_n, log_t, static_cast<const uint64_t *>(consts), n_consts);
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// in: (batch, k, 2^log_n), out: (batch, nb, 2^log_n); consts: n_consts
// words (ops/rns.py DeviceRnsTool.lift_consts).
extern "C" int troy_behz_lift(void *out, const void *in, long long batch,
                              int k, int nb, int log_n, const void *consts,
                              int n_consts, void *stream) {
    if (int bad = launch_status_for(k, nb)) return bad;
    return launch_tiled(behz_lift_kernel, out, in, batch, k, nb, log_n,
                        k + 1, consts, n_consts, stream);
}

// in: (batch, k + nb, 2^log_n), rows in q then in Bsk; out: (batch, k,
// 2^log_n); consts: DeviceRnsTool.tail_consts.
extern "C" int troy_behz_tail(void *out, const void *in, long long batch,
                              int k, int nb, int log_n, const void *consts,
                              int n_consts, void *stream) {
    if (int bad = launch_status_for(k, nb)) return bad;
    return launch_tiled(behz_tail_kernel, out, in, batch, k, nb, log_n,
                        k + nb, consts, n_consts, stream);
}

// in: (batch, 2, 2^log_n), residues mod t and gamma; out: (batch, 2^log_n)
// mod t; consts: the 9 words of DeviceRnsTool.decrypt_consts.
extern "C" int troy_behz_decrypt_round(void *out, const void *in,
                                       long long batch, int log_n,
                                       const void *consts, int n_consts,
                                       void *stream) {
    if (n_consts != kRoundConsts) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    behz_decrypt_round_kernel<<<grid_blocks(batch << log_n, threads), threads,
                                n_consts * sizeof(uint64_t),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), batch,
        log_n, static_cast<const uint64_t *>(consts), n_consts);
    TROY_RETURN_LAUNCH_STATUS();
}
