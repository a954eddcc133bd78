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
// What bounds it on the H100: at n = 16384 nothing but the launch (a few MB
// of words, a few hundred integer products per coefficient). Design: one
// thread per coefficient of one polynomial, so each input word is read once
// and each output word written once, coalesced across the warp; the
// Montgomery step's branch (on r >= m~/2, with m~ = 2^32 and wrapping u64
// words) and Shenoy-Kumaresan's (on the value alpha > m_sk/2) are selects on
// values, as in the plain version.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int MAX_LIMBS = 20;   // per base, m~ included, as kernel C

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
    // temp_i = x_i * inv_punctured_i mod q_i
    __device__ __forceinline__ void punctured(const uint64_t *x,
                                              uint64_t *temp) const {
#pragma unroll
        for (int j = 0; j < MAX_LIMBS; ++j) {
            if (j < k_in) {
                temp[j] = mul_mod_shoup(x[j], invp[j], invp_shoup[j], q_in[j]);
            }
        }
    }
    // sum_i temp_i * M[o][i] mod p_o
    __device__ __forceinline__ uint64_t output(const uint64_t *temp,
                                               int o) const {
        const uint64_t *row = mat + o * k_in;
        u128 acc = 0;
#pragma unroll
        for (int j = 0; j < MAX_LIMBS; ++j) {
            if (j < k_in) acc += static_cast<u128>(temp[j]) * row[j];
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
    __syncthreads();
}

__global__ void behz_lift_kernel(uint64_t *__restrict__ out,
                                 const uint64_t *__restrict__ in,
                                 int64_t batch, int k, int nb, int log_n,
                                 const uint64_t *__restrict__ consts,
                                 int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    Cursor c{shared};
    const Converter conv(c, k, nb + 1);           // q -> Bsk u {m~}
    const uint64_t *mt = c.take(k), *mt_shoup = c.take(k);
    const uint64_t *ninv = c.take(2);             // -Q^-1 mod m~, Shoup
    const uint64_t *pq = c.take(nb), *pq_shoup = c.take(nb);
    const uint64_t *imt = c.take(nb), *imt_shoup = c.take(nb);
    const uint64_t m_tilde = conv.p_out[nb];

    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = in + ((poly * k) << log_n) + i;
        uint64_t *dst = out + ((poly * nb) << log_n) + i;
        uint64_t x[MAX_LIMBS], temp[MAX_LIMBS];
#pragma unroll
        for (int j = 0; j < MAX_LIMBS; ++j) {
            if (j < k) {
                x[j] = mul_mod_shoup(src[static_cast<int64_t>(j) << log_n],
                                     mt[j], mt_shoup[j], conv.q_in[j]);
            }
        }
        conv.punctured(x, temp);
        const uint64_t r = mul_mod_shoup(conv.output(temp, nb), ninv[0],
                                         ninv[1], m_tilde);
        for (int o = 0; o < nb; ++o) {
            const uint64_t b = conv.p_out[o];
            const uint64_t centered = r >= (m_tilde >> 1) ? r + (b - m_tilde)
                                                          : r;
            const uint64_t d = add_mod(
                mul_mod_shoup(centered, pq[o], pq_shoup[o], b),
                conv.output(temp, o), b);
            dst[static_cast<int64_t>(o) << log_n] =
                mul_mod_shoup(d, imt[o], imt_shoup[o], b);
        }
    }
}

__global__ void behz_tail_kernel(uint64_t *__restrict__ out,
                                 const uint64_t *__restrict__ in,
                                 int64_t batch, int k, int nb, int log_n,
                                 const uint64_t *__restrict__ consts,
                                 int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    const int n_b = nb - 1;                       // |B|
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

    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = in + ((poly * (k + nb)) << log_n) + i;
        uint64_t *dst = out + ((poly * k) << log_n) + i;
        uint64_t x[MAX_LIMBS], temp[MAX_LIMBS];
#pragma unroll
        for (int j = 0; j < MAX_LIMBS; ++j) {
            if (j < k) {
                x[j] = mul_mod_shoup(src[static_cast<int64_t>(j) << log_n],
                                     tq[j], tq_shoup[j], q_to_bsk.q_in[j]);
            }
        }
        q_to_bsk.punctured(x, temp);
        uint64_t floored[MAX_LIMBS];              // floor(x t / Q) in Bsk
#pragma unroll
        for (int o = 0; o < MAX_LIMBS; ++o) {
            if (o < nb) {
                const uint64_t b = q_to_bsk.p_out[o];
                const uint64_t xb = mul_mod_shoup(
                    src[static_cast<int64_t>(k + o) << log_n], tb[o],
                    tb_shoup[o], b);
                const uint64_t diff = xb + (b - q_to_bsk.output(temp, o));
                floored[o] = mul_mod_shoup(diff, ipq[o], ipq_shoup[o], b);
            }
        }
        b_to_q_msk.punctured(floored, temp);
        const uint64_t alpha = mul_mod_shoup(
            b_to_q_msk.output(temp, k) + (m_sk - floored[n_b]), ipb[0],
            ipb[1], m_sk);
        const bool negative = alpha > (m_sk >> 1);
        for (int o = 0; o < k; ++o) {
            const uint64_t q = b_to_q_msk.p_out[o];
            const uint64_t corr =
                negative ? mul_mod_shoup(m_sk - alpha, pb[o], pb_shoup[o], q)
                         : mul_mod_shoup(alpha, npb[o], npb_shoup[o], q);
            dst[static_cast<int64_t>(o) << log_n] =
                add_mod(b_to_q_msk.output(temp, o), corr, q);
        }
    }
}

__global__ void behz_decrypt_round_kernel(uint64_t *__restrict__ out,
                                          const uint64_t *__restrict__ in,
                                          int64_t batch, int log_n,
                                          const uint64_t *__restrict__ consts,
                                          int n_consts) {
    extern __shared__ uint64_t shared[];
    load_consts(shared, consts, n_consts);
    // -Q^-1 mod t and mod gamma with their Shoup words, the high Barrett
    // word of t, gamma^-1 mod t with its Shoup word, t, gamma
    const uint64_t *c = shared;
    const uint64_t t = c[7], gamma = c[8];

    const int64_t n = int64_t(1) << log_n;
    const int64_t total = batch << log_n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < total; idx += stride) {
        const int64_t poly = idx >> log_n;
        const int64_t i = idx & (n - 1);
        const uint64_t *src = in + ((poly * 2) << log_n) + i;
        const uint64_t vt = mul_mod_shoup(src[0], c[0], c[1], t);
        const uint64_t vg = mul_mod_shoup(src[n], c[2], c[3], gamma);
        const uint64_t corrected =
            vg > (gamma >> 1)
                ? add_mod(vt, barrett_reduce_64(gamma - vg, t, c[4]), t)
                : sub_mod(vt, barrett_reduce_64(vg, t, c[4]), t);
        out[idx] = mul_mod_shoup(corrected, c[5], c[6], t);
    }
}

int launch_status_for(int k, int nb) {
    return (k < 1 || k > MAX_LIMBS || nb < 2 || nb + 1 > MAX_LIMBS)
               ? static_cast<int>(cudaErrorInvalidValue)
               : 0;
}

}  // namespace

// in: (batch, k, 2^log_n), out: (batch, nb, 2^log_n); consts: n_consts
// words (ops/rns.py DeviceRnsTool.lift_consts).
extern "C" int troy_behz_lift(void *out, const void *in, long long batch,
                              int k, int nb, int log_n, const void *consts,
                              int n_consts, void *stream) {
    if (int bad = launch_status_for(k, nb)) return bad;
    const int threads = 256;
    behz_lift_kernel<<<grid_blocks(batch << log_n, threads), threads,
                       n_consts * sizeof(uint64_t),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), batch,
        k, nb, log_n, static_cast<const uint64_t *>(consts), n_consts);
    TROY_RETURN_LAUNCH_STATUS();
}

// in: (batch, k + nb, 2^log_n), rows in q then in Bsk; out: (batch, k,
// 2^log_n); consts: DeviceRnsTool.tail_consts.
extern "C" int troy_behz_tail(void *out, const void *in, long long batch,
                              int k, int nb, int log_n, const void *consts,
                              int n_consts, void *stream) {
    if (int bad = launch_status_for(k, nb)) return bad;
    const int threads = 256;
    behz_tail_kernel<<<grid_blocks(batch << log_n, threads), threads,
                       n_consts * sizeof(uint64_t),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), batch,
        k, nb, log_n, static_cast<const uint64_t *>(consts), n_consts);
    TROY_RETURN_LAUNCH_STATUS();
}

// in: (batch, 2, 2^log_n), residues mod t and gamma; out: (batch, 2^log_n)
// mod t; consts: the 9 words of DeviceRnsTool.decrypt_consts.
extern "C" int troy_behz_decrypt_round(void *out, const void *in,
                                       long long batch, int log_n,
                                       const void *consts, int n_consts,
                                       void *stream) {
    if (n_consts != 9) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    behz_decrypt_round_kernel<<<grid_blocks(batch << log_n, threads), threads,
                                n_consts * sizeof(uint64_t),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in), batch,
        log_n, static_cast<const uint64_t *>(consts), n_consts);
    TROY_RETURN_LAUNCH_STATUS();
}
