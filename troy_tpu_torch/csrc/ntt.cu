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
// of a (..., k, n) tensor flatten into rows, so one launch covers every
// polynomial and limb. Round r of the forward transform reads its twiddles
// as root_powers[m : 2m] with their Shoup words (ops/ntt.py:353-361).
//
// What bounds it on the H100: latency, not bandwidth. A whole mult+relin
// works on a few MB that stay in the 50 MB L2, and one 16384-point row is
// 14 dependent rounds of 8192 butterflies. Design: one thread block per
// row keeps the whole row (128 KiB at n = 16384) in dynamic shared memory
// through all log2(n) rounds, so device memory is read and written once
// per row and rounds are separated only by __syncthreads(). This is the
// simple form: with few rows a launch fills few of the 132 SMs; splitting a
// row over several blocks (and n >= 32768, which does not fit) is later
// work.

#include "u64.cuh"

using namespace troy;

namespace {

template <bool kInverse>
__global__ void ntt_rows_kernel(uint64_t *__restrict__ out,
                                const uint64_t *__restrict__ in, int log_n,
                                int k, const uint64_t *__restrict__ roots,
                                const uint64_t *__restrict__ roots_shoup,
                                const uint64_t *__restrict__ moduli,
                                const uint64_t *__restrict__ inv_degree,
                                const uint64_t *__restrict__ inv_degree_shoup,
                                int lazy) {
    extern __shared__ uint64_t v[];
    const int n = 1 << log_n;
    const int half = n >> 1;
    const int64_t row = blockIdx.x;
    const int limb = static_cast<int>(row % k);
    const uint64_t q = moduli[limb];
    const uint64_t q2 = 2 * q;
    const uint64_t *w_tab = roots + static_cast<int64_t>(limb) * n;
    const uint64_t *wq_tab = roots_shoup + static_cast<int64_t>(limb) * n;
    const uint64_t *src = in + row * n;
    uint64_t *dst = out + row * n;

    for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = src[i];
    __syncthreads();

    if (!kInverse) {
        for (int r = 0; r < log_n; ++r) {
            const int m = 1 << r;
            const int log_gap = log_n - r - 1;
            const int gap_mask = (1 << log_gap) - 1;
            for (int b = threadIdx.x; b < half; b += blockDim.x) {
                const int blk = b >> log_gap;
                const int x = (blk << (log_gap + 1)) + (b & gap_mask);
                const int y = x + (1 << log_gap);
                uint64_t a = v[x];
                a = a >= q2 ? a - q2 : a;
                const uint64_t bw = mul_mod_shoup_lazy(v[y], w_tab[m + blk],
                                                       wq_tab[m + blk], q);
                v[x] = a + bw;
                v[y] = a - bw + q2;
            }
            __syncthreads();
        }
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const uint64_t x = v[i];
            dst[i] = lazy ? x : reduce_4q(x, q);
        }
    } else {
        for (int r = log_n - 1; r >= 0; --r) {
            const int m = 1 << r;
            const int log_gap = log_n - r - 1;
            const int gap_mask = (1 << log_gap) - 1;
            for (int b = threadIdx.x; b < half; b += blockDim.x) {
                const int blk = b >> log_gap;
                const int x = (blk << (log_gap + 1)) + (b & gap_mask);
                const int y = x + (1 << log_gap);
                const uint64_t a = v[x];
                const uint64_t c = v[y];
                uint64_t s = a + c;
                s = s >= q2 ? s - q2 : s;
                v[x] = s;
                v[y] = mul_mod_shoup_lazy(a - c + q2, w_tab[m + blk],
                                          wq_tab[m + blk], q);
            }
            __syncthreads();
        }
        const uint64_t iv = inv_degree[limb];
        const uint64_t ivs = inv_degree_shoup[limb];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const uint64_t x = mul_mod_shoup_lazy(v[i], iv, ivs, q);
            dst[i] = lazy ? x : reduce_2q(x, q);
        }
    }
}

}  // namespace

// out, in: (rows, 2^log_n); tables: (k, n) roots (inverse roots for
// inverse=1) and Shoup words; moduli, inv_degree(_shoup): (k,).
extern "C" int troy_ntt(void *out, const void *in, long long rows, int log_n,
                        int k, const void *roots, const void *roots_shoup,
                        const void *moduli, const void *inv_degree,
                        const void *inv_degree_shoup, int inverse, int lazy,
                        void *stream) {
    const int n = 1 << log_n;
    const size_t smem = static_cast<size_t>(n) * sizeof(uint64_t);
    int threads = n / 2 < 1024 ? n / 2 : 1024;
    threads = threads < 32 ? 32 : threads;
    auto kernel = inverse ? ntt_rows_kernel<true> : ntt_rows_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(rows), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        log_n, k, static_cast<const uint64_t *>(roots),
        static_cast<const uint64_t *>(roots_shoup),
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(inv_degree),
        static_cast<const uint64_t *>(inv_degree_shoup), lazy);
    TROY_RETURN_LAUNCH_STATUS();
}
