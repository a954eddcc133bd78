// Kernel D: per-limb modular add, sub, negate and Shoup scalar multiply,
// and the fused finishes of the zero encryptions, the switching-key rows
// and BGV's balanced add.
//
// Replaces troy_tpu/ops/poly.py:36 rns_add, :42 rns_sub, :48 rns_neg and
// :53 rns_scalar_mul (with :65 rns_broadcast_scalar_mul on top), and their
// chains: troy_tpu/rlwe.py:125-131 (the symmetric zero encryption's
// neg(add)) with the plaintext's add of troy_tpu/encryptor.py:29-49,
// rlwe.py:327-330 (the public-key one's add), troy_tpu/keygen.py:47-54 (P w
// onto c0's limb j of row j) and troy_tpu/evaluator.py:874-883 (e1 a +- e2
// b). Every form gives the words of the composition it replaces: each
// step is canonical arithmetic on reduced words.
//
// Data: groups of (k, n) rows, group g of x, y and c1 at g k n, of out at
// g out_stride (a ciphertext's c0 inside (B, 2, k, n) has stride 2 k n),
// of m at g m_stride; the per-limb modulus and constants are (k,).
//   kAdd, kSub, kNeg, kScalarMul: out = x + y, x - y, -x, x w1;
//   kZeroSym: out = m - (x + y) (m = 0 where absent), and c1 copied into
//      the component after out's (out + k n) where given;
//   kZeroAsym: out = x + y, + m on group 0 only (the public-key
//      encryption's c0);
//   kKeyRows: out = m_g w1 - (x + y) on limb g of group g (m_g a row of n
//      words, w1 = P mod q_i, Shoup), -(x + y) on the other limbs; c1
//      copied as for kZeroSym;
//   kBalancedAdd, kBalancedSub: out = x w1 +- y w2.
//
// What bounds it on the H100: bytes; two to four words in, one or two
// out, a few integer operations each. Design: one kernel with an op code;
// a 3-D grid of coefficient tiles, limbs (blockIdx.y, so no thread
// divides) and groups; two words a thread through 16-byte loads and
// stores; one launch for a whole chain of the old steps, so the finish of
// an encryption or a key is one launch and writes where the ciphertext
// or key wants its words.

#include "u64.cuh"

using namespace troy;

namespace {

enum Op {
    kAdd = 0, kSub = 1, kNeg = 2, kScalarMul = 3, kZeroSym = 4,
    kZeroAsym = 5, kKeyRows = 6, kBalancedAdd = 7, kBalancedSub = 8
};

constexpr int kThreads = 128;        // two words a thread
constexpr unsigned kMaxGridZ = 65535;

__device__ __forceinline__ ulonglong2 load2(const uint64_t *p) {
    return *reinterpret_cast<const ulonglong2 *>(p);
}

__device__ __forceinline__ void store2(uint64_t *p, uint64_t a, uint64_t b) {
    *reinterpret_cast<ulonglong2 *>(p) = make_ulonglong2(a, b);
}

// One word of op at limb i of group g (z = x + y where the op needs it).
__device__ __forceinline__ uint64_t apply(int op, uint64_t x, uint64_t y,
                                          uint64_t m, uint64_t q,
                                          uint64_t w1, uint64_t w1q,
                                          uint64_t w2, uint64_t w2q) {
    switch (op) {
        case kAdd: return add_mod(x, y, q);
        case kSub: return sub_mod(x, y, q);
        case kNeg: return neg_mod(x, q);
        case kScalarMul: return mul_mod_shoup(x, w1, w1q, q);
        case kZeroSym:
        case kKeyRows: return sub_mod(m, add_mod(x, y, q), q);
        case kZeroAsym: return add_mod(add_mod(x, y, q), m, q);
        case kBalancedAdd:
            return add_mod(mul_mod_shoup(x, w1, w1q, q),
                           mul_mod_shoup(y, w2, w2q, q), q);
        default:
            return sub_mod(mul_mod_shoup(x, w1, w1q, q),
                           mul_mod_shoup(y, w2, w2q, q), q);
    }
}

// out and x may be the same words (an in-place finish): neither is
// __restrict__.
__global__ void rns_elementwise_kernel(
        uint64_t *out, int64_t out_stride, const uint64_t *x,
        const uint64_t *__restrict__ y, const uint64_t *__restrict__ m,
        int64_t m_stride, int64_t m_groups, const uint64_t *__restrict__ c1,
        int op, int64_t groups, int k, int log_n,
        const uint64_t *__restrict__ moduli, const uint64_t *__restrict__ w1,
        const uint64_t *__restrict__ w1_shoup,
        const uint64_t *__restrict__ w2,
        const uint64_t *__restrict__ w2_shoup) {
    const int64_t c = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                           threadIdx.x);
    if (c >= (int64_t{1} << log_n)) return;
    const int i = blockIdx.y;
    const uint64_t q = __ldg(moduli + i);
    const bool scaled = op == kScalarMul || op == kKeyRows ||
                        op == kBalancedAdd || op == kBalancedSub;
    const uint64_t a1 = scaled ? __ldg(w1 + i) : 0;
    const uint64_t a1q = scaled ? __ldg(w1_shoup + i) : 0;
    const bool balanced = op == kBalancedAdd || op == kBalancedSub;
    const uint64_t a2 = balanced ? __ldg(w2 + i) : 0;
    const uint64_t a2q = balanced ? __ldg(w2_shoup + i) : 0;
    const bool has_y = op != kNeg && op != kScalarMul;
    const int64_t row = static_cast<int64_t>(i) << log_n;
    const int64_t kn = static_cast<int64_t>(k) << log_n;
    for (int64_t g = blockIdx.z; g < groups; g += gridDim.z) {
        const int64_t at = g * kn + row + c;
        const ulonglong2 xv = load2(x + at);
        const ulonglong2 yv = has_y ? load2(y + at) : make_ulonglong2(0, 0);
        ulonglong2 mv = make_ulonglong2(0, 0);
        if (op == kKeyRows) {
            if (i == g) {
                const ulonglong2 t = load2(m + g * m_stride + c);
                mv = make_ulonglong2(mul_mod_shoup(t.x, a1, a1q, q),
                                     mul_mod_shoup(t.y, a1, a1q, q));
            }
        } else if (m && g < m_groups) {
            mv = load2(m + g * m_stride + row + c);
        }
        uint64_t *dst = out + g * out_stride + row + c;
        store2(dst, apply(op, xv.x, yv.x, mv.x, q, a1, a1q, a2, a2q),
               apply(op, xv.y, yv.y, mv.y, q, a1, a1q, a2, a2q));
        if (c1) {
            const ulonglong2 v = load2(c1 + at);
            store2(dst + kn, v.x, v.y);
        }
    }
}

}  // namespace

// out: groups (k, 2^log_n) rows at out_stride words; x, y, c1: (groups,
// k, 2^log_n) contiguous (y unused for neg and the scalar multiply, c1
// NULL for no copy); m: groups at m_stride words, used on the first
// m_groups (NULL for none); moduli, w1, w1_shoup, w2, w2_shoup: (k,), w1
// for the scalar multiply, the key rows and the balanced add, w2 for the
// balanced add (NULL otherwise). Every pointer and stride 16-byte aligned.
extern "C" int troy_rns_elementwise(void *out, long long out_stride,
                                    const void *x, const void *y,
                                    const void *m, long long m_stride,
                                    long long m_groups, const void *c1,
                                    int op, long long groups, int k,
                                    int log_n, const void *moduli,
                                    const void *w1, const void *w1_shoup,
                                    const void *w2, const void *w2_shoup,
                                    void *stream) {
    if (op < kAdd || op > kBalancedSub || groups < 1 || k < 1 ||
        k > 65535 || log_n < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long half = 1ll << (log_n - 1);
    const dim3 grid(static_cast<unsigned>((half + kThreads - 1) / kThreads),
                    static_cast<unsigned>(k),
                    static_cast<unsigned>(groups < kMaxGridZ ? groups
                                                             : kMaxGridZ));
    rns_elementwise_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), out_stride,
        static_cast<const uint64_t *>(x), static_cast<const uint64_t *>(y),
        static_cast<const uint64_t *>(m), m_stride, m_groups,
        static_cast<const uint64_t *>(c1), op, groups, k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<const uint64_t *>(w1),
        static_cast<const uint64_t *>(w1_shoup),
        static_cast<const uint64_t *>(w2),
        static_cast<const uint64_t *>(w2_shoup));
    TROY_RETURN_LAUNCH_STATUS();
}
