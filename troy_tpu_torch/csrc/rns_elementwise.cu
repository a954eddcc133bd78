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
//
// DG (troy_rns_zero_embed) and G (troy_bfv_plain_embed): the BFV plain
// embedding round(Q m / t) (troy_tpu/ops/poly.py:98
// bfv_multiply_add_plain, plain_embed.cuh's arithmetic) on D's grid, in
// kernels of their own compiled for each form (zero_embed_kernel<kForm>
// and plain_embed_kernel<kForm> on one body), so that the 128-bit steps
// leave D's instance as it was:
//   kEmbedSym (DG): out = embed(m) - (x + y), c1 copied as kZeroSym: the
//      BFV symmetric zero encryption's finish with its plaintext, the
//      words of D's kZeroSym then G's add (troy_tpu/encryptor.py:29,
//      troy_tpu/rlwe.py:125-131);
//   kEmbedAsym (DG): out = x + y, + embed(m) on group 0 (the public-key
//      finish, troy_tpu/rlwe.py:327-330, with the plaintext);
//   kEmbedAdd, kEmbedSub (G): out = x +- embed(m), the components after
//      c0 copied from c1 (BFV add_plain and sub_plain, the host-sampling
//      encrypt's embed).
// m is one row of n words mod t a group, read at m_stride. A limb's block
// computes fix for its two coefficients itself (no state across limbs);
// every load of a thread is issued before the 128-bit Barrett step, and
// out may be x (in place), so neither is __restrict__. What bounds it:
// bytes at a batch, the launch at one encryption (n = 16384: 1.4 MB), so
// one launch does the whole finish and its words go straight into the
// ciphertext.

#include "plain_embed.cuh"

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

enum EmbedForm { kEmbedSym = 0, kEmbedAsym = 1, kEmbedAdd = 2,
                 kEmbedSub = 3 };

// consts: EmbedLayout (plain_embed.cuh). x's and y's groups at k n words,
// out's at out_stride, m's rows at m_stride, c1's at c1_stride, each with
// `copies` components copied into the components after out's (c1 must not
// overlap x: a thread stores its copies after its own words).
template <int kForm>
__device__ __forceinline__ void embed_body(
        uint64_t *out, int64_t out_stride, const uint64_t *x,
        const uint64_t *__restrict__ y, const uint64_t *__restrict__ m,
        int64_t m_stride, const uint64_t *__restrict__ c1,
        int64_t c1_stride, int copies, int64_t groups, int k, int log_n,
        const uint64_t *__restrict__ consts) {
    const int64_t c = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                           threadIdx.x);
    if (c >= (int64_t{1} << log_n)) return;
    const int i = blockIdx.y;
    const EmbedLayout L{k};
    const EmbedT et = embed_t(consts);
    const uint64_t q = __ldg(consts + L.q() + i);
    const uint64_t cr_hi = __ldg(consts + L.cr_hi() + i);
    const uint64_t d = __ldg(consts + L.d() + i);
    const uint64_t d_shoup = __ldg(consts + L.d_shoup() + i);
    const bool small = et.t <= q;
    constexpr bool kHasY = kForm == kEmbedSym || kForm == kEmbedAsym;
    const int64_t row = static_cast<int64_t>(i) << log_n;
    const int64_t kn = static_cast<int64_t>(k) << log_n;
    for (int64_t g = blockIdx.z; g < groups; g += gridDim.z) {
        const int64_t at = g * kn + row + c;
        const bool embeds = kForm != kEmbedAsym || g == 0;
        // m first: fix needs only m, so it can start while x and y load
        const ulonglong2 mv = embeds ? load2(m + g * m_stride + c)
                                     : make_ulonglong2(0, 0);
        const ulonglong2 xv = load2(x + at);
        const ulonglong2 yv = kHasY ? load2(y + at) : make_ulonglong2(0, 0);
        const uint64_t *src =
            copies > 0 ? c1 + g * c1_stride + row + c : nullptr;
        const ulonglong2 cv = src ? load2(src) : make_ulonglong2(0, 0);
        uint64_t *dst = out + g * out_stride + row + c;
        uint64_t t0 = 0, t1 = 0;
        if (embeds) {
            t0 = embed_limb(mv.x, embed_fix(mv.x, et), q, cr_hi, d, d_shoup,
                            small);
            t1 = embed_limb(mv.y, embed_fix(mv.y, et), q, cr_hi, d, d_shoup,
                            small);
        }
        if constexpr (kForm == kEmbedSym) {
            store2(dst, sub_mod(t0, add_mod(xv.x, yv.x, q), q),
                   sub_mod(t1, add_mod(xv.y, yv.y, q), q));
        } else if constexpr (kForm == kEmbedAsym) {
            store2(dst, add_mod(add_mod(xv.x, yv.x, q), t0, q),
                   add_mod(add_mod(xv.y, yv.y, q), t1, q));
        } else if constexpr (kForm == kEmbedAdd) {
            store2(dst, add_mod(xv.x, t0, q), add_mod(xv.y, t1, q));
        } else {
            store2(dst, sub_mod(xv.x, t0, q), sub_mod(xv.y, t1, q));
        }
        if (src) {
            store2(dst + kn, cv.x, cv.y);
            for (int j = 1; j < copies; ++j) {
                const ulonglong2 v = load2(src + j * kn);
                store2(dst + (j + 1) * kn, v.x, v.y);
            }
        }
    }
}

#define TROY_EMBED_PARAMS                                                  \
    uint64_t *out, int64_t out_stride, const uint64_t *x,                  \
        const uint64_t *__restrict__ y, const uint64_t *__restrict__ m,    \
        int64_t m_stride, const uint64_t *__restrict__ c1,                 \
        int64_t c1_stride, int copies, int64_t groups, int k, int log_n,   \
        const uint64_t *__restrict__ consts
#define TROY_EMBED_ARGS                                                    \
    out, out_stride, x, y, m, m_stride, c1, c1_stride, copies, groups, k,  \
        log_n, consts

// DG's forms and G's, under names of their own (the profiler's)
template <int kForm>
__global__ void zero_embed_kernel(TROY_EMBED_PARAMS) {
    embed_body<kForm>(TROY_EMBED_ARGS);
}

template <int kForm>
__global__ void plain_embed_kernel(TROY_EMBED_PARAMS) {
    embed_body<kForm>(TROY_EMBED_ARGS);
}

int embed_launch(int form, void *out, long long out_stride, const void *x,
                 const void *y, const void *m, long long m_stride,
                 const void *c1, long long c1_stride, int copies,
                 long long groups, int k, int log_n, const void *consts,
                 cudaStream_t stream) {
    if (groups < 1 || k < 1 || k > 65535 || log_n < 1 || copies < 0 ||
        consts == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long half = 1ll << (log_n - 1);
    const dim3 grid(static_cast<unsigned>((half + kThreads - 1) / kThreads),
                    static_cast<unsigned>(k),
                    static_cast<unsigned>(groups < kMaxGridZ ? groups
                                                             : kMaxGridZ));
    auto *o = static_cast<uint64_t *>(out);
    auto *xs = static_cast<const uint64_t *>(x);
    auto *ys = static_cast<const uint64_t *>(y);
    auto *ms = static_cast<const uint64_t *>(m);
    auto *cs = static_cast<const uint64_t *>(c1);
    auto *cn = static_cast<const uint64_t *>(consts);
    switch (form) {
#define TROY_EMBED_FORM(kernel, f)                                          \
    case f:                                                                 \
        kernel<f><<<grid, kThreads, 0, stream>>>(                           \
            o, out_stride, xs, ys, ms, m_stride, cs, c1_stride, copies,     \
            groups, k, log_n, cn);                                          \
        break;
    TROY_EMBED_FORM(zero_embed_kernel, kEmbedSym)
    TROY_EMBED_FORM(zero_embed_kernel, kEmbedAsym)
    TROY_EMBED_FORM(plain_embed_kernel, kEmbedAdd)
    TROY_EMBED_FORM(plain_embed_kernel, kEmbedSub)
#undef TROY_EMBED_FORM
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
    TROY_RETURN_LAUNCH_STATUS();
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

// DG: form 0 (symmetric) or 1 (public key). x, y: (groups, k, 2^log_n)
// contiguous; out: groups at out_stride words (it may be x); m: rows of
// 2^log_n words mod t at m_stride (the symmetric finish reads one a group,
// the public-key finish one for group 0); c1 (groups, k, 2^log_n) copied
// into the component after each of out's groups, or NULL (symmetric
// only); consts: EmbedLayout. Every pointer and stride 16-byte aligned.
extern "C" int troy_rns_zero_embed(void *out, long long out_stride,
                                   const void *x, const void *y,
                                   const void *m, long long m_stride,
                                   const void *c1, int form,
                                   long long groups, int k, int log_n,
                                   const void *consts, void *stream) {
    if ((form != kEmbedSym && form != kEmbedAsym) ||
        (form == kEmbedAsym && c1 != nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return embed_launch(form, out, out_stride, x, y, m, m_stride, c1,
                        static_cast<long long>(k) << log_n, c1 ? 1 : 0,
                        groups, k, log_n, consts,
                        static_cast<cudaStream_t>(stream));
}

// G: out = c0 +- round(Q m / t). c0: (groups, k, 2^log_n) contiguous; out:
// groups at out_stride words (it may be c0); m: rows at m_stride words;
// c1: NULL, or groups at c1_stride words of `copies` (k, 2^log_n)
// components copied into the components after each of out's groups;
// consts: EmbedLayout. Every pointer and stride 16-byte aligned.
extern "C" int troy_bfv_plain_embed(void *out, long long out_stride,
                                    const void *c0, const void *m,
                                    long long m_stride, const void *c1,
                                    long long c1_stride, int copies,
                                    int subtract, long long groups, int k,
                                    int log_n, const void *consts,
                                    void *stream) {
    return embed_launch(subtract ? kEmbedSub : kEmbedAdd, out, out_stride,
                        c0, nullptr, m, m_stride, c1, c1_stride,
                        c1 ? copies : 0, groups, k, log_n, consts,
                        static_cast<cudaStream_t>(stream));
}
