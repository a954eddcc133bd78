// Kernel M: the Galois automorphism x -> x^elt as a gather over the
// coefficients.
//
// Replaces troy_tpu/evaluator.py:785 _apply_permutation_signed (coefficient
// domain: out[j] = in[src[j]], negated mod q where the index wrapped past
// x^n = -1, and 0 stays 0) and :796 _apply_permutation (NTT domain: a plain
// gather of the bit-reversed evaluations), one kernel with moduli = NULL for
// the unsigned form. The index tables come from utils/galois.py.
//
// A second entry point takes one table per leading batch index (tables
// (m, n), rows_per_table rows each): the hoisted Galois path's output
// permutation, one element per ciphertext
// (troy_tpu/evaluator.py:463 _hoisted_galois_core), in one launch. It can
// also write component-major ((c, b) for input (b, c)), which gives the
// batched fold (:442 _batched_galois_fold) its c0s and c1s as two
// contiguous stacks.
//
// Table: one int32 word per output, the source index in bits 0-30 and the
// negate flag in bit 31 (ops/galois.py pack_table), built once per
// (n, elt, device): 4 bytes an output word where an int64 index and a bool
// took 9. The form serves every caller, the batch encoder's slot maps and
// the inverse NTT-domain permutations included, which no formula in elt
// gives.
//
// What bounds it on the H100: at n = 16384 the bytes (2.7 MB for both
// components of a 5-limb ciphertext, 0.8 us), and on the host the launch
// itself. Design: a 2-D grid, rows on y and output words on x, so the row,
// its limb, its table and its component-major position are per-row integers
// (32-bit, once per thread and row) and nothing is divided per word; each
// thread reads four table words as one 16-byte load, gathers four words of
// its row (128 KiB at n = 16384, L2-resident) and writes them with two
// 16-byte stores.

#include "u64.cuh"

using namespace troy;

namespace {

constexpr int kWordsPerThread = 4;
constexpr int kThreads = 256;
constexpr int kIndexMask = 0x7fffffff;

// rows_per_table 0: one table for every row; else row r reads table
// r / rows_per_table. comps > 0: the input rows are (b, c, i) with c <
// comps and i < k, written to output row (c, b, i). moduli NULL: unsigned
// (the flag bits are ignored).
__global__ void galois_permute_kernel(uint64_t *__restrict__ out,
                                      const uint64_t *__restrict__ in,
                                      const int32_t *__restrict__ table,
                                      int rows, int k, int log_n,
                                      const uint64_t *__restrict__ moduli,
                                      int rows_per_table, int comps) {
    const int j = (blockIdx.x * blockDim.x + threadIdx.x) * kWordsPerThread;
    if (j >= (1 << log_n)) return;
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        const int t = rows_per_table > 0 ? r / rows_per_table : 0;
        const int4 w = *reinterpret_cast<const int4 *>(
            table + (static_cast<int64_t>(t) << log_n) + j);
        const uint64_t *src = in + (static_cast<int64_t>(r) << log_n);
        uint64_t v0 = src[w.x & kIndexMask], v1 = src[w.y & kIndexMask];
        uint64_t v2 = src[w.z & kIndexMask], v3 = src[w.w & kIndexMask];
        if (moduli != nullptr) {
            const uint64_t q = moduli[r % k];
            v0 = w.x < 0 ? neg_mod(v0, q) : v0;
            v1 = w.y < 0 ? neg_mod(v1, q) : v1;
            v2 = w.z < 0 ? neg_mod(v2, q) : v2;
            v3 = w.w < 0 ? neg_mod(v3, q) : v3;
        }
        int o = r;
        if (comps > 0) {
            const int per = comps * k;
            const int b = r / per, c = (r / k) % comps, i = r % k;
            o = (c * (rows / per) + b) * k + i;
        }
        ulonglong2 *dst = reinterpret_cast<ulonglong2 *>(
            out + (static_cast<int64_t>(o) << log_n) + j);
        dst[0] = make_ulonglong2(v0, v1);
        dst[1] = make_ulonglong2(v2, v3);
    }
}

int permute(void *out, const void *in, const void *table, long long rows,
            int k, int log_n, const void *moduli, long long rows_per_table,
            int comps, void *stream) {
    const int n = 1 << log_n;
    if (k < 1 || comps < 0 || log_n < 2 || log_n > 30 || rows < 1 ||
        rows > 0x7fffffffLL || rows_per_table < 0 ||
        (comps > 0 && rows % (static_cast<long long>(comps) * k) != 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int per_row = n / kWordsPerThread;
    const int threads = per_row < kThreads ? per_row : kThreads;
    const dim3 grid((per_row + threads - 1) / threads,
                    static_cast<unsigned>(rows < 65535 ? rows : 65535));
    galois_permute_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(in),
        static_cast<const int32_t *>(table), static_cast<int>(rows), k, log_n,
        static_cast<const uint64_t *>(moduli),
        static_cast<int>(rows_per_table), comps);
    TROY_RETURN_LAUNCH_STATUS();
}

}  // namespace

// in, out: (rows, 2^log_n), out 16-byte aligned; table: (2^log_n,) int32,
// 16-byte aligned; moduli: (k,), or NULL for the unsigned gather.
extern "C" int troy_galois_permute(void *out, const void *in,
                                   const void *table, long long rows, int k,
                                   int log_n, const void *moduli,
                                   void *stream) {
    return permute(out, in, table, rows, k, log_n, moduli, 0, 0, stream);
}

// The batched form: tables (rows / rows_per_table, 2^log_n), one table per
// leading batch index (rows_per_table 0: one table for all); comps > 0
// writes component-major (above).
extern "C" int troy_galois_permute_batched(void *out, const void *in,
                                           const void *table, long long rows,
                                           int k, int log_n,
                                           const void *moduli,
                                           long long rows_per_table,
                                           int comps, void *stream) {
    return permute(out, in, table, rows, k, log_n, moduli, rows_per_table,
                   comps, stream);
}
