// Kernel R1: the cross-shard modular sum of gathered partial residues.
//
// Replaces the reduction that GSPMD inserts into troy_tpu/parallel/
// sharding.py:153 limb_sharded_multiply_relin (and its Galois and 2-D
// counterparts, :236, :181, :254): with the RNS-limb axis sharded, each
// device holds the key switch's inner product over its own decomposition
// digits only, and XLA sums the partials with an all-reduce. Here the
// partials (2, k+1, n) of the w ranks are all-gathered as one (w, rows, n)
// tensor and summed mod each limb's prime in one launch:
//
//   out[r, i] = (parts[0, r, i] + ... + parts[w-1, r, i]) mod q_{r % k}
//
// Every partial is fully reduced (kernel B's output), so the running sum
// stays below 2 q < 2^62 and add_mod keeps it in [0, q): the result is the
// word kernel B gives for the whole inner product, which the divide by the
// special prime then reads as it would unsharded.
//
// What bounds it on the H100: bytes; w words read and one written per
// output word, a compare and a subtract per added term. Design: one thread
// per output word in a grid-stride loop; for each of the w partials the
// threads of a warp read consecutive words (coalesced); the limb's prime is
// read once per word from the (k,) moduli.

#include "u64.cuh"

using namespace troy;

namespace {

__global__ void shard_modsum_kernel(uint64_t *__restrict__ out,
                                    const uint64_t *__restrict__ parts,
                                    int w, int64_t words, int log_n, int k,
                                    const uint64_t *__restrict__ moduli) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         idx < words; idx += stride) {
        const uint64_t q = moduli[(idx >> log_n) % k];
        uint64_t acc = parts[idx];
        for (int r = 1; r < w; ++r) {
            acc = add_mod(acc, parts[static_cast<int64_t>(r) * words + idx],
                          q);
        }
        out[idx] = acc;
    }
}

}  // namespace

// out: (rows, 2^log_n); parts: (w, rows, 2^log_n), words below the prime of
// their row's limb (row r: limb r % k); words = rows << log_n; moduli: (k,).
extern "C" int troy_shard_modsum(void *out, const void *parts, int w,
                                 long long words, int log_n, int k,
                                 const void *moduli, void *stream) {
    if (w < 1 || words < 1 || k < 1 || log_n < 0 || log_n > 30 ||
        words % (1LL << log_n) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = 256;
    shard_modsum_kernel<<<grid_blocks(words, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t *>(out), static_cast<const uint64_t *>(parts),
        w, words, log_n, k, static_cast<const uint64_t *>(moduli));
    TROY_RETURN_LAUNCH_STATUS();
}
