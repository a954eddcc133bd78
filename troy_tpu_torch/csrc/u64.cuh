// Shared __device__ layer of the port's kernels: 64-bit modular arithmetic
// on uint64_t, the CUDA twin of troy_tpu_torch/ops/u64ops.py (and of the JAX
// package's troy_tpu/ops/u64ops.py:36-188). Every algorithm here is the one
// the plain versions run, step for step, so a kernel and its plain version
// give the same words, lazy ranges included.
//
// Tensors hold u64 words in int64 storage; a kernel reads them through
// uint64_t pointers, so Shoup quotients and Barrett ratio words (which use
// all 64 bits and are negative as int64) are read as the unsigned words
// they are. Every modulus is below 2^61.
//
// Hopper has a native 64x64->high-64 multiply (__umul64hi); the TPU had to
// build it from four 32x32 products.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace troy {

typedef unsigned __int128 u128;

__device__ __forceinline__ uint64_t mulhi64(uint64_t a, uint64_t b) {
    return __umul64hi(a, b);
}

// (lo, hi) of a*b.
__device__ __forceinline__ void mul128(uint64_t a, uint64_t b,
                                       uint64_t &lo, uint64_t &hi) {
    lo = a * b;
    hi = __umul64hi(a, b);
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
    uint64_t s = a + b;
    return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b,
                                            uint64_t q) {
    return a >= b ? a - b : a - b + q;
}

__device__ __forceinline__ uint64_t neg_mod(uint64_t a, uint64_t q) {
    return a == 0 ? 0 : q - a;
}

// Any u64 word to [0, q) with the high Barrett ratio word
// (uintarithsmallmod.h barrettReduce64).
__device__ __forceinline__ uint64_t barrett_reduce_64(uint64_t x, uint64_t q,
                                                      uint64_t cr_hi) {
    uint64_t r = x - __umul64hi(x, cr_hi) * q;
    return r >= q ? r - q : r;
}

// (z_hi:z_lo) to [0, q), cr_hi:cr_lo = floor(2^128 / q)
// (uintarithsmallmod.h:95-163). The same word steps as the plain version.
__device__ __forceinline__ uint64_t barrett_reduce_128(
        uint64_t z_lo, uint64_t z_hi, uint64_t q,
        uint64_t cr_lo, uint64_t cr_hi) {
    uint64_t carry = __umul64hi(z_lo, cr_lo);
    uint64_t t2_lo, t2_hi;
    mul128(z_lo, cr_hi, t2_lo, t2_hi);
    uint64_t t1 = t2_lo + carry;
    uint64_t t3 = t2_hi + (t1 < t2_lo);
    mul128(z_hi, cr_lo, t2_lo, t2_hi);
    uint64_t s = t1 + t2_lo;
    carry = t2_hi + (s < t1);
    t1 = z_hi * cr_hi + t3 + carry;
    uint64_t r = z_lo - t1 * q;
    return r >= q ? r - q : r;
}

// Shoup multiplication by a constant w < q with quotient
// wq = floor(w * 2^64 / q): lazy result in [0, 2q) for any u64 x.
__device__ __forceinline__ uint64_t mul_mod_shoup_lazy(uint64_t x, uint64_t w,
                                                       uint64_t wq,
                                                       uint64_t q) {
    return x * w - __umul64hi(x, wq) * q;
}

__device__ __forceinline__ uint64_t mul_mod_shoup(uint64_t x, uint64_t w,
                                                  uint64_t wq, uint64_t q) {
    uint64_t r = mul_mod_shoup_lazy(x, w, wq, q);
    return r >= q ? r - q : r;
}

__device__ __forceinline__ uint64_t reduce_2q(uint64_t x, uint64_t q) {
    return x >= q ? x - q : x;
}

__device__ __forceinline__ uint64_t reduce_4q(uint64_t x, uint64_t q) {
    x = x >= 2 * q ? x - 2 * q : x;
    return x >= q ? x - q : x;
}

}  // namespace troy

// Every C entry point returns this: the launch status, as an int.
#define TROY_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
