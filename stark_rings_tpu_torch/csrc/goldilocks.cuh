// Goldilocks field arithmetic on the device: q = 2^64 - 2^32 + 1,
// canonical values in [0, q) held as native uint64_t.
//
// Device counterpart of the u32-pair helpers of
// stark_rings_tpu/ops/pallas_goldilocks.py (_reduce128, _mul_q, _sub_q).
// The TPU has no 64-bit integer multiplier, so the reference splits every
// value into two u32 planes; Hopper multiplies 64x64 -> 128 with one
// multiply and one __umul64hi, so the helpers here work on whole words.
// The port's plain twins (ops/goldilocks.py) keep the reference's u32-pair
// arithmetic, which makes a comparison of the two a meaningful check.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t Q = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod q = 2^32 - 1

// (hi * 2^64 + lo) mod q, for any 128-bit input, via 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod q).  Canonical output.
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & EPS;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPS;           // borrow of 2^64 == -(2^32 - 1)
    const uint64_t t1 = hi_lo * EPS;     // hi_lo * 2^64 mod q, < 2^64
    uint64_t t2 = t0 + t1;
    if (t2 < t1) t2 += EPS;              // carry of 2^64 == 2^32 - 1
    return t2 >= Q ? t2 - Q : t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d + Q : d;
}

// Canonical inputs: a carry out of 2^64 or a sum >= q both reduce by q
// (the wrapped s - q is s + 2^64 - q in the carry case).
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    return (s < a || s >= Q) ? s - Q : s;
}

// l + r*(u - l): binds one multilinear variable to r.
__device__ __forceinline__ uint64_t lerp(uint64_t l, uint64_t u, uint64_t r) {
    return add(l, mul(r, sub(u, l)));
}

}  // namespace gl
