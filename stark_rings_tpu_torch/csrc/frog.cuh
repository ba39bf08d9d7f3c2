// Frog field arithmetic on the device: q = 15912092521325583641, a
// generic 64-bit prime above 2^63, values in u64 Montgomery form
// (R = 2^64), as in stark_rings_tpu's fields/field.py (_Frog).
//
// Device counterpart of _FrogOps (stark_rings_tpu/mle/pallas_sumcheck.py)
// and of _Frog._mont_mul_raw.  The TPU kernel builds every 64-bit step
// from u32 planes; Hopper has native u64 add and compare, and a
// 64x64 -> 128 product is one multiply for the low word and one
// __umul64hi for the high word.  Every step wraps as the reference's u64
// arithmetic does, so any u64 inputs give the reference's bits; canonical
// inputs give canonical outputs.
#pragma once

#include <cstdint>

namespace frog {

constexpr uint64_t Q = 0xDCD31BD79EC2DD19ull;   // 15912092521325583641
constexpr uint64_t QP = 0xA3AE2AD7EED4D0D7ull;  // -q^-1 mod 2^64

// Montgomery product a * b * 2^-64 mod q: three products (a*b, the low
// word of m = lo * QP, the high word of m*q).  lo + lo(m*q) is 0 mod
// 2^64 and carries exactly when lo != 0; hi + hi(m*q) + carry is reduced
// by q once if it wrapped past 2^64 or reached q.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b) {
    const uint64_t lo = a * b;
    const uint64_t hi = __umul64hi(a, b);
    const uint64_t m = lo * QP;
    const uint64_t t = hi + __umul64hi(m, Q);
    const uint64_t t2 = t + (lo != 0 ? 1ull : 0ull);
    const bool wrapped = t < hi || t2 < t;
    return (wrapped || t2 >= Q) ? t2 - Q : t2;
}

// A carry out of 2^64 or a sum >= q both reduce by q (the wrapped s - q
// is s + 2^64 - q in the carry case).
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    return (s < a || s >= Q) ? s - Q : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d + Q : d;
}

}  // namespace frog
