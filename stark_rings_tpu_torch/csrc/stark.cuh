// The 252-bit stark prime on the device: q = 2^251 + 17 * 2^192 + 1,
// values in Montgomery form (R = 2^256) as eight little-endian u32 limbs,
// as in stark_rings_tpu's fields/field.py (_Stark).
//
// Device counterpart of _Stark's _geq_q, _sub_q, add, sub and
// _mont_mul_limbs, which the reference runs in XLA.  Every step is the
// reference's on u64 words with the same wraps (the borrow of a limb
// subtraction is the top bit of the wrapped u64, the carry out of limb 7
// of a sum is dropped), so any u32 limbs give the reference's bits, and
// canonical inputs give canonical outputs.  S1-S3 of stark.cu share
// these helpers.
#pragma once

#include <cstdint>

namespace sp {

constexpr int L = 8;
// q's limbs, least significant first (immediates once a loop unrolls)
__host__ __device__ constexpr uint32_t qlimb(int j) {
    return j == 0 ? 1u : j == 6 ? 17u : j == 7 ? 0x08000000u : 0u;
}
constexpr uint32_t QPRIME = 0xFFFFFFFFu;  // -q^-1 mod 2^32 (q = 1 mod 2^32)

// value >= q, lexicographic from the top limb (equal counts).
__device__ __forceinline__ bool geq_q(const uint32_t (&x)[L]) {
#pragma unroll
    for (int j = L - 1; j >= 0; --j)
        if (x[j] != qlimb(j)) return x[j] > qlimb(j);
    return true;
}

// x -= q where `mask`, the borrow rippling as through u64 words.
__device__ __forceinline__ void sub_q(uint32_t (&x)[L], bool mask) {
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const uint64_t d = static_cast<uint64_t>(x[j])
                           - (mask ? qlimb(j) : 0u) - borrow;
        borrow = d >> 63;
        x[j] = static_cast<uint32_t>(d);
    }
}

// a + b mod q (the reference's add).
__device__ __forceinline__ void add(const uint32_t (&a)[L],
                                    const uint32_t (&b)[L],
                                    uint32_t (&out)[L]) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const uint64_t s = static_cast<uint64_t>(a[j]) + b[j] + carry;
        out[j] = static_cast<uint32_t>(s);
        carry = s >> 32;
    }
    sub_q(out, geq_q(out));
}

// a - b mod q (the reference's sub: q added back where it borrowed).
__device__ __forceinline__ void sub(const uint32_t (&a)[L],
                                    const uint32_t (&b)[L],
                                    uint32_t (&out)[L]) {
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const uint64_t d = static_cast<uint64_t>(a[j]) - b[j] - borrow;
        borrow = d >> 63;
        out[j] = static_cast<uint32_t>(d);
    }
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const uint64_t s = static_cast<uint64_t>(out[j])
                           + (borrow ? qlimb(j) : 0u) + carry;
        out[j] = static_cast<uint32_t>(s);
        carry = s >> 32;
    }
}

// CIOS Montgomery product a * b * 2^-256 mod q.  t[0..9] as in the
// reference's loop: t[8] and t[9] never pass a few units, so u32 holds
// them exactly.
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[L],
                                         const uint32_t (&b)[L],
                                         uint32_t (&out)[L]) {
    uint32_t t[L + 2];
#pragma unroll
    for (int j = 0; j < L + 2; ++j) t[j] = 0u;
#pragma unroll
    for (int i = 0; i < L; ++i) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const uint64_t s = static_cast<uint64_t>(t[j])
                               + static_cast<uint64_t>(a[i]) * b[j] + carry;
            t[j] = static_cast<uint32_t>(s);
            carry = s >> 32;
        }
        uint64_t s = static_cast<uint64_t>(t[L]) + carry;
        t[L] = static_cast<uint32_t>(s);
        t[L + 1] += static_cast<uint32_t>(s >> 32);
        const uint32_t m = t[0] * QPRIME;
        carry = (static_cast<uint64_t>(t[0])
                 + static_cast<uint64_t>(m) * qlimb(0)) >> 32;
#pragma unroll
        for (int j = 1; j < L; ++j) {
            s = static_cast<uint64_t>(t[j])
                + static_cast<uint64_t>(m) * qlimb(j) + carry;
            t[j - 1] = static_cast<uint32_t>(s);
            carry = s >> 32;
        }
        s = static_cast<uint64_t>(t[L]) + carry;
        t[L - 1] = static_cast<uint32_t>(s);
        t[L] = t[L + 1] + static_cast<uint32_t>(s >> 32);
        t[L + 1] = 0u;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) out[j] = t[j];
    sub_q(out, t[L] != 0u || geq_q(out));
}

}  // namespace sp
