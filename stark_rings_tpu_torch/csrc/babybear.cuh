// BabyBear field arithmetic on the device: q = 15 * 2^27 + 1, values in
// u32 Montgomery form (R = 2^32), as in stark_rings_tpu's fields/field.py.
//
// Device counterpart of the u32 helpers of
// stark_rings_tpu/ops/pallas_fold_bb.py (_bb_mont_mul and the REDC at the
// end of _bb_fold_rows) and of _BbOps (stark_rings_tpu/mle/
// pallas_sumcheck.py: add, sub and the Montgomery product).  Every step wraps exactly as the reference's u32
// arithmetic does, so inputs outside [0, q) give the reference's bits too;
// canonical inputs give canonical outputs.
#pragma once

#include <cstdint>

namespace bb {

constexpr uint32_t Q = 2013265921u;     // 15 * 2^27 + 1
constexpr uint32_t QINV = 2013265919u;  // -q^-1 mod 2^32

// REDC of a 64-bit word: (x + m q) / 2^32 mod 2^32 with m = x * QINV mod
// 2^32, then one conditional subtract.  The low words of x and m q sum to
// 0 mod 2^32, with a carry exactly when x's low word is not 0.  Below
// q * 2^32 the result is canonical.
__device__ __forceinline__ uint32_t redc64(uint64_t x) {
    const uint32_t lo = static_cast<uint32_t>(x);
    const uint32_t hi = static_cast<uint32_t>(x >> 32);
    const uint32_t m = lo * QINV;
    const uint32_t t = hi + __umulhi(m, Q) + (lo != 0u ? 1u : 0u);
    return t >= Q ? t - Q : t;
}

// Montgomery product a * b * 2^-32 mod q.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
    return redc64(static_cast<uint64_t>(a) * b);
}

// Canonical inputs: q < 2^31, so the u32 sum does not wrap.
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    const uint32_t s = a + b;
    return s >= Q ? s - Q : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    const uint32_t d = a - b;
    return a < b ? d + Q : d;
}

}  // namespace bb
