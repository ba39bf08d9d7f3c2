// Exact Goldilocks matrix product y = W x (mod q) for a constant [R, C]
// matrix W and u64 data x [C, M], for Hopper (sm_90a): the kernel of
// stark_rings_tpu_torch/ops/mxu_fused.py.  Plain C entry point, loaded with
// ctypes by ops/_build.py.
//
// Replaces MxuModMatPallas.apply (stark_rings_tpu/ops/pallas_mxu.py:186,
// pallas_call at :201), which per tile of columns
//   * cut x into ten 7-bit digits (_digits_from_planes),
//   * took the int8 x int8 -> int32 products of every weight digit W_k with
//     every data digit x_l on the MXU, summed by exponent into the 19
//     buckets V_s = sum_{k + l = s} W_k x_l,
//   * carry-packed sum_s V_s 2^(7s) into words (_word_accumulate) and
//   * folded the words mod q (_word_finalize).
// This kernel does the same in its own body, with no library GEMM: one
// thread per output column and RB rows, the ten data digits of x[c, m] and
// the ten weight digits of W[r, c] in registers, 100 int32 MACs per (r, c),
// the 19 buckets of each row in registers.  The digits lie in [0, 127] and
// C * 127^2 * 10 < 2^31 (asserted by the wrapper), so no bucket overflows.
// The buckets are packed into three 64-bit words (the value is below
// 2^158) and folded with 2^64 = 2^32 - 1 and 2^128 = -2^32 (mod q).
//
// Bound: at the main path's shape (R = C = 128, M = 10,240, one level of a
// deg-2^14 MatmulNTT multiply at B = 80) the 1.68e10 digit MACs take
// 0.017 ms at the int8 tensor-core rate and the 21 MB of x and y 0.006 ms
// at the memory rate; on the int32 pipes used here the MACs bound it.
// The ragged edge of M is masked (no padding).  Later work: mma.sync or
// wgmma int8 tiles for the digit products, with this fold as the epilogue.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RB = 4;          // rows per thread
constexpr int DIGITS = 10;     // 7-bit digits of a u64
constexpr int BUCKETS = 2 * DIGITS - 1;

// sum_s v[s] 2^(7s) mod q, canonical, for any 19 buckets below 2^31.
__device__ __forceinline__ uint64_t fold_buckets(const int32_t (&v)[BUCKETS]) {
    uint64_t w0 = 0, w1 = 0, w2 = 0;
#pragma unroll
    for (int s = 0; s < BUCKETS; ++s) {
        const uint64_t val = static_cast<uint32_t>(v[s]);
        const int r = 7 * s;
        const int sh = r & 63;
        const uint64_t lo = val << sh;
        const uint64_t hi = sh ? val >> (64 - sh) : 0;   // < 2^31
        if (r < 64) {
            w0 += lo;
            const uint64_t add = hi + (w0 < lo ? 1 : 0);
            w1 += add;
            w2 += w1 < add ? 1 : 0;
        } else {
            w1 += lo;
            w2 += hi + (w1 < lo ? 1 : 0);
        }
    }
    // w2 < 2^30, so w2 * 2^32 < q
    return gl::sub(gl::reduce128(w1, w0), w2 << 32);
}

// w: weight digits [R, C, 16] int8 (digit k at byte k, bytes 10..15 zero);
// x: [C, M] u64; out: [R, M] u64.
__global__ void __launch_bounds__(THREADS)
mxu_mod_mat_kernel(const uint64_t* __restrict__ x,
                   const uint32_t* __restrict__ w,
                   uint64_t* __restrict__ out, int R, int C, int64_t M) {
    const int64_t m = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (m >= M) return;
    const int r0 = blockIdx.y * RB;
    int32_t v[RB][BUCKETS];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int s = 0; s < BUCKETS; ++s) v[i][s] = 0;
    for (int c = 0; c < C; ++c) {
        const uint64_t xv = x[static_cast<int64_t>(c) * M + m];
        int32_t xd[DIGITS];
#pragma unroll
        for (int l = 0; l < DIGITS; ++l)
            xd[l] = static_cast<int32_t>((xv >> (7 * l)) & 127);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            // rows past R (in the last row block) repeat row R - 1 and are
            // not stored; the same 16 bytes for every thread of the block
            const int r = r0 + i < R ? r0 + i : R - 1;
            const uint4 pk = *reinterpret_cast<const uint4*>(
                w + (static_cast<int64_t>(r) * C + c) * 4);
            const uint32_t word[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
            for (int k = 0; k < DIGITS; ++k) {
                const int32_t wk = (word[k >> 2] >> (8 * (k & 3))) & 0xFF;
#pragma unroll
                for (int l = 0; l < DIGITS; ++l) v[i][k + l] += wk * xd[l];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
        if (r0 + i < R)
            out[static_cast<int64_t>(r0 + i) * M + m] = fold_buckets(v[i]);
}

}  // namespace

// Sizes are checked by the Python wrapper: C * 127^2 * 10 < 2^31,
// ceil(M / 128) < 2^31, ceil(R / 4) <= 65535.
extern "C" int srt_mxu_mod_mat(const void* x, const void* w, void* out,
                               int R, int C, int64_t M, void* stream) {
    const dim3 grid(static_cast<unsigned>((M + THREADS - 1) / THREADS),
                    static_cast<unsigned>((R + RB - 1) / RB));
    mxu_mod_mat_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(
        stream)>>>(static_cast<const uint64_t*>(x),
                   static_cast<const uint32_t*>(w),
                   static_cast<uint64_t*>(out), R, C, M);
    return static_cast<int>(cudaGetLastError());
}
