// S1-S3: the 252-bit stark prime's limb arithmetic for Hopper (sm_90a).
// Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; wrappers and plain twins are in
// stark_rings_tpu_torch/ops/stark.py.
//
// None of the three replaces a Pallas kernel: the reference computes them
// in XLA (stark_rings_tpu/fields/field.py _Stark: _mont_mul_limbs, add,
// sub; stark_rings_tpu/ops/mxu_limb.py LimbPrescaledMat.fold), where each
// fuses into one pass.  In eager PyTorch each limb step would be a launch
// of its own, so here each is one kernel with one thread an element and
// every limb and word in registers.
//
// S1 stark_mul_kernel:          out = a * b * 2^-256 mod q (CIOS,
//                                stark.cuh)
// S2 stark_add_kernel,
//    stark_sub_kernel:          out = a + b, a - b mod q
//   a is [rows, 8] u32 limbs, b is [b_rows, 8] read at row (row mod
//   b_rows): b_rows = rows for two full operands, fewer for a table
//   broadcast over leading axes (the four-step's mid twiddle [n2, k1, 8]
//   against [B, n2, k1, 8]).  Loads and stores are two 16-byte vectors a
//   row; a warp reads and writes 1 KB of contiguous rows.
// S3 limb_fold_kernel<SIGNED>: the digit GEMM's int32 buckets
//   V[K*R, cols] -> canonical limbs [R, cols, 8] (or [cols, R, 8]):
//   value = sum_k b_k 2^(8k), b_k the bucket's u32 bits (plus 2^26 with
//   u32 wrap in the signed scheme, K = 33; K = 32 unsigned), packed into
//   ten base-2^32 words, carry-normalized, divided by 2^256 in eight
//   word-REDC rounds (the weights carry 2^256), one conditional subtract,
//   and in the signed scheme the bias image subtracted mod q.  One thread
//   a column: the K bucket loads of a warp are 128-byte lines along cols.

#include <cstdint>

#include <cuda_runtime.h>

#include "stark.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = 10;  // words of sum_k b_k 2^(8k) for K <= 33 buckets
// (sum_k 2^26 2^(8k) for k < 33) * 2^-256 mod q: the signed scheme's
// bucket bias after the fold
__host__ __device__ constexpr uint32_t bias_red(int j) {
    return j == 0 ? 0x9f9fbfc0u : j == 4 ? 0x1f9b9b9bu
         : j == 5 ? 0x24242424u : j == 6 ? 0x01ffdfe4u
         : j == 7 ? 0x02020202u : 0x9b9b9b9bu;
}

__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&x)[sp::L]) {
    const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void store_row(uint32_t* __restrict__ p,
                                          const uint32_t (&x)[sp::L]) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// OP: 0 mul, 1 add, 2 sub
template <int OP>
__device__ __forceinline__ void binary_row(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           int64_t b_rows,
                                           uint32_t* __restrict__ out,
                                           int64_t rows) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS
                        + threadIdx.x;
    if (row >= rows) return;
    const int64_t brow = b_rows == rows ? row : row % b_rows;
    uint32_t x[sp::L], y[sp::L], z[sp::L];
    load_row(a + row * sp::L, x);
    load_row(b + brow * sp::L, y);
    if (OP == 0)
        sp::mont_mul(x, y, z);
    else if (OP == 1)
        sp::add(x, y, z);
    else
        sp::sub(x, y, z);
    store_row(out + row * sp::L, z);
}

__global__ void __launch_bounds__(THREADS)
stark_mul_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, int64_t b_rows,
                 uint32_t* __restrict__ out, int64_t rows) {
    binary_row<0>(a, b, b_rows, out, rows);
}

__global__ void __launch_bounds__(THREADS)
stark_add_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, int64_t b_rows,
                 uint32_t* __restrict__ out, int64_t rows) {
    binary_row<1>(a, b, b_rows, out, rows);
}

__global__ void __launch_bounds__(THREADS)
stark_sub_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, int64_t b_rows,
                 uint32_t* __restrict__ out, int64_t rows) {
    binary_row<2>(a, b, b_rows, out, rows);
}

template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
limb_fold_kernel(const int32_t* __restrict__ v, uint32_t* __restrict__ out,
                 int64_t R, int64_t cols, bool transpose_out) {
    constexpr int K = SIGNED ? 33 : 32;
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS
                      + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    uint64_t w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = 0;
    const int32_t* p = v + r * cols + c;
    const int64_t step = R * cols;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        uint32_t bk = static_cast<uint32_t>(__ldg(p + k * step));
        if (SIGNED) bk += 1u << 26;
        const int j = (8 * k) >> 5, sh = (8 * k) & 31;
        const uint64_t contrib = static_cast<uint64_t>(bk) << sh;
        w[j] += contrib & 0xFFFFFFFFull;
        w[j + 1] += contrib >> 32;
    }
    // carry-normalize to base-2^32 digits, two more for the REDC carries
    uint64_t d[NW + 2];
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        const uint64_t t = w[j] + carry;
        d[j] = t & 0xFFFFFFFFull;
        carry = t >> 32;
    }
    d[NW] = carry;
    d[NW + 1] = 0;
    // eight REDC rounds, each an exact division by 2^32
#pragma unroll
    for (int round = 0; round < sp::L; ++round) {
        const uint32_t m = static_cast<uint32_t>(d[0]) * sp::QPRIME;
        carry = 0;
#pragma unroll
        for (int j = 0; j < sp::L; ++j) {
            const uint64_t s = d[j] + static_cast<uint64_t>(m) * sp::qlimb(j)
                               + carry;
            d[j] = s & 0xFFFFFFFFull;
            carry = s >> 32;
        }
#pragma unroll
        for (int j = sp::L; j < NW + 2; ++j) {
            const uint64_t s = d[j] + carry;
            d[j] = s & 0xFFFFFFFFull;
            carry = s >> 32;
        }
#pragma unroll
        for (int j = 0; j < NW + 1; ++j) d[j] = d[j + 1];
        d[NW + 1] = 0;
    }
    uint32_t x[sp::L];
#pragma unroll
    for (int j = 0; j < sp::L; ++j) x[j] = static_cast<uint32_t>(d[j]);
    sp::sub_q(x, sp::geq_q(x));
    if (SIGNED) {
        uint32_t bias[sp::L], y[sp::L];
#pragma unroll
        for (int j = 0; j < sp::L; ++j) bias[j] = bias_red(j);
        sp::sub(x, bias, y);
#pragma unroll
        for (int j = 0; j < sp::L; ++j) x[j] = y[j];
    }
    const int64_t o = transpose_out ? c * R + r : r * cols + c;
    store_row(out + o * sp::L, x);
}

using BinaryKernel = void (*)(const uint32_t*, const uint32_t*, int64_t,
                              uint32_t*, int64_t);

int launch_binary(BinaryKernel kernel, const void* a, const void* b,
                  int64_t b_rows, void* out, int64_t rows, void* stream) {
    const auto blocks = static_cast<unsigned>((rows + THREADS - 1)
                                              / THREADS);
    kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        b_rows, static_cast<uint32_t*>(out), rows);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  The Python wrappers check the
// shapes: rows >= 1, 1 <= b_rows <= rows, (rows + 255) / 256 < 2^31,
// R <= 65535, and 16-byte aligned contiguous operands.

extern "C" int srt_stark_mul(const void* a, const void* b, int64_t b_rows,
                             void* out, int64_t rows, void* stream) {
    return launch_binary(stark_mul_kernel, a, b, b_rows, out, rows,
                         stream);
}

extern "C" int srt_stark_add(const void* a, const void* b, int64_t b_rows,
                             void* out, int64_t rows, void* stream) {
    return launch_binary(stark_add_kernel, a, b, b_rows, out, rows,
                         stream);
}

extern "C" int srt_stark_sub(const void* a, const void* b, int64_t b_rows,
                             void* out, int64_t rows, void* stream) {
    return launch_binary(stark_sub_kernel, a, b, b_rows, out, rows,
                         stream);
}

extern "C" int srt_limb_fold(const void* v, void* out, int64_t R,
                             int64_t cols, int is_signed, int transpose_out,
                             void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    auto* op = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((cols + THREADS - 1) / THREADS),
                    static_cast<unsigned>(R));
    if (is_signed)
        limb_fold_kernel<true><<<grid, THREADS, 0, s>>>(vp, op, R, cols,
                                                        transpose_out != 0);
    else
        limb_fold_kernel<false><<<grid, THREADS, 0, s>>>(vp, op, R, cols,
                                                         transpose_out != 0);
    return static_cast<int>(cudaGetLastError());
}
