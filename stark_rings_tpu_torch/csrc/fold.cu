// Bucket-fold epilogues of the deg-2^16 Goldilocks ring multiply, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; wrappers and plain twins are in
// stark_rings_tpu_torch/ops/fold.py.
//
// Each level of the four-step transform is a digit GEMM
//     V[K*R, cols] (int32) = big[K*R, P*C] @ planes[P*C, cols]
// whose K bucket planes hold the value  sum_k V[k*R + r, c] * 2^(8k).
// fold(V)[r, c] is that value mod q, canonical:
//   unsigned scheme (K = 8): b_k = (u32)V[k*R + r, c];
//   signed scheme   (K = 9): b_k = (u32)V[k*R + r, c] + 2^26 (u32 wrap),
//                            and BIAS_MOD_Q is subtracted after the fold.
// Buckets are below 2^27, so the 8-bucket sum reaches about 2^84 and the
// signed 9-bucket sum about 2^91: each thread accumulates exactly in 128
// bits (any int32 input is folded exactly) and reduces once.
//
// Shapes on the main path (N = 2^16, N1 = N2 = 256, B = 80, unsigned):
// R = 256, K*R = 2048, t = 256, cols = B*t = 20480.
//
// All three kernels are bound by device memory: a few dozen integer
// operations per output against 32-36 bytes of buckets read and 8
// bytes written.  The design keeps every read coalesced: one thread per
// output element, consecutive threads on consecutive columns, so each
// warp reads 128 contiguous bytes of every bucket row, and the K loads of
// a thread are independent (unrolled) so they are all in flight at once.
// Later work: several columns per thread with 16-byte loads, a
// shared-memory tile for K1's transposed store, and folding inside the
// GEMM epilogue so the buckets never reach device memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

// sum_k 2^26 * 2^(8k) for k < 9, mod q (the signed scheme's bucket bias).
constexpr uint64_t BIAS_MOD_Q = 578721382569606140ull;
constexpr int THREADS = 256;

// fold(V) at one (r, c): p points at V[r, c], step = R * ld (one bucket).
template <bool SIGNED>
__device__ __forceinline__ uint64_t fold_point(const int32_t* __restrict__ p,
                                               int64_t step) {
    constexpr int K = SIGNED ? 9 : 8;
    uint32_t b[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        b[k] = static_cast<uint32_t>(p[k * step]);
        if (SIGNED) b[k] += (1u << 26);
    }
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int s = 8 * k;
        const uint64_t v = b[k];
        // v * 2^s as a 128-bit (chi, clo); s <= 64, shifts kept in [0, 64)
        const uint64_t clo = s < 64 ? v << (s & 63) : 0;
        const uint64_t chi = s == 0 ? 0
                           : s < 64 ? v >> ((64 - s) & 63)
                                    : v << ((s - 64) & 63);
        lo += clo;
        hi += chi + (lo < clo ? 1 : 0);
    }
    const uint64_t x = gl::reduce128(hi, lo);
    return SIGNED ? gl::sub(x, BIAS_MOD_Q) : x;
}

// K1: fold, times the mid twiddle tw[r, c mod t].
// Replaces fold_tw_dma (stark_rings_tpu/ops/pallas_fold.py, via _fold_dma
// and _make_fold_dma_kernel), which ran the same fold on u32 pairs in
// VMEM.  Per call on the main path: 168 MB of buckets read, 0.5 MB of
// twiddles (cache-resident), 42 MB written.  With TRANSPOSE the [R, t]
// tile of every batch element b is stored transposed,
// out[j, b*R + r] (the four-step mid transpose): reads stay coalesced,
// the 8-byte stores land R*B*8 bytes apart.
template <bool SIGNED, bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
fold_tw_kernel(const int32_t* __restrict__ v, int64_t ld,
               const uint64_t* __restrict__ tw, int64_t t,
               uint64_t* __restrict__ out, int64_t R, int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t b = c / t;
    const int64_t j = c - b * t;
    const uint64_t y = gl::mul(fold_point<SIGNED>(v + r * ld + c, R * ld),
                               tw[r * t + j]);
    if (TRANSPOSE) {
        out[j * (cols / t) * R + b * R + r] = y;
    } else {
        out[r * cols + c] = y;
    }
}

// K2: fold(Va)[r, c] * fold(Vb)[r, c mod b_cols].
// Replaces fold_end2_mul_dma (pallas_fold.py, _make_fold2_mul_kernel).
// Vb is a second tensor, the right half of a stacked Va (vb = va + cols,
// same ld), or a batch-1 cached operand with b_cols = t columns that is
// indexed modulo t here instead of being broadcast to [K*R, cols] first.
// Per call on the main path: 336 MB read (two operands), or 170 MB with a
// batch-1 Vb (2 MB, cache-resident); 42 MB written.
template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
fold_end2_mul_kernel(const int32_t* __restrict__ va, int64_t lda,
                     const int32_t* __restrict__ vb, int64_t ldb,
                     int64_t b_cols, uint64_t* __restrict__ out, int64_t R,
                     int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t cb = b_cols == cols ? c : c % b_cols;
    const uint64_t x = fold_point<SIGNED>(va + r * lda + c, R * lda);
    const uint64_t y = fold_point<SIGNED>(vb + r * ldb + cb, R * ldb);
    out[r * cols + c] = gl::mul(x, y);
}

// K3: fold only.
// Replaces fold_end_dma (pallas_fold.py, via _fold_dma).  Per call on the
// main path: 168 MB read, 42 MB written.
template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
fold_end_kernel(const int32_t* __restrict__ v, int64_t ld,
                uint64_t* __restrict__ out, int64_t R, int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    out[r * cols + c] = fold_point<SIGNED>(v + r * ld + c, R * ld);
}

dim3 grid_for(int64_t R, int64_t cols) {
    return dim3(static_cast<unsigned>((cols + THREADS - 1) / THREADS),
                static_cast<unsigned>(R));
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Sizes are checked by the Python
// wrappers: R <= 65535, (cols + 255) / 256 < 2^31, t divides cols.

extern "C" int srt_fold_tw(const void* v, int64_t ld, const void* tw,
                           int64_t t, void* out, int64_t R, int64_t cols,
                           int transpose_out, int is_signed, void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    const auto* twp = static_cast<const uint64_t*>(tw);
    auto* op = static_cast<uint64_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed) {
        if (transpose_out)
            fold_tw_kernel<true, true><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
        else
            fold_tw_kernel<true, false><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
    } else {
        if (transpose_out)
            fold_tw_kernel<false, true><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
        else
            fold_tw_kernel<false, false><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_fold_end2_mul(const void* va, int64_t lda, const void* vb,
                                 int64_t ldb, int64_t b_cols, void* out,
                                 int64_t R, int64_t cols, int is_signed,
                                 void* stream) {
    const auto* ap = static_cast<const int32_t*>(va);
    const auto* bp = static_cast<const int32_t*>(vb);
    auto* op = static_cast<uint64_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed)
        fold_end2_mul_kernel<true><<<grid, THREADS, 0, s>>>(
            ap, lda, bp, ldb, b_cols, op, R, cols);
    else
        fold_end2_mul_kernel<false><<<grid, THREADS, 0, s>>>(
            ap, lda, bp, ldb, b_cols, op, R, cols);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_fold_end(const void* v, int64_t ld, void* out, int64_t R,
                            int64_t cols, int is_signed, void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    auto* op = static_cast<uint64_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed)
        fold_end_kernel<true><<<grid, THREADS, 0, s>>>(
            vp, ld, op, R, cols);
    else
        fold_end_kernel<false><<<grid, THREADS, 0, s>>>(
            vp, ld, op, R, cols);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
