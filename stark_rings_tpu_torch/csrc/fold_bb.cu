// K4: bucket-fold epilogues of the BabyBear power-of-two ring multiply
// (BASELINE config 2), for Hopper (sm_90a).  Plain C entry points, loaded
// with ctypes by stark_rings_tpu_torch/ops/_build.py; wrappers and plain
// twins are in stark_rings_tpu_torch/ops/fold_bb.py.
//
// Replaces bb_fold_end_dma, bb_fold_tw_dma and bb_fold_end2_mul_dma of
// stark_rings_tpu/ops/pallas_fold_bb.py (one pallas_call, _bb_fold_dma,
// whose kernel is _make_bb_fold_dma_kernel over _bb_fold_rows and
// _bb_mont_mul).  The TPU kernels double-buffer column chunks through
// VMEM; here each thread computes one output straight from device
// memory, as the Goldilocks folds of fold.cu do.
//
// Each level's digit GEMM gives V[K*R, cols] (int32) whose K bucket
// planes hold sum_k V[k*R + r, c] * 2^(8k):
//   unsigned scheme (K = 4): b_k = (u32)V[k*R + r, c], acc < 2^55 for
//                            buckets within their bound;
//   signed scheme   (K = 5): b_k = (u32)V[k*R + r, c] + 2^26 (u32 wrap),
//                            acc < 2^59, and BIAS_RED is subtracted mod q
//                            after the REDC.
// The weights carry 2^32, so one REDC of acc (acc + m q < 2^64 within the
// bound) gives the canonical value.  acc is summed mod 2^64 and the REDC
// wraps mod 2^32 exactly as the reference's u32 pairs do, so every int32
// bucket folds to the reference's bits.
//
// Shapes on the main path (N = 2^12, N1 = N2 = 64, B = 4096, unsigned):
// R = 64, K*R = 256, t = 64, cols = B*t = 262144.  Per call: 268 MB of
// buckets read (537 MB for bb_fold_end2_mul with two operands) and 67 MB
// written; a few dozen integer operations per output against 16 bytes
// read per operand, so device memory bounds all three.  Reads are
// coalesced (consecutive threads on consecutive columns, the K loads of a
// thread independent and in flight together).  The transposed store of
// bb_fold_tw lands R*B*4 bytes apart per thread (one 32-byte sector per
// 4-byte store): a shared-memory tile for it is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

// (sum_k 2^26 * 2^(8k) for k < 5) * 2^-32 mod q: the signed scheme's
// bucket bias after the REDC.
constexpr uint32_t BIAS_RED = 35914756u;
constexpr int THREADS = 256;

// fold(V) at one (r, c): p points at V[r, c], step = R * ld (one bucket).
template <bool SIGNED>
__device__ __forceinline__ uint32_t fold_point(const int32_t* __restrict__ p,
                                               int64_t step) {
    constexpr int K = SIGNED ? 5 : 4;
    uint32_t b[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        b[k] = static_cast<uint32_t>(p[k * step]);
        if (SIGNED) b[k] += (1u << 26);
    }
    uint64_t acc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) acc += static_cast<uint64_t>(b[k]) << (8 * k);
    const uint32_t t = bb::redc64(acc);
    if (!SIGNED) return t;
    return t < BIAS_RED ? t + (bb::Q - BIAS_RED) : t - BIAS_RED;
}

// fold times the Montgomery twiddle tw[r, c mod t]; with TRANSPOSE the
// [R, t] tile of batch element b is stored as out[j, b*R + r].
template <bool SIGNED, bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
bb_fold_tw_kernel(const int32_t* __restrict__ v, int64_t ld,
                  const uint32_t* __restrict__ tw, int64_t t,
                  uint32_t* __restrict__ out, int64_t R, int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t b = c / t;
    const int64_t j = c - b * t;
    const uint32_t y = bb::mont_mul(fold_point<SIGNED>(v + r * ld + c, R * ld),
                                    tw[r * t + j]);
    if (TRANSPOSE) {
        out[j * (cols / t) * R + b * R + r] = y;
    } else {
        out[r * cols + c] = y;
    }
}

// fold(Va)[r, c] * fold(Vb)[r, c mod b_cols] (Montgomery).  Vb is a second
// tensor, the right half of a stacked Va (vb = va + cols, same ld), or a
// batch-1 cached operand with b_cols = t columns, read modulo t here
// instead of being broadcast to [K*R, cols] first (268 MB at B = 4096).
template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
bb_fold_end2_mul_kernel(const int32_t* __restrict__ va, int64_t lda,
                        const int32_t* __restrict__ vb, int64_t ldb,
                        int64_t b_cols, uint32_t* __restrict__ out, int64_t R,
                        int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t cb = b_cols == cols ? c : c % b_cols;
    const uint32_t x = fold_point<SIGNED>(va + r * lda + c, R * lda);
    const uint32_t y = fold_point<SIGNED>(vb + r * ldb + cb, R * ldb);
    out[r * cols + c] = bb::mont_mul(x, y);
}

template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
bb_fold_end_kernel(const int32_t* __restrict__ v, int64_t ld,
                   uint32_t* __restrict__ out, int64_t R, int64_t cols) {
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

extern "C" int srt_bb_fold_tw(const void* v, int64_t ld, const void* tw,
                              int64_t t, void* out, int64_t R, int64_t cols,
                              int transpose_out, int is_signed, void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    const auto* twp = static_cast<const uint32_t*>(tw);
    auto* op = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed) {
        if (transpose_out)
            bb_fold_tw_kernel<true, true><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
        else
            bb_fold_tw_kernel<true, false><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
    } else {
        if (transpose_out)
            bb_fold_tw_kernel<false, true><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
        else
            bb_fold_tw_kernel<false, false><<<grid, THREADS, 0, s>>>(
                vp, ld, twp, t, op, R, cols);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_bb_fold_end2_mul(const void* va, int64_t lda,
                                    const void* vb, int64_t ldb,
                                    int64_t b_cols, void* out, int64_t R,
                                    int64_t cols, int is_signed,
                                    void* stream) {
    const auto* ap = static_cast<const int32_t*>(va);
    const auto* bp = static_cast<const int32_t*>(vb);
    auto* op = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed)
        bb_fold_end2_mul_kernel<true><<<grid, THREADS, 0, s>>>(
            ap, lda, bp, ldb, b_cols, op, R, cols);
    else
        bb_fold_end2_mul_kernel<false><<<grid, THREADS, 0, s>>>(
            ap, lda, bp, ldb, b_cols, op, R, cols);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_bb_fold_end(const void* v, int64_t ld, void* out,
                               int64_t R, int64_t cols, int is_signed,
                               void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    auto* op = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(R, cols);
    if (is_signed)
        bb_fold_end_kernel<true><<<grid, THREADS, 0, s>>>(vp, ld, op, R, cols);
    else
        bb_fold_end_kernel<false><<<grid, THREADS, 0, s>>>(vp, ld, op, R,
                                                           cols);
    return static_cast<int>(cudaGetLastError());
}
