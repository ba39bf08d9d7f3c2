// Radix-2 negacyclic Goldilocks NTT for Hopper (sm_90a): the forward and
// inverse transforms and the fused ring multiply of
// stark_rings_tpu_torch/ops/goldilocks_ntt.py, bit-equal to the port's
// NTTContext (leaf order, no bit reversal).  Plain C entry points, loaded
// with ctypes by ops/_build.py.
//
// Replaces GoldilocksPallasNTT._call (stark_rings_tpu/ops/pallas_goldilocks.py
// :457, pallas_call at :472), which ran every stage of a transform (or of
// fwd(a), fwd(b), slot product and inverse) on u32 planes of whole rows in
// VMEM.  One row of N = 2^16 words is 512 KB, more than a block's 227 KB
// of shared memory, so the stages split by butterfly span t = N / 2^(s+1):
//
//   * stages with 2t <= TILE = 2^log_tile (2^14 words, 128 KB) keep every
//     aligned TILE-word block of a row independent: ntt_tile_kernel runs
//     all of them in shared memory, one block per (row, tile);
//   * the stages with 2t > TILE (2 of them at N = 2^16) are grid-wide
//     passes over device memory, one launch each (ntt_stage_kernel).
//
// Twiddles: the reference's one [N] table per direction in the m + i
// layout (stage s with m = 2^s blocks reads entries [m, 2m)); 1/N is a
// kernel argument.  Forward butterflies are Cooley-Tukey (a + w b, a - w b),
// inverse ones Gentleman-Sande (a + b, w^-1 (a - b)) in the reverse stage
// order, then x 1/N.
//
// Bound at the main path's shape (N = 2^16, B = 80, one fused multiply:
// 136M modmuls, 127 MB of operands and result): by the card's integer
// multiply rate, not by memory, once the passes are few.  The design keeps
// the round trips to device memory at one per global stage plus one per
// tile launch; butterflies are one per thread per stage, twiddles read
// through the cache.  Later work: radix-4 global passes, register-blocked
// butterflies, and a whole forward transform of both operands per launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int STAGE_THREADS = 256;
constexpr int TILE_THREADS = 1024;

// Mode bits of ntt_tile_kernel.
constexpr int FWD = 1;     // forward stages of the tile
constexpr int PW_GLOBAL = 2;  // times `other` (evaluations) from device memory
constexpr int PW_TILE = 4;    // times the forward transform of `other`,
                              // taken in shared memory beside x
constexpr int INV = 8;     // inverse stages of the tile (x 1/N if whole row)

__device__ __forceinline__ void butterfly_fwd(uint64_t& a, uint64_t& b,
                                              uint64_t w) {
    const uint64_t p = gl::mul(w, b);
    b = gl::sub(a, p);
    a = gl::add(a, p);
}

__device__ __forceinline__ void butterfly_inv(uint64_t& a, uint64_t& b,
                                              uint64_t w) {
    const uint64_t d = gl::sub(a, b);
    a = gl::add(a, b);
    b = gl::mul(w, d);
}

// One radix-2 stage s over device memory, one butterfly per thread, rows
// of 2^logN words.  dst may be src (in place: each thread reads and writes
// its own pair).  With `scaled` (the inverse's last stage) both outputs are
// multiplied by ninv.
template <bool INVERSE>
__global__ void __launch_bounds__(STAGE_THREADS)
ntt_stage_kernel(const uint64_t* src, uint64_t* dst,
                 const uint64_t* __restrict__ w, uint64_t ninv, int scaled,
                 int logN, int s, int64_t total) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * STAGE_THREADS
                      + threadIdx.x;
    if (k >= total) return;
    const int log_t = logN - s - 1;
    const int64_t row = k >> (logN - 1);
    const int64_t kk = k & ((int64_t{1} << (logN - 1)) - 1);
    const int64_t blk = kk >> log_t;
    const int64_t i0 = (row << logN) + (blk << (log_t + 1))
                       + (kk & ((int64_t{1} << log_t) - 1));
    const int64_t i1 = i0 + (int64_t{1} << log_t);
    const uint64_t tw = w[(int64_t{1} << s) + blk];
    uint64_t a = src[i0], b = src[i1];
    if (INVERSE) {
        butterfly_inv(a, b, tw);
        if (scaled) {
            a = gl::mul(a, ninv);
            b = gl::mul(b, ninv);
        }
    } else {
        butterfly_fwd(a, b, tw);
    }
    dst[i0] = a;
    dst[i1] = b;
}

// Stages [s_lo, logN) of one tile in shared memory, forward (ascending s)
// or inverse (descending s).  `tile` is the tile's index within its row.
template <bool INVERSE>
__device__ __forceinline__ void tile_stages(uint64_t* x,
                                            const uint64_t* __restrict__ w,
                                            int logN, int log_tile,
                                            int64_t tile) {
    const int s_lo = logN - log_tile;
    const int half = 1 << (log_tile - 1);
    for (int n = 0; n < log_tile; ++n) {
        const int s = INVERSE ? logN - 1 - n : s_lo + n;
        const int log_t = logN - s - 1;
        // the tile's first block at stage s, in the m + i table layout
        const int64_t wbase = (int64_t{1} << s)
                              + (tile << (log_tile - log_t - 1));
        for (int k = threadIdx.x; k < half; k += blockDim.x) {
            const int blk = k >> log_t;
            const int i0 = (blk << (log_t + 1)) + (k & ((1 << log_t) - 1));
            const int i1 = i0 + (1 << log_t);
            uint64_t a = x[i0], b = x[i1];
            if (INVERSE)
                butterfly_inv(a, b, w[wbase + blk]);
            else
                butterfly_fwd(a, b, w[wbase + blk]);
            x[i0] = a;
            x[i1] = b;
        }
        __syncthreads();
    }
}

// One block per (row, tile) of 2^log_tile words: load x's tile (and, with
// PW_TILE, other's) into shared memory, run the MODE's steps, store to dst
// (which may be src: the tile is loaded whole before any store).  The
// last inverse stage of a row multiplies by ninv when the tile is the whole
// row (log_tile == logN).
template <int MODE>
__global__ void __launch_bounds__(TILE_THREADS)
ntt_tile_kernel(const uint64_t* src, const uint64_t* __restrict__ other,
                uint64_t* dst, const uint64_t* __restrict__ wf,
                const uint64_t* __restrict__ wi, uint64_t ninv, int logN,
                int log_tile) {
    extern __shared__ uint64_t smem[];
    const int size = 1 << log_tile;
    const int64_t tile = blockIdx.x & ((1u << (logN - log_tile)) - 1);
    const int64_t base = static_cast<int64_t>(blockIdx.x) << log_tile;
    uint64_t* x = smem;
    uint64_t* y = smem + size;
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
        x[i] = src[base + i];
        if (MODE & PW_TILE) y[i] = other[base + i];
    }
    __syncthreads();
    if (MODE & FWD) tile_stages<false>(x, wf, logN, log_tile, tile);
    if (MODE & PW_TILE) tile_stages<false>(y, wf, logN, log_tile, tile);
    if (MODE & (PW_GLOBAL | PW_TILE)) {
        for (int i = threadIdx.x; i < size; i += blockDim.x)
            x[i] = gl::mul(x[i], (MODE & PW_TILE) ? y[i] : other[base + i]);
        __syncthreads();
    }
    if (MODE & INV) tile_stages<true>(x, wi, logN, log_tile, tile);
    const bool scale = (MODE & INV) && log_tile == logN;
    for (int i = threadIdx.x; i < size; i += blockDim.x)
        dst[base + i] = scale ? gl::mul(x[i], ninv) : x[i];
}

template <int MODE>
int launch_tile(const uint64_t* src, const uint64_t* other, uint64_t* dst,
                const uint64_t* wf, const uint64_t* wi, uint64_t ninv,
                int logN, int log_tile, int64_t rows, cudaStream_t s) {
    const int size = 1 << log_tile;
    const int smem = (MODE & PW_TILE ? 2 : 1) * size * 8;
    cudaError_t err = cudaFuncSetAttribute(
        ntt_tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = size / 2 < TILE_THREADS ? size / 2 : TILE_THREADS;
    const auto grid = static_cast<unsigned>(rows << (logN - log_tile));
    ntt_tile_kernel<MODE><<<grid, threads, smem, s>>>(src, other, dst, wf, wi,
                                                      ninv, logN, log_tile);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sizes are checked by the Python wrappers: 1 <= logN, the grid within
// 2^31 - 1 blocks, log_tile <= logN with the tile (two with PW_TILE) in
// 128 KB.

extern "C" int srt_ntt_stage(const void* src, void* dst, const void* w,
                             uint64_t ninv, int scaled, int logN, int s,
                             int64_t rows, int inverse, void* stream) {
    const int64_t total = rows << (logN - 1);
    const auto grid = static_cast<unsigned>(
        (total + STAGE_THREADS - 1) / STAGE_THREADS);
    const auto* sp = static_cast<const uint64_t*>(src);
    auto* dp = static_cast<uint64_t*>(dst);
    const auto* wp = static_cast<const uint64_t*>(w);
    auto st = static_cast<cudaStream_t>(stream);
    if (inverse)
        ntt_stage_kernel<true><<<grid, STAGE_THREADS, 0, st>>>(
            sp, dp, wp, ninv, scaled, logN, s, total);
    else
        ntt_stage_kernel<false><<<grid, STAGE_THREADS, 0, st>>>(
            sp, dp, wp, ninv, scaled, logN, s, total);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_ntt_tile(const void* src, const void* other, void* dst,
                            const void* wf, const void* wi, uint64_t ninv,
                            int logN, int log_tile, int64_t rows, int mode,
                            void* stream) {
    const auto* sp = static_cast<const uint64_t*>(src);
    const auto* op = static_cast<const uint64_t*>(other);
    auto* dp = static_cast<uint64_t*>(dst);
    const auto* fp = static_cast<const uint64_t*>(wf);
    const auto* ip = static_cast<const uint64_t*>(wi);
    auto st = static_cast<cudaStream_t>(stream);
    switch (mode) {
    case FWD:
        return launch_tile<FWD>(sp, op, dp, fp, ip, ninv, logN, log_tile,
                                rows, st);
    case INV:
        return launch_tile<INV>(sp, op, dp, fp, ip, ninv, logN, log_tile,
                                rows, st);
    case FWD | PW_GLOBAL | INV:
        return launch_tile<FWD | PW_GLOBAL | INV>(sp, op, dp, fp, ip, ninv,
                                                  logN, log_tile, rows, st);
    case FWD | PW_TILE | INV:
        return launch_tile<FWD | PW_TILE | INV>(sp, op, dp, fp, ip, ninv,
                                                logN, log_tile, rows, st);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
