// K4: bucket-fold epilogues of the BabyBear power-of-two ring multiply
// (BASELINE config 2), for Hopper (sm_90a).  Plain C entry points, loaded
// with ctypes by stark_rings_tpu_torch/ops/_build.py; wrappers and plain
// twins are in stark_rings_tpu_torch/ops/fold_bb.py.
//
// Replaces bb_fold_end_dma, bb_fold_tw_dma and bb_fold_end2_mul_dma of
// stark_rings_tpu/ops/pallas_fold_bb.py (one pallas_call, _bb_fold_dma,
// whose kernel is _make_bb_fold_dma_kernel over _bb_fold_rows and
// _bb_mont_mul).  The TPU kernels double-buffer column chunks through
// VMEM; here the untransposed kernels compute one output a thread straight
// from device memory, as the Goldilocks folds of fold.cu do, and the
// transposed bb_fold_tw goes through a tile in shared memory.
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
// thread independent and in flight together).
//
// The transposed bb_fold_tw stores the [R, t] tile of batch element b as
// out[j, b*R + r].  Stored straight from the fold, neighbouring threads
// (neighbouring j) land B*R*4 bytes apart, one 32-byte sector per 4-byte
// store: eight times the output's bytes.  bb_fold_tw_t_kernel instead
// gives one block a 32 x 64 tile (rows r, columns j) of one b: it reads
// the buckets along c, as above, folds into tile[j][r] in shared memory
// (one word of padding a row, so neither the write along j nor the read
// along r has a bank conflict), and after __syncthreads stores along r,
// so each j is one 128-byte line out[j*(B*R) + b*R + r0 ...].  Ragged
// edges (R or t not a multiple of the tile) are masked.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

// (sum_k 2^26 * 2^(8k) for k < 5) * 2^-32 mod q: the signed scheme's
// bucket bias after the REDC.
constexpr uint32_t BIAS_RED = 35914756u;
constexpr int THREADS = 256;

// The fold of one point's K bucket words.
template <bool SIGNED>
__device__ __forceinline__ uint32_t fold_words(
        const uint32_t (&b)[SIGNED ? 5 : 4]) {
    constexpr int K = SIGNED ? 5 : 4;
    uint64_t acc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const uint32_t w = SIGNED ? b[k] + (1u << 26) : b[k];
        acc += static_cast<uint64_t>(w) << (8 * k);
    }
    const uint32_t t = bb::redc64(acc);
    if (!SIGNED) return t;
    return t < BIAS_RED ? t + (bb::Q - BIAS_RED) : t - BIAS_RED;
}

// fold(V) at one (r, c): p points at V[r, c], step = R * ld (one bucket).
template <bool SIGNED>
__device__ __forceinline__ uint32_t fold_point(const int32_t* __restrict__ p,
                                               int64_t step) {
    uint32_t b[SIGNED ? 5 : 4];
#pragma unroll
    for (int k = 0; k < (SIGNED ? 5 : 4); ++k)
        b[k] = static_cast<uint32_t>(p[k * step]);
    return fold_words<SIGNED>(b);
}

// fold times the Montgomery twiddle tw[r, c mod t], stored [R, B*t].
template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
bb_fold_tw_kernel(const int32_t* __restrict__ v, int64_t ld,
                  const uint32_t* __restrict__ tw, int64_t t,
                  uint32_t* __restrict__ out, int64_t R, int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t b = c / t;
    const int64_t j = c - b * t;
    out[r * cols + c] = bb::mont_mul(fold_point<SIGNED>(v + r * ld + c,
                                                        R * ld),
                                     tw[r * t + j]);
}

// The same product stored transposed, [t, B*R]: block x is the tile
// (b, rows r0 + [0, TILE_R), columns j0 + [0, TILE_C)) with j-tiles
// fastest.  Each pass of THREADS threads folds PASS = THREADS / TILE_C
// rows of the tile; the loads of DEPTH passes are issued before any is
// folded.  Six blocks an SM (at most 40 registers a thread) keep the
// most loads in flight.  (On an H100 at the main path's shape, 32 x 64 at
// DEPTH 4 ran fastest of the 64 x 64, 64 x 32, 32 x 128 and 32 x 64 tiles,
// and six resident blocks faster than five or eight.)
constexpr int TILE_R = 32;
constexpr int TILE_C = 64;
constexpr int PASS = THREADS / TILE_C;
constexpr int DEPTH = 4;
constexpr int TILE_BLOCKS = 6;

template <bool SIGNED>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS)
bb_fold_tw_t_kernel(const int32_t* __restrict__ v, int64_t ld,
                    const uint32_t* __restrict__ tw, int64_t t,
                    uint32_t* __restrict__ out, int64_t R, int64_t B,
                    int64_t j_tiles, int64_t r_tiles) {
    constexpr int K = SIGNED ? 5 : 4;
    __shared__ uint32_t tile[TILE_C][TILE_R + 1];
    int64_t blk = blockIdx.x;
    const int64_t j0 = blk % j_tiles * TILE_C;
    blk /= j_tiles;
    const int64_t r0 = blk % r_tiles * TILE_R;
    const int64_t b = blk / r_tiles;
    const int64_t step = R * ld;

    // fold along c: thread (jl, rr) takes column j0 + jl of rows
    // r0 + rr, r0 + rr + PASS, ...
    const int jl = threadIdx.x % TILE_C;
    const int rr = threadIdx.x / TILE_C;
    const int64_t j = j0 + jl;
    const bool j_in = j < t;
    const int32_t* col = v + b * t + j;
#pragma unroll
    for (int p0 = 0; p0 < TILE_R; p0 += PASS * DEPTH) {
        uint32_t w[DEPTH][K];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
            const int64_t r = r0 + p0 + d * PASS + rr;
            const bool in = j_in && r < R;
#pragma unroll
            for (int k = 0; k < K; ++k)
                w[d][k] = in ? static_cast<uint32_t>(col[r * ld + k * step])
                             : 0u;
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
            const int rl = p0 + d * PASS + rr;
            if (j_in && r0 + rl < R)
                tile[jl][rl] = bb::mont_mul(fold_words<SIGNED>(w[d]),
                                            tw[(r0 + rl) * t + j]);
        }
    }
    __syncthreads();

    // store along r: thread (rl, jj) writes out[j0 + jj + i*THREADS/TILE_R,
    // b*R + r0 + rl]; a warp's 32 r are one 128-byte line
    const int rl = threadIdx.x % TILE_R;
    const int jj = threadIdx.x / TILE_R;
    const int64_t r = r0 + rl;
    if (r >= R) return;
    uint32_t* dst = out + b * R + r;
#pragma unroll
    for (int jt = jj; jt < TILE_C; jt += THREADS / TILE_R)
        if (j0 + jt < t) dst[(j0 + jt) * (B * R)] = tile[jt][rl];
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
    if (!transpose_out) {
        const dim3 grid = grid_for(R, cols);
        if (is_signed)
            bb_fold_tw_kernel<true><<<grid, THREADS, 0, s>>>(vp, ld, twp, t,
                                                             op, R, cols);
        else
            bb_fold_tw_kernel<false><<<grid, THREADS, 0, s>>>(vp, ld, twp, t,
                                                              op, R, cols);
        return static_cast<int>(cudaGetLastError());
    }
    const int64_t B = cols / t;
    const int64_t j_tiles = (t + TILE_C - 1) / TILE_C;
    const int64_t r_tiles = (R + TILE_R - 1) / TILE_R;
    if (B * j_tiles * r_tiles >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto blocks = static_cast<unsigned>(B * j_tiles * r_tiles);
    if (is_signed)
        bb_fold_tw_t_kernel<true><<<blocks, THREADS, 0, s>>>(
            vp, ld, twp, t, op, R, B, j_tiles, r_tiles);
    else
        bb_fold_tw_t_kernel<false><<<blocks, THREADS, 0, s>>>(
            vp, ld, twp, t, op, R, B, j_tiles, r_tiles);
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
