// Bucket-fold epilogues and the slot product of the Goldilocks ring
// multiply, for Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
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
// All the folds are bound by device memory: a few dozen integer
// operations per output against 32-36 bytes of buckets read and 8
// bytes written.  Every read is coalesced (consecutive threads on
// consecutive columns, each warp reads 128 contiguous bytes of every
// bucket row), and the K loads of a thread are independent (unrolled),
// all in flight at once.  The untransposed kernels compute one output a
// thread and store it where it was read.
//
// K1 with the four-step's mid transpose stores the [R, t] tile of batch
// element b as out[j, b*R + r].  Stored straight from the fold,
// neighbouring threads (neighbouring j) would land B*R*8 bytes apart, one
// 32-byte sector per 8-byte store.  fold_tw_t_kernel gives a block a
// TILE_R x TILE_C = 32 x 32 (r x j) tile of one b instead: 256 threads
// read the buckets along c as above, fold and multiply by tw[r, j] into
// tile[j][r] in shared memory (8,448 B: 32 rows of 32 + 1 u64 words, the
// pad keeping both the write along j and the read along r free of bank
// conflicts in 64-bit half-warp phases), and after one __syncthreads
// store along r, so each j is a 256-byte run out[j*(B*R) + b*R + r0 ...].
// Ragged R and t are masked.  32 registers a thread let eight blocks
// (2,048 threads) share an SM, which kept more loads in flight than two
// rows' loads a thread at four blocks or wider tiles did
// (examples/tile_variants.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

// sum_k 2^26 * 2^(8k) for k < 9, mod q (the signed scheme's bucket bias).
constexpr uint64_t BIAS_MOD_Q = 578721382569606140ull;
constexpr int THREADS = 256;

// The fold of one point's K bucket words (the raw bits of V).
template <bool SIGNED>
__device__ __forceinline__ uint64_t fold_words(
        const uint32_t (&b)[SIGNED ? 9 : 8]) {
    constexpr int K = SIGNED ? 9 : 8;
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int s = 8 * k;
        const uint64_t v = SIGNED ? b[k] + (1u << 26) : b[k];
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

// fold(V) at one (r, c): p points at V[r, c], step = R * ld (one bucket).
template <bool SIGNED>
__device__ __forceinline__ uint64_t fold_point(const int32_t* __restrict__ p,
                                               int64_t step) {
    uint32_t b[SIGNED ? 9 : 8];
#pragma unroll
    for (int k = 0; k < (SIGNED ? 9 : 8); ++k)
        b[k] = static_cast<uint32_t>(p[k * step]);
    return fold_words<SIGNED>(b);
}

// K1: fold, times the mid twiddle tw[r, c mod t], stored [R, B*t].
// Replaces the whole-array fold_tw (stark_rings_tpu/ops/pallas_fold.py,
// pallas_call at :154).  Per call on the main path: 168 MB of buckets
// read, 0.5 MB of twiddles (cache-resident), 42 MB written.
template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
fold_tw_kernel(const int32_t* __restrict__ v, int64_t ld,
               const uint64_t* __restrict__ tw, int64_t t,
               uint64_t* __restrict__ out, int64_t R, int64_t cols) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (c >= cols) return;
    const int64_t j = c % t;
    out[r * cols + c] = gl::mul(fold_point<SIGNED>(v + r * ld + c, R * ld),
                                tw[r * t + j]);
}

// K1 transposed: the same product stored [t, B*R], out[j, b*R + r] (the
// four-step mid transpose).  Replaces fold_tw_dma (pallas_fold.py:377,
// pallas_call at :350 via _fold_dma), which ran the same fold on u32
// pairs in VMEM.  Block x is the tile (b, rows r0 + [0, TILE_R), columns
// j0 + [0, TILE_C)) with j-tiles fastest.  Each pass of THREADS threads
// folds PASS = THREADS / TILE_C rows of the tile; the loads of DEPTH
// passes are issued before any is folded.
constexpr int TILE_R = 32;
constexpr int TILE_C = 32;
constexpr int PASS = THREADS / TILE_C;
constexpr int DEPTH = 1;
constexpr int TILE_BLOCKS = 8;

template <bool SIGNED>
__global__ void __launch_bounds__(THREADS, TILE_BLOCKS)
fold_tw_t_kernel(const int32_t* __restrict__ v, int64_t ld,
                 const uint64_t* __restrict__ tw, int64_t t,
                 uint64_t* __restrict__ out, int64_t R, int64_t B,
                 int64_t j_tiles, int64_t r_tiles) {
    constexpr int K = SIGNED ? 9 : 8;
    __shared__ uint64_t tile[TILE_C][TILE_R + 1];
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
                tile[jl][rl] = gl::mul(fold_words<SIGNED>(w[d]),
                                       tw[(r0 + rl) * t + j]);
        }
    }
    __syncthreads();

    // store along r: thread (rl, jj) writes out[j0 + jj + i*THREADS/TILE_R,
    // b*R + r0 + rl]; a warp's 32 r are one 256-byte run
    const int rl = threadIdx.x % TILE_R;
    const int jj = threadIdx.x / TILE_R;
    const int64_t r = r0 + rl;
    if (r >= R) return;
    uint64_t* dst = out + b * R + r;
#pragma unroll
    for (int jt = jj; jt < TILE_C; jt += THREADS / TILE_R)
        if (j0 + jt < t) dst[(j0 + jt) * (B * R)] = tile[jt][rl];
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

// Goldilocks slot product out[i] = a[i] * b[i mod b_n] mod q over a flat
// range: b is a's shape or a table that broadcasts over a's leading axes
// (the four-step's twist and twiddles [N1, C] against [B, N1, C], a
// batch-1 cached operand).  BCAST = false when b_n == n skips the modulo.
// Replaces pointwise_mul (pallas_fold.py, pallas_call at :675) and K3b
// pointwise_dma (:639), which compute the same function on u32 planes in
// VMEM tiles.  One thread per element; on the main path (N = 2^16,
// B = 80) 84 MB read and 42 MB written per call, bound by device memory;
// a broadcast table is read from L2 after its first pass.
template <bool BCAST>
__global__ void __launch_bounds__(THREADS)
pointwise_mul_kernel(const uint64_t* __restrict__ a,
                     const uint64_t* __restrict__ b,
                     uint64_t* __restrict__ out, int64_t n, int64_t b_n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i < n) out[i] = gl::mul(a[i], b[BCAST ? i % b_n : i]);
}

// x <- x * b mod q, `depth` times, starting from x = a, over a flat range.
// Replaces pointwise_chain (pallas_fold.py:526, pallas_call at :545), which
// runs the same dependent chain on u32 pairs in VMEM.  The chain stays in
// registers: a and b are read once and x written once, so at depth 16 on
// [80, 2^16] (126 MB moved, 84M modmuls) it is bound by its modmuls'
// instructions, and at large depth it measures the rate of dependent
// Goldilocks modmuls the card sustains.  The loop is not unrolled: one
// trip is one gl::mul, so gl::mul's instruction count can be read off the
// loop body in the SASS (the card's modmul peak).
__global__ void __launch_bounds__(THREADS)
pointwise_chain_kernel(const uint64_t* __restrict__ a,
                       const uint64_t* __restrict__ b,
                       uint64_t* __restrict__ out, int64_t n, int depth) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= n) return;
    uint64_t x = a[i];
    const uint64_t y = b[i];
#pragma unroll 1
    for (int d = 0; d < depth; ++d) x = gl::mul(x, y);
    out[i] = x;
}

dim3 grid_for(int64_t R, int64_t cols) {
    return dim3(static_cast<unsigned>((cols + THREADS - 1) / THREADS),
                static_cast<unsigned>(R));
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Sizes are checked by the Python
// wrappers: R <= 65535, (cols + 255) / 256 < 2^31, t divides cols; the
// transposed K1 refuses (cudaErrorInvalidValue) a grid of 2^31 tiles.

extern "C" int srt_fold_tw(const void* v, int64_t ld, const void* tw,
                           int64_t t, void* out, int64_t R, int64_t cols,
                           int transpose_out, int is_signed, void* stream) {
    const auto* vp = static_cast<const int32_t*>(v);
    const auto* twp = static_cast<const uint64_t*>(tw);
    auto* op = static_cast<uint64_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (!transpose_out) {
        const dim3 grid = grid_for(R, cols);
        if (is_signed)
            fold_tw_kernel<true><<<grid, THREADS, 0, s>>>(vp, ld, twp, t, op,
                                                          R, cols);
        else
            fold_tw_kernel<false><<<grid, THREADS, 0, s>>>(vp, ld, twp, t,
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
        fold_tw_t_kernel<true><<<blocks, THREADS, 0, s>>>(
            vp, ld, twp, t, op, R, B, j_tiles, r_tiles);
    else
        fold_tw_t_kernel<false><<<blocks, THREADS, 0, s>>>(
            vp, ld, twp, t, op, R, B, j_tiles, r_tiles);
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

extern "C" int srt_pointwise_mul(const void* a, const void* b, void* out,
                                 int64_t n, int64_t b_n, void* stream) {
    const auto grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
    const auto* ap = static_cast<const uint64_t*>(a);
    const auto* bp = static_cast<const uint64_t*>(b);
    auto* op = static_cast<uint64_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (b_n == n)
        pointwise_mul_kernel<false><<<grid, THREADS, 0, s>>>(ap, bp, op, n,
                                                             b_n);
    else
        pointwise_mul_kernel<true><<<grid, THREADS, 0, s>>>(ap, bp, op, n,
                                                            b_n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_pointwise_chain(const void* a, const void* b, void* out,
                                   int64_t n, int depth, void* stream) {
    const auto grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
    pointwise_chain_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(
        stream)>>>(static_cast<const uint64_t*>(a),
                   static_cast<const uint64_t*>(b),
                   static_cast<uint64_t*>(out), n, depth);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
