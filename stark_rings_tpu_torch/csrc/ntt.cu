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
//   * stages with 2t <= TILE = 2^log_tile (2^13 words, 64 KB, from
//     LOG_TILE in goldilocks_ntt.py; the kernel takes up to 2^14) keep
//     every aligned TILE-word block of a row independent: ntt_tile_kernel
//     runs all of them, one tile per 2^(log_tile - RB) threads;
//   * the stages with 2t > TILE (3 of them at N = 2^16) are grid-wide
//     passes over device memory, one launch each (ntt_stage_kernel, one
//     butterfly a thread).
//
// Twiddles: the reference's one [N] table per direction in the m + i
// layout (stage s with m = 2^s blocks reads entries [m, 2m)); 1/N is a
// kernel argument.  Forward butterflies are Cooley-Tukey (a + w b, a - w b),
// inverse ones Gentleman-Sande (a + b, w^-1 (a - b)) in the reverse stage
// order, then x 1/N.
//
// The tile kernel is bound by the card's integer pipes: a butterfly is a
// modmul (29 instructions) and an exact sum and difference, all integer
// instructions, which retire at about half the SMs' issue rate (the dependent
// chain of pointwise_chain at depth 256), so the design keeps the butterflies in
// registers and pays little else.  A tile's stage of span 2^h pairs words
// whose index differs in bit h.  A thread holds REG = 2^RB words whose indices
// differ in RB consecutive bits [lo, lo + RB) (the other bits are its index in
// the tile) and runs the stages of those bits in registers; a round is such a
// run, and between two rounds the tile is exchanged once through shared
// memory: each thread writes its words, one __syncthreads, each reads the
// words of its next bit set (and writes them back to the same places at the
// next exchange, so one barrier an exchange is enough).  Words sit at
// i + (i >> RB) in shared memory: that pad keeps every exchange free of bank
// conflicts in 64-bit half-warp phases, whatever lo is.  The forward runs bits
// from the top down in rounds of RB, the inverse from the bottom up, so the
// forward's last round and the inverse's first share the bit set [0, RB): in
// mul_eval and mul the slot product sits between them in registers.  A 2^13
// tile is 4 rounds a direction (bits 9-12, 5-8, 1-4, 0), 3 exchanges; mul_eval
// has 6 barriers (the first design, one butterfly a thread a stage in shared
// memory, had one a stage: 30 at 2^14).  Loads and stores of device memory go
// straight from registers: coalesced across threads in a round with lo >= 5,
// 16-byte vector accesses of a thread's 2^RB contiguous words in a round with
// lo = 0.
//
// Geometry: 2^(log_tile - RB) threads a tile, 512 at 2^13 (1,024 at 2^14),
// at most 64 registers a thread (128 for mul's two operands); shared
// memory 8 (2^13 + 2^9) words = 69,632 B at 2^13, so two blocks share an
// SM (139,264 B and one block at 2^14).  Tiles of fewer than 64 threads
// share a block of 64; a tile of at most 2^RB words is one thread and one
// round, with no shared memory.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int STAGE_THREADS = 256;

// Mode bits of ntt_tile_kernel.
constexpr int FWD = 1;     // forward stages of the tile
constexpr int PW_GLOBAL = 2;  // times `other` (evaluations) from device memory
constexpr int PW_TILE = 4;    // times the forward transform of `other`,
                              // held in registers beside x's
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

// Register rounds of the tile kernel (see the header).
constexpr int RB = 4;                 // log2 words a thread holds
constexpr int REG = 1 << RB;
constexpr int LOG_TILE_MAX = 14;
constexpr int TILE_THREADS = 1 << (LOG_TILE_MAX - RB);
constexpr int MIN_THREADS = 64;       // threads a block at least

// Tile index of word (u, j): thread u of the tile, register j, bit set
// [lo, lo + RB).
__device__ __forceinline__ int word_at(int u, int lo, int j) {
    return ((u >> lo) << (lo + RB)) | (j << lo) | (u & ((1 << lo) - 1));
}

// Shared-memory place of tile word i (one pad word every REG words).
__device__ __forceinline__ int spad(int i) { return i + (i >> RB); }

// One thread's place: its tile (global index, index within its row),
// its index u in the tile, and the tile's log size L.
struct Place {
    const uint64_t* wf;
    const uint64_t* wi;
    int64_t base;      // first word of the tile in the rows
    int64_t tile;      // tile index within its row
    int logN, L, u;
    bool live;         // false for the padding tiles of the last block
};

// The stage of bit h = lo + B on the thread's registers, when h is in
// [e_lo, e_hi): pairs (j, j | 2^B), the twiddle of pair j entry
// 2^s + (tile << (L - h - 1)) + (word >> (h + 1)) of the stage s =
// logN - 1 - h, where word >> (h + 1) = (u >> lo) << (RB - 1 - B) |
// j >> (B + 1).
template <bool INVERSE, int B>
__device__ __forceinline__ void reg_stage(uint64_t (&x)[REG], const Place& p,
                                          int lo, int e_lo, int e_hi) {
    const int h = lo + B;
    if (h < e_lo || h >= e_hi) return;
    constexpr int NW = 1 << (RB - 1 - B);
    const auto* wb = reinterpret_cast<const unsigned long long*>(
        (INVERSE ? p.wi : p.wf) + (int64_t{1} << (p.logN - 1 - h))
        + (p.tile << (p.L - h - 1))
        + (static_cast<int64_t>(p.u >> lo) << (RB - 1 - B)));
    // a tile below REG words reads only its own 2^(L-1-B) entries
    const int nw = p.L > RB ? NW : 1 << (p.L - 1 - B);
    uint64_t tw[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) tw[k] = k < nw ? __ldg(wb + k) : 0;
#pragma unroll
    for (int j = 0; j < REG; ++j) {
        if (j & (1 << B)) continue;
        if (INVERSE)
            butterfly_inv(x[j], x[j | (1 << B)], tw[j >> (B + 1)]);
        else
            butterfly_fwd(x[j], x[j | (1 << B)], tw[j >> (B + 1)]);
    }
}

// The stages of bits [e_lo, e_hi) (a subset of [lo, lo + RB)): forward
// from the top bit down, inverse from the bottom up.
template <bool INVERSE, int... Bs>
__device__ __forceinline__ void reg_stages(uint64_t (&x)[REG], const Place& p,
                                           int lo, int e_lo, int e_hi,
                                           std::integer_sequence<int, Bs...>) {
    (reg_stage<INVERSE, INVERSE ? Bs : RB - 1 - Bs>(x, p, lo, e_lo, e_hi),
     ...);
}

template <bool INVERSE>
__device__ __forceinline__ void reg_stages(uint64_t (&x)[REG], const Place& p,
                                           int lo, int e_lo, int e_hi) {
    reg_stages<INVERSE>(x, p, lo, e_lo, e_hi,
                        std::make_integer_sequence<int, RB>{});
}

// Device memory -> registers in the mapping of bit set [lo, lo + RB).
__device__ __forceinline__ void load_words(uint64_t (&x)[REG],
                                           const uint64_t* src,
                                           const Place& p, int lo) {
    const uint64_t* t = src + p.base;
    if (lo == 0) {   // the thread's words are contiguous: 16-byte loads
        const auto* v = reinterpret_cast<const ulonglong2*>(t + (p.u << RB));
#pragma unroll
        for (int j = 0; j < REG; j += 2) {
            const bool in = p.live && j < (1 << p.L);
            const ulonglong2 y = in ? v[j / 2] : make_ulonglong2(0, 0);
            x[j] = y.x;
            x[j + 1] = y.y;
        }
    } else {
#pragma unroll
        for (int j = 0; j < REG; ++j)
            x[j] = p.live ? t[word_at(p.u, lo, j)] : 0;
    }
}

// Registers -> device memory, times `scale` when it is not 1.
__device__ __forceinline__ void store_words(const uint64_t (&x)[REG],
                                            uint64_t* dst, const Place& p,
                                            int lo, uint64_t scale) {
    if (!p.live) return;
    uint64_t* t = dst + p.base;
    uint64_t y[REG];
#pragma unroll
    for (int j = 0; j < REG; ++j) y[j] = scale != 1 ? gl::mul(x[j], scale)
                                                    : x[j];
    if (lo == 0) {
        auto* v = reinterpret_cast<ulonglong2*>(t + (p.u << RB));
#pragma unroll
        for (int j = 0; j < REG; j += 2)
            if (j < (1 << p.L)) v[j / 2] = make_ulonglong2(y[j], y[j + 1]);
    } else {
#pragma unroll
        for (int j = 0; j < REG; ++j) t[word_at(p.u, lo, j)] = y[j];
    }
}

// The exchange between rounds: registers in the mapping of bit set
// [lo, ...) out, one barrier, registers in the mapping of [next, ...) in.
__device__ __forceinline__ void exchange(uint64_t (&x)[REG], uint64_t* sh,
                                         const Place& p, int lo, int next) {
#pragma unroll
    for (int j = 0; j < REG; ++j) sh[spad(word_at(p.u, lo, j))] = x[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < REG; ++j) x[j] = sh[spad(word_at(p.u, next, j))];
}

// The forward stages of the tile, from registers in the mapping of bit
// set [top, top + RB), top = max(L - RB, 0), to the mapping of [0, RB).
__device__ __forceinline__ void forward_rounds(uint64_t (&x)[REG],
                                               uint64_t* sh, const Place& p) {
    int lo = p.L > RB ? p.L - RB : 0;
    reg_stages<false>(x, p, lo, lo, p.L);
    for (int hi = lo; hi > 0; hi = lo) {
        const int next = hi > RB ? hi - RB : 0;
        exchange(x, sh, p, lo, next);
        lo = next;
        reg_stages<false>(x, p, lo, lo, hi);
    }
}

// The inverse stages of the tile, from registers in the mapping of
// [0, RB) to the mapping of [top, top + RB).
__device__ __forceinline__ void inverse_rounds(uint64_t (&x)[REG],
                                               uint64_t* sh, const Place& p) {
    const int top = p.L > RB ? p.L - RB : 0;
    reg_stages<true>(x, p, 0, 0, p.L < RB ? p.L : RB);
    int lo = 0;
    for (int e = RB; e < p.L; e += RB) {
        const int next = e < top ? e : top;
        exchange(x, sh, p, lo, next);
        lo = next;
        reg_stages<true>(x, p, lo, e, e + RB < p.L ? e + RB : p.L);
    }
}

// One tile of 2^log_tile words per 2^(log_tile - RB) threads (at least
// one): load x's tile (and, with PW_TILE, other's), run the MODE's steps,
// store to dst (which may be src: a tile's words are all loaded before
// its first exchange's barrier, or by the one thread that stores them,
// and stored after its last).  The last inverse stage of a
// row multiplies by ninv when the tile is the whole row (log_tile ==
// logN).  `tiles` is rows << (logN - log_tile).
template <int MODE>
__global__ void __launch_bounds__((MODE & PW_TILE) ? TILE_THREADS / 2
                                                   : TILE_THREADS)
ntt_tile_kernel(const uint64_t* src, const uint64_t* __restrict__ other,
                uint64_t* dst, const uint64_t* __restrict__ wf,
                const uint64_t* __restrict__ wi, uint64_t ninv, int logN,
                int log_tile, int64_t tiles) {
    extern __shared__ uint64_t smem[];
    const int L = log_tile;
    const int lt = L > RB ? L - RB : 0;       // log2 threads a tile
    const int per_block = blockDim.x >> lt;   // tiles a block
    const int slot = threadIdx.x >> lt;
    const int64_t g = static_cast<int64_t>(blockIdx.x) * per_block + slot;
    Place p;
    p.wf = wf;
    p.wi = wi;
    p.logN = logN;
    p.L = L;
    p.u = threadIdx.x & ((1 << lt) - 1);
    p.live = g < tiles;
    p.tile = g & ((int64_t{1} << (logN - L)) - 1);
    p.base = g << L;
    uint64_t* sh = smem + slot * ((1 << L) + ((1 << L) >> RB));
    const int top = lt ? L - RB : 0;

    uint64_t x[REG];
    uint64_t y[REG];
    if constexpr ((MODE & PW_TILE) != 0) {
        load_words(y, other, p, top);
        forward_rounds(y, sh, p);
        __syncthreads();   // y's last exchange is read before x's first
    }
    load_words(x, src, p, (MODE & FWD) ? top : 0);
    if constexpr ((MODE & FWD) != 0) forward_rounds(x, sh, p);
    if constexpr ((MODE & PW_TILE) != 0) {
#pragma unroll
        for (int j = 0; j < REG; ++j) x[j] = gl::mul(x[j], y[j]);
    }
    if constexpr ((MODE & PW_GLOBAL) != 0) {
        uint64_t o[REG];
        load_words(o, other, p, 0);
#pragma unroll
        for (int j = 0; j < REG; ++j) x[j] = gl::mul(x[j], o[j]);
    }
    if constexpr ((MODE & INV) != 0) {
        inverse_rounds(x, sh, p);
        store_words(x, dst, p, top, L == logN ? ninv : 1);
    } else {
        store_words(x, dst, p, 0, 1);
    }
}

template <int MODE>
int launch_tile(const uint64_t* src, const uint64_t* other, uint64_t* dst,
                const uint64_t* wf, const uint64_t* wi, uint64_t ninv,
                int logN, int log_tile, int64_t rows, cudaStream_t s) {
    if (log_tile > LOG_TILE_MAX) return static_cast<int>(
        cudaErrorInvalidValue);
    const int lt = log_tile > RB ? log_tile - RB : 0;
    const int threads = (1 << lt) > MIN_THREADS ? 1 << lt : MIN_THREADS;
    const int per_block = threads >> lt;
    // shared memory only where a tile has rounds to exchange
    const int smem = lt ? per_block * ((1 << log_tile)
                                       + ((1 << log_tile) >> RB)) * 8
                        : 0;
    cudaError_t err = cudaFuncSetAttribute(
        ntt_tile_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t tiles = rows << (logN - log_tile);
    const auto grid = static_cast<unsigned>((tiles + per_block - 1)
                                            / per_block);
    ntt_tile_kernel<MODE><<<grid, threads, smem, s>>>(
        src, other, dst, wf, wi, ninv, logN, log_tile, tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Sizes are checked by the Python wrappers: 1 <= logN, the grid within
// 2^31 - 1 blocks, 1 <= log_tile <= logN; PW_TILE only with the whole row
// in a tile of at most 2^13 words.  srt_ntt_tile refuses (returns
// cudaErrorInvalidValue) log_tile > LOG_TILE_MAX.

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
