// Goldilocks MLE kernels for Hopper (sm_90a): full evaluation (K5),
// fix-last-variables (K6) and the one-pass k-ary product sumcheck
// prover (K7).  Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; wrappers and plain twins are in
// stark_rings_tpu_torch/mle/fix.py and mle/sumcheck_kernel.py.
//
// A table is u64 [2^nv] in canonical storage, little-endian index:
// variable j is bit j of the index.  Binding variable j to r maps each
// pair (l, u) of entries that differ only in bit j to l + r*(u - l).
//
// The TPU kernels (stark_rings_tpu/mle/pallas_fix.py and
// pallas_sumcheck.py) keep a half-size copy of each table in VMEM
// scratch and bind top variables on contiguous row halves.  At nv = 20
// that copy is 4 MB per table, far above a Hopper SM's 227 KB of shared
// memory, so the designs here differ:
//   K5 binds the low variables first, one 2^10-entry tile per block in
//      shared memory: the table is read once, and nv = 20 is two
//      launches (tiles of the table, then the tile of the 2^10 partials).
//   K6 must bind the top variables: each thread owns one output index
//      and combines its 2^s strided inputs (coalesced across the warp)
//      in registers, s <= 5 variables per launch.
//   K7 launches once per round; its half-size tables live in device
//      memory (L2-resident at nv = 20) and are folded in place.
// All three are bound by memory traffic and launch latency, not by the
// modular arithmetic: one lerp (one 64x64->128 multiply) per entry read.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5: full evaluation.  Replaces evaluate_goldilocks_pallas
// (stark_rings_tpu/mle/pallas_fix.py, _make_eval_kernel and _lerp).
// ---------------------------------------------------------------------------

constexpr int EVAL_THREADS = 256;
constexpr int EVAL_MAX_BITS = 10;

// Block b binds the m low variables of tile b (entries b*2^m ...
// (b+1)*2^m - 1) to pts[0..m-1] and writes the value to out[b].  The
// tile's top variable is bound while it is loaded (two coalesced reads
// per thread), the rest in shared memory on top and bottom halves.
__global__ void __launch_bounds__(EVAL_THREADS)
mle_eval_tiles_kernel(const uint64_t* __restrict__ in,
                      uint64_t* __restrict__ out, int m,
                      const uint64_t* __restrict__ pts) {
    __shared__ uint64_t s[1 << (EVAL_MAX_BITS - 1)];
    const uint64_t* tile = in + (static_cast<int64_t>(blockIdx.x) << m);
    int h = 1 << (m - 1);
    const uint64_t r_top = pts[m - 1];
    for (int i = threadIdx.x; i < h; i += EVAL_THREADS)
        s[i] = gl::lerp(tile[i], tile[i + h], r_top);
    for (int j = m - 2; j >= 0; --j) {
        __syncthreads();
        h = 1 << j;
        const uint64_t r = pts[j];
        // s[i] is read and written only by the thread that owns i < h
        for (int i = threadIdx.x; i < h; i += EVAL_THREADS)
            s[i] = gl::lerp(s[i], s[i + h], r);
    }
    if (threadIdx.x == 0) out[blockIdx.x] = s[0];  // written by thread 0
}

// ---------------------------------------------------------------------------
// K6: fix the last variables.  Replaces fix_last_goldilocks_pallas
// (pallas_fix.py, _make_fix_kernel).
// ---------------------------------------------------------------------------

constexpr int FIX_THREADS = 256;
constexpr int FIX_MAX_BITS = 5;

// The multilinear value of p[(base + j)*M], j < 2^S, at pts[0..S-1]
// (bit t of j bound to pts[t]): the top bit splits j into two halves.
// Written as a compile-time recursion so the 2^S loads are independent
// scalars the compiler keeps in registers (an indexed local array was
// placed in local memory).
template <int S>
__device__ __forceinline__ uint64_t fix_tree(const uint64_t* p, int64_t M,
                                             int base, const uint64_t* pts) {
    if constexpr (S == 0) {
        return p[base * M];
    } else {
        const uint64_t lo = fix_tree<S - 1>(p, M, base, pts);
        const uint64_t hi = fix_tree<S - 1>(p, M, base + (1 << (S - 1)), pts);
        return gl::lerp(lo, hi, pts[S - 1]);
    }
}

// Binds the top S variables of a table of 2^S * M entries: out[i] for
// i < M combines in[i + j*M], j < 2^S, where bit t of j is the variable
// bound to pts[t].  Consecutive threads read consecutive addresses for
// every j.
template <int S>
__global__ void __launch_bounds__(FIX_THREADS)
mle_fix_top_kernel(const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, int64_t M,
                   const uint64_t* __restrict__ pts) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * FIX_THREADS
                      + threadIdx.x;
    if (i < M) out[i] = fix_tree<S>(in + i, M, 0, pts);
}

template <int S>
void launch_fix(const uint64_t* in, uint64_t* out, int64_t M,
                const uint64_t* pts, cudaStream_t s) {
    const auto blocks = static_cast<unsigned>((M + FIX_THREADS - 1)
                                              / FIX_THREADS);
    mle_fix_top_kernel<S><<<blocks, FIX_THREADS, 0, s>>>(in, out, M, pts);
}

// ---------------------------------------------------------------------------
// K7: k-ary product sumcheck, msb order.  Replaces
// sumcheck_prove_many_pallas (pallas_sumcheck.py, _make_kernel with
// _GlOps).
// ---------------------------------------------------------------------------

constexpr int SC_THREADS = 256;
constexpr int SC_MAX_BLOCKS = 1024;
constexpr int SC_MAX_K = 8;

// Blocks of a round on 2*half entries per table; the reduce kernel
// recomputes it to find each round's partials.
__host__ __device__ inline int sc_blocks(int64_t half) {
    const int64_t b = (half + SC_THREADS - 1) / SC_THREADS;
    return b < SC_MAX_BLOCKS ? static_cast<int>(b) : SC_MAX_BLOCKS;
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = gl::add(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Modular sum over the block; the result is valid in thread 0.  Every
// thread of the block must call it.
__device__ uint64_t block_sum(uint64_t v, uint64_t* sh) {
    v = warp_sum(v);
    __syncthreads();                     // sh may still be read
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    v = threadIdx.x < SC_THREADS / 32 ? sh[threadIdx.x] : 0;
    return threadIdx.x < 32 ? warp_sum(v) : v;
}

struct Tables {
    const uint64_t* in[SC_MAX_K];
    uint64_t* out[SC_MAX_K];
};

// One round on tables of 2*half entries: the message sums
// p(t) = sum_x prod_j (T_j[x] + t*(T_j[x+half] - T_j[x])), t = 0..K, as
// per-block partials, and the fold T_j[x] + r*(T_j[x+half] - T_j[x])
// into out[j][x] (which may be in[j]: entry x is read and written only
// by its own thread).
template <int K>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_round_kernel(Tables tb, int64_t half,
                      const uint64_t* __restrict__ chal, int round,
                      uint64_t* __restrict__ partials) {
    __shared__ uint64_t sh[SC_THREADS / 32];
    const uint64_t r = chal[round];
    uint64_t acc[K + 1];
#pragma unroll
    for (int t = 0; t <= K; ++t) acc[t] = 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * SC_THREADS;
    for (int64_t x = static_cast<int64_t>(blockIdx.x) * SC_THREADS
                     + threadIdx.x; x < half; x += stride) {
        uint64_t lo[K], d[K], cur[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            lo[j] = tb.in[j][x];
            d[j] = gl::sub(tb.in[j][x + half], lo[j]);
            cur[j] = lo[j];
        }
#pragma unroll
        for (int t = 0; t <= K; ++t) {
            if (t) {
#pragma unroll
                for (int j = 0; j < K; ++j) cur[j] = gl::add(cur[j], d[j]);
            }
            uint64_t p = cur[0];
#pragma unroll
            for (int j = 1; j < K; ++j) p = gl::mul(p, cur[j]);
            acc[t] = gl::add(acc[t], p);
        }
#pragma unroll
        for (int j = 0; j < K; ++j)
            tb.out[j][x] = gl::add(lo[j], gl::mul(r, d[j]));
    }
    uint64_t* row = partials
        + (static_cast<int64_t>(round) * SC_MAX_BLOCKS + blockIdx.x) * (K + 1);
#pragma unroll
    for (int t = 0; t <= K; ++t) {
        const uint64_t s = block_sum(acc[t], sh);
        if (threadIdx.x == 0) row[t] = s;
    }
}

// msgs[round, t] = sum of that round's per-block partials; one block per
// round.
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_reduce_kernel(const uint64_t* __restrict__ partials,
                       uint64_t* __restrict__ msgs, int k1, int64_t half0) {
    __shared__ uint64_t sh[SC_THREADS / 32];
    const int round = blockIdx.x;
    const int nb = sc_blocks(half0 >> round);
    const uint64_t* rows = partials
        + static_cast<int64_t>(round) * SC_MAX_BLOCKS * k1;
    for (int t = 0; t < k1; ++t) {
        uint64_t a = 0;
        for (int b = threadIdx.x; b < nb; b += SC_THREADS)
            a = gl::add(a, rows[b * k1 + t]);
        a = block_sum(a, sh);
        if (threadIdx.x == 0) msgs[round * k1 + t] = a;
    }
}

template <int K>
void launch_round(const Tables& tb, int64_t half, const uint64_t* chal,
                  int round, uint64_t* partials, cudaStream_t s) {
    sumcheck_round_kernel<K><<<sc_blocks(half), SC_THREADS, 0, s>>>(
        tb, half, chal, round, partials);
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  The Python wrappers check sizes.

// K5 stage: n_tiles tiles of 2^m entries (1 <= m <= 10) -> n_tiles values.
extern "C" int srt_mle_eval_tiles(const void* in, void* out, int64_t n_tiles,
                                  int m, const void* pts, void* stream) {
    if (m < 1 || m > EVAL_MAX_BITS || n_tiles < 1 || n_tiles >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    mle_eval_tiles_kernel<<<static_cast<unsigned>(n_tiles), EVAL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), m,
        static_cast<const uint64_t*>(pts));
    return static_cast<int>(cudaGetLastError());
}

// K6 stage: a table of 2^s * M entries -> M entries, top s variables
// bound (1 <= s <= 5).
extern "C" int srt_mle_fix_top(const void* in, void* out, int64_t M, int s,
                               const void* pts, void* stream) {
    if (M < 1 || (M + FIX_THREADS - 1) / FIX_THREADS >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* ip = static_cast<const uint64_t*>(in);
    auto* op = static_cast<uint64_t*>(out);
    const auto* pp = static_cast<const uint64_t*>(pts);
    auto st = static_cast<cudaStream_t>(stream);
    switch (s) {
        case 1: launch_fix<1>(ip, op, M, pp, st); break;
        case 2: launch_fix<2>(ip, op, M, pp, st); break;
        case 3: launch_fix<3>(ip, op, M, pp, st); break;
        case 4: launch_fix<4>(ip, op, M, pp, st); break;
        case 5: launch_fix<5>(ip, op, M, pp, st); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// K7 round: `ins` / `outs` are host arrays of k device pointers (the
// tables read this round and the half-size tables written); partials is
// u64 [rounds, 1024, k+1].
extern "C" int srt_sumcheck_round(const void* ins, const void* outs, int k,
                                  int64_t half, const void* chal, int round,
                                  void* partials, void* stream) {
    if (k < 1 || k > SC_MAX_K || half < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Tables tb{};
    for (int j = 0; j < k; ++j) {
        tb.in[j] = static_cast<const uint64_t* const*>(ins)[j];
        tb.out[j] = static_cast<uint64_t* const*>(outs)[j];
    }
    const auto* cp = static_cast<const uint64_t*>(chal);
    auto* pp = static_cast<uint64_t*>(partials);
    auto st = static_cast<cudaStream_t>(stream);
    switch (k) {
        case 1: launch_round<1>(tb, half, cp, round, pp, st); break;
        case 2: launch_round<2>(tb, half, cp, round, pp, st); break;
        case 3: launch_round<3>(tb, half, cp, round, pp, st); break;
        case 4: launch_round<4>(tb, half, cp, round, pp, st); break;
        case 5: launch_round<5>(tb, half, cp, round, pp, st); break;
        case 6: launch_round<6>(tb, half, cp, round, pp, st); break;
        case 7: launch_round<7>(tb, half, cp, round, pp, st); break;
        default: launch_round<8>(tb, half, cp, round, pp, st); break;
    }
    return static_cast<int>(cudaGetLastError());
}

// K7 messages: msgs u64 [rounds, k1] from the partials of rounds whose
// halves are half0, half0/2, ...
extern "C" int srt_sumcheck_reduce(const void* partials, void* msgs, int k1,
                                   int rounds, int64_t half0, void* stream) {
    if (k1 < 2 || k1 > SC_MAX_K + 1 || rounds < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    sumcheck_reduce_kernel<<<rounds, SC_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(partials), static_cast<uint64_t*>(msgs),
        k1, half0);
    return static_cast<int>(cudaGetLastError());
}
