// MLE kernels for Hopper (sm_90a): full evaluation (K5) and
// fix-last-variables (K6) of Goldilocks tables, and the one-pass k-ary
// product sumcheck prover (K7) over Goldilocks, BabyBear or frog, for
// one claim or a batch of claims.  Plain C entry points, loaded with
// ctypes by stark_rings_tpu_torch/ops/_build.py; wrappers and plain twins
// are in stark_rings_tpu_torch/mle/fix.py and mle/sumcheck_kernel.py.
//
// A table is [2^nv] words of its field's storage (u64 canonical
// Goldilocks, u32 Montgomery BabyBear, u64 Montgomery frog), with a
// little-endian index: variable j is bit j of the index.  Binding variable j to r maps each
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
//      memory (L2-resident at nv = 20) and are folded in place.  A batch
//      of claims is a second grid axis, so a proof of any number of
//      claims is nv + 1 launches.
// All three are bound by memory traffic and launch latency, not by the
// modular arithmetic: one lerp (one 64x64->128 multiply; three for
// frog's Montgomery product) per entry read.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"
#include "frog.cuh"
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
// K7: k-ary product sumcheck, msb order, over Goldilocks, BabyBear or frog,
// for one claim or a batch of claims that share the challenges.  Replaces
// sumcheck_prove_many_pallas (pallas_sumcheck.py, _make_kernel with
// _GlOps, _BbOps or _FrogOps) and sumcheck_prove_batch_goldilocks_pallas,
// which loops over the claims with one kernel each: here blockIdx.y is
// the claim, so one launch per round serves every claim.
// ---------------------------------------------------------------------------

constexpr int SC_THREADS = 256;
constexpr int SC_MAX_BLOCKS = 1024;
constexpr int SC_MAX_K = 8;
constexpr int SC_MAX_CLAIMS = 65535;     // gridDim.y

// The field ops of K7 on the field's storage form (as the reference's
// ops classes): its word type and add, sub and mul.  0 is the storage
// of 0 in every field.
struct GlOps {
    using word = uint64_t;
    static __device__ __forceinline__ word add(word a, word b) {
        return gl::add(a, b);
    }
    static __device__ __forceinline__ word sub(word a, word b) {
        return gl::sub(a, b);
    }
    static __device__ __forceinline__ word mul(word a, word b) {
        return gl::mul(a, b);
    }
};

struct BbOps {
    using word = uint32_t;
    static __device__ __forceinline__ word add(word a, word b) {
        return bb::add(a, b);
    }
    static __device__ __forceinline__ word sub(word a, word b) {
        return bb::sub(a, b);
    }
    static __device__ __forceinline__ word mul(word a, word b) {
        return bb::mont_mul(a, b);
    }
};

struct FrogOps {
    using word = uint64_t;
    static __device__ __forceinline__ word add(word a, word b) {
        return frog::add(a, b);
    }
    static __device__ __forceinline__ word sub(word a, word b) {
        return frog::sub(a, b);
    }
    static __device__ __forceinline__ word mul(word a, word b) {
        return frog::mont_mul(a, b);
    }
};

// Blocks of a round on 2*half entries per table.
__host__ __device__ inline int sc_blocks(int64_t half) {
    const int64_t b = (half + SC_THREADS - 1) / SC_THREADS;
    return b < SC_MAX_BLOCKS ? static_cast<int>(b) : SC_MAX_BLOCKS;
}

// Partial rows of rounds 0 .. rounds-1 of one claim whose first round
// has half0: round i's rows follow those of rounds 0 .. i-1, and claim
// w's follow those of claims 0 .. w-1, so no round leaves unused rows.
__host__ __device__ inline int64_t sc_rows(int64_t half0, int rounds) {
    int64_t n = 0;
    for (int i = 0; i < rounds; ++i) n += sc_blocks(half0 >> i);
    return n;
}

template <class F>
__device__ __forceinline__ typename F::word warp_sum(typename F::word v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = F::add(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Modular sum over the block; the result is valid in thread 0.  Every
// thread of the block must call it.
template <class F>
__device__ typename F::word block_sum(typename F::word v,
                                      typename F::word* sh) {
    using W = typename F::word;
    v = warp_sum<F>(v);
    __syncthreads();                     // sh may still be read
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    v = threadIdx.x < SC_THREADS / 32 ? sh[threadIdx.x] : W(0);
    return threadIdx.x < 32 ? warp_sum<F>(v) : v;
}

template <class W>
struct Tables {
    const W* in[SC_MAX_K];
    W* out[SC_MAX_K];
};

// One round on tables of 2*half entries: the message sums
// p(t) = sum_x prod_j (T_j[x] + t*(T_j[x+half] - T_j[x])), t = 0..K, as
// per-block partials, and the fold T_j[x] + r*(T_j[x+half] - T_j[x])
// into out[j][x] (which may be in[j]: entry x is read and written only
// by its own thread).  Claim w = blockIdx.y reads in[j] + w*in_claim,
// writes out[j] + w*out_claim, and block b its partials in row
// w*claim_rows + row0 + b.
template <class F, int K>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_round_kernel(Tables<typename F::word> tb, int64_t in_claim,
                      int64_t out_claim, int64_t half,
                      const typename F::word* __restrict__ chal, int round,
                      int64_t row0, int64_t claim_rows,
                      typename F::word* __restrict__ partials) {
    using W = typename F::word;
    __shared__ W sh[SC_THREADS / 32];
    const int64_t w = blockIdx.y;
    const W r = chal[round];
    W acc[K + 1];
#pragma unroll
    for (int t = 0; t <= K; ++t) acc[t] = 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * SC_THREADS;
    for (int64_t x = static_cast<int64_t>(blockIdx.x) * SC_THREADS
                     + threadIdx.x; x < half; x += stride) {
        W lo[K], d[K], cur[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const W* in = tb.in[j] + w * in_claim;
            lo[j] = in[x];
            d[j] = F::sub(in[x + half], lo[j]);
            cur[j] = lo[j];
        }
#pragma unroll
        for (int t = 0; t <= K; ++t) {
            if (t) {
#pragma unroll
                for (int j = 0; j < K; ++j) cur[j] = F::add(cur[j], d[j]);
            }
            W p = cur[0];
#pragma unroll
            for (int j = 1; j < K; ++j) p = F::mul(p, cur[j]);
            acc[t] = F::add(acc[t], p);
        }
#pragma unroll
        for (int j = 0; j < K; ++j)
            tb.out[j][w * out_claim + x] = F::add(lo[j], F::mul(r, d[j]));
    }
    W* row = partials + (w * claim_rows + row0 + blockIdx.x) * (K + 1);
#pragma unroll
    for (int t = 0; t <= K; ++t) {
        const W s = block_sum<F>(acc[t], sh);
        if (threadIdx.x == 0) row[t] = s;
    }
}

// n * d in the field by doubling (n >= 0): storage is linear, so the
// field's add on storage words gives the storage of the multiple.
template <class F>
__device__ __forceinline__ typename F::word small_multiple(
        typename F::word d, int n) {
    typename F::word acc = 0;
    for (; n; n >>= 1, d = F::add(d, d))
        if (n & 1) acc = F::add(acc, d);
    return acc;
}

// sumcheck_round_kernel for any number k of tables (the caller's route
// for k > SC_MAX_K), with k read at run time: the table pointers are
// device arrays, and the k+1 message sums go SC_WIDE_T at a time, each
// group a pass over the block's entries that keeps SC_WIDE_T sums and
// SC_WIDE_T products in registers, whatever k is.  The fold runs after
// the last pass, since out[j] may be in[j].
constexpr int SC_WIDE_T = 8;

template <class F>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_round_wide_kernel(const typename F::word* const* __restrict__ in,
                           typename F::word* const* __restrict__ out, int k,
                           int64_t in_claim, int64_t out_claim, int64_t half,
                           const typename F::word* __restrict__ chal,
                           int round, int64_t row0, int64_t claim_rows,
                           typename F::word* __restrict__ partials) {
    using W = typename F::word;
    __shared__ W sh[SC_THREADS / 32];
    const int64_t w = blockIdx.y;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * SC_THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * SC_THREADS
                          + threadIdx.x;
    W* row = partials + (w * claim_rows + row0 + blockIdx.x) * (k + 1);
    for (int t0 = 0; t0 <= k; t0 += SC_WIDE_T) {
        W acc[SC_WIDE_T];
#pragma unroll
        for (int u = 0; u < SC_WIDE_T; ++u) acc[u] = 0;
        for (int64_t x = first; x < half; x += stride) {
            W prod[SC_WIDE_T];
            for (int j = 0; j < k; ++j) {
                const W* tj = in[j] + w * in_claim;
                const W lo = tj[x];
                const W d = F::sub(tj[x + half], lo);
                W cur = F::add(lo, small_multiple<F>(d, t0));
#pragma unroll
                for (int u = 0; u < SC_WIDE_T; ++u) {
                    if (u) cur = F::add(cur, d);
                    prod[u] = j ? F::mul(prod[u], cur) : cur;
                }
            }
#pragma unroll
            for (int u = 0; u < SC_WIDE_T; ++u)
                acc[u] = F::add(acc[u], prod[u]);
        }
#pragma unroll
        for (int u = 0; u < SC_WIDE_T; ++u) {
            const W s = block_sum<F>(acc[u], sh);
            if (threadIdx.x == 0 && t0 + u <= k) row[t0 + u] = s;
        }
    }
    const W r = chal[round];
    for (int64_t x = first; x < half; x += stride)
        for (int j = 0; j < k; ++j) {
            const W* tj = in[j] + w * in_claim;
            const W lo = tj[x];
            out[j][w * out_claim + x] = F::add(lo,
                                               F::mul(r, F::sub(tj[x + half],
                                                                lo)));
        }
}

// msgs[w, round, t] = sum of that claim's and round's per-block partials;
// one block per (round, claim).
template <class F>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_reduce_kernel(const typename F::word* __restrict__ partials,
                       typename F::word* __restrict__ msgs, int k1,
                       int rounds, int64_t half0) {
    using W = typename F::word;
    __shared__ W sh[SC_THREADS / 32];
    const int round = blockIdx.x;
    const int64_t w = blockIdx.y;
    const int64_t cr = w * rounds + round;
    const int nb = sc_blocks(half0 >> round);
    const W* rows = partials
        + (w * sc_rows(half0, rounds) + sc_rows(half0, round)) * k1;
    for (int t = 0; t < k1; ++t) {
        W a = 0;
        for (int b = threadIdx.x; b < nb; b += SC_THREADS)
            a = F::add(a, rows[b * k1 + t]);
        a = block_sum<F>(a, sh);
        if (threadIdx.x == 0) msgs[cr * k1 + t] = a;
    }
}

template <class F, int K>
void launch_round(const Tables<typename F::word>& tb, dim3 grid,
                  int64_t in_claim, int64_t out_claim, int64_t half,
                  const void* chal, int round, int64_t row0,
                  int64_t claim_rows, void* partials, cudaStream_t s) {
    using W = typename F::word;
    sumcheck_round_kernel<F, K><<<grid, SC_THREADS, 0, s>>>(
        tb, in_claim, out_claim, half, static_cast<const W*>(chal), round,
        row0, claim_rows, static_cast<W*>(partials));
}

template <class F>
int sumcheck_round(const void* ins, const void* outs, int k, int claims,
                   int64_t in_claim, int64_t out_claim, int64_t half,
                   const void* chal, int round, int rounds, void* partials,
                   cudaStream_t s) {
    if (k < 1 || k > SC_MAX_K || half < 1 || claims < 1
            || claims > SC_MAX_CLAIMS || round < 0 || round >= rounds
            || round > 62 || half > (INT64_MAX >> round))
        return static_cast<int>(cudaErrorInvalidValue);
    using W = typename F::word;
    Tables<W> tb{};
    for (int j = 0; j < k; ++j) {
        tb.in[j] = static_cast<const W* const*>(ins)[j];
        tb.out[j] = static_cast<W* const*>(outs)[j];
    }
    const int64_t half0 = half << round;
    const int64_t row0 = sc_rows(half0, round);
    const int64_t claim_rows = sc_rows(half0, rounds);
    const dim3 grid(sc_blocks(half), claims);
    switch (k) {
#define SC_ROUND(KK)                                                       \
        case KK:                                                           \
            launch_round<F, KK>(tb, grid, in_claim, out_claim, half, chal, \
                                round, row0, claim_rows, partials, s);     \
            break;
        SC_ROUND(1) SC_ROUND(2) SC_ROUND(3) SC_ROUND(4)
        SC_ROUND(5) SC_ROUND(6) SC_ROUND(7) SC_ROUND(8)
#undef SC_ROUND
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

template <class F>
int sumcheck_round_wide(const void* ins, const void* outs, int k, int claims,
                        int64_t in_claim, int64_t out_claim, int64_t half,
                        const void* chal, int round, int rounds,
                        void* partials, cudaStream_t s) {
    if (k < 1 || half < 1 || claims < 1 || claims > SC_MAX_CLAIMS
            || round < 0 || round >= rounds || round > 62
            || half > (INT64_MAX >> round))
        return static_cast<int>(cudaErrorInvalidValue);
    using W = typename F::word;
    const int64_t half0 = half << round;
    sumcheck_round_wide_kernel<F><<<dim3(sc_blocks(half), claims),
                                    SC_THREADS, 0, s>>>(
        static_cast<const W* const*>(ins), static_cast<W* const*>(outs), k,
        in_claim, out_claim, half, static_cast<const W*>(chal), round,
        sc_rows(half0, round), sc_rows(half0, rounds),
        static_cast<W*>(partials));
    return static_cast<int>(cudaGetLastError());
}

template <class F>
int sumcheck_reduce(const void* partials, void* msgs, int k1, int rounds,
                    int claims, int64_t half0, cudaStream_t s) {
    if (k1 < 2 || rounds < 1 || claims < 1
            || claims > SC_MAX_CLAIMS || half0 < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    using W = typename F::word;
    sumcheck_reduce_kernel<F><<<dim3(rounds, claims), SC_THREADS, 0, s>>>(
        static_cast<const W*>(partials), static_cast<W*>(msgs), k1, rounds,
        half0);
    return static_cast<int>(cudaGetLastError());
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

// K7 partials of `claims` claims whose first round has half0 (2^(nv-1)):
// the rows of k+1 words the caller allocates for srt_sumcheck_round_*.
extern "C" int64_t srt_sumcheck_partial_rows(int64_t half0, int rounds,
                                             int claims) {
    return claims * sc_rows(half0, rounds);
}

// K7 entry points, one pair per field:
//   srt_sumcheck_round_<field>: one round for `claims` claims.  `ins` /
//     `outs` are host arrays of k device pointers, the tables read this
//     round and the half-size tables written, claim w's at w*in_claim /
//     w*out_claim words further; partials holds
//     srt_sumcheck_partial_rows(half << round, rounds, claims) rows of
//     k+1 words of the field.
//   srt_sumcheck_round_wide_<field>: the same round for any k >= 1, with
//     `ins` / `outs` device arrays of k device pointers.
//   srt_sumcheck_reduce_<field>: msgs [claims, rounds, k1] words from the
//     partials of rounds whose halves are half0, half0/2, ...
#define SC_ENTRIES(NAME, OPS)                                                \
    extern "C" int srt_sumcheck_round_##NAME(                                \
            const void* ins, const void* outs, int k, int claims,            \
            int64_t in_claim, int64_t out_claim, int64_t half,               \
            const void* chal, int round, int rounds, void* partials,         \
            void* stream) {                                                  \
        return sumcheck_round<OPS>(ins, outs, k, claims, in_claim,           \
                                   out_claim, half, chal, round, rounds,     \
                                   partials,                                 \
                                   static_cast<cudaStream_t>(stream));       \
    }                                                                        \
    extern "C" int srt_sumcheck_round_wide_##NAME(                           \
            const void* ins, const void* outs, int k, int claims,            \
            int64_t in_claim, int64_t out_claim, int64_t half,               \
            const void* chal, int round, int rounds, void* partials,         \
            void* stream) {                                                  \
        return sumcheck_round_wide<OPS>(ins, outs, k, claims, in_claim,      \
                                        out_claim, half, chal, round,        \
                                        rounds, partials,                    \
                                        static_cast<cudaStream_t>(stream));  \
    }                                                                        \
    extern "C" int srt_sumcheck_reduce_##NAME(                               \
            const void* partials, void* msgs, int k1, int rounds,            \
            int claims, int64_t half0, void* stream) {                       \
        return sumcheck_reduce<OPS>(partials, msgs, k1, rounds, claims,      \
                                    half0,                                   \
                                    static_cast<cudaStream_t>(stream));      \
    }
SC_ENTRIES(goldilocks, GlOps)
SC_ENTRIES(babybear, BbOps)
SC_ENTRIES(frog, FrogOps)
#undef SC_ENTRIES
