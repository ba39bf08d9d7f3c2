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
//   K7 proves in one cooperative launch per proof (or per chunk of
//      claims), as the reference proves in one pallas_call.  Before this
//      design it was one launch a round plus one reduction: at nv = 20
//      the host's 21 launches took 0.25 ms against 0.05-0.08 ms of
//      device work.  Now the rounds run in a loop inside the kernel, in
//      grid phases: a thread holds 2^m entries of each table in
//      registers (m = 3 for two Goldilocks tables) and folds them m
//      times, so m rounds share one grid-wide barrier, each resident
//      block walking the phase's (claim, block) pairs.  The half-size
//      tables live in device memory (L2-resident at nv = 20, k = 2: at
//      most 8.4 MB of the 50 MB L2).  Once a claim's tables fit the tail's
//      shared memory, one block per claim finishes its rounds there
//      with __syncthreads instead of grid barriers, and then reduces the
//      earlier rounds' per-block partials to their messages.  What
//      bounds it: round 0's read of the tables from device memory, then
//      the grid barriers and the tail's chain of dependent rounds.
// None is bound by the modular arithmetic: one lerp (one 64x64->128
// multiply; three for frog's Montgomery product) per entry read.  K5 and
// K6 are bound by memory traffic and launch latency.

#include <cstdint>

#include <cooperative_groups.h>
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
// which loops over the claims with one kernel each: here the claims are
// virtual blocks of the same launch.
// ---------------------------------------------------------------------------

constexpr int SC_THREADS = 256;
constexpr int SC_MAX_BLOCKS = 1024;
constexpr int SC_MAX_K = 8;
constexpr int SC_MAX_CLAIMS = 65535;     // per launch (the wide kernels'
                                         // gridDim.y)
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_MAX_DEVICES = 64;       // devices whose capacity is kept
// The tail: rounds whose tables of 2*half words each fit SC_TAIL_BYTES of
// shared memory, half <= SC_TAIL_HALF, run in one block per claim.  32 KB
// keeps the kernel's occupancy at what its registers allow (at most 7
// blocks an SM share 228 KB); 1024 keeps a tail round to 4 entries a
// thread.  Goldilocks and frog at k = 2 start the tail at half = 1024,
// k = 8 at 256; BabyBear at 1024 up to k = 4.
constexpr int64_t SC_TAIL_BYTES = 32 * 1024;
constexpr int64_t SC_TAIL_HALF = 1024;
// A grid phase: up to SC_MAX_PHASE rounds between two grid barriers, as
// many as let a thread hold its 2^m entries of each table in registers
// (2^m * k words of at most SC_PHASE_BYTES): m = 3 for two Goldilocks
// tables, 4 for two BabyBear tables, 1 from five Goldilocks tables.
constexpr int SC_PHASE_BYTES = 128;
constexpr int SC_MAX_PHASE = 4;

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

// The largest half a tail round takes, for k tables of word_bytes words,
// and the first round run in the tail for a first round of half0; the
// rounds a grid phase takes; the blocks of grid round i (its phase's
// last round's: one entry base a thread) and the partial rows of the
// grid rounds before round i.  plan() in mle/sumcheck_kernel.py mirrors
// these rules.
__host__ __device__ inline int64_t sc_tail_half(int k, int word_bytes) {
    int64_t h = SC_TAIL_HALF;
    while (2 * h * k * word_bytes > SC_TAIL_BYTES) h >>= 1;
    return h;
}

__host__ __device__ inline int sc_tail_round(int64_t half0, int rounds,
                                             int k, int word_bytes) {
    const int64_t h = sc_tail_half(k, word_bytes);
    int i = 0;
    while (i < rounds && (half0 >> i) > h) ++i;
    return i;
}

__host__ __device__ constexpr int sc_phase_rounds(int k, int word_bytes) {
    int m = 1;
    while (m < SC_MAX_PHASE && (2 << m) * k * word_bytes <= SC_PHASE_BYTES)
        ++m;
    return m;
}

__host__ __device__ inline int sc_round_blocks(int64_t half0, int tail,
                                               int m, int i) {
    const int end = (i / m + 1) * m;
    return sc_blocks(half0 >> ((end < tail ? end : tail) - 1));
}

__host__ __device__ inline int64_t sc_phase_rows(int64_t half0, int tail,
                                                 int m, int i) {
    int64_t n = 0;
    for (int r = 0; r < i; ++r) n += sc_round_blocks(half0, tail, m, r);
    return n;
}

template <class W>
struct Tables {
    const W* in[SC_MAX_K];
};

// The k + 1 message sums and the fold of one entry pair (lo_j, hi_j) of
// every table: acc[q0 + t] += prod_j (lo_j + t*d_j), d_j = hi_j - lo_j,
// and lo_j becomes lo_j + r*d_j.
template <class F, int K, int NV>
__device__ __forceinline__ void sc_pair(typename F::word (&lo)[K],
                                        const typename F::word (&hi)[K],
                                        typename F::word r,
                                        typename F::word (&acc)[NV], int q0) {
    using W = typename F::word;
    W d[K], cur[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        d[j] = F::sub(hi[j], lo[j]);
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
        acc[q0 + t] = F::add(acc[q0 + t], p);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) lo[j] = F::add(lo[j], F::mul(r, d[j]));
}

// Block sums of acc[0..NV): thread q < NV gets sum q (other threads get
// 0).  Each warp's sums go to sh[q * SC_WARPS + warp]; one __syncthreads.
// The caller alternates between two sh buffers, so a later call cannot
// overwrite sh while it is still read.
template <class F, int NV>
__device__ __forceinline__ typename F::word sc_block_sums(
        typename F::word (&acc)[NV], typename F::word* sh) {
    using W = typename F::word;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
        const W v = warp_sum<F>(acc[q]);
        if ((threadIdx.x & 31) == 0) sh[q * SC_WARPS + (threadIdx.x >> 5)] = v;
    }
    __syncthreads();
    W a = 0;
    if (threadIdx.x < NV) {
        a = sh[threadIdx.x * SC_WARPS];
#pragma unroll
        for (int i = 1; i < SC_WARPS; ++i)
            a = F::add(a, sh[threadIdx.x * SC_WARPS + i]);
    }
    return a;
}

// What a grid phase needs besides its rounds: the claims' tables (or,
// after the first phase, the half-size tables in scratch), the
// challenges and the partials.
template <class W>
struct Grid {
    Tables<W> tb;
    W* scratch;
    int64_t claims, half0, claim_rows;
    const W* chal;
    W* partials;
};

// M rounds i0 .. i0+M-1 of every claim.  The table of round i0 has
// 2^M * h entries, h the half of round i0+M-1; the thread with base
// y < h holds entries y + c*h (c < 2^M) of each table in registers,
// folds them M times (round i0+r pairs c with c + 2^(M-1-r)) and writes
// the one entry left to scratch[w, j, y].  Entry y is read and written by
// its own thread only, so the fold is in place.  Virtual block (w, b)
// takes bases b*SC_THREADS + tid + n*sc_blocks(h)*SC_THREADS and writes
// round i0+r's sums to partial row w*claim_rows + row0 + r*nb + b.
// sh: the two buffers of sc_block_sums, SH words each.
template <class F, int K, int M, int SH>
__device__ __forceinline__ void sc_phase(const Grid<typename F::word>& g,
                                         int i0, int64_t row0,
                                         typename F::word (*sh)[SH], int& n) {
    using W = typename F::word;
    constexpr int E = 1 << M;
    constexpr int NV = M * (K + 1);
    const int64_t h = g.half0 >> (i0 + M - 1);
    const int nb = sc_blocks(h);
    const int64_t claim_words = K * g.half0;
    W r[M];
#pragma unroll
    for (int q = 0; q < M; ++q) r[q] = g.chal[i0 + q];
    for (int64_t v = blockIdx.x; v < g.claims * nb; v += gridDim.x) {
        const int64_t w = v / nb;
        const int64_t b = v - w * nb;
        W acc[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) acc[q] = 0;
        for (int64_t y = b * SC_THREADS + threadIdx.x; y < h;
             y += static_cast<int64_t>(nb) * SC_THREADS) {
            W e[K][E];
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const W* in = i0 ? g.scratch + w * claim_words + j * g.half0
                                 : g.tb.in[j] + w * 2 * g.half0;
#pragma unroll
                for (int c = 0; c < E; ++c) e[j][c] = in[y + c * h];
            }
#pragma unroll
            for (int q = 0; q < M; ++q) {
                const int P = E >> (q + 1);      // pairs (c, c + P)
#pragma unroll
                for (int c = 0; c < E / 2; ++c) {
                    if (c >= P) continue;
                    W lo[K], hi[K];
#pragma unroll
                    for (int j = 0; j < K; ++j) {
                        lo[j] = e[j][c];
                        hi[j] = e[j][c + P];
                    }
                    sc_pair<F, K, NV>(lo, hi, r[q], acc, q * (K + 1));
#pragma unroll
                    for (int j = 0; j < K; ++j) e[j][c] = lo[j];
                }
            }
#pragma unroll
            for (int j = 0; j < K; ++j)
                g.scratch[w * claim_words + j * g.half0 + y] = e[j][0];
        }
        const W sum = sc_block_sums<F, NV>(acc, sh[n++ & 1]);
        if (threadIdx.x < NV) {
            const int q = threadIdx.x / (K + 1);
            const int t = threadIdx.x - q * (K + 1);
            g.partials[(w * g.claim_rows + row0 + q * nb + b) * (K + 1) + t]
                = sum;
        }
    }
}

// A phase of m <= M rounds: sc_phase instantiated for m.
template <class F, int K, int M, int SH>
__device__ __forceinline__ void sc_run_phase(int m,
                                             const Grid<typename F::word>& g,
                                             int i0, int64_t row0,
                                             typename F::word (*sh)[SH],
                                             int& n) {
    if constexpr (M > 1) {
        if (m < M) {
            sc_run_phase<F, K, M - 1, SH>(m, g, i0, row0, sh, n);
            return;
        }
    }
    sc_phase<F, K, M, SH>(g, i0, row0, sh, n);
}

// The whole proof of `claims` claims in one cooperative launch.  Claim w's
// table j is tb.in[j] + w*2*half0; scratch holds its half-size tables,
// [claims, K, half0].  Rounds 0 .. tail-1 run in grid phases of up to
// MK = sc_phase_rounds(K, sizeof(word)) rounds (sc_phase), each ended by
// a grid barrier.  Rounds tail .. rounds-1 run in one block per claim on
// the tables in shared memory (2*half_tail words each), whose messages go
// straight to msgs; the block then reduces the claim's grid rounds'
// partials to their messages (one warp per (round, t)) and writes the
// finals to scratch[w, j, 0].
template <class F, int K>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_prove_kernel(Grid<typename F::word> g, int rounds, int tail,
                      typename F::word* __restrict__ msgs) {
    using W = typename F::word;
    constexpr int MK = sc_phase_rounds(K, sizeof(W));
    constexpr int SH = MK * (K + 1) * SC_WARPS;
    __shared__ W sh[2][SH];
    extern __shared__ __align__(16) unsigned char tail_bytes[];
    W* st = reinterpret_cast<W*>(tail_bytes);
    const int64_t half0 = g.half0;
    const int64_t claim_words = K * half0;   // scratch, claim to claim
    int n = 0;                               // block sums so far (sh parity)

    int64_t row0 = 0;
    for (int i = 0; i < tail;) {
        const int m = tail - i < MK ? tail - i : MK;
        sc_run_phase<F, K, MK, SH>(m, g, i, row0, sh, n);
        row0 += static_cast<int64_t>(m) * sc_blocks(half0 >> (i + m - 1));
        i += m;
        cooperative_groups::this_grid().sync();
    }

    const int64_t half_t = half0 >> tail;
    for (int64_t w = blockIdx.x; w < g.claims; w += gridDim.x) {
        W* tab[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const W* src = tail ? g.scratch + w * claim_words + j * half0
                                : g.tb.in[j] + w * 2 * half0;
            tab[j] = st + j * 2 * half_t;
            for (int64_t x = threadIdx.x; x < 2 * half_t; x += SC_THREADS)
                tab[j][x] = src[x];
        }
        __syncthreads();
        for (int i = tail; i < rounds; ++i) {
            const int64_t half = half0 >> i;
            W acc[K + 1];
#pragma unroll
            for (int t = 0; t <= K; ++t) acc[t] = 0;
            for (int64_t x = threadIdx.x; x < half; x += SC_THREADS) {
                W lo[K], hi[K];
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    lo[j] = tab[j][x];
                    hi[j] = tab[j][x + half];
                }
                sc_pair<F, K, K + 1>(lo, hi, g.chal[i], acc, 0);
#pragma unroll
                for (int j = 0; j < K; ++j) tab[j][x] = lo[j];   // in place
            }
            // the barrier inside also orders this round's folds before
            // the next round's reads
            const W sum = sc_block_sums<F, K + 1>(acc, sh[n++ & 1]);
            if (threadIdx.x <= K) msgs[(w * rounds + i) * (K + 1)
                                       + threadIdx.x] = sum;
        }
        if (threadIdx.x < K)             // the finals, tab[j][0]
            g.scratch[w * claim_words + threadIdx.x * half0] =
                st[threadIdx.x * 2 * half_t];
        const int lane = threadIdx.x & 31;
        for (int p = threadIdx.x >> 5; p < tail * (K + 1); p += SC_WARPS) {
            const int i = p / (K + 1);
            const int t = p - i * (K + 1);
            const W* rows = g.partials
                + (w * g.claim_rows + sc_phase_rows(half0, tail, MK, i))
                  * (K + 1);
            const int nb = sc_round_blocks(half0, tail, MK, i);
            W a = 0;
            for (int b = lane; b < nb; b += 32)
                a = F::add(a, rows[b * (K + 1) + t]);
            a = warp_sum<F>(a);
            if (lane == 0) msgs[(w * rounds + i) * (K + 1) + t] = a;
        }
        __syncthreads();                 // st is refilled for the next claim
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

// One round for any number k of tables (the caller's route for
// k > SC_MAX_K, one launch a round), with k read at run time: the table
// pointers are device arrays, and the k+1 message sums go SC_WIDE_T at a
// time, each group a pass over the block's entries that keeps SC_WIDE_T
// sums and SC_WIDE_T products in registers, whatever k is.  The fold
// runs after the last pass, since out[j] may be in[j].
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
int launch_prove(const Grid<typename F::word>& g, int rounds, int tail,
                 void* msgs, int* info, cudaStream_t s) {
    using W = typename F::word;
    const auto kernel = sumcheck_prove_kernel<F, K>;
    const int64_t half_t = g.half0 >> tail;
    const size_t smem = 2 * half_t * K * sizeof(W);
    // the resident capacity (SMs << 8 | blocks an SM), by device and
    // tail size (half_t = 2^e, e <= 10), asked of the runtime once;
    // 0 = not asked yet
    static int capacity[SC_MAX_DEVICES][11];
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int e = 0;
    while ((int64_t{1} << e) < half_t) ++e;
    int* cached = dev < SC_MAX_DEVICES ? &capacity[dev][e] : nullptr;
    if (cached && *cached) {
        sms = *cached >> 8;
        per_sm = *cached & 0xff;
    } else {
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, SC_THREADS, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (!coop) return static_cast<int>(cudaErrorNotSupported);
        if (per_sm < 1 || per_sm > 0xff)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        if (cached) *cached = sms << 8 | per_sm;
    }
    // the co-resident capacity, capped by the most virtual blocks a phase
    // has (the first grid phase's, or one per claim in the tail)
    constexpr int MK = sc_phase_rounds(K, sizeof(W));
    const int64_t work = tail ? g.claims * sc_round_blocks(g.half0, tail,
                                                           MK, 0)
                              : g.claims;
    const int64_t cap = static_cast<int64_t>(sms) * per_sm;
    const int grid = static_cast<int>(work < cap ? work : cap);
    info[0] = grid;
    info[1] = per_sm;
    W* msgs_w = static_cast<W*>(msgs);
    void* args[] = {const_cast<Grid<W>*>(&g), &rounds, &tail, &msgs_w};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(grid), dim3(SC_THREADS), args,
                                      smem, s);
    const cudaError_t last = cudaGetLastError();   // clear a refusal too
    return static_cast<int>(err != cudaSuccess ? err : last);
}

template <class F>
int sumcheck_prove(const void* ins, void* scratch, int k, int claims,
                   int64_t half0, int rounds, int tail, const void* chal,
                   int64_t claim_rows, void* partials, void* msgs, int* info,
                   cudaStream_t s) {
    using W = typename F::word;
    if (k < 1 || k > SC_MAX_K || claims < 1 || claims > SC_MAX_CLAIMS
            || rounds < 1 || rounds > 62
            || half0 != (int64_t{1} << (rounds - 1))
            || tail != sc_tail_round(half0, rounds, k, sizeof(W))
            || claim_rows != sc_phase_rows(half0, tail,
                                           sc_phase_rounds(k, sizeof(W)),
                                           tail))
        return static_cast<int>(cudaErrorInvalidValue);
    Grid<W> g{};
    for (int j = 0; j < k; ++j)
        g.tb.in[j] = static_cast<const W* const*>(ins)[j];
    g.scratch = static_cast<W*>(scratch);
    g.claims = claims;
    g.half0 = half0;
    g.claim_rows = claim_rows;
    g.chal = static_cast<const W*>(chal);
    g.partials = static_cast<W*>(partials);
    switch (k) {
#define SC_PROVE(KK)                                                        \
        case KK:                                                            \
            return launch_prove<F, KK>(g, rounds, tail, msgs, info, s);
        SC_PROVE(1) SC_PROVE(2) SC_PROVE(3) SC_PROVE(4)
        SC_PROVE(5) SC_PROVE(6) SC_PROVE(7) SC_PROVE(8)
#undef SC_PROVE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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

// K7 entry points, one set per field:
//   srt_sumcheck_prove_<field>: the whole proof of `claims` claims for
//     k <= 8 tables, one cooperative launch.  `ins` is a host array of k
//     device pointers, claim w's table j at ins[j] + w*2*half0 words;
//     scratch is [claims, k, half0] words, whose [w, j, 0] are the finals
//     afterwards; msgs [claims, rounds, k+1].  `tail` and `claim_rows`
//     are the plan's (mle/sumcheck_kernel.py): the first round run in
//     the tail, and the partial rows of k+1 words a claim (partials holds
//     claims * claim_rows); a call whose plan differs from the kernel's
//     is refused.  info[0] and info[1] receive the grid and the resident
//     blocks an SM.  A device that cannot launch cooperatively, or
//     refuses the grid, returns the error and launches nothing.
//   srt_sumcheck_round_wide_<field>: one round for any k >= 1.  `ins` /
//     `outs` are device arrays of k device pointers, the tables read this
//     round and the half-size tables written, claim w's at w*in_claim /
//     w*out_claim words further; partials holds claims *
//     sc_rows(half << round, rounds) rows of k+1 words.
//   srt_sumcheck_reduce_<field>: msgs [claims, rounds, k1] words from the
//     partials of rounds whose halves are half0, half0/2, ...
#define SC_ENTRIES(NAME, OPS)                                                \
    extern "C" int srt_sumcheck_prove_##NAME(                                \
            const void* ins, void* scratch, int k, int claims,               \
            int64_t half0, int rounds, int tail, const void* chal,           \
            int64_t claim_rows, void* partials, void* msgs, int* info,       \
            void* stream) {                                                  \
        return sumcheck_prove<OPS>(ins, scratch, k, claims, half0, rounds,   \
                                   tail, chal, claim_rows, partials, msgs,   \
                                   info, static_cast<cudaStream_t>(stream)); \
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
