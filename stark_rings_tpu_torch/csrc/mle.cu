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
//   K5 binds the low variables first, 2^12 words a block: each thread
//      binds its 16 words in registers (16-byte loads), the warp the
//      next five variables with shuffles, the block the last three after
//      one barrier.  The blocks' values go to partials, and the block that
//      draws the last ticket of a group of them binds the group, in the
//      same launch: one launch an evaluation at every nv.
//   K6 must bind the top variables, in one launch a call.  For k <= 5
//      each thread owns one output and combines its 2^k strided inputs
//      (coalesced across the warp) in a register tree.  For k > 5 each
//      output is a sum of its 2^k inputs times eq weights (a table a
//      block in shared memory), split over blocks in chunks of j's whose
//      partials the block with a tile's last ticket adds, so the table
//      is read once.
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
//      Beyond 8 tables, sumcheck_wide_kernel reads k at run time and
//      runs the same schedule in one launch, one round a grid phase, each
//      entry's k + 1 sums split over threads 8 at a time (before, one
//      launch a round and a reduction: nv + 1 launches, host-bound).
//      There a round's k - 1 products a sum bind the modular arithmetic
//      more than the bytes do.
// K5, K6 and K7 up to 8 tables are not bound by the modular arithmetic:
// one lerp (one 64x64->128 multiply; three for frog's Montgomery product)
// per entry read.  K5 and K6 are bound by memory traffic and, at nv = 20,
// by the launch itself.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "frog.cuh"
#include "goldilocks.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5 and K6 take their points as a table in the launch parameters, so a
// list of 0-d point tensors needs no stack: point j is the device word
// *ptr[j], or val[j] where ptr[j] is null (a point given as an integer).
// A launch that combines the values of several blocks takes two scratch
// buffers of the caller's: tickets (u32 counters) and partials (64-bit
// words).  Every ticket is 0 before a launch, and the block that draws
// a ticket's last number sets it back to 0, so one pair of buffers
// serves every launch on a stream in turn, whatever its shape; two
// streams need two pairs (mle/fix.py keeps one a stream).
// ---------------------------------------------------------------------------

constexpr int MLE_MAX_POINTS = 40;   // a table of 2^40 words is 8 TB

struct Points {
    const uint64_t* ptr[MLE_MAX_POINTS];
    uint64_t val[MLE_MAX_POINTS];
};

__device__ __forceinline__ uint64_t point(const Points& p, int j) {
    const auto* a = reinterpret_cast<const unsigned long long*>(p.ptr[j]);
    return a ? __ldg(a) : p.val[j];
}

// Loads through L2 only (ld.global.cg): a partial that another block
// wrote in this launch is never read from a stale L1 line.
__device__ __forceinline__ uint64_t ld_cg(const uint64_t* p) {
    uint64_t a;
    asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(a) : "l"(p) : "memory");
    return a;
}

__device__ __forceinline__ void ld_cg2(const uint64_t* p, uint64_t& a,
                                       uint64_t& b) {
    asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
                 : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

// One word, or two from a 16-byte boundary: through L2 (CG) where
// another block of the launch wrote them, else plain loads (a kernel's
// input, which it never writes).
template <bool CG>
__device__ __forceinline__ uint64_t load1(const uint64_t* p) {
    if constexpr (CG) return ld_cg(p);
    return *p;
}

template <bool CG>
__device__ __forceinline__ void load2(const uint64_t* p, uint64_t& a,
                                      uint64_t& b) {
    if constexpr (CG) {
        ld_cg2(p, a, b);
    } else {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
        a = v.x;
        b = v.y;
    }
}

// Binds the variable of shuffle distance 1 << s: every lane ends with
// the pair's value (the lane whose bit s is 0 holds the low entry).
__device__ __forceinline__ uint64_t lerp_lanes(uint64_t v, int s, uint64_t r) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, v, 1 << s);
    const bool odd = (threadIdx.x >> s) & 1;
    return gl::lerp(odd ? o : v, odd ? v : o, r);
}

// A launch's scratch: `tickets` counters, all 0, and room for
// `partials` words.
struct Scratch {
    unsigned* tickets;
    int64_t n_tickets;
    uint64_t* partials;
    int64_t n_partials;

    bool holds(int64_t tickets_needed, int64_t partials_needed) const {
        return tickets_needed <= n_tickets && partials_needed <= n_partials
               && (!tickets_needed || tickets)
               && (!partials_needed || partials);
    }
};

// ---------------------------------------------------------------------------
// K5: full evaluation.  Replaces evaluate_goldilocks_pallas
// (stark_rings_tpu/mle/pallas_fix.py, _make_eval_kernel and _lerp).
// ---------------------------------------------------------------------------

constexpr int EVAL_THREADS = 256;
constexpr int EVAL_WARPS = EVAL_THREADS / 32;
constexpr int EVAL_BITS = 12;                       // a block binds 2^12 words
constexpr int EVAL_WORDS = (1 << EVAL_BITS) / EVAL_THREADS;  // 16 a thread

__host__ __device__ constexpr int ilog2(int x) {
    return x > 1 ? 1 + ilog2(x / 2) : 0;
}

// Binds the 2^n words src[0 .. 2^n), n <= EVAL_BITS, to the points
// off .. off+n-1 (bit b of the index to point off + b) with the whole
// block; the value is valid in thread 0, and every thread must call it.
// Thread (warp w, lane l) loads VW words at a time (VW = 2: 16-byte
// loads) from VW*(l + 32*(w + 8*u)), u < EVAL_WORDS/VW, so each load
// instruction of a warp covers 32*VW contiguous words.  The index bits
// split three ways:
//   registers: bit 0 if VW = 2 (bound as it is loaded), and the top
//     bits (those of u);
//   lanes: the next five bits, bound with shuffles, no barrier;
//   warps: the next three, bound by warp 0 after one barrier.
// Every thread computes each step, so none sits idle until the warps'
// step.  Words at or beyond 2^n read as 0 and the variables past n are
// not bound, so thread 0's value never takes them in.  CG: src holds
// partials of this launch (read through L2).
template <int VW, bool CG>
__device__ __forceinline__ uint64_t eval_block(const uint64_t* src, int n,
                                               const Points& pts, int off,
                                               uint64_t* sh) {
    constexpr int LV = ilog2(VW);           // index bits within a load
    constexpr int U = EVAL_WORDS / VW;      // loads a thread
    constexpr int LU = ilog2(U);            // index bits of u
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t size = int64_t{1} << n;
    uint64_t r0 = 0;
    if constexpr (VW == 2) r0 = point(pts, off);
    uint64_t x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t i = VW * (lane + 32 * (warp + EVAL_WARPS * u));
        x[u] = 0;
        if (i < size) {
            if constexpr (VW == 2) {
                uint64_t a, b;
                load2<CG>(src + i, a, b);
                x[u] = gl::lerp(a, b, r0);
            } else {
                x[u] = load1<CG>(src + i);
            }
        }
    }
#pragma unroll
    for (int s = 0; s < LU; ++s) {           // u's bits: pairs (2c, 2c+1)
        const int b = LV + 8 + s;
        const uint64_t r = b < n ? point(pts, off + b) : 0;
#pragma unroll
        for (int c = 0; c < (U >> (s + 1)); ++c)
            x[c] = b < n ? gl::lerp(x[2 * c], x[2 * c + 1], r) : x[2 * c];
    }
    uint64_t v = x[0];
#pragma unroll
    for (int s = 0; s < 5; ++s)
        if (LV + s < n) v = lerp_lanes(v, s, point(pts, off + LV + s));
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < EVAL_WARPS ? sh[lane] : 0;
#pragma unroll
        for (int s = 0; s < 3; ++s)
            if (LV + 5 + s < n)
                v = lerp_lanes(v, s, point(pts, off + LV + 5 + s));
    }
    return v;
}

// The levels of an evaluation: level 0 binds b0 = min(nv, EVAL_BITS)
// variables in each of its 2^(nv - b0) blocks; each later level binds up
// to EVAL_BITS more, in the block that draws the last ticket of its
// group.  The tickets (one a group of every later level) and partials
// (the values of every level but the last) of an nv; mle/fix.py's
// eval_plan mirrors these rules.
__host__ __device__ inline void eval_layout(int nv, int64_t& tickets,
                                            int64_t& partials) {
    tickets = partials = 0;
    int done = nv < EVAL_BITS ? nv : EVAL_BITS;
    while (done < nv) {
        const int b = nv - done < EVAL_BITS ? nv - done : EVAL_BITS;
        partials += int64_t{1} << (nv - done);
        tickets += int64_t{1} << (nv - done - b);
        done += b;
    }
}

// The launch's point table from host arrays of n device pointers (0 for
// a point given as a value) and n values.
inline bool make_points(Points& p, int n, const void* ptrs,
                        const void* vals) {
    if (n < 1 || n > MLE_MAX_POINTS || !ptrs || !vals) return false;
    const auto* pp = static_cast<const uint64_t*>(ptrs);
    const auto* vv = static_cast<const uint64_t*>(vals);
    for (int j = 0; j < MLE_MAX_POINTS; ++j) {
        p.ptr[j] = j < n ? reinterpret_cast<const uint64_t*>(pp[j]) : nullptr;
        p.val[j] = j < n ? vv[j] : 0;
    }
    return true;
}

// The whole evaluation in one launch.  Block x binds tile x of 2^b0
// words; while variables are left, it writes its value to the level's
// partials, fences, and takes a ticket of its group of 2^b values: the
// block that draws the group's last ticket sets the ticket back to 0 and
// binds the group (reading the partials through L2).  The one block
// that binds the last level writes *out.
template <int VW>
__global__ void __launch_bounds__(EVAL_THREADS)
mle_eval_kernel(const uint64_t* __restrict__ in, int nv,
                const __grid_constant__ Points pts, uint64_t* partials,
                unsigned* tickets, uint64_t* __restrict__ out) {
    __shared__ uint64_t sh[EVAL_WARPS];
    __shared__ int last;
    int done = nv < EVAL_BITS ? nv : EVAL_BITS;
    int64_t idx = blockIdx.x;
    uint64_t v = eval_block<VW, false>(in + (idx << done), done, pts, 0,
                                       sh);
    while (done < nv) {
        const int b = nv - done < EVAL_BITS ? nv - done : EVAL_BITS;
        const int64_t g = idx >> b;
        if (threadIdx.x == 0) {
            partials[idx] = v;
            __threadfence();
            const bool mine = atomicAdd(tickets + g, 1u) == (1u << b) - 1;
            if (mine) {
                tickets[g] = 0;
                __threadfence();
            }
            last = mine;
        }
        __syncthreads();
        if (!last) return;                  // the whole block
        v = eval_block<VW, true>(partials + (g << b), b, pts, done, sh);
        partials += int64_t{1} << (nv - done);
        tickets += int64_t{1} << (nv - done - b);
        idx = g;
        done += b;
    }
    if (threadIdx.x == 0) *out = v;
}

// ---------------------------------------------------------------------------
// K6: fix the last variables.  Replaces fix_last_goldilocks_pallas
// (pallas_fix.py, _make_fix_kernel).
// ---------------------------------------------------------------------------

constexpr int FIX_THREADS = 256;
constexpr int FIX_TREE_BITS = 5;     // k <= 5: the register tree
constexpr int FIX_ROW = 64;          // threads of a row: 2 outputs each
constexpr int FIX_ROWS = FIX_THREADS / FIX_ROW;
constexpr int FIX_TILE = 2 * FIX_ROW;              // outputs of a block
constexpr int64_t FIX_TARGET_BLOCKS = 256;
constexpr int64_t FIX_MAX_CHUNKS = 128;
constexpr int64_t FIX_MIN_J = 8;
constexpr int64_t FIX_MAX_J = 256;
constexpr int FIX_PREFETCH = 8;      // j's a thread loads before the weights
static_assert(FIX_PREFETCH <= FIX_MIN_J, "every row takes FIX_PREFETCH j's");

// The multilinear value of p[(base + j)*M], j < 2^S, at r[0..S-1]
// (bit t of j bound to r[t]): the top bit splits j into two halves.
// Written as a compile-time recursion so the 2^S loads are independent
// scalars the compiler keeps in registers (an indexed local array was
// placed in local memory).
template <int S>
__device__ __forceinline__ uint64_t fix_tree(const uint64_t* p, int64_t M,
                                             int base, const uint64_t* r) {
    if constexpr (S == 0) {
        return p[base * M];
    } else {
        const uint64_t lo = fix_tree<S - 1>(p, M, base, r);
        const uint64_t hi = fix_tree<S - 1>(p, M, base + (1 << (S - 1)), r);
        return gl::lerp(lo, hi, r[S - 1]);
    }
}

// k = S <= 5: out[i] for i < M combines in[i + j*M], j < 2^S, where bit
// t of j is the variable bound to point t.  Consecutive threads read
// consecutive addresses for every j.
template <int S>
__global__ void __launch_bounds__(FIX_THREADS)
mle_fix_tree_kernel(const uint64_t* __restrict__ in,
                    uint64_t* __restrict__ out, int64_t M,
                    const __grid_constant__ Points pts) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * FIX_THREADS
                      + threadIdx.x;
    uint64_t r[S];
#pragma unroll
    for (int t = 0; t < S; ++t) r[t] = point(pts, t);
    if (i < M) out[i] = fix_tree<S>(in + i, M, 0, r);
}

// k > 5: the split of the 2^k j's of each output.  A block takes a tile
// of FIX_TILE outputs and one of `chunks` chunks of consecutive j's, J a
// row.  Chunks double (J halves) while J exceeds FIX_MAX_J, and while
// the grid has fewer than FIX_TARGET_BLOCKS blocks, up to
// FIX_MAX_CHUNKS chunks and down to FIX_MIN_J.  fix_plan in mle/fix.py
// mirrors these rules.
__host__ __device__ inline void fix_layout(int nv, int k, int64_t& chunks,
                                           int64_t& J) {
    const int64_t tiles = (int64_t{1} << (nv - k)) / FIX_TILE;
    J = (int64_t{1} << k) / FIX_ROWS;
    chunks = 1;
    while (J > FIX_MAX_J || (tiles * chunks < FIX_TARGET_BLOCKS
                             && chunks < FIX_MAX_CHUNKS
                             && J >= 2 * FIX_MIN_J)) {
        chunks *= 2;
        J /= 2;
    }
}

// Outputs i and i + 1 of input row p: one 16-byte load (VW = 2), or
// two 8-byte loads off a 16-byte boundary.
template <int VW>
__device__ __forceinline__ void load_in(const uint64_t* p, uint64_t& a,
                                        uint64_t& b) {
    if constexpr (VW == 2) {
        load2<false>(p, a, b);
    } else {
        a = load1<false>(p);
        b = load1<false>(p + 1);
    }
}

// Two outputs' 128-bit sums of products, each product reduced first
// (< q < 2^64), so 2^64 terms cannot overflow.
struct Acc2 {
    uint64_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
    __device__ __forceinline__ void add(uint64_t a, uint64_t b) {
        lo0 += a;
        hi0 += lo0 < a;
        lo1 += b;
        hi1 += lo1 < b;
    }
};

// k > 5 in one launch, reading each input word once: out[i] =
// sum_j w_j in[i + j*M] with the eq weights w_j = prod_t (bit t of j ?
// r_t : 1 - r_t), which equals the lerp tree mod q (the multilinear
// extension is unique).  Block (tile, chunk c) builds the weights of its
// 4J j's in shared memory: the chunk's high bits give one factor, every
// thread's own; then row y's thread t sums its J j's for outputs
// tile*128 + 2t and +1 (16-byte loads when VW = 2, each row of a warp
// on 512 contiguous bytes), the rows add up through shared memory, and
// with one chunk the block writes the outputs.  With more, it writes the
// chunk's partials, fences, and takes the tile's ticket: the block that
// draws the last sets it back to 0 and adds the chunks' partials.
template <int VW>
__global__ void __launch_bounds__(FIX_THREADS)
mle_fix_eq_kernel(const uint64_t* __restrict__ in,
                  uint64_t* __restrict__ out, int64_t M, int k, int J,
                  int64_t chunks, const __grid_constant__ Points pts,
                  uint64_t* partials, unsigned* tickets) {
    __shared__ uint64_t w[FIX_ROWS * FIX_MAX_J];
    __shared__ uint64_t rows[FIX_ROWS][FIX_TILE];
    __shared__ int last;
    const int64_t tiles = M / FIX_TILE;
    const int64_t tile = blockIdx.x % tiles;
    const int64_t c = blockIdx.x / tiles;
    const int y = threadIdx.x / FIX_ROW, t = threadIdx.x % FIX_ROW;
    const int64_t i = tile * FIX_TILE + 2 * t;
    int lb = 0;                               // bits of j within a chunk
    while ((1 << lb) < FIX_ROWS * J) ++lb;
    const int64_t j0 = c << lb;
    const uint64_t* p = in + i + (j0 + static_cast<int64_t>(y) * J) * M;
    // the first FIX_PREFETCH j's are in flight while the weights are made
    uint64_t xa[FIX_PREFETCH], xb[FIX_PREFETCH];
#pragma unroll
    for (int u = 0; u < FIX_PREFETCH; ++u) load_in<VW>(p + u * M, xa[u], xb[u]);
    if (static_cast<int>(threadIdx.x) < FIX_ROWS * J) {
        uint64_t hi = 1;
        for (int s = lb; s < k; ++s) {
            const uint64_t r = point(pts, s);
            hi = gl::mul(hi, (j0 >> s) & 1 ? r : gl::sub(1, r));
        }
        for (int e = threadIdx.x; e < FIX_ROWS * J; e += FIX_THREADS) {
            uint64_t x = hi;
            for (int s = 0; s < lb; ++s) {
                const uint64_t r = point(pts, s);
                x = gl::mul(x, (e >> s) & 1 ? r : gl::sub(1, r));
            }
            w[e] = x;
        }
    }
    __syncthreads();
    const uint64_t* wy = w + y * J;
    Acc2 acc;
#pragma unroll
    for (int u = 0; u < FIX_PREFETCH; ++u)
        acc.add(gl::mul(wy[u], xa[u]), gl::mul(wy[u], xb[u]));
#pragma unroll 8
    for (int u = FIX_PREFETCH; u < J; ++u) {
        uint64_t a, b;
        load_in<VW>(p + u * M, a, b);
        const uint64_t wu = wy[u];
        acc.add(gl::mul(wu, a), gl::mul(wu, b));
    }
    rows[y][2 * t] = gl::reduce128(acc.hi0, acc.lo0);
    rows[y][2 * t + 1] = gl::reduce128(acc.hi1, acc.lo1);
    __syncthreads();
    // thread x < FIX_TILE adds output x's rows
    const int64_t o = tile * FIX_TILE + threadIdx.x;
    uint64_t s = 0;
    if (threadIdx.x < FIX_TILE) {
        s = rows[0][threadIdx.x];
#pragma unroll
        for (int r = 1; r < FIX_ROWS; ++r) s = gl::add(s, rows[r][threadIdx.x]);
    }
    if (chunks == 1) {
        if (threadIdx.x < FIX_TILE) out[o] = s;
        return;
    }
    if (threadIdx.x < FIX_TILE) {
        partials[c * M + o] = s;
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const bool mine = atomicAdd(tickets + tile, 1u)
                          == static_cast<unsigned>(chunks - 1);
        if (mine) {
            tickets[tile] = 0;
            __threadfence();
        }
        last = mine;
    }
    __syncthreads();
    if (!last) return;                      // the whole block
    // row y adds chunks y, y + 4, ... for outputs i and i + 1
    Acc2 sum;
    for (int64_t cc = y; cc < chunks; cc += FIX_ROWS) {
        uint64_t a, b;
        ld_cg2(partials + cc * M + i, a, b);
        sum.add(a, b);
    }
    rows[y][2 * t] = gl::reduce128(sum.hi0, sum.lo0);
    rows[y][2 * t + 1] = gl::reduce128(sum.hi1, sum.lo1);
    __syncthreads();
    if (threadIdx.x < FIX_TILE) {
        s = rows[0][threadIdx.x];
#pragma unroll
        for (int r = 1; r < FIX_ROWS; ++r) s = gl::add(s, rows[r][threadIdx.x]);
        out[o] = s;
    }
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
constexpr int SC_MAX_CLAIMS = 65535;     // per launch (a chunk of claims)
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

template <class F>
__device__ __forceinline__ typename F::word warp_sum(typename F::word v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = F::add(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
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

// ---------------------------------------------------------------------------
// K7 beyond SC_MAX_K tables: sumcheck_wide_kernel reads k at run time and
// proves in one cooperative launch per proof (or chunk of claims), with
// the rounds as sumcheck_prove_kernel runs them: grid rounds, each ended
// by a grid barrier (one round a phase: two entries of k > 8 tables
// never fit SC_PHASE_BYTES a thread), then the tail of one block per
// claim in shared memory.  An entry pair's k + 1 message sums go
// SC_WIDE_T at a time: group gi holds sums 8*gi .. 8*gi + 7, and each of
// a block's threads owns one (entry, group) pair, sc_wide_groups(k)
// groups to an entry, so a round's chain of dependent products is k long
// whatever k is.  A grid round first copies its block's entries of every
// table into shared memory, all loads in flight at once (a thread's k
// dependent loads were what a round waited on), and folds them from
// there.  After the last grid round every block of the grid sums
// partial rows into the grid rounds' messages, a warp a (claim, round,
// sum), before the tail.  Table pointers ride in the launch parameters
// (__grid_constant__) up to SC_WIDE_PTRS tables; beyond, all k come from
// a device array.
// ---------------------------------------------------------------------------

constexpr int SC_WIDE_T = 8;              // sums a group
constexpr int SC_WIDE_GROUPS = 32;        // most groups an entry a pass
constexpr int SC_WIDE_PTRS = 64;
constexpr int64_t SC_WIDE_STAGE_BYTES = 32 * 1024;   // a grid round's stage

// Threads an entry: the groups of k + 1 sums, rounded up to a power of 2,
// at most SC_WIDE_GROUPS (more groups take further passes).
__host__ __device__ inline int sc_wide_groups(int k) {
    const int g = (k + SC_WIDE_T) / SC_WIDE_T;
    int p = 1;
    while (p < g && p < SC_WIDE_GROUPS) p <<= 1;
    return p;
}

// Entries a block takes at once, and the tables a grid round stages at
// once (2 words an entry a table in SC_WIDE_STAGE_BYTES).
__host__ __device__ inline int sc_wide_entries(int k) {
    return SC_THREADS / sc_wide_groups(k);
}

__host__ __device__ inline int sc_wide_stage_tables(int k, int word_bytes) {
    const int64_t n = SC_WIDE_STAGE_BYTES
                      / (2 * int64_t{sc_wide_entries(k)} * word_bytes);
    return n < k ? static_cast<int>(n) : k;
}

// Blocks of a wide round on 2*half entries a table, and the partial rows
// of the grid rounds before round i.  plan() in mle/sumcheck_kernel.py
// mirrors them.
__host__ __device__ inline int sc_wide_blocks(int64_t half, int k) {
    const int64_t e = sc_wide_entries(k);
    const int64_t b = (half + e - 1) / e;
    return b < SC_MAX_BLOCKS ? static_cast<int>(b) : SC_MAX_BLOCKS;
}

__host__ __device__ inline int64_t sc_wide_rows(int64_t half0, int k,
                                                int i) {
    int64_t n = 0;
    for (int r = 0; r < i; ++r) n += sc_wide_blocks(half0 >> r, k);
    return n;
}

template <class W>
struct WideGrid {
    const W* in[SC_WIDE_PTRS];   // claim 0's tables (k <= SC_WIDE_PTRS)
    const W* const* more;        // device array of all k, or null
    W* scratch;
    int64_t claims, half0, claim_rows;
    const W* chal;
    W* partials;
    int k;
};

template <class W>
__device__ __forceinline__ const W* wide_table(const WideGrid<W>& g, int j) {
    return g.more ? g.more[j] : g.in[j];
}

// Multiply factor lo + t*(hi - lo), t = t0 .. t0 + SC_WIDE_T - 1 (t <= k),
// into prod[t - t0]; the first factor sets prod.  The factor at t0 + u is
// the one at t0 + (u with its lowest bit cleared) plus that bit's multiple
// of d: three adds deep, not seven.
template <class F>
__device__ __forceinline__ void sc_wide_factor(
        typename F::word (&prod)[SC_WIDE_T], typename F::word lo,
        typename F::word hi, int t0, int k, bool first) {
    using W = typename F::word;
    W step[4];                            // d, 2d, 4d, 8d
    step[0] = F::sub(hi, lo);
#pragma unroll
    for (int b = 1; b < 4; ++b) step[b] = F::add(step[b - 1], step[b - 1]);
    static_assert(SC_WIDE_T == 8, "three doublings of d");
    W cur[SC_WIDE_T];
    cur[0] = t0 ? F::add(lo, small_multiple<F>(step[3], t0 / SC_WIDE_T))
                : lo;
#pragma unroll
    for (int u = 1; u < SC_WIDE_T; ++u)
        cur[u] = F::add(cur[u & (u - 1)],
                        step[(u & 1) ? 0 : (u & 2) ? 1 : 2]);
#pragma unroll
    for (int u = 0; u < SC_WIDE_T; ++u) {
        if (t0 + u > k) break;
        prod[u] = first ? cur[u] : F::mul(prod[u], cur[u]);
    }
}

// The block's sums of acc over its entries, for thread (e, gl)'s group
// g0 + gl: the warp's lanes of a group by shuffles, the warps through
// red (SC_WIDE_T * SC_WARPS * SC_WIDE_GROUPS words); out(t, v) receives
// sum t <= k.  Every thread of the block calls it; its first barrier
// also orders the caller's folds before later reads.
template <class F, class Out>
__device__ __forceinline__ void sc_wide_block_sums(
        typename F::word (&acc)[SC_WIDE_T], int k, int g0, int GP,
        typename F::word* red, Out out) {
    using W = typename F::word;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < SC_WIDE_T; ++u)
        for (int o = GP; o < 32; o <<= 1)
            acc[u] = F::add(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], o));
    __syncthreads();                     // red may still be read
    if (lane < GP) {                     // GP divides 32: lane gl of a warp
#pragma unroll
        for (int u = 0; u < SC_WIDE_T; ++u)
            red[(u * SC_WARPS + warp) * GP + lane] = acc[u];
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < SC_WIDE_T * GP) {
        const int u = threadIdx.x / GP, gl = threadIdx.x % GP;
        W a = red[u * SC_WARPS * GP + gl];
        for (int wi = 1; wi < SC_WARPS; ++wi)
            a = F::add(a, red[(u * SC_WARPS + wi) * GP + gl]);
        const int t = (g0 + gl) * SC_WIDE_T + u;
        if (t <= k) out(t, a);
    }
}

// Grid round on virtual block b of nb: entries y0 + e, y0 = b*E, b*E +
// nb*E, ... < h of src(j) (2h words), staged in `stage` a slice of tables
// at a time; folded into dst(j) (h words, may be src(j)).
template <class F, class Src, class Dst, class Out>
__device__ __forceinline__ void sc_wide_grid_round(
        int k, Src src, Dst dst, int64_t h, int64_t b, int nb,
        typename F::word r, typename F::word* stage, typename F::word* red,
        Out out) {
    using W = typename F::word;
    const int GP = sc_wide_groups(k), E = sc_wide_entries(k);
    const int KJ = sc_wide_stage_tables(k, sizeof(W));
    const int gl = threadIdx.x % GP, e = threadIdx.x / GP;
    for (int g0 = 0; g0 * SC_WIDE_T <= k; g0 += GP) {
        const int t0 = (g0 + gl) * SC_WIDE_T;
        const bool fold = (g0 + GP) * SC_WIDE_T > k;   // the last pass
        W acc[SC_WIDE_T];
#pragma unroll
        for (int u = 0; u < SC_WIDE_T; ++u) acc[u] = 0;
        for (int64_t y0 = b * E; y0 < h; y0 += int64_t{nb} * E) {
            const bool mine = y0 + e < h;
            W prod[SC_WIDE_T];
            for (int j0 = 0; j0 < k; j0 += KJ) {
                const int nj = k - j0 < KJ ? k - j0 : KJ;
                __syncthreads();                       // the stage is free
                for (int x = threadIdx.x; x < nj * 2 * E; x += SC_THREADS) {
                    const int j = x / (2 * E), q = x - j * 2 * E;
                    const int64_t y = y0 + (q < E ? q : q - E);
                    if (y < h) stage[x] = src(j0 + j)[q < E ? y : y + h];
                }
                __syncthreads();
                if (mine && t0 <= k)
                    for (int j = 0; j < nj; ++j)
                        sc_wide_factor<F>(prod, stage[j * 2 * E + e],
                                          stage[j * 2 * E + E + e], t0, k,
                                          j0 + j == 0);
                if (mine && fold)
                    for (int j = gl; j < nj; j += GP) {
                        const W lo = stage[j * 2 * E + e];
                        const W hi = stage[j * 2 * E + E + e];
                        dst(j0 + j)[y0 + e] = F::add(lo,
                                                     F::mul(r, F::sub(hi, lo)));
                    }
            }
            if (mine && t0 <= k) {
#pragma unroll
                for (int u = 0; u < SC_WIDE_T; ++u)
                    if (t0 + u <= k) acc[u] = F::add(acc[u], prod[u]);
            }
        }
        sc_wide_block_sums<F>(acc, k, g0, GP, red, out);
    }
}

// Tail round on the block's tables in shared memory, tab(j) of 2h words,
// folded in place.  When the round has fewer entries than the block has
// (entry, group) threads, S = 2, 4, ... threads share an (entry, group):
// thread s multiplies the factors j = s, s + S, ... and the S partial
// products meet by shuffles, so a round's chain of products is about
// k / S + log2(S) long (S <= k, and the GP * S threads of an entry lie in
// one warp).
template <class F, class Tab, class Out>
__device__ __forceinline__ void sc_wide_tail_round(
        int k, Tab tab, int64_t h, typename F::word r, typename F::word* red,
        Out out) {
    using W = typename F::word;
    const int GP = sc_wide_groups(k);
    int S = 1;
    while (2 * S <= k && GP * 2 * S <= 32
           && int64_t{SC_THREADS / (GP * 2 * S)} >= h)
        S *= 2;
    const int E = SC_THREADS / (GP * S);       // entries at once
    const int gl = threadIdx.x % GP, s = threadIdx.x / GP % S;
    const int e = threadIdx.x / (GP * S);
    for (int g0 = 0; g0 * SC_WIDE_T <= k; g0 += GP) {
        const int t0 = (g0 + gl) * SC_WIDE_T;
        W acc[SC_WIDE_T];
#pragma unroll
        for (int u = 0; u < SC_WIDE_T; ++u) acc[u] = 0;
        for (int64_t y0 = 0; y0 < h; y0 += E) {   // uniform: shuffles inside
            const int64_t y = y0 + e;
            W prod[SC_WIDE_T] = {};
            if (y < h && t0 <= k)
                for (int j = s; j < k; j += S)
                    sc_wide_factor<F>(prod, tab(j)[y], tab(j)[y + h], t0, k,
                                      j == s);
            for (int o = GP; o < GP * S; o <<= 1) {
#pragma unroll
                for (int u = 0; u < SC_WIDE_T; ++u) {
                    const W p = __shfl_xor_sync(0xffffffffu, prod[u], o);
                    prod[u] = F::mul(prod[u], p);
                }
            }
            if (s == 0 && y < h && t0 <= k) {
#pragma unroll
                for (int u = 0; u < SC_WIDE_T; ++u)
                    if (t0 + u <= k) acc[u] = F::add(acc[u], prod[u]);
            }
        }
        if ((g0 + GP) * SC_WIDE_T > k) {       // the last pass folds
            __syncthreads();                   // the round's reads are done
            for (int64_t y = e; y < h; y += E)
                for (int j = s * GP + gl; j < k; j += GP * S) {
                    const W lo = tab(j)[y];
                    tab(j)[y] = F::add(lo, F::mul(r, F::sub(tab(j)[y + h],
                                                            lo)));
                }
        }
        sc_wide_block_sums<F>(acc, k, g0, GP, red, out);
    }
}

// The whole proof of `claims` claims of k > SC_MAX_K tables in one
// cooperative launch, in the layout of sumcheck_prove_kernel: claim w's
// table j is wide_table(g, j) + w*2*half0, scratch [claims, k, half0]
// holds the half-size tables and, afterwards, the finals at [w, j, 0].
// Rounds 0 .. tail-1 are grid rounds (partial row w*claim_rows + the
// blocks of the rounds before + b), rounds tail .. rounds-1 the tail's.
template <class F>
__global__ void __launch_bounds__(SC_THREADS)
sumcheck_wide_kernel(const __grid_constant__ WideGrid<typename F::word> g,
                     int rounds, int tail, typename F::word* __restrict__ msgs) {
    using W = typename F::word;
    __shared__ W red[SC_WIDE_T * SC_WARPS * SC_WIDE_GROUPS];
    extern __shared__ __align__(16) unsigned char tail_bytes[];
    W* st = reinterpret_cast<W*>(tail_bytes);   // the stage, then the tail
    const int k = g.k;
    const int64_t half0 = g.half0;
    const int64_t claim_words = k * half0;   // scratch, claim to claim

    int64_t row0 = 0;
    for (int i = 0; i < tail; ++i) {
        const int64_t h = half0 >> i;
        const int nb = sc_wide_blocks(h, k);
        for (int64_t v = blockIdx.x; v < g.claims * nb; v += gridDim.x) {
            const int64_t w = v / nb;
            const int64_t b = v - w * nb;
            W* sc = g.scratch + w * claim_words;
            W* row = g.partials + (w * g.claim_rows + row0 + b) * (k + 1);
            sc_wide_grid_round<F>(
                k,
                [&](int j) -> const W* {
                    return i ? sc + j * half0
                             : wide_table(g, j) + w * 2 * half0;
                },
                [&](int j) { return sc + j * half0; }, h, b, nb, g.chal[i],
                st, red, [&](int t, W s) { row[t] = s; });
        }
        row0 += nb;
        cooperative_groups::this_grid().sync();
    }

    // the grid rounds' messages: a warp of the grid a (claim, round, sum)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t sums = tail * int64_t{k + 1};
    for (int64_t p = blockIdx.x * int64_t{SC_WARPS} + warp;
         p < g.claims * sums; p += int64_t{gridDim.x} * SC_WARPS) {
        const int64_t w = p / sums;
        const int i = static_cast<int>((p - w * sums) / (k + 1));
        const int t = static_cast<int>(p - w * sums - int64_t{i} * (k + 1));
        const W* rows = g.partials
            + (w * g.claim_rows + sc_wide_rows(half0, k, i)) * (k + 1);
        const int nb = sc_wide_blocks(half0 >> i, k);
        W a = 0;
        for (int b = lane; b < nb; b += 32)
            a = F::add(a, rows[b * (k + 1) + t]);
        a = warp_sum<F>(a);
        if (lane == 0) msgs[(w * rounds + i) * (k + 1) + t] = a;
    }

    const int64_t half_t = half0 >> tail;    // 0 when no round is left
    for (int64_t w = blockIdx.x; w < g.claims && half_t; w += gridDim.x) {
        W* sc = g.scratch + w * claim_words;
        __syncthreads();                 // st is free (the stage, a claim)
        for (int j = 0; j < k; ++j) {
            const W* src = tail ? sc + j * half0
                                : wide_table(g, j) + w * 2 * half0;
            for (int64_t x = threadIdx.x; x < 2 * half_t; x += SC_THREADS)
                st[j * 2 * half_t + x] = src[x];
        }
        __syncthreads();
        const auto tab = [&](int j) { return st + j * 2 * half_t; };
        for (int i = tail; i < rounds; ++i)
            sc_wide_tail_round<F>(
                k, tab, half0 >> i, g.chal[i], red,
                [&](int t, W s) { msgs[(w * rounds + i) * (k + 1) + t] = s; });
        __syncthreads();                 // the last round's fold is done
        for (int j = threadIdx.x; j < k; j += SC_THREADS)
            sc[j * half0] = st[j * 2 * half_t];   // the finals, tab(j)[0]
    }
}

// Launches `kernel` cooperatively with `smem` bytes of dynamic shared
// memory and a grid of the co-resident capacity capped at `work` (the most
// virtual blocks a phase has).  The capacity (SMs << 8 | blocks an SM) is
// asked of the runtime at `ask_smem` >= smem bytes, once, and kept in
// *cached (0 = not asked yet; null: ask every time).  info[0] and info[1]
// receive the grid and the blocks an SM.
inline int launch_coop(const void* kernel, void** args, size_t smem,
                       size_t ask_smem, int64_t work, int* cached, int* info,
                       cudaStream_t s) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
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
                &per_sm, kernel, SC_THREADS, ask_smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (!coop) return static_cast<int>(cudaErrorNotSupported);
        if (per_sm < 1 || per_sm > 0xff)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        if (cached) *cached = sms << 8 | per_sm;
    }
    const int64_t cap = static_cast<int64_t>(sms) * per_sm;
    const int grid = static_cast<int>(work < cap ? work : cap);
    info[0] = grid;
    info[1] = per_sm;
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(SC_THREADS),
                                      args, smem, s);
    const cudaError_t last = cudaGetLastError();   // clear a refusal too
    return static_cast<int>(err != cudaSuccess ? err : last);
}

template <class F, int K>
int launch_prove(const Grid<typename F::word>& g, int rounds, int tail,
                 void* msgs, int* info, cudaStream_t s) {
    using W = typename F::word;
    const int64_t half_t = g.half0 >> tail;
    // the capacity by device and tail size (half_t = 2^e, e <= 10)
    static int capacity[SC_MAX_DEVICES][11];
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int e = 0;
    while ((int64_t{1} << e) < half_t) ++e;
    constexpr int MK = sc_phase_rounds(K, sizeof(W));
    const int64_t work = tail ? g.claims * sc_round_blocks(g.half0, tail,
                                                           MK, 0)
                              : g.claims;
    W* msgs_w = static_cast<W*>(msgs);
    void* args[] = {const_cast<Grid<W>*>(&g), &rounds, &tail, &msgs_w};
    const size_t smem = 2 * half_t * K * sizeof(W);
    return launch_coop(
        reinterpret_cast<const void*>(sumcheck_prove_kernel<F, K>), args,
        smem, smem, work,
        dev < SC_MAX_DEVICES ? &capacity[dev][e] : nullptr, info, s);
}

template <class F>
int launch_wide(const WideGrid<typename F::word>& g, int rounds, int tail,
                void* msgs, int* info, cudaStream_t s) {
    using W = typename F::word;
    // the tail's tables, or a grid round's stage, whichever is larger
    const size_t tail_bytes = 2 * (g.half0 >> tail) * g.k * sizeof(W);
    const size_t stage = tail ? 2 * sizeof(W) * sc_wide_entries(g.k)
                                * sc_wide_stage_tables(g.k, sizeof(W))
                              : 0;
    const size_t smem = tail_bytes > stage ? tail_bytes : stage;
    // the capacity by device and bytes rounded up to whole KB (at most
    // 32): a grid that fits the rounded-up bytes fits
    static int capacity[SC_MAX_DEVICES][SC_WIDE_STAGE_BYTES / 1024 + 1];
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int kb = static_cast<int>((smem + 1023) / 1024);
    const int64_t work = tail ? g.claims * sc_wide_blocks(g.half0, g.k)
                              : g.claims;
    W* msgs_w = static_cast<W*>(msgs);
    void* args[] = {const_cast<WideGrid<W>*>(&g), &rounds, &tail, &msgs_w};
    const void* kernel = reinterpret_cast<const void*>(
        sumcheck_wide_kernel<F>);
    return launch_coop(kernel, args, smem, static_cast<size_t>(kb) * 1024,
                       work,
                       dev < SC_MAX_DEVICES ? &capacity[dev][kb] : nullptr,
                       info, s);
}

template <class F>
int sumcheck_prove(const void* ins, const void* more, void* scratch, int k,
                   int claims, int64_t half0, int rounds, int tail,
                   const void* chal, int64_t claim_rows, void* partials,
                   void* msgs, int* info, cudaStream_t s) {
    using W = typename F::word;
    if (k < 1 || claims < 1 || claims > SC_MAX_CLAIMS
            || rounds < 1 || rounds > 62
            || half0 != (int64_t{1} << (rounds - 1))
            || tail != sc_tail_round(half0, rounds, k, sizeof(W))
            || claim_rows != (k > SC_MAX_K
                              ? sc_wide_rows(half0, k, tail)
                              : sc_phase_rows(half0, tail,
                                              sc_phase_rounds(k, sizeof(W)),
                                              tail))
            || (k > SC_WIDE_PTRS && !more))
        return static_cast<int>(cudaErrorInvalidValue);
    if (k > SC_MAX_K) {
        WideGrid<W> g{};
        if (k > SC_WIDE_PTRS)
            g.more = static_cast<const W* const*>(more);
        else
            for (int j = 0; j < k; ++j)
                g.in[j] = static_cast<const W* const*>(ins)[j];
        g.scratch = static_cast<W*>(scratch);
        g.claims = claims;
        g.half0 = half0;
        g.claim_rows = claim_rows;
        g.chal = static_cast<const W*>(chal);
        g.partials = static_cast<W*>(partials);
        g.k = k;
        return launch_wide<F>(g, rounds, tail, msgs, info, s);
    }
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

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  The Python wrappers check sizes.

// K5: the multilinear value of the 2^nv words `in` at the nv points
// (1 <= nv <= 40), written to *out, in one launch.  pt_ptrs / pt_vals:
// host arrays of nv device pointers (0 for a point given as a value) and
// nv values.  tickets (n_tickets u32, all 0) and partials (n_partials
// words): the scratch that eval_layout asks for, null where it asks for
// none.
extern "C" int srt_mle_eval(const void* in, int nv, const void* pt_ptrs,
                            const void* pt_vals, void* tickets,
                            int64_t n_tickets, void* partials,
                            int64_t n_partials, void* out, void* stream) {
    Points pts;
    const Scratch sc{static_cast<unsigned*>(tickets), n_tickets,
                     static_cast<uint64_t*>(partials), n_partials};
    int64_t need_t, need_p;
    eval_layout(nv, need_t, need_p);
    if (!make_points(pts, nv, pt_ptrs, pt_vals) || !sc.holds(need_t, need_p))
        return static_cast<int>(cudaErrorInvalidValue);
    const int b0 = nv < EVAL_BITS ? nv : EVAL_BITS;
    const auto blocks = static_cast<unsigned>(int64_t{1} << (nv - b0));
    const auto* ip = static_cast<const uint64_t*>(in);
    auto* op = static_cast<uint64_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if ((reinterpret_cast<uintptr_t>(in) & 15) == 0)
        mle_eval_kernel<2><<<blocks, EVAL_THREADS, 0, st>>>(
            ip, nv, pts, sc.partials, sc.tickets, op);
    else
        mle_eval_kernel<1><<<blocks, EVAL_THREADS, 0, st>>>(
            ip, nv, pts, sc.partials, sc.tickets, op);
    return static_cast<int>(cudaGetLastError());
}

// K6: bind the top k variables of the 2^nv words `in` (nv >= 9,
// 1 <= k <= nv - 7) to the k points (bit t of the top k to point t) and
// write the 2^(nv-k) words `out`, in one launch.  Points and scratch as
// srt_mle_eval's, the layout fix_layout's: with more than one chunk,
// one ticket a tile and chunks * 2^(nv-k) partials.
extern "C" int srt_mle_fix(const void* in, int nv, int k, const void* pt_ptrs,
                           const void* pt_vals, void* tickets,
                           int64_t n_tickets, void* partials,
                           int64_t n_partials, void* out, void* stream) {
    Points pts;
    if (nv < 9 || nv > MLE_MAX_POINTS || k < 1 || k > nv - 7
            || !make_points(pts, k, pt_ptrs, pt_vals))
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t M = int64_t{1} << (nv - k);
    const auto* ip = static_cast<const uint64_t*>(in);
    auto* op = static_cast<uint64_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (k <= FIX_TREE_BITS) {
        const auto blocks = static_cast<unsigned>((M + FIX_THREADS - 1)
                                                  / FIX_THREADS);
        switch (k) {
#define FIX_TREE(S)                                                         \
            case S:                                                         \
                mle_fix_tree_kernel<S><<<blocks, FIX_THREADS, 0, st>>>(     \
                    ip, op, M, pts);                                        \
                break;
            FIX_TREE(1) FIX_TREE(2) FIX_TREE(3) FIX_TREE(4) FIX_TREE(5)
#undef FIX_TREE
        }
        return static_cast<int>(cudaGetLastError());
    }
    int64_t chunks, J;
    fix_layout(nv, k, chunks, J);
    const int64_t tiles = M / FIX_TILE;
    const Scratch sc{static_cast<unsigned*>(tickets), n_tickets,
                     static_cast<uint64_t*>(partials), n_partials};
    if (!sc.holds(chunks > 1 ? tiles : 0, chunks > 1 ? chunks * M : 0)
            || tiles * chunks >= (int64_t{1} << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto blocks = static_cast<unsigned>(tiles * chunks);
    const int j = static_cast<int>(J);
    if ((reinterpret_cast<uintptr_t>(in) & 15) == 0)
        mle_fix_eq_kernel<2><<<blocks, FIX_THREADS, 0, st>>>(
            ip, op, M, k, j, chunks, pts, sc.partials, sc.tickets);
    else
        mle_fix_eq_kernel<1><<<blocks, FIX_THREADS, 0, st>>>(
            ip, op, M, k, j, chunks, pts, sc.partials, sc.tickets);
    return static_cast<int>(cudaGetLastError());
}

// K7 entry points, one set per field:
//   srt_sumcheck_prove_<field>: the whole proof of `claims` claims of k
//     tables, one cooperative launch (sumcheck_prove_kernel for k <= 8,
//     sumcheck_wide_kernel beyond).  `ins` is a host array of k device
//     pointers, claim w's table j at ins[j] + w*2*half0 words; for k >
//     SC_WIDE_PTRS, `more` is a device array of the same k pointers
//     (else null).  scratch is [claims, k, half0] words, whose [w, j, 0]
//     are the finals afterwards; msgs [claims, rounds, k+1].  `tail` and
//     `claim_rows` are the plan's (mle/sumcheck_kernel.py): the first
//     round run in the tail, and the partial rows of k+1 words a claim
//     (partials holds claims * claim_rows); a call whose plan differs from
//     the kernel's is refused.  info[0] and info[1] receive the grid and
//     the resident blocks an SM.  A device that cannot launch
//     cooperatively, or refuses the grid, returns the error and launches
//     nothing.
#define SC_ENTRIES(NAME, OPS)                                                \
    extern "C" int srt_sumcheck_prove_##NAME(                                \
            const void* ins, const void* more, void* scratch, int k,         \
            int claims, int64_t half0, int rounds, int tail,                 \
            const void* chal, int64_t claim_rows, void* partials,            \
            void* msgs, int* info, void* stream) {                           \
        return sumcheck_prove<OPS>(ins, more, scratch, k, claims, half0,     \
                                   rounds, tail, chal, claim_rows, partials, \
                                   msgs, info,                               \
                                   static_cast<cudaStream_t>(stream));       \
    }
SC_ENTRIES(goldilocks, GlOps)
SC_ENTRIES(babybear, BbOps)
SC_ENTRIES(frog, FrogOps)
#undef SC_ENTRIES
