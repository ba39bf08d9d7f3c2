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
// None is bound by the modular arithmetic: one lerp (one 64x64->128
// multiply; three for frog's Montgomery product) per entry read.  K5 and
// K6 are bound by memory traffic and, at nv = 20, by the launch itself.

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
