// The extension-slot product of the BabyBear ring model (D = 72: 8 CRT
// slots of F_q[Y]/(Y^9 - nr), q = 15 * 2^27 + 1), for Hopper (sm_90a).
// Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; wrappers and plain twins are in
// stark_rings_tpu_torch/ops/slot_bb.py.  The counterparts of csrc/slot.cu's
// Goldilocks pair.
//
// It replaces no Pallas kernel: the reference leaves this product to XLA
// (stark_rings_tpu/ops/model_mul.py:158 ntt_mul_bt, :183 matvec_t), and the
// port ran it as int64 torch ops emulating 31-bit Montgomery products,
// about 30 elementwise kernels a field product over [N, 9, 9, *batch]
// tensors.  Words are u32 Montgomery form (x R, R = 2^32), stored in the
// slot in the order [0, 3, 6, 1, 4, 7, 2, 5, 8] (upstream's Fq9 as Fq3 of
// Fq3): degree d sits at row perm(d) = 3 (d mod 3) + d / 3, a
// permutation that is its own inverse.  In degree coordinates
//     c_k = S_k + nr S_{k+9},  S_d = sum_{i+j=d} a_i b_j  (S_17 = 0),
// and the device routine here (Ext9) adds the 81 products of u32 words,
// each below q^2 < 2^62, into 17 exact degree sums, four products at a
// time into a u64 (4 (q - 1)^2 < 2^64) and each such u64 into a 96-bit
// sum.  The fold takes u = S_{k+9} 2^-32 mod q, adds nr R u (< q^2) to
// S_k, and reduces: (S_k + nr S_{k+9}) 2^-32 mod q, the Montgomery word of
// the product (a R)(b R) 2^-32.  Integer sums are exact and associative,
// so every order of blocks and every split of a sum gives the twin's
// canonical words.  Input words must be canonical (< q), as the port
// stores them.
//
// bb_slot_mul_kernel: a [N, 9, Ba] times b [N, 9, Bb] -> out [N*9, Ba],
// b read at j mod Bb (Bb = Ba, or 1: the folding challenge).  A thread
// takes V = 4 neighbouring j's of one slot with 16-byte loads and stores
// along the batch (V = 1 where Ba % 4 != 0 or an operand is not 16-byte
// aligned).  Bound by bytes: the fold step's challenge product s1
// [72, 16 x 16,384] by r [72, 1] reads and writes 151 MB, 0.045 ms at
// 3.35 TB/s; its 2.1 M extension products (170 M products of 32-bit
// words and the folds) are about half of that at the SMs' issue rate.
//
// bb_slot_matvec_kernel: A [N, 9, n, m] and x [N, 9, W, m] -> out
// [N*9, W, n], out[s, :, w, i] = sum_j A[s, :, i, j] (x) x[s, :, w, j]
// (the Ajtai commit's contraction, with no [N, 9, 9, m, W, n] tensor).
// The plan of slot_matvec_kernel: a block takes one slot, a tile of 8 i's
// by 16 w's (a thread a pair) and a chunk of j's; it stages 32 j's of the
// tile's 72 rows of A and 144 rows of x in shared memory at a time
// (coalesced along j; rows padded to 33 words, so the 8 i's and 4 w's a
// warp reads sit in distinct banks), and each thread adds the 81 products
// of its pair for each j.  Each block folds its sums mod q; the block that
// draws its (slot, tile)'s last ticket adds the chunks' canonical partials
// exactly in a u64 and reduces once, and leaves the ticket at 0.  A sum
// stays exact over a chunk of up to 2^28 j's: 2^28 x 9 q^2 + q^2 < 2^94.
// At the commit's shape (N = 8, n = 8, W = 16, m = 65,536) the operands
// are 0.45 GB (0.14 ms by bytes), and the 67.1 M extension products,
// 5.44 G products of 32-bit words, are the bound.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int E = 9;
constexpr int DEG = 2 * E - 1;                   // degree sums S_0..S_16
constexpr uint32_t R2 = 1172168163u;             // 2^64 mod q
constexpr int MUL_THREADS = 256;
constexpr int MV_TILE_N = 8;                     // i's of a block
constexpr int MV_TILE_W = 16;                    // w's of a block
constexpr int MV_THREADS = MV_TILE_N * MV_TILE_W;
constexpr int MV_STEP = 32;                      // j's staged at a time
constexpr int MV_PAD = MV_STEP + 1;

// The stored row of degree d (the 3 x 3 transpose; its own inverse).
__host__ __device__ constexpr int perm(int d) { return (d % 3) * 3 + d / 3; }

// An exact sum of u64 words in 96 bits.
struct Acc96 {
    uint64_t lo = 0;
    uint32_t top = 0;

    __device__ __forceinline__ void add(uint64_t v) {
        asm("add.cc.u64 %0, %0, %2;\n\taddc.u32 %1, %1, 0;"
            : "+l"(lo), "+r"(top)
            : "l"(v));
    }

    // The sum times 2^-32 mod q, canonical: with the sum
    // top 2^64 + h 2^32 + l, that is top 2^32 + h + l 2^-32.
    __device__ __forceinline__ uint32_t reduce() const {
        const uint32_t l = bb::redc64(lo & 0xFFFFFFFFull);
        uint32_t h = static_cast<uint32_t>(lo >> 32);   // < 2^32 < 3q
        h = h >= 2 * bb::Q ? h - 2 * bb::Q : h;
        h = h >= bb::Q ? h - bb::Q : h;
        return bb::add(bb::add(l, h), bb::mont_mul(top, R2));
    }
};

// The degree sums S_0..S_16 of sum_j a_j(Y) b_j(Y), in degree order.
struct Ext9 {
    Acc96 s[DEG];

    __device__ __forceinline__ void add(const uint32_t (&a)[E],
                                        const uint32_t (&b)[E]) {
#pragma unroll
        for (int d = 0; d < DEG; ++d) {
            uint64_t t = 0;
            int terms = 0;
#pragma unroll
            for (int i = 0; i < E; ++i) {     // fixed trip counts: every
                if (d - i < 0 || d - i >= E) continue;   // index constant
                t += static_cast<uint64_t>(a[i]) * b[d - i];
                if (++terms == 4) {
                    s[d].add(t);
                    t = 0;
                    terms = 0;
                }
            }
            if (terms) s[d].add(t);
        }
    }

    // c_k = (S_k + nr S_{k+9}) 2^-32 mod q (Y^9 = nr), from nr R mod q.
    __device__ __forceinline__ void fold(uint32_t nr_mont, uint32_t (&c)[E]) {
#pragma unroll
        for (int k = 0; k < E - 1; ++k) {
            s[k].add(static_cast<uint64_t>(nr_mont) * s[k + E].reduce());
            c[k] = s[k].reduce();
        }
        c[E - 1] = s[E - 1].reduce();
    }
};

template <int V>
__device__ __forceinline__ void load_v(const uint32_t* p, uint32_t (&v)[V]) {
    if constexpr (V == 4) {
        const uint4 t = *reinterpret_cast<const uint4*>(p);
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    } else {
        v[0] = *p;
    }
}

template <int V>
__device__ __forceinline__ void store_v(uint32_t* p, const uint32_t (&v)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
        *p = v[0];
    }
}

// Loads through L2 only (ld.global.cg): a partial that another block
// wrote in this launch is never read from a stale L1 line.
__device__ __forceinline__ uint32_t ld_cg(const uint32_t* p) {
    uint32_t a;
    asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(a) : "l"(p) : "memory");
    return a;
}

// Slot blockIdx.y, batch entries j .. j + V - 1 of a thread.
template <int V, bool BCAST>
__global__ void __launch_bounds__(MUL_THREADS)
bb_slot_mul_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   int64_t Ba, uint32_t nr_mont) {
    const int64_t j =
        (static_cast<int64_t>(blockIdx.x) * MUL_THREADS + threadIdx.x) * V;
    if (j >= Ba) return;
    const int64_t base = static_cast<int64_t>(blockIdx.y) * E * Ba + j;
    uint32_t x[E][V], y[E][BCAST ? 1 : V];
#pragma unroll
    for (int k = 0; k < E; ++k) {
        load_v<V>(a + base + k * Ba, x[k]);
        if constexpr (BCAST) {
            y[k][0] = b[blockIdx.y * E + k];
        } else {
            load_v<V>(b + base + k * Ba, y[k]);
        }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        uint32_t av[E], bv[E];
#pragma unroll
        for (int d = 0; d < E; ++d) {
            av[d] = x[perm(d)][v];
            bv[d] = y[perm(d)][BCAST ? 0 : v];
        }
        Ext9 e;
        e.add(av, bv);
        uint32_t c[E];
        e.fold(nr_mont, c);
#pragma unroll
        for (int d = 0; d < E; ++d) x[perm(d)][v] = c[d];
    }
#pragma unroll
    for (int k = 0; k < E; ++k) store_v<V>(out + base + k * Ba, x[k]);
}

// Block (chunk blockIdx.x, tile blockIdx.y, slot blockIdx.z); tile t
// covers i in [8 (t mod tiles_n), +8), w in [16 (t / tiles_n), +16).
// Partials: [N, tiles, chunks, 9, MV_THREADS] u32 words; tickets: one a
// (slot, tile), all 0.
__global__ void __launch_bounds__(MV_THREADS)
bb_slot_matvec_kernel(const uint32_t* __restrict__ A,
                      const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out, int n, int W, int64_t m,
                      int64_t chunk, int tiles_n, uint32_t nr_mont,
                      uint32_t* partials, unsigned* tickets) {
    __shared__ uint32_t As[E][MV_TILE_N][MV_PAD];
    __shared__ uint32_t xs[E][MV_TILE_W][MV_PAD];
    __shared__ int last;
    const int64_t chunks = gridDim.x, c = blockIdx.x;
    const int tile = blockIdx.y, s = blockIdx.z;
    const int i0 = (tile % tiles_n) * MV_TILE_N;
    const int w0 = (tile / tiles_n) * MV_TILE_W;
    const int ti = threadIdx.x % MV_TILE_N, tw = threadIdx.x / MV_TILE_N;
    const int64_t j0 = c * chunk;
    const int64_t j1 = m < j0 + chunk ? m : j0 + chunk;
    const uint32_t* Ag = A + static_cast<int64_t>(s) * E * n * m;
    const uint32_t* xg = x + static_cast<int64_t>(s) * E * W * m;
    constexpr int A_ROWS = E * MV_TILE_N, ROWS = E * (MV_TILE_N + MV_TILE_W);
    Ext9 e;
    for (int64_t jb = j0; jb < j1; jb += MV_STEP) {
        for (int t = threadIdx.x; t < ROWS * MV_STEP; t += MV_THREADS) {
            const int row = t / MV_STEP, col = t % MV_STEP;
            const int64_t j = jb + col;
            uint32_t v = 0;
            if (row < A_ROWS) {
                const int k = row / MV_TILE_N, r = row % MV_TILE_N;
                if (i0 + r < n && j < j1)
                    v = Ag[(static_cast<int64_t>(k) * n + i0 + r) * m + j];
                As[k][r][col] = v;
            } else {
                const int k = (row - A_ROWS) / MV_TILE_W;
                const int r = (row - A_ROWS) % MV_TILE_W;
                if (w0 + r < W && j < j1)
                    v = xg[(static_cast<int64_t>(k) * W + w0 + r) * m + j];
                xs[k][r][col] = v;
            }
        }
        __syncthreads();
#pragma unroll 2
        for (int q = 0; q < MV_STEP; ++q) {    // past j1 the words are 0
            uint32_t av[E], bv[E];
#pragma unroll
            for (int d = 0; d < E; ++d) {
                av[d] = As[perm(d)][ti][q];
                bv[d] = xs[perm(d)][tw][q];
            }
            e.add(av, bv);
        }
        __syncthreads();
    }
    uint32_t cv[E];
    e.fold(nr_mont, cv);
    const int i = i0 + ti, w = w0 + tw;
    const bool owner = i < n && w < W;
    const int64_t plane = static_cast<int64_t>(W) * n;
    uint32_t* o = out + static_cast<int64_t>(s) * E * plane
                  + static_cast<int64_t>(w) * n + i;
    if (chunks == 1) {
        if (owner) {
#pragma unroll
            for (int d = 0; d < E; ++d) o[perm(d) * plane] = cv[d];
        }
        return;
    }
    const int64_t g = static_cast<int64_t>(s) * gridDim.y + tile;
    uint32_t* pg = partials + g * chunks * E * MV_THREADS + threadIdx.x;
#pragma unroll
    for (int d = 0; d < E; ++d) pg[(c * E + perm(d)) * MV_THREADS] = cv[d];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const bool mine = atomicAdd(tickets + g, 1u)
                          == static_cast<unsigned>(chunks - 1);
        if (mine) {
            tickets[g] = 0;
            __threadfence();
        }
        last = mine;
    }
    __syncthreads();
    if (!last) return;                      // the whole block
#pragma unroll
    for (int k = 0; k < E; ++k) {
        uint64_t sum = 0;                   // < chunks q < q 2^32
        for (int64_t cc = 0; cc < chunks; ++cc)
            sum += ld_cg(pg + (cc * E + k) * MV_THREADS);
        // sum 2^-32, then times 2^64 2^-32: sum mod q, canonical
        if (owner) o[k * plane] = bb::mont_mul(bb::redc64(sum), R2);
    }
}

}  // namespace

extern "C" int srt_bb_slot_mul(const void* a, const void* b, void* out,
                               int64_t N, int64_t Ba, int bcast, int vec,
                               uint32_t nr_mont, void* stream) {
    const auto* ap = static_cast<const uint32_t*>(a);
    const auto* bp = static_cast<const uint32_t*>(b);
    auto* op = static_cast<uint32_t*>(out);
    const int V = vec == 4 ? 4 : 1;
    const dim3 grid(static_cast<unsigned>(
                        (Ba / V + MUL_THREADS - 1) / MUL_THREADS),
                    static_cast<unsigned>(N));
    auto s = static_cast<cudaStream_t>(stream);
    if (V == 4 && bcast)
        bb_slot_mul_kernel<4, true><<<grid, MUL_THREADS, 0, s>>>(
            ap, bp, op, Ba, nr_mont);
    else if (V == 4)
        bb_slot_mul_kernel<4, false><<<grid, MUL_THREADS, 0, s>>>(
            ap, bp, op, Ba, nr_mont);
    else if (bcast)
        bb_slot_mul_kernel<1, true><<<grid, MUL_THREADS, 0, s>>>(
            ap, bp, op, Ba, nr_mont);
    else
        bb_slot_mul_kernel<1, false><<<grid, MUL_THREADS, 0, s>>>(
            ap, bp, op, Ba, nr_mont);
    return static_cast<int>(cudaGetLastError());
}

// grid (chunks, tiles, N); partials and tickets as bb_slot_matvec_kernel
// takes them (unused, and may be null, when chunks == 1).
extern "C" int srt_bb_slot_matvec(const void* A, const void* x, void* out,
                                  int64_t N, int n, int W, int64_t m,
                                  int64_t chunk, int64_t chunks, int tiles_n,
                                  int tiles, uint32_t nr_mont, void* partials,
                                  void* tickets, void* stream) {
    const dim3 grid(static_cast<unsigned>(chunks),
                    static_cast<unsigned>(tiles), static_cast<unsigned>(N));
    bb_slot_matvec_kernel<<<grid, MV_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(x),
        static_cast<uint32_t*>(out), n, W, m, chunk, tiles_n, nr_mont,
        static_cast<uint32_t*>(partials), static_cast<unsigned*>(tickets));
    return static_cast<int>(cudaGetLastError());
}
