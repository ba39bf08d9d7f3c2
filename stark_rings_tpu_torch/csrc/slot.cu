// The extension-slot product of the Goldilocks ring model (D = 24: 8 CRT
// slots of F_q[X]/(X^3 - nr)), for Hopper (sm_90a).  Plain C entry
// points, loaded with ctypes by stark_rings_tpu_torch/ops/_build.py;
// wrappers and plain twins are in stark_rings_tpu_torch/ops/slot.py.
//
// It replaces no Pallas kernel: the reference leaves this product to
// XLA (stark_rings_tpu/ops/model_mul.py:158 ntt_mul_bt, :183 matvec_t,
// gathers, two u64 products and a sum tree over the E x E table), and
// the port ran it as int64 torch ops, about 30 elementwise kernels a
// field product.  In degree coordinates (the Goldilocks model stores
// them in that order)
//     c_k = sum_i a_i b_{(k-i) mod 3} nr^[i > k]
//         = S_k + nr S_{k+3},  S_d = sum_{i+j=d} a_i b_j  (S_5 = 0),
// and the one device routine here (Ext) adds the nine 128-bit products
// a_i b_j into five exact 192-bit degree sums and folds them mod q once.
// Integer sums are exact and associative, so every order of blocks and
// every split of a sum gives the same canonical words as the twin.
//
// slot_mul_kernel: a [N, 3, Ba] times b [N, 3, Bb] -> out [N*3, Ba],
// b read at j mod Bb (Bb = Ba, or 1: the folding challenge).  A thread
// takes V = 2 neighbouring j's of one slot with 16-byte loads and
// stores along the batch (V = 1 where Ba is odd or an operand is not 16-
// byte aligned).  Bound by bytes: TModelMul.mul_t at B = 65,536 reads a
// and b and writes c, 3 x 24 x 65,536 x 8 B = 37.7 MB, 0.0113 ms at
// 3.35 TB/s; its 4.7 M products of 64-bit words are about 0.005 ms of
// the SMs' instruction rate.
//
// slot_matvec_kernel: A [N, 3, n, m] and x [N, 3, W, m] -> out
// [N*3, W, n], out[s, :, w, i] = sum_j A[s, :, i, j] (x) x[s, :, w, j]
// (the Ajtai commit's contraction, with no [N, E, E, m, W, n] tensor).
// A block takes one slot, a tile of 8 i's by 16 w's (a thread a pair)
// and a chunk of j's; it stages 32 j's of the tile's 24 rows of A and
// 48 rows of x in shared memory at a time (coalesced along j; rows
// padded to 33 words, so the 8 i's and 4 w's a warp reads sit in
// distinct banks), and each thread adds the nine products of its pair
// for each j.  The chunks split m so that about four blocks an SM are
// launched; each block folds its sums mod q, and the block that draws
// its (slot, tile)'s last ticket adds the chunks' partials (the K5
// pattern of csrc/mle.cu) and leaves the ticket at 0.  At the folding
// step's shape (n = 8, m = 8,192, W = 16) the operands are 37.8 MB
// (0.011 ms by bytes; they stay in the 50 MB L2 across the tiles that
// share them), and the 8.39 M extension products, 75.5 M products of
// 64-bit words, are the bound: 0.065 ms at one Goldilocks modmul's cost
// each, about half that as unreduced products.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MUL_THREADS = 256;
constexpr int MV_TILE_N = 8;                     // i's of a block
constexpr int MV_TILE_W = 16;                    // w's of a block
constexpr int MV_THREADS = MV_TILE_N * MV_TILE_W;
constexpr int MV_STEP = 32;                      // j's staged at a time
constexpr int MV_PAD = MV_STEP + 1;

// An exact sum of 128-bit products in three words.
struct Acc192 {
    uint64_t lo = 0, hi = 0, top = 0;

    __device__ __forceinline__ void add(uint64_t a, uint64_t b) {
        const uint64_t plo = a * b, phi = __umul64hi(a, b);
        lo += plo;
        const uint64_t c0 = lo < plo;
        const uint64_t h = hi + phi;
        const uint64_t c1 = h < phi;      // then h < 2^64 - 1: no 2nd carry
        hi = h + c0;
        top += c1 + (hi < c0);
    }

    // The sum mod q, canonical, for top < 2^32 - 1 (fewer than 2^32 - 1
    // products): 2^128 = -2^32 (mod q), and top * 2^32 < q.
    __device__ __forceinline__ uint64_t reduce() const {
        return gl::sub(gl::reduce128(hi, lo), top << 32);
    }
};

// The degree sums S_0..S_4 of sum_j a_j(X) b_j(X).
struct Ext {
    Acc192 s[5];

    __device__ __forceinline__ void add(const uint64_t (&a)[3],
                                        const uint64_t (&b)[3]) {
        s[0].add(a[0], b[0]);
        s[1].add(a[0], b[1]);
        s[1].add(a[1], b[0]);
        s[2].add(a[0], b[2]);
        s[2].add(a[1], b[1]);
        s[2].add(a[2], b[0]);
        s[3].add(a[1], b[2]);
        s[3].add(a[2], b[1]);
        s[4].add(a[2], b[2]);
    }

    // c_k = S_k + nr S_{k+3} mod q (X^3 = nr).
    __device__ __forceinline__ void fold(uint64_t nr, uint64_t (&c)[3]) const {
        c[0] = gl::add(s[0].reduce(), gl::mul(nr, s[3].reduce()));
        c[1] = gl::add(s[1].reduce(), gl::mul(nr, s[4].reduce()));
        c[2] = s[2].reduce();
    }
};

template <int V>
__device__ __forceinline__ void load_v(const uint64_t* p, uint64_t (&v)[V]) {
    if constexpr (V == 2) {
        const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(p);
        v[0] = t.x;
        v[1] = t.y;
    } else {
        v[0] = *p;
    }
}

template <int V>
__device__ __forceinline__ void store_v(uint64_t* p, const uint64_t (&v)[V]) {
    if constexpr (V == 2) {
        *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v[0], v[1]);
    } else {
        *p = v[0];
    }
}

// Loads through L2 only (ld.global.cg): a partial that another block
// wrote in this launch is never read from a stale L1 line.
__device__ __forceinline__ uint64_t ld_cg(const uint64_t* p) {
    uint64_t a;
    asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(a) : "l"(p) : "memory");
    return a;
}

// Slot blockIdx.y, batch entries j .. j + V - 1 of a thread.
template <int V, bool BCAST>
__global__ void __launch_bounds__(MUL_THREADS)
slot_mul_kernel(const uint64_t* __restrict__ a,
                const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                int64_t Ba, uint64_t nr) {
    const int64_t j =
        (static_cast<int64_t>(blockIdx.x) * MUL_THREADS + threadIdx.x) * V;
    if (j >= Ba) return;
    const int64_t base = static_cast<int64_t>(blockIdx.y) * 3 * Ba + j;
    uint64_t x[3][V], y[3][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        load_v<V>(a + base + k * Ba, x[k]);
        if constexpr (BCAST) {
            const uint64_t bk = b[blockIdx.y * 3 + k];
#pragma unroll
            for (int v = 0; v < V; ++v) y[k][v] = bk;
        } else {
            load_v<V>(b + base + k * Ba, y[k]);
        }
    }
    uint64_t z[3][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const uint64_t av[3] = {x[0][v], x[1][v], x[2][v]};
        const uint64_t bv[3] = {y[0][v], y[1][v], y[2][v]};
        Ext e;
        e.add(av, bv);
        uint64_t c[3];
        e.fold(nr, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) z[k][v] = c[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) store_v<V>(out + base + k * Ba, z[k]);
}

// Block (chunk blockIdx.x, tile blockIdx.y, slot blockIdx.z); tile t
// covers i in [8 (t mod tiles_n), +8), w in [16 (t / tiles_n), +16).
// Partials: [N, tiles, chunks, 3, MV_THREADS] words; tickets: one a
// (slot, tile), all 0.
__global__ void __launch_bounds__(MV_THREADS)
slot_matvec_kernel(const uint64_t* __restrict__ A,
                   const uint64_t* __restrict__ x,
                   uint64_t* __restrict__ out, int n, int W, int64_t m,
                   int64_t chunk, int tiles_n, uint64_t nr,
                   uint64_t* partials, unsigned* tickets) {
    __shared__ uint64_t As[3][MV_TILE_N][MV_PAD];
    __shared__ uint64_t xs[3][MV_TILE_W][MV_PAD];
    __shared__ int last;
    const int64_t chunks = gridDim.x, c = blockIdx.x;
    const int tile = blockIdx.y, s = blockIdx.z;
    const int i0 = (tile % tiles_n) * MV_TILE_N;
    const int w0 = (tile / tiles_n) * MV_TILE_W;
    const int ti = threadIdx.x % MV_TILE_N, tw = threadIdx.x / MV_TILE_N;
    const int64_t j0 = c * chunk;
    const int64_t j1 = m < j0 + chunk ? m : j0 + chunk;
    const uint64_t* Ag = A + static_cast<int64_t>(s) * 3 * n * m;
    const uint64_t* xg = x + static_cast<int64_t>(s) * 3 * W * m;
    constexpr int A_ROWS = 3 * MV_TILE_N, ROWS = 3 * (MV_TILE_N + MV_TILE_W);
    Ext e;
    for (int64_t jb = j0; jb < j1; jb += MV_STEP) {
        for (int t = threadIdx.x; t < ROWS * MV_STEP; t += MV_THREADS) {
            const int row = t / MV_STEP, col = t % MV_STEP;
            const int64_t j = jb + col;
            uint64_t v = 0;
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
#pragma unroll 4
        for (int q = 0; q < MV_STEP; ++q) {    // past j1 the words are 0
            const uint64_t av[3] = {As[0][ti][q], As[1][ti][q], As[2][ti][q]};
            const uint64_t bv[3] = {xs[0][tw][q], xs[1][tw][q], xs[2][tw][q]};
            e.add(av, bv);
        }
        __syncthreads();
    }
    uint64_t cv[3];
    e.fold(nr, cv);
    const int i = i0 + ti, w = w0 + tw;
    const bool owner = i < n && w < W;
    const int64_t plane = static_cast<int64_t>(W) * n;
    uint64_t* o = out + static_cast<int64_t>(s) * 3 * plane
                  + static_cast<int64_t>(w) * n + i;
    if (chunks == 1) {
        if (owner) {
#pragma unroll
            for (int k = 0; k < 3; ++k) o[k * plane] = cv[k];
        }
        return;
    }
    const int64_t g = static_cast<int64_t>(s) * gridDim.y + tile;
    uint64_t* pg = partials + g * chunks * 3 * MV_THREADS + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 3; ++k) pg[(c * 3 + k) * MV_THREADS] = cv[k];
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
    for (int k = 0; k < 3; ++k) {
        uint64_t lo = 0, hi = 0;
        for (int64_t cc = 0; cc < chunks; ++cc) {
            const uint64_t v = ld_cg(pg + (cc * 3 + k) * MV_THREADS);
            lo += v;
            hi += lo < v;
        }
        if (owner) o[k * plane] = gl::reduce128(hi, lo);
    }
}

}  // namespace

extern "C" int srt_slot_mul(const void* a, const void* b, void* out,
                            int64_t N, int64_t Ba, int bcast, int vec,
                            uint64_t nr, void* stream) {
    const auto* ap = static_cast<const uint64_t*>(a);
    const auto* bp = static_cast<const uint64_t*>(b);
    auto* op = static_cast<uint64_t*>(out);
    const int V = vec == 2 ? 2 : 1;
    const dim3 grid(static_cast<unsigned>(
                        (Ba / V + MUL_THREADS - 1) / MUL_THREADS),
                    static_cast<unsigned>(N));
    auto s = static_cast<cudaStream_t>(stream);
    if (V == 2 && bcast)
        slot_mul_kernel<2, true><<<grid, MUL_THREADS, 0, s>>>(ap, bp, op, Ba,
                                                              nr);
    else if (V == 2)
        slot_mul_kernel<2, false><<<grid, MUL_THREADS, 0, s>>>(ap, bp, op,
                                                               Ba, nr);
    else if (bcast)
        slot_mul_kernel<1, true><<<grid, MUL_THREADS, 0, s>>>(ap, bp, op, Ba,
                                                              nr);
    else
        slot_mul_kernel<1, false><<<grid, MUL_THREADS, 0, s>>>(ap, bp, op,
                                                               Ba, nr);
    return static_cast<int>(cudaGetLastError());
}

// grid (chunks, tiles, N); partials and tickets as slot_matvec_kernel
// takes them (unused, and may be null, when chunks == 1).
extern "C" int srt_slot_matvec(const void* A, const void* x, void* out,
                               int64_t N, int n, int W, int64_t m,
                               int64_t chunk, int64_t chunks, int tiles_n,
                               int tiles, uint64_t nr, void* partials,
                               void* tickets, void* stream) {
    const dim3 grid(static_cast<unsigned>(chunks),
                    static_cast<unsigned>(tiles), static_cast<unsigned>(N));
    slot_matvec_kernel<<<grid, MV_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(A), static_cast<const uint64_t*>(x),
        static_cast<uint64_t*>(out), n, W, m, chunk, tiles_n, nr,
        static_cast<uint64_t*>(partials), static_cast<unsigned*>(tickets));
    return static_cast<int>(cudaGetLastError());
}
