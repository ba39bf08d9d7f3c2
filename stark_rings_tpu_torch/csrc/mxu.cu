// Exact Goldilocks matrix product y = W x (mod q) for a constant [R, C]
// matrix W and u64 data x [C, M], for Hopper (sm_90a): the kernel of
// stark_rings_tpu_torch/ops/mxu_fused.py.  Plain C entry point, loaded with
// ctypes by ops/_build.py.
//
// Replaces MxuModMatPallas.apply (stark_rings_tpu/ops/pallas_mxu.py:186,
// pallas_call at :201), which per tile of columns
//   * cut x into ten 7-bit digits (_digits_from_planes),
//   * took the int8 x int8 -> int32 products of every weight digit W_k with
//     every data digit x_l on the MXU, summed by exponent into the 19
//     buckets V_s = sum_{k + l = s} W_k x_l,
//   * carry-packed sum_s V_s 2^(7s) into words (_word_accumulate) and
//   * folded the words mod q (_word_finalize).
//
// Here the digit products run on the int8 tensor cores, with no library
// GEMM, as the 100 products W_k x_l accumulated into 19 bucket tiles (the
// minimal MAC count; the reference's stacked [19R, 10C] x [10C, M] form
// multiplies the zero blocks of its weights too, 1.9x the MACs):
//   * a block takes 64 rows x 32 columns of y and walks C in chunks of
//     32.  Each chunk's weight digits come from a table built once by the
//     wrapper (int8 [10, Rp, Cp], plane k row r at bytes k*Rp*Cp + r*Cp,
//     zero-padded to 64 rows and 32 columns) into shared memory by
//     cp.async; its x words are loaded into registers a chunk ahead, cut
//     into ten digit planes in shared memory (4 consecutive c of one
//     column in one 32-bit word, the B operand's layout), never in device
//     memory.  Two buffers of each, one barrier a chunk.
//   * each of the 8 warps owns 32 rows x 8 columns of y: two m16n8
//     accumulator tiles for each of the 19 buckets (152 registers), so a
//     thread ends with all 19 buckets of its 4 outputs of each tile.  A
//     chunk is 200 mma.sync.m16n8k32 s8 a warp: for each weight digit k,
//     its two A fragments against the ten B fragments of the data digits,
//     into buckets k + l.
//   * the epilogue folds each output's 19 int32 buckets (each below 2^31:
//     C * 127^2 * 10 < 2^31, asserted by the wrapper) into 32-bit limbs
//     summed in 64 bits, then three 64-bit words, then mod q
//     (fold_buckets), in registers.
// The ragged edges are masked: columns past M read 0 and are not stored,
// rows past R are not stored, and C is zero-padded in the table (x rows
// past C read 0).
//
// Bound: at the main path's shape (R = C = 128, M = 10,240, one level of a
// deg-2^14 MatmulNTT multiply at B = 80) the 1.68e10 digit MACs take
// 0.017 ms at the int8 tensor-core rate and the 21 MB of x and y 0.006 ms
// at the memory rate.  Neither bounds this design: with each mma.sync
// replaced by an integer add, or the fold by a plain sum, the kernel takes
// the same time (cost probes of examples/tile_variants.py).  One block an
// SM (226 registers, 152 of them accumulators) walks four chunks behind a
// barrier each, loading a chunk ahead: the loads' latency and the
// barriers, not the arithmetic, set its time.  The fold sums its limbs
// without carries until the end, which took the kernel from 255
// registers and a spill to 226 and no spill.

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MT = 2;          // m16 tiles of a warp: 32 rows
constexpr int MIN_BLOCKS = 1;  // blocks an SM the registers must allow
constexpr int DIGITS = 10;     // 7-bit digits of a u64
constexpr int BUCKETS = 2 * DIGITS - 1;
constexpr int BM = 32;         // columns of a block
constexpr int WARPS_M = BM / 8;
constexpr int BR = 16 * MT * (THREADS / 32 / WARPS_M);   // rows of a block
constexpr int TABLE_ROWS = 64; // the weight table's row padding
constexpr int KC = 32;         // c of a chunk (one mma's depth)
constexpr int KQ = KC / 4;     // 32-bit words of a chunk's row
static_assert(TABLE_ROWS % BR == 0, "blocks tile the padded rows");
// Shared-memory rows, padded so that a warp's fragment loads hit 32
// banks: a weight row of KQ words in W_STRIDE, a digit row of BM words in
// D_STRIDE.
constexpr int W_STRIDE = KQ + 4;
constexpr int D_STRIDE = BM + 8;
constexpr int W_WORDS = DIGITS * BR * W_STRIDE;     // one weight buffer
constexpr int D_WORDS = DIGITS * KQ * D_STRIDE;     // one digit buffer
constexpr size_t SMEM_BYTES = 2 * (W_WORDS + D_WORDS) * sizeof(uint32_t);
constexpr int W_COPIES = DIGITS * BR * KC / 16;     // 16-byte copies a chunk
constexpr int MAX_DEVICES = 64;    // devices whose attribute is kept
static_assert(THREADS >= KQ * BM, "a digit word column a thread");

// sum_s v[s] 2^(7s) mod q, canonical, for any 19 buckets below 2^31.  A
// bucket's value shifted by 7s lies in two 32-bit limbs; each limb sums its
// pieces in 64 bits (at most 19 of them, each below 2^32), with no carry
// between limbs until one pass at the end.  The value is below 2^158:
// three words w0, w1, w2 < 2^30, folded with 2^64 = 2^32 - 1 and
// 2^128 = -2^32 (mod q).
__device__ __forceinline__ uint64_t fold_buckets(const int32_t (&v)[BUCKETS]) {
    uint64_t limb[5] = {0, 0, 0, 0, 0};       // limb j: bits 32j ..
#pragma unroll
    for (int s = 0; s < BUCKETS; ++s) {
        const uint32_t val = static_cast<uint32_t>(v[s]);
        const int r = 7 * s, j = r >> 5, sh = r & 31;
        limb[j] += static_cast<uint32_t>(val << sh);
        if (sh) limb[j + 1] += val >> (32 - sh);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        limb[j + 1] += limb[j] >> 32;
        limb[j] &= 0xFFFFFFFFull;
    }
    const uint64_t w0 = limb[0] | limb[1] << 32;
    const uint64_t w1 = limb[2] | limb[3] << 32;
    // w2 = limb[4] < 2^30, so w2 * 2^32 < q
    return gl::sub(gl::reduce128(w1, w0), limb[4] << 32);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Digit l of v (bits 7l .. 7l+6) in the low 7 bits of a 32-bit word.
__device__ __forceinline__ uint32_t digit_word(uint64_t v, int l) {
    const uint32_t lo = static_cast<uint32_t>(v);
    const uint32_t hi = static_cast<uint32_t>(v >> 32);
    const int r = 7 * l;
    if (r + 7 <= 32) return lo >> r;
    if (r < 32) return __funnelshift_r(lo, hi, r);
    return hi >> (r - 32);
}

// D[m] += A[16 x 32] B[32 x 8], int8 in, int32 sums (one tensor-core MMA).
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A chunk's digit products for the warp's 32 x 8 tile: bucket k + l of m16
// tile t gets plane k's A fragment times data digit l's B fragment.
// ws: the chunk's weight planes, at the warp's first row; ds: its digit
// planes, at the warp's first column.
__device__ __forceinline__ void chunk_products(
        int32_t (&acc)[MT][BUCKETS][4], const uint32_t* ws,
        const uint32_t* ds, int g, int t) {
    uint32_t b[DIGITS][2];
#pragma unroll
    for (int l = 0; l < DIGITS; ++l) {
        b[l][0] = ds[(l * KQ + t) * D_STRIDE + g];
        b[l][1] = ds[(l * KQ + t + 4) * D_STRIDE + g];
    }
#pragma unroll
    for (int k = 0; k < DIGITS; ++k) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const uint32_t* row = ws + (k * BR + 16 * mt + g) * W_STRIDE + t;
            const uint32_t a[4] = {row[0], row[8 * W_STRIDE], row[4],
                                   row[8 * W_STRIDE + 4]};
#pragma unroll
            for (int l = 0; l < DIGITS; ++l)
                mma_s8(acc[mt][k + l], a, b[l][0], b[l][1]);
        }
    }
}

// wt: weight planes int8 [DIGITS, Rp, Cp] (Rp, Cp multiples of
// TABLE_ROWS, KC);
// x: [C, M] u64; out: [R, M] u64.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mxu_mod_mat_kernel(const uint64_t* __restrict__ x,
                   const uint8_t* __restrict__ wt,
                   uint64_t* __restrict__ out, int R, int C, int64_t M,
                   int Rp, int Cp) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = warp / WARPS_M, wm = warp % WARPS_M;
    const int r0 = blockIdx.y * BR;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
    const int chunks = Cp / KC;

    // the chunk's x words of this thread: rows 4*xq .. 4*xq+3, column xm
    const int xq = tid / BM, xm = tid % BM;
    const bool digits = tid < KQ * BM;
    const bool col_in = digits && m0 + xm < M;
    uint64_t xv[4];
    auto load_x = [&](int ch) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int c = ch * KC + 4 * xq + i;
            xv[i] = col_in && c < C ? x[static_cast<int64_t>(c) * M + m0 + xm]
                                    : 0;
        }
    };
    auto copy_w = [&](int ch, uint32_t* ws) {
        for (int i = tid; i < W_COPIES; i += THREADS) {
            const int half = i & 1, row = (i >> 1) % BR, k = i / (2 * BR);
            const uint8_t* src = wt + (static_cast<int64_t>(k) * Rp + r0
                                       + row) * Cp + ch * KC + 16 * half;
            uint32_t* dst = ws + (k * BR + row) * W_STRIDE + 4 * half;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         :: "r"(smem_addr(dst)), "l"(src));
        }
        asm volatile("cp.async.commit_group;");
    };

    int32_t acc[MT][BUCKETS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int s = 0; s < BUCKETS; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][s][i] = 0;

    copy_w(0, smem);
    load_x(0);
    for (int ch = 0; ch < chunks; ++ch) {
        const int buf = ch & 1;
        uint32_t* ws = smem + buf * W_WORDS;
        uint32_t* ds = smem + 2 * W_WORDS + buf * D_WORDS;
        // digit plane l, word (xq, xm): digit l of the four x words
        if (digits) {
#pragma unroll
            for (int l = 0; l < DIGITS; ++l) {
                const uint32_t p = __byte_perm(digit_word(xv[0], l),
                                               digit_word(xv[1], l), 0x0040);
                const uint32_t q = __byte_perm(digit_word(xv[2], l),
                                               digit_word(xv[3], l), 0x0040);
                ds[(l * KQ + xq) * D_STRIDE + xm] =
                    __byte_perm(p, q, 0x5410) & 0x7F7F7F7Fu;
            }
        }
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        // the chunk's planes are in; every warp is done with the other
        // buffers (read in the chunk before)
        __syncthreads();
        if (ch + 1 < chunks) {
            copy_w(ch + 1, smem + (buf ^ 1) * W_WORDS);
            load_x(ch + 1);
        }
        chunk_products(acc, ws + wr * 16 * MT * W_STRIDE, ds + wm * 8, g, t);
    }

    // thread (g, t) holds rows g and g + 8 of each m16 tile, columns 2t
    // and 2t + 1 of the warp's 8
    const int64_t m = m0 + wm * 8 + 2 * t;
    const bool pair = (M & 1) == 0 && m + 1 < M;   // one 16-byte store
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + wr * 16 * MT + 16 * mt + g + 8 * h;
            uint64_t y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                int32_t v[BUCKETS];
#pragma unroll
                for (int s = 0; s < BUCKETS; ++s) v[s] = acc[mt][s][2 * h + e];
                y[e] = fold_buckets(v);
            }
            if (r >= R || m >= M) continue;
            uint64_t* o = out + static_cast<int64_t>(r) * M + m;
            if (pair) {
                *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(y[0], y[1]);
            } else {
                o[0] = y[0];
                if (m + 1 < M) o[1] = y[1];
            }
        }
}

}  // namespace

// Sizes are checked by the Python wrapper: C * 127^2 * 10 < 2^31,
// ceil(M / 32) < 2^31, ceil(R / 64) <= 65535; wt is the [10, Rp, Cp] table
// of mxu_fused.tc_weights (Rp = R and Cp = C rounded up to 64 and 32).
extern "C" int srt_mxu_mod_mat(const void* x, const void* wt, void* out,
                               int R, int C, int64_t M, void* stream) {
    // the shared memory above 48 KB, allowed once a device
    static bool configured[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES || !configured[dev]) {
        err = cudaFuncSetAttribute(mxu_mod_mat_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(SMEM_BYTES));
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < MAX_DEVICES) configured[dev] = true;
    }
    const int Rp = (R + TABLE_ROWS - 1) / TABLE_ROWS * TABLE_ROWS;
    const int Cp = (C + KC - 1) / KC * KC;
    const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                    static_cast<unsigned>(Rp / BR));
    mxu_mod_mat_kernel<<<grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(x), static_cast<const uint8_t*>(wt),
        static_cast<uint64_t*>(out), R, C, M, Rp, Cp);
    return static_cast<int>(cudaGetLastError());
}

// The kernel's dynamic shared memory, bytes (printed beside its SASS).
extern "C" int srt_mxu_mod_mat_smem() {
    return static_cast<int>(SMEM_BYTES);
}
