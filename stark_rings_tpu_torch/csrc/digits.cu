// The folding step's digit stage in one pass, for Hopper (sm_90a): the
// balanced base-b digits of the folded witness, the exact L2 sum of each
// witness's digits and the psi range check of every digit, as one kernel
// a field: step_digits_kernel over Goldilocks (canonical u64 words) and
// bb_step_digits_kernel over BabyBear (canonical u32 Montgomery words).
// Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; the wrapper and its plain twin are in
// stark_rings_tpu_torch/ops/digits.py.
//
// It replaces no Pallas kernel: the reference runs these stages as XLA ops
// (stark_rings_tpu/decomp/balanced.py decompose, decomp/norms.py l2_check,
// rings/monomial.py psi_range_check_batched), and the port ran them as
// chains of torch ops over the whole digit tensor: k passes of torch.where
// and a stack, the squares of base-2^32 words and their stacks, and D - 1
// selects for psi, each a pass over device memory.
//
// A thread takes four coefficients of one row (d, w) of coeff [D, W, L], a
// block's width apart, loaded before any is worked on.  For each: its
// balanced signed magnitude (neg = u > (q - 1) / 2, cur = neg ? q - u : u),
// then the k digits of decompose's fixed-k loop (m = cur mod b; low = 2m <=
// b; the digit's magnitude m if low, else b - m, its sign neg ^ !low, zero
// never negative; cur = cur / b, plus one if not low), the storage words
// of dt[d, w, l k + j].  They pass through shared memory, so that the
// block writes each round's THREADS k contiguous words with neighbouring
// threads on neighbouring words (a thread's own k words, 64 bytes apart
// from the next thread's at Goldilocks' k = 8, would scatter each store
// over 32 sectors).  On each digit's storage word it
// evaluates what the twin evaluates: the canonical value vm, centered = vm
// or q - vm (vm > (q - 1) / 2), the signed magnitude that l2_check
// squares, and psi by the formula of rings/monomial.py _exp_pos_batched:
//     sm = centered narrowed to 32 bits, as there;
//     pos = sm (vm <= (q - 1) / 2) or (D - sm) mod D;
//     valid = sm < D (positive) or sm <= D (negative);
//     ok = valid and tbl[pos mod D] == word
// (|d| <= b/2 < 2^30, so sm keeps centered and pos mod D takes no
// division), tbl the table ct(psi X^p), p in [0, D), of storage words that
// the wrapper passes, staged in shared memory (the wrapper takes the kernel
// only while it fits 48 KB).  A digit fails exactly where the reference's
// check fails it: on these rings every negative digit fails.
//
// Per witness: each block adds its threads' squares (centered^2 <= (b/2)^2
// each) and counts its coefficients with a failing digit; the block that
// draws the witness's last ticket adds every block's two partials (the
// slot_matvec pattern: partials, a fence, then the ticket) and writes
// out[0, w], the witness's exact L2 sum, and out[1, w], its coefficients
// with a failing digit, and leaves the ticket at 0.  The sum stays exact
// while D L k (b/2)^2 < 2^64, which the wrapper checks, and integer sums
// give the same bits in any order of blocks.
//
// Bound by bytes: one read of coeff, one write of dt.  At the BabyBear
// step's shape ([72, 16, 16,384], k = 4) 75.5 MB + 302 MB, 0.113 ms at 3.35
// TB/s; at the Goldilocks step's ([24, 16, 16,384], k = 8) 50.3 MB + 403
// MB, 0.135 ms.  The operations (k digit rounds a coefficient, a REDC or
// two and psi's compares a digit) take the SMs a fraction of that time.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 4;                       // coefficients a thread
constexpr int SPAN = THREADS * PER;          // coefficients a block
constexpr int MAX_K = 64;                    // digits a coefficient
constexpr uint32_t BB_R2 = 1172168163u;      // 2^64 mod q

// psi's table in shared memory, rounded up to 16 bytes.
__host__ __device__ constexpr size_t table_bytes(int D, size_t word) {
    return (D * word + 15) / 16 * 16;
}

// Goldilocks: canonical u64 words, stored as they are.
struct GlField {
    using Word = uint64_t;
    static constexpr uint64_t Q = gl::Q;
    __device__ static uint64_t canon(uint64_t x) { return x; }
    __device__ static uint64_t from_canon(uint64_t u) { return u; }
};

// BabyBear: u32 Montgomery words x R mod q, R = 2^32.
struct BbField {
    using Word = uint32_t;
    static constexpr uint32_t Q = bb::Q;
    __device__ static uint32_t canon(uint32_t x) { return bb::redc64(x); }
    __device__ static uint32_t from_canon(uint32_t u) {
        return bb::mont_mul(u, BB_R2);      // u 2^64 2^-32 = u R mod q
    }
};

__device__ __forceinline__ uint64_t ld_cg(const uint64_t* p) {
    uint64_t a;
    asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(a) : "l"(p) : "memory");
    return a;
}

// The block's sums of a and b mod 2^64, in thread 0 (every thread calls
// it).
__device__ __forceinline__ void block_sums(uint64_t& a, uint64_t& b,
                                           uint64_t (*ws)[WARPS]) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    __syncthreads();                        // ws free from an earlier use
    if (threadIdx.x % 32 == 0) {
        ws[0][threadIdx.x / 32] = a;
        ws[1][threadIdx.x / 32] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 1; i < WARPS; ++i) {
            a += ws[0][i];
            b += ws[1][i];
        }
    }
}

// The k digits of one coefficient's storage word x, written to o[0, k)
// (KC = k known at compile time, or 0); adds their squared signed
// magnitudes to sq, and returns whether every digit passes psi (true
// without PSI).
template <class F, bool POW2, bool PSI, int KC>
__device__ __forceinline__ bool coeff_digits(
        typename F::Word x, typename F::Word* o, int k, typename F::Word b,
        int shift, const typename F::Word* tab, int D, uint64_t& sq) {
    using Word = typename F::Word;
    constexpr Word HALF = (F::Q - 1) / 2;
    const Word u = F::canon(x);
    const bool neg = u > HALF;
    Word cur = neg ? F::Q - u : u;
    bool ok = true;
#pragma unroll
    for (int j = 0; j < (KC ? KC : k); ++j) {
        Word quot, m;
        if (POW2) {
            quot = cur >> shift;
            m = cur & (b - 1);
        } else {
            quot = cur / b;
            m = cur - quot * b;
        }
        const bool low = 2 * m <= b;
        const Word dmag = low ? m : b - m;
        const Word dpos = F::from_canon(dmag);
        const bool dneg = (neg != !low) && dmag != 0;
        const Word word = dneg ? F::Q - dpos : dpos;
        cur = low ? quot : quot + 1;
        // the digit's word as the twin reads it
        const Word vm = F::canon(word);
        const bool is_pos = vm <= HALF;
        const Word centered = is_pos ? vm : F::Q - vm;
        sq += static_cast<uint64_t>(centered) * centered;
        if (PSI) {
            // centered <= b/2 < 2^30: the narrowing to 32 bits keeps it,
            // sm >= 0, and (D - sm) mod D is D - sm or 0
            const int sm = static_cast<int>(centered);
            const bool valid = is_pos ? sm < D : sm <= D;
            const int pos = !valid ? 0 : is_pos ? sm : sm == D ? 0 : D - sm;
            ok = ok && valid && tab[pos] == word;
        }
        o[j] = word;
    }
    return ok;
}

// Block blockIdx.x = (d W + w) chunks + c takes coefficients [c SPAN,
// +SPAN) of row (d, w), PER a thread at a stride of THREADS (loaded first).
// DIRECT (k words of 16 bytes, BabyBear at k = 4): a thread stores its
// coefficient's digits as one 16-byte store beside its neighbours'.
// Otherwise each round of THREADS coefficients puts its digits in shared
// memory, a thread's k words a row of k | 1 words (an odd stride: no bank
// conflicts), and the block then writes the round's contiguous THREADS k
// words of dt, neighbouring threads on neighbouring words.  Dynamic shared
// memory: psi's table (D words, rounded up to 16 bytes), then the rows.
// partials: [W, D chunks, 2] u64 words; tickets: one a witness, all 0;
// out: [2, W] u64 words (int64 tensors).
template <class F, bool POW2, bool PSI, bool DIRECT>
__device__ __forceinline__ void digits_body(
        const typename F::Word* __restrict__ coeff,
        typename F::Word* __restrict__ dt,
        const typename F::Word* __restrict__ tbl, int D, int W, int64_t L,
        int k, typename F::Word b, int shift, uint64_t* partials,
        unsigned* tickets, uint64_t* __restrict__ out) {
    using Word = typename F::Word;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint64_t ws[2][WARPS];
    __shared__ bool last;

    const int64_t chunks = (L + SPAN - 1) / SPAN;
    const int64_t c = blockIdx.x % chunks;
    const int64_t row = blockIdx.x / chunks;            // d W + w
    const int w = static_cast<int>(row % W);
    const int d = static_cast<int>(row / W);
    Word* tab = reinterpret_cast<Word*>(smem);
    if (PSI) {
        for (int i = threadIdx.x; i < D; i += THREADS) tab[i] = tbl[i];
        __syncthreads();
    }

    const int64_t l0 = c * SPAN;
    Word x[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int64_t l = l0 + i * THREADS + threadIdx.x;
        x[i] = l < L ? coeff[row * L + l] : 0;
    }
    uint64_t sq = 0, fails = 0;
    if (DIRECT) {
        constexpr int VEC = 16 / sizeof(Word);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int64_t l = l0 + i * THREADS + threadIdx.x;
            if (l >= L) break;
            union { Word w[VEC]; uint4 v; } pack;
            fails += !coeff_digits<F, POW2, PSI, VEC>(x[i], pack.w, VEC, b,
                                                      shift, tab, D, sq);
            *reinterpret_cast<uint4*>(dt + (row * L + l) * VEC) = pack.v;
        }
    } else {
        Word* stage = reinterpret_cast<Word*>(
            smem + (PSI ? table_bytes(D, sizeof(Word)) : 0));
        const int stride = k | 1;
        // e / k as (e magic) >> 32: exact for e < 2^32 / k (e < THREADS k)
        const uint32_t magic = 0xFFFFFFFFu / k + 1;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int64_t first = l0 + i * THREADS;     // the round's first
            if (first >= L) break;
            const int n = static_cast<int>(L - first < THREADS ? L - first
                                                               : THREADS);
            if (threadIdx.x < n)
                fails += !coeff_digits<F, POW2, PSI, 0>(
                    x[i], stage + threadIdx.x * stride, k, b, shift, tab, D,
                    sq);
            __syncthreads();
            Word* o = dt + (row * L + first) * k;
            for (uint32_t e = threadIdx.x; e < static_cast<uint32_t>(n * k);
                 e += THREADS) {
                const uint32_t r = __umulhi(e, magic);
                o[e] = stage[r * stride + (e - r * k)];
            }
            __syncthreads();
        }
    }

    const int64_t nblk = D * chunks;
    const int64_t blk = d * chunks + c;
    block_sums(sq, fails, ws);
    uint64_t* pw = partials + static_cast<int64_t>(w) * nblk * 2;
    if (threadIdx.x == 0) {
        pw[blk * 2] = sq;
        pw[blk * 2 + 1] = fails;
        __threadfence();
        const bool mine = atomicAdd(tickets + w, 1u)
                          == static_cast<unsigned>(nblk - 1);
        if (mine) {
            tickets[w] = 0;
            __threadfence();
        }
        last = mine;
    }
    __syncthreads();
    if (!last) return;                      // the whole block
    uint64_t s = 0, f = 0;
    for (int64_t i = threadIdx.x; i < nblk; i += THREADS) {
        s += ld_cg(pw + i * 2);
        f += ld_cg(pw + i * 2 + 1);
    }
    block_sums(s, f, ws);
    if (threadIdx.x == 0) {
        out[w] = s;
        out[W + w] = f;
    }
}

#define DIGITS_ARGS(Word)                                                   \
    const Word* __restrict__ coeff, Word* __restrict__ dt,                  \
        const Word* __restrict__ tbl, int D, int W, int64_t L, int k,       \
        Word b, int shift, uint64_t* partials, unsigned* tickets,           \
        uint64_t* __restrict__ out
#define DIGITS_PASS coeff, dt, tbl, D, W, L, k, b, shift, partials, tickets, \
        out

template <bool POW2, bool PSI, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
step_digits_kernel(DIGITS_ARGS(uint64_t)) {
    digits_body<GlField, POW2, PSI, DIRECT>(DIGITS_PASS);
}

template <bool POW2, bool PSI, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
bb_step_digits_kernel(DIGITS_ARGS(uint32_t)) {
    digits_body<BbField, POW2, PSI, DIRECT>(DIGITS_PASS);
}

template <class Word>
using DigitsKernel = void (*)(DIGITS_ARGS(Word));

// One launch: a block a chunk of SPAN coefficients of one (d, w) row; its
// dynamic shared memory holds psi's table and a round's digits (up to 181
// KB at k = 64 and a 48 KB table).
template <class Word>
int launch_digits(const DigitsKernel<Word> kernels[2][2][2],
                  const void* coeff, void* dt, const void* tbl, int D, int W,
                  int64_t L, int k, uint64_t b, int shift, int psi,
                  void* partials, void* tickets, void* out, void* stream) {
    if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = static_cast<int64_t>(D) * W
                           * ((L + SPAN - 1) / SPAN);
    const bool direct = k * sizeof(Word) == 16;
    const size_t smem = (psi ? table_bytes(D, sizeof(Word)) : 0)
        + (direct ? 0 : static_cast<size_t>(THREADS) * (k | 1) * sizeof(Word));
    const DigitsKernel<Word> kernel = kernels[shift >= 0][psi != 0][direct];
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const Word*>(coeff), static_cast<Word*>(dt),
        static_cast<const Word*>(tbl), D, W, L, k, static_cast<Word>(b),
        shift, static_cast<uint64_t*>(partials),
        static_cast<unsigned*>(tickets), static_cast<uint64_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeff [D, W, L] storage words in, dt [D, W, L k] and out [2, W] int64
// out; b even, 2 <= b < 2^31; 1 <= k <= 64; shift = log2(b) when b is a
// power of two, else -1; tbl: D storage words (at most 48 KB) when psi,
// else unused (may be null);
// partials: 2 W D ceil(L / 1024) int64 words; tickets: W, all 0.
extern "C" int srt_step_digits(const void* coeff, void* dt, const void* tbl,
                               int D, int W, int64_t L, int k, uint64_t b,
                               int shift, int psi, void* partials,
                               void* tickets, void* out, void* stream) {
    static const DigitsKernel<uint64_t> kernels[2][2][2] = {
        {{step_digits_kernel<false, false, false>,
          step_digits_kernel<false, false, true>},
         {step_digits_kernel<false, true, false>,
          step_digits_kernel<false, true, true>}},
        {{step_digits_kernel<true, false, false>,
          step_digits_kernel<true, false, true>},
         {step_digits_kernel<true, true, false>,
          step_digits_kernel<true, true, true>}}};
    return launch_digits<uint64_t>(kernels, coeff, dt, tbl, D, W, L, k, b,
                                   shift, psi, partials, tickets, out,
                                   stream);
}

extern "C" int srt_bb_step_digits(const void* coeff, void* dt,
                                  const void* tbl, int D, int W, int64_t L,
                                  int k, uint64_t b, int shift, int psi,
                                  void* partials, void* tickets, void* out,
                                  void* stream) {
    static const DigitsKernel<uint32_t> kernels[2][2][2] = {
        {{bb_step_digits_kernel<false, false, false>,
          bb_step_digits_kernel<false, false, true>},
         {bb_step_digits_kernel<false, true, false>,
          bb_step_digits_kernel<false, true, true>}},
        {{bb_step_digits_kernel<true, false, false>,
          bb_step_digits_kernel<true, false, true>},
         {bb_step_digits_kernel<true, true, false>,
          bb_step_digits_kernel<true, true, true>}}};
    return launch_digits<uint32_t>(kernels, coeff, dt, tbl, D, W, L, k, b,
                                   shift, psi, partials, tickets, out,
                                   stream);
}
