// K8, the twiddle-fused transpose exchange of the sharded four-step NTT, for
// Hopper (sm_90a).  Plain C entry points, loaded with ctypes by
// stark_rings_tpu_torch/ops/_build.py; the wrappers and their plain twins
// are in stark_rings_tpu_torch/parallel/exchange.py.
//
// Replaces twiddle_exchange_fwd / twiddle_exchange_inv
// (stark_rings_tpu/parallel/pallas_exchange.py:241 / :268, one pallas_call
// at :222).  There each device twiddles its [R1, C] blocks in VMEM and
// sends each one to its destination device with make_async_remote_copy,
// after a barrier.  Here one launch runs the whole exchange over P shards
// of one card: shard s's inputs are read through a table of P source
// pointers, and each product is stored through a table of P destination
// pointers.  With R1 = N1 / P and C = N2 / P:
//
//   forward: out[d][b*R1 + r, s*C + c] = x[s][b*N1 + d*R1 + r, c]
//                                        * tw[s][d*R1 + r, c]
//   inverse: out[d][b*N1 + s*R1 + r, c] = x[s][b*R1 + r, d*C + c]
//                                         * tw[s][r, d*C + c]
//
// i.e. all_to_all(f.mul(x, tw)), split rows / concat cols (forward) or
// split cols / concat rows (inverse).  The reference's barrier keeps a
// remote write from landing in an output that is not live yet; in one
// process the wrapper allocates every output before the launch, and stream
// order does the rest.  The pointer tables are a kernel parameter, so a
// later launch per source device can store into peer memory unchanged.
//
// Goldilocks words are canonical u64 (gl::mul), BabyBear words u32
// Montgomery (bb::mont_mul, the field's own mul on its storage, so the
// twiddle table is used as it is stored).  Two fields and two directions:
// four instances of one template.
//
// Bound: device memory.  One modmul per word against 3 words moved (x and
// tw read, out written; at deg 2^20, P = 8, B = 8 the twiddles are read B
// times, through L2).  The design keeps both sides coalesced: one thread
// per word, consecutive threads on consecutive words of x, and each run
// of C words (C = 128 at deg 2^20, P = 8: 1 KB of u64) lands contiguous in
// the destination.  Every extent is a power of two, so index arithmetic
// is shifts and masks.  Later work: 16-byte loads, and the peer-memory
// launch per source device.

#include <cstdint>

#include <cuda_runtime.h>

#include "babybear.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int EX_THREADS = 256;
constexpr int EX_MAX_P = 64;

template <class W>
struct ShardPtrs {
    const W* x[EX_MAX_P];
    const W* tw[EX_MAX_P];
    W* out[EX_MAX_P];
};

struct GlWord {
    using word = uint64_t;
    static __device__ __forceinline__ word mul(word a, word b) {
        return gl::mul(a, b);
    }
};

struct BbWord {
    using word = uint32_t;
    static __device__ __forceinline__ word mul(word a, word b) {
        return bb::mont_mul(a, b);
    }
};

// Shard s = blockIdx.y; one thread per word of its input (B * N / P words).
template <class F, bool INVERSE>
__global__ void __launch_bounds__(EX_THREADS)
twiddle_exchange_kernel(ShardPtrs<typename F::word> sp, int64_t words,
                        int log_n1, int log_n2, int log_p) {
    const int s = blockIdx.y;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * EX_THREADS
                      + threadIdx.x;
    if (i >= words) return;
    const int log_r1 = log_n1 - log_p;
    const int log_c = log_n2 - log_p;
    const auto v = sp.x[s][i];
    if (!INVERSE) {
        // x[s]: [B, N1, C]; tw[s]: [N1, C]
        const int64_t c = i & ((int64_t{1} << log_c) - 1);
        const int64_t row = (i >> log_c) & ((int64_t{1} << log_n1) - 1);
        const int64_t b = i >> (log_c + log_n1);
        const int64_t d = row >> log_r1;
        const int64_t r = row & ((int64_t{1} << log_r1) - 1);
        const int64_t dst = (((b << log_r1) + r) << log_n2)
                            + (static_cast<int64_t>(s) << log_c) + c;
        sp.out[d][dst] = F::mul(v, sp.tw[s][(row << log_c) + c]);
    } else {
        // x[s]: [B, R1, N2]; tw[s]: [R1, N2]
        const int64_t n2 = i & ((int64_t{1} << log_n2) - 1);
        const int64_t r = (i >> log_n2) & ((int64_t{1} << log_r1) - 1);
        const int64_t b = i >> (log_n2 + log_r1);
        const int64_t d = n2 >> log_c;
        const int64_t c = n2 & ((int64_t{1} << log_c) - 1);
        const int64_t dst = (((b << log_n1) + (static_cast<int64_t>(s)
                                                << log_r1) + r) << log_c) + c;
        sp.out[d][dst] = F::mul(v, sp.tw[s][(r << log_n2) + n2]);
    }
}

template <class F>
int twiddle_exchange(const void* x, const void* tw, const void* out, int P,
                     int64_t B, int log_n1, int log_n2, int log_p,
                     int inverse, cudaStream_t stream) {
    using W = typename F::word;
    if (log_p < 0 || log_p > 6 || P != (1 << log_p) || P > EX_MAX_P
            || log_n1 < log_p || log_n2 < log_p || log_n1 + log_n2 > 40
            || B < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t words = B << (log_n1 + log_n2 - log_p);
    const int64_t blocks = (words + EX_THREADS - 1) / EX_THREADS;
    if (blocks >= (int64_t{1} << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    ShardPtrs<W> sp{};
    for (int p = 0; p < P; ++p) {
        sp.x[p] = static_cast<const W* const*>(x)[p];
        sp.tw[p] = static_cast<const W* const*>(tw)[p];
        sp.out[p] = static_cast<W* const*>(out)[p];
    }
    const dim3 grid(static_cast<unsigned>(blocks), P);
    if (inverse)
        twiddle_exchange_kernel<F, true><<<grid, EX_THREADS, 0, stream>>>(
            sp, words, log_n1, log_n2, log_p);
    else
        twiddle_exchange_kernel<F, false><<<grid, EX_THREADS, 0, stream>>>(
            sp, words, log_n1, log_n2, log_p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8 entry points, one per field: x, tw and out are host arrays of P
// device pointers (shard p's input, twiddle table and output), N1 = 2^log_n1,
// N2 = 2^log_n2, P = 2^log_p <= 64, B rows of the batch; inverse = 0 runs
// the forward direction.  Every output must be allocated (and must not
// alias an input) before the call.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
#define EX_ENTRY(NAME, OPS)                                                  \
    extern "C" int srt_twiddle_exchange_##NAME(                              \
            const void* x, const void* tw, const void* out, int P,           \
            int64_t B, int log_n1, int log_n2, int log_p, int inverse,       \
            void* stream) {                                                  \
        return twiddle_exchange<OPS>(x, tw, out, P, B, log_n1, log_n2,       \
                                     log_p, inverse,                         \
                                     static_cast<cudaStream_t>(stream));     \
    }
EX_ENTRY(goldilocks, GlWord)
EX_ENTRY(babybear, BbWord)
#undef EX_ENTRY
