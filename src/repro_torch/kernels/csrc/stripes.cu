// Algorithm 5 ("stripes") co-occurrence counts for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stripes.py:stripes_pallas (body
// _stripes_kernel): tokens (N,) int32 -> a (V, V) int32 table that counts,
// for every pair of positions (i, i + j) with 1 <= j <= window and
// i + j < N whose ids a = tok[i], b = tok[i + j] both lie in [0, V), one at
// [a, b] and one at [b, a] (so 2 on the diagonal when a == b, as the Pallas
// kernel's acc + acc.T gives).  Ids outside [0, V) pair with nothing, as the
// Pallas one-hot drops them.  The caller zeroes the table.
//
// Bound: memory.  The count must read 4N bytes of tokens and write 4*V*V;
// at 3.35 TB/s that is the floor.  The TPU kernel keeps the whole table in
// VMEM and adds one-hot outer products on the MXU, after its wrapper
// gathered an (N, window) neighbour matrix in device memory.  Here a CTA
// loads a tile of tokens plus a `window` halo into shared memory (no
// gathered matrix) and each thread adds its tokens' pairs with integer
// atomics: into a per-CTA shared table when the V*V table and the tile fit
// in 227 KB (V <= ~238), flushed with global atomics for non-zero entries,
// else straight into the global table with 64-bit offsets.  Integer atomics
// commute, so the counts are exact.  A Zipf stream puts a large share of
// all pairs on a few hot addresses, where the atomics serialise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;              // tokens per tile, halo excluded
constexpr long long kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ void add_pair(int32_t* table, long long vocab,
                                         int a, int b) {
    if (a == b) {
        atomicAdd(table + (long long)a * vocab + a, 2);
    } else {
        atomicAdd(table + (long long)a * vocab + b, 1);
        atomicAdd(table + (long long)b * vocab + a, 1);
    }
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
stripes_kernel(const int32_t* __restrict__ tokens, int32_t* __restrict__ out,
               long long n, int vocab, int window) {
    extern __shared__ int32_t smem[];
    int32_t* tile = smem;                                 // kTile + window
    int32_t* table = smem + kTile + window;               // vocab*vocab (SMEM)
    const long long table_size = (long long)vocab * vocab;
    if (SMEM) {
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            table[i] = 0;
        }
    }
    int32_t* base = SMEM ? table : out;
    for (long long start = (long long)blockIdx.x * kTile; start < n;
         start += (long long)gridDim.x * kTile) {
        __syncthreads();   // the previous tile is consumed (and table zeroed)
        for (int t = threadIdx.x; t < kTile + window; t += blockDim.x) {
            // positions past the end read as -1: out of range, no pair
            tile[t] = start + t < n ? tokens[start + t] : -1;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
            const int a = tile[t];
            if (a < 0 || a >= vocab) continue;
            for (int j = 1; j <= window; ++j) {
                const int b = tile[t + j];
                if (b < 0 || b >= vocab) continue;
                add_pair(base, vocab, a, b);
            }
        }
    }
    if (SMEM) {
        __syncthreads();
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            const int32_t v = table[i];
            if (v != 0) atomicAdd(out + i, v);
        }
    }
}

}  // namespace

// tokens: (n,) int32; out: (vocab, vocab) int32, zeroed by the caller.
// Adds the pair counts into `out` on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int stripes_launch(const void* tokens, void* out, long long n,
                              int vocab, int window, int sm_count,
                              void* stream) {
    if (n < 0 || vocab < 1 || window < 1 || window > (1 << 20) ||
        sm_count < 1) {
        return cudaErrorInvalidValue;
    }
    if (n == 0) return cudaSuccess;
    const int32_t* tok = static_cast<const int32_t*>(tokens);
    int32_t* o = static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + kTile - 1) / kTile;
    const long long tile_bytes = (long long)(kTile + window) * sizeof(int32_t);
    const long long smem = tile_bytes +
                           (long long)vocab * vocab * (long long)sizeof(int32_t);
    if (smem <= kMaxSmemBytes) {
        long long per_sm = kMaxSmemBytes / smem;
        if (per_sm > 4) per_sm = 4;
        long long blocks = per_sm * sm_count;
        if (blocks > tiles) blocks = tiles;
        auto kernel = stripes_kernel<true>;
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        kernel<<<(unsigned int)blocks, kThreads, (size_t)smem, st>>>(
            tok, o, n, vocab, window);
    } else {
        if (tile_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
        auto kernel = stripes_kernel<false>;
        if (tile_bytes > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)tile_bytes);
            if (err != cudaSuccess) return err;
        }
        long long blocks = 8LL * sm_count;
        if (blocks > tiles) blocks = tiles;
        kernel<<<(unsigned int)blocks, kThreads, (size_t)tile_bytes, st>>>(
            tok, o, n, vocab, window);
    }
    return cudaGetLastError();
}
