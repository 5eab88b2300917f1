// Count-min sketch batch update (paper section 3) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/cms.py:cms_update_pallas (body
// _cms_kernel): tokens (N,) int32 and an optional (N,) int32 weight -> a
// (depth, width) int32 table where row d counts, for every token x, weight
// at column uhash(x, d) % width.  uhash is the multiply-xorshift hash of
// _uhash_u32 with the primes PRIMES[d % 10] and PRIMES[(d + 3) % 10], in
// uint32 arithmetic, so a bucket here is the bucket of the JAX package.
// Counts are int32 and exact (the Pallas f32 accumulator stops being exact
// at 2**24).  The caller zeroes the table.
//
// Bound: memory.  The update must read 4N bytes of tokens (+4N of weights)
// and write depth*width*4; at 3.35 TB/s that is the floor.  The TPU kernel
// scatters each token block with a one-hot (1, BN) x (BN, W) matmul per hash
// row because its MXU is idle otherwise; on Hopper that spends BN*W
// multiply-adds on zeros per row, so here each (token, row) costs one
// atomic add.  Threads grid-stride over tokens.  When the table fits in
// shared memory (depth*width*4 <= 227 KB) every CTA counts into a private
// shared table and flushes only its non-zero entries with global atomics;
// otherwise the atomics go straight to the global table.  Integer atomics
// commute, so the result is exact and independent of their order.  A Zipf
// token stream sends most updates to a few hot buckets, where the shared
// atomics serialise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr long long kMaxSmemBytes = 227 * 1024;

// the JAX package's _HASH_PRIMES (src/repro/core/monoids.py), in order
__constant__ uint32_t kPrimes[10] = {
    0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u,
    0xD3A2646Cu, 0xFD7046C5u, 0xB55A4F09u, 0x8DA6B343u, 0xD8163841u,
};

__device__ __forceinline__ uint32_t uhash(uint32_t x, int seed) {
    const uint32_t a = kPrimes[seed % 10];
    const uint32_t b = kPrimes[(seed + 3) % 10];
    uint32_t h = (x ^ (x >> 16)) * a;
    h = (h ^ (h >> 13)) * b;
    return h ^ (h >> 16);
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const int32_t* __restrict__ tokens,
                  const int32_t* __restrict__ weights,
                  int32_t* __restrict__ out, long long n, int depth,
                  int width) {
    extern __shared__ int32_t table[];
    const long long table_size = (long long)depth * width;
    if (SMEM) {
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            table[i] = 0;
        }
        __syncthreads();
    }
    int32_t* base = SMEM ? table : out;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const int32_t w = weights != nullptr ? weights[i] : 1;
        if (w == 0) continue;
        const uint32_t x = static_cast<uint32_t>(tokens[i]);
        for (int d = 0; d < depth; ++d) {
            const uint32_t col = uhash(x, d) % static_cast<uint32_t>(width);
            atomicAdd(base + (long long)d * width + col, w);
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

// tokens: (n,) int32; weights: (n,) int32 or null (every token counts 1);
// out: (depth, width) int32, zeroed by the caller.  Adds the batch's counts
// into `out` on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cms_update_launch(const void* tokens, const void* weights,
                                 void* out, long long n, int depth, int width,
                                 int sm_count, void* stream) {
    if (n < 0 || depth < 1 || width < 1 || sm_count < 1) {
        return cudaErrorInvalidValue;
    }
    if (n == 0) return cudaSuccess;
    const int32_t* tok = static_cast<const int32_t*>(tokens);
    const int32_t* wts = static_cast<const int32_t*>(weights);
    int32_t* o = static_cast<int32_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long work_blocks = (n + kThreads - 1) / kThreads;
    const long long smem = (long long)depth * width * (long long)sizeof(int32_t);
    if (smem <= kMaxSmemBytes) {
        // every CTA pays depth*width to clear and flush its table, so keep
        // the grid to what is resident at once
        long long per_sm = kMaxSmemBytes / smem;
        if (per_sm > 4) per_sm = 4;
        long long blocks = per_sm * sm_count;
        if (blocks > work_blocks) blocks = work_blocks;
        auto kernel = cms_update_kernel<true>;
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        kernel<<<(unsigned int)blocks, kThreads, (size_t)smem, st>>>(
            tok, wts, o, n, depth, width);
    } else {
        long long blocks = 8LL * sm_count;
        if (blocks > work_blocks) blocks = work_blocks;
        cms_update_kernel<false><<<(unsigned int)blocks, kThreads, 0, st>>>(
            tok, wts, o, n, depth, width);
    }
    return cudaGetLastError();
}
