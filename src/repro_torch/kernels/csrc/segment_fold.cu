// Keyed semiring fold (the paper's combiner) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/segment_fold.py:segment_fold_pallas
// (body _segment_fold_kernel): values (N, D) of f32/bf16/f16/int8/uint8/int16/
// int32, seg_ids (N,) int32 and an optional (N,) bool valid mask -> an (S, W)
// float32 table, W = D + with_count (the count column is a virtual column of
// ones).  semiring 0 = sum, 1 = max, 2 = min.  Rows whose id lies outside
// [0, S) or whose mask is false contribute nothing: every table write is
// bounds-checked.  Max/min propagate NaN like torch.maximum / jnp.maximum.
//
// Bound: memory.  The fold must read N*D*elt + 4N (+ N for the mask) bytes
// and write S*W*4; at 3.35 TB/s that is the floor.  The TPU design turns the
// scatter into a one-hot (S, BN) x (BN, D) matmul because its MXU is idle
// otherwise; on Hopper that matmul spends S*N*D multiply-adds on zeros, so
// here each element costs one atomic instead.  One warp folds one row at a
// time (lanes over columns, so a row's id and mask are read once and the
// branch on them is warp-uniform).  When the table fits in shared memory
// (S*W*4 <= 227 KB) each CTA folds into a private shared-memory table with
// shared atomics and flushes only the entries it touched with global atomics,
// so global atomic traffic is bounded by grid * S * W instead of N * W.
// Otherwise elements go straight to the global table.  Float sums are taken
// in atomic order, which varies from run to run; max, min and integer-valued
// sums below 2**24 are order-independent and therefore bit-exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr long long kMaxSmemBytes = 227 * 1024;

enum { kSum = 0, kMax = 1, kMin = 2 };
enum { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kU8 = 4, kI16 = 5, kI32 = 6 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int16_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int32_t x) { return static_cast<float>(x); }

template <int SEMIRING>
__host__ __device__ __forceinline__ float identity() {
    return SEMIRING == kSum ? 0.0f : (SEMIRING == kMax ? -INFINITY : INFINITY);
}

// NaN-propagating max/min by compare-and-swap (shared or global memory).  A
// stored NaN is final; a NaN operand always replaces.
template <int SEMIRING>
__device__ __forceinline__ void atomic_extreme(float* addr, float val) {
    unsigned int* ua = reinterpret_cast<unsigned int*>(addr);
    unsigned int old = *ua;
    unsigned int assumed;
    do {
        assumed = old;
        const float cur = __uint_as_float(assumed);
        if (cur != cur) return;
        const bool wins = (val != val) ||
                          (SEMIRING == kMax ? val > cur : val < cur);
        if (!wins) return;
        old = atomicCAS(ua, assumed, __float_as_uint(val));
    } while (old != assumed);
}

template <int SEMIRING>
__device__ __forceinline__ void fold_into(float* addr, float val) {
    if (SEMIRING == kSum) {
        atomicAdd(addr, val);
    } else {
        atomic_extreme<SEMIRING>(addr, val);
    }
}

__global__ void fill_kernel(float* out, long long n, float value) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        out[i] = value;
    }
}

template <typename T, int SEMIRING, bool SMEM>
__global__ void __launch_bounds__(kThreads)
segment_fold_kernel(const T* __restrict__ values,
                    const int32_t* __restrict__ seg_ids,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ out,
                    long long n, int d, int s, int w) {
    extern __shared__ float table[];
    const long long table_size = (long long)s * w;
    if (SMEM) {
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            table[i] = identity<SEMIRING>();
        }
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    float* base = SMEM ? table : out;
    for (long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
         row < n; row += warps) {
        const int seg = seg_ids[row];
        if (seg < 0 || seg >= s) continue;
        if (mask != nullptr && !mask[row]) continue;
        float* dst = base + (long long)seg * w;
        const T* src = values + row * d;
        for (int col = lane; col < w; col += 32) {
            fold_into<SEMIRING>(dst + col, col < d ? to_f32(src[col]) : 1.0f);
        }
    }
    if (SMEM) {
        __syncthreads();
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            const float v = table[i];
            // untouched entries still hold the identity: skip their atomics
            if (__float_as_uint(v) != __float_as_uint(identity<SEMIRING>())) {
                fold_into<SEMIRING>(out + i, v);
            }
        }
    }
}

template <typename T, int SEMIRING>
cudaError_t launch_typed(const void* values, const int32_t* seg_ids,
                         const uint8_t* mask, float* out, long long n, int d,
                         int s, int w, int sm_count, cudaStream_t stream) {
    const long long table_size = (long long)s * w;
    long long fill_blocks = (table_size + kThreads - 1) / kThreads;
    if (fill_blocks > 4LL * sm_count) fill_blocks = 4LL * sm_count;
    fill_kernel<<<(unsigned int)fill_blocks, kThreads, 0, stream>>>(
        out, table_size, identity<SEMIRING>());
    if (n == 0) return cudaGetLastError();
    const long long rows_per_block = kThreads / 32;
    const long long work_blocks = (n + rows_per_block - 1) / rows_per_block;
    const long long smem = table_size * (long long)sizeof(float);
    if (smem <= kMaxSmemBytes) {
        // every CTA pays S*W to initialise and flush its table, so keep the
        // grid to what is resident at once
        long long per_sm = kMaxSmemBytes / smem;
        if (per_sm > 4) per_sm = 4;
        long long blocks = per_sm * sm_count;
        if (blocks > work_blocks) blocks = work_blocks;
        auto kernel = segment_fold_kernel<T, SEMIRING, true>;
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        kernel<<<(unsigned int)blocks, kThreads, (size_t)smem, stream>>>(
            static_cast<const T*>(values), seg_ids, mask, out, n, d, s, w);
    } else {
        long long blocks = 8LL * sm_count;
        if (blocks > work_blocks) blocks = work_blocks;
        segment_fold_kernel<T, SEMIRING, false>
            <<<(unsigned int)blocks, kThreads, 0, stream>>>(
                static_cast<const T*>(values), seg_ids, mask, out, n, d, s, w);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_semiring(int semiring, const void* values,
                            const int32_t* seg_ids, const uint8_t* mask,
                            float* out, long long n, int d, int s, int w,
                            int sm_count, cudaStream_t stream) {
    switch (semiring) {
        case kSum: return launch_typed<T, kSum>(values, seg_ids, mask, out, n, d, s, w, sm_count, stream);
        case kMax: return launch_typed<T, kMax>(values, seg_ids, mask, out, n, d, s, w, sm_count, stream);
        case kMin: return launch_typed<T, kMin>(values, seg_ids, mask, out, n, d, s, w, sm_count, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// values: (n, d) contiguous of dtype `dtype_code`; seg_ids: (n,) int32;
// mask: (n,) bool or null; out: (s, d + with_count) float32.  Fills `out`
// with the semiring identity and folds into it on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int segment_fold_launch(const void* values, int dtype_code,
                                   const void* seg_ids, const void* mask,
                                   void* out, long long n, int d, int s,
                                   int semiring, int with_count, int sm_count,
                                   void* stream) {
    if (n < 0 || d < 1 || s < 1 || sm_count < 1) return cudaErrorInvalidValue;
    if (with_count && semiring != kSum) return cudaErrorInvalidValue;
    const int w = d + (with_count ? 1 : 0);
    const int32_t* ids = static_cast<const int32_t*>(seg_ids);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype_code) {
        case kF32: return launch_semiring<float>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kBF16: return launch_semiring<__nv_bfloat16>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kF16: return launch_semiring<__half>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kI8: return launch_semiring<int8_t>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kU8: return launch_semiring<uint8_t>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kI16: return launch_semiring<int16_t>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        case kI32: return launch_semiring<int32_t>(semiring, values, ids, m, o, n, d, s, w, sm_count, st);
        default: return cudaErrorInvalidValue;
    }
}
