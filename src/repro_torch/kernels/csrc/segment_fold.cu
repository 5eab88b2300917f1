// Keyed semiring fold (the paper's combiner) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/segment_fold.py:segment_fold_pallas
// (body _segment_fold_kernel): values (N, D) of f32/bf16/f16/int8/uint8/int16/
// int32, seg_ids (N,) int32 and an optional (N,) bool valid mask -> an (S, W)
// float32 table, W = D + with_count (the count column is a virtual column of
// ones).  semiring 0 = sum, 1 = max, 2 = min.  Rows whose id lies outside
// [0, S) or whose mask is false contribute nothing: every table write is
// bounds-checked.
//
// Bound: memory.  The fold must read N*D*elt + 4N (+ N for the mask) bytes
// and write S*W*4; at 3.35 TB/s that is the floor.  The TPU design turns the
// scatter into a one-hot (S, BN) x (BN, D) matmul because its MXU is idle
// otherwise; on Hopper that matmul spends S*N*D multiply-adds on zeros, so
// here each element costs at most one atomic, and the design is about making
// those atomics few and cheap:
//
// - Lanes over rows where W is small.  A warp takes 32 consecutive rows at
//   a time, each lane its own row, so ids, mask and values are read
//   coalesced.  For W <= 4 (every fold of the serving, stream-stats and
//   MapReduce paths: 8 x 3, N x 2, N x 1) a lane loads its whole row into
//   registers; for 4 < W <= 32 the lanes walk the 32 rows' elements in
//   memory order.  Only for W > 32 (mean_by_key's 65, a 128-wide bf16 sum)
//   does a warp take one row at a time, lanes over its columns.
// - Warp aggregation.  Lanes whose rows share an id in a run of consecutive
//   rows combine their values with a segmented warp reduction (five
//   shuffles) and only the run's first lane issues the atomic, so a warp
//   issues one atomic per run and column.  packed_stats (4096 consecutive
//   rows per id) issues one per 32 rows; distinct ids cost nothing extra.
// - Native atomics.  Sums use atomicAdd.  Max and min use integer atomics on
//   the float's bits, split by sign (the IEEE order of non-negative floats is
//   that of their bits as int32, of negative floats the reverse of their bits
//   as uint32): max is atomicMax(int) for a value with the sign bit clear and
//   atomicMin(unsigned) for one with it set; min the mirror.  No CAS loop.
//   Integer inputs fold the same way after the float32 conversion, which is
//   exact because rounding is monotone: f32(max x) == max f32(x).
//   NaN wins and stays: max stores 0x7fc00000 (the largest int32 a float
//   max can hold), min 0xffc00000 (the largest uint32 a float min can hold).
//   +-0.0: max gives +0.0 unless every zero is -0.0, min gives -0.0 if any
//   zero is -0.0 (IEEE 754-2019 maximum / minimum), in any order.
// - One launch where it counts.  When the (S, W) table fits in shared memory
//   and N*W <= 16384 (the serving path's 8 x 3 decode-step fold), ONE CTA
//   folds everything into a shared table and writes the whole table with
//   plain stores: one launch, no fill, no global atomic.  Otherwise a fill
//   kernel writes the identity first (two launches): each CTA folds into a
//   private shared table (S*W*4 <= 227 KB) and flushes its touched entries
//   with global atomics, or, for larger tables, folds straight into the
//   global table.  A single launch there would need a grid-wide barrier
//   between the fill and the first atomic, which a plain launch cannot give.
//
// Float sums are taken in atomic order, which varies from run to run; max,
// min and integer-valued sums below 2**24 are order-independent and
// therefore bit-exact.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr long long kSingleCtaElems = 16384;   // N * W at or below: one CTA
constexpr int kSmallW = 4;                     // W at or below: rows in registers
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMaxNaN = 0x7fc00000u;
constexpr unsigned kMinNaN = 0xffc00000u;

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

// The semiring's combine in registers, with the atomics' NaN and +-0 rules.
template <int SEMIRING>
__device__ __forceinline__ float combine(float a, float b) {
    if (SEMIRING == kSum) return a + b;
    if (a != a) return a;
    if (b != b) return b;
    if (a == b) {   // equal values differ in bits only as +0.0 / -0.0
        const unsigned ua = __float_as_uint(a), ub = __float_as_uint(b);
        return __uint_as_float(SEMIRING == kMax ? (ua & ub) : (ua | ub));
    }
    return SEMIRING == kMax ? fmaxf(a, b) : fminf(a, b);
}

// One element into a table entry (shared or global memory), native atomics.
template <int SEMIRING>
__device__ __forceinline__ void fold_into(float* addr, float val) {
    if (SEMIRING == kSum) {
        atomicAdd(addr, val);
        return;
    }
    int* as_int = reinterpret_cast<int*>(addr);
    unsigned* as_uint = reinterpret_cast<unsigned*>(addr);
    const unsigned bits = __float_as_uint(val);
    if (SEMIRING == kMax) {
        if (val != val) atomicMax(as_int, (int)kMaxNaN);
        else if (bits >> 31) atomicMin(as_uint, bits);
        else atomicMax(as_int, (int)bits);
    } else {
        if (val != val) atomicMax(as_uint, kMinNaN);
        else if (bits >> 31) atomicMax(as_uint, bits);
        else atomicMin(as_int, (int)bits);
    }
}

// Runs of equal keys among the warp's lanes (a key of -1 marks a dropped
// row): `head` is true for a run's first lane, `run_end` is its last lane,
// `aggregate` is false when every run is one lane long (warp-uniform).
struct Runs {
    bool head;
    bool aggregate;
    int run_end;
};

__device__ __forceinline__ Runs find_runs(int key, int lane) {
    const int up = __shfl_up_sync(kFull, key, 1);
    const int down = __shfl_down_sync(kFull, key, 1);
    const unsigned tails = __ballot_sync(kFull, lane == 31 || key != down);
    Runs runs;
    runs.head = lane == 0 || key != up;
    runs.aggregate = tails != kFull;
    runs.run_end = lane + __ffs(tails >> lane) - 1;
    return runs;
}

// Segmented suffix reduction: afterwards a run's first lane holds the
// combine of the run's values.  Every lane of the warp must call it.
template <int SEMIRING>
__device__ __forceinline__ float reduce_run(float x, int lane, int run_end) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(kFull, x, off);
        if (lane + off <= run_end) x = combine<SEMIRING>(x, y);
    }
    return x;
}

__global__ void fill_kernel(float* out, long long n, float value) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        out[i] = value;
    }
}

// The three ways a warp walks the values (by W): kRows, W <= kSmallW, each
// lane loads its own row into registers; kElems, W <= 32, the lanes walk 32
// rows' elements in memory order; kCols, W > 32, one row at a time with
// the lanes over its columns (the row's id read once, a dropped row skipped
// whole).  SMEM: fold into a shared-memory table, then either store it
// (single != 0, one CTA) or flush its touched entries into `out` with
// atomics.
enum { kRows = 0, kElems = 1, kCols = 2 };

template <typename T, int SEMIRING, int LAYOUT, bool SMEM>
__global__ void __launch_bounds__(kThreads)
segment_fold_kernel(const T* __restrict__ values,
                    const int32_t* __restrict__ seg_ids,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ out,
                    long long n, int d, int s, int w, int single) {
    extern __shared__ float smem_table[];
    const long long table_size = (long long)s * w;
    if (SMEM) {
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            smem_table[i] = identity<SEMIRING>();
        }
        __syncthreads();
    }
    float* table = SMEM ? smem_table : out;
    const int lane = threadIdx.x & 31;
    const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    if (LAYOUT == kCols) {
        for (long long row = warp; row < n; row += warps) {
            const int seg = seg_ids[row];
            if (seg < 0 || seg >= s) continue;
            if (mask != nullptr && !mask[row]) continue;
            float* dst = table + (long long)seg * w;
            const T* src = values + row * d;
            for (int col = lane; col < w; col += 32) {
                fold_into<SEMIRING>(dst + col, col < d ? to_f32(src[col]) : 1.0f);
            }
        }
    }
    // kElems: the element this lane takes in step 0 of a 32-row chunk is
    // (row r0, column c0); each step advances it by 32 elements
    const int r0 = LAYOUT == kElems ? lane / d : 0;
    const int c0 = LAYOUT == kElems ? lane % d : 0;
    const int dq = LAYOUT == kElems ? 32 / d : 0;
    const int dr = LAYOUT == kElems ? 32 % d : 0;
    for (long long base = warp * 32; LAYOUT != kCols && base < n;
         base += warps * 32) {
        const long long row = base + lane;
        float x[kSmallW];
        if (LAYOUT == kRows) {
#pragma unroll
            for (int c = 0; c < kSmallW; ++c) {
                x[c] = (c < d && row < n) ? to_f32(values[row * d + c]) : 0.0f;
            }
        }
        int key = -1;
        if (row < n) {
            const int seg = seg_ids[row];
            if (seg >= 0 && seg < s && (mask == nullptr || mask[row])) key = seg;
        }
        const Runs runs = find_runs(key, lane);
        if (LAYOUT == kRows) {
#pragma unroll
            for (int c = 0; c < kSmallW; ++c) {
                if (c >= w) break;
                float v = key < 0 ? identity<SEMIRING>() : (c < d ? x[c] : 1.0f);
                if (runs.aggregate) v = reduce_run<SEMIRING>(v, lane, runs.run_end);
                if (key >= 0 && runs.head) {
                    fold_into<SEMIRING>(table + (long long)key * w + c, v);
                }
            }
        } else {
            const T* chunk = values + base * d;
            // elements of the chunk that lie in the table: the loads need
            // not wait for the row's key, so unrolled steps overlap them
            const long long in_chunk = (n - base) * d;
            int r = r0, c = c0;
#pragma unroll 8
            for (int step = 0; step < d; ++step) {
                const int e = lane + 32 * step;
                const float v = e < in_chunk ? to_f32(chunk[e]) : 0.0f;
                const int row_key = __shfl_sync(kFull, key, r);
                if (row_key >= 0) {
                    fold_into<SEMIRING>(table + (long long)row_key * w + c, v);
                }
                c += dr;
                r += dq;
                if (c >= d) {
                    c -= d;
                    ++r;
                }
            }
            if (w > d) {   // the count column (sum only)
                float v = key < 0 ? 0.0f : 1.0f;
                if (runs.aggregate) v = reduce_run<SEMIRING>(v, lane, runs.run_end);
                if (key >= 0 && runs.head) {
                    fold_into<SEMIRING>(table + (long long)key * w + d, v);
                }
            }
        }
    }
    if (SMEM) {
        __syncthreads();
        for (long long i = threadIdx.x; i < table_size; i += blockDim.x) {
            const float v = smem_table[i];
            if (single) {
                out[i] = v;
            } else if (__float_as_uint(v) !=
                       __float_as_uint(identity<SEMIRING>())) {
                // untouched entries still hold the identity: no atomic
                fold_into<SEMIRING>(out + i, v);
            }
        }
    }
}

// How one call runs: the kernel variant and its grid.
struct Plan {
    int layout;
    bool smem;
    bool single;
    long long blocks;
    int threads;
    long long smem_bytes;
};

Plan make_plan(long long n, int s, int w, int sm_count) {
    Plan p;
    p.layout = w <= kSmallW ? kRows : (w <= 32 ? kElems : kCols);
    p.smem_bytes = (long long)s * w * (long long)sizeof(float);
    p.smem = p.smem_bytes <= kMaxSmemBytes;
    p.single = p.smem && n * w <= kSingleCtaElems;
    if (p.single) {
        const long long rows = (n + 31) / 32 * 32;
        const long long cap = p.layout == kCols ? kThreads / 2 : kThreads;
        p.threads = (int)(rows < 32 ? 32 : (rows > cap ? cap : rows));
        p.blocks = 1;
        return p;
    }
    // kCols: 512-thread CTAs, up to 8 per SM over the global table; the
    // lanes-over-rows layouts: two 1024-thread CTAs fill an SM
    p.threads = p.layout == kCols ? kThreads / 2 : kThreads;
    const long long rows_per_block = p.layout == kCols ? p.threads / 32 : p.threads;
    const long long work_blocks = (n + rows_per_block - 1) / rows_per_block;
    long long per_sm = p.layout == kCols ? 8 : 2;
    if (p.smem) {
        // every CTA pays S*W to initialise and flush its table, so keep the
        // grid to what is resident at once
        long long fit = kMaxSmemBytes / p.smem_bytes;
        if (fit > 2048 / p.threads) fit = 2048 / p.threads;
        if (fit < per_sm) per_sm = fit;
    }
    p.blocks = per_sm * sm_count;
    if (p.blocks > work_blocks) p.blocks = work_blocks;
    return p;
}

template <typename T, int SEMIRING, int LAYOUT, bool SMEM>
cudaError_t launch_fold(const Plan& p, const void* values,
                        const int32_t* seg_ids, const uint8_t* mask,
                        float* out, long long n, int d, int s, int w,
                        cudaStream_t stream) {
    auto kernel = segment_fold_kernel<T, SEMIRING, LAYOUT, SMEM>;
    const size_t smem = SMEM ? (size_t)p.smem_bytes : 0;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<(unsigned int)p.blocks, p.threads, smem, stream>>>(
        static_cast<const T*>(values), seg_ids, mask, out, n, d, s, w,
        p.single ? 1 : 0);
    return cudaGetLastError();
}

template <typename T, int SEMIRING, int LAYOUT>
cudaError_t launch_layout(const Plan& p, const void* values,
                          const int32_t* seg_ids, const uint8_t* mask,
                          float* out, long long n, int d, int s, int w,
                          cudaStream_t stream) {
    return p.smem
        ? launch_fold<T, SEMIRING, LAYOUT, true>(p, values, seg_ids, mask, out, n, d, s, w, stream)
        : launch_fold<T, SEMIRING, LAYOUT, false>(p, values, seg_ids, mask, out, n, d, s, w, stream);
}

template <typename T, int SEMIRING>
cudaError_t launch_typed(const void* values, const int32_t* seg_ids,
                         const uint8_t* mask, float* out, long long n, int d,
                         int s, int w, int sm_count, cudaStream_t stream) {
    const Plan p = make_plan(n, s, w, sm_count);
    if (!p.single) {
        const long long table_size = (long long)s * w;
        long long fill_blocks = (table_size + kThreads - 1) / kThreads;
        if (fill_blocks > 2LL * sm_count) fill_blocks = 2LL * sm_count;
        fill_kernel<<<(unsigned int)fill_blocks, kThreads, 0, stream>>>(
            out, table_size, identity<SEMIRING>());
        if (n == 0) return cudaGetLastError();
    }
    switch (p.layout) {
        case kRows: return launch_layout<T, SEMIRING, kRows>(p, values, seg_ids, mask, out, n, d, s, w, stream);
        case kElems: return launch_layout<T, SEMIRING, kElems>(p, values, seg_ids, mask, out, n, d, s, w, stream);
        default: return launch_layout<T, SEMIRING, kCols>(p, values, seg_ids, mask, out, n, d, s, w, stream);
    }
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
// mask: (n,) bool or null; out: (s, d + with_count) float32.  Writes the
// semiring's fold into `out` (identity where nothing lands) on `stream`;
// returns cudaGetLastError() (0 on success).
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
