// Flash attention backward for Hopper, sm_90a: dq, dk, dv of
// flash_attention.cu's forward.
//
// Replaces no TPU kernel: the Pallas flash_attention kernel
// (src/repro/kernels/flash_attention.py) has no backward, and the JAX
// package trains through XLA's autodiff of its own attention
// (src/repro/models/attention.py:151).  This kernel is the gradient of the
// port's forward, under the same contract:
//   * q (B, H, Sq, d), k and v (B, KV, Sk, d) with H % KV == 0, all
//     float32, all bfloat16 or all float16, any d in 1..256, any batch /
//     head / row strides with a unit-stride last axis (o, do, dq, dk, dv
//     alike);
//   * the forward's masks: causal top-left (k_pos <= q_pos), non-causal at
//     any Sq and Sk, and the sliding window (qp - window < k_pos <= qp);
//   * inputs are cast up to f32, every product and sum is f32, the softmax
//     is f32, and dq, dk, dv are rounded once to the inputs' dtype.
// With s = (q . k) * scale and lse the forward's row log-sum-exp (read, not
// recomputed):
//   D = rowsum(dO . O),  P = exp(s - lse),  dV = P^T dO,  dP = dO V^T,
//   dS = P * (dP - D),   dQ = dS K * scale, dK = dS^T Q * scale.
//
// Bound.  At qwen3-0.6b's training shape (B 8, S 1024, 16 / 8 heads of 128,
// bf16, causal) the work is ~2.5x the forward's products, ~86 GFLOP against
// ~235 MB: the tensor cores' rate bounds it.
//
// Design.
//   * Three launches per call.  A preprocess computes D (one warp per query
//     row).  The dK / dV kernel runs one block per (batch, KV head, key
//     tile): it keeps the tile's K and V in shared memory and its dK and dV
//     sums in registers, and loops over the group's H / KV query heads and,
//     within each, over the query tiles that can see the key tile, so a GQA
//     group's sum is taken in one fixed order with no atomics
//     (deterministic).  The dQ kernel runs one block per (batch, head,
//     query tile) and loops over the live key tiles.  Each kernel
//     recomputes s and dP for its tile pairs.
//   * 16-bit inputs run on the tensor cores (mma.sync
//     m16n8k16, f32 accumulation; the forward's fragment plumbing): 4 warps
//     of 16 rows own a block's 64 keys (dK / dV) or 64 queries (dQ), the
//     looped tiles are 32 rows, tiles land by cp.async with rows padded for
//     ldmatrix and head dims zero-padded to a multiple of 16; s and dP^T
//     (or s^T and dP^T) accumulate as C fragments, become P and dS in
//     registers, and enter the next products as A fragments split into two
//     16-bit halves (x = hi + lo, two mmas: P and dS are f32 and are never
//     rounded to one 16-bit value), so dV = P^T dO, dK = dS^T Q and dQ =
//     dS K keep the f32 contract.  A warp skips a tile whose entries the
//     causal or window mask all drop.  Above 128 columns a block's output
//     columns are split in two (blockIdx.z), each half recomputing s and dP
//     over all of d, so a warp's dK and dV sums fit its registers.
//   * f32 inputs run on the CUDA cores in f32 FMA (the f32 contract would
//     need three bf16 products per product on the tensor cores):
//     32-row tiles staged in shared memory as f32 (rows padded by 4 floats
//     so the float4 reads of 8 rows fall in distinct banks), each of 256
//     threads computing 4 score entries or one row's float4 column groups.
//   * wgmma with TMA loads and warp specialisation are a later redesign.
//   * Masks as in the forward.  A dK / dV block starts at the first query
//     tile that sees its keys (causal: the tile of query k0) and ends past
//     the last (window: query k0 + rows - 1 + window - 1); a dQ block loops
//     over the key tiles from its first row's window edge to its last row's
//     diagonal.  Entries outside the mask, past Sq or past Sk get P = 0.
//   * Head dims are bucketed (32, 64, 128, 256 columns), zero-padded in
//     shared memory; columns past d are never stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;     // 8 warps
constexpr int BQ = 32;            // query rows per tile
constexpr int BK = 32;            // key rows per tile
constexpr int LDP = BQ + 8;       // P / dS row stride: 8 key rows, distinct banks
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    const float* lse;             // (B, H, Sq) contiguous
    float* delta;                 // (B, H, Sq) contiguous: D
    void* dq;
    void* dk;
    void* dv;
    long long q_sb, q_sh, q_ss;   // element strides: batch, head, row
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    long long do_sb, do_sh, do_ss;
    long long dq_sb, dq_sh, dq_ss;
    long long dk_sb, dk_sh, dk_ss;
    long long dv_sb, dv_sh, dv_ss;
    int B, H, KV, Sq, Sk, d;
    float scale;
    int causal;
    int window;                   // 0: none
    int vec_q, vec_k, vec_v, vec_do;   // 16-byte aligned bases and strides
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
        __nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
    return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
    return __float2half_rn(x);
}

// Rows [r0, r0 + ROWS) of one (batch, head) slice (row stride ss), columns
// [0, DB), into shared memory as f32 (row stride LD): zeros past n_valid
// rows and past column d.
template <int DB, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long ss,
                                          int r0, int n_valid, int d,
                                          int tid) {
    constexpr int LD = DB + 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * DB; i += kThreads) {
        const int r = i / DB, c = i % DB, gr = r0 + r;
        s[r * LD + c] = gr < n_valid && c < d ? to_f32(g[gr * ss + c]) : 0.f;
    }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
    y.x = fmaf(s, x.x, y.x);
    y.y = fmaf(s, x.y, y.y);
    y.z = fmaf(s, x.z, y.z);
    y.w = fmaf(s, x.w, y.w);
}

__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
    return qp < a.Sq && kp < a.Sk && (!a.causal || kp <= qp) &&
           (a.window == 0 || kp > qp - a.window);
}

// -- D = rowsum(dO . O): one warp per (b, h, row) ---------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a) {
    const long long row = (long long)blockIdx.x * (kThreads / 32) +
                          threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const long long rows = (long long)a.B * a.H * a.Sq;
    if (row >= rows) return;
    const int i = (int)(row % a.Sq);
    const int h = (int)((row / a.Sq) % a.H);
    const int b = (int)(row / ((long long)a.Sq * a.H));
    const T* O = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
                 i * a.o_ss;
    const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb +
                  h * a.do_sh + i * a.do_ss;
    float acc = 0.f;
    for (int c = lane; c < a.d; c += 32)
        acc = fmaf(to_f32(dO[c]), to_f32(O[c]), acc);
#pragma unroll
    for (int s = 16; s > 0; s /= 2) acc += __shfl_xor_sync(kFull, acc, s);
    if (lane == 0) a.delta[row] = acc;
}

// shared-memory layout of both tile kernels, in floats
template <int DB>
struct Smem {
    static constexpr int LD = DB + 4;
    static constexpr int kQ = 0;                      // [BQ][LD]
    static constexpr int kDO = kQ + BQ * LD;          // [BQ][LD]
    static constexpr int kK = kDO + BQ * LD;          // [BK][LD]
    static constexpr int kV = kK + BK * LD;           // [BK][LD]
    static constexpr int kP = kV + BK * LD;           // [32][LDP]
    static constexpr int kDS = kP + 32 * LDP;         // [32][LDP]
    static constexpr int kLse = kDS + 32 * LDP;       // [BQ]
    static constexpr int kDelta = kLse + BQ;          // [BQ]
    static constexpr size_t kBytes = (size_t)(kDelta + BQ) * sizeof(float);
};

// A query tile's Q, dO, lse * log2(e) and D, rows [q0, q0 + BQ).
template <int DB, typename T>
__device__ __forceinline__ void load_query_tile(const Args& a, float* sm,
                                                const T* Q, const T* dO,
                                                const float* lse,
                                                const float* delta, int q0,
                                                int tid) {
    using S = Smem<DB>;
    load_tile<DB, BQ>(sm + S::kQ, Q, a.q_ss, q0, a.Sq, a.d, tid);
    load_tile<DB, BQ>(sm + S::kDO, dO, a.do_ss, q0, a.Sq, a.d, tid);
    if (tid < BQ) {
        const int r = q0 + tid;
        sm[S::kLse + tid] = r < a.Sq ? lse[r] * kLog2e : 0.f;
        sm[S::kDelta + tid] = r < a.Sq ? delta[r] : 0.f;
    }
}

// The scores and dP of 4 (row, column) entries: s[i] = A[ra] . B[cb_i] and
// dp[i] = A2[ra] . B2[cb_i], cb_i = cj + 8 i, over the DB columns.
template <int DB>
__device__ __forceinline__ void four_dots(const float* A, const float* A2,
                                          const float* Bm, const float* B2,
                                          int ra, int cj, float s[4],
                                          float dp[4]) {
    constexpr int LD = DB + 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.f;
    const float* a1 = A + ra * LD;
    const float* a2 = A2 + ra * LD;
#pragma unroll 4
    for (int c = 0; c < DB; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a1 + c);
        const float4 y = *reinterpret_cast<const float4*>(a2 + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = cj + 8 * i;
            s[i] = dot4(x, *reinterpret_cast<const float4*>(Bm + r * LD + c),
                        s[i]);
            dp[i] = dot4(y, *reinterpret_cast<const float4*>(B2 + r * LD + c),
                         dp[i]);
        }
    }
}

// -- dK, dV: one block per (b, kv head, 32-key tile) ------------------------

template <int DB, typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
    using S = Smem<DB>;
    constexpr int LD = S::LD, NC = DB / 32;
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
    const int k0 = blockIdx.y * BK;
    const int G = a.H / a.KV;

    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    load_tile<DB, BK>(sm + S::kK, K, a.k_ss, k0, a.Sk, a.d, tid);
    load_tile<DB, BK>(sm + S::kV, V, a.v_ss, k0, a.Sk, a.d, tid);

    // the queries that can see keys [k0, k0 + BK)
    const int q_lo = a.causal ? k0 : 0;
    const int q_hi = a.window > 0 ? min(a.Sq, k0 + BK - 1 + a.window) : a.Sq;

    const int kr = tid / 8, cj = tid % 8;   // this thread's key row, lane
    float4 dk[NC], dv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
        dk[j] = dv[j] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int hg = 0; hg < G; ++hg) {
        const int h = kvh * G + hg;
        const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
        const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb +
                      h * a.do_sh;
        const long long row0 = ((long long)b * a.H + h) * a.Sq;
        for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
            __syncthreads();            // the previous tile's reads are done
            load_query_tile<DB>(a, sm, Q, dO, a.lse + row0, a.delta + row0,
                                q0, tid);
            __syncthreads();
            // s^T and dP^T: key row kr against query rows cj + 8 i
            float s[4], dp[4];
            four_dots<DB>(sm + S::kK, sm + S::kV, sm + S::kQ, sm + S::kDO,
                          kr, cj, s, dp);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int qc = cj + 8 * i;
                float p = 0.f;
                if (live(a, q0 + qc, k0 + kr))
                    p = exp2f(fmaf(s[i], a.scale * kLog2e,
                                   -sm[S::kLse + qc]));
                sm[S::kP + kr * LDP + qc] = p;
                sm[S::kDS + kr * LDP + qc] = p * (dp[i] - sm[S::kDelta + qc]);
            }
            __syncthreads();
            // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll 4
            for (int q = 0; q < BQ; ++q) {
                const float p = sm[S::kP + kr * LDP + q];
                const float ds = sm[S::kDS + kr * LDP + q];
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const int c = 4 * cj + 32 * j;
                    axpy4(p, *reinterpret_cast<const float4*>(
                                 sm + S::kDO + q * LD + c), dv[j]);
                    axpy4(ds, *reinterpret_cast<const float4*>(
                                  sm + S::kQ + q * LD + c), dk[j]);
                }
            }
        }
    }

    const int kp = k0 + kr;
    if (kp >= a.Sk) return;
    T* dK = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + kp * a.dk_ss;
    T* dV = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + kp * a.dv_ss;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const int c = 4 * cj + 32 * j;
        const float xk[4] = {dk[j].x, dk[j].y, dk[j].z, dk[j].w};
        const float xv[4] = {dv[j].x, dv[j].y, dv[j].z, dv[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c + e < a.d) {
                dK[c + e] = from_f32<T>(xk[e] * a.scale);
                dV[c + e] = from_f32<T>(xv[e]);
            }
    }
}

// -- dQ: one block per (b, head, 32-query tile) -----------------------------

template <int DB, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
    using S = Smem<DB>;
    constexpr int LD = S::LD, NC = DB / 32;
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int kvh = h / (a.H / a.KV);
    const int q0 = blockIdx.y * BQ;

    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    load_query_tile<DB>(a, sm, Q, dO, a.lse + row0, a.delta + row0, q0, tid);

    // the keys rows [q0, q0 + BQ) can see
    const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;

    const int qr = tid / 8, cj = tid % 8;   // this thread's query row, lane
    float4 dq[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[j] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
        __syncthreads();                // the previous tile's reads are done
        load_tile<DB, BK>(sm + S::kK, K, a.k_ss, k0, a.Sk, a.d, tid);
        load_tile<DB, BK>(sm + S::kV, V, a.v_ss, k0, a.Sk, a.d, tid);
        __syncthreads();
        // s and dP: query row qr against key rows cj + 8 i
        float s[4], dp[4];
        four_dots<DB>(sm + S::kQ, sm + S::kDO, sm + S::kK, sm + S::kV, qr, cj,
                      s, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kc = cj + 8 * i;
            float ds = 0.f;
            if (live(a, q0 + qr, k0 + kc)) {
                const float p = exp2f(fmaf(s[i], a.scale * kLog2e,
                                           -sm[S::kLse + qr]));
                ds = p * (dp[i] - sm[S::kDelta + qr]);
            }
            sm[S::kDS + qr * LDP + kc] = ds;
        }
        __syncthreads();
        // dQ += dS K over this tile's keys
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float ds = sm[S::kDS + qr * LDP + kk];
#pragma unroll
            for (int j = 0; j < NC; ++j)
                axpy4(ds, *reinterpret_cast<const float4*>(
                              sm + S::kK + kk * LD + 4 * cj + 32 * j), dq[j]);
        }
    }

    const int qp = q0 + qr;
    if (qp >= a.Sq) return;
    T* dQ = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh + qp * a.dq_ss;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const int c = 4 * cj + 32 * j;
        const float x[4] = {dq[j].x, dq[j].y, dq[j].z, dq[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c + e < a.d) dQ[c + e] = from_f32<T>(x[e] * a.scale);
    }
}

// -- tensor-core kernels: 16-bit inputs, head dims up to 128 ---------------
//
// The same two-kernel split on mma.sync m16n8k16 (f32 accumulation), with
// the forward's fragment plumbing: tiles of 16-bit inputs land in shared
// memory by cp.async (rows padded by 16 bytes for ldmatrix, head dims
// zero-padded to a multiple of 16), a warp owns 16 rows of the block's
// tile, and a score accumulator becomes an A operand without a trip
// through shared memory.  s, dP and the softmax stay f32; P and dS, f32
// values, enter their products split into two 16-bit halves (x = hi + lo,
// two mmas), as the forward's p does, so no f32 operand is rounded to one
// 16-bit value.

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float x, float y, __nv_bfloat16*) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(float x, float y, __half*) {
    __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t r, __nv_bfloat16*) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
__device__ __forceinline__ float2 unpack(uint32_t r, __half*) {
    return __half22float2(*reinterpret_cast<__half2*>(&r));
}

// (x, y) = hi + lo with hi = round(x, y) and lo = round((x, y) - hi)
template <typename M>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
    hi = pack(x, y, (M*)nullptr);
    const float2 h = unpack(hi, (M*)nullptr);
    lo = pack(x - h.x, y - h.y, (M*)nullptr);
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1,
                                         __nv_bfloat16*) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1, __half*) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(s)), "l"(g));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Rows [r0, r0 + ROWS) of one (batch, head) slice, columns [0, dpad), into
// shared memory (row stride LD): cp.async 16-byte chunks where the source
// is aligned and in range, zeros past n_valid rows and past column d,
// element-wise loads elsewhere (the forward's loader).  The caller waits.
template <int DB, int ROWS, typename T>
__device__ __forceinline__ void load_tile16(T* s, const T* g, long long ss,
                                            int r0, int n_valid, int d,
                                            int dpad, bool vec, int tid) {
    constexpr int CE = 8;                 // 16-bit elements per 16 bytes
    constexpr int CPR = DB / CE;
    constexpr int LD = DB + 8;
#pragma unroll 1
    for (int i = tid; i < ROWS * CPR; i += kMmaThreads) {
        const int r = i / CPR, c = (i % CPR) * CE, gr = r0 + r;
        if (c >= dpad) continue;
        T* dst = s + r * LD + c;
        if (gr < n_valid && vec && c + CE <= d) {
            cp_async16(dst, g + gr * ss + c);
        } else if (gr >= n_valid || c >= d) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        } else {
#pragma unroll
            for (int e = 0; e < CE; ++e)
                dst[e] = c + e < d ? g[gr * ss + c + e] : from_f32<T>(0.f);
        }
    }
}

// acc[n-tiles] += A (16 rows of sA, row 16 w) . B^T (rows of sB as the n
// dim): the q . k^T pattern, NT n-tiles of 8 rows of sB, over dk k-steps
template <int DB, int NT, typename T>
__device__ __forceinline__ void mma_abt(float acc[NT][4], const T* sA,
                                        const T* sB, int w, int dk,
                                        int lane) {
    constexpr int LD = DB + 8;
    const int a_row = lane % 16, a_col = 8 * (lane / 16);
    const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
        acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk) {
        if (kk < dk) {
            uint32_t a[4];
            ldsm_x4(a, sA + (16 * w + a_row) * LD + 16 * kk + a_col);
#pragma unroll
            for (int jp = 0; jp < NT / 2; ++jp) {
                uint32_t b[4];
                ldsm_x4(b, sB + (16 * jp + k_row) * LD + 16 * kk + k_col);
                mma16816(acc[2 * jp], a, b[0], b[1], (T*)nullptr);
                mma16816(acc[2 * jp + 1], a, b[2], b[3], (T*)nullptr);
            }
        }
    }
}

// acc[DC/8 n-tiles] += X . sB, X the f32 16 x (16 NK) C fragments x[2 NK]
// (rows g, g + 8) split into two 16-bit halves, sB rows [0, 16 NK) x the
// 16-column groups of columns [c0, c0 + DC) below 16 dk (the p . v
// pattern)
template <int DB, int DC, int NK, typename T>
__device__ __forceinline__ void mma_xb(float acc[DC / 8][4],
                                       float x[2 * NK][4],
                                       const T* sB, int c0, int dk,
                                       int lane) {
    constexpr int LD = DB + 8;
    const int a_row = lane % 16, a_col = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
        uint32_t hi[4], lo[4];
        split2<T>(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
        split2<T>(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
        split2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
        split2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
            if (c0 / 16 + dp < dk) {
                uint32_t b[4];
                ldsm_x4_trans(b, sB + (16 * kk + a_row) * LD + c0 + 16 * dp +
                                     a_col);
                mma16816(acc[2 * dp], hi, b[0], b[1], (T*)nullptr);
                mma16816(acc[2 * dp + 1], hi, b[2], b[3], (T*)nullptr);
                mma16816(acc[2 * dp], lo, b[0], b[1], (T*)nullptr);
                mma16816(acc[2 * dp + 1], lo, b[2], b[3], (T*)nullptr);
            }
        }
    }
}

// rows g, g + 8 of a warp's 16 x DC accumulator (times mul) into global
// rows r0 + g, r0 + g + 8 (below n_valid), columns c0 + [0, DC) below d
template <int DC, typename T>
__device__ __forceinline__ void store_rows(T* G, long long ss, int r0,
                                           int n_valid, int c0, int d,
                                           float mul, float acc[DC / 8][4],
                                           int lane) {
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i;
        if (r >= n_valid) continue;
        T* row = G + r * ss;
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
            const int c = c0 + 8 * j + 2 * t4;
            if (c < d) row[c] = from_f32<T>(acc[j][2 * i] * mul);
            if (c + 1 < d) row[c + 1] = from_f32<T>(acc[j][2 * i + 1] * mul);
        }
    }
}

template <int DB>
struct MmaSmem {
    static constexpr int LD = DB + 8;
    static constexpr int R = 64;               // the block's own rows
    static constexpr int C = 32;               // rows of the looped tile
    // [own A rows][own B rows][looped A rows][looped B rows], then f32
    // lse * log2(e) and D of the query rows
    static constexpr size_t k16 = (size_t)(2 * R + 2 * C) * LD;
    static constexpr size_t kBytes = k16 * 2 + 2 * R * sizeof(float);
};

// dK, dV: one block per (b, kv head, 64 keys, DC output columns); warp w
// owns keys 16 w ..; loops over the group's heads and the 32-query tiles
// that see its keys.  Above 128 columns the output columns are split over
// blockIdx.z (each block recomputes s and dP^T over all of d), so a warp's
// dK and dV sums fit its registers.
template <int DB, int DC, typename T>
__global__ void __launch_bounds__(kMmaThreads) dkdv_mma_kernel(const Args a) {
    using S = MmaSmem<DB>;
    constexpr int LD = S::LD, NQ = S::C;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sK = reinterpret_cast<T*>(smem_raw);
    T* sV = sK + S::R * LD;
    T* sQ = sV + S::R * LD;
    T* sDO = sQ + NQ * LD;
    float* sLse = reinterpret_cast<float*>(sDO + NQ * LD);
    float* sDelta = sLse + S::R;

    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
    const int k0 = blockIdx.y * S::R;
    const int G = a.H / a.KV;
    const int dk = (a.d + 15) / 16, dpad = 16 * dk;

    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    load_tile16<DB, S::R>(sK, K, a.k_ss, k0, a.Sk, a.d, dpad, a.vec_k, tid);
    load_tile16<DB, S::R>(sV, V, a.v_ss, k0, a.Sk, a.d, dpad, a.vec_v, tid);

    const int q_lo = a.causal ? k0 : 0;
    const int q_hi = a.window > 0 ? min(a.Sq, k0 + S::R - 1 + a.window)
                                  : a.Sq;
    const int kw = k0 + 16 * w;               // this warp's first key
    const int c0 = blockIdx.z * DC;           // this block's output columns
    float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

    for (int hg = 0; hg < G; ++hg) {
        const int h = kvh * G + hg;
        const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
        const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb +
                      h * a.do_sh;
        const long long row0 = ((long long)b * a.H + h) * a.Sq;
        for (int q0 = (q_lo / NQ) * NQ; q0 < q_hi; q0 += NQ) {
            __syncthreads();            // the previous tile's reads are done
            load_tile16<DB, NQ>(sQ, Q, a.q_ss, q0, a.Sq, a.d, dpad, a.vec_q,
                                tid);
            load_tile16<DB, NQ>(sDO, dO, a.do_ss, q0, a.Sq, a.d, dpad,
                                a.vec_do, tid);
            if (tid < NQ) {
                const int r = q0 + tid;
                sLse[tid] = r < a.Sq ? a.lse[row0 + r] * kLog2e : 0.f;
                sDelta[tid] = r < a.Sq ? a.delta[row0 + r] : 0.f;
            }
            cp_async_wait_all();
            __syncthreads();
            // a warp whose keys no query of this tile sees skips it
            const bool dead = kw >= a.Sk ||
                (a.causal && kw > q0 + NQ - 1) ||
                (a.window > 0 && kw + 15 <= q0 - a.window);
            if (dead) continue;
            // s^T and dP^T: keys (rows g, g + 8) x queries 8 j + 2 t4 + e
            float s[NQ / 8][4], dp[NQ / 8][4];
            mma_abt<DB, NQ / 8>(s, sK, sQ, w, dk, lane);
            mma_abt<DB, NQ / 8>(dp, sV, sDO, w, dk, lane);
#pragma unroll
            for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qc = 8 * j + 2 * t4 + (e & 1);
                    const int kp = kw + g + 8 * (e / 2);
                    float p = 0.f;
                    if (live(a, q0 + qc, kp))
                        p = exp2f(fmaf(s[j][e], a.scale * kLog2e,
                                       -sLse[qc]));
                    s[j][e] = p;
                    dp[j][e] = p * (dp[j][e] - sDelta[qc]);
                }
            // dV += P^T dO, dK += dS^T Q over the tile's queries
            mma_xb<DB, DC, NQ / 16>(dv_acc, s, sDO, c0, dk, lane);
            mma_xb<DB, DC, NQ / 16>(dk_acc, dp, sQ, c0, dk, lane);
        }
    }
    T* dK = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
    T* dV = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
    store_rows<DC>(dK, a.dk_ss, kw, a.Sk, c0, a.d, a.scale, dk_acc, lane);
    store_rows<DC>(dV, a.dv_ss, kw, a.Sk, c0, a.d, 1.f, dv_acc, lane);
}

// dQ: one block per (b, head, 64 queries, DC output columns); warp w owns
// queries 16 w ..; loops over the 32-key tiles its rows see
template <int DB, int DC, typename T>
__global__ void __launch_bounds__(kMmaThreads) dq_mma_kernel(const Args a) {
    using S = MmaSmem<DB>;
    constexpr int LD = S::LD, NK = S::C;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sDO = sQ + S::R * LD;
    T* sK = sDO + S::R * LD;
    T* sV = sK + NK * LD;
    float* sLse = reinterpret_cast<float*>(sV + NK * LD);
    float* sDelta = sLse + S::R;

    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int kvh = h / (a.H / a.KV);
    const int q0 = blockIdx.y * S::R;
    const int dk = (a.d + 15) / 16, dpad = 16 * dk;

    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    load_tile16<DB, S::R>(sQ, Q, a.q_ss, q0, a.Sq, a.d, dpad, a.vec_q, tid);
    load_tile16<DB, S::R>(sDO, dO, a.do_ss, q0, a.Sq, a.d, dpad, a.vec_do,
                          tid);
    if (tid < S::R) {
        const int r = q0 + tid;
        sLse[tid] = r < a.Sq ? a.lse[row0 + r] * kLog2e : 0.f;
        sDelta[tid] = r < a.Sq ? a.delta[row0 + r] : 0.f;
    }
    cp_async_wait_all();

    const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.Sk, q0 + S::R) : a.Sk;
    const int qw = q0 + 16 * w;               // this warp's first query
    const int c0 = blockIdx.z * DC;           // this block's output columns
    float dq_acc[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
        dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

    for (int k0 = (k_lo / NK) * NK; k0 < k_hi; k0 += NK) {
        __syncthreads();                // the previous tile's reads are done
        load_tile16<DB, NK>(sK, K, a.k_ss, k0, a.Sk, a.d, dpad, a.vec_k, tid);
        load_tile16<DB, NK>(sV, V, a.v_ss, k0, a.Sk, a.d, dpad, a.vec_v, tid);
        cp_async_wait_all();
        __syncthreads();
        const bool dead = qw >= a.Sq || (a.causal && k0 > qw + 15) ||
            (a.window > 0 && k0 + NK - 1 <= qw - a.window);
        if (dead) continue;
        // s and dP: queries (rows g, g + 8) x keys 8 j + 2 t4 + e
        float s[NK / 8][4], dp[NK / 8][4];
        mma_abt<DB, NK / 8>(s, sQ, sK, w, dk, lane);
        mma_abt<DB, NK / 8>(dp, sDO, sV, w, dk, lane);
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = 16 * w + g + 8 * (e / 2);
                const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
                float ds = 0.f;
                if (live(a, q0 + r, kp)) {
                    const float p = exp2f(fmaf(s[j][e], a.scale * kLog2e,
                                               -sLse[r]));
                    ds = p * (dp[j][e] - sDelta[r]);
                }
                dp[j][e] = ds;
            }
        // dQ += dS K over the tile's keys
        mma_xb<DB, DC, NK / 16>(dq_acc, dp, sK, c0, dk, lane);
    }
    T* dQ = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    store_rows<DC>(dQ, a.dq_ss, qw, a.Sq, c0, a.d, a.scale, dq_acc, lane);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// the tensor-core kernels: 16-bit inputs; output columns in chunks of at
// most 128
template <int DB, typename T>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
    constexpr size_t bytes = MmaSmem<DB>::kBytes;
    constexpr int R = MmaSmem<DB>::R;
    constexpr int DC = DB < 128 ? DB : 128;
    const unsigned nz = (unsigned)((a.d + DC - 1) / DC);
    const long long rows = (long long)a.B * a.H * a.Sq;
    const long long nq = (a.Sq + R - 1) / R, nk = (a.Sk + R - 1) / R;
    const long long bkv = (long long)a.B * a.KV, bh = (long long)a.B * a.H;
    if (nq > 65535 || nk > 65535 || bh > 0x7fffffffLL ||
        rows / (kThreads / 32) + 1 > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    cudaError_t err = opt_in(dkdv_mma_kernel<DB, DC, T>, bytes);
    if (err == cudaSuccess) err = opt_in(dq_mma_kernel<DB, DC, T>, bytes);
    if (err != cudaSuccess) return err;
    if (rows > 0)
        delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) /
                                     (kThreads / 32)),
                          kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nk > 0)         // with Sq == 0 this writes zeros
        dkdv_mma_kernel<DB, DC, T><<<dim3((unsigned)bkv, (unsigned)nk, nz),
                                     kMmaThreads, bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nq > 0)         // with Sk == 0 this writes zeros
        dq_mma_kernel<DB, DC, T><<<dim3((unsigned)bh, (unsigned)nq, nz),
                                   kMmaThreads, bytes, stream>>>(a);
    return cudaGetLastError();
}

template <int DB, typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    constexpr size_t bytes = Smem<DB>::kBytes;
    const long long rows = (long long)a.B * a.H * a.Sq;
    const long long nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BK - 1) / BK;
    const long long bkv = (long long)a.B * a.KV, bh = (long long)a.B * a.H;
    if (nq > 65535 || nk > 65535 || bh > 0x7fffffffLL ||
        rows / (kThreads / 32) + 1 > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    // the attribute is per kernel and per device: set it on every call
    // (cheap), so a second card is covered too
    cudaError_t err = opt_in(dkdv_kernel<DB, T>, bytes);
    if (err == cudaSuccess) err = opt_in(dq_kernel<DB, T>, bytes);
    if (err != cudaSuccess) return err;
    if (rows > 0)
        delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) /
                                     (kThreads / 32)),
                          kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nk > 0)         // with Sq == 0 this writes zeros
        dkdv_kernel<DB, T><<<dim3((unsigned)bkv, (unsigned)nk), kThreads,
                             bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nq > 0)         // with Sk == 0 this writes zeros
        dq_kernel<DB, T><<<dim3((unsigned)bh, (unsigned)nq), kThreads, bytes,
                           stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
    if (a.d <= 32) return launch<32, T>(a, stream);
    if (a.d <= 64) return launch<64, T>(a, stream);
    if (a.d <= 128) return launch<128, T>(a, stream);
    return launch<256, T>(a, stream);
}

// 16-bit inputs on the tensor cores
template <typename T>
cudaError_t dispatch16(const Args& a, cudaStream_t stream) {
    if (a.d <= 32) return launch_mma<32, T>(a, stream);
    if (a.d <= 64) return launch_mma<64, T>(a, stream);
    if (a.d <= 128) return launch_mma<128, T>(a, stream);
    return launch_mma<256, T>(a, stream);
}

int aligned16(const void* p, int size, long long s0, long long s1,
              long long s2) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (s0 * size) % 16 == 0 && (s1 * size) % 16 == 0 &&
           (s2 * size) % 16 == 0;
}

}  // namespace

// q, o, do, dq: (B, H, Sq, d); k, v, dk, dv: (B, KV, Sk, d); each given by
// its base pointer and element strides of batch, head and row (the last
// axis is unit-stride).  lse: the forward's (B, H, Sq) float32 row
// log-sum-exp; delta: (B, H, Sq) float32 scratch (receives D).  dtype: 0 =
// float32, 1 = bfloat16, 2 = float16, the same for q, k, v, o, do, dq, dk,
// dv; d in 1..256.  causal: top-left; window: 0, or the sliding window in
// keys (causal only).  Writes every row of dq, dk and dv.  Launches three
// kernels on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int batch, int H, int KV, int Sq, int Sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int causal, int window, void* stream) {
    if (batch < 0 || H < 1 || KV < 1 || H % KV != 0 || Sq < 0 || Sk < 0 ||
        d < 1 || d > 256 || dtype < 0 || dtype > 2 || window < 0 ||
        (window > 0 && !causal)) {
        return cudaErrorInvalidValue;
    }
    if (batch == 0 || (Sq == 0 && Sk == 0)) return cudaSuccess;
    const int size = dtype == 0 ? 4 : 2;
    const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
                 dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                 batch, H, KV, Sq, Sk, d, scale, causal, window,
                 aligned16(q, size, q_sb, q_sh, q_ss),
                 aligned16(k, size, k_sb, k_sh, k_ss),
                 aligned16(v, size, v_sb, v_sh, v_ss),
                 aligned16(dout, size, do_sb, do_sh, do_ss)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(a, st);
    if (dtype == 1) return dispatch16<__nv_bfloat16>(a, st);
    return dispatch16<__half>(a, st);
}
