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
//   * inputs are cast up to f32; s, dP, the softmax, D and every sum are
//     f32.  For 16-bit inputs P and dS are rounded once to the inputs'
//     dtype before the products that read them (dV = P^T dO, dK = dS^T Q,
//     dQ = dS K), as the reference's training attention rounds its softmax
//     weights to the activation dtype before p . v
//     (src/repro/models/attention.py:168); f32 inputs keep P and dS in f32.
//     dq, dk, dv are rounded once to the inputs' dtype.
// With s = (q . k) * scale and lse the forward's row log-sum-exp (read, not
// recomputed):
//   D = rowsum(dO . O),  P = exp(s - lse),  dV = P^T dO,  dP = dO V^T,
//   dS = P * (dP - D),   dQ = dS K * scale, dK = dS^T Q * scale.
//
// Bound.  At qwen3-0.6b's training shape (B 8, S 1024, 16 / 8 heads of 128,
// bf16, causal) the work is ~2.5x the forward's products, ~86 GFLOP against
// ~202 MB: the tensor cores' rate bounds it.
//
// Design.  Three launches per call, no atomics, every sum in one fixed
// order (deterministic):
//   * a preprocess writes, per query row, D and lse * log2(e) into a
//     scratch padded to kRowPad rows per (batch, head), so the tile kernels
//     read whole aligned tiles of rows;
//   * the dK / dV kernel runs one block per (batch, KV head, key tile): it
//     keeps the tile's K and V and its dK and dV sums, and loops over the
//     group's H / KV query heads and, within each, over the query tiles
//     that can see the key tile, so a GQA group's sum needs no atomics;
//   * the dQ kernel runs one block per (batch, head, query tile) and loops
//     over the live key tiles.  Both recompute s and dP: 7 tile products
//     per (query, key) tile pair where a one-pass backward with atomics
//     would do 5.
// Three designs share that split; the launcher is told which one to run
// (flash_attention.py's backward_design picks it by dtype, head dim and
// strides before the launch) and refuses a design the inputs do not fit:
//   * wgmma (16-bit, d 64 / 128 / 256, 16-byte aligned bases and strides
//     of q, k, v, do, dq, dk, dv): warp-specialised kernels.  One producer
//     warp loads the block's own tiles and then the looped tiles (Q, dO and
//     the rows' lse and D; or K and V) with TMA (cp.async.bulk.tensor, 128-
//     byte swizzle, 64 x 64 boxes; out-of-range rows arrive as zeros) into
//     a ring of 2 or 3 stages, each guarded by a full and an empty
//     mbarrier.  Each consumer warpgroup owns 64 rows of the block's tile
//     and runs every product as wgmma.mma_async with f32 accumulators: s^T
//     = K Q^T and dP^T = V dO^T (or s and dP) from shared memory, then P
//     and dS, built in registers under the mask and packed to 16 bits,
//     enter dV += P^T dO and dK += dS^T Q (or dQ += dS K) as the A operand
//     from registers, with B read MN-major (transposed) from the same
//     swizzled tile.  P is computed while dP is still in flight, in
//     straight-line loops (the mask only on diagonal and edge tiles).
//     Looped tiles have 128 rows at d 64 and 64 above.  d 64 and 128 run
//     two consumer warpgroups (128 rows a block); setmaxnreg moves
//     registers from the producer to them, so the dK and dV sums (128 f32
//     a thread at d 128) stay in registers.  d 256 runs one consumer
//     warpgroup (64 rows) and splits the output columns in two halves over
//     blockIdx.z, each half recomputing s and dP over all 256 columns.
//     Under the causal mask the heaviest tiles go first: dK / dV blocks run
//     in key order (key tile 0 sees every query tile), dQ blocks in reverse
//     query order.
//   * mma_sync (16-bit, any other head dim or layout): mma.sync m16n8k16
//     kernels, 4 warps of 16 rows over a 64-row block, looped tiles of 32
//     rows by cp.async, head dims zero-padded to a multiple of 16.
//   * cuda_cores (f32): f32 FMA on the CUDA cores (the f32 contract would
//     need three bf16 products per product on the tensor cores).
// A tile whose entries the causal or window mask all drop is skipped;
// entries outside the mask, past Sq or past Sk get P = 0.

#include <cuda.h>
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
constexpr int LDP = BQ + 8;       // P / dS row stride: distinct banks
constexpr float kLog2e = 1.4426950408889634f;
// rows of the lse / D scratch per (batch, head): Sq rounded up to this
// (flash_attention.py's BWD_ROW_PAD); the padding holds zeros
constexpr int kRowPad = 128;

enum Design { kCudaCores = 0, kMmaSync = 1, kWgmma = 2 };

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const void* o;
    const void* dout;
    const float* lse;             // (B, H, Sq) contiguous: the forward's
    float* lse2;                  // (B, H, Sqp): lse * log2(e), 0 past Sq
    float* dd;                    // (B, H, Sqp): D, 0 past Sq
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
    int B, H, KV, Sq, Sk, d, Sqp;
    float scale;
    int causal;
    int window;                   // 0: none
    int vec_q, vec_k, vec_v, vec_do;   // 16-byte aligned bases and strides
    int vec_od;                   // o and do: 16-byte rows of 8 elements
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
    return qp < a.Sq && kp < a.Sk && (!a.causal || kp <= qp) &&
           (a.window == 0 || kp > qp - a.window);
}
// live() without branches, so the entries of a tile interleave
__device__ __forceinline__ bool keep(const Args& a, int qp, int kp) {
    return (qp < a.Sq) & (kp < a.Sk) & (!a.causal | (kp <= qp)) &
           ((a.window == 0) | (kp > qp - a.window));
}
// 2^x in one MUFU op (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// -- the preprocess: `lanes` lanes per padded (b, h, row) -------------------
// D = rowsum(dO . O) and lse * log2(e) of rows below Sq, zeros past them

template <typename T>
__device__ __forceinline__ float dot16(uint4 x, uint4 y) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 a = unpack(xs[i], (T*)nullptr);
        const float2 b = unpack(ys[i], (T*)nullptr);
        acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
    }
    return acc;
}

// this lane's share (lane `sub` of `lanes`) of one row's dO . O
template <typename T>
__device__ __forceinline__ float row_dot(const Args& a, const T* O,
                                         const T* dO, int sub, int lanes) {
    float acc = 0.f;
    if constexpr (sizeof(T) == 2) {
        if (a.vec_od) {           // 8 elements (16 bytes) a lane
            for (int c = 8 * sub; c < a.d; c += 8 * lanes)
                acc += dot16<T>(*reinterpret_cast<const uint4*>(O + c),
                                *reinterpret_cast<const uint4*>(dO + c));
            return acc;
        }
    }
    for (int c = sub; c < a.d; c += lanes)
        acc = fmaf(to_f32(dO[c]), to_f32(O[c]), acc);
    return acc;
}

// lanes: a power of two <= 32 (32 / lanes rows a warp)
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Args a,
                                                         int lanes) {
    const int lane = threadIdx.x % 32, sub = lane % lanes;
    const long long row = ((long long)blockIdx.x * (kThreads / 32) +
                           threadIdx.x / 32) * (32 / lanes) + lane / lanes;
    const bool valid = row < (long long)a.B * a.H * a.Sqp;
    const int i = valid ? (int)(row % a.Sqp) : 0;
    const long long bh = valid ? row / a.Sqp : 0;
    float acc = 0.f, l2 = 0.f;
    if (valid && i < a.Sq) {
        const int h = (int)(bh % a.H), b = (int)(bh / a.H);
        const T* O = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh +
                     i * a.o_ss;
        const T* dO = static_cast<const T*>(a.dout) + b * a.do_sb +
                      h * a.do_sh + i * a.do_ss;
        acc = row_dot(a, O, dO, sub, lanes);
        l2 = a.lse[bh * a.Sq + i] * kLog2e;
    }
    for (int s = lanes / 2; s > 0; s /= 2)   // every lane takes part
        acc += __shfl_xor_sync(kFull, acc, s);
    if (valid && sub == 0) {
        a.lse2[row] = l2;
        a.dd[row] = acc;
    }
}

// -- cuda_cores: f32 inputs -------------------------------------------------

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

// A query tile's Q, dO, lse * log2(e) and D, rows [q0, q0 + BQ); lse2 and
// dd point at the (batch, head)'s padded scratch rows.
template <int DB, typename T>
__device__ __forceinline__ void load_query_tile(const Args& a, float* sm,
                                                const T* Q, const T* dO,
                                                const float* lse2,
                                                const float* dd, int q0,
                                                int tid) {
    using S = Smem<DB>;
    load_tile<DB, BQ>(sm + S::kQ, Q, a.q_ss, q0, a.Sq, a.d, tid);
    load_tile<DB, BQ>(sm + S::kDO, dO, a.do_ss, q0, a.Sq, a.d, tid);
    if (tid < BQ) {
        sm[S::kLse + tid] = lse2[q0 + tid];
        sm[S::kDelta + tid] = dd[q0 + tid];
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

// dK, dV: one block per (b, kv head, 32-key tile)
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
        const long long row0 = ((long long)b * a.H + h) * a.Sqp;
        for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
            __syncthreads();            // the previous tile's reads are done
            load_query_tile<DB>(a, sm, Q, dO, a.lse2 + row0, a.dd + row0, q0,
                                tid);
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

// dQ: one block per (b, head, 32-query tile)
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
    const long long row0 = ((long long)b * a.H + h) * a.Sqp;
    load_query_tile<DB>(a, sm, Q, dO, a.lse2 + row0, a.dd + row0, q0, tid);

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

// -- mma_sync: 16-bit inputs at any head dim --------------------------------
//
// The same two-kernel split on mma.sync m16n8k16 (f32 accumulation), with
// the forward's fragment plumbing: tiles of 16-bit inputs land in shared
// memory by cp.async (rows padded by 16 bytes for ldmatrix, head dims
// zero-padded to a multiple of 16), a warp owns 16 rows of the block's
// tile, and a score accumulator becomes an A operand (P or dS, rounded to
// 16 bits) without a trip through shared memory.

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows

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
// (rows g, g + 8) rounded to 16 bits, sB rows [0, 16 NK) x the 16-column
// groups of columns [c0, c0 + DC) below 16 dk (the p . v pattern)
template <int DB, int DC, int NK, typename T>
__device__ __forceinline__ void mma_xb(float acc[DC / 8][4],
                                       float x[2 * NK][4],
                                       const T* sB, int c0, int dk,
                                       int lane) {
    constexpr int LD = DB + 8;
    const int a_row = lane % 16, a_col = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
        const uint32_t xa[4] = {
            pack(x[2 * kk][0], x[2 * kk][1], (T*)nullptr),
            pack(x[2 * kk][2], x[2 * kk][3], (T*)nullptr),
            pack(x[2 * kk + 1][0], x[2 * kk + 1][1], (T*)nullptr),
            pack(x[2 * kk + 1][2], x[2 * kk + 1][3], (T*)nullptr)};
#pragma unroll
        for (int dp = 0; dp < DC / 16; ++dp) {
            if (c0 / 16 + dp < dk) {
                uint32_t b[4];
                ldsm_x4_trans(b, sB + (16 * kk + a_row) * LD + c0 + 16 * dp +
                                     a_col);
                mma16816(acc[2 * dp], xa, b[0], b[1], (T*)nullptr);
                mma16816(acc[2 * dp + 1], xa, b[2], b[3], (T*)nullptr);
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
        const long long row0 = ((long long)b * a.H + h) * a.Sqp;
        for (int q0 = (q_lo / NQ) * NQ; q0 < q_hi; q0 += NQ) {
            __syncthreads();            // the previous tile's reads are done
            load_tile16<DB, NQ>(sQ, Q, a.q_ss, q0, a.Sq, a.d, dpad, a.vec_q,
                                tid);
            load_tile16<DB, NQ>(sDO, dO, a.do_ss, q0, a.Sq, a.d, dpad,
                                a.vec_do, tid);
            if (tid < NQ) {
                sLse[tid] = a.lse2[row0 + q0 + tid];
                sDelta[tid] = a.dd[row0 + q0 + tid];
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
    const long long row0 = ((long long)b * a.H + h) * a.Sqp;
    load_tile16<DB, S::R>(sQ, Q, a.q_ss, q0, a.Sq, a.d, dpad, a.vec_q, tid);
    load_tile16<DB, S::R>(sDO, dO, a.do_ss, q0, a.Sq, a.d, dpad, a.vec_do,
                          tid);
    if (tid < S::R) {
        sLse[tid] = a.lse2[row0 + q0 + tid];
        sDelta[tid] = a.dd[row0 + q0 + tid];
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

// -- wgmma: 16-bit inputs, d 64 / 128 / 256 (TMA ring, warp-specialised) ---

constexpr int kTileRows = 64;            // rows of a TMA box and a wgmma tile
constexpr int kPanelBytes = kTileRows * 128;   // 64 rows x 64 columns, 8 KB
constexpr int kProducerRegs = 24;        // setmaxnreg of the producer
constexpr int kConsumerRegs = 240;       // ... and of the consumer warpgroups

// The layout of both wgmma kernels at head dim D.
template <int D>
struct Hop {
    static constexpr int NWG = D == 256 ? 1 : 2;   // consumer warpgroups
    static constexpr int R = kTileRows * NWG;      // the block's own rows
    static constexpr int P = D / 64;               // 128-byte column panels
    static constexpr int DC = D < 128 ? D : 128;   // output columns a block
    // rows of a looped tile, the wgmma N of s and dP (whose accumulators
    // take BL / 2 registers a thread beside the output sums): 128 at d 64,
    // where the products per exp are fewest (one 128-row tile costs less
    // than two of 64); 64 above, where the dK and dV sums take the room
    static constexpr int BL = D == 64 ? 128 : 64;
    // + the producer: a whole warpgroup (one warp issues, three idle) when
    // setmaxnreg moves its registers to two consumer warpgroups (ptxas
    // sizes the entry count by warpgroups: 65536 / 384 = 168, and 128 x
    // (168 - 24) = 256 x (240 - 168)); one warp beside a single consumer
    // warpgroup, which starts with enough
    static constexpr int kProducers = NWG > 1 ? 128 : 32;
    static constexpr int kThreads = NWG * 128 + kProducers;
    static constexpr int kOwnBytes = R * D * 2;    // one own tile
    static constexpr int kLoopBytes = BL * D * 2;  // one looped tile
    static constexpr int kPanel = BL * 128;        // a looped tile's panel
    // [own A][own B][ST x (looped A, looped B)][ST x lse2, D][barriers],
    // every tile 1024-byte aligned (the swizzle's period); three ring
    // stages where they fit in 227 KB, else two
    static constexpr int kStage = 2 * kLoopBytes + 2 * BL * 4;
    static constexpr int ST =
        2 * kOwnBytes + 3 * kStage + 2048 <= 227 * 1024 ? 3 : 2;
    static constexpr int kRing = 2 * kOwnBytes;
    static constexpr int kVec = kRing + ST * 2 * kLoopBytes;
    static constexpr int kBar = kVec + ST * 2 * BL * 4;
    static constexpr size_t kBytes = kBar + (2 * ST + 1) * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    return ok != 0;
}
// Wait for the phase of parity `parity` to complete.  (A bounded wait
// that traps costs the consumers their setmaxnreg budget: ptxas then
// spills the dK / dV sums.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    while (!mbar_try_wait(addr, parity)) {
    }
}

// a 64 x 64 box at (col, row, head, batch) of a 4-d tensor map into shared
// memory, completing on bar
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int head, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head), "r"(batch)
        : "memory");
}
// `bytes` contiguous bytes (16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pin registers that an asynchronous wgmma reads or writes in program
// order against the fence / wait around it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K][4]) {
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B)
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand at `addr` (64 rows of a tile of `rows`-row panels):
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
    return sw128(addr, 16, 1024);
}
// ... and its k-step kk (16 columns): panel kk / 4, 32 bytes a step inside
// the 128-byte row, added to the descriptor's address field
__host__ __device__ constexpr uint64_t kstep(int rows, int kk) {
    return (uint64_t)(((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4);
}
// MN-major (transposed) B operand of a looped tile at `addr` (columns
// c0 ..): K = rows, 8-row groups 1024 bytes apart; N = columns, 64-column
// panels `panel` bytes apart.  k-step kk (rows 16 kk ..) adds mnstep(kk).
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t panel) {
    return sw128(addr, panel, 1024);
}
__host__ __device__ constexpr uint64_t mnstep(int kk) {
    return (uint64_t)((kk * 16 * 128) >> 4);
}
// a value the compiler may not hoist out of the loop it is made in (a
// descriptor held across the loop would pin registers the sums need)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

// d[0..32) += A (64 x 16, shared) . B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc,
                                             __nv_bfloat16*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc, __half*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}

// d[0..32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, __nv_bfloat16*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, __half*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, __nv_bfloat16*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, __half*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A (64 x 16, shared) . B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc,
                                              __nv_bfloat16*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc,
                                              __half*) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc, (T*)nullptr);
    else wgmma_ss_n128(d, da, db, acc, (T*)nullptr);
}
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
    if constexpr (N == 64) wgmma_rs_n64(d, a, db, (T*)nullptr);
    else wgmma_rs_n128(d, a, db, (T*)nullptr);
}

// x (a 64 x N C fragment, 16-bit after rounding) as the A operand of N / 16
// k-steps of 16: step kk takes n8 blocks 2 kk and 2 kk + 1
template <int N, typename T>
__device__ __forceinline__ void to_a(const float (&x)[N / 2],
                                     uint32_t (&xa)[N / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            xa[kk][r] = pack(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1],
                             (T*)nullptr);
}

// rows (g, g + 8) of a warp's 16 rows of a 64 x N accumulator (times mul),
// as 16-bit pairs, into global rows r0 + g, r0 + g + 8 below n_valid and
// columns c0 .. c0 + N
template <int N, typename T>
__device__ __forceinline__ void store_frag(T* G, long long ss, int r0,
                                           int n_valid, int c0, float mul,
                                           const float (&acc)[N / 2],
                                           int lane) {
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i;
        if (r >= n_valid) continue;
        T* row = G + r * ss + c0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
            *reinterpret_cast<uint32_t*>(row + 8 * j) =
                pack(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul,
                     (T*)nullptr);
    }
}

// dK, dV: one block per (b, kv head, R keys, DC output columns); consumer
// warpgroup wg owns keys 64 wg ..; the producer warp streams the group's
// heads' query tiles (BL rows) that see the block's keys.
template <int D, typename T>
__global__ void __launch_bounds__(Hop<D>::kThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Args a) {
    using H = Hop<D>;
    constexpr int BL = H::BL;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* sm = smem_raw + (base - raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + H::kBar);
    uint64_t* empty = full + H::ST;
    uint64_t* own = empty + H::ST;
    const float* vec = reinterpret_cast<const float*>(sm + H::kVec);

    const int tid = threadIdx.x;
    const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV;
    const int k0 = blockIdx.y * H::R;
    const int c0 = blockIdx.z * H::DC;
    const int G = a.H / a.KV;
    // the query tiles that can see keys [k0, k0 + R), per head
    const int q_lo = a.causal ? k0 : 0;
    const int q_hi = a.window > 0 ? min(a.Sq, k0 + H::R - 1 + a.window)
                                  : a.Sq;
    const int t_lo = q_lo / BL;
    const int nt = q_hi > q_lo ? (q_hi + BL - 1) / BL - t_lo : 0;
    const int n_iter = G * nt;

    if (tid == 0) {
        for (int s = 0; s < H::ST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], H::NWG * 128);
        }
        mbar_init(own, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= H::NWG * 128) {              // the producer
        if constexpr (H::NWG > 1) setmaxnreg_dec<kProducerRegs>();
        if (tid == H::NWG * 128) {      // one thread issues every load
            mbar_expect_tx(own, 2 * H::kOwnBytes);
            for (int p = 0; p < H::P; ++p)
                for (int r = 0; r < H::R; r += kTileRows) {
                    const uint32_t at = p * H::R * 128 + r * 128;
                    tma_box(base + at, &tk, own, 64 * p, k0 + r, kvh, b);
                    tma_box(base + H::kOwnBytes + at, &tv, own, 64 * p,
                            k0 + r, kvh, b);
                }
            for (int i = 0; i < n_iter; ++i) {
                const int s = i % H::ST, u = i / H::ST;
                const int h = kvh * G + i / nt;
                const int q0 = (t_lo + i % nt) * BL;
                mbar_wait(&empty[s], (u & 1) ^ 1);
                mbar_expect_tx(&full[s], 2 * H::kLoopBytes + 2 * BL * 4);
                const uint32_t ring = base + H::kRing + s * 2 * H::kLoopBytes;
                for (int p = 0; p < H::P; ++p)
                    for (int r = 0; r < BL; r += kTileRows) {
                        const uint32_t at = p * H::kPanel + r * 128;
                        tma_box(ring + at, &tq, &full[s], 64 * p, q0 + r, h,
                                b);
                        tma_box(ring + H::kLoopBytes + at, &tdo, &full[s],
                                64 * p, q0 + r, h, b);
                    }
                const long long row = ((long long)b * a.H + h) * a.Sqp + q0;
                const uint32_t vs = base + H::kVec + s * 2 * BL * 4;
                bulk_copy(vs, a.lse2 + row, BL * 4, &full[s]);
                bulk_copy(vs + BL * 4, a.dd + row, BL * 4, &full[s]);
            }
        }
    } else {                                // the consumer warpgroups
        if constexpr (H::NWG > 1) setmaxnreg_inc<kConsumerRegs>();
        const int wg = tid / 128, ww = (tid % 128) / 32, lane = tid % 32;
        const int g = lane / 4, t4 = lane % 4;
        const int kw = k0 + kTileRows * wg;  // this warpgroup's first key
        const float sl2 = a.scale * kLog2e;
        float dk[H::DC / 2], dv[H::DC / 2];
#pragma unroll
        for (int j = 0; j < H::DC / 2; ++j) dk[j] = dv[j] = 0.f;
        mbar_wait(own, 0);
        for (int i = 0; i < n_iter; ++i) {
            const int s = i % H::ST, u = i / H::ST;
            const int q0 = (t_lo + i % nt) * BL;
            mbar_wait(&full[s], u & 1);
            const bool dead = kw >= a.Sk ||
                (a.causal && kw > q0 + BL - 1) ||
                (a.window > 0 && kw + kTileRows - 1 <= q0 - a.window);
            if (!dead) {
                const uint32_t sQ = base + H::kRing + s * 2 * H::kLoopBytes;
                const uint32_t sDO = sQ + H::kLoopBytes;
                const uint64_t dK = opaque(kmajor(base + wg * kPanelBytes));
                const uint64_t dV = dK + (H::kOwnBytes >> 4);
                const uint64_t dQ = kmajor(sQ), dDO = kmajor(sDO);
                // s^T = K Q^T and dP^T = V dO^T: keys x the tile's queries
                float st[BL / 2], dpt[BL / 2];
                pin(st);
                pin(dpt);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<BL, T>(st, dK + kstep(H::R, kk),
                                    dQ + kstep(BL, kk), kk > 0);
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<BL, T>(dpt, dV + kstep(H::R, kk),
                                    dDO + kstep(BL, kk), kk > 0);
                wgmma_commit();
                // P under the mask while dP^T is in flight: entry 4 j + e
                // is key row 16 ww + g + 8 (e / 2), query column
                // 8 j + 2 t4 + (e & 1)
                wgmma_wait<1>();
                pin(st);
                const float* L = vec + s * 2 * BL;
                const float* Dv = L + BL;
                const bool whole = q0 + BL <= a.Sq &&
                    kw + kTileRows <= a.Sk &&
                    (!a.causal || kw + kTileRows - 1 <= q0) &&
                    (a.window == 0 || kw > q0 + BL - 1 - a.window);
                // straight-line loops (a branch per entry would serialise
                // the entries' latencies): the mask only off the diagonal
                // and the edges
                if (whole) {
#pragma unroll
                    for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            st[4 * j + e] = ex2(fmaf(
                                st[4 * j + e], sl2,
                                -L[8 * j + 2 * t4 + (e & 1)]));
                } else {
#pragma unroll
                    for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int qc = 8 * j + 2 * t4 + (e & 1);
                            const int kp = kw + 16 * ww + g + 8 * (e / 2);
                            const float p = ex2(fmaf(st[4 * j + e], sl2,
                                                     -L[qc]));
                            st[4 * j + e] = keep(a, q0 + qc, kp) ? p : 0.f;
                        }
                }
                // dS = P (dP - D)
                wgmma_wait<0>();
                pin(dpt);
#pragma unroll
                for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        dpt[4 * j + e] = st[4 * j + e] *
                            (dpt[4 * j + e] - Dv[8 * j + 2 * t4 + (e & 1)]);
                uint32_t pa[BL / 16][4], da[BL / 16][4];
                to_a<BL, T>(st, pa);
                to_a<BL, T>(dpt, da);
                // dV += P^T dO, dK += dS^T Q over the tile's queries
                pin(pa);
                pin(da);
                pin(dv);
                pin(dk);
                const uint64_t bDO =
                    mnmajor(sDO + (c0 / 64) * H::kPanel, H::kPanel);
                const uint64_t bQ =
                    mnmajor(sQ + (c0 / 64) * H::kPanel, H::kPanel);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BL / 16; ++kk)
                    wgmma_rs<H::DC, T>(dv, pa[kk], bDO + mnstep(kk));
#pragma unroll
                for (int kk = 0; kk < BL / 16; ++kk)
                    wgmma_rs<H::DC, T>(dk, da[kk], bQ + mnstep(kk));
                wgmma_commit();
                wgmma_wait<0>();
                pin(dv);
                pin(dk);
                pin(pa);
                pin(da);
            }
            mbar_arrive(&empty[s]);
        }
        const int r0 = kw + 16 * ww;
        T* dK = static_cast<T*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh;
        T* dV = static_cast<T*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh;
        store_frag<H::DC>(dK, a.dk_ss, r0, a.Sk, c0, a.scale, dk, lane);
        store_frag<H::DC>(dV, a.dv_ss, r0, a.Sk, c0, 1.f, dv, lane);
    }
}

// dQ: one block per (b, head, R queries, DC output columns), heaviest query
// tiles first; consumer warpgroup wg owns queries 64 wg ..; the producer
// warp streams the key tiles (BL rows) its rows see.
template <int D, typename T>
__global__ void __launch_bounds__(Hop<D>::kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
    using H = Hop<D>;
    constexpr int BL = H::BL;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* sm = smem_raw + (base - raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + H::kBar);
    uint64_t* empty = full + H::ST;
    uint64_t* own = empty + H::ST;

    const int tid = threadIdx.x;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int kvh = h / (a.H / a.KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * H::R;
    const int c0 = blockIdx.z * H::DC;
    // the key tiles rows [q0, q0 + R) can see
    const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
    const int k_hi = a.causal ? min(a.Sk, q0 + H::R) : a.Sk;
    const int t_lo = k_lo / BL;
    const int n_iter = k_hi > k_lo ? (k_hi + BL - 1) / BL - t_lo : 0;

    if (tid == 0) {
        for (int s = 0; s < H::ST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], H::NWG * 128);
        }
        mbar_init(own, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= H::NWG * 128) {              // the producer
        if constexpr (H::NWG > 1) setmaxnreg_dec<kProducerRegs>();
        if (tid == H::NWG * 128) {      // one thread issues every load
            mbar_expect_tx(own, 2 * H::kOwnBytes);
            for (int p = 0; p < H::P; ++p)
                for (int r = 0; r < H::R; r += kTileRows) {
                    const uint32_t at = p * H::R * 128 + r * 128;
                    tma_box(base + at, &tq, own, 64 * p, q0 + r, h, b);
                    tma_box(base + H::kOwnBytes + at, &tdo, own, 64 * p,
                            q0 + r, h, b);
                }
            for (int i = 0; i < n_iter; ++i) {
                const int s = i % H::ST, u = i / H::ST;
                const int kt = (t_lo + i) * BL;
                mbar_wait(&empty[s], (u & 1) ^ 1);
                mbar_expect_tx(&full[s], 2 * H::kLoopBytes);
                const uint32_t ring = base + H::kRing + s * 2 * H::kLoopBytes;
                for (int p = 0; p < H::P; ++p)
                    for (int r = 0; r < BL; r += kTileRows) {
                        const uint32_t at = p * H::kPanel + r * 128;
                        tma_box(ring + at, &tk, &full[s], 64 * p, kt + r, kvh,
                                b);
                        tma_box(ring + H::kLoopBytes + at, &tv, &full[s],
                                64 * p, kt + r, kvh, b);
                    }
            }
        }
    } else {                                // the consumer warpgroups
        if constexpr (H::NWG > 1) setmaxnreg_inc<kConsumerRegs>();
        const int wg = tid / 128, ww = (tid % 128) / 32, lane = tid % 32;
        const int g = lane / 4, t4 = lane % 4;
        const int qw = q0 + kTileRows * wg;  // this warpgroup's first query
        const float sl2 = a.scale * kLog2e;
        // lse * log2(e) and D of this thread's rows qw + 16 ww + g (+ 8)
        const long long row = ((long long)b * a.H + h) * a.Sqp + qw +
                              16 * ww + g;
        const float L[2] = {a.lse2[row], a.lse2[row + 8]};
        const float Dv[2] = {a.dd[row], a.dd[row + 8]};
        float dq[H::DC / 2];
#pragma unroll
        for (int j = 0; j < H::DC / 2; ++j) dq[j] = 0.f;
        mbar_wait(own, 0);
        for (int i = 0; i < n_iter; ++i) {
            const int s = i % H::ST, u = i / H::ST;
            const int kt = (t_lo + i) * BL;
            mbar_wait(&full[s], u & 1);
            const bool dead = qw >= a.Sq ||
                (a.causal && kt > qw + kTileRows - 1) ||
                (a.window > 0 && kt + BL - 1 <= qw - a.window);
            if (!dead) {
                const uint32_t sK = base + H::kRing + s * 2 * H::kLoopBytes;
                const uint32_t sV = sK + H::kLoopBytes;
                const uint64_t dQ = opaque(kmajor(base + wg * kPanelBytes));
                const uint64_t dDO = dQ + (H::kOwnBytes >> 4);
                const uint64_t dK = kmajor(sK), dV = kmajor(sV);
                // s = Q K^T and dP = dO V^T: the rows x the tile's keys
                float sc[BL / 2], dp[BL / 2];
                pin(sc);
                pin(dp);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<BL, T>(sc, dQ + kstep(H::R, kk),
                                    dK + kstep(BL, kk), kk > 0);
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<BL, T>(dp, dDO + kstep(H::R, kk),
                                    dV + kstep(BL, kk), kk > 0);
                wgmma_commit();
                // P under the mask while dP is in flight: entry 4 j + e is
                // query row 16 ww + g + 8 (e / 2), key column
                // 8 j + 2 t4 + (e & 1)
                wgmma_wait<1>();
                pin(sc);
                const bool whole = qw + kTileRows <= a.Sq &&
                    kt + BL <= a.Sk &&
                    (!a.causal || kt + BL - 1 <= qw) &&
                    (a.window == 0 || kt > qw + kTileRows - 1 - a.window);
                if (whole) {
#pragma unroll
                    for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2,
                                                     -L[e / 2]));
                } else {
#pragma unroll
                    for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int kp = kt + 8 * j + 2 * t4 + (e & 1);
                            const int qp = qw + 16 * ww + g + 8 * (e / 2);
                            const float p = ex2(fmaf(sc[4 * j + e], sl2,
                                                     -L[e / 2]));
                            sc[4 * j + e] = keep(a, qp, kp) ? p : 0.f;
                        }
                }
                // dS = P (dP - D)
                wgmma_wait<0>();
                pin(dp);
#pragma unroll
                for (int j = 0; j < BL / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        dp[4 * j + e] = sc[4 * j + e] *
                                        (dp[4 * j + e] - Dv[e / 2]);
                uint32_t da[BL / 16][4];
                to_a<BL, T>(dp, da);
                // dQ += dS K over the tile's keys
                pin(da);
                pin(dq);
                const uint64_t bK =
                    mnmajor(sK + (c0 / 64) * H::kPanel, H::kPanel);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BL / 16; ++kk)
                    wgmma_rs<H::DC, T>(dq, da[kk], bK + mnstep(kk));
                wgmma_commit();
                wgmma_wait<0>();
                pin(dq);
                pin(da);
            }
            mbar_arrive(&empty[s]);
        }
        T* dQ = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
        store_frag<H::DC>(dQ, a.dq_ss, qw + 16 * ww, a.Sq, c0, a.scale, dq,
                          lane);
    }
}

// -- host -------------------------------------------------------------------

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <typename T>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
    // 16-byte rows: d / 8 lanes a row (rounded up to a power of two), so
    // a warp reads whole rows at d 64 and 128; else a warp a row
    int lanes = 32;
    if (sizeof(T) == 2 && a.vec_od)
        for (lanes = 1; lanes < 32 && 8 * lanes < a.d; lanes *= 2) {
        }
    const long long rows = (long long)a.B * a.H * a.Sqp;
    const long long per_block = (kThreads / 32) * (32 / lanes);
    if (rows > 0)
        delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                          kThreads, 0, stream>>>(a, lanes);
    return cudaGetLastError();
}

// the tensor-core kernels: 16-bit inputs; output columns in chunks of at
// most 128
template <int DB, typename T>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
    constexpr size_t bytes = MmaSmem<DB>::kBytes;
    constexpr int R = MmaSmem<DB>::R;
    constexpr int DC = DB < 128 ? DB : 128;
    const unsigned nz = (unsigned)((a.d + DC - 1) / DC);
    const long long nq = (a.Sq + R - 1) / R, nk = (a.Sk + R - 1) / R;
    const long long bkv = (long long)a.B * a.KV, bh = (long long)a.B * a.H;
    cudaError_t err = opt_in(dkdv_mma_kernel<DB, DC, T>, bytes);
    if (err == cudaSuccess) err = opt_in(dq_mma_kernel<DB, DC, T>, bytes);
    if (err == cudaSuccess) err = launch_delta<T>(a, stream);
    if (err != cudaSuccess) return err;
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
    const long long nq = (a.Sq + BQ - 1) / BQ, nk = (a.Sk + BK - 1) / BK;
    const long long bkv = (long long)a.B * a.KV, bh = (long long)a.B * a.H;
    // the attribute is per kernel and per device: set it on every call
    // (cheap), so a second card is covered too
    cudaError_t err = opt_in(dkdv_kernel<DB, T>, bytes);
    if (err == cudaSuccess) err = opt_in(dq_kernel<DB, T>, bytes);
    if (err == cudaSuccess) err = launch_delta<T>(a, stream);
    if (err != cudaSuccess) return err;
    if (nk > 0)         // with Sq == 0 this writes zeros
        dkdv_kernel<DB, T><<<dim3((unsigned)bkv, (unsigned)nk), kThreads,
                             bytes, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (nq > 0)         // with Sk == 0 this writes zeros
        dq_kernel<DB, T><<<dim3((unsigned)bh, (unsigned)nq), kThreads, bytes,
                           stream>>>(a);
    return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (no -lcuda on the link line)
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return err == cudaSuccess && q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A 4-d map (d, S, heads, B) of one 16-bit operand with 64 x 64 boxes and
// the 128-byte swizzle; a size-1 axis's stride is never stepped, so it is
// replaced by a legal one.
bool tensor_map(CUtensorMap* map, const void* ptr, int dtype, int d, int S,
                int heads, int B, long long ss, long long sh, long long sb) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    if (S == 1) ss = d;
    if (heads == 1) sh = ss * S;
    if (B == 1) sb = sh * heads;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S,
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {64, kTileRows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                  4, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A kernel that moves registers with setmaxnreg must start with enough of
// them that the producers' release covers the consumers' request (else
// setmaxnreg.inc would wait forever): checked before the first launch.
template <typename K>
bool registers_balance(K kernel, int consumers, int producers) {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return false;
    return fa.numRegs <= kConsumerRegs && fa.numRegs >= kProducerRegs &&
           producers * (fa.numRegs - kProducerRegs) >=
               consumers * (kConsumerRegs - fa.numRegs);
}

template <int D, typename T>
cudaError_t launch_wgmma(const Args& a, int dtype, cudaStream_t stream) {
    using H = Hop<D>;
    CUtensorMap maps[4];
    if (!tensor_map(&maps[0], a.q, dtype, a.d, a.Sq, a.H, a.B, a.q_ss,
                    a.q_sh, a.q_sb) ||
        !tensor_map(&maps[1], a.dout, dtype, a.d, a.Sq, a.H, a.B, a.do_ss,
                    a.do_sh, a.do_sb) ||
        !tensor_map(&maps[2], a.k, dtype, a.d, a.Sk, a.KV, a.B, a.k_ss,
                    a.k_sh, a.k_sb) ||
        !tensor_map(&maps[3], a.v, dtype, a.d, a.Sk, a.KV, a.B, a.v_ss,
                    a.v_sh, a.v_sb))
        return cudaErrorNotSupported;
    if constexpr (H::NWG > 1) {
        static const bool ok =
            registers_balance(dkdv_wgmma_kernel<D, T>, H::NWG * 128,
                              H::kProducers) &&
            registers_balance(dq_wgmma_kernel<D, T>, H::NWG * 128,
                              H::kProducers);
        if (!ok) return cudaErrorInvalidConfiguration;
    }
    const unsigned nz = D / H::DC;
    const long long nq = (a.Sq + H::R - 1) / H::R;
    const long long nk = (a.Sk + H::R - 1) / H::R;
    const long long bkv = (long long)a.B * a.KV, bh = (long long)a.B * a.H;
    cudaError_t err = opt_in(dkdv_wgmma_kernel<D, T>, H::kBytes);
    if (err == cudaSuccess) err = opt_in(dq_wgmma_kernel<D, T>, H::kBytes);
    if (err == cudaSuccess) err = launch_delta<T>(a, stream);
    if (err != cudaSuccess) return err;
    dkdv_wgmma_kernel<D, T><<<dim3((unsigned)bkv, (unsigned)nk, nz),
                              H::kThreads, H::kBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dq_wgmma_kernel<D, T><<<dim3((unsigned)bh, (unsigned)nq, nz),
                            H::kThreads, H::kBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
    if (a.d <= 32) return launch<32, T>(a, stream);
    if (a.d <= 64) return launch<64, T>(a, stream);
    if (a.d <= 128) return launch<128, T>(a, stream);
    return launch<256, T>(a, stream);
}

template <typename T>
cudaError_t dispatch16(const Args& a, int design, int dtype,
                       cudaStream_t stream) {
    if (design == kWgmma) {
        if (a.d == 64) return launch_wgmma<64, T>(a, dtype, stream);
        if (a.d == 128) return launch_wgmma<128, T>(a, dtype, stream);
        return launch_wgmma<256, T>(a, dtype, stream);
    }
    if (a.d <= 32) return launch_mma<32, T>(a, stream);
    if (a.d <= 64) return launch_mma<64, T>(a, stream);
    if (a.d <= 128) return launch_mma<128, T>(a, stream);
    return launch_mma<256, T>(a, stream);
}

bool aligned16(const void* p, int size, long long s0, long long s1,
               long long s2) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (s0 * size) % 16 == 0 && (s1 * size) % 16 == 0 &&
           (s2 * size) % 16 == 0;
}

// what the wgmma design's TMA boxes and paired stores need of one
// operand: a 16-byte aligned base and 16-byte strides on every axis of
// more than one entry (flash_attention.py's _tma_ready)
bool tma_ready(const void* p, int n0, long long s0, int n1, long long s1,
               int n2, long long s2) {
    const int ns[3] = {n0, n1, n2};
    const long long st[3] = {s0, s1, s2};
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    for (int i = 0; i < 3; ++i)
        if (ns[i] > 1 && (st[i] <= 0 || (st[i] * 2) % 16 != 0)) return false;
    return true;
}

}  // namespace

// q, o, do, dq: (B, H, Sq, d); k, v, dk, dv: (B, KV, Sk, d); each given by
// its base pointer and element strides of batch, head and row (the last
// axis is unit-stride).  lse: the forward's (B, H, Sq) float32 row
// log-sum-exp; scratch: float32 of 2 x B x H x Sqp, Sqp = Sq rounded up to
// kRowPad (receives lse * log2(e) and D).  dtype: 0 = float32, 1 =
// bfloat16, 2 = float16, the same for q, k, v, o, do, dq, dk, dv; d in
// 1..256.  causal: top-left; window: 0, or the sliding window in keys
// (causal only).  design: 0 cuda_cores (float32), 1 mma_sync (16-bit), 2
// wgmma (16-bit, d 64 / 128 / 256, Sq and Sk >= 1, every 16-bit operand
// tma_ready); a design the inputs do not fit is refused.  Writes every row
// of dq, dk and dv.  Launches three kernels on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int dtype, int batch, int H, int KV, int Sq, int Sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int causal, int window, int design, void* stream) {
    if (batch < 0 || H < 1 || KV < 1 || H % KV != 0 || Sq < 0 || Sk < 0 ||
        d < 1 || d > 256 || dtype < 0 || dtype > 2 || window < 0 ||
        (window > 0 && !causal) || (design == kCudaCores) != (dtype == 0) ||
        design < 0 || design > 2) {
        return cudaErrorInvalidValue;
    }
    if (batch == 0 || (Sq == 0 && Sk == 0)) return cudaSuccess;
    // a window of Sq or more drops no key of a top-left causal row; as 0 it
    // also keeps k0 + rows + window (the last query a key tile sees) in int
    if (window >= Sq) window = 0;
    const int Sqp = (Sq + kRowPad - 1) / kRowPad * kRowPad;
    const long long bh = (long long)batch * H;
    if ((Sq + 31) / 32 > 65535 || (Sk + 31) / 32 > 65535 ||
        bh > 0x7fffffffLL || bh * Sqp / (kThreads / 32) + 1 > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    if (design == kWgmma &&
        (Sq < 1 || Sk < 1 || (d != 64 && d != 128 && d != 256) ||
         !tma_ready(q, batch, q_sb, H, q_sh, Sq, q_ss) ||
         !tma_ready(k, batch, k_sb, KV, k_sh, Sk, k_ss) ||
         !tma_ready(v, batch, v_sb, KV, v_sh, Sk, v_ss) ||
         !tma_ready(dout, batch, do_sb, H, do_sh, Sq, do_ss) ||
         !tma_ready(dq, batch, dq_sb, H, dq_sh, Sq, dq_ss) ||
         !tma_ready(dk, batch, dk_sb, KV, dk_sh, Sk, dk_ss) ||
         !tma_ready(dv, batch, dv_sb, KV, dv_sh, Sk, dv_ss)))
        return cudaErrorInvalidValue;
    const int size = dtype == 0 ? 4 : 2;
    float* lse2 = static_cast<float*>(scratch);
    const Args a{q, k, v, o, dout, static_cast<const float*>(lse), lse2,
                 lse2 + bh * Sqp, dq, dk, dv,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, do_sb, do_sh, do_ss,
                 dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                 batch, H, KV, Sq, Sk, d, Sqp, scale, causal, window,
                 aligned16(q, size, q_sb, q_sh, q_ss),
                 aligned16(k, size, k_sb, k_sh, k_ss),
                 aligned16(v, size, v_sb, v_sh, v_ss),
                 aligned16(dout, size, do_sb, do_sh, do_ss),
                 d % 8 == 0 && aligned16(o, size, o_sb, o_sh, o_ss) &&
                     aligned16(dout, size, do_sb, do_sh, do_ss)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(a, st);
    if (dtype == 1) return dispatch16<__nv_bfloat16>(a, design, dtype, st);
    return dispatch16<__half>(a, design, dtype, st);
}
