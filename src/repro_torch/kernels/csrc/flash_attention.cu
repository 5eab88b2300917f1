// Flash attention forward for Hopper, sm_90a, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel): q (B, H, Sq, d), k (B, KV, Sk, d) and
// v (B, KV, Sk, dv) with H % KV == 0 -> o (B, H, Sq, dv) in q's dtype, the
// attn_state (m, l, o) online-softmax fold over KV tiles.  The Pallas kernel
// has dv == d; MLA (DeepSeek-V2) attends with q / k at d = 192 (128 nope +
// 64 rope) and v at dv = 128, which the reference runs in XLA einsums
// (src/repro/models/attention.py:502-524), so here dv may differ from d
// (1..256 each) and the scale stays the caller's, 1 / sqrt(d).  Its
// contract, kept here:
//   * q, k, v are cast up to f32; scores s = (q . k) * scale and the softmax
//     weights p stay in f32; o accumulates in f32;
//   * the causal mask is top-left, k_pos <= q_pos (not the bottom-right
//     tril(k=Sk-Sq) of the plain softmax reference; they agree at Sq == Sk);
//     with a per-row query offset (q_off, (B,) int32, the warm prefill of
//     the radix prefix cache) query i of batch b sits at q_off[b] + i and
//     keeps keys k_pos <= q_off[b] + i: the keys of its cached prefix and
//     of its suffix so far;
//   * a sliding window (window >= 1, causal only; the reference's
//     _causal_mask, src/repro/models/attention.py:124-130) also drops the
//     keys k_pos <= qp - window of the query at position qp, so each query
//     keeps qp - window < k_pos <= qp;
//   * the m_safe / alpha guards keep a row with no live key at o = 0;
//   * the output is o / max(l, 1e-30), rounded once to q's dtype;
//   * on request (a non-null lse) each row's log-sum-exp m + log(l), the
//     normaliser the backward reads (the Pallas kernel has no backward).
// Unlike the Pallas kernel it takes ragged Sq and Sk (it masks the edge of
// both axes itself), q, k, v all float32, all bfloat16 or all float16, any
// head dim 1..256 (and any v head dim 1..256), and any batch / head / row
// strides with a unit-stride last axis, so the model passes its (B, S, H, d)
// projections without a copy.
//
// Bound.  At the serving path's prefill shape (B 4, S 64, 16 / 8 heads of
// 128, bf16) the work is 3 MB against ~68 MFLOP: bytes bound it, and in
// practice the launch and the per-block latency.  At long S (4096) it is
// ~69 GFLOP against 50 MB: the tensor cores' rate bounds it.
//
// Design.
//   * Products on the tensor cores: mma.sync m16n8k16 with f32 accumulation
//     (bf16 or f16 operands), fragments read from shared memory by ldmatrix
//     (.trans for V).  One warp owns 16 query rows; its (m, l, o) stay in
//     registers, and its score accumulators become the A operand of p . v
//     without a trip through shared memory.
//   * Precision, the f32 contract where it matters.  A bf16 x bf16 (or
//     f16 x f16) product is exact in f32, so q . k for 16-bit inputs is one
//     mma.  p is f32 and is never rounded to one 16-bit value: it is split
//     p = p_hi + p_lo (p_hi = round(p), p_lo = round(p - p_hi)) and p . v is
//     p_hi . v + p_lo . v, two mmas (the residual is ~2^-17 of p for bf16,
//     2^-22 for f16 above its subnormals).  f32 inputs are split the same
//     way into bf16 halves and each product is the three terms a_hi b_hi +
//     a_hi b_lo + a_lo b_hi (the dropped a_lo b_lo and the halves' residuals
//     are ~2^-17 of the product).
//   * K / V tiles of 32 keys are brought in by cp.async, three in flight
//     (two for f32 and at 256 columns, to fit shared memory): the next
//     tiles load while this one is multiplied.  f32 tiles (16 keys) land raw
//     and are split into bf16 hi / lo tiles in shared memory.  Rows are
//     padded by 16 bytes so ldmatrix's 8 row addresses fall in distinct
//     banks.  Head dims are zero-padded in shared memory up to a multiple of
//     16 (the mma k-depth; zero columns add nothing to q . k, and o's
//     columns past dv are never stored); k-steps past that are skipped, so
//     one tile shape per head-dim bucket (32, 64, 128, 256 columns) serves
//     every d.  q . k runs over d's bucket (DB), V's tiles, the o
//     accumulators and p . v over dv's (DVB).  Instantiated are the equal
//     pairs (DB == DVB, one bucket for max(d, dv)) and MLA's (256, 128): at
//     d 192 / dv 128 it keeps 64 o accumulators a thread, not 128, and V
//     tiles half as wide.  Up to 128 columns a warp keeps its q fragments
//     in registers for the whole KV loop.
//   * A block is 4 warps, 64 query rows of one (batch, head).  The grid's
//     fast axis is (batch, head), the slow one the query tile, heaviest
//     causal tiles first.  At the prefill's 4 x 64 bucket that is 64 blocks
//     on 132 SMs; 16-row blocks (256 of them, one warp each) were measured
//     slower there (PERF.md), as each block's load-compute-store chain, not
//     the SM count, sets the time.
//   * Causal: the block stops at the tile holding its last query, and each
//     warp skips the 16-key slices wholly above its own diagonal; the mask
//     is applied only on tiles that cross the diagonal or the Sk edge.  A
//     query offset shifts the diagonal by q_off[b] keys, so a warm prefill
//     reads its row's prefix and suffix keys straight from the per-layer
//     cache (the (B, max_seq, KV, d) cache viewed through its strides) and
//     skips the tiles past its last query, as the top-left path does.  The
//     KV head is h / (H / KV), read by index: no repeated KV.
//   * Sliding window: the lower edge mirrors the upper one.  A block starts
//     its tile loop at the tile of its first live key, max(0, off + q0 -
//     window + 1) / BK, so KV tiles wholly below the window are never
//     loaded; each warp skips the 16-key slices wholly below its own first
//     live key, and the mask tests the lower edge on the tiles that cross
//     it.  Without a window (0) the loop starts at tile 0: the path above.
//   * Unaligned inputs (a base or stride that is no multiple of 16 bytes)
//     and the last partial 16-byte chunk of a row (d * size no multiple of
//     16) take element-wise loads instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;     // a block: 4 warps of 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_sh, q_ss;   // element strides: batch, head, row
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    int H, KV, Sq, Sk, d, dv;     // dv: v's and o's head dim
    float scale_log2;             // scale * log2(e): p = exp2(s2 - m2)
    int causal;
    const int* q_off;             // (B,) query offsets, or null (all 0)
    int window;                   // sliding window in keys, or 0 (none)
    int vec_q, vec_k, vec_v, vec_o;   // 16-byte aligned bases and strides
    float* lse;                   // (B, H, Sq) row log-sum-exp, or null
};

// -- element types ----------------------------------------------------------

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
    return __float2half_rn(x);
}

// The mma operand type of each input type: float inputs are split into
// bf16 halves.
template <typename T> struct MmaOf { using type = T; };
template <> struct MmaOf<float> { using type = __nv_bfloat16; };

// two f32 values -> one 32-bit register of two 16-bit values (x low)
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

// -- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// 2^x on the SFU (max error 2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
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
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// -- tile geometry ----------------------------------------------------------

// DB: the head-dim bucket of q and k (32, 64, 128 or 256 columns); DVB: the
// bucket of v and o (DVB <= DB); T: the input type
template <int DB, int DVB, typename T>
struct Tile {
    using M = typename MmaOf<T>::type;
    static constexpr bool kSplit = sizeof(T) == 4;
    // keys per KV tile and tiles in flight: f32 tiles land raw before their
    // split, so they are shorter and fewer, to keep two blocks on an SM
    static constexpr int BK = kSplit ? 16 : 32;
    static constexpr int STAGES = kSplit || DB >= 256 ? 2 : 3;
    static constexpr int LD = DB + 8;                     // M row, padded
    static constexpr int LDV = DVB + 8;                   // M row of V
    static constexpr int RAW_LD = DB + 16 / (int)sizeof(T);   // T row
    static constexpr int RAW_LDV = DVB + 16 / (int)sizeof(T); // T row of V
    static constexpr int NT = BK / 8;                     // n-tiles of keys
    static constexpr int KSTEPS = DB / 16;                // of q . k
    static constexpr int NW = kThreads / 32;              // warps per block
    static constexpr int BQ = 16 * NW;                    // query rows
    static constexpr size_t kRaw = (size_t)BK * RAW_LD * sizeof(T);
    static constexpr size_t kRawV = (size_t)BK * RAW_LDV * sizeof(T);
    static constexpr size_t kConv = (size_t)BK * LD * sizeof(M);
    static constexpr size_t kConvV = (size_t)BK * LDV * sizeof(M);
    // [raw K x STAGES][raw V x STAGES][K hi, K lo, V hi, V lo (split)]
    // [Q hi (, Q lo)]
    static constexpr size_t kSmem = STAGES * (kRaw + kRawV) +
        (kSplit ? 2 * (kConv + kConvV) : 0) +
        (size_t)(kSplit ? 2 : 1) * BQ * LD * sizeof(M);
};

// The loaders below walk a tile's 16-byte column chunks (CPR to a row) with
// a compile-time trip count: chunk i = tid + kThreads * n sits at row
// i / CPR, column (i % CPR) * CE.

// Copy rows [r0, r0 + ROWS) of one (batch, head) slice, columns [0, dpad),
// into shared memory (row stride lds elements): cp.async 16-byte chunks
// where the source is aligned and in range, zeros past n_valid rows and past
// column d, element-wise loads elsewhere.
template <int DB, int ROWS, typename T>
__device__ __forceinline__ void load_tile_async(
        T* s, int lds, const T* g, long long ss, int r0, int n_valid, int d,
        int dpad, bool vec, int tid) {
    constexpr int CE = 16 / sizeof(T);
    constexpr int CPR = DB / CE;
    constexpr int N = (ROWS * CPR + kThreads - 1) / kThreads;
#pragma unroll 1            // unrolled, its addresses cost ~40 registers
    for (int n = 0; n < N; ++n) {
        const int i = tid + kThreads * n;
        const int r = i / CPR, c = (i % CPR) * CE, gr = r0 + r;
        if (i >= ROWS * CPR || c >= dpad) continue;
        T* dst = s + r * lds + c;
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

// four f32 values -> their bf16 hi and lo halves at hi[0..3], lo[0..3]
__device__ __forceinline__ void split4(float4 x, __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
    uint2 h, l;
    split2<__nv_bfloat16>(x.x, x.y, h.x, l.x);
    split2<__nv_bfloat16>(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi) = h;
    *reinterpret_cast<uint2*>(lo) = l;
}

// f32 tile of ROWS rows (row stride raw_ld) -> bf16 hi and lo tiles (row
// stride ld), columns [0, dpad)
template <int DB, int ROWS>
__device__ __forceinline__ void split_tile(
        const float* raw, int raw_ld, __nv_bfloat16* hi, __nv_bfloat16* lo,
        int ld, int dpad, int tid) {
    constexpr int CPR = DB / 4;
    constexpr int N = (ROWS * CPR + kThreads - 1) / kThreads;
#pragma unroll
    for (int n = 0; n < N; ++n) {
        const int i = tid + kThreads * n;
        const int r = i / CPR, c = (i % CPR) * 4;
        if (i >= ROWS * CPR || c >= dpad) continue;
        split4(*reinterpret_cast<const float4*>(raw + r * raw_ld + c),
               hi + r * ld + c, lo + r * ld + c);
    }
}

// f32 Q rows [q0, q0 + ROWS), columns [0, dpad) -> bf16 hi and lo tiles
template <int DB, int ROWS>
__device__ __forceinline__ void load_q_split(
        __nv_bfloat16* hi, __nv_bfloat16* lo, int ld, const float* g,
        long long ss, int q0, int Sq, int d, int dpad, bool vec, int tid) {
    constexpr int CPR = DB / 4;
    constexpr int N = (ROWS * CPR + kThreads - 1) / kThreads;
#pragma unroll
    for (int n = 0; n < N; ++n) {
        const int i = tid + kThreads * n;
        const int r = i / CPR, c = (i % CPR) * 4, gr = q0 + r;
        if (i >= ROWS * CPR || c >= dpad) continue;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < Sq && vec && c + 4 <= d) {
            x = *reinterpret_cast<const float4*>(g + gr * ss + c);
        } else if (gr < Sq) {
            float* xe = &x.x;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (c + e < d) xe[e] = g[gr * ss + c + e];
        }
        split4(x, hi + r * ld + c, lo + r * ld + c);
    }
}

// two adjacent output columns c, c + 1 of one row
__device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

template <int DB, int DVB, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
    using C = Tile<DB, DVB, T>;
    using M = typename C::M;
    constexpr int BK = C::BK, NT = C::NT, LD = C::LD, RAW_LD = C::RAW_LD;
    constexpr int LDV = C::LDV, RAW_LDV = C::RAW_LDV;
    constexpr int STAGES = C::STAGES, BQ = C::BQ;
    constexpr bool kSplit = C::kSplit;
    M* const tag = nullptr;                 // selects mma16816's operand type
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;       // mma fragment coordinates

    T* rawK = reinterpret_cast<T*>(smem);                // STAGES tiles
    T* rawV = rawK + STAGES * BK * RAW_LD;               // STAGES tiles
    M* conv = reinterpret_cast<M*>(rawV + STAGES * BK * RAW_LDV);
    M* sKhi = conv;                                      // split only
    M* sKlo = sKhi + BK * LD;
    M* sVhi = sKlo + BK * LD;
    M* sVlo = sVhi + BK * LDV;
    M* sQ = kSplit ? sVlo + BK * LDV : conv;
    M* sQlo = sQ + BQ * LD;                              // split only

    const int bh = blockIdx.x;
    const int b = bh / a.H, h = bh % a.H;
    const int kvh = h / (a.H / a.KV);
    const int qtile = gridDim.y - 1 - blockIdx.y;        // heaviest first
    const int q0 = qtile * BQ;

    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

    const int dk = (a.d + 15) / 16;              // live k-steps of q . k
    const int dpad = 16 * dk;
    const int dvk = (a.dv + 15) / 16;            // live column steps of p . v
    const int dvpad = 16 * dvk;
    // query row r sits at position off + r (off = 0: the top-left mask)
    const int off = a.q_off != nullptr ? a.q_off[b] : 0;
    const int q_last = min(q0 + BQ, a.Sq) - 1;
    const int k_end = a.causal ? min(a.Sk, off + q_last + 1) : a.Sk;
    const int n_tiles = (k_end + BK - 1) / BK;
    // the block's first live key under the window: its tiles start there
    const int t0 = a.window > 0 ? max(0, off + q0 - a.window + 1) / BK : 0;

    auto load_kv = [&](int tile, int stage) {
        const int k0 = tile * BK;
        load_tile_async<DB, BK>(rawK + stage * BK * RAW_LD, RAW_LD, K, a.k_ss,
                                k0, a.Sk, a.d, dpad, a.vec_k, tid);
        load_tile_async<DVB, BK>(rawV + stage * BK * RAW_LDV, RAW_LDV, V,
                                 a.v_ss, k0, a.Sk, a.dv, dvpad, a.vec_v, tid);
    };
    // the pipeline's first STAGES - 1 tiles (a group is committed for
    // every tile index, empty past the last, so the waits count alike)
    if (n_tiles > t0) {             // else no key: o stays 0
        if constexpr (kSplit)
            load_q_split<DB, BQ>(sQ, sQlo, LD, Q, a.q_ss, q0, a.Sq, a.d, dpad,
                                 a.vec_q, tid);
        else                        // in the first tile's cp.async group
            load_tile_async<DB, BQ>(sQ, LD, Q, a.q_ss, q0, a.Sq, a.d, dpad,
                                    a.vec_q, tid);
#pragma unroll
        for (int st = 0; st < STAGES - 1; ++st) {
            if (t0 + st < n_tiles) load_kv(t0 + st, st);
            cp_async_commit();
        }
    }

    // this warp's rows and the keys it can see
    const int w0 = q0 + 16 * warp;
    const int kv_end_w = a.causal ? min(a.Sk, off + w0 + 16) : a.Sk;
    // its first live key (the window of its first row); 0 without a window
    const int kv_start_w = a.window > 0 ? max(0, off + w0 - a.window + 1) : 0;
    const int r_lo = w0 + g, r_hi = w0 + g + 8;
    const int p_lo = off + r_lo, p_hi = off + r_hi;   // their positions

    float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8; log2 domain
    float l[2] = {0.f, 0.f};               // this thread's partials
    float o[DVB / 8][4];
#pragma unroll
    for (int j = 0; j < DVB / 8; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    // ldmatrix lane offsets: A (q) and the trans B (v) address rows
    // lane % 16 at column 8 * (lane / 16); the B of q . k (k) addresses rows
    // (lane % 8) + 8 * (lane / 16) at column 8 * ((lane / 8) % 2)
    const int a_row = lane % 16, a_col = 8 * (lane / 16);
    const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
    const M* qrow = sQ + (16 * warp + a_row) * LD + a_col;
    const M* qrow_lo = sQlo + (16 * warp + a_row) * LD + a_col;

    // up to 128 columns the warp's q fragments stay in registers for the
    // whole KV loop; at 256 they are read from shared memory per tile
    constexpr bool kQReg = DB <= 128;
    constexpr int QF = kQReg ? C::KSTEPS : 1;
    uint32_t qf[QF][4], qf_lo[kSplit ? QF : 1][4];

    for (int t = t0; t < n_tiles; ++t) {
        const int stage = (t - t0) % STAGES;
        if (t + STAGES - 1 < n_tiles)
            load_kv(t + STAGES - 1, (t - t0 + STAGES - 1) % STAGES);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();        // tile t has landed
        __syncthreads();
        if (kQReg && t == t0) {
#pragma unroll
            for (int kk = 0; kk < QF; ++kk)
                if (kk < dk) {
                    ldsm_x4(qf[kk], qrow + 16 * kk);
                    if constexpr (kSplit) ldsm_x4(qf_lo[kk], qrow_lo + 16 * kk);
                }
        }
        const M* tK;
        const M* tV;
        const M* tKlo = sKlo;
        const M* tVlo = sVlo;
        if constexpr (kSplit) {
            split_tile<DB, BK>(
                reinterpret_cast<const float*>(rawK) + stage * BK * RAW_LD,
                RAW_LD, reinterpret_cast<__nv_bfloat16*>(sKhi),
                reinterpret_cast<__nv_bfloat16*>(sKlo), LD, dpad, tid);
            split_tile<DVB, BK>(
                reinterpret_cast<const float*>(rawV) + stage * BK * RAW_LDV,
                RAW_LDV, reinterpret_cast<__nv_bfloat16*>(sVhi),
                reinterpret_cast<__nv_bfloat16*>(sVlo), LDV, dvpad, tid);
            __syncthreads();
            tK = sKhi;
            tV = sVhi;
        } else {
            tK = reinterpret_cast<const M*>(rawK) + stage * BK * RAW_LD;
            tV = reinterpret_cast<const M*>(rawV) + stage * BK * RAW_LDV;
        }

        const int k0 = t * BK;
        // else every key is above this warp, or below its window
        if (k0 < kv_end_w && k0 + BK > kv_start_w) {
            // s = q k^T over this tile's keys: n-tile j holds keys
            // k0 + 8 j + 2 t4 + {0, 1} of rows g (s[j][0..1]), g + 8 ([2..3])
            float s[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
                s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < C::KSTEPS; ++kk) {
                if (kk < dk) {
                    uint32_t qs[4], qs_lo[4];
                    const uint32_t* qa = qs;
                    const uint32_t* qal = qs_lo;
                    if constexpr (kQReg) {
                        qa = qf[kk];
                        qal = qf_lo[kSplit ? kk : 0];
                    } else {
                        ldsm_x4(qs, qrow + 16 * kk);
                        if constexpr (kSplit) ldsm_x4(qs_lo, qrow_lo + 16 * kk);
                    }
#pragma unroll
                    for (int jp = 0; jp < NT / 2; ++jp) {
                        if (k0 + 16 * jp < kv_end_w &&
                            k0 + 16 * jp + 16 > kv_start_w) {
                            uint32_t kb[4];
                            const int off =
                                (16 * jp + k_row) * LD + 16 * kk + k_col;
                            ldsm_x4(kb, tK + off);
                            mma16816(s[2 * jp], qa, kb[0], kb[1], tag);
                            mma16816(s[2 * jp + 1], qa, kb[2], kb[3], tag);
                            if constexpr (kSplit) {
                                uint32_t kl[4];
                                ldsm_x4(kl, tKlo + off);
                                mma16816(s[2 * jp], qa, kl[0], kl[1], tag);
                                mma16816(s[2 * jp + 1], qa, kl[2], kl[3],
                                         tag);
                                mma16816(s[2 * jp], qal, kb[0], kb[1],
                                         tag);
                                mma16816(s[2 * jp + 1], qal, kb[2], kb[3],
                                         tag);
                            }
                        }
                    }
                }
            }

            // fold this tile into (m, l, o): the attn_state monoid with the
            // Pallas kernel's -inf guards.  m is kept in the log2 domain,
            // m = max(s) * scale * log2(e), and p = exp2(s * scale * log2(e)
            // - m_safe) = exp(s * scale - m_safe / log2(e)); a masked score
            // is -inf and its p is 2^-inf = 0
            // the lower edge: the tile's first key lies at or below the
            // last row's window, off + w0 + 15 - window
            const bool need_mask =
                k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > off + w0) ||
                (a.window > 0 && k0 < off + w0 + 16 - a.window);
            float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (need_mask) {
                        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
                        const int qp = e < 2 ? p_lo : p_hi;
                        if (kp >= a.Sk || (a.causal && kp > qp) ||
                            (a.window > 0 && kp <= qp - a.window))
                            s[j][e] = -INFINITY;
                    }
                    mb[e / 2] = fmaxf(mb[e / 2], s[j][e]);
                }
            float m_safe[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mb[i] = fmaxf(mb[i], __shfl_xor_sync(kFull, mb[i], 1));
                mb[i] = fmaxf(mb[i], __shfl_xor_sync(kFull, mb[i], 2));
                const float m_new = fmaxf(m[i], mb[i] * a.scale_log2);
                m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
                const float alpha =
                    m[i] == -INFINITY ? 0.f : ex2(m[i] - m_safe[i]);
                l[i] *= alpha;
#pragma unroll
                for (int j = 0; j < DVB / 8; ++j) {
                    o[j][2 * i] *= alpha;
                    o[j][2 * i + 1] *= alpha;
                }
                m[i] = m_new;
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p =
                        ex2(fmaf(s[j][e], a.scale_log2, -m_safe[e / 2]));
                    s[j][e] = p;
                    l[e / 2] += p;
                }

            // o += p v: the score accumulators of n-tiles 2 kk, 2 kk + 1 are
            // the A fragment of keys [16 kk, 16 kk + 16); p = p_hi + p_lo
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                if (k0 + 16 * kk < kv_end_w &&
                    k0 + 16 * kk + 16 > kv_start_w) {
                    uint32_t ph[4], pl[4];
                    split2<M>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
                    split2<M>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
                    split2<M>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
                    split2<M>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
                    for (int dp = 0; dp < DVB / 16; ++dp) {
                        if (dp < dvk) {
                            uint32_t vb[4];
                            const int off =
                                (16 * kk + a_row) * LDV + 16 * dp + a_col;
                            ldsm_x4_trans(vb, tV + off);
                            mma16816(o[2 * dp], ph, vb[0], vb[1], tag);
                            mma16816(o[2 * dp + 1], ph, vb[2], vb[3], tag);
                            mma16816(o[2 * dp], pl, vb[0], vb[1], tag);
                            mma16816(o[2 * dp + 1], pl, vb[2], vb[3], tag);
                            if constexpr (kSplit) {
                                uint32_t vl[4];
                                ldsm_x4_trans(vl, tVlo + off);
                                mma16816(o[2 * dp], ph, vl[0], vl[1], tag);
                                mma16816(o[2 * dp + 1], ph, vl[2], vl[3],
                                         tag);
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();            // this stage is free for a later load
    }

    // extract: o / max(l, 1e-30), l summed over the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(kFull, lt, 1);
        lt += __shfl_xor_sync(kFull, lt, 2);
        const float den = fmaxf(lt, 1e-30f);
        const int qr = i == 0 ? r_lo : r_hi;
        if (qr >= a.Sq) continue;
        // the backward's softmax normaliser: lse = m + log(l) in the
        // natural-log domain (m is kept in log2); -inf for a row with no key
        if (a.lse != nullptr && t4 == 0)
            a.lse[(long long)bh * a.Sq + qr] =
                lt > 0.f ? m[i] * kLn2 + logf(lt) : -INFINITY;
        T* orow = O + qr * a.o_ss;
#pragma unroll
        for (int j = 0; j < DVB / 8; ++j) {
            const int c = 8 * j + 2 * t4;
            const float x = o[j][2 * i] / den, y = o[j][2 * i + 1] / den;
            if (a.vec_o && c + 1 < a.dv) {
                store2(orow + c, x, y);
            } else {
                if (c < a.dv) orow[c] = from_f32<T>(x);
                if (c + 1 < a.dv) orow[c + 1] = from_f32<T>(y);
            }
        }
    }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <int DB, int DVB, typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
    using C = Tile<DB, DVB, T>;
    auto kernel = flash_attention_kernel<DB, DVB, T>;
    const long long bh = (long long)batch * a.H;
    const long long qtiles = cdiv(a.Sq, C::BQ);
    if (bh > 0x7fffffffLL || qtiles > 65535) return cudaErrorInvalidValue;
    static bool opted_in[64] = {false};   // per device: above 48 KB
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return cudaErrorInvalidDevice;
    if (C::kSmem > 48 * 1024 && !opted_in[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)C::kSmem);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    kernel<<<dim3((unsigned)bh, (unsigned)qtiles), kThreads, C::kSmem,
             stream>>>(a);
    return cudaGetLastError();
}

// the (DB, DVB) pairs the models use: one bucket for max(d, dv), and MLA's
// (256, 128) when only d needs 256 columns
template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
    const int w = a.d > a.dv ? a.d : a.dv;
    if (w <= 32) return launch<32, 32, T>(a, batch, stream);
    if (w <= 64) return launch<64, 64, T>(a, batch, stream);
    if (w <= 128) return launch<128, 128, T>(a, batch, stream);
    if (a.dv <= 128) return launch<256, 128, T>(a, batch, stream);
    return launch<256, 256, T>(a, batch, stream);
}

int aligned16(const void* p, int size, long long s0, long long s1,
              long long s2) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
           (s0 * size) % 16 == 0 && (s1 * size) % 16 == 0 &&
           (s2 * size) % 16 == 0;
}

}  // namespace

// q: (B, H, Sq, d), k: (B, KV, Sk, d), v: (B, KV, Sk, dv), o: (B, H, Sq,
// dv), each given by its base pointer and element strides of batch, head and
// row (the last axis is unit-stride).  dtype: 0 = float32, 1 = bfloat16, 2 =
// float16, the same for all four; d and dv in 1..256; scale is the caller's
// (the reference's 1 / sqrt(d)).  q_offset: null, or (B,) int32 query
// offsets on the device (causal only: query i of batch b keeps the keys at
// positions <= q_offset[b] + i).  window: 0, or the sliding window in keys
// (causal only: the query at position qp also drops the keys <= qp -
// window).  lse: null, or a (B, H, Sq) contiguous float32 output that
// receives each query row's log-sum-exp of its scaled scores, m + log(l)
// (-inf for a row with no key), which the backward
// (flash_attention_bwd.cu) reads instead of recomputing m and l; null
// writes nothing.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int H, int KV, int Sq, int Sk, int d, int dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, const void* q_offset, int window, void* lse,
    void* stream) {
    if (batch < 0 || H < 1 || KV < 1 || H % KV != 0 || Sq < 0 || Sk < 0 ||
        d < 1 || d > 256 || dv < 1 || dv > 256 || dtype < 0 || dtype > 2 ||
        (q_offset != nullptr && !causal) || window < 0 ||
        (window > 0 && !causal)) {
        return cudaErrorInvalidValue;
    }
    if (batch == 0 || Sq == 0) return cudaSuccess;
    const int size = dtype == 0 ? 4 : 2;
    const Args a{q, k, v, o,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 H, KV, Sq, Sk, d, dv, scale * kLog2e, causal,
                 static_cast<const int*>(q_offset), window,
                 aligned16(q, size, q_sb, q_sh, q_ss),
                 aligned16(k, size, k_sb, k_sh, k_ss),
                 aligned16(v, size, v_sb, v_sh, v_ss),
                 aligned16(o, size, o_sb, o_sh, o_ss),
                 static_cast<float*>(lse)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(a, batch, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(a, batch, st);
    return dispatch<__half>(a, batch, st);
}
