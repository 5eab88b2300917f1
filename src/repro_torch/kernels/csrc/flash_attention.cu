// Flash attention forward for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel): q (B, H, Sq, d), k and v (B, KV, Sk,
// d) with H % KV == 0 -> o (B, H, Sq, d) in q's dtype, the attn_state
// (m, l, o) online-softmax fold over KV tiles.  Its contract, kept here:
//   * q, k, v are cast up to f32; scores s = (q . k) * scale and the softmax
//     weights p stay in f32; o accumulates in f32;
//   * the causal mask is top-left, k_pos <= q_pos (not the bottom-right
//     tril(k=Sk-Sq) of the plain softmax reference; they agree at Sq == Sk);
//   * the m_safe / alpha guards keep a row with no live key at o = 0;
//   * the output is o / max(l, 1e-30), rounded once to q's dtype.
// Unlike the Pallas kernel it takes ragged Sq and Sk (it masks the edge of
// both axes itself), head dims 16..256 in multiples of 16, and any
// batch / head / row strides with a unit-stride last axis, so the model
// passes its (B, S, H, d) projections without a transpose copy.
//
// Design.  The TPU kernel walks KV blocks along a sequential grid axis and
// keeps (m, l, o) in VMEM between grid steps.  Blocks of a CUDA grid run in
// no order, so here one block owns one (batch*head, query tile) and loops
// over the KV tiles itself, with (m, l, o) in registers: 128 threads as
// 16 row groups x 8 column groups; a thread owns R query rows (R = 4, or 2
// at d > 128) and, for the scores, 4 keys of the 32-key tile, for the
// output, d/8 columns as float4 chunks.  Q, the K tile and the V tile are
// converted to f32 in shared memory (rows padded by 4 floats so the 4 or 8
// rows a warp reads at once fall in distinct banks); the p tile goes through
// shared memory between the two products.  Row max and row sum are reduced
// across the 8 threads of a row with warp shuffles; each thread keeps a
// partial l, summed once at the end.  The KV head is h / (H / KV), read by
// index as the Pallas kv_index does: no repeated KV is materialised.  A KV
// tile wholly above the causal diagonal is the fold's identity and is not
// visited, and the heaviest causal query tiles are scheduled first.
//
// Bound.  At the serving path's shape (B 4, S 64, 16 / 8 heads of 128, bf16)
// the work is 3 MB of q, k, v and o against ~68 MFLOP: bytes bound it, and
// the launch dominates.  At long S (4096) it is ~69 GFLOP against 50 MB:
// operations bound it, at the tensor cores' rate for bf16.  This kernel is
// the simple one: its products run as f32 FMAs on the CUDA cores (exact for
// bf16 inputs, and the only way to keep f32 inputs at f32), register-tiled
// so each shared-memory float4 feeds 8-16 FMAs.  wgmma / mma.sync products
// and TMA loads are left to a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = 16;
constexpr int kColGroups = 8;
constexpr int kBK = 32;                         // keys per KV tile
constexpr int kKeysPerThread = kBK / kColGroups;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_sh, q_ss;   // element strides: batch, head, row
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    int H, KV, Sq, Sk, d;
    float scale;
    int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);                   // round to nearest even
}

// tile geometry for a head-dim bucket DB (a power of two, 32..256)
template <int DB>
struct Tile {
    static constexpr int R = DB == 256 ? 2 : 4;       // query rows / thread
    static constexpr int BQ = kRowGroups * R;         // query rows / block
    static constexpr int QS = DB + 4;                 // padded Q, K row
    static constexpr int VS = DB;
    static constexpr int PS = kBK + 8;                // padded p row
    static constexpr int CPT = DB / kColGroups;       // output cols / thread
    static constexpr size_t kSmem =
        sizeof(float) * (size_t)(BQ * QS + kBK * QS + kBK * VS + BQ * PS);
};

template <int DB, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
    using C = Tile<DB>;
    constexpr int R = C::R;
    constexpr int CPT = C::CPT;
    extern __shared__ __align__(16) float smem[];
    float* sQ = smem;
    float* sK = sQ + C::BQ * C::QS;
    float* sV = sK + kBK * C::QS;
    float* sP = sV + kBK * C::VS;

    const int tid = threadIdx.x;
    const int tc = tid & (kColGroups - 1);      // the 8 lanes of a row group
    const int tr = tid / kColGroups;            // are adjacent in one warp
    const int qtile = gridDim.x - 1 - blockIdx.x;
    const int bh = blockIdx.y;
    const int b = bh / a.H;
    const int h = bh % a.H;
    const int kvh = h / (a.H / a.KV);
    const int q0 = qtile * C::BQ;

    const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
    const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
    T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

    for (int i = tid; i < C::BQ * DB; i += kThreads) {
        const int r = i / DB, c = i % DB, qr = q0 + r;
        float x = 0.f;
        if (qr < a.Sq && c < a.d) x = to_f32(Q[qr * a.q_ss + c]);
        sQ[r * C::QS + c] = x;
    }

    float m[R], l[R], acc[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }

    const int q_last = min(q0 + C::BQ, a.Sq) - 1;
    const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
    const int n_tiles = (k_end + kBK - 1) / kBK;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * kBK;
        __syncthreads();            // the last tile's readers are done
        for (int i = tid; i < kBK * DB; i += kThreads) {
            const int r = i / DB, c = i % DB, kr = k0 + r;
            float kx = 0.f, vx = 0.f;
            if (kr < a.Sk && c < a.d) {
                kx = to_f32(K[kr * a.k_ss + c]);
                vx = to_f32(V[kr * a.v_ss + c]);
            }
            sK[r * C::QS + c] = kx;
            sV[r * C::VS + c] = vx;
        }
        __syncthreads();

        // s = q k^T for rows tr + 16 i and keys tc + 8 j
        float s[R][kKeysPerThread];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < a.d; c += 4) {
            float4 qv[R], kv[kKeysPerThread];
#pragma unroll
            for (int i = 0; i < R; ++i)
                qv[i] = *reinterpret_cast<const float4*>(
                    &sQ[(tr + kRowGroups * i) * C::QS + c]);
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j)
                kv[j] = *reinterpret_cast<const float4*>(
                    &sK[(tc + kColGroups * j) * C::QS + c]);
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
                for (int j = 0; j < kKeysPerThread; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        // fold this tile's partial state into (m, l, o): the attn_state
        // monoid, with the Pallas kernel's -inf guards
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int row = tr + kRowGroups * i;
            const int qp = q0 + row;
            float mb = -INFINITY;
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j) {
                const int kp = k0 + tc + kColGroups * j;
                const bool keep = kp < a.Sk && (!a.causal || kp <= qp);
                s[i][j] = keep ? s[i][j] * a.scale : -INFINITY;
                mb = fmaxf(mb, s[i][j]);
            }
            mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 1));
            mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 2));
            mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 4));
            const float m_new = fmaxf(m[i], mb);
            const float m_safe = m_new == -INFINITY ? 0.f : m_new;
            const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < kKeysPerThread; ++j) {
                const float p = s[i][j] == -INFINITY ? 0.f
                                                     : expf(s[i][j] - m_safe);
                sP[row * C::PS + tc + kColGroups * j] = p;
                psum += p;
            }
            l[i] = l[i] * alpha + psum;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
            m[i] = m_new;
        }
        __syncthreads();

        // o += p v over the tile's keys; columns 4 tc + 32 cc + {0..3}
        const int kn = min(kBK, a.Sk - k0);
        for (int j = 0; j < kn; j += 4) {
            float4 p4[R];
#pragma unroll
            for (int i = 0; i < R; ++i)
                p4[i] = *reinterpret_cast<const float4*>(
                    &sP[(tr + kRowGroups * i) * C::PS + j]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                float pv[R];
#pragma unroll
                for (int i = 0; i < R; ++i)
                    pv[i] = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z : p4[i].w;
                const float* vrow = &sV[(j + jj) * C::VS + 4 * tc];
#pragma unroll
                for (int cc = 0; cc < CPT / 4; ++cc) {
                    const float4 vv =
                        *reinterpret_cast<const float4*>(vrow + 32 * cc);
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        acc[i][4 * cc + 0] = fmaf(pv[i], vv.x, acc[i][4 * cc + 0]);
                        acc[i][4 * cc + 1] = fmaf(pv[i], vv.y, acc[i][4 * cc + 1]);
                        acc[i][4 * cc + 2] = fmaf(pv[i], vv.z, acc[i][4 * cc + 2]);
                        acc[i][4 * cc + 3] = fmaf(pv[i], vv.w, acc[i][4 * cc + 3]);
                    }
                }
            }
        }
    }

    // extract: o / max(l, 1e-30), l summed over the row's 8 threads
#pragma unroll
    for (int i = 0; i < R; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(kFull, lt, 1);
        lt += __shfl_xor_sync(kFull, lt, 2);
        lt += __shfl_xor_sync(kFull, lt, 4);
        const float den = fmaxf(lt, 1e-30f);
        const int qr = q0 + tr + kRowGroups * i;
        if (qr >= a.Sq) continue;
        T* orow = O + qr * a.o_ss;
#pragma unroll
        for (int cc = 0; cc < CPT / 4; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * tc + 32 * cc + e;
                if (c < a.d) store(orow + c, acc[i][4 * cc + e] / den);
            }
    }
}

template <int DB, typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
    using C = Tile<DB>;
    auto kernel = flash_attention_kernel<DB, T>;
    if (C::kSmem > 48 * 1024) {           // the opt-in above 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)C::kSmem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((a.Sq + C::BQ - 1) / C::BQ, batch * a.H);
    kernel<<<grid, kThreads, C::kSmem, stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
    if (a.d <= 32) return launch<32, T>(a, batch, stream);
    if (a.d <= 64) return launch<64, T>(a, batch, stream);
    if (a.d <= 128) return launch<128, T>(a, batch, stream);
    return launch<256, T>(a, batch, stream);
}

}  // namespace

// q: (B, H, Sq, d), k and v: (B, KV, Sk, d), o: (B, H, Sq, d), each given
// by its base pointer and element strides of batch, head and row (the last
// axis is unit-stride).  dtype: 0 = float32, 1 = bfloat16, the same for all
// four.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int H, int KV, int Sq, int Sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, void* stream) {
    if (batch < 0 || H < 1 || KV < 1 || H % KV != 0 || Sq < 0 || Sk < 0 ||
        d < 16 || d > 256 || d % 16 != 0 || (dtype != 0 && dtype != 1)) {
        return cudaErrorInvalidValue;
    }
    if (batch == 0 || Sq == 0) return cudaSuccess;
    const Args a{q, k, v, o,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 H, KV, Sq, Sk, d, scale, causal};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? dispatch<float>(a, batch, st)
                      : dispatch<__nv_bfloat16>(a, batch, st);
}
