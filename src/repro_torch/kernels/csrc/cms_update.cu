// Count-min sketch batch update (paper section 3) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/cms.py:cms_update_pallas (body
// _cms_kernel): tokens (N,) int32 or int64 and an optional (N,) weight
// (int32, or uint8 / bool read as 0..255) -> a (depth, width) int32 table
// where row d counts, for every token x, its weight at column
// uhash(x, d) % width.  uhash is the multiply-xorshift hash of _uhash_u32
// over the id's low 32 bits with the primes PRIMES[d % 10] and
// PRIMES[(d + 3) % 10], in uint32 arithmetic, so a bucket here is the
// bucket of the JAX package.  Counts are int32 and exact (the Pallas f32
// accumulator stops being exact at 2**24): integer adds commute, so the
// result does not depend on the order of the atomics.
//
// Bound: memory.  The update must read N tokens (4 or 8 bytes each), N
// weights (1 or 4 bytes) and write depth*width*4; at 3.35 TB/s that is
// the floor.  The TPU kernel scatters each token block with a one-hot
// (1, BN) x (BN, W) matmul per hash row on its MXU; on Hopper that spends
// BN*W multiply-adds on zeros per row, so here a (token, row) costs one
// integer atomic, and the atomics, not the bytes, set the time.  Weights
// and int64 ids are read as they are (no conversion pass).  A memset of
// the table and one launch.  Two regimes by the table's size T:
//
// - T*4 <= 227 KB (the stream-stats sketch, 4 x 2048): every CTA counts
//   into its own shared table and flushes its non-zero entries with global
//   atomics.  The grid is sized to the work: a CTA gets at least T / 2 and
//   at least 2048 tokens (so clearing and flushing its table stays below
//   counting), and at most 4 CTAs run per SM.  Here shared-atomic issue
//   sets the time on Zipf and uniform ids alike: a hot set (below) costs a
//   lookup per token and saves no warp instruction, since a warp's cold
//   lanes still issue every row's atomic; and reducing the tables of a
//   cluster of 8 through distributed shared memory before the flush costs
//   more (cluster scheduling, two cluster barriers) than the global flush
//   atomics it saves.  Both are timed by kernel_variants.py.
// - Larger: atomics straight to the global table (L2), where same-address
//   atomics serialise across the whole card: the Zipf corpus's top id is
//   ~20% of the tokens, its top 128 ids ~72%.  A token's buckets depend
//   only on the token, so each CTA counts its hot ids once per token in a
//   private shared counter and adds each counter to the id's depth buckets
//   once, at its end; cold tokens keep one global atomic per row.  The hot
//   set is the CTA's own: it counts a sample of its first tokens (an
//   eighth of its share, 256 to 4096, warp-aggregated with
//   __match_any_sync) in a shared hash table and takes the ids of the
//   highest power-of-two count buckets that hold at most 128 ids together.
//   Uniform ids must not pay for this, and the table's L2 atomics already
//   bound them: a stream whose first 512 sampled ids hardly repeat (under
//   an eighth are repeats) stops sampling there with an empty set, and a
//   set that carries under a quarter of the sample is left empty too.  (A
//   table split over a cluster's shared memory, 8 x 164 KB, is 5% faster
//   on the Zipf corpus at 5 x 65536 and 12% slower on uniform ids, timed
//   by kernel_variants.py, so it is not built.)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                // tokens a thread loads at once
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr int kHotMax = 128;              // hot ids per CTA at most
constexpr int kHotBits = 9;               // 512 hot-id hash slots (> 2 x kHotMax)
constexpr int kHotSlots = 1 << kHotBits;
constexpr int kHotWords = 2 * kHotSlots + 2 * kHotMax;
constexpr int kSampleMin = 256;           // tokens a CTA samples: an eighth
constexpr int kSampleMax = 4096;          // of its share, within these
constexpr int kSampleMaxBits = 13;        // 8192 sample hash slots at most
constexpr int kSampleFirst = 512;         // the first, which decide whether to go on
constexpr int kProbes = 32;
constexpr long long kMinTokensPerCta = 2048;
constexpr int kGridDiv = 2;               // a CTA gets >= T / kGridDiv tokens
constexpr int kCtasPerSm = 4;             // shared-table CTAs per SM at most
constexpr int kGlobalCtasPerSm = 2;
// the global regime's shared memory: the hot set and the largest sample
constexpr long long kGlobalSmemBytes = 4LL * (kHotWords + (2 << kSampleMaxBits));
constexpr uint32_t kEmpty = 0xffffffffu;  // never sampled: always a cold id
constexpr unsigned kFull = 0xffffffffu;

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

// Fibonacci hashing: the top `bits` bits of x * 2^32 / phi.
__device__ __forceinline__ unsigned fib_hash(uint32_t x, int bits) {
    return (x * 2654435761u) >> (32 - bits);
}

// the id's low 32 bits (int64 -> uint32 is modulo 2^32)
template <typename Tok>
__device__ __forceinline__ uint32_t token_at(const void* tokens, long long i) {
    return static_cast<uint32_t>(static_cast<const Tok*>(tokens)[i]);
}

// WK: 0 no weights (every token counts 1), 1 int32, 2 uint8 (or bool)
template <int WK>
__device__ __forceinline__ int32_t weight_at(const void* weights, long long i) {
    if constexpr (WK == 0) {
        return 1;
    } else if constexpr (WK == 1) {
        return static_cast<const int32_t*>(weights)[i];
    } else {
        return static_cast<const uint8_t*>(weights)[i];
    }
}

struct Params {
    const void* tokens;
    const void* weights;
    int32_t* out;
    long long n;
    long long share;      // tokens per CTA (the last may have fewer)
    int depth;
    int width;
    int table;            // depth * width
    int sample_bits;      // log2 of the sample hash table's slots
};

// The global regime's shared memory (int32 words): the hot set's hash
// (kHotSlots ids, then their indices), its ids and counters (kHotMax each),
// then the sample's hash table (ids, then counts).
struct HotSet {
    uint32_t* key;
    int32_t* slot;
    uint32_t* ids;
    int32_t* cnt;
    int32_t* sample;
};

__device__ __forceinline__ HotSet carve(int32_t* smem) {
    return {reinterpret_cast<uint32_t*>(smem), smem + kHotSlots,
            reinterpret_cast<uint32_t*>(smem + 2 * kHotSlots),
            smem + 2 * kHotSlots + kHotMax, smem + kHotWords};
}

// The hot-set index of id x, or -1 (the hash is at most 25% full).
__device__ __forceinline__ int hot_lookup(const HotSet& hs, uint32_t x) {
    for (unsigned q = fib_hash(x, kHotBits);; ++q) {
        const unsigned s = q & (kHotSlots - 1);
        const uint32_t k = hs.key[s];
        if (k == x) return hs.slot[s];   // an empty slot's index is -1
        if (k == kEmpty) return -1;
    }
}

// Counts the tokens at begin + [from, to) into the sample's hash table:
// whole warps walk the sample, so the lanes that drew the same id add it
// with one atomic (a Zipf sample is a fifth the top id).  Adds the tokens
// counted to *sampled and the ids new to the table to *distinct.
template <typename Tok, int WK>
__device__ void count_sample(const void* tokens, const void* weights,
                             long long begin, int from, int to,
                             int sample_bits, uint32_t* keys,
                             int32_t* counts, int* sampled, int* distinct) {
    const int lane = threadIdx.x & 31;
    const int slots = 1 << sample_bits;
    int mine = 0, fresh = 0;
    for (int i = from + (int)threadIdx.x - lane; i < to; i += kThreads) {
        const int at = i + lane;
        uint32_t x = kEmpty;
        if (at < to) {
            const long long j = begin + at;
            if (weight_at<WK>(weights, j) != 0) x = token_at<Tok>(tokens, j);
        }
        const unsigned peers = __match_any_sync(kFull, x);
        if (x == kEmpty || lane != __ffs(peers) - 1) continue;
        const int drawn = __popc(peers);
        mine += drawn;
        const unsigned h = fib_hash(x, sample_bits);
        for (int q = 0; q < kProbes; ++q) {   // a full run drops the sample
            const unsigned s = (h + q) & (slots - 1);
            uint32_t k = keys[s];
            if (k == kEmpty) {
                k = atomicCAS(&keys[s], kEmpty, x);
                fresh += k == kEmpty;
            }
            if (k == kEmpty || k == x) {
                atomicAdd(&counts[s], drawn);
                break;
            }
        }
    }
    if (mine) atomicAdd(sampled, mine);
    if (fresh) atomicAdd(distinct, fresh);
}

// Picks the hot set from the `samples` tokens at begin into hs (ids,
// zeroed counters, hash) and returns its size.  Ends with the block
// synchronised.
template <typename Tok, int WK>
__device__ int pick_hot(const void* tokens, const void* weights,
                        long long begin, int samples, int sample_bits,
                        const HotSet& hs) {
    __shared__ int hist[32];
    __shared__ int sampled, distinct, hot_tokens, chosen, threshold;
    const int tid = threadIdx.x;
    const int slots = 1 << sample_bits;
    uint32_t* keys = reinterpret_cast<uint32_t*>(hs.sample);
    int32_t* counts = hs.sample + slots;
    for (int i = tid; i < slots; i += kThreads) {
        keys[i] = kEmpty;
        counts[i] = 0;
    }
    for (int i = tid; i < kHotSlots; i += kThreads) {
        hs.key[i] = kEmpty;
        hs.slot[i] = -1;
    }
    if (tid < 32) hist[tid] = 0;
    if (tid == 0) {
        sampled = 0;
        distinct = 0;
        hot_tokens = 0;
        chosen = 0;
    }
    __syncthreads();
    const int first = samples < kSampleFirst ? samples : kSampleFirst;
    count_sample<Tok, WK>(tokens, weights, begin, 0, first, sample_bits, keys,
                          counts, &sampled, &distinct);
    __syncthreads();
    const int first_sampled = sampled, repeats = sampled - distinct;
    __syncthreads();   // read by all before the second stage adds to them
    // ids that hardly repeat in the first tokens (a uniform stream): no hot
    // set, and no more sampling
    if (8 * repeats < first_sampled) return 0;
    count_sample<Tok, WK>(tokens, weights, begin, first, samples, sample_bits,
                          keys, counts, &sampled, &distinct);
    __syncthreads();
    // sampled ids seen twice or more, by power-of-two count bucket
    for (int s = tid; s < slots; s += kThreads) {
        const int c = counts[s];
        if (c >= 2) atomicAdd(&hist[31 - __clz(c)], 1);
    }
    __syncthreads();
    if (tid == 0) {   // the highest buckets that hold <= kHotMax ids
        int taken = 0, t = INT_MAX;
        for (int b = 30; b >= 1; --b) {
            if (taken + hist[b] > kHotMax) break;
            taken += hist[b];
            if (hist[b]) t = 1 << b;
        }
        threshold = t;
    }
    __syncthreads();
    const int t = threshold;
    int mine = 0;
    for (int s = tid; s < slots; s += kThreads) {
        const int c = counts[s];
        if (c < t) continue;
        const int k = atomicAdd(&chosen, 1);
        const uint32_t x = keys[s];
        hs.ids[k] = x;
        hs.cnt[k] = 0;
        mine += c;
        for (unsigned q = fib_hash(x, kHotBits);; ++q) {
            const unsigned slot = q & (kHotSlots - 1);
            if (atomicCAS(&hs.key[slot], kEmpty, x) == kEmpty) {
                hs.slot[slot] = k;
                break;
            }
        }
    }
    if (mine) atomicAdd(&hot_tokens, mine);
    __syncthreads();
    // a set that carries under a quarter of the sample costs a lookup per
    // token and saves little: leave it empty
    return 4 * hot_tokens >= sampled ? chosen : 0;
}

// SHARED: T*4 <= 227 KB, each CTA counts into its own shared table;
// else the global table, with the CTA's hot ids counted once per token.
template <typename Tok, int WK, bool SHARED>
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const Params p) {
    extern __shared__ int32_t smem[];
    const HotSet hs = carve(smem);
    int32_t* table = SHARED ? smem : p.out;
    const int tid = threadIdx.x;
    const long long begin = (long long)blockIdx.x * p.share;
    const long long end = begin + p.share < p.n ? begin + p.share : p.n;
    int hot_n = 0;
    if constexpr (SHARED) {
        for (int i = tid; i < p.table; i += kThreads) table[i] = 0;
        __syncthreads();
    }
    if constexpr (!SHARED) {
        const long long len = end > begin ? end - begin : 0;
        long long want = len / 8;
        want = want < kSampleMin ? kSampleMin
                                 : (want > kSampleMax ? kSampleMax : want);
        const int samples = (int)(want < len ? want : len);
        hot_n = pick_hot<Tok, WK>(p.tokens, p.weights, begin, samples,
                                  p.sample_bits, hs);
    }

    const uint32_t width = static_cast<uint32_t>(p.width);
    for (long long base = begin; base < end; base += (long long)kThreads * kUnroll) {
        uint32_t x[kUnroll];
        int32_t w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long i = base + u * kThreads + tid;
            w[u] = i < end ? weight_at<WK>(p.weights, i) : 0;
            x[u] = i < end ? token_at<Tok>(p.tokens, i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int slot = hot_n > 0 && w[u] != 0 ? hot_lookup(hs, x[u]) : -1;
            // a hot id: one shared add per token
            if (slot >= 0) atomicAdd(&hs.cnt[slot], w[u]);
            // a cold id: one atomic per hash row
            if (slot < 0 && w[u] != 0) {
                for (int d = 0; d < p.depth; ++d) {
                    atomicAdd(table + d * p.width + (int)(uhash(x[u], d) % width),
                              w[u]);
                }
            }
        }
    }
    __syncthreads();
    // each hot id's count into its depth buckets (no hot set: shared table)
    for (int j = tid; j < hot_n * p.depth; j += kThreads) {
        const int k = j / p.depth, d = j - k * p.depth;
        const int32_t c = hs.cnt[k];
        if (c != 0) {
            atomicAdd(table + d * p.width + (int)(uhash(hs.ids[k], d) % width), c);
        }
    }
    if constexpr (SHARED) {
        __syncthreads();
        for (int i = tid; i < p.table; i += kThreads) {
            const int32_t v = table[i];
            if (v != 0) atomicAdd(p.out + i, v);
        }
    }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// log2 of the sample hash table's slots for a CTA share: >= 2 x samples
int sample_bits_for(long long share) {
    long long s = share / 8;
    s = s < kSampleMin ? kSampleMin : (s > kSampleMax ? kSampleMax : s);
    int bits = 6;
    while ((1LL << bits) < 2 * s) ++bits;
    return bits;
}

template <typename Tok, int WK, bool SHARED>
cudaError_t launch(Params p, int sm_count, cudaStream_t st) {
    const auto kernel = cms_update_kernel<Tok, WK, SHARED>;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    static bool opted[64] = {};   // the shared-memory opt-in, per device
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!opted[device]) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(SHARED ? kMaxSmemBytes : kGlobalSmemBytes));
        if (err != cudaSuccess) return err;
        opted[device] = true;
    }
    long long blocks;
    if (SHARED) {
        long long per_cta = p.table / kGridDiv;
        if (per_cta < kMinTokensPerCta) per_cta = kMinTokensPerCta;
        blocks = ceil_div(p.n, per_cta);
        if (blocks > (long long)sm_count * kCtasPerSm) {
            blocks = (long long)sm_count * kCtasPerSm;
        }
    } else {
        blocks = ceil_div(p.n, kMinTokensPerCta);
        if (blocks > (long long)sm_count * kGlobalCtasPerSm) {
            blocks = (long long)sm_count * kGlobalCtasPerSm;
        }
    }
    p.share = ceil_div(p.n, blocks);
    p.sample_bits = sample_bits_for(p.share);
    const size_t smem = SHARED ? 4 * (size_t)p.table
                               : 4 * (size_t)(kHotWords + (2 << p.sample_bits));
    kernel<<<(unsigned)blocks, kThreads, smem, st>>>(p);
    return cudaGetLastError();
}

template <typename Tok, int WK>
cudaError_t launch_regime(const Params& p, int sm_count, cudaStream_t st) {
    if ((long long)p.table * 4 <= kMaxSmemBytes) {
        return launch<Tok, WK, true>(p, sm_count, st);
    }
    return launch<Tok, WK, false>(p, sm_count, st);
}

template <typename Tok>
cudaError_t launch_weights(const Params& p, int weight_kind, int sm_count,
                           cudaStream_t st) {
    if (weight_kind == 0) return launch_regime<Tok, 0>(p, sm_count, st);
    if (weight_kind == 1) return launch_regime<Tok, 1>(p, sm_count, st);
    return launch_regime<Tok, 2>(p, sm_count, st);
}

}  // namespace

// tokens: (n,) int32 (token_bytes 4) or int64 (8); weights: (n,) int32
// (weight_kind 1), uint8 or bool (2), or null (0: every token counts 1);
// out: (depth, width) int32.  Zeroes `out` and counts the batch into it on
// `stream` (a memset and one kernel launch); returns the CUDA error (0 on
// success).
extern "C" int cms_update_launch(const void* tokens, int token_bytes,
                                 const void* weights, int weight_kind,
                                 void* out, long long n, int depth, int width,
                                 int sm_count, void* stream) {
    if (n < 0 || depth < 1 || width < 1 || sm_count < 1 ||
        (token_bytes != 4 && token_bytes != 8) || weight_kind < 0 ||
        weight_kind > 2 || (weights == nullptr) != (weight_kind == 0) ||
        (long long)depth * width > INT_MAX) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(int32_t) * depth * width, st);
    if (err != cudaSuccess || n == 0) return err;
    Params p = {};
    p.tokens = tokens;
    p.weights = weights;
    p.out = static_cast<int32_t*>(out);
    p.n = n;
    p.depth = depth;
    p.width = width;
    p.table = depth * width;
    return token_bytes == 4
        ? launch_weights<int32_t>(p, weight_kind, sm_count, st)
        : launch_weights<long long>(p, weight_kind, sm_count, st);
}
