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
// gathered matrix) and adds each pair with one integer atomic at the upper
// cell [min(a, b), max(a, b)]; the lower triangle is mirrored from it at the
// end, which halves the atomics.  Integer atomics commute, so the counts are
// exact.
//
// - V <= ~238: the whole V*V table fits in 227 KB of shared memory next to
//   the tile.  Each CTA counts into its own table and flushes the non-zero
//   upper cells to both [a, b] and [b, a] with global atomics.  One launch.
// - Larger V: the global table, where a Zipf stream puts most pairs on a
//   few hot cells and the atomics serialise (in the chip_smoke corpus the
//   64 most frequent of 4095 ids carry 74% of the tokens).  So:
//   1. select_hot_kernel (one CTA) counts a strided sample of up to 16384
//      tokens in a shared hash table and picks the (at most 128) most
//      frequent ids in range: the hot set, picked from the data.  A set
//      that carries under a quarter of the sampled tokens (a uniform
//      stream) is left empty.
//   2. stripes_kernel gives every CTA a private H x H shared table for the
//      pairs of two hot ids, flushed with one global atomic per non-zero
//      cell; every other pair adds its own atomic to the global table.
//      (Aggregating those across the warp with __match_any_sync on the cell
//      gains ~3% on the Zipf corpus and loses ~13% on uniform ids, timed
//      by kernel_variants.py: two lanes rarely hold the same cold pair.)
//   3. mirror_kernel copies the upper triangle to the lower, 32 x 32 tiles
//      through shared memory.
//   Three launches (plus the caller's zero fill).  Which ids are hot moves
//   only the speed: a pair lands on the same cell either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 1024;              // tokens per tile, halo excluded
constexpr long long kMaxSmemBytes = 227 * 1024;
constexpr int kHotMax = 128;             // hot ids at most
constexpr int kHotBits = 9;              // 512 hot-id hash slots (> 2 x kHotMax)
constexpr int kHotSlots = 1 << kHotBits;
constexpr int kSelectThreads = 1024;
constexpr int kSample = 1 << 14;         // tokens the hot set is picked from
constexpr int kSampleBits = 13;          // 8192 sample hash slots (64 KB)
constexpr int kSampleSlots = 1 << kSampleBits;
constexpr int kProbes = 32;
constexpr unsigned kFull = 0xffffffffu;

// Fibonacci hashing: the top `bits` bits of id * 2^32 / phi.
__device__ __forceinline__ unsigned hash_id(int id, int bits) {
    return ((unsigned)id * 2654435761u) >> (32 - bits);
}

// Shared memory of stripes_kernel for a hot set of at most hot_cap ids: the
// token tile (kTile + window ids) and, with a hot set, each tile token's hot
// slot, the H x H table, the hot ids and their hash (ids, slots).
long long stripes_smem_bytes(int window, int hot_cap) {
    const long long tile = (long long)(kTile + window) * sizeof(int32_t);
    if (hot_cap == 0) return tile;
    return 2 * tile + (long long)hot_cap * hot_cap * sizeof(int32_t) +
           (long long)hot_cap * sizeof(int32_t) +
           2LL * kHotSlots * sizeof(int32_t);
}

// The hot set: hot[0] = H, hot[1..H] = the ids.  Dynamic shared memory:
// the sample's hash table, kSampleSlots ids then their counts.
__global__ void __launch_bounds__(kSelectThreads)
select_hot_kernel(const int32_t* __restrict__ tokens, long long n, int vocab,
                  int hot_cap, int32_t* __restrict__ hot) {
    extern __shared__ int32_t sample_table[];
    int32_t* keys = sample_table;
    int32_t* counts = sample_table + kSampleSlots;
    __shared__ int total;
    __shared__ int chosen;
    __shared__ int in_range;       // sampled tokens with ids in [0, V)
    __shared__ int hot_tokens;     // ... of them with a hot id
    for (int i = threadIdx.x; i < kSampleSlots; i += blockDim.x) {
        keys[i] = -1;
        counts[i] = 0;
    }
    if (threadIdx.x == 0) in_range = 0;
    __syncthreads();
    const long long samples = n < kSample ? n : kSample;
    const int lane = threadIdx.x & 31;
    int mine = 0;
    // whole warps walk the sample, so the lanes that drew the same id add
    // it with one atomic (a Zipf sample is a fifth the top id)
    for (long long i = threadIdx.x - lane; i < samples; i += blockDim.x) {
        const long long at = i + lane;
        int id = at < samples ? tokens[at * n / samples] : -1;
        if (id >= vocab) id = -1;
        const unsigned peers = __match_any_sync(kFull, id);
        if (id < 0 || lane != __ffs(peers) - 1) continue;
        const int drawn = __popc(peers);
        mine += drawn;
        const unsigned h = hash_id(id, kSampleBits);
        for (int p = 0; p < kProbes; ++p) {   // a full run drops the sample
            const unsigned slot = (h + p) & (kSampleSlots - 1);
            int k = keys[slot];
            if (k == -1) k = atomicCAS(&keys[slot], -1, id);
            if (k == -1 || k == id) {
                atomicAdd(&counts[slot], drawn);
                break;
            }
        }
    }
    if (mine) atomicAdd(&in_range, mine);
    __syncthreads();
    // the least t >= 1 with at most hot_cap sampled ids counted >= t times
    int lo = 1, hi = kSample + 1;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (threadIdx.x == 0) total = 0;
        __syncthreads();
        mine = 0;
        for (int i = threadIdx.x; i < kSampleSlots; i += blockDim.x) {
            mine += counts[i] >= mid;
        }
        if (mine) atomicAdd(&total, mine);
        __syncthreads();
        if (total <= hot_cap) hi = mid; else lo = mid + 1;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        chosen = 0;
        hot_tokens = 0;
    }
    __syncthreads();
    mine = 0;
    for (int i = threadIdx.x; i < kSampleSlots; i += blockDim.x) {
        if (counts[i] >= lo) {
            hot[1 + atomicAdd(&chosen, 1)] = keys[i];
            mine += counts[i];
        }
    }
    if (mine) atomicAdd(&hot_tokens, mine);
    __syncthreads();
    // a hot set that carries under a quarter of the tokens holds under 1/16
    // of the pairs: its lookups would cost more than it saves, so it is empty
    if (threadIdx.x == 0) hot[0] = 4 * hot_tokens >= in_range ? chosen : 0;
}

// hot == nullptr: no hot set (every pair goes to the global table).
__global__ void __launch_bounds__(kThreads)
stripes_kernel(const int32_t* __restrict__ tokens, int32_t* __restrict__ out,
               long long n, int vocab, int window,
               const int32_t* __restrict__ hot) {
    extern __shared__ int32_t smem[];
    int32_t* tile = smem;                                   // kTile + window
    int32_t* tile_slot = tile + kTile + window;             // kTile + window
    int32_t* hot_table = tile_slot + kTile + window;        // H x H
    const int h = hot != nullptr ? hot[0] : 0;
    int32_t* hot_ids = hot_table + h * h;                   // H
    int32_t* slot_key = hot_ids + h;                        // kHotSlots
    int32_t* slot_val = slot_key + kHotSlots;               // kHotSlots
    if (h > 0) {
        for (int i = threadIdx.x; i < h * h; i += blockDim.x) hot_table[i] = 0;
        for (int i = threadIdx.x; i < kHotSlots; i += blockDim.x) slot_key[i] = -1;
        __syncthreads();
        for (int i = threadIdx.x; i < h; i += blockDim.x) {
            const int id = hot[1 + i];
            hot_ids[i] = id;
            for (unsigned p = hash_id(id, kHotBits);; ++p) {   // <= 25% full
                const unsigned slot = p & (kHotSlots - 1);
                if (atomicCAS(&slot_key[slot], -1, id) == -1) {
                    slot_val[slot] = i;
                    break;
                }
            }
        }
    }
    for (long long start = (long long)blockIdx.x * kTile; start < n;
         start += (long long)gridDim.x * kTile) {
        __syncthreads();   // the previous tile is consumed (hash is built)
        for (int t = threadIdx.x; t < kTile + window; t += blockDim.x) {
            // positions past the end read as -1: out of range, no pair
            const int id = start + t < n ? tokens[start + t] : -1;
            int slot = -1;
            if (h > 0 && id >= 0 && id < vocab) {
                for (unsigned p = hash_id(id, kHotBits);; ++p) {
                    const int key = slot_key[p & (kHotSlots - 1)];
                    if (key == id) {
                        slot = slot_val[p & (kHotSlots - 1)];
                        break;
                    }
                    if (key == -1) break;
                }
            }
            tile[t] = id;
            if (h > 0) tile_slot[t] = slot;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
            const int a = tile[t];
            const int sa = h > 0 ? tile_slot[t] : -1;
            const bool a_in = a >= 0 && a < vocab;
            for (int j = 1; j <= window; ++j) {
                const int b = tile[t + j];
                const int sb = h > 0 ? tile_slot[t + j] : -1;
                const bool pair = a_in && b >= 0 && b < vocab;
                const int add = a == b ? 2 : 1;
                const bool hot_pair = pair && sa >= 0 && sb >= 0;
                if (hot_pair) {
                    // row: the smaller id's slot, so the flush's cell is upper
                    atomicAdd(&hot_table[a <= b ? sa * h + sb : sb * h + sa], add);
                } else if (pair) {
                    atomicAdd(out + (long long)min(a, b) * vocab + max(a, b), add);
                }
            }
        }
    }
    if (h > 0) {
        __syncthreads();
        for (int i = threadIdx.x; i < h * h; i += blockDim.x) {
            const int32_t v = hot_table[i];
            if (v != 0) {
                atomicAdd(out + (long long)hot_ids[i / h] * vocab + hot_ids[i % h], v);
            }
        }
    }
}

// The lower triangle from the upper: out[c][r] = out[r][c] for r < c.
__global__ void mirror_kernel(int32_t* __restrict__ out, int vocab) {
    __shared__ int32_t block[32][33];
    const int bi = blockIdx.y, bj = blockIdx.x;   // the upper tile (bi, bj)
    if (bi > bj) return;
    const int tx = threadIdx.x;
    for (int y = threadIdx.y; y < 32; y += blockDim.y) {
        const int r = bi * 32 + y, c = bj * 32 + tx;
        block[y][tx] = (r < vocab && c < vocab) ? out[(long long)r * vocab + c] : 0;
    }
    __syncthreads();
    for (int y = threadIdx.y; y < 32; y += blockDim.y) {
        const int r = bj * 32 + y, c = bi * 32 + tx;   // a lower element
        if (r < vocab && c < vocab && r > c) {
            out[(long long)r * vocab + c] = block[tx][y];
        }
    }
}

// The V <= ~238 route: a per-CTA table of the whole V x V.
__global__ void __launch_bounds__(kThreads)
stripes_smem_kernel(const int32_t* __restrict__ tokens,
                    int32_t* __restrict__ out, long long n, int vocab,
                    int window) {
    extern __shared__ int32_t smem[];
    int32_t* tile = smem;                                 // kTile + window
    int32_t* table = smem + kTile + window;               // vocab * vocab
    const int table_size = vocab * vocab;
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) table[i] = 0;
    for (long long start = (long long)blockIdx.x * kTile; start < n;
         start += (long long)gridDim.x * kTile) {
        __syncthreads();   // the previous tile is consumed (table zeroed)
        for (int t = threadIdx.x; t < kTile + window; t += blockDim.x) {
            tile[t] = start + t < n ? tokens[start + t] : -1;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
            const int a = tile[t];
            if (a < 0 || a >= vocab) continue;
            for (int j = 1; j <= window; ++j) {
                const int b = tile[t + j];
                if (b < 0 || b >= vocab) continue;
                atomicAdd(&table[min(a, b) * vocab + max(a, b)], a == b ? 2 : 1);
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) {
        const int32_t v = table[i];
        if (v == 0) continue;
        const int r = i / vocab, c = i % vocab;
        atomicAdd(out + i, v);
        if (r != c) atomicAdd(out + c * vocab + r, v);
    }
}

cudaError_t set_smem(const void* kernel, long long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The largest hot set whose tables fit in shared memory next to the tile.
int hot_capacity(int window) {
    for (int cap = kHotMax; cap >= 32; cap /= 2) {
        if (stripes_smem_bytes(window, cap) <= kMaxSmemBytes) return cap;
    }
    return 0;
}

}  // namespace

// tokens: (n,) int32; out: (vocab, vocab) int32, zeroed by the caller;
// scratch: kHotMax + 1 int32 (the hot set).  Adds the pair counts into
// `out` on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int stripes_launch(const void* tokens, void* out, void* scratch,
                              long long n, int vocab, int window,
                              int sm_count, void* stream) {
    if (n < 0 || vocab < 1 || window < 1 || window > (1 << 20) ||
        sm_count < 1) {
        return cudaErrorInvalidValue;
    }
    if (n == 0) return cudaSuccess;
    const int32_t* tok = static_cast<const int32_t*>(tokens);
    int32_t* o = static_cast<int32_t*>(out);
    int32_t* hot = static_cast<int32_t*>(scratch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + kTile - 1) / kTile;
    const long long tile_bytes = stripes_smem_bytes(window, 0);
    if (tile_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
    const long long table_bytes = (long long)vocab * vocab * sizeof(int32_t);
    if (tile_bytes + table_bytes <= kMaxSmemBytes) {
        const long long smem = tile_bytes + table_bytes;
        long long per_sm = kMaxSmemBytes / smem;
        if (per_sm > 4) per_sm = 4;
        long long blocks = per_sm * sm_count;
        if (blocks > tiles) blocks = tiles;
        cudaError_t err = set_smem((const void*)stripes_smem_kernel, smem);
        if (err != cudaSuccess) return err;
        stripes_smem_kernel<<<(unsigned int)blocks, kThreads, (size_t)smem, st>>>(
            tok, o, n, vocab, window);
        return cudaGetLastError();
    }
    const int hot_cap = hot_capacity(window);
    if (hot_cap > 0) {
        const long long sample_bytes = 2LL * kSampleSlots * sizeof(int32_t);
        cudaError_t err = set_smem((const void*)select_hot_kernel, sample_bytes);
        if (err != cudaSuccess) return err;
        select_hot_kernel<<<1, kSelectThreads, (size_t)sample_bytes, st>>>(
            tok, n, vocab, hot_cap, hot);
    }
    const long long smem = stripes_smem_bytes(window, hot_cap);
    cudaError_t err = set_smem((const void*)stripes_kernel, smem);
    if (err != cudaSuccess) return err;
    long long per_sm = kMaxSmemBytes / smem;
    if (per_sm > 2) per_sm = 2;   // every CTA pays H x H to zero and flush
    long long blocks = per_sm * sm_count;
    if (blocks > tiles) blocks = tiles;
    stripes_kernel<<<(unsigned int)blocks, kThreads, (size_t)smem, st>>>(
        tok, o, n, vocab, window, hot_cap > 0 ? hot : nullptr);
    const unsigned tiles_per_side = (unsigned)((vocab + 31) / 32);
    mirror_kernel<<<dim3(tiles_per_side, tiles_per_side), dim3(32, 8), 0, st>>>(
        o, vocab);
    return cudaGetLastError();
}
