"""Time design variants of the ``stripes`` and ``cms_update`` CUDA kernels.

  python3 kernel_variants.py [--seed 0] [--kernel stripes|cms_update|both]

Each variant is the kernel's source (``src/repro_torch/kernels/csrc/
stripes.cu`` or ``cms_update.cu``) with one design choice edited out or
changed, built with the same nvcc flags into ``build/variants/`` and called
through the same C entry point as the wrapper.  ``stripes`` runs on
``chip_smoke.py``'s Algorithm 5 tokens (2**24 ids of the Zipf corpus at V
4096, window 4) and on 2**24 uniform ids; ``cms_update`` on chip_smoke's
2**24 Zipf corpus tokens and 2**24 uniform ids (vocab 151936) at 4 x 2048
and 5 x 65536, and on the stream-stats path's first batch (524288 ragged
tokens, 4 x 2048, its bool mask).  Every variant's table must equal the
plain version's (a ``cms_update`` variant that differs or fails to launch
is reported, the others still run, and the exit code is 1).  Prints one
line per (tokens, variant) with two CUDA-event timings (ms per call,
back-to-back calls) and, for ``cms_update``, two device times (the calls
replayed from a CUDA graph), then the card's name and power limit.  Needs
one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "src"))

# the fold's cold-pair atomic, and the same atomic aggregated across the
# warp with __match_any_sync on the cell
_COLD = """} else if (pair) {
                    atomicAdd(out + (long long)min(a, b) * vocab + max(a, b), add);
                }"""
_COLD_MATCH = """}
                const long long cell = (pair && !hot_pair)
                    ? (long long)min(a, b) * vocab + max(a, b) : -1LL;
                const unsigned peers = __match_any_sync(0xffffffffu, cell);
                if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
                    atomicAdd(out + cell, add * __popc(peers));
                }"""
_HOT_MAX = "constexpr int kHotMax = 128;"
VARIANTS = {
    "as built": [],
    "cold pairs aggregated with __match_any_sync": [(_COLD, _COLD_MATCH)],
    "hot set of 64": [(_HOT_MAX, "constexpr int kHotMax = 64;")],
    "no hot set": [(_HOT_MAX, "constexpr int kHotMax = 0;")],
}

# cms_update edits.  _CG: cooperative groups for the cluster and
# labeled-partition variants.
_INCLUDES = "#include <cuda_runtime.h>"
_CG = """#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;"""
# the hot counter's add, and the same add summed over the lanes that hold
# the same hot id (__match_any_sync, through labeled_partition)
_HOT_ADD = "            if (slot >= 0) atomicAdd(&hs.cnt[slot], w[u]);"
_HOT_ADD_MATCH = """            if constexpr (!SHARED) {
                const auto peers = cg::labeled_partition(
                    cg::tiled_partition<32>(cg::this_thread_block()), slot);
                const int32_t sum = cg::reduce(peers, w[u], cg::plus<int32_t>());
                if (slot >= 0 && peers.thread_rank() == 0) {
                    atomicAdd(&hs.cnt[slot], sum);
                }
            }"""
_SAMPLES = "        const int samples = (int)(want < len ? want : len);"
# the hot set from one shared pass: a one-CTA kernel picks it from the
# batch's first 4096 tokens into a device buffer; every CTA hashes it
_KERNEL = """template <typename Tok, int WK, bool SHARED>
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const Params p) {"""
_SELECT_PASS = """__device__ uint32_t g_hot[kHotMax + 1];

template <typename Tok, int WK>
__global__ void __launch_bounds__(kThreads)
select_hot_kernel(const Params p) {
    extern __shared__ int32_t smem[];
    const HotSet hs = carve(smem);
    const int samples = (int)(p.n < kSampleMax ? p.n : kSampleMax);
    const int h = pick_hot<Tok, WK>(p.tokens, p.weights, 0, samples,
                                    kSampleMaxBits, hs);
    for (int i = threadIdx.x; i < h; i += kThreads) g_hot[1 + i] = hs.ids[i];
    if (threadIdx.x == 0) g_hot[0] = h;
}

__device__ int load_hot(const HotSet& hs) {
    for (int i = threadIdx.x; i < kHotSlots; i += kThreads) {
        hs.key[i] = kEmpty;
        hs.slot[i] = -1;
    }
    __syncthreads();
    const int h = g_hot[0];
    for (int k = threadIdx.x; k < h; k += kThreads) {
        const uint32_t x = g_hot[1 + k];
        hs.ids[k] = x;
        hs.cnt[k] = 0;
        for (unsigned q = fib_hash(x, kHotBits);; ++q) {
            const unsigned slot = q & (kHotSlots - 1);
            if (atomicCAS(&hs.key[slot], kEmpty, x) == kEmpty) {
                hs.slot[slot] = k;
                break;
            }
        }
    }
    __syncthreads();
    return h;
}

""" + _KERNEL
_PICK = """        hot_n = pick_hot<Tok, WK>(p.tokens, p.weights, begin, samples,
                                  p.sample_bits, hs);"""
_LAUNCH = "    kernel<<<(unsigned)blocks, kThreads, smem, st>>>(p);"
_LAUNCH_SELECT = """    if (!SHARED) {
        const auto select = select_hot_kernel<Tok, WK>;
        static bool select_opted = false;
        if (!select_opted) {
            err = cudaFuncSetAttribute(select,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kGlobalSmemBytes);
            if (err != cudaSuccess) return err;
            select_opted = true;
        }
        select<<<1, kThreads, kGlobalSmemBytes, st>>>(p);
    }
""" + _LAUNCH
# the hot set in the shared-table regime too: the sample and the hot set
# sit in front of the table
_SHARED_TABLE = "    int32_t* table = SHARED ? smem : p.out;"
_SHARED_HOT_TABLE = ("    int32_t* table = SHARED ? smem + kGlobalSmemBytes / 4 "
                     ": p.out;")
_GLOBAL_ONLY = "    if constexpr (!SHARED) {\n        const long long len"
_SHARED_SMEM = "    const size_t smem = SHARED ? 4 * (size_t)p.table"
_SHARED_OPT = "(int)(SHARED ? kMaxSmemBytes : kGlobalSmemBytes));"
# the shared tables of a cluster of 8 CTAs reduced through distributed
# shared memory before one flush per cluster
_FLUSH = """    if constexpr (SHARED) {
        __syncthreads();
        for (int i = tid; i < p.table; i += kThreads) {
            const int32_t v = table[i];
            if (v != 0) atomicAdd(p.out + i, v);
        }
    }"""
_FLUSH_CLUSTER = """    if constexpr (SHARED) {
        const cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
        const int slice = (p.table + c - 1) / c;
        const int hi = (r + 1) * slice < p.table ? (r + 1) * slice : p.table;
        for (int i = r * slice + tid; i < hi; i += kThreads) {
            int32_t v = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                if (q < c) v += cluster.map_shared_rank(table, q)[i];
            }
            if (v != 0) atomicAdd(p.out + i, v);
        }
        cluster.sync();
    }"""
_SHARE = "    p.share = ceil_div(p.n, blocks);"
_SHARE_CLUSTER = """    const int cluster = SHARED ? (blocks < 8 ? (int)blocks : 8) : 1;
    blocks = blocks / cluster * cluster;
""" + _SHARE
_LAUNCH_CLUSTER = """    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return err;"""
# a table above one CTA split over a cluster of up to 8 CTAs' shared
# memory (entry i in CTA i % C at i / C), the hot set as in the global
# regime; the grid is the clusters that fit on the card at once
_CEIL_DIV = "long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }"
_SPLIT = _CEIL_DIV + """
int sample_bits_for(long long share);

template <typename Tok, int WK>
__global__ void __launch_bounds__(kThreads)
cms_split_kernel(const Params p, int log2c, int local) {
    extern __shared__ int32_t smem[];
    const HotSet hs = carve(smem);
    int32_t* part = hs.sample;   // after the sample is counted
    const cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x;
    const long long begin = (long long)blockIdx.x * p.share;
    const long long end = begin + p.share < p.n ? begin + p.share : p.n;
    const long long len = end > begin ? end - begin : 0;
    long long want = len / 8;
    want = want < kSampleMin ? kSampleMin : (want > kSampleMax ? kSampleMax : want);
    const int samples = (int)(want < len ? want : len);
    const int hot_n = pick_hot<Tok, WK>(p.tokens, p.weights, begin, samples,
                                        p.sample_bits, hs);
    for (int i = tid; i < local; i += kThreads) part[i] = 0;
    cluster.sync();
    const uint32_t width = static_cast<uint32_t>(p.width);
    const int cmask = (1 << log2c) - 1;
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
            if (slot >= 0) atomicAdd(&hs.cnt[slot], w[u]);
            if (slot < 0 && w[u] != 0) {
                for (int d = 0; d < p.depth; ++d) {
                    const int idx = d * p.width + (int)(uhash(x[u], d) % width);
                    atomicAdd(cluster.map_shared_rank(part, idx & cmask) + (idx >> log2c),
                              w[u]);
                }
            }
        }
    }
    __syncthreads();
    for (int j = tid; j < hot_n * p.depth; j += kThreads) {
        const int k = j / p.depth, d = j - k * p.depth;
        const int32_t c = hs.cnt[k];
        if (c != 0) {
            const int idx = d * p.width + (int)(uhash(hs.ids[k], d) % width);
            atomicAdd(cluster.map_shared_rank(part, idx & cmask) + (idx >> log2c), c);
        }
    }
    cluster.sync();
    const int r = (int)cluster.block_rank();
    for (int j = tid; j < local; j += kThreads) {
        const int idx = (j << log2c) | r;
        if (idx < p.table && part[j] != 0) atomicAdd(p.out + idx, part[j]);
    }
}

template <typename Tok, int WK>
cudaError_t launch_split(Params p, int log2c, cudaStream_t st) {
    const auto kernel = cms_split_kernel<Tok, WK>;
    static bool opted = false;
    cudaError_t err;
    if (!opted) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(kMaxSmemBytes - 1024));
        if (err != cudaSuccess) return err;
        opted = true;
    }
    const int c = 1 << log2c;
    const int local = (int)ceil_div(p.table, c);
    const int part = local > (2 << kSampleMaxBits) ? local : (2 << kSampleMaxBits);
    const size_t smem = 4 * (size_t)(kHotWords + part);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int fit = 0;   // the clusters the card holds at once
    if (fit == 0) {
        err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
        if (err != cudaSuccess) return err;
        if (fit < 1) return cudaErrorInvalidConfiguration;
    }
    long long clusters = ceil_div(p.n, kMinTokensPerCta * c);
    if (clusters > fit) clusters = fit;
    p.share = ceil_div(p.n, clusters * c);
    p.sample_bits = sample_bits_for(p.share);
    cfg.gridDim = dim3((unsigned)(clusters * c));
    err = cudaLaunchKernelEx(&cfg, kernel, p, log2c, local);
    return err != cudaSuccess ? err : cudaGetLastError();
}"""
_REGIME = "    return launch<Tok, WK, false>(p, sm_count, st);\n}"
_REGIME_SPLIT = """    const long long cap = (kMaxSmemBytes - 1024) / 4 - kHotWords;
    for (int log2c = 1; log2c <= 3; ++log2c) {
        if ((cap << log2c) >= p.table) return launch_split<Tok, WK>(p, log2c, st);
    }
""" + _REGIME
_GRID_DIV = "constexpr int kGridDiv = 2;"
_GLOBAL_PER_SM = "constexpr int kGlobalCtasPerSm = 2;"
CMS_VARIANTS = {
    "as built": [],
    "no hot set": [(_SAMPLES, "        const int samples = 0;")],
    "one-stage sample (no early stop on ids that do not repeat)": [
        ("    if (8 * repeats < first_sampled) return 0;\n",
         "    // one stage: every sample is counted\n")],
    "hot ids aggregated with __match_any_sync": [
        (_INCLUDES, _CG), (_HOT_ADD, _HOT_ADD_MATCH)],
    "hot set from one shared pass": [
        (_KERNEL, _SELECT_PASS),
        (_PICK, "        hot_n = load_hot(hs);"),
        (_LAUNCH, _LAUNCH_SELECT)],
    "hot set in the shared-table regime too": [
        (_SHARED_TABLE, _SHARED_HOT_TABLE),
        (_GLOBAL_ONLY, "    {\n        const long long len"),
        (_SHARED_SMEM, _SHARED_SMEM + " + kGlobalSmemBytes"),
        (_SHARED_OPT, "(int)(kMaxSmemBytes - 1024));")],
    "shared tables reduced across a cluster of 8": [
        (_INCLUDES, _CG), (_FLUSH, _FLUSH_CLUSTER),
        (_SHARE, _SHARE_CLUSTER), (_LAUNCH, _LAUNCH_CLUSTER)],
    "tables above one CTA split over a cluster's shared memory": [
        (_INCLUDES, _CG), (_CEIL_DIV, _SPLIT), (_REGIME, _REGIME_SPLIT)],
    "half the CTAs (shared: >= T tokens each; global: 1 per SM)": [
        (_GRID_DIV, "constexpr int kGridDiv = 1;"),
        (_GLOBAL_PER_SM, "constexpr int kGlobalCtasPerSm = 1;")],
    "more CTAs (shared: >= T / 4 tokens each; global: 3 per SM)": [
        (_GRID_DIV, "constexpr int kGridDiv = 4;"),
        (_GLOBAL_PER_SM, "constexpr int kGlobalCtasPerSm = 3;")],
}


def variant_libraries(build_dir, library=None, variants=None):
    """Build each variant of ``library``'s source (stripes by default) and
    return {name: CudaLibrary}."""
    from repro_torch.kernels._build import CudaLibrary, build_all

    if library is None:
        from repro_torch.kernels.stripes import LIBRARY as library
        variants = VARIANTS
    text = library.source.read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: edit not found once")
            src = src.replace(old, new)
        path = build_dir / f"{library.name}_variant{i}.cu"
        path.write_text(src)
        lib = CudaLibrary(f"{library.name}_variant{i}", library.functions)
        lib.source = path
        libs[name] = lib
    return libs


def time_stripes(libs, seed, dev):
    import chip_smoke
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.stripes import _HOT_MAX, stripe_counts_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    vocab, window = 4096, 4
    streams = {
        "zipf": chip_smoke.corpus_tokens(vocab, 1 << 24, seed + 2, dev),
        "uniform": torch.randint(0, vocab, (1 << 24,), generator=gen,
                                 device=dev, dtype=torch.int32)}
    for tokens_name, toks in streams.items():
        want = stripe_counts_plain(toks, vocab, window)
        for name, lib in libs.items():
            launch = lib.load().stripes_launch

            def call():
                out = torch.zeros((vocab, vocab), dtype=torch.int32,
                                  device=dev)
                hot = torch.empty((_HOT_MAX + 1,), dtype=torch.int32,
                                  device=dev)
                err = launch(toks.data_ptr(), out.data_ptr(), hot.data_ptr(),
                             toks.numel(), vocab, window, sm_count(dev),
                             torch._C._cuda_getCurrentRawStream(dev.index))
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out

            if not torch.equal(call(), want):
                raise RuntimeError(f"variant {name!r} != the plain version")
            print(f"stripes variant [{name}] {tokens_name} V={vocab} "
                  f"W={window} N={toks.numel()}: exact, ms="
                  f"{chip_smoke.cuda_ms(call, 5)} / "
                  f"{chip_smoke.cuda_ms(call, 5)}", flush=True)


def time_cms(libs, seed, dev):
    import chip_smoke
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.cms import (_TOKEN_BYTES, _WEIGHT_KIND,
                                         cms_counts_plain)

    gen = torch.Generator(device=dev).manual_seed(seed)
    zipf = chip_smoke.corpus_tokens(151936, 1 << 24, seed + 1, dev)
    uniform = torch.randint(0, 151936, (1 << 24,), generator=gen, device=dev,
                            dtype=torch.int32)
    path_toks, path_mask = chip_smoke.stream_batches(seed, dev, count=1)[0]
    cases = [
        ("stream-stats batch N=524288 ragged bool mask", path_toks.reshape(-1),
         path_mask.reshape(-1), 4, 2048),
        ("zipf N=2^24", zipf, None, 4, 2048),
        ("uniform N=2^24", uniform, None, 4, 2048),
        ("zipf N=2^24", zipf, None, 5, 65536),
        ("uniform N=2^24", uniform, None, 5, 65536),
    ]
    failed = []
    for case, toks, weights, depth, width in cases:
        want = cms_counts_plain(toks, depth, width, weights=weights)
        for name, lib in libs.items():
            launch = lib.load().cms_update_launch

            def call():
                out = torch.zeros((depth, width), dtype=torch.int32,
                                  device=dev)
                err = launch(
                    toks.data_ptr(), _TOKEN_BYTES[toks.dtype],
                    weights.data_ptr() if weights is not None else None,
                    _WEIGHT_KIND[weights.dtype] if weights is not None else 0,
                    out.data_ptr(), toks.numel(), depth, width, sm_count(dev),
                    torch._C._cuda_getCurrentRawStream(dev.index))
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out

            label = f"cms_update variant [{name}] {case} {depth}x{width}"
            try:
                exact = torch.equal(call(), want)
            except RuntimeError as e:   # a launch the card refused
                failed.append(f"{label}: {e}")
                print(f"{label}: FAILED {e}", flush=True)
                continue
            if not exact:
                failed.append(f"{label}: != the plain version")
                print(f"{label}: MISMATCH", flush=True)
                continue
            print(f"{label}: exact, ms={chip_smoke.cuda_ms(call, 10)} / "
                  f"{chip_smoke.cuda_ms(call, 10)} device_ms="
                  f"{chip_smoke.graph_ms(call)} / {chip_smoke.graph_ms(call)}",
                  flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=("stripes", "cms_update", "both"),
                    default="both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from pathlib import Path

    import chip_smoke
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.cms import LIBRARY as CMS_LIBRARY

    build_dir = Path(_HERE) / "build" / "variants"
    stripes = cms = {}
    if args.kernel in ("stripes", "both"):
        stripes = variant_libraries(build_dir)
    if args.kernel in ("cms_update", "both"):
        cms = variant_libraries(build_dir, CMS_LIBRARY, CMS_VARIANTS)
    build_all(list(stripes.values()) + list(cms.values()))
    dev = torch.device("cuda", torch.cuda.current_device())
    if stripes:
        time_stripes(stripes, args.seed, dev)
    failed = time_cms(cms, args.seed, dev) if cms else []
    print(f"card: {chip_smoke.card_line()}")
    for line in failed:
        print(line, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
