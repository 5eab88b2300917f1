"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py [--seed 0] [--requests 16] [--serve-only]
                        [--train-only] [--mla-only] [--mesh-only]

Phases, each of which must pass or the script exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 off for every comparison.
2. kernels: build every CUDA kernel from the sources in
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once,
   sm_90a), launch each at real sizes and at each path's shapes (for
   ``segment_fold``: serve, ``packed_stats``, max-by-key; for
   ``flash_attention``: the prefill's 4 x 64 bucket in bf16 and f16 and at
   qwen2-moe-a2.7b's 16 / 16 heads, S 4096, ragged, Sq != Sk, head_dim 8),
   and hold it against its plain
   PyTorch version (16-bit attention also against two lower-precision
   controls it must be told apart from); time kernel, plain version and
   the one-call PyTorch yardstick with CUDA events.  ``segment_fold``,
   ``cms_update`` (Zipf and uniform tokens at 4 x 2048 and 5 x 65536; the
   stream-stats batch with an int32 mask, a bool mask, and int64 tokens)
   and ``stripes`` rows (Zipf and uniform tokens at V 4096) also print the
   device time of kernel and yardstick replayed from a CUDA graph and the
   CUDA launches one call makes (``torch.profiler``'s device events).
3. serve: ``build_engine`` for qwen3-0.6b at full width (28 layers, bf16,
   random weights from ``--seed``, the prefix cache on as by default)
   answers ``--requests`` requests; each
   decode step's metrics fold must have launched ``segment_fold`` once,
   and each prefill call ``flash_attention`` once per layer.  Then one
   decode step's eager wall time against its CUDA-graph replay, one
   (4, 64) prefill's eager wall time, and an engine step and the sampler
   alone at temperature 0 and 0.8.
4. reference: a small float32 model served on the card (prefill through
   the ``flash_attention`` kernel) and on the CPU (its plain version) with
   the same weights gives the same tokens, greedy and at temperature 0.8.
5. stream stats: ``update_stats`` over 16 ragged ``SyntheticCorpus``
   batches at qwen3-0.6b's training data shape (vocab 151936, seq 4096,
   global batch 128): one ``cms_update`` launch per batch, one
   ``segment_fold`` launch per batch's ``packed_stats``; the card's state
   equals the CPU's and the tree fold of the per-batch states, and each
   batch's per-row ``packed_stats`` (tokens, docs) equals the CPU's.
6. MapReduce: ``average_by_key_job(65536)`` on 2**22 records, 8 shards
   (Algorithms 1 and 3; Algorithm 4 at 2**12 records) and the max-by-key
   job (Algorithms 1 and 3 through ``segment_fold``) against float64
   oracles, launches counted against each plan's tier;
   ``word_count_job(151936)`` over the stream's tokens against
   ``np.bincount``.
7. Algorithm 5: ``cooccurrence_stripes`` over 2**24 corpus tokens (V=4096,
   window 4) launches ``stripes`` and equals its plain version.
8. prefix cache: ``flash_attention`` with per-row query offsets (the warm
   prefill: the serve config's call in bf16, f16 and f32, and a long one)
   against its plain version with phase 2's checks, offsets of zero equal
   to the top-left call bit for bit, SDPA with the same boolean mask timed
   beside it; a float32 smoke model with the cache on gives the CPU's
   tokens, and on the card a cold engine's (greedy and at temperature
   0.8); then phase 3's weights serve ``benchmarks/bench_prefix.py``'s
   trace (A) and phase 3's config with a 48-token shared prefix (B) on a
   warm and a cold engine: TTFT p50 / p99 and warm / cold (the reference's
   <= 0.6 gate is printed, not enforced), hit rate, bytes saved, each
   prefill call's eager wall time by (k, bucket) and the stats flush per
   step; each prefill must launch ``flash_attention`` once per layer, the
   fold-accounted bytes must equal the resident bytes, some prompt token
   must come from the trie, and the program shapes stay within the bound.
   Then the sliding window of ``flash_attention`` at gemma3-1b's heads
   (cases w1-w4: cold S 1024 and 600, warm Sq 128 over Sk 1024, a window as
   long as the keys, which must equal the windowless call bit for bit)
   against its plain version with phase 2's checks, timed beside SDPA with
   the same boolean mask; w1's device time must fall below 0.9 of the
   windowless call's (the tiles below the window are skipped).
9. gemma3-1b (26 layers, 5:1 local:global, window 512): its float32 smoke
   model with the cache on and a ``WindowedMetrics`` subscribed gives the
   CPU's tokens and a cold engine's on the card (greedy and at 0.8), the
   consumer counting every token and prefix hit; then the serve CLI's own
   run (``launch.serve.run_cli``) at full width, random weights from
   ``--seed``: 16 requests of 520-1000 tokens, 8 slots, buckets 256 / 512 /
   1024, ``--users 4``, half the prompts opening with a 640-token prefix,
   greedy; ``flash_attention`` must launch 26 times per prefill call and
   ``segment_fold`` once per step.  Then the same trace on fresh engines
   with and without the consumer (its host time per step), the decode
   step eager against its CUDA-graph replay, and the tied ``unembed``'s
   share of the replayed step.
10. streaming windows: 2**22 timestamped events through ``tumbling_fold``
   (``sum_``, ``max_``; 4096 windows) and ``session_fold`` (the sessions of
   65536 users), each exact against a numpy oracle with one
   ``segment_fold`` launch per fold, wall time and events/s printed; and
   ``SlidingWindow(sum_, 32)`` over 10**4 events against brute force.
11. MoE, qwen2-moe-a2.7b (24 layers, 60 + 4 pad experts of 2048 x 1408,
   top-4, 4 shared, bf16): (a) the expert products through ``grouped_mm``
   against the per-expert loop on one full-width layer at the decode (8 x
   top-4) and (4, 64) prefill shapes, group sizes == ``bincount`` with the
   pads empty, timed beside their byte bound; (b) its float32 smoke model
   served on the card and the CPU, with the cache on and off, greedy and at
   0.8: the same tokens; (c) the serve CLI's own run at full width (16
   requests of 8-64 tokens, 8 slots, buckets 16 / 32 / 64, 32 new tokens,
   greedy): ``flash_attention`` 24 launches per prefill call,
   ``segment_fold`` one per step, three grouped products per layer per
   step and prefill call; tokens/s, TTFT, the decode step eager against
   its CUDA-graph replay and its byte bound, and the MoE layer's device
   time split (route + sort, grouped products, combine, shared experts).
12. the context-conditioned family: (a) ``flash_attention`` non-causal at
   whisper-small's encoder (x1: B 8, S 1500, 12 / 12 x 64) and
   cross-attention (x2: 64 queries over 1500 frames) and
   llama-3.2-vision-90b's cross-attention (x3: 64 queries over 1600
   patches, 64 / 8 x 128), bf16, with phase 2's checks, timed beside SDPA,
   one launch each; (b) both smoke configs in float32 (gates 0.5) on the
   card and the CPU: ``forward(context=)`` logits within 1e-4 and 16
   greedy serve steps' tokens equal; (c) whisper-small at full width
   through ``build_serve_step`` (8 slots): ``make_cache`` encodes 8 x 1500
   frames in 12 launches, 16 prompt + 64 greedy steps with no launch, the
   step eager against its CUDA-graph replay (equal bit for bit) and its
   byte bound, a (8, 64) ``forward(context=)`` in 36 launches, and in
   float32 the last ``forward`` logits within 2e-2 of the decode loop's;
   (d) llama-3.2-vision-90b at full width cut to one period (5 layers, the
   cut printed as ``reduced``), 8 slots: ``init_cache(context=)``, 32
   greedy steps, the step eager against its replay and its byte bound, a
   (4, 64) ``forward(context=)`` in 5 launches.
13. the recurrent family: (a) ``flash_attention`` at jamba's attention
   (case j: B 4, S 64, 32 / 8 x 128, bf16, causal) with phase 2's checks,
   timed beside SDPA, one launch; (b) both smoke configs (xlstm, jamba) in
   float32 on the card and the CPU with the same weights: ``forward``
   logits within 1e-4 and ``build_engine``'s greedy tokens for 4 prompts
   shorter than their buckets (the decode loop over the bucket as the
   prefill) equal, ``segment_fold`` once per engine step; (c) xlstm-1.3b
   at full width, nothing cut (48 layers, 3.57 B parameters), through the
   serve CLI's own run (16 requests of 8-32 tokens, 8 slots, buckets 16 /
   32, 32 new tokens, greedy): no ``flash_attention`` launch,
   ``segment_fold`` once per step, tokens/s and TTFT; the decode step eager
   against its CUDA-graph replay (equal bit for bit) and its byte bound
   (weights without ``embed`` and the mLSTM states read and written); in
   float32 a (2, 256) ``forward``'s last logits within 2e-2 of the decode
   loop's; (d) jamba-v0.1-52b at full width cut to one period (8 layers,
   13.3 B parameters, the cut printed as ``reduced``), 8 slots: a 16-token
   prompt and 32 greedy steps through ``decode_step``, the step eager
   against its replay and its byte bound (experts hit counted on random
   rows), a (4, 64) ``forward`` in 1 launch with ``expert_load`` summing to
   4 x 64 x 2 x 4.
14. training: (a) ``flash_attention``'s backward through its autograd
   Function (the forward launch writing each row's log-sum-exp, then
   ``csrc/flash_attention_bwd.cu``) against its f32 plain version at the
   training shapes t1-t5 (qwen3-0.6b B 8 x S 1024, gemma3's window 512 at
   d 256, the whisper encoder, cross-attention at Sq 64 / Sk 1500, odd f32
   sizes): each gradient within 2e-2 (16-bit) or 1e-4 (f32) of its max
   magnitude, one backward launch per call in the design the case must
   take (``wgmma`` for t1-t4, the CUDA cores for t5; printed), timed in
   turns with SDPA's backward (ours, SDPA, SDPA, ours; 20 calls a
   reading after a warm-up, both readings printed) beside its bound and
   its plain version, and forward + backward beside SDPA's forward +
   backward; (b) the qwen3 smoke model
   in f32 trains 5 steps (2 microbatches) on the card and on the CPU from
   the same parameters and batches, loss and grad_norm within 1e-4; (c)
   qwen3-0.6b at full width, nothing cut, through the training CLI: 20
   steps of 8 x 1024 tokens in 2 microbatches, remat per layer, a
   checkpoint at step 10; finite, falling loss; ``flash_attention`` 28 x 2
   x 2 launches a step, its backward 28 x 2, ``cms_update`` one; a second
   CLI run from a copy of the step-10 checkpoint to step 20 ends with the
   stream stats and token count equal and losses within 1e-2; median step
   time, tokens/s, the step's bound and share, peak memory and the
   backward's share of one profiled step, split by kernel.
   ``--train-only`` runs phases 1 and 14 alone.
15. MLA and deepseek-v2-236b: (a) ``flash_attention`` at v's head dim 128
   != q / k's 192 (128 heads, bf16): m1, the engine's (4, 64) bucket; m2,
   S 4096 causal; m3, the warm call (Sq 16 over 96 cache rows at per-row
   offsets), each against its plain version with phase 2's checks (the
   p-rounded control on 16 heads), one launch per call, timed beside its
   bound, its plain version and SDPA at dv != d (the backend it took
   printed; v zero-padded to 192 only if SDPA refused); the backward at
   m1's shape (v, o and do padded to 192 on the card: ``mma_sync``)
   against the f32 plain backward; (b) the float32 smoke model card vs
   CPU: ``forward`` logits and ``loss_fn``'s loss and gradient norm
   within 1e-4, engine tokens equal with the prefix cache on and off,
   greedy and at 0.8, warm == cold; (c) deepseek-v2-236b at full width
   cut to 4 layers (the dense prelude and 3 MoE layers of 160 experts,
   top-6, 2 shared; 13.3 B parameters; the cut printed as ``reduced``)
   through ``build_engine`` with phase 3's traffic: ``flash_attention``
   4 launches per prefill call and none in a decode step,
   ``segment_fold`` one per step, 3 grouped products per MoE layer per
   step and prefill call, a (4, 64) forward's ``expert_load`` summing to
   4 x 64 x 6 x 3; tokens/s, TTFT, the decode step eager against its
   replay and its byte bound, the latent cache's 1152 bytes per token
   per layer against an up-projected K / V cache's 81920, peak memory.
   ``--mla-only`` runs phases 1 and 15 alone.
16. the mesh tier (``repro_torch.dist``, the monoid shuffle across ranks;
   the kernels are built in this process before any rank starts, each rank
   a ``torch.multiprocessing`` spawn meeting at a ``FileStore``): (a)
   NCCL, a world of one, mesh (1,) 'data': ``run_sharded`` for phase 6's mean-by-key and
   max-by-key (2**22 records, 65536 keys; Algorithm 4 on 2**12) for every
   strategy, max exact against ``run_local`` and mean within 1e-5 of the
   float64 oracle, ``segment_fold`` launched as each plan's tier says, and
   a keyed and a flat ``execute_fold(mesh_axes=('data',))`` equal to the
   local fold; (b) gloo, 4 ranks on cuda:0 (NCCL refuses two ranks on one
   card), mesh (2, 2) ('pod', 'data'): which collectives gloo takes for
   CUDA tensors of each dtype (the phase fails if one is refused),
   ``run_sharded`` as in (a) over 'data', ``combine_keyed_table`` over
   'data' then 'pod' with each shuffle algorithm forced, ``sync_stats``
   over phase 5's 16 batches split 4 per host equal to the single-host
   state bit for bit (one ``cms_update`` per batch), and
   ``execute_fold(sum, mesh_axes=('data', 'pod'))`` over qwen3-0.6b's
   gradient shapes (the embedding, the final norm and the first
   ``--mesh-layers`` layers, f32, 2 microbatches) in scan and async,
   dense, ``topk:0.01`` and ``int8``: output plus the pod-summed error
   feedback within 1e-4 of the dense sum, the pod axis's bytes equal to
   the plan's (lossy below dense); per rank the local and shuffle ms,
   bytes per axis, the plan's ``predicted_us`` beside the measured time
   and async's measured overlap (the median of 3 runs of each schedule
   through ``async_microbatch_fold``) beside the modeled one.  A rank that fails or hangs fails the phase.
   ``--mesh-only`` runs phases 1 and 16 alone.

The last lines are the card, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  The exit code
is 0 only when every phase passed; a failing phase raises (exit 1), no
card exits 2, and a copy of this script without ``src/repro_torch`` beside
it exits 1, none of them printing the record or the ok line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# dense peaks of an H100 SXM (data sheet): bf16 and f16 on the tensor cores.
# float32 at the f32 contract's cheapest rate on this card: three bf16
# tensor-core products per product (989e12 / 3), which beats the CUDA cores'
# 67e12; TF32 (495e12) rounds the inputs to 10 mantissa bits, so it is not
# that contract
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 989e12 / 3}

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "src"))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, repeat: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed (the host's launch gaps removed); best of
    ``repeat`` replays."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


# how many times cuda_launches profiles a call whose trace came back empty
PROFILE_TRIES = 5


def cuda_launches(fn):
    """The kernels and memsets one call of ``fn`` puts on the card, counted
    from ``torch.profiler``'s device events.  The profiler at times records
    no device event at all (its activity buffers come back empty), so an
    empty trace is profiled again, up to ``PROFILE_TRIES`` times; None when
    every try came back empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if count:
            return count
    return None


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    a, b = a.to(torch.float64), b.to(torch.float64)
    both_nan = torch.isnan(a) & torch.isnan(b)
    if bool((torch.isnan(a) ^ torch.isnan(b)).any()):
        return math.inf
    same_inf = (a == b)            # equal infinities give nan below
    diff = torch.where(both_nan | same_inf, 0.0, (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(gen: torch.Generator, dev: torch.device):
    """The shapes the kernel runs at: four at scale and the serving path's
    own (8 slots x 3 metric columns), plus NaN/empty-segment semantics."""
    N = 1 << 22

    def ids(n, s):
        return torch.randint(0, s, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    cases = []
    # mean-by-key: 16 MB global-atomics table, 90% of rows valid
    S, D = 65_536, 64
    cases.append(dict(
        name="mean_by_key f32 N=2^22 D=64 S=65536 mask=90%",
        values=torch.randn((N, D), generator=gen, device=dev), ids=ids(N, S),
        S=S, semiring="sum", with_count=True,
        mask=torch.rand((N,), generator=gen, device=dev) < 0.9,
        rtol=1e-5, atol=1e-4))
    # bitwise_or on 0/1 uint8 bitmaps via the max semiring
    S, D = 4_096, 32
    cases.append(dict(
        name="bitwise_or(max) u8 N=2^22 D=32 S=4096",
        values=torch.randint(0, 2, (N, D), generator=gen, device=dev,
                             dtype=torch.uint8), ids=ids(N, S),
        S=S, semiring="max", with_count=False, mask=None, rtol=0, atol=0))
    # bf16 sum: 4096 rows per key summed in f32 in atomic order
    S, D = 1_024, 128
    cases.append(dict(
        name="sum bf16 N=2^22 D=128 S=1024",
        values=torch.randn((N, D), generator=gen, device=dev)
        .to(torch.bfloat16), ids=ids(N, S),
        S=S, semiring="sum", with_count=False, mask=None,
        rtol=1e-5, atol=2e-3))
    # int32 min: the 128 KB shared-memory table regime
    S, D = 2_048, 16
    cases.append(dict(
        name="min i32 N=2^22 D=16 S=2048",
        values=torch.randint(-1_000_000, 1_000_000, (N, D), generator=gen,
                             device=dev, dtype=torch.int32), ids=ids(N, S),
        S=S, semiring="min", with_count=False, mask=None, rtol=0, atol=0))
    # f32 max with NaN rows, out-of-range ids and empty segments
    n, S, D = 1 << 16, 4_096, 8
    v = torch.randn((n, D), generator=gen, device=dev)
    v[::997] = float("nan")
    cases.append(dict(
        name="max f32 N=2^16 D=8 S=4096 NaN rows, ids in [-1, S+1)",
        values=v, ids=torch.randint(-1, S + 1, (n,), generator=gen,
                                    device=dev, dtype=torch.int32),
        S=S, semiring="max", with_count=False, mask=None, rtol=0, atol=0))
    # the serving path's shape: one decode step's metrics fold
    S, D = 8, 3
    cases.append(dict(
        name="serve sum f32 N=8 D=3 S=8 (decode-step metrics)", serve=True,
        values=torch.randn((S, D), generator=gen, device=dev),
        ids=torch.arange(S, dtype=torch.int32, device=dev), S=S,
        semiring="sum", with_count=False,
        mask=torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool,
                          device=dev), rtol=0, atol=0))
    return cases


def mapreduce_records(seed: int):
    """The MapReduce phase's records: 2**22 (key, value) pairs over 65536
    keys, keys int32 and values float32, as numpy arrays."""
    rng = np.random.default_rng(seed + 5)
    n, k = 1 << 22, 65536
    return (rng.integers(0, k, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32))


def path_fold_cases(batch, keys_np, vals_np, dev):
    """``segment_fold`` at the shapes the slice's paths give it, on the
    paths' own data: ``packed_stats`` on one stream batch (one row of
    (1, is_eos) per position, segment = batch row, the ragged mask) and
    max-by-key's per-shard (combiner) and whole (naive) tables.  Every
    case is exact: the sums are of small integers, and max is order-free."""
    toks, mask = batch
    B, S = toks.shape
    flat = toks.reshape(-1)
    keys = torch.from_numpy(keys_np).to(dev)
    vals = torch.from_numpy(vals_np).to(dev)[:, None]
    shard = keys.numel() // 8
    return [
        dict(name=f"packed_stats sum f32 N={B * S} D=2 S={B} ragged mask "
                  "(stream batch)",
             values=torch.stack([torch.ones_like(flat, dtype=torch.float32),
                                 (flat == 0).to(torch.float32)], dim=-1),
             ids=torch.arange(B, dtype=torch.int32, device=dev)
             .repeat_interleave(S), S=B, semiring="sum", with_count=False,
             mask=mask.to(torch.bool).reshape(-1), rtol=0, atol=0),
        dict(name="max_by_key f32 N=2^19 D=1 S=65536 (combiner shard)",
             values=vals[:shard], ids=keys[:shard], S=65536, semiring="max",
             with_count=False, mask=None, rtol=0, atol=0),
        dict(name="max_by_key f32 N=2^22 D=1 S=65536 (naive)",
             values=vals, ids=keys, S=65536, semiring="max",
             with_count=False, mask=None, rtol=0, atol=0),
    ]


def run_kernel_case(case, segment_fold, segment_fold_plain) -> dict:
    v, ids, S, sr = case["values"], case["ids"], case["S"], case["semiring"]
    wc, mask = case["with_count"], case["mask"]

    def kernel():
        return segment_fold(v, ids, S, semiring=sr, with_count=wc,
                            valid_mask=mask)

    def plain():
        return segment_fold_plain(v, ids, S, semiring=sr, with_count=wc,
                                  valid_mask=mask)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    err = max_err(got, ref)
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    ok = all(torch.allclose(g.double(), r.double(), rtol=case["rtol"],
                            atol=case["atol"], equal_nan=True)
             for g, r in pairs)
    if case["rtol"] == 0 and case["atol"] == 0:
        ok = ok and err == 0.0

    # the one-call PyTorch yardstick on the same table: dropped rows are
    # routed to a spare row S beforehand (outside the timed call)
    n, d = v.shape
    keep = (ids >= 0) & (ids < S)
    if mask is not None:
        keep &= mask
    routed = torch.where(keep, ids.long(), S)
    vals = v.float() if sr == "sum" else v
    if wc:
        vals = torch.cat([vals, vals.new_ones((n, 1))], dim=1)
    w = vals.shape[1]
    if sr == "sum":
        table = torch.zeros((S + 1, w), dtype=vals.dtype, device=v.device)

        def library():
            return table.index_add_(0, routed, vals)
    else:
        index = routed[:, None].expand(n, w).contiguous()
        table = torch.zeros((S + 1, w), dtype=vals.dtype, device=v.device)
        reduce = "amax" if sr == "max" else "amin"

        def library():
            return table.scatter_reduce_(0, index, vals, reduce=reduce,
                                         include_self=False)

    iters = 200 if n <= 1024 else 10
    kernel_ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(plain, iters)
    library_ms = cuda_ms(library, iters)
    device_ms = graph_ms(kernel)
    library_device_ms = graph_ms(library)
    out_elt = 4 if v.dtype.is_floating_point else v.element_size()
    nbytes = (n * d * v.element_size() + 4 * n
              + (n if mask is not None else 0) + S * (d + wc) * out_elt)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(name=case["name"], ok=ok, max_abs_err=err,
                tolerance=f"rtol={case['rtol']} atol={case['atol']}",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                cuda_launches=cuda_launches(kernel),
                bound_ms=bound_ms, bound_bytes=nbytes,
                serve=case.get("serve", False))


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------

def serve_full(args, segment_fold, flash_attention):
    from repro_torch.configs import get_config
    from repro_torch.models import num_params
    from repro_torch.serving import (ServeConfig, build_engine,
                                     poisson_trace, serve_trace)

    config = ServeConfig(arch="qwen3-0.6b", full=True, num_slots=8,
                         prefill_buckets=(16, 32, 64), max_new_tokens=32,
                         prefill_batch=4, seed=args.seed)
    t0 = time.perf_counter()
    engine = build_engine(config, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = get_config(config.arch, smoke=not config.full)
    print(f"{cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype} "
          f"params={num_params(engine.backend.params)} "
          f"init_s={setup_s:.1f}", flush=True)

    # warm-up: one short request (cuBLAS handles, allocator) before timing
    engine.submit(list(range(1, 9)), max_new_tokens=2)
    for _ in engine.run(max_steps=64):
        pass
    torch.cuda.synchronize()

    rng = np.random.default_rng(args.seed)
    trace = poisson_trace(rng, args.requests, 0.0, 8, 64,
                          engine.backend.vocab_size, 32)
    steps0, prefills0 = engine.stats.steps, engine.stats.prefill_calls
    segment_fold.launches = 0
    flash_attention.launches = 0
    results, wall = serve_trace(engine, trace)
    torch.cuda.synchronize()
    launches = segment_fold.launches
    flash_launches = flash_attention.launches
    steps = engine.stats.steps - steps0
    prefills = engine.stats.prefill_calls - prefills0

    vocab = engine.backend.vocab_size
    if len(results) != args.requests:
        raise RuntimeError(f"{len(results)} of {args.requests} completed")
    for r in results:
        if not (1 <= len(r.tokens) <= 32) or not math.isfinite(r.logprob_sum):
            raise RuntimeError(f"bad result {r}")
        if any(not 0 <= t < vocab for t in r.tokens):
            raise RuntimeError(f"token outside the vocab in {r.tokens}")
        if len(r.tokens) < 32 and not r.stopped:
            raise RuntimeError(f"uid {r.uid} ended early without eos")
    if launches <= 0 or launches != steps:
        raise RuntimeError(f"segment_fold launched {launches} times over "
                           f"{steps} decode steps; the per-step fold must "
                           "launch the CUDA kernel exactly once per step")
    if prefills <= 0 or flash_launches != cfg.num_layers * prefills:
        raise RuntimeError(f"flash_attention launched {flash_launches} times "
                           f"over {prefills} prefill calls; each prefill "
                           f"must launch it once per layer "
                           f"({cfg.num_layers})")
    gen = sum(len(r.tokens) for r in results)
    ttft = np.array([r.ttft_s for r in results])
    counts = engine.compile_counts()
    if sum(counts.values()) > engine.compile_bound():
        raise RuntimeError(f"program shapes {counts} exceed the bound "
                           f"{engine.compile_bound()}")
    print(f"serve: completed={len(results)} generated_tokens={gen} "
          f"wall_s={wall} tokens_per_s={gen / wall} "
          f"ttft_p50_ms={np.percentile(ttft, 50) * 1e3} "
          f"ttft_p99_ms={np.percentile(ttft, 99) * 1e3} "
          f"decode_steps={steps} prefill_calls={prefills} "
          f"segment_fold.launches={launches} "
          f"flash_attention.launches={flash_launches} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)
    print(f"program shapes: {counts} (bound {engine.compile_bound()})")
    prefix = getattr(engine, "prefix", None)   # None: a checkout without it
    if prefix is not None:
        ps = prefix.stats
        print(f"prefix cache (on, the default): hit_rate={ps.hit_rate()} "
              f"hit_tokens={ps.hit_tokens}/{ps.prompt_tokens} nodes="
              f"{prefix.node_count} resident={prefix.total_bytes} "
              f"fold_accounted={prefix.accounted_bytes()} folds="
              f"{ps.folds} fold_rows={ps.fold_rows}", flush=True)
        if prefix.accounted_bytes() != prefix.total_bytes:
            raise RuntimeError("prefix cache: fold-accounted bytes != "
                               "resident bytes")
    decode_breakdown(engine)
    return launches, flash_launches, engine


def decode_breakdown(engine, iters: int = 20) -> None:
    """Where a decode step's time goes: the eager step's wall time against
    the same step captured in a CUDA graph and replayed (device time with
    the host's launch gaps removed)."""
    be, S = engine.backend, engine.config.num_slots
    cache = be.init_cache(S, True)
    cur = torch.ones((S, 1), dtype=torch.int32, device=be.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            be.decode(be.params, cache, cur)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        be.decode(be.params, cache, cur)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / iters * 1e3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        be.decode(be.params, cache, cur)
    replay_ms = cuda_ms(graph.replay, iters)
    print(f"decode step ({S} slots, full width): eager_wall_ms={eager_ms} "
          f"graph_replay_ms={replay_ms} host_bound_share="
          f"{1 - replay_ms / eager_ms}", flush=True)
    # one prefill program of the serve phase's largest shape, (4, 64),
    # eager, beside the 64 eager decode steps it replaces
    k, bucket = engine.config.prefill_batch, engine.config.prefill_buckets[-1]
    cachek = be.init_cache(k, True)
    toks = torch.randint(1, be.vocab_size, (k, bucket), dtype=torch.int32,
                         device=be.device)
    lengths = torch.full((k,), bucket, dtype=torch.int32, device=be.device)
    be.prefill(be.params, cachek, toks, lengths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        be.prefill(be.params, cachek, toks, lengths)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"prefill ({k} x {bucket}, full width, one pass): eager_wall_ms="
          f"{prefill_ms} against {bucket} eager decode steps = "
          f"{bucket * eager_ms} ms", flush=True)
    for temperature in (0.0, 0.8, 0.0, 0.8):
        step, sample = engine_step_ms(engine, temperature, iters)
        print(f"engine step ({S} slots busy, full width, temperature "
              f"{temperature}): eager_wall_ms={step} sampler_wall_ms="
              f"{sample}", flush=True)
    return replay_ms


def engine_step_ms(engine, temperature: float, iters: int):
    """Eager wall times at ``temperature`` on the serve engine's backend:
    one ``ContinuousEngine.step`` (decode, sampling, metrics fold, host
    bookkeeping) with every slot busy, and the engine's sampler alone on
    (slots, vocab) logits."""
    from repro_torch.serving import ContinuousEngine

    config = dataclasses.replace(engine.config, temperature=temperature,
                                 max_new_tokens=iters + 4)
    eng = ContinuousEngine(engine.backend, config)
    for i in range(config.num_slots):
        eng.submit(list(range(1 + i, 9 + i)))
    for _ in range(2):           # admission (prefill) and a warm step
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3

    S = config.num_slots
    logits = 3 * torch.randn((S, engine.backend.vocab_size),
                             device=engine.backend.device)
    seeds, tok_idx = np.arange(S, dtype=np.int64), np.full((S,), 5, np.int64)
    eng._sample_rows(logits, seeds, tok_idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._sample_rows(logits, seeds, tok_idx)
    torch.cuda.synchronize()
    return step_ms, (time.perf_counter() - t0) / iters * 1e3


def serve_reference(args):
    """A float32 smoke model on the card vs the same weights on the CPU,
    greedy and sampled (temperature 0.8: the threefry stream is the same
    on both devices)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, ServeConfig, make_backend

    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(args.seed)
    params_cpu = init_params(cfg, gen, device="cpu")
    params_gpu = pytree.tree_map(lambda t: t.to("cuda"), params_cpu)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 16)))
               .tolist() for _ in range(7)]

    for temperature in (0.0, 0.8):
        config = ServeConfig(num_slots=3, prefill_buckets=(8, 16),
                             max_new_tokens=6, prefill_batch=2,
                             seed=args.seed, temperature=temperature)
        out = {}
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            eng = ContinuousEngine(make_backend(cfg, params, config, dev),
                                   config)
            uids = [eng.submit(p) for p in prompts]
            before = flash_attention.launches
            for _ in eng.run(max_steps=200):
                pass
            launched = flash_attention.launches - before
            want = cfg.num_layers * eng.stats.prefill_calls \
                if dev == "cuda" else 0
            if launched != want:
                raise RuntimeError(f"{dev}: flash_attention launched "
                                   f"{launched} times, expected {want}")
            out[dev] = [eng.result(u) for u in uids]
        worst = 0.0
        for a, b in zip(out["cpu"], out["cuda"]):
            if a.tokens != b.tokens or a.stopped != b.stopped:
                raise RuntimeError(f"temperature {temperature}: cuda tokens "
                                   f"{b.tokens} != cpu {a.tokens}")
            worst = max(worst, abs(a.logprob_sum - b.logprob_sum))
        if worst > 1e-3:
            raise RuntimeError(f"temperature {temperature}: logprob sums "
                               f"differ by {worst} (> 1e-3)")
        print(f"reference: f32 smoke model, temperature {temperature}, "
              f"{len(prompts)} requests, cuda tokens (prefill on the "
              f"flash_attention kernel) == cpu tokens (its plain version), "
              f"max |logprob_sum diff| = {worst}", flush=True)


# ---------------------------------------------------------------------------
# phase 2, continued: cms_update and stripes against their plain versions
# ---------------------------------------------------------------------------

def corpus_tokens(vocab: int, n: int, seed: int, dev) -> torch.Tensor:
    """``n`` Zipf tokens from the port's ``SyntheticCorpus`` (one batch of
    n // 4096 rows of 4096), flattened, on ``dev``."""
    from repro_torch.data import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(vocab_size=vocab, seq_len=4096,
                                        global_batch=n // 4096, seed=seed),
                             device=dev)
    return corpus(0)["tokens"].reshape(-1)


def stream_batches(seed: int, dev, count: int = 16, start: int = 0):
    """The stream-stats path's batches: ragged qwen3-0.6b training data
    (vocab 151936, seq 4096, global batch 128), tokens and masks, of steps
    ``start`` to ``start + count``."""
    from repro_torch.data import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(vocab_size=151936, seq_len=4096,
                                        global_batch=128, seed=seed,
                                        ragged=True), device=dev)
    return [(b["tokens"], b["valid_mask"])
            for b in (corpus(step) for step in range(start, start + count))]


def _time_three(kernel, plain, library, iters):
    return (cuda_ms(kernel, iters), cuda_ms(plain, iters),
            cuda_ms(library, iters))


def run_cms_case(name, toks, depth, width, weights, *, path=False) -> dict:
    from repro_torch.core.monoids import _uhash
    from repro_torch.kernels.cms import cms_counts, cms_counts_plain

    def kernel():
        return cms_counts(toks, depth, width, weights=weights)

    def plain():
        return cms_counts_plain(toks, depth, width, weights=weights)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max_err(got, ref)
    ok = bool(torch.equal(got, ref))
    # the yardstick: ONE index_add_ of the weights into the flattened table,
    # bucket ids d*W + h_d precomputed outside the timed call
    n = toks.numel()
    ids = torch.cat([d * width + _uhash(toks, d) % width
                     for d in range(depth)])
    w = (torch.ones((n,), dtype=torch.int32, device=toks.device)
         if weights is None else weights.to(torch.int32)).repeat(depth)
    table = torch.zeros((depth * width,), dtype=torch.int32,
                        device=toks.device)

    def library():
        return table.index_add_(0, ids, w)

    ms, plain_ms, library_ms = _time_three(kernel, plain, library, 10)
    # the bytes the kernel must read: each id (4 or 8) and weight (1 or 4)
    # as it is given, and the table written once
    nbytes = n * toks.element_size() + 4 * depth * width + \
        (n * weights.element_size() if weights is not None else 0)
    return dict(name=name, ok=ok, max_abs_err=err, tolerance="exact",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=graph_ms(kernel),
                library_device_ms=graph_ms(library),
                cuda_launches=cuda_launches(kernel),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
                path=path)


def run_stripes_case(name, toks, vocab, window, *, path=False) -> dict:
    from repro_torch.kernels.stripes import stripe_counts, stripe_counts_plain

    def kernel():
        return stripe_counts(toks, vocab, window)

    def plain():
        return stripe_counts_plain(toks, vocab, window)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max_err(got, ref)
    ok = bool(torch.equal(got, ref)) and bool(torch.equal(got, got.T))
    # the yardstick: ONE bincount of the precomputed pair ids a*V + b, both
    # directions, over the pairs whose ids both lie in [0, V)
    t = toks.long()
    n = t.numel()
    pair_ids = []
    for j in range(1, window + 1):
        a, b = t[:n - j], t[j:]
        keep = (a >= 0) & (a < vocab) & (b >= 0) & (b < vocab)
        a, b = a[keep], b[keep]
        pair_ids += [a * vocab + b, b * vocab + a]
    ids = torch.cat(pair_ids)
    del pair_ids

    def library():
        return torch.bincount(ids, minlength=vocab * vocab)

    ms, plain_ms, library_ms = _time_three(kernel, plain, library, 5)
    nbytes = 4 * n + 4 * vocab * vocab
    # bincount reads its input's max on the host, so it cannot be captured
    # in a CUDA graph: no device time for the yardstick
    return dict(name=name, ok=ok, max_abs_err=err, tolerance="exact",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=graph_ms(kernel, iters=5), library_device_ms=None,
                cuda_launches=cuda_launches(kernel),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
                pairs=int(ids.numel()) // 2, path=path)


# flash_attention cases: (name, B, H, KV, Sq, Sk, d, dtype, causal); case a
# is the prefill path's shape (4 prompts x a 64-token bucket, qwen3-0.6b),
# case i the same bucket at qwen2-moe-a2.7b's heads (16 / 16 x 128, MHA)
FLASH_CASES = [
    ("a: prefill path B4 S64 H16/KV8 d128 bf16 causal", 4, 16, 8, 64, 64, 128,
     torch.bfloat16, True),
    ("b: B1 S4096 H16/KV8 d128 bf16 causal", 1, 16, 8, 4096, 4096, 128,
     torch.bfloat16, True),
    ("c: B1 S4096 H16/KV8 d128 f32 causal", 1, 16, 8, 4096, 4096, 128,
     torch.float32, True),
    ("d: B2 S1024 H16/KV8 d128 bf16 non-causal", 2, 16, 8, 1024, 1024, 128,
     torch.bfloat16, False),
    ("e: B2 S100 H4/KV2 d64 f32 causal (ragged edges)", 2, 4, 2, 100, 100,
     64, torch.float32, True),
    ("f: B1 Sq64 Sk192 H4/KV2 d128 f32 causal (top-left)", 1, 4, 2, 64, 192,
     128, torch.float32, True),
    ("g: qwen2.5-14b smoke heads B2 S100 H8/KV2 d8 bf16 causal", 2, 8, 2, 100,
     100, 8, torch.bfloat16, True),
    ("h: case a in f16 B4 S64 H16/KV8 d128 causal", 4, 16, 8, 64, 64, 128,
     torch.float16, True),
    ("i: qwen2-moe-a2.7b prefill path B4 S64 H16/KV16 d128 bf16 causal", 4,
     16, 16, 64, 64, 128, torch.bfloat16, True),
]
# f32: the same f32 sums in another order; bf16: one bf16 ulp of |o| ~ 2-4;
# f16: two f16 ulps of |o| ~ 2-4, below the error of the same inputs run at
# bf16 precision (checked per f16 case)
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2,
              torch.float16: 4e-3}
# 16-bit inputs: the largest share of output elements that may differ from
# the plain version's; a kernel that rounded p to one 16-bit value (the
# control, checked per case) differs in more
FLASH_DIFFER_SHARE = 0.02


def flash_work(B, H, Sq, Sk, d, causal):
    """Multiply-adds x 2 of q k^T and p v over the (query, key) pairs the
    mask keeps (top-left causal: query i sees keys 0..min(i, Sk - 1))."""
    return 4 * B * H * window_pairs(Sq, Sk, causal, None) * d


def plain_p_rounded(q, k, v, causal, q_offset=None, window=None):
    """The plain contract with p rounded once to q's 16-bit dtype before
    p v: what a kernel without the p_hi + p_lo split computes."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, KV, H // KV, Sq, d)
    kf = k.to(torch.float32)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        if q_offset is not None:
            q_pos = (q_offset.long()[:, None] + q_pos)[:, None, None]
        k_pos = torch.arange(Sk, device=q.device)
        drop = k_pos > q_pos[..., None]
        if window is not None:
            drop |= k_pos <= q_pos[..., None] - window
        s = s.masked_fill(drop, -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(q.dtype).to(torch.float32),
                     v.to(torch.float32)[:, :, None])
    return (o / p.sum(dim=-1, keepdim=True)).reshape(
        B, H, Sq, v.shape[-1]).to(q.dtype)


def differ_share(a, b) -> float:
    return float((a != b).float().mean())


def run_flash_case(case, gen, dev) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    name, B, H, KV, Sq, Sk, d, dtype, causal = case
    q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]

    def kernel():
        return flash_attention(q, k, v, causal=causal)

    def plain():
        return flash_attention_plain(q, k, v, causal=causal)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max_err(got, ref)
    atol = FLASH_ATOL[dtype]
    ok = err <= atol
    controls = {}
    if dtype != torch.float32:
        # the checks must be able to fail a lower precision: p rounded to
        # one 16-bit value, and (f16) the same inputs run at bf16 precision
        share = differ_share(got, ref)
        controls["differ_share"] = share
        controls["p_rounded_share"] = differ_share(
            plain_p_rounded(q, k, v, causal), ref)
        ok &= share <= FLASH_DIFFER_SHARE < controls["p_rounded_share"]
        if dtype == torch.float16:
            at_bf16 = flash_attention(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), causal=causal)
            controls["bf16_err"] = max_err(at_bf16.to(dtype), ref)
            ok &= controls["bf16_err"] > atol
    iters = 5 if Sq >= 1024 else 50
    ms = cuda_ms(kernel, iters)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(plain, iters)
    library_ms = library_device_ms = None
    # the yardstick's is_causal mask is ours only at Sq == Sk; without a
    # mask any lengths
    if Sq == Sk or not causal:
        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        library_ms = cuda_ms(library, iters)
        library_device_ms = graph_ms(library)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = flash_work(B, H, Sq, Sk, d, causal)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(name=name, ok=ok, max_abs_err=err, tolerance=f"atol={atol}",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                flops=flops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                controls=controls, path=name.startswith("a:"))


def print_row(kernel: str, row: dict) -> None:
    print(f"kernel {kernel} [{row['name']}]: "
          f"{'OK' if row['ok'] else 'MISMATCH'} "
          f"max_abs_err={row['max_abs_err']} ({row['tolerance']}) "
          f"kernel_ms={row['ms']} plain_ms={row['plain_ms']} "
          f"library_ms={row['library_ms']} bound_ms={row['bound_ms']}"
          f" bound_by={row.get('bound_by', 'bytes')}"
          + (f" device_ms={row['device_ms']} library_device_ms="
             f"{row['library_device_ms']} cuda_launches="
             f"{row['cuda_launches']}" if "cuda_launches" in row else ""),
          flush=True)


# ---------------------------------------------------------------------------
# phase 5: stream stats at the trainer's data shape
# ---------------------------------------------------------------------------

def stream_stats_phase(batches, dev) -> dict:
    from repro_torch.core import tree_fold
    from repro_torch.data import (init_stats, make_stream_stats,
                                  packed_stats, summarize, update_stats)
    from repro_torch.kernels.cms import cms_counts
    from repro_torch.kernels.segment_fold import segment_fold

    m = make_stream_stats()
    state = init_stats(m, device=dev)
    update_stats(init_stats(m, device=dev), *batches[0])   # warm-up
    torch.cuda.synchronize()
    cms_counts.launches = 0
    segment_fold.launches = 0
    t0 = time.perf_counter()
    packed = []
    for toks, mask in batches:
        state = update_stats(state, toks, valid_mask=mask)
        packed.append(packed_stats(toks, mask))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cms_update": cms_counts.launches,
                "segment_fold": segment_fold.launches}
    n_tokens = sum(int(t.numel()) for t, _ in batches)
    valid = sum(int(mask.sum()) for _, mask in batches)
    if launches["cms_update"] != len(batches):
        raise RuntimeError(f"cms_update launched {launches['cms_update']} "
                           f"times over {len(batches)} batches")
    if launches["segment_fold"] != len(batches):
        raise RuntimeError(f"packed_stats launched segment_fold "
                           f"{launches['segment_fold']} times over "
                           f"{len(batches)} batches")
    if int(state["count"]) != valid:
        raise RuntimeError(f"token count {int(state['count'])} != valid "
                           f"tokens {valid}")
    # every batch's per-row packed_stats == the CPU run on the same batch
    # == the direct count (real tokens and EOS tokens per row)
    for i, ((toks, mask), got) in enumerate(zip(batches, packed)):
        cpu_out = packed_stats(toks.cpu(), mask.cpu())
        keep = mask.to(torch.bool)
        want = {"tokens": keep.sum(1).to(torch.int32),
                "docs": (keep & (toks == 0)).sum(1).to(torch.int32)}
        for col in ("tokens", "docs"):
            if not (torch.equal(got[col].cpu(), cpu_out[col])
                    and torch.equal(got[col], want[col])):
                raise RuntimeError(f"packed_stats[{col!r}] of batch {i}: "
                                   "card != cpu or != the direct count")

    # the streamed state == the tree fold of per-batch states
    per_batch = [update_stats(init_stats(m, device=dev), t, valid_mask=v)
                 for t, v in batches]
    folded = tree_fold(m, pytree.tree_map(lambda *xs: torch.stack(xs),
                                          *per_batch))
    for k in state:
        if not torch.equal(state[k], folded[k]):
            raise RuntimeError(f"streamed {k} != tree-folded {k}")
    # the card's state after the first 2 batches == the CPU's, bit for bit
    card = init_stats(m, device=dev)
    cpu = init_stats(m, device="cpu")
    for toks, mask in batches[:2]:
        card = update_stats(card, toks, valid_mask=mask)
        cpu = update_stats(cpu, toks.cpu(), valid_mask=mask.cpu())
    for k in cpu:
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise RuntimeError(f"card {k} != cpu {k} after 2 batches")
    summary = summarize(m, state)
    print(f"stream stats: batches={len(batches)} positions={n_tokens} "
          f"valid_tokens={valid} wall_s={wall} "
          f"tokens_per_s={n_tokens / wall} valid_tokens_per_s={valid / wall} "
          f"launches={launches} approx_distinct={summary['approx_distinct']} "
          "card==cpu after 2 batches, streamed==tree-folded, per-row "
          "packed_stats==cpu==direct count", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: MapReduce jobs (Algorithms 1, 3, 4) and word count
# ---------------------------------------------------------------------------

def mapreduce_phase(seed: int, dev, stream_tokens) -> int:
    """Mean-by-key (Algorithms 1/3/4) and max-by-key against float64 /
    numpy oracles, each run's segment_fold launches counted against the
    tier its plan chose: mean's int32 count leaf keeps it on the exact
    segment tier (the reference's ``_kernel_exact`` rule), max-by-key (all
    float32) rides the kernel tier."""
    from repro_torch.core import (MapReduceJob, average_by_key_job, monoids,
                                  word_count_job)
    from repro_torch.kernels.segment_fold import segment_fold

    keys_np, vals_np = mapreduce_records(seed)
    n, k, shards = keys_np.size, 65536, 8
    records = {"key": torch.from_numpy(keys_np).to(dev),
               "value": torch.from_numpy(vals_np).to(dev)}
    mean_job = average_by_key_job(k)
    max_job = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                           monoid=monoids.max_, num_keys=k)
    kernel_launches = 0
    for job, strategy, count in (
            (mean_job, "naive", n), (mean_job, "combiner", n),
            (mean_job, "in_mapper", 1 << 12), (max_job, "naive", n),
            (max_job, "combiner", n)):
        recs = {key: v[:count] for key, v in records.items()}
        job.run_local(recs, strategy=strategy, num_shards=shards)  # warm-up
        torch.cuda.synchronize()
        segment_fold.launches = 0
        t0 = time.perf_counter()
        out = job.run_local(recs, strategy=strategy, num_shards=shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segment_fold.launches
        st = job.stats(recs, strategy=strategy,
                       num_shards=shards).with_measured(wall * 1e6)
        tier = job.plan(recs, strategy=strategy,
                        num_shards=shards).local_tier.kind
        want = 0 if tier != "kernel" else (1 if strategy == "naive"
                                           else shards)
        if launches != want or (job is max_job and tier != "kernel"):
            raise RuntimeError(f"{job.monoid.name} {strategy}: segment_fold "
                               f"launched {launches} times on the {tier} "
                               f"tier, expected {want}")
        kernel_launches += launches
        got = out.cpu().numpy().astype(np.float64)
        if job is mean_job:
            sums = np.zeros(k, np.float64)
            np.add.at(sums, keys_np[:count],
                      vals_np[:count].astype(np.float64))
            cnt = np.maximum(np.bincount(keys_np[:count], minlength=k), 1)
            oracle = sums / cnt
        else:
            oracle = np.full(k, -np.inf)
            np.maximum.at(oracle, keys_np[:count],
                          vals_np[:count].astype(np.float64))
        err = float(np.abs(np.where(np.isinf(oracle), 0.0, got - oracle)
                           ).max())
        if not err <= 1e-4 or not np.array_equal(np.isinf(got),
                                                 np.isinf(oracle)):
            raise RuntimeError(f"{job.monoid.name} {strategy}: max |out - "
                               f"oracle| = {err}")
        print(f"mapreduce {job.monoid.name}_by_key {strategy}: "
              f"records={count} shards={shards} keys={k} tier={tier} "
              f"wall_s={wall} us_per_record={wall / count * 1e6} "
              f"segment_fold.launches={launches} max_abs_err_vs_f64={err} "
              f"model_error(measured/predicted)={st.model_error()} "
              f"stats={st}", flush=True)

    wc = word_count_job(151936)
    counts = wc.run_local(stream_tokens, strategy="combiner", num_shards=8)
    want = np.bincount(stream_tokens.cpu().numpy(), minlength=151936)
    if not np.array_equal(counts.cpu().numpy(), want):
        raise RuntimeError("word count != np.bincount")
    st = wc.stats(stream_tokens, strategy="combiner", num_shards=8)
    print(f"mapreduce word_count: tokens={stream_tokens.numel()} "
          f"vocab=151936 == np.bincount; plan: {st.plan}", flush=True)
    return kernel_launches


# ---------------------------------------------------------------------------
# phase 7: Algorithm 5 co-occurrence through the stripes kernel
# ---------------------------------------------------------------------------

def algorithm5_phase(tokens, vocab: int, window: int) -> int:
    from repro_torch.core import monoids
    from repro_torch.kernels.stripes import stripe_counts, stripe_counts_plain

    stripe_counts.launches = 0
    t0 = time.perf_counter()
    table = monoids.cooccurrence_stripes(tokens, vocab, window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stripe_counts.launches
    if launches != 1:
        raise RuntimeError(f"stripes launched {launches} times, expected 1")
    if not torch.equal(table, stripe_counts_plain(tokens, vocab, window)):
        raise RuntimeError("cooccurrence_stripes != the plain version")
    print(f"algorithm 5: cooccurrence_stripes N={tokens.numel()} V={vocab} "
          f"window={window} wall_s={wall} pairs={int(table.sum()) // 2} "
          f"stripe_counts.launches={launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the radix prefix cache (warm prefill on flash_attention with
# per-row query offsets)
# ---------------------------------------------------------------------------

# (name, B, H, KV, Sq, Sk, d, dtype, offsets): the serve config's warm call
# (phase 3's config: a 16-token suffix bucket over a 96-row cache) in each
# float type, and a long one
FLASH_OFFSET_CASES = [
    ("warm: serve config B4 Sq16 Sk96 H16/KV8 d128 bf16 offsets 0/20/44/60",
     4, 16, 8, 16, 96, 128, torch.bfloat16, (0, 20, 44, 60)),
    ("warm: serve config B4 Sq16 Sk96 H16/KV8 d128 f16 offsets 0/20/44/60",
     4, 16, 8, 16, 96, 128, torch.float16, (0, 20, 44, 60)),
    ("warm: serve config B4 Sq16 Sk96 H16/KV8 d128 f32 offsets 0/20/44/60",
     4, 16, 8, 16, 96, 128, torch.float32, (0, 20, 44, 60)),
    ("long: B2 Sq128 Sk4096 H16/KV8 d128 bf16 offsets 3968/2000", 2, 16, 8,
     128, 4096, 128, torch.bfloat16, (3968, 2000)),
]


def run_flash_offset_case(case, gen, dev) -> dict:
    """``flash_attention`` with per-row query offsets against its plain
    version (phase 2's tolerances and 16-bit controls); offsets all zero
    must give the top-left call's output bit for bit.  SDPA with the same
    mask as an explicit boolean tensor is timed only."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    name, B, H, KV, Sq, Sk, d, dtype, offsets = case
    q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)

    def kernel():
        return flash_attention(q, k, v, q_offset=off)

    def plain():
        return flash_attention_plain(q, k, v, q_offset=off)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max_err(got, ref)
    atol = FLASH_ATOL[dtype]
    ok = err <= atol
    controls = {}
    zero = torch.zeros_like(off)
    controls["zero_offsets_bitwise"] = bool(torch.equal(
        flash_attention(q, k, v, q_offset=zero), flash_attention(q, k, v)))
    ok &= controls["zero_offsets_bitwise"]
    if dtype != torch.float32:
        share = differ_share(got, ref)
        controls["differ_share"] = share
        controls["p_rounded_share"] = differ_share(
            plain_p_rounded(q, k, v, True, off), ref)
        ok &= share <= FLASH_DIFFER_SHARE < controls["p_rounded_share"]
        if dtype == torch.float16:
            at_bf16 = flash_attention(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), q_offset=off)
            controls["bf16_err"] = max_err(at_bf16.to(dtype), ref)
            ok &= controls["bf16_err"] > atol
    iters = 5 if Sk >= 1024 else 50
    ms = cuda_ms(kernel, iters)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(plain, iters)
    q_pos = off.long()[:, None] + torch.arange(Sq, device=dev)
    mask = (torch.arange(Sk, device=dev) <= q_pos[..., None])[:, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    library_ms = cuda_ms(library, iters)
    library_device_ms = graph_ms(library)
    # the keys the offsets let each row read, and the (query, key) pairs
    keys = sum(min(o + Sq, Sk) for o in offsets)
    pairs = sum(int(np.minimum(o + np.arange(Sq) + 1, Sk).sum())
                for o in offsets)
    nbytes = (2 * q.numel() + 2 * keys * KV * d) * q.element_size()
    flops = 4 * H * pairs * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(name=name, ok=ok, max_abs_err=err, tolerance=f"atol={atol}",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                flops=flops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                controls=controls)


# sliding-window cases (phase 8, continued): (name, B, H, KV, Sq, Sk, d,
# dtype, offsets or None, window), gemma3-1b's heads (4 / 1 x 256, bf16,
# window 512): its cold prefill at the largest bucket of phase 9, a length
# that is no tile multiple, its warm prefill over the 1024-row cache, and a
# window as long as the cache
FLASH_WINDOW_CASES = [
    ("w1: gemma3-1b cold prefill B4 S1024 H4/KV1 d256 bf16 window 512", 4, 4,
     1, 1024, 1024, 256, torch.bfloat16, None, 512),
    ("w2: B4 S600 H4/KV1 d256 bf16 window 512 (ragged)", 4, 4, 1, 600, 600,
     256, torch.bfloat16, None, 512),
    ("w3: gemma3-1b warm prefill B4 Sq128 Sk1024 H4/KV1 d256 bf16 offsets "
     "0/300/600/896 window 512", 4, 4, 1, 128, 1024, 256, torch.bfloat16,
     (0, 300, 600, 896), 512),
    ("w4: w3 with window 1024 = Sk (no key below any window)", 4, 4, 1, 128,
     1024, 256, torch.bfloat16, (0, 300, 600, 896), 1024),
]


def window_work(B, Sq, Sk, offsets, window):
    """Per row: the keys some query reads ([first live key, last live key])
    and the (query, key) pairs the mask keeps, each query at offset + i
    keeping qp - window < k <= qp."""
    keys = pairs = 0
    for b in range(B):
        off = 0 if offsets is None else offsets[b]
        qp = off + np.arange(Sq)
        lo = np.maximum(qp - window + 1, 0)
        hi = np.minimum(qp + 1, Sk)
        pairs += int(np.maximum(hi - lo, 0).sum())
        keys += max(0, int(hi.max()) - int(lo.min()))
    return keys, pairs


def run_flash_window_case(case, gen, dev) -> dict:
    """``flash_attention(window=)`` against its plain version with phase 2's
    tolerances and 16-bit controls; ``window >= Sk`` must give the
    windowless call's output bit for bit, kernel and plain version alike.
    SDPA with the same boolean mask is timed only, and the same call without
    a window is timed beside it (device time: the tiles below the window are
    skipped, not masked)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    name, B, H, KV, Sq, Sk, d, dtype, offsets, window = case
    q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    off = None if offsets is None else torch.tensor(offsets, dtype=torch.int32,
                                                    device=dev)

    def kernel():
        return flash_attention(q, k, v, q_offset=off, window=window)

    def plain():
        return flash_attention_plain(q, k, v, q_offset=off, window=window)

    def no_window():
        return flash_attention(q, k, v, q_offset=off)

    before = flash_attention.launches
    got = kernel()
    torch.cuda.synchronize()
    launched = flash_attention.launches - before
    ref = plain()
    err = max_err(got, ref)
    atol = FLASH_ATOL[dtype]
    ok = err <= atol and launched == 1
    controls = {"launches": launched}
    share = differ_share(got, ref)
    controls["differ_share"] = share
    controls["p_rounded_share"] = differ_share(
        plain_p_rounded(q, k, v, True, off, window), ref)
    ok &= share <= FLASH_DIFFER_SHARE < controls["p_rounded_share"]
    if window >= Sk:
        controls["kernel_equals_windowless_bitwise"] = bool(
            torch.equal(got, no_window()))
        controls["plain_equals_windowless_bitwise"] = bool(torch.equal(
            ref, flash_attention_plain(q, k, v, q_offset=off)))
        ok &= controls["kernel_equals_windowless_bitwise"] and \
            controls["plain_equals_windowless_bitwise"]
    iters = 20
    ms = cuda_ms(kernel, iters)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(plain, 3)
    no_window_device_ms = graph_ms(no_window)
    q_pos = torch.arange(Sq, device=dev).expand(B, Sq) if off is None else \
        off.long()[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = ((k_pos <= q_pos[..., None]) &
            (k_pos > q_pos[..., None] - window))[:, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    library_ms = cuda_ms(library, iters)
    library_device_ms = graph_ms(library)
    keys, pairs = window_work(B, Sq, Sk, offsets, window)
    nbytes = (2 * q.numel() + 2 * keys * KV * d) * q.element_size()
    flops = 4 * H * pairs * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(name=name, ok=ok, max_abs_err=err, tolerance=f"atol={atol}",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                no_window_device_ms=no_window_device_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                flops=flops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                controls=controls)


def window_cases(gen, dev):
    """Phase 8, continued: every window case, printed; w1's device time
    against the same call without a window must show the tiles below the
    window skipped (< 0.9: masking them would cost as much as reading
    them)."""
    rows = [run_flash_window_case(case, gen, dev)
            for case in FLASH_WINDOW_CASES]
    for row in rows:
        print_row("flash_attention", row)
        print(f"  flops={row['flops']} bytes={row['bound_bytes']} "
              f"device_ms={row['device_ms']} (graph replay; SDPA "
              f"{row['library_device_ms']}; no window "
              f"{row['no_window_device_ms']})"
              + "".join(f" {k}={v}" for k, v in row["controls"].items()),
              flush=True)
    w1 = rows[0]
    ratio = w1["device_ms"] / w1["no_window_device_ms"]
    keys, pairs = window_work(4, 1024, 1024, None, 512)
    print(f"w1 device time with window 512 / without: {ratio} (the live "
          f"pairs' share: {pairs / (4 * 1024 * 1025 / 2)})", flush=True)
    if ratio >= 0.9:
        raise RuntimeError(f"w1 with a window takes {ratio} of the "
                           "windowless call's device time: the tiles below "
                           "the window are read")
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"window cases disagree with the plain version: "
                           f"{bad}")
    return rows


def cache_reference(args, arch, prompts, buckets, label):
    """``arch``'s smoke model in float32 with the prefix cache on, over
    shared-prefix ``prompts``: the card's tokens == the CPU's and == cold
    (cache off) CPU and card engines' (greedy and at temperature 0.8),
    logprob sums within 1e-3; each card prefill launches flash_attention
    once per layer; a subscribed WindowedMetrics counts every served token
    and the engine's prefix hits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousEngine, ServeConfig,
                                     WindowedMetrics, make_backend)

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(args.seed)
    params_cpu = init_params(cfg, gen, device="cpu")
    params_gpu = pytree.tree_map(lambda t: t.to("cuda"), params_cpu)
    for temperature in (0.0, 0.8):
        out, hits = {}, {}
        for name, dev, params, on in (("cpu", "cpu", params_cpu, True),
                                      ("cpu cold", "cpu", params_cpu, False),
                                      ("cuda", "cuda", params_gpu, True),
                                      ("cuda cold", "cuda", params_gpu,
                                       False)):
            config = ServeConfig(arch=arch, num_slots=3,
                                 prefill_buckets=buckets, max_new_tokens=6,
                                 prefill_batch=2, seed=args.seed,
                                 temperature=temperature, prefix_cache=on)
            eng = ContinuousEngine(make_backend(cfg, params, config, dev),
                                   config)
            metrics = WindowedMetrics(window=4, device=dev)
            eng.subscribe(metrics.observe)
            uids = [eng.submit(p, user=i % 3) for i, p in enumerate(prompts)]
            before = flash_attention.launches
            for _ in eng.run(max_steps=300):
                pass
            launched = flash_attention.launches - before
            want = cfg.num_layers * eng.stats.prefill_calls \
                if dev == "cuda" else 0
            if launched != want:
                raise RuntimeError(f"{name}: flash_attention launched "
                                   f"{launched} times, expected {want}")
            out[name] = [eng.result(u) for u in uids]
            hits[name] = eng.prefix.stats.hit_tokens if on else 0
            served = sum(len(r.tokens) for r in out[name])
            fp = metrics.fleet_prefix()
            if metrics.fleet_tokens() != served or \
                    fp["hit_tokens"] != hits[name]:
                raise RuntimeError(
                    f"{name}: WindowedMetrics counts {metrics.fleet_tokens()} "
                    f"tokens and {fp['hit_tokens']} hit tokens; the engine "
                    f"served {served} and hit {hits[name]}")
        if hits["cuda"] <= 0 or hits["cuda"] != hits["cpu"]:
            raise RuntimeError(f"prefix hits: cuda {hits['cuda']}, cpu "
                               f"{hits['cpu']}")
        worst = {}
        for other in ("cpu", "cpu cold", "cuda cold"):
            worst[other] = 0.0
            for a, b in zip(out[other], out["cuda"]):
                if a.tokens != b.tokens or a.stopped != b.stopped:
                    raise RuntimeError(
                        f"temperature {temperature}: warm cuda tokens "
                        f"{b.tokens} != {other} tokens {a.tokens}")
                worst[other] = max(worst[other],
                                   abs(a.logprob_sum - b.logprob_sum))
            if worst[other] > 1e-3:
                raise RuntimeError(f"temperature {temperature}: logprob sums "
                                   f"differ from {other} by {worst[other]}")
        print(f"{label}: f32 smoke model, temperature {temperature}, "
              f"{len(prompts)} requests, {hits['cuda']} prompt tokens from "
              f"the trie; warm cuda tokens == cpu tokens (max "
              f"|logprob_sum diff| {worst['cpu']}) == cold cpu tokens "
              f"({worst['cpu cold']}) == cold cuda tokens "
              f"({worst['cuda cold']}); WindowedMetrics fleet tokens == "
              f"tokens served, fleet hit tokens == the engine's", flush=True)


def prefix_reference(args):
    """qwen3-0.6b's smoke model over prompts of which 75% open with one
    8-token prefix (``cache_reference``)."""
    from repro_torch.configs import get_config

    vocab = get_config("qwen3-0.6b", smoke=True).vocab_size
    rng = np.random.default_rng(args.seed + 8)
    shared = rng.integers(1, vocab, 8).tolist()
    prompts = [(shared if rng.random() < 0.75 else []) +
               rng.integers(1, vocab, int(rng.integers(1, 7))).tolist()
               for _ in range(9)]
    cache_reference(args, "qwen3-0.6b", prompts, (8, 16), "prefix reference")


def shared_prefix_trace(rng, vocab):
    """``benchmarks/bench_prefix.py``'s trace, draw for draw: 16 Poisson
    arrivals at 100 Hz; 75% of prompts open with one 12-token prefix and
    add 1-4 tokens, the rest are 2-4 random tokens; 4 new tokens each."""
    shared = rng.integers(1, vocab, 12).tolist()
    t, out = 0.0, []
    for _ in range(16):
        t += float(rng.exponential(1.0 / 100.0))
        if rng.random() < 0.75:
            suffix = rng.integers(1, vocab, int(rng.integers(1, 5))).tolist()
            prompt = shared + suffix
        else:
            prompt = rng.integers(1, vocab, int(rng.integers(2, 5))).tolist()
        out.append((t, prompt, 4, 0))
    return out


def _timed_calls(engine):
    """Wrap the engine's admission of one (k, bucket) chunk, the backend
    prefill inside it and the prefix-stats flush with wall clocks (each
    call synchronised); returns the dict they fill and an undo function."""
    times = {"prefill": {}, "admit": {}, "flush": []}
    be = engine.backend
    prefill, flush = be.prefill, engine.prefix and engine.prefix.flush_stats
    admit = engine._admit_chunk

    def timed_admit(jobs, bucket):
        t0 = time.perf_counter()
        admit(jobs, bucket)
        torch.cuda.synchronize()
        key = (len(jobs), bucket,
               "warm" if any(j.hit_len for j in jobs) else "cold")
        times["admit"].setdefault(key, []).append(
            (time.perf_counter() - t0) * 1e3)

    def timed_prefill(params, cache, toks, lengths, *prefix):
        t0 = time.perf_counter()
        out = prefill(params, cache, toks, lengths, *prefix)
        torch.cuda.synchronize()
        key = (*toks.shape, "warm" if prefix else "cold")
        times["prefill"].setdefault(key, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out

    def timed_flush():
        t0 = time.perf_counter()
        n = flush()
        torch.cuda.synchronize()
        times["flush"].append(((time.perf_counter() - t0) * 1e3, n))
        return n

    be.prefill = timed_prefill
    engine._admit_chunk = timed_admit
    if flush:
        engine.prefix.flush_stats = timed_flush

    def undo():
        be.prefill = prefill
        del engine._admit_chunk
        if flush:
            engine.prefix.flush_stats = flush
    return times, undo


def prefix_warm_cold(label, params, cfg, config, trace, flash_attention):
    """Two engines over the same weights, cache on (warm) and off (cold),
    over the identical trace: a warm-up pass each (every program shape
    runs; the warm engine's trie fills), then the measured passes (TTFT,
    hit rate, bytes saved, launches), then a pass with each prefill call
    and stats flush timed.  Returns the launches counted."""
    from repro_torch.serving import ContinuousEngine, make_backend, serve_trace

    engines = {}
    for name, on in (("warm", True), ("cold", False)):
        c = dataclasses.replace(config, prefix_cache=on)
        engines[name] = ContinuousEngine(
            make_backend(cfg, params, c, "cuda"), c)
    warm, cold = engines["warm"], engines["cold"]
    serve_trace(warm, trace)
    serve_trace(cold, trace)
    torch.cuda.synchronize()
    ps = warm.prefix.stats
    hit0 = (ps.hit_tokens, ps.prompt_tokens, ps.bytes_saved)
    results, launches = {}, {}
    for name in ("warm", "cold"):
        eng = engines[name]
        calls0 = eng.stats.prefill_calls
        flash_attention.launches = 0
        results[name], _ = serve_trace(eng, trace)
        torch.cuda.synchronize()
        flash = flash_attention.launches
        calls = eng.stats.prefill_calls - calls0
        if calls <= 0 or flash != cfg.num_layers * calls:
            raise RuntimeError(f"{label} {name}: flash_attention launched "
                               f"{flash} times over {calls} prefill calls "
                               f"({cfg.num_layers} layers)")
        launches[name] = (flash, calls)
        for r in results[name]:
            if any(not 0 <= t < cfg.vocab_size for t in r.tokens) or \
                    not math.isfinite(r.logprob_sum):
                raise RuntimeError(f"{label} {name}: bad result {r}")
        counts = eng.compile_counts()
        if sum(counts.values()) > eng.compile_bound():
            raise RuntimeError(f"{label} {name}: program shapes {counts} "
                               f"exceed the bound {eng.compile_bound()}")
    hit_tokens = ps.hit_tokens - hit0[0]
    prompt_tokens = ps.prompt_tokens - hit0[1]
    bytes_saved = ps.bytes_saved - hit0[2]
    if hit_tokens <= 0:
        raise RuntimeError(f"{label}: no prompt token came from the trie")
    if warm.prefix.accounted_bytes() != warm.prefix.total_bytes:
        raise RuntimeError(f"{label}: fold-accounted bytes "
                           f"{warm.prefix.accounted_bytes()} != resident "
                           f"{warm.prefix.total_bytes}")
    ttft = {n: np.array([r.ttft_s for r in results[n]]) * 1e3
            for n in results}
    p50 = {n: float(np.percentile(t, 50)) for n, t in ttft.items()}
    p99 = {n: float(np.percentile(t, 99)) for n, t in ttft.items()}
    ratio = p50["warm"] / p50["cold"]
    print(f"prefix {label}: ttft_p50_ms warm={p50['warm']} cold="
          f"{p50['cold']} warm/cold={ratio} (the reference's gate <= 0.6: "
          f"{'met' if ratio <= 0.6 else 'not met'}, not enforced) "
          f"ttft_p99_ms warm={p99['warm']} cold={p99['cold']} "
          f"hit_rate={hit_tokens / max(prompt_tokens, 1)} "
          f"hit_tokens={hit_tokens}/{prompt_tokens} bytes_saved="
          f"{bytes_saved} nodes={warm.prefix.node_count} resident="
          f"{warm.prefix.total_bytes} fold_accounted="
          f"{warm.prefix.accounted_bytes()} evictions={ps.evictions} "
          f"flash_attention.launches (launches, prefill calls)={launches} "
          f"program_shapes={warm.compile_counts()} (bound "
          f"{warm.compile_bound()})", flush=True)
    for name in ("warm", "cold"):
        times, undo = _timed_calls(engines[name])
        serve_trace(engines[name], trace)
        undo()
        per = {what: {f"k{k}_b{b}_{kind}": (len(v), float(np.median(v)))
                      for (k, b, kind), v in sorted(times[what].items())}
               for what in ("prefill", "admit")}
        line = f"prefix {label} {name}: eager wall ms per call (calls, " \
               f"median): prefill {per['prefill']}; the admission around " \
               f"it (prefix load, prefill, sampling, slot write, gather, " \
               f"trie insert) {per['admit']}"
        if times["flush"]:
            ms = [t for t, _ in times["flush"]]
            folds = sum(n for _, n in times["flush"])
            line += (f"; stats flush per step: mean_ms={float(np.mean(ms))}"
                     f" max_ms={max(ms)} steps={len(ms)} folds={folds}")
        print(line, flush=True)
    return sum(n for n, _ in launches.values())


def prefix_phase(args, engine, flash_attention, gen, dev):
    """Phase 8: the offset kernel cases, CPU and cold exactness, and warm
    against cold at full width on phase 3's weights (trace A:
    bench_prefix.py's; trace B: phase 3's config with a 48-token shared
    prefix).  Returns the kernel rows and the launches the warm paths
    made."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeConfig, poisson_trace

    rows = [run_flash_offset_case(case, gen, dev)
            for case in FLASH_OFFSET_CASES]
    for row in rows:
        print_row("flash_attention", row)
        print(f"  flops={row['flops']} bytes={row['bound_bytes']} "
              f"device_ms={row['device_ms']} (graph replay; SDPA with the "
              f"mask as a boolean tensor {row['library_device_ms']})"
              + "".join(f" {k}={v}" for k, v in row["controls"].items()),
              flush=True)
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention with query offsets disagrees "
                           f"with its plain version: {bad}")
    prefix_reference(args)

    cfg = get_config("qwen3-0.6b", smoke=False)
    params = engine.backend.params
    vocab = cfg.vocab_size
    trace_a = shared_prefix_trace(np.random.default_rng(args.seed), vocab)
    config_a = ServeConfig(arch="qwen3-0.6b", full=True, num_slots=4,
                           prefill_buckets=(4, 16), max_new_tokens=4,
                           prefill_batch=4, prefix_block=4, seed=args.seed)
    launches = prefix_warm_cold("trace A (bench_prefix.py)", params, cfg,
                                config_a, trace_a, flash_attention)
    trace_b = poisson_trace(np.random.default_rng(args.seed + 9), 16, 0.0,
                            56, 64, vocab, 32, shared_frac=0.75,
                            shared_len=48)
    launches += prefix_warm_cold("trace B (phase 3 config, 48-token shared "
                                 "prefix)", params, cfg, engine.config,
                                 trace_b, flash_attention)
    return rows, launches


# ---------------------------------------------------------------------------
# phase 9: gemma3-1b at full width through the serve CLI, with windows
# ---------------------------------------------------------------------------

GEMMA_CLI = ["--arch", "gemma3-1b", "--full", "--requests", "16", "--slots",
             "8", "--buckets", "256,512,1024", "--min-prompt", "520",
             "--max-prompt", "1000", "--gen", "32", "--rate", "0", "--users",
             "4", "--shared-frac", "0.5", "--shared-len", "640",
             "--temperature", "0"]


def gemma_reference(args):
    """The gemma3-1b smoke config (window 8) through ``cache_reference``:
    prompts of 12-40 tokens, most opening with a 16-token shared prefix, so
    cold and warm prefills both cross the window."""
    from repro_torch.configs import get_config

    vocab = get_config("gemma3-1b", smoke=True).vocab_size
    rng = np.random.default_rng(args.seed + 9)
    shared = rng.integers(1, vocab, 16).tolist()
    prompts = []
    for _ in range(10):
        n = int(rng.integers(12, 41))
        head = shared if n > 16 and rng.random() < 0.7 else []
        prompts.append(head + rng.integers(1, vocab, n - len(head)).tolist())
    cache_reference(args, "gemma3-1b", prompts, (16, 32, 48),
                    "gemma3 reference (window 8, prompts of 12-40 tokens)")


def gemma_phase(args, segment_fold, flash_attention):
    """gemma3-1b at full width (26 layers, 5:1 local:global, window 512,
    random weights from ``--seed``) through the serve CLI's own run; then
    the same trace on fresh engines with and without the WindowedMetrics
    subscription, the consumer's host time, the decode step eager against
    its CUDA-graph replay, and the tied-embedding ``unembed``'s share of
    it.  Returns (flash_attention launches, prefill calls)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_cli, serve_trace
    from repro_torch.models import num_params, unembed
    from repro_torch.serving import ContinuousEngine, WindowedMetrics

    segment_fold.launches = 0
    flash_attention.launches = 0
    run = run_cli(GEMMA_CLI + ["--seed", str(args.seed)])
    torch.cuda.synchronize()
    fold_launches = segment_fold.launches
    flash_launches = flash_attention.launches
    engine, metrics, results = run["engine"], run["metrics"], run["results"]
    cfg = get_config(engine.config.arch, smoke=not engine.config.full)
    st = engine.stats
    vocab, budget = cfg.vocab_size, engine.config.max_new_tokens
    if len(results) != len(run["trace"]):
        raise RuntimeError(f"{len(results)} of {len(run['trace'])} "
                           "completed")
    for r in results:
        if not (1 <= len(r.tokens) <= budget) or \
                not math.isfinite(r.logprob_sum):
            raise RuntimeError(f"bad result {r}")
        if any(not 0 <= t < vocab for t in r.tokens):
            raise RuntimeError(f"token outside the vocab in {r.tokens}")
        if len(r.tokens) < budget and not r.stopped:
            raise RuntimeError(f"uid {r.uid} ended early without eos")
    if st.prefill_calls <= 0 or \
            flash_launches != cfg.num_layers * st.prefill_calls:
        raise RuntimeError(f"flash_attention launched {flash_launches} times "
                           f"over {st.prefill_calls} prefill calls; each "
                           f"must launch it once per layer "
                           f"({cfg.num_layers})")
    if fold_launches <= 0 or fold_launches != st.steps:
        raise RuntimeError(f"segment_fold launched {fold_launches} times "
                           f"over {st.steps} decode steps")
    gen = sum(len(r.tokens) for r in results)
    ps, fp = engine.prefix.stats, metrics.fleet_prefix()
    if metrics.fleet_tokens() != gen or fp["hit_tokens"] != ps.hit_tokens:
        raise RuntimeError(f"WindowedMetrics: fleet tokens "
                           f"{metrics.fleet_tokens()} (served {gen}), hit "
                           f"tokens {fp['hit_tokens']} (engine "
                           f"{ps.hit_tokens})")
    if ps.hit_tokens <= 0:
        raise RuntimeError("no prompt token came from the trie")
    ttft = np.array([r.ttft_s for r in results])
    print(f"gemma3-1b serve (CLI): params={num_params(engine.backend.params)}"
          f" completed={len(results)} generated_tokens={gen} "
          f"wall_s={run['wall_s']} tokens_per_s={gen / run['wall_s']} "
          f"ttft_p50_ms={np.percentile(ttft, 50) * 1e3} "
          f"ttft_p99_ms={np.percentile(ttft, 99) * 1e3} "
          f"decode_steps={st.steps} prefill_calls={st.prefill_calls} "
          f"flash_attention.launches={flash_launches} (== {cfg.num_layers} "
          f"x prefill calls) segment_fold.launches={fold_launches} "
          f"hit_tokens={ps.hit_tokens}/{ps.prompt_tokens} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)

    # the same trace with and without the consumer, in turns (ABBA), each
    # on a fresh engine (an empty trie) over the CLI's weights
    config = engine.config
    for subscribed in (False, True, True, False):
        eng = ContinuousEngine(engine.backend, config)
        host_s = [0.0]
        if subscribed:
            m = WindowedMetrics(window=32, half_life_s=60.0,
                                device=eng.backend.device)

            def observe(ev, m=m):
                t0 = time.perf_counter()
                m.observe(ev)
                host_s[0] += time.perf_counter() - t0
            eng.subscribe(observe)
        res, wall = serve_trace(eng, run["trace"])
        torch.cuda.synchronize()
        toks = sum(len(r.tokens) for r in res)
        line = (f"gemma3-1b serve, WindowedMetrics "
                f"{'subscribed' if subscribed else 'not subscribed'}: "
                f"tokens_per_s={toks / wall} wall_s={wall} steps="
                f"{eng.stats.steps}")
        if subscribed:
            line += (f" consumer_host_ms_per_step="
                     f"{host_s[0] / eng.stats.steps * 1e3} "
                     f"consumer_host_us_per_event="
                     f"{host_s[0] / m.events * 1e6} events={m.events}")
        print(line, flush=True)
    # the same trace with the prefix cache off: at these prompt lengths the
    # default trie (256 nodes of 4 tokens) holds about one prompt, so what
    # its inserts, evictions and stats folds cost shows against this pass
    eng = ContinuousEngine(engine.backend,
                           dataclasses.replace(config, prefix_cache=False))
    res, wall = serve_trace(eng, run["trace"])
    torch.cuda.synchronize()
    ttft = np.array([r.ttft_s for r in res])
    print(f"gemma3-1b serve, prefix cache off: tokens_per_s="
          f"{sum(len(r.tokens) for r in res) / wall} wall_s={wall} "
          f"ttft_p50_ms={np.percentile(ttft, 50) * 1e3} ttft_p99_ms="
          f"{np.percentile(ttft, 99) * 1e3} steps={eng.stats.steps} "
          f"prefill_calls={eng.stats.prefill_calls} (cache on: stats folds "
          f"{ps.folds}, evictions {ps.evictions})", flush=True)

    step_graph_ms = decode_breakdown(engine)
    # the tied-embedding unembed (an f32 copy of the 262144 x 1152
    # embedding per call) on the decode step's (8, 1, 1152) hidden rows
    h = torch.randn((config.num_slots, 1, cfg.d_model),
                    device=engine.backend.device, dtype=cfg.dtype)
    params = engine.backend.params
    unembed_ms = graph_ms(lambda: unembed(params, cfg, h))
    print(f"gemma3-1b unembed (tied embedding cast to f32 per call): "
          f"device_ms={unembed_ms} of the decode step's graph replay "
          f"{step_graph_ms} ms: share={unembed_ms / step_graph_ms}",
          flush=True)
    return flash_launches


# ---------------------------------------------------------------------------
# phase 10: streaming windows on the card
# ---------------------------------------------------------------------------

def windows_phase(args, segment_fold, dev) -> int:
    """2**22 timestamped events through ``tumbling_fold`` (``sum_``,
    ``max_``) over 4096 windows and ``session_fold`` (``sum_``) over the
    sessions of 65536 users, each exact against a numpy oracle (float64
    sums at atol 1e-4; the values are integers in float32, so the kernel's
    float32 sums are exact too), ``segment_fold`` launched once per fold;
    then ``SlidingWindow(sum_, 32)`` over 10**4 events against a brute-force
    numpy window.  Returns the folds' ``segment_fold`` launches."""
    from repro_torch.core import monoids
    from repro_torch.data import (SlidingWindow, session_fold, sessionize,
                                  tumbling_fold)

    rng = np.random.default_rng(args.seed + 10)
    n, n_windows, width, n_users = 1 << 22, 4096, 0.37, 65536
    # timestamps run 0.1% past the last window: those events are masked
    ts = np.sort(rng.uniform(0.0, n_windows * width * 1.001, n))
    vals = rng.integers(-100, 101, n).astype(np.float32)
    users = rng.integers(0, n_users, n)
    vals_t = torch.from_numpy(vals).to(dev)
    ts_t = torch.from_numpy(ts).to(dev)

    ids = np.floor((ts.astype(np.float32) - np.float32(0.0))
                   / np.float32(width)).astype(np.int64)
    live = (ids >= 0) & (ids < n_windows)
    want_sum = np.bincount(ids[live], weights=vals[live].astype(np.float64),
                           minlength=n_windows)
    want_max = np.full(n_windows, -np.inf, np.float32)
    np.maximum.at(want_max, ids[live], vals[live])
    t0 = time.perf_counter()
    sids, n_sessions = sessionize(users, ts, gap=30.0)
    sessionize_s = time.perf_counter() - t0
    want_sessions = np.bincount(sids, weights=vals.astype(np.float64),
                                minlength=n_sessions)

    folds = {
        "tumbling sum_": lambda: tumbling_fold(
            monoids.sum_, vals_t, ts_t, width=width, num_windows=n_windows,
            with_plan=True),
        "tumbling max_": lambda: tumbling_fold(
            monoids.max_, vals_t, ts_t, width=width, num_windows=n_windows,
            with_plan=True),
        "session sum_": lambda: session_fold(
            monoids.sum_, vals_t, sids, n_sessions, with_plan=True),
    }
    wants = {"tumbling sum_": want_sum, "tumbling max_": want_max,
             "session sum_": want_sessions}
    segment_fold.launches = 0
    outs = {}
    for name, fold in folds.items():
        outs[name] = fold()
    torch.cuda.synchronize()
    launches = segment_fold.launches
    if launches != len(folds):
        raise RuntimeError(f"segment_fold launched {launches} times over "
                           f"{len(folds)} window folds")
    for name, (out, plan) in outs.items():
        got = out.cpu().numpy().astype(np.float64)
        want = wants[name]
        err = float(np.abs(got - want).max())
        exact = name == "tumbling max_"
        if plan.local_tier.kind != "kernel" or \
                (err != 0.0 if exact else err > 1e-4):
            raise RuntimeError(f"{name}: tier {plan.local_tier.kind}, max "
                               f"|err| {err} against the numpy oracle")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            folds[name]()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        print(f"windows: {name} over {n} events into {len(want)} "
              f"{'sessions' if 'session' in name else 'windows'}: plan "
              f"{plan.describe()} max_abs_err={err} (numpy oracle"
              f"{', exact' if exact else ', float64'}) wall_ms={wall * 1e3} "
              f"(median of 5) events_per_s={n / wall}", flush=True)
    print(f"windows: sessionize (host, numpy) of {n} events from {n_users} "
          f"users, gap 30 -> {n_sessions} sessions in {sessionize_s} s",
          flush=True)

    # the two-stacks sliding window on the card against brute force
    small = rng.integers(-100, 101, 10_000).astype(np.float32)
    win = SlidingWindow(monoids.sum_, 32, device=dev)
    small_t = torch.from_numpy(small).to(dev)
    t0 = time.perf_counter()
    for i in range(small.size):
        win.push(small_t[i])
        if i % 97 == 0 or i == small.size - 1:
            got = float(win.query())
            want = float(small[max(0, i - 31): i + 1].astype(np.float64)
                         .sum())
            if got != want:
                raise RuntimeError(f"SlidingWindow at event {i}: {got} != "
                                   f"brute force {want}")
    wall = time.perf_counter() - t0
    if win.flip_combines > win.pushes:
        raise RuntimeError("SlidingWindow flipped more than once per event")
    print(f"windows: SlidingWindow(sum_, 32) over {small.size} events on the "
          f"card == brute-force numpy window (checked every 97 events and "
          f"at the end); {win.flip_combines / win.pushes} flip combines per "
          f"event; wall_s={wall} ({wall / small.size * 1e6} us per push)",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the MoE family, qwen2-moe-a2.7b at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_CLI = ["--arch", MOE_ARCH, "--full", "--requests", "16", "--slots", "8",
           "--buckets", "16,32,64", "--min-prompt", "8", "--max-prompt",
           "64", "--gen", "32", "--rate", "0", "--temperature", "0"]


def grouped_tolerance(plain: torch.Tensor) -> float:
    """bf16 grouped products against the per-expert loop: 4 bf16 ulps of
    the largest output (both accumulate in float32, in other orders, and
    round the SwiGLU's hidden rows to bf16 before the down product)."""
    return 2.0 ** -5 * float(plain.abs().max())


def moe_layer_bytes(cfg, experts_hit: int) -> int:
    """Weight bytes one MoE layer must read: the router, the experts with
    rows (three D x F matrices each) and the shared experts."""
    size = cfg.dtype.itemsize
    D, Fe = cfg.d_model, cfg.d_ff_expert
    shared = 3 * D * Fe * cfg.num_shared_experts
    return size * (D * cfg.num_experts + experts_hit * 3 * D * Fe + shared)


def moe_grouped_cases(args, dev):
    """Phase 11(a): ``expert_compute`` (three ``grouped_mm`` products)
    against ``expert_compute_plain`` (one matmul per expert) on one
    full-width layer's experts (64 of 2048 x 1408, bf16, random weights),
    tokens routed by its router at the decode shape (8 slots x top-4) and
    the prefill's (4, 64) bucket x top-4.  The group sizes must equal
    ``bincount``'s and leave the 4 pad experts empty; the products must
    agree within ``grouped_tolerance``.  Times the grouped products, the
    loop and (graph replay) the grouped products' device time beside the
    bound: each expert with rows read once, the buffer read and the output
    written once, or the products' operations at the bf16 peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    p = moe.init_moe(cfg, gen, device=dev)
    D, Fe, k = cfg.d_model, cfg.d_ff_expert, cfg.moe_top_k
    rows = []
    for name, tokens in (("decode: 8 slots x top-4", 8),
                         ("prefill: (4, 64) bucket x top-4", 256)):
        x = torch.randn((tokens, D), generator=gen, device=dev).to(cfg.dtype)
        xbuf, gs, order, top_w = moe.dispatch(p, cfg, x)
        top_e, _ = moe.route(p, cfg, x)
        plain_gs = torch.bincount(top_e.reshape(-1).long(),
                                  minlength=cfg.num_experts).to(torch.int32)
        pads = int(gs[cfg.num_experts - cfg.num_padded_experts:].sum())
        if not torch.equal(gs, plain_gs) or pads:
            raise RuntimeError(f"expert_load {gs.tolist()} != bincount "
                               f"{plain_gs.tolist()} or pads routed ({pads})")
        got = moe.expert_compute(p, xbuf, gs)
        want = moe.expert_compute_plain(p, xbuf, gs)
        err, tol = max_err(got, want), grouped_tolerance(want)
        hit = int((gs > 0).sum())
        n = xbuf.shape[0]
        nbytes = cfg.dtype.itemsize * (hit * 3 * D * Fe + 2 * n * D)
        flops = 2 * 3 * n * D * Fe
        bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S, \
            flops / PEAK_FLOPS[cfg.dtype]
        row = {"name": name, "rows": n, "experts_hit": hit,
               "max_abs_err": err, "tolerance": tol, "ok": err <= tol,
               "differ_share": differ_share(got, want),
               "ms": cuda_ms(lambda: moe.expert_compute(p, xbuf, gs), 20),
               "plain_ms": cuda_ms(
                   lambda: moe.expert_compute_plain(p, xbuf, gs), 5),
               "device_ms": graph_ms(
                   lambda: moe.expert_compute(p, xbuf, gs)),
               "bound_ms": 1e3 * max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops else
               "operations"}
        print(f"grouped_mm [{name}]: {'OK' if row['ok'] else 'MISMATCH'} "
              f"rows={n} experts_hit={hit} expert_load == bincount, pads 0; "
              f"max_abs_err={err} (tolerance {tol}) differ_share="
              f"{row['differ_share']} ms={row['ms']} device_ms="
              f"{row['device_ms']} plain_ms={row['plain_ms']} (per-expert "
              f"loop) bound_ms={row['bound_ms']} bound_by={row['bound_by']}"
              f" bytes={nbytes} flops={flops}", flush=True)
        rows.append(row)
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"grouped_mm disagrees with the per-expert loop: "
                           f"{bad}")
    return rows


def moe_reference(args):
    """Phase 11(b): the qwen2-moe smoke model (8 experts, 1 pad, top-2, 2
    shared) through ``cache_reference``: card == CPU == cold tokens, greedy
    and at 0.8, over prompts of which 75% open with one 8-token prefix."""
    from repro_torch.configs import get_config

    vocab = get_config(MOE_ARCH, smoke=True).vocab_size
    rng = np.random.default_rng(args.seed + 11)
    shared = rng.integers(1, vocab, 8).tolist()
    prompts = [(shared if rng.random() < 0.75 else []) +
               rng.integers(1, vocab, int(rng.integers(1, 7))).tolist()
               for _ in range(9)]
    cache_reference(args, MOE_ARCH, prompts, (8, 16),
                    "moe reference (8 experts, 1 pad, top-2, 2 shared)")


def moe_layer_split(engine, cfg, tokens: int):
    """Device time (graph replay) of layer 0's MoE FFN on ``tokens`` rows of
    random hidden states, and of its parts: route + sort + gather
    (``dispatch``), the three grouped products, the ordered combine and the
    shared experts.  -> (whole layer ms, experts with rows)."""
    from repro_torch.models import moe

    p = engine.backend.params["layers"][0]["ffn"]
    dev = engine.backend.device
    gen = torch.Generator(device=dev).manual_seed(tokens)
    xf = torch.randn((tokens, cfg.d_model), generator=gen,
                     device=dev).to(cfg.dtype)
    xbuf, gs, order, top_w = moe.dispatch(p, cfg, xf)
    out_buf = moe.expert_compute(p, xbuf, gs)
    parts = {
        "route+sort": lambda: moe.dispatch(p, cfg, xf),
        "grouped products": lambda: moe.expert_compute(p, xbuf, gs),
        "combine": lambda: moe.combine(out_buf, order, top_w),
        "shared experts": lambda: moe.dense_ffn(p["shared"], cfg, xf),
        "whole layer": lambda: moe.moe_ffn_local(p, cfg, xf[None])}
    ms = {name: graph_ms(fn) for name, fn in parts.items()}
    hit = int((gs > 0).sum())
    print(f"{MOE_ARCH} MoE layer at {tokens} tokens (device ms, graph "
          f"replay; experts with rows {hit}): "
          + " ".join(f"{name.replace(' ', '_')}={v}" for name, v in
                     ms.items()), flush=True)
    return ms["whole layer"], hit


def moe_phase(args, segment_fold, flash_attention) -> None:
    """Phase 11(c): qwen2-moe-a2.7b at full width (24 layers, 60 + 4 pad
    experts of 2048 x 1408, top-4, 4 shared, bf16, random weights from
    ``--seed``) through the serve CLI's own run: 16 requests of 8-64
    tokens, 8 slots, buckets 16 / 32 / 64, 32 new tokens, greedy.
    ``flash_attention`` must launch 24 times per prefill call,
    ``segment_fold`` once per decode step and ``expert_compute`` (three
    grouped products) once per layer per decode step and prefill call.
    Then the decode step eager against its CUDA-graph replay beside its
    byte bound, and the MoE layer's device time split at the decode and
    prefill shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_cli
    from repro_torch.models import moe, num_params

    torch.cuda.reset_peak_memory_stats()
    segment_fold.launches = 0
    flash_attention.launches = 0
    moe.expert_compute.calls = 0
    t0 = time.perf_counter()
    run = run_cli(MOE_CLI + ["--seed", str(args.seed)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fold_launches = segment_fold.launches
    flash_launches = flash_attention.launches
    grouped_calls = moe.expert_compute.calls
    engine, results = run["engine"], run["results"]
    cfg = get_config(engine.config.arch, smoke=not engine.config.full)
    st = engine.stats
    vocab, budget = cfg.vocab_size, engine.config.max_new_tokens
    if len(results) != len(run["trace"]):
        raise RuntimeError(f"{len(results)} of {len(run['trace'])} "
                           "completed")
    for r in results:
        if not (1 <= len(r.tokens) <= budget) or \
                not math.isfinite(r.logprob_sum):
            raise RuntimeError(f"bad result {r}")
        if any(not 0 <= t < vocab for t in r.tokens):
            raise RuntimeError(f"token outside the vocab in {r.tokens}")
        if len(r.tokens) < budget and not r.stopped:
            raise RuntimeError(f"uid {r.uid} ended early without eos")
    if st.prefill_calls <= 0 or \
            flash_launches != cfg.num_layers * st.prefill_calls:
        raise RuntimeError(f"flash_attention launched {flash_launches} times "
                           f"over {st.prefill_calls} prefill calls; each "
                           f"must launch it once per layer "
                           f"({cfg.num_layers})")
    if fold_launches <= 0 or fold_launches != st.steps:
        raise RuntimeError(f"segment_fold launched {fold_launches} times "
                           f"over {st.steps} decode steps")
    if grouped_calls != cfg.num_layers * (st.steps + st.prefill_calls):
        raise RuntimeError(f"expert_compute ran {grouped_calls} times over "
                           f"{st.steps} steps and {st.prefill_calls} prefill "
                           f"calls of {cfg.num_layers} MoE layers")
    counts = engine.compile_counts()
    if sum(counts.values()) > engine.compile_bound():
        raise RuntimeError(f"program shapes {counts} exceed the bound "
                           f"{engine.compile_bound()}")
    gen = sum(len(r.tokens) for r in results)
    ttft = np.array([r.ttft_s for r in results])
    print(f"{MOE_ARCH} serve (CLI): params={num_params(engine.backend.params)}"
          f" active_params={cfg.num_active_params()} completed="
          f"{len(results)} generated_tokens={gen} wall_s={run['wall_s']} "
          f"tokens_per_s={gen / run['wall_s']} "
          f"ttft_p50_ms={np.percentile(ttft, 50) * 1e3} "
          f"ttft_p99_ms={np.percentile(ttft, 99) * 1e3} "
          f"decode_steps={st.steps} prefill_calls={st.prefill_calls} "
          f"flash_attention.launches={flash_launches} (== {cfg.num_layers} "
          f"x prefill calls) segment_fold.launches={fold_launches} (== "
          f"steps) grouped_mm products={3 * grouped_calls} (3 x "
          f"{cfg.num_layers} layers x (steps + prefill calls)) "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30} "
          f"cli_s={run_s}", flush=True)

    step_graph_ms = decode_breakdown(engine)
    layer_ms, hit = moe_layer_split(engine, cfg, engine.config.num_slots)
    k, bucket = engine.config.prefill_batch, engine.config.prefill_buckets[-1]
    _, prefill_hit = moe_layer_split(engine, cfg, k * bucket)
    # byte bounds: every layer's attention and MoE weights (as many experts
    # as layer 0 routed random rows of that shape to), and lm_head read
    # once at the model's dtype
    D, V, size = cfg.d_model, cfg.vocab_size, cfg.dtype.itemsize
    attn_bytes = size * (4 * D * cfg.num_heads * cfg.head_dim)
    unembed_bytes = D * V * size
    step_bytes = cfg.num_layers * (attn_bytes + moe_layer_bytes(cfg, hit)) \
        + unembed_bytes
    prefill_bytes = cfg.num_layers * (
        attn_bytes + moe_layer_bytes(cfg, prefill_hit)) + unembed_bytes
    print(f"{MOE_ARCH} decode step: graph_replay_ms={step_graph_ms} "
          f"bound_ms={1e3 * step_bytes / HBM_BYTES_PER_S} (bytes="
          f"{step_bytes}, {hit} experts per layer) moe_layers_ms="
          f"{cfg.num_layers * layer_ms} (estimate: {cfg.num_layers} x layer "
          f"0 replayed alone on random rows) moe_share_estimate="
          f"{cfg.num_layers * layer_ms / step_graph_ms}; ({k}, {bucket}) "
          f"prefill bound_ms={1e3 * prefill_bytes / HBM_BYTES_PER_S} (bytes="
          f"{prefill_bytes}, {prefill_hit} experts per layer)", flush=True)


# ---------------------------------------------------------------------------
# phase 12: the context-conditioned family (whisper-small, llama-3.2-vision)
# ---------------------------------------------------------------------------

# flash_attention at the context family's shapes (run_flash_case's tuple):
# whisper-small's encoder (8 x 1500 frames, 12 / 12 x 64), its decoder's
# cross-attention in forward (64 queries over the 1500 encoded frames) and
# llama-3.2-vision-90b's (64 queries over 1600 patches, 64 / 8 x 128)
FLASH_CONTEXT_CASES = [
    ("x1: whisper-small encoder B8 S1500 H12/KV12 d64 bf16 non-causal", 8,
     12, 12, 1500, 1500, 64, torch.bfloat16, False),
    ("x2: whisper-small cross-attention B8 Sq64 Sk1500 H12/KV12 d64 bf16 "
     "non-causal", 8, 12, 12, 64, 1500, 64, torch.bfloat16, False),
    ("x3: llama-3.2-vision cross-attention B4 Sq64 Sk1600 H64/KV8 d128 bf16 "
     "non-causal", 4, 64, 8, 64, 1600, 128, torch.bfloat16, False),
]
WHISPER = "whisper-small"
VISION = "llama-3.2-vision-90b"
CONTEXT_GATE = 0.5      # the reference's gates start at 0: tanh(0) hides xattn


def path_flash_cases(cases, what, gen, dev):
    """Phase 12(a) (cases x1-x3) and 13(a) (case j): each case through
    ``run_flash_case`` (phase 2's checks, SDPA as the yardstick); each call
    must be one ``flash_attention`` launch, and one kernel on the card
    wherever the profiler records the call (``cuda_launches`` None: not
    measured)."""
    from repro_torch.kernels.flash_attention import flash_attention

    rows = []
    for case in cases:
        row = run_flash_case(case, gen, dev)
        name, B, H, KV, Sq, Sk, d, dtype, causal = case
        q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, H, Sq, d), (B, KV, Sk, d),
                                 (B, KV, Sk, d))]
        before = flash_attention.launches
        flash_attention(q, k, v, causal=causal)
        row["launches"] = flash_attention.launches - before
        row["cuda_launches"] = cuda_launches(
            lambda: flash_attention(q, k, v, causal=causal))
        row["ok"] &= row["launches"] == 1 and \
            row["cuda_launches"] in (1, None)
        print_row("flash_attention", row)
        print(f"  launches={row['launches']} (wrapper count, one call; "
              f"cuda_launches None = the profiler recorded no event) "
              f"flops={row['flops']} bytes={row['bound_bytes']} "
              f"device_ms={row['device_ms']} (graph replay; SDPA "
              f"{row['library_device_ms']})"
              + "".join(f" {k}={v}" for k, v in row["controls"].items()),
              flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention at {what}: {bad}")
    return rows


def context_model(arch, seed, *, dtype=None, num_layers=None, device="cpu",
                  batch=2):
    """(cfg, params, context) of ``arch``: its smoke config, or with
    ``num_layers`` its full config at that depth, in ``dtype`` when given;
    random weights from ``seed`` on ``device`` with every cross-attention
    gate at ``CONTEXT_GATE``; a standard normal context of ``context_spec``
    for ``batch`` rows."""
    from repro_torch.configs import context_spec, get_config
    from repro_torch.models import init_params

    cfg = get_config(arch, smoke=num_layers is None)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    for layer in params["layers"]:
        for key in ("mix", "xattn"):
            if "gate" in layer.get(key, {}):
                layer[key]["gate"].fill_(CONTEXT_GATE)
    spec = context_spec(cfg, batch)
    context = torch.randn(spec.shape, generator=gen, device=device
                          ).to(spec.dtype)
    return cfg, params, context


def feed_prompt(cfg, params, cache, prompt):
    """``prompt`` (B, P) through the serve step (``decode_step`` over a
    cache with one position, which advances past the prompt in place) ->
    the greedy next token (B, 1)."""
    from repro_torch.models import decode_step

    for i in range(prompt.shape[1]):
        logits, new = decode_step(params, cfg, cache, prompt[:, i:i + 1])
        cache["pos"] = new["pos"]
    return logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)


def greedy_decode(cfg, params, cache, tok, steps):
    """``steps`` greedy tokens through the serve step from ``tok`` (B, 1)
    -> (B, steps) int64 tokens; the caller's cache keeps its ``pos``."""
    from repro_torch.models import decode_step

    out = []
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
    return torch.cat(out, 1).long()


def context_reference_run(arch, seed, steps=16):
    """Phase 12(b): ``arch``'s float32 smoke model on the card and on the
    CPU with the same weights (gates at ``CONTEXT_GATE``) and context:
    ``forward(context=)``'s logits agree at atol 1e-4, and the greedy
    tokens of ``steps`` serve steps from ``init_cache(context=)`` are
    equal.  -> (max logit difference, cpu tokens, card tokens, card
    flash_attention launches in forward)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward, init_cache, unembed

    cfg, params, context = context_model(arch, seed, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = pytree.tree_map(lambda t: t.to(dev), params)
        ctx, tk = context.to(dev), toks.to(dev)
        before = flash_attention.launches
        logits = unembed(p, cfg, forward(p, cfg, tk, context=ctx))
        launched = flash_attention.launches - before
        cache = init_cache(p, cfg, 2, 12 + steps, context=ctx)
        tokens = greedy_decode(cfg, p, cache, feed_prompt(cfg, p, cache, tk),
                               steps)
        out[dev] = (logits.cpu(), tokens.cpu(), launched)
    err = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    return err, out["cpu"][1], out["cuda"][1], out["cuda"][2]


def context_reference(args):
    """Phase 12(b) for both smoke configs; fails on a logit difference
    over 1e-4, unequal tokens, or a card forward that did not launch
    ``flash_attention`` once per attention (encoder, self, cross)."""
    from repro_torch.configs import get_config

    for arch in (WHISPER, VISION):
        cfg = get_config(arch, smoke=True)
        err, cpu_toks, gpu_toks, launched = context_reference_run(
            arch, args.seed)
        want = 2 * cfg.num_layers + cfg.encoder_layers \
            if cfg.decoder_cross_attn else cfg.num_layers
        ok = err <= 1e-4 and torch.equal(cpu_toks, gpu_toks) and \
            launched == want
        print(f"context reference ({cfg.name}, float32, gates "
              f"{CONTEXT_GATE}): {'OK' if ok else 'MISMATCH'} forward "
              f"logits max |card - cpu| = {err} (atol 1e-4); 16 greedy serve"
              f" steps card tokens == cpu tokens: "
              f"{torch.equal(cpu_toks, gpu_toks)}; flash_attention launches"
              f" in forward {launched} (want {want})", flush=True)
        if not ok:
            raise RuntimeError(f"{arch}: the card's float32 smoke model "
                               f"differs from the CPU's")


def decoder_step_bytes(cfg, params, cache) -> int:
    """Bytes one decode step must move: every decoder weight the step
    reads (a cross-attention's wk / wv are read only by ``init_cache``),
    ``lm_head`` once at the model's dtype, and every cache tensor (the
    self-attention rows the step scores and the context K/V)."""
    size = cfg.dtype.itemsize
    total = 0
    for i, layer in enumerate(params["layers"]):
        for key, sub in layer.items():
            if isinstance(sub, dict):
                skip = ("wk", "wv", "bk", "bv", "k_norm") if (
                    key == "xattn" or cfg.block_type(i) == "xattn") and \
                    key in ("mix", "xattn") else ()
                total += sum(t.numel() * t.element_size() for n, t in
                             sub.items() if n not in skip and
                             isinstance(t, torch.Tensor))
            else:
                total += sub.numel() * sub.element_size()
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    total += head.numel() * size + params["final_norm"].numel() * size
    total += sum(t.numel() * t.element_size()
                 for c in cache["layers"] for t in c.values())
    return total


def step_eager_vs_graph(cfg, params, cache, tok, iters=10):
    """The serve step's eager wall time and its CUDA-graph replay, and
    whether one replay from a copy of ``cache`` gives the eager step's
    logits and cache bit for bit.  -> (eager ms, replay ms, equal)."""
    from repro_torch.models import decode_step

    def copy(c):
        return pytree.tree_map(lambda t: t.clone(), c)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            decode_step(params, cfg, copy(cache), tok)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    work = copy(cache)
    t0 = time.perf_counter()
    for _ in range(iters):
        decode_step(params, cfg, work, tok)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / iters * 1e3
    del work
    eager_cache = copy(cache)
    want, _ = decode_step(params, cfg, eager_cache, tok)
    graph_cache = copy(cache)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = decode_step(params, cfg, graph_cache, tok)
    graph.replay()
    torch.cuda.synchronize()
    equal = torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(graph_cache), pytree.tree_leaves(eager_cache)))
    replay_ms = cuda_ms(graph.replay, iters)
    del graph, graph_cache, eager_cache
    return eager_ms, replay_ms, equal


def whisper_phase(args, flash_attention):
    """Phase 12(c): whisper-small at full width, nothing cut (12 + 12
    layers, d_model 768, 12 / 12 x 64 heads, vocab 51865, bf16, random
    weights from ``--seed``) through ``build_serve_step`` with 8 slots:
    ``make_cache`` encodes 8 x 1500 frames (12 launches), a 16-token prompt
    per slot then 64 greedy tokens through the step (no launch), the step
    eager against its CUDA-graph replay (equal bit for bit) and its byte
    bound, one ``forward(context=)`` of (8, 64) tokens (36 launches); then
    in float32 the last position's ``forward`` logits within 2e-2 of the
    decode loop's (the reference's bound)."""
    from repro_torch.models import (decode_step, forward, init_cache,
                                    num_params, unembed)
    from repro_torch.serving import ServeConfig, build_serve_step

    torch.cuda.reset_peak_memory_stats()
    config = ServeConfig(arch=WHISPER, full=True, num_slots=8,
                         prefill_buckets=(16,), max_new_tokens=64,
                         seed=args.seed)
    t0 = time.perf_counter()
    cfg, built, params, make_cache = build_serve_step(config, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: decoder {cfg.num_layers} layers, encoder "
          f"{cfg.encoder_layers} layers over {cfg.encoder_seq} frames, "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} (GELU, not gated) vocab="
          f"{cfg.vocab_size} {cfg.dtype} params={num_params(params)} slots="
          f"{built.num_slots} max_seq={built.max_seq} init_s="
          f"{time.perf_counter() - t0} (nothing cut)", flush=True)
    S, B, D = cfg.encoder_seq, built.num_slots, cfg.d_model
    make_cache()                        # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    cache = make_cache()
    torch.cuda.synchronize()
    encode_wall = (time.perf_counter() - t0) * 1e3
    encode_launches = flash_attention.launches
    encode_device = graph_ms(make_cache, iters=2, repeat=2)
    enc_products = 2 * B * S * cfg.encoder_layers * (
        4 * D * D + 2 * D * cfg.d_ff)
    enc_attn = cfg.encoder_layers * flash_work(B, cfg.num_heads, S, S,
                                               cfg.head_dim, False)
    kv_products = 2 * B * S * cfg.num_layers * 2 * D * cfg.num_kv_heads \
        * cfg.head_dim
    peak = PEAK_FLOPS[cfg.dtype]
    print(f"{cfg.name} make_cache (encode {B} x {S} frames, project the "
          f"cross K/V of {cfg.num_layers} layers): wall_ms={encode_wall} "
          f"device_ms={encode_device} (graph replay) bound_ms="
          f"{1e3 * (enc_products + enc_attn + kv_products) / peak} "
          f"(encoder products {1e3 * enc_products / peak} + attention "
          f"{1e3 * enc_attn / peak} + cross_kv {1e3 * kv_products / peak}) "
          f"flash_attention.launches={encode_launches} (want "
          f"{cfg.encoder_layers})", flush=True)
    if encode_launches != cfg.encoder_layers:
        raise RuntimeError(f"make_cache launched flash_attention "
                           f"{encode_launches} times; the encoder has "
                           f"{cfg.encoder_layers} layers")

    rng = np.random.default_rng(args.seed + 12)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 16))
                              .astype(np.int32)).cuda()
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = feed_prompt(cfg, params, cache, prompt)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = greedy_decode(cfg, params, cache, tok, 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if flash_attention.launches:
        raise RuntimeError(f"the decode loop launched flash_attention "
                           f"{flash_attention.launches} times (want 0)")
    if tokens.shape != (B, 64) or bool(((tokens < 0) |
                                        (tokens >= cfg.vocab_size)).any()):
        raise RuntimeError(f"bad tokens {tokens.shape}")
    print(f"{cfg.name} serve step: {B} slots, 16 prompt steps prompt_s="
          f"{prompt_s}, then 64 greedy steps wall_s={wall} tokens_per_s="
          f"{B * 64 / wall} flash_attention.launches=0 "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)
    tok = tokens[:, -1:].to(torch.int32)
    eager_ms, replay_ms, equal = step_eager_vs_graph(cfg, params, cache, tok)
    nbytes = decoder_step_bytes(cfg, params, cache)
    xkv = sum(c["xk"].numel() * 2 * c["xk"].element_size()
              for c in cache["layers"])
    print(f"{cfg.name} decode step ({B} slots, full width): eager_wall_ms="
          f"{eager_ms} graph_replay_ms={replay_ms} replay == eager bit for "
          f"bit: {equal} bound_ms={1e3 * nbytes / HBM_BYTES_PER_S} (bytes="
          f"{nbytes}, of which cross K/V {xkv}) host_bound_share="
          f"{1 - replay_ms / eager_ms}", flush=True)
    if not equal:
        raise RuntimeError("the whisper decode step's graph replay differs "
                           "from the eager step")
    del cache
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 12)
    context = torch.randn((B, S, D), generator=gen, device="cuda").to(
        cfg.dtype)
    toks = torch.randint(1, cfg.vocab_size, (B, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    forward(params, cfg, toks, context=context)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    forward(params, cfg, toks, context=context)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = flash_attention.launches
    want = cfg.encoder_layers + 2 * cfg.num_layers
    print(f"{cfg.name} forward(context=) of ({B}, 64) tokens: wall_ms="
          f"{fwd_ms} flash_attention.launches={fwd_launches} (want {want}: "
          f"{cfg.encoder_layers} encoder, {cfg.num_layers} self, "
          f"{cfg.num_layers} cross)", flush=True)
    if fwd_launches != want:
        raise RuntimeError(f"forward launched flash_attention {fwd_launches}"
                           f" times (want {want})")
    del params, context, built, make_cache
    torch.cuda.empty_cache()

    # float32 at full width: forward's last position against the decode
    # loop over the same tokens, the reference's bound 2e-2
    cfg32, p32, ctx32 = context_model(WHISPER, args.seed, dtype=torch.float32,
                                      num_layers=cfg.num_layers,
                                      device="cuda", batch=B)
    flash_attention.launches = 0
    full = unembed(p32, cfg32, forward(p32, cfg32, toks, context=ctx32))
    launched = flash_attention.launches
    cache = init_cache(p32, cfg32, B, 64, context=ctx32)
    for i in range(64):
        logits, cache = decode_step(p32, cfg32, cache, toks[:, i:i + 1])
    diff = float((full[:, -1] - logits[:, -1]).abs().max())
    print(f"{cfg.name} float32 full width: forward(context=) last-position "
          f"logits vs the 64-step decode loop's max |diff| = {diff} (bound "
          f"2e-2, the reference's tests/test_models.py); forward launches "
          f"{launched}", flush=True)
    if not diff < 2e-2 or launched != want:
        raise RuntimeError(f"whisper float32: forward vs decode {diff} "
                           f"(launches {launched})")
    del p32, ctx32, cache, full
    torch.cuda.empty_cache()


def vision_phase(args, flash_attention):
    """Phase 12(d): llama-3.2-vision-90b at full width cut to one period
    (5 layers: 4 ``attn`` + 1 gated ``xattn``; d_model 8192, 64 / 8 x 128
    heads, d_ff 28672, vocab 128256, 1600 image tokens, bf16, gate
    ``CONTEXT_GATE``), 8 slots: ``init_cache(context=)``, 32 greedy serve
    steps (no launch), the step eager against its replay (equal) and its
    byte bound, one ``forward(context=)`` of (4, 64) tokens (5
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_cache, num_params

    full_layers = get_config(VISION).num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, context = context_model(VISION, args.seed, num_layers=5,
                                         device="cuda", batch=8)
    torch.cuda.synchronize()
    print(f"{cfg.name} (one period): {cfg.num_layers} layers "
          f"{list(cfg.layer_pattern)} d_model={cfg.d_model} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab_size} image_tokens="
          f"{cfg.num_image_tokens} {cfg.dtype} params={num_params(params)} "
          f"gate={CONTEXT_GATE} init_s={time.perf_counter() - t0} "
          f"reduced: num_layers {full_layers} -> {cfg.num_layers}",
          flush=True)
    B = context.shape[0]
    flash_attention.launches = 0
    t0 = time.perf_counter()
    cache = init_cache(params, cfg, B, 64, context=context)
    torch.cuda.synchronize()
    cache_ms = (time.perf_counter() - t0) * 1e3
    first = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    tokens = greedy_decode(cfg, params, cache, first, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if flash_attention.launches:
        raise RuntimeError(f"init_cache / decode launched flash_attention "
                           f"{flash_attention.launches} times (want 0)")
    tok = tokens[:, -1:].to(torch.int32)
    eager_ms, replay_ms, equal = step_eager_vs_graph(cfg, params, cache, tok)
    nbytes = decoder_step_bytes(cfg, params, cache)
    print(f"{cfg.name} (one period): init_cache wall_ms={cache_ms}; "
          f"{B} slots x 32 greedy steps wall_s={wall} tokens_per_s="
          f"{B * 32 / wall}; decode step eager_wall_ms={eager_ms} "
          f"graph_replay_ms={replay_ms} replay == eager bit for bit: {equal}"
          f" bound_ms={1e3 * nbytes / HBM_BYTES_PER_S} (bytes={nbytes}) "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)
    if not equal:
        raise RuntimeError("the vision decode step's graph replay differs "
                           "from the eager step")
    del cache
    toks = torch.randint(1, cfg.vocab_size, (4, 64), dtype=torch.int32,
                         device="cuda")
    forward(params, cfg, toks, context=context[:4])
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    h = forward(params, cfg, toks, context=context[:4])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launched = flash_attention.launches
    print(f"{cfg.name} (one period) forward(context=) of (4, 64) tokens: "
          f"wall_ms={fwd_ms} flash_attention.launches={launched} (want "
          f"{cfg.num_layers}: 4 self, 1 cross) finite="
          f"{bool(torch.isfinite(h).all())} peak_mem_GiB="
          f"{torch.cuda.max_memory_allocated() / 2**30}", flush=True)
    if launched != cfg.num_layers or not bool(torch.isfinite(h).all()):
        raise RuntimeError(f"vision forward: {launched} launches")
    del params, context, h
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the recurrent family (xlstm-1.3b, jamba-v0.1-52b)
# ---------------------------------------------------------------------------

XLSTM = "xlstm-1.3b"
JAMBA = "jamba-v0.1-52b"
# flash_attention at jamba's attention layer (run_flash_case's tuple): a
# (4, 64) forward at 32 / 8 x 128 heads
FLASH_JAMBA_CASES = [
    ("j: jamba-v0.1-52b attention B4 S64 H32/KV8 d128 bf16 causal", 4, 32,
     8, 64, 64, 128, torch.bfloat16, True),
]
# buckets below phase 3's: a recurrent arch prefills by the decode step run
# over the bucket, up to 32 eager steps per prefill call
XLSTM_CLI = ["--arch", XLSTM, "--full", "--requests", "16", "--slots", "8",
             "--buckets", "16,32", "--min-prompt", "8", "--max-prompt", "32",
             "--gen", "32", "--rate", "0", "--temperature", "0"]


def recurrent_reference_run(arch, seed):
    """Phase 13(b): ``arch``'s float32 smoke model on the CPU and on the
    card with the same weights.  ``forward`` logits of (2, 12) tokens, and
    ``build_engine``'s greedy tokens for 4 requests whose prompts are
    shorter than their buckets (the decode-loop prefill folds their pads).
    -> (max logit difference, cpu tokens, card tokens, card
    flash_attention launches in forward, card segment_fold launches over
    the engine's run, the card engine's steps)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.segment_fold import segment_fold
    from repro_torch.models import forward, init_params, unembed
    from repro_torch.serving import ServeConfig, build_engine

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed + 13)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 5, 9, 13)]
    config = ServeConfig(arch=arch, num_slots=2, prefill_buckets=(8, 16),
                         max_new_tokens=8, prefill_batch=2, temperature=0.0,
                         eos_id=-1, seed=seed)
    out = {}
    for dev in ("cpu", "cuda"):
        p = pytree.tree_map(lambda t: t.to(dev), params)
        before = flash_attention.launches
        logits = unembed(p, cfg, forward(p, cfg, toks.to(dev)))
        launched = flash_attention.launches - before
        engine = build_engine(config, device=dev, params=p)
        uids = [engine.submit(x) for x in prompts]
        folds = segment_fold.launches
        for _ in engine.run(max_steps=200):
            pass
        folds = segment_fold.launches - folds
        tokens = [engine.result(u).tokens for u in uids]
        out[dev] = (logits.cpu(), tokens, launched, folds,
                    engine.stats.steps)
    err = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    return (err, out["cpu"][1], out["cuda"][1]) + out["cuda"][2:]


def recurrent_reference(args):
    """Phase 13(b) for both smoke configs; fails on a logit difference over
    1e-4, unequal tokens, a card forward that did not launch
    ``flash_attention`` once per attention layer, or a ``segment_fold``
    count other than one per engine step."""
    from repro_torch.configs import get_config

    for arch in (XLSTM, JAMBA):
        cfg = get_config(arch, smoke=True)
        err, cpu_toks, gpu_toks, launched, folds, steps = \
            recurrent_reference_run(arch, args.seed)
        want = sum(cfg.block_type(i) == "attn" for i in range(cfg.num_layers))
        ok = err <= 1e-4 and cpu_toks == gpu_toks and launched == want and \
            folds == steps > 0
        print(f"recurrent reference ({cfg.name}, float32): "
              f"{'OK' if ok else 'MISMATCH'} forward logits max |card - cpu|"
              f" = {err} (atol 1e-4); build_engine greedy tokens (4 prompts "
              f"shorter than their buckets, decode-loop prefill) card == cpu:"
              f" {cpu_toks == gpu_toks}; flash_attention launches in forward "
              f"{launched} (want {want}); segment_fold launches {folds} over "
              f"{steps} engine steps", flush=True)
        if not ok:
            raise RuntimeError(f"{arch}: the card's float32 smoke model "
                               f"differs from the CPU's")


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def recurrent_step_bytes(cfg, params, cache, experts_hit=0) -> int:
    """Bytes one decode step must move: every weight it reads once (all but
    ``embed``, of which it gathers B rows; of an MoE layer the router and
    ``experts_hit`` experts), each recurrent state read and written, and
    an attention layer's K/V rows [0, pos] read."""
    nbytes = tree_bytes
    total = nbytes({k: v for k, v in params.items()
                    if k not in ("embed", "layers")})
    rows = int(cache["pos"].max()) + 1
    for i, (layer, c) in enumerate(zip(params["layers"], cache["layers"])):
        total += nbytes({k: v for k, v in layer.items() if k != "ffn"})
        if cfg.ffn_type(i) == "moe":
            total += moe_layer_bytes(cfg, experts_hit)
        else:
            total += nbytes(layer.get("ffn", {}))
        if cfg.block_type(i) in ("attn", "local"):
            total += nbytes([t[:, :rows] for t in c.values()])
        else:
            total += 2 * nbytes(c)
    return total


def recurrent_mix_split(cfg, params, B, step_ms) -> None:
    """Where a replayed decode step's time goes among its recurrent blocks:
    for each block type, one decode of its first layer's mixer on ``B``
    random rows replayed from a CUDA graph, beside its byte bound (its
    weights once, its state read and written) and, times the layers of
    that type, its share of the replayed step (an estimate)."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(B)
    for ltype in ssm.RECURRENT_BLOCKS:
        layers = [i for i in range(cfg.num_layers)
                  if cfg.block_type(i) == ltype]
        if not layers:
            continue
        p = params["layers"][layers[0]]["mix"]
        cache = ssm.INIT_CACHE[ltype](cfg, B, "cuda")
        x = torch.randn((B, 1, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.dtype)
        ms = graph_ms(lambda: ssm.DECODE[ltype](p, cfg, x, cache))
        weights, state = tree_bytes(p), tree_bytes(cache)
        bound = 1e3 * (weights + 2 * state) / HBM_BYTES_PER_S
        print(f"{cfg.name} {ltype} decode (layer {layers[0]}, {B} rows, "
              f"device ms, graph replay): {ms} bound_ms={bound} (weights "
              f"{weights}, state {state} read and written) x "
              f"{len(layers)} layers = {len(layers) * ms} ms, "
              f"{len(layers) * ms / step_ms} of the replayed step "
              f"(estimate)", flush=True)
        del cache


def xlstm_phase(args, segment_fold, flash_attention):
    """Phase 13(c): xlstm-1.3b at full width, nothing cut (48 layers, 6 x
    (7 mLSTM + 1 sLSTM), d_model 2048, 4 heads, vocab 50304 untied, bf16,
    3.57 B parameters, random weights from ``--seed``) through the serve
    CLI's own run: 16 requests of 8-32 tokens at t=0, 8 slots, buckets 16 /
    32, 32 new tokens, greedy.  ``flash_attention`` must not launch and
    ``segment_fold`` must launch once per engine step.  Then the decode
    step eager against its CUDA-graph replay (equal bit for bit) and its
    byte bound, the mLSTM and sLSTM layers' shares of the replay, and in
    float32 the last position of a (2, 256) ``forward`` (two mLSTM chunks)
    within 2e-2 of the decode loop's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_cli
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, num_params, unembed)

    torch.cuda.reset_peak_memory_stats()
    segment_fold.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    run = run_cli(XLSTM_CLI + ["--seed", str(args.seed)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fold_launches, flash_launches = segment_fold.launches, \
        flash_attention.launches
    engine, results = run["engine"], run["results"]
    cfg = get_config(engine.config.arch, smoke=not engine.config.full)
    st = engine.stats
    budget = engine.config.max_new_tokens
    if len(results) != len(run["trace"]):
        raise RuntimeError(f"{len(results)} of {len(run['trace'])} "
                           "completed")
    for r in results:
        if not (1 <= len(r.tokens) <= budget) or \
                not math.isfinite(r.logprob_sum) or \
                any(not 0 <= t < cfg.vocab_size for t in r.tokens):
            raise RuntimeError(f"bad result {r}")
        if len(r.tokens) < budget and not r.stopped:
            raise RuntimeError(f"uid {r.uid} ended early without eos")
    if flash_launches:
        raise RuntimeError(f"xlstm launched flash_attention "
                           f"{flash_launches} times (it has no attention)")
    if st.prefill_calls <= 0 or fold_launches != st.steps:
        raise RuntimeError(f"segment_fold launched {fold_launches} times "
                           f"over {st.steps} engine steps")
    if sum(engine.compile_counts().values()) > engine.compile_bound():
        raise RuntimeError(f"program shapes {engine.compile_counts()} exceed"
                           f" the bound {engine.compile_bound()}")
    gen = sum(len(r.tokens) for r in results)
    ttft = np.array([r.ttft_s for r in results])
    params = engine.backend.params
    print(f"{XLSTM} serve (CLI, full width, nothing cut): params="
          f"{num_params(params)} layers={cfg.num_layers} "
          f"{list(cfg.layer_pattern)} completed={len(results)} "
          f"generated_tokens={gen} wall_s={run['wall_s']} tokens_per_s="
          f"{gen / run['wall_s']} ttft_p50_ms={np.percentile(ttft, 50) * 1e3}"
          f" ttft_p99_ms={np.percentile(ttft, 99) * 1e3} decode_steps="
          f"{st.steps} prefill_calls={st.prefill_calls} (decode loop over "
          f"the bucket) flash_attention.launches=0 segment_fold.launches="
          f"{fold_launches} (== steps) peak_mem_GiB="
          f"{torch.cuda.max_memory_allocated() / 2**30} cli_s={run_s}",
          flush=True)
    B = engine.config.num_slots
    del run, engine, results
    torch.cuda.empty_cache()

    cache = init_cache(params, cfg, B, 64, pos_per_slot=True)
    toks = torch.randint(1, cfg.vocab_size, (B, 9), dtype=torch.int32,
                         device="cuda")
    feed_prompt(cfg, params, cache, toks[:, :8])   # states not all zeros
    eager_ms, replay_ms, equal = step_eager_vs_graph(cfg, params, cache,
                                                     toks[:, 8:])
    nbytes = recurrent_step_bytes(cfg, params, cache)
    size = cfg.dtype.itemsize
    state = sum(t.numel() * t.element_size() for c in cache["layers"]
                for t in c.values())
    print(f"{XLSTM} decode step ({B} slots, full width): eager_wall_ms="
          f"{eager_ms} graph_replay_ms={replay_ms} replay == eager bit for "
          f"bit: {equal} bound_ms={1e3 * nbytes / HBM_BYTES_PER_S} (bytes="
          f"{nbytes}: weights without embed "
          f"{(num_params(params) - params['embed'].numel()) * size}, states "
          f"{state} read and written) replay/bound="
          f"{replay_ms / (1e3 * nbytes / HBM_BYTES_PER_S)} host_bound_share="
          f"{1 - replay_ms / eager_ms}", flush=True)
    if not equal:
        raise RuntimeError("the xlstm decode step's graph replay differs "
                           "from the eager step")
    del cache
    recurrent_mix_split(cfg, params, B, replay_ms)
    del params
    torch.cuda.empty_cache()

    # float32 at full width: forward's last position against the decode
    # loop over the same 256 tokens, the reference's bound 2e-2
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen32 = torch.Generator(device="cuda").manual_seed(args.seed + 13)
    p32 = init_params(cfg32, gen32, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (2, 256), generator=gen32,
                         device="cuda", dtype=torch.int32)
    t0 = time.perf_counter()
    full = unembed(p32, cfg32, forward(p32, cfg32, toks)[:, -1:])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    cache = init_cache(p32, cfg32, 2, 256)
    for i in range(256):
        logits, cache = decode_step(p32, cfg32, cache, toks[:, i:i + 1])
    diff = float((full[:, -1] - logits[:, -1]).abs().max())
    print(f"{XLSTM} float32 full width ({num_params(p32) * 4} bytes of "
          f"weights): forward (2, 256) wall_ms={fwd_ms}; its last-position "
          f"logits vs the 256-step decode loop's max |diff| = {diff} (bound "
          f"2e-2, the reference's tests/test_models.py) finite="
          f"{bool(torch.isfinite(full).all())}", flush=True)
    if not diff < 2e-2:
        raise RuntimeError(f"xlstm float32: forward vs decode {diff}")
    del p32, cache, full
    torch.cuda.empty_cache()


def jamba_phase(args, flash_attention):
    """Phase 13(d): jamba-v0.1-52b at full width cut to one period (8
    layers: 7 ``mamba`` with d_inner 8192, d_state 16, and 1 ``attn`` at
    32 / 8 x 128; 4 dense FFNs of 14336 and 4 MoE FFNs of 16 experts of
    14336, top-2; bf16, 13.3 B parameters; the cut printed as
    ``reduced``), 8 slots: a 16-token prompt through ``decode_step``, 32
    greedy steps (no launch), the step eager against its replay (equal)
    and its byte bound, the Mamba layers' share of the replay, one (4, 64) ``forward`` (1 launch, ``expert_load``
    summing to 4 x 64 x top-2 x 4 MoE layers)."""
    from repro_torch.configs import get_config
    from repro_torch.models import (forward_with_stats, init_cache,
                                    init_params, moe, num_params)

    full_layers = get_config(JAMBA).num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(JAMBA), num_layers=8)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name} (one period): {cfg.num_layers} layers "
          f"{list(cfg.layer_pattern)} ffn {list(cfg.ffn_pattern)} d_model="
          f"{cfg.d_model} d_inner={cfg.d_inner} d_state={cfg.d_state} heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff="
          f"{cfg.d_ff} experts={cfg.num_experts} top-{cfg.moe_top_k} vocab="
          f"{cfg.vocab_size} {cfg.dtype} params={num_params(params)} "
          f"init_s={time.perf_counter() - t0} reduced: num_layers "
          f"{full_layers} -> {cfg.num_layers}", flush=True)
    B = 8
    cache = init_cache(params, cfg, B, 64)
    prompt = torch.randint(1, cfg.vocab_size, (B, 16), generator=gen,
                           device="cuda", dtype=torch.int32)
    flash_attention.launches = 0
    t0 = time.perf_counter()
    tok = feed_prompt(cfg, params, cache, prompt)
    tokens = greedy_decode(cfg, params, cache, tok, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if flash_attention.launches:
        raise RuntimeError(f"jamba's decode launched flash_attention "
                           f"{flash_attention.launches} times (want 0)")
    if bool(((tokens < 0) | (tokens >= cfg.vocab_size)).any()):
        raise RuntimeError("jamba: token outside the vocab")
    eager_ms, replay_ms, equal = step_eager_vs_graph(
        cfg, params, cache, tokens[:, -1:].to(torch.int32))
    # experts hit per MoE layer at the decode shape: each MoE layer routes
    # B random rows (an estimate: the step's own rows are not read back)
    hits = []
    for i, layer in enumerate(params["layers"]):
        if cfg.ffn_type(i) == "moe":
            xf = torch.randn((B, cfg.d_model), generator=gen,
                             device="cuda").to(cfg.dtype)
            hits.append(int((moe.dispatch(layer["ffn"], cfg, xf)[1] > 0)
                            .sum()))
    nbytes = recurrent_step_bytes(cfg, params, cache,
                                  round(sum(hits) / len(hits)))
    print(f"{cfg.name} (one period): {B} slots, 16 prompt + 32 greedy steps"
          f" wall_s={wall} tokens_per_s={B * 48 / wall}; decode step "
          f"eager_wall_ms={eager_ms} graph_replay_ms={replay_ms} replay == "
          f"eager bit for bit: {equal} bound_ms="
          f"{1e3 * nbytes / HBM_BYTES_PER_S} (bytes={nbytes}, experts hit "
          f"per MoE layer {hits} on random rows) replay/bound="
          f"{replay_ms / (1e3 * nbytes / HBM_BYTES_PER_S)} peak_mem_GiB="
          f"{torch.cuda.max_memory_allocated() / 2**30}", flush=True)
    if not equal:
        raise RuntimeError("the jamba decode step's graph replay differs "
                           "from the eager step")
    del cache
    recurrent_mix_split(cfg, params, B, replay_ms)
    toks = torch.randint(1, cfg.vocab_size, (4, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    forward_with_stats(params, cfg, toks)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    h, stats = forward_with_stats(params, cfg, toks)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launched = flash_attention.launches
    n_moe = sum(cfg.ffn_type(i) == "moe" for i in range(cfg.num_layers))
    load, want_load = int(stats["expert_load"].sum()), \
        4 * 64 * cfg.moe_top_k * n_moe
    print(f"{cfg.name} (one period) forward of (4, 64) tokens: wall_ms="
          f"{fwd_ms} flash_attention.launches={launched} (want 1) "
          f"expert_load sum={load} (want {want_load}) finite="
          f"{bool(torch.isfinite(h).all())} peak_mem_GiB="
          f"{torch.cuda.max_memory_allocated() / 2**30}", flush=True)
    if launched != 1 or load != want_load or \
            not bool(torch.isfinite(h).all()):
        raise RuntimeError(f"jamba forward: {launched} launches, "
                           f"expert_load {load}")
    del params, h
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: training (loss_fn, AdamW, the microbatch fold, checkpoint and
# restart) on flash_attention's hand-written backward
# ---------------------------------------------------------------------------

# (name, B, H, KV, Sq, Sk, d, dtype, causal, window, the design the
# launcher must take: flash_attention.backward_design)
FLASH_BWD_CASES = [
    ("t1: qwen3-0.6b training B8 S1024 H16/KV8 d128 bf16 causal", 8, 16, 8,
     1024, 1024, 128, torch.bfloat16, True, None, "wgmma"),
    ("t2: gemma3 local layer B2 S1024 H4/KV1 d256 bf16 window 512", 2, 4, 1,
     1024, 1024, 256, torch.bfloat16, True, 512, "wgmma"),
    ("t3: whisper encoder B8 S1500 H12/KV12 d64 bf16 non-causal", 8, 12, 12,
     1500, 1500, 64, torch.bfloat16, False, None, "wgmma"),
    ("t4: cross-attention B2 Sq64 Sk1500 H12/KV12 d64 bf16 non-causal", 2, 12,
     12, 64, 1500, 64, torch.bfloat16, False, None, "wgmma"),
    ("t5: odd sizes B2 S100 H4/KV2 d40 f32 causal", 2, 4, 2, 100, 100, 40,
     torch.float32, True, None, "cuda_cores"),
]
# calls timed per reading of phase 14(a), after a warm-up call
BWD_ITERS = 20
# each gradient's max error against the f32 plain version, as a share of
# that gradient's max magnitude: 16-bit inputs round dq / dk / dv once (and
# the forward's o, which D reads) to 8 (bf16) or 11 (f16) bits; f32 sums
# the same products in another order
FLASH_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                  torch.float16: 2e-2}
TRAIN_ARCH = "qwen3-0.6b"
# the weights come from TrainerConfig's seed, 0 (the CLI takes no --seed, as
# the JAX package's takes none)
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--full", "--steps", "20", "--batch", "8",
             "--seq", "1024", "--microbatches", "2", "--ckpt-every", "10",
             "--log-every", "1"]


def window_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the forward's mask keeps (top-left causal, the
    sliding window, or none)."""
    if not causal:
        return Sq * Sk
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Sk)
    lo = np.zeros_like(i) if window is None else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def run_flash_bwd_case(case, gen, dev) -> dict:
    """Phase 14(a): the backward through the autograd Function (the forward
    launch writing the row log-sum-exp, then ``flash_attention_bwd``)
    against ``flash_attention_backward_plain`` on the same inputs in f32;
    one backward launch per call, in the design the case expects; the
    backward kernel and SDPA's backward alone timed in turns (ours, SDPA,
    SDPA, ours: ``kernel_ms`` and ``library_ms`` are the means of each
    pair), then its plain version and our forward + backward beside SDPA's
    (``fwd_bwd_ms``, ``library_fwd_bwd_ms``), ``BWD_ITERS`` calls a
    reading."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward_plain, flash_attention_bwd)

    name, B, H, KV, Sq, Sk, d, dtype, causal, window, expect = case[:11]
    dv = case[11] if len(case) > 11 else d      # v's head dim (MLA: 128)
    q, k, v = [torch.randn(shape, generator=gen, device=dev).to(dtype)
               .requires_grad_()
               for shape in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, dv))]
    do = torch.randn((B, H, Sq, dv), generator=gen, device=dev).to(dtype)
    before = flash_attention_bwd.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    launches = flash_attention_bwd.launches - before
    o = o.detach()
    want = flash_attention_backward_plain(
        q.detach().float(), k.detach().float(), v.detach().float(),
        o.float(), do.float(), causal=causal, window=window)
    rel = [max_err(g, w) / max(float(w.abs().max()), 1e-30)
           for g, w in zip(got, want)]
    rtol = FLASH_BWD_RTOL[dtype]
    design = flash_attention_bwd.last_design
    ok = launches == 1 and all(e <= rtol for e in rel) and design == expect

    qd, kd, vd = q.detach(), k.detach(), v.detach()
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    from repro_torch.kernels.flash_attention import _launch
    _launch(qd, kd, vd, causal, None, window, lse)

    def kernel():
        return flash_attention_bwd(qd, kd, vd, o, do, lse, causal=causal,
                                   window=window)

    def plain():
        return flash_attention_backward_plain(qd, kd, vd, o, do, lse,
                                              causal=causal, window=window)

    def ours_fwd_bwd():
        out = flash_attention(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out, (q, k, v), do)

    mask = None
    if window is not None:
        qp = torch.arange(Sq, device=dev)[:, None]
        kp = torch.arange(Sk, device=dev)[None, :]
        mask = (kp <= qp) & (kp > qp - window)

    def sdpa():
        if dv == d:
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        return mla_sdpa(q, k, v, causal, mask)[0]

    def library_fwd_bwd():
        return torch.autograd.grad(sdpa(), (q, k, v), do)

    sdpa_out = sdpa()

    def library():                # SDPA's backward alone, on a kept graph
        return torch.autograd.grad(sdpa_out, (q, k, v), do,
                                   retain_graph=True)

    pair = [cuda_ms(kernel, BWD_ITERS), cuda_ms(library, BWD_ITERS)]
    pair += [cuda_ms(library, BWD_ITERS), cuda_ms(kernel, BWD_ITERS)]
    ms, library_ms = (pair[0] + pair[3]) / 2, (pair[1] + pair[2]) / 2
    plain_ms = cuda_ms(plain, BWD_ITERS)
    fwd_bwd_ms = cuda_ms(ours_fwd_bwd, BWD_ITERS)
    library_fwd_bwd_ms = cuda_ms(library_fwd_bwd, BWD_ITERS)
    del sdpa_out
    nbytes = (2 * q.numel() + 2 * o.numel() + 2 * k.numel() +
              2 * v.numel()) * q.element_size() + lse.numel() * 4
    # q, o, do and lse read, dq written; k, v read, dk, dv written
    pairs = B * H * window_pairs(Sq, Sk, causal, window)
    flops = 2 * pairs * (3 * d + 2 * dv)
    # the backward's five products: s = q k^T, dQ and dK over d columns,
    # dV and dP over dv (at d == dv: 2.5 x the forward's 4 pairs d)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    # the kernels' own floor: 7 tile products where the bound counts 5 (s
    # and dP are recomputed in the dQ kernel, which keeps the sums free of
    # atomics)
    seven_ms = max(bytes_ms, 2 * pairs * (4 * d + 3 * dv) /
                   PEAK_FLOPS[dtype] * 1e3)
    return dict(name=name, ok=ok, max_abs_err=max(max_err(g, w) for g, w in
                                                  zip(got, want)),
                rel_errs=rel, tolerance=f"rtol={rtol} of max|grad|",
                design=design, expected_design=expect,
                readings=dict(ours=[pair[0], pair[3]],
                              sdpa_backward=[pair[1], pair[2]]),
                launches=launches, ms=ms, plain_ms=plain_ms,
                fwd_bwd_ms=fwd_bwd_ms, library_ms=library_ms,
                library_fwd_bwd_ms=library_fwd_bwd_ms,
                bound_ms=max(bytes_ms, ops_ms), seven_product_ms=seven_ms,
                flops=flops, bound_bytes=nbytes,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def train_smoke_card_vs_cpu(args) -> None:
    """Phase 14(b): qwen3-0.6b's smoke model in float32 trains 5 steps
    through ``make_train_step`` (2 microbatches, remat) on the card and on
    the CPU from the same parameters and batches; loss and grad_norm agree
    within 1e-4 (relative) at every step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=True),
                              dtype=torch.float32)
    step = make_train_step(cfg, num_microbatches=2, opt=OptConfig(
        peak_lr=1e-3, warmup_steps=2, decay_steps=100))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=64, global_batch=4,
                                        seed=args.seed), device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device="cpu")
    states = {"cpu": (params, init_opt_state(params))}
    cuda_params = pytree.tree_map(lambda t: t.cuda(), params)
    states["cuda"] = (cuda_params, init_opt_state(cuda_params))
    worst = 0.0
    for i in range(5):
        batch = corpus(i)
        out = {}
        for where, (p, o) in states.items():
            b = {k: v.to(where) for k, v in batch.items()}
            p, o, m = step(p, o, b)
            states[where] = (p, o)
            out[where] = (float(m["loss"]), float(m["grad_norm"]))
        errs = [abs(a - b) / max(abs(b), 1.0)
                for a, b in zip(out["cuda"], out["cpu"])]
        worst = max(worst, *errs)
        print(f"  train smoke step {i + 1}: card loss={out['cuda'][0]:.6f} "
              f"grad_norm={out['cuda'][1]:.6f}  cpu loss={out['cpu'][0]:.6f} "
              f"grad_norm={out['cpu'][1]:.6f}", flush=True)
    print(f"train smoke (f32, card vs CPU, 5 steps): worst relative "
          f"difference of loss / grad_norm {worst:.3g} (limit 1e-4)",
          flush=True)
    if not worst <= 1e-4:
        raise RuntimeError(f"train smoke: card and CPU disagree ({worst})")


def step_bound_ms(cfg, batch: int, seq: int) -> float:
    """The least time of one training step on the tensor cores: 6 x
    parameters x tokens of matrix products (forward and backward, no
    recompute) plus attention's q k^T and p v forward (x 1) and backward
    (x 2.5) over the causal pairs, at the bf16 peak."""
    tokens = batch * seq
    attn = 3.5 * cfg.num_layers * 4 * batch * cfg.num_heads * \
        window_pairs(seq, seq, True, None) * cfg.head_dim
    return (6 * cfg.num_params() * tokens + attn) / PEAK_FLOPS[
        torch.bfloat16] * 1e3


def train_phase(args) -> int:
    """Phase 14(c): qwen3-0.6b at full width, nothing cut (28 layers,
    d_model 1024, 16 / 8 x 128, d_ff 3072, vocab 151936 tied, bf16), trained
    through the CLI (``repro_torch.launch.train.main``): 20 steps at global
    batch 8 x seq 1024 in 2 microbatches, remat per layer, a checkpoint at
    step 10; then a second CLI run from a copy of the step-10 checkpoint to
    step 20.  Returns the backward's launches in the straight run."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.cms import cms_counts
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.segment_fold import segment_fold
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import main as train_main
    from repro_torch.data import DataConfig, SyntheticCorpus

    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    steps, mbs = 20, 2
    os.makedirs(os.path.join(_HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(
        _HERE, "build"))
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention_bwd.launches = 0
        cms_counts.launches = segment_fold.launches = 0
        t0 = time.perf_counter()
        out1 = train_main(TRAIN_CLI + ["--ckpt-dir",
                                       os.path.join(root, "straight")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        cms, fold = cms_counts.launches, segment_fold.launches
        peak = torch.cuda.max_memory_allocated()
        hist = out1["history"]
        losses = [h["loss"] for h in hist]
        dts = sorted(h["dt"] for h in hist[2:])
        med_s = dts[len(dts) // 2]
        bound = step_bound_ms(cfg, 8, 1024)
        print(f"qwen3-0.6b train (full width, {cfg.num_params()} params, "
              f"batch 8 x 1024 in {mbs} microbatches, remat): {steps} steps "
              f"in {run_s:.1f}s; losses {losses}", flush=True)
        print(f"  launches: flash_attention {fwd} (expected {L * mbs * 2 * steps}"
              f" = {L} layers x {mbs} microbatches x 2 (remat) x {steps}), "
              f"flash_attention_bwd {bwd} (expected {L * mbs * steps}), "
              f"cms_update {cms} (expected {steps}), segment_fold {fold}",
              flush=True)
        print(f"  step: median {med_s * 1e3:.1f} ms after the first 2 "
              f"(wall, ends in a sync), {8 * 1024 / med_s:.0f} tokens/s; "
              f"bound {bound:.2f} ms (bf16 tensor cores: 6 x params x tokens "
              f"+ attention), share {bound / (med_s * 1e3):.3f}; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)
        ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        ok &= fwd == L * mbs * 2 * steps and bwd == L * mbs * steps
        ok &= cms == steps
        if not ok:
            raise RuntimeError("qwen3-0.6b training: a loss is not finite, "
                               "the loss did not fall, or a launch count is "
                               "off")

        # the restart: a copy of the step-10 checkpoint, resumed to 20
        resumed = os.path.join(root, "resumed")
        os.makedirs(resumed)
        shutil.copytree(os.path.join(root, "straight", "step_00000010"),
                        os.path.join(resumed, "step_00000010"))
        with open(os.path.join(resumed, "LATEST"), "w") as f:
            f.write("10")
        out2 = train_main(TRAIN_CLI + ["--ckpt-dir", resumed])
        stats_equal = all(torch.equal(out1["stream_stats"][k],
                                      out2["stream_stats"][k])
                          for k in out1["stream_stats"])
        tokens_equal = torch.equal(out1["metrics_acc"]["tokens"],
                                   out2["metrics_acc"]["tokens"])
        loss_diff = max(abs(a["loss"] - b["loss"]) for a, b in
                        zip(hist[10:], out2["history"]))
        print(f"  restart at 10 -> 20: stream stats equal {stats_equal}, "
              f"tokens equal {tokens_equal} "
              f"({float(out2['metrics_acc']['tokens'])}), worst loss "
              f"difference over steps 11-20 {loss_diff:.3g} (limit 1e-2; the "
              f"embedding's backward adds with atomics, so the parameters "
              f"are not bit for bit)", flush=True)
        if not (stats_equal and tokens_equal and loss_diff <= 1e-2):
            raise RuntimeError("qwen3-0.6b restart is not exact")

        # the backward kernel's share of one step, from a profiler trace
        from torch.profiler import ProfilerActivity, profile
        step = make_train_step(cfg, num_microbatches=mbs)
        params, opt_state = out1["params"], out1["opt_state"]
        del out1, out2
        batch = SyntheticCorpus(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8,
            seed=0), device="cuda")(steps)
        batch.pop("valid_mask", None)
        params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(params, opt_state, batch)
            torch.cuda.synchronize()
        dev_us = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            dev_us[e.key] = t
        total = sum(dev_us.values())
        # flash_attention_bwd.cu's kernels: D, then dK / dV and dQ (the
        # wgmma, mma.sync and CUDA-core designs)
        bwd_names = ("delta_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel",
                     "dkdv_mma_kernel", "dq_mma_kernel", "dkdv_kernel",
                     "dq_kernel")
        bwd_us = sum(t for k, t in dev_us.items()
                     if any(n in k for n in bwd_names))
        split = {n: sum(t for k, t in dev_us.items() if n in k)
                 for n in bwd_names}
        fwd_us = sum(t for k, t in dev_us.items()
                     if "flash_attention_kernel" in k)
        print(f"  one step's device time (profiler): {total / 1e3:.1f} ms; "
              f"flash_attention_bwd {bwd_us / 1e3:.1f} ms (share "
              f"{bwd_us / max(total, 1e-9):.3f}), flash_attention forward "
              f"{fwd_us / 1e3:.1f} ms (share {fwd_us / max(total, 1e-9):.3f})",
              flush=True)
        print("  flash_attention_bwd by kernel (ms): " + ", ".join(
            f"{n} {t / 1e3:.2f}" for n, t in split.items() if t), flush=True)
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        for k, t in top:
            print(f"    {t / 1e3:9.2f} ms  {k[:100]}", flush=True)
        return bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


def training_phase(args, gen, dev) -> tuple:
    """Phase 14: (a) the backward cases t1-t5, (b) the smoke model card vs
    CPU, (c) qwen3-0.6b at full width through the CLI with a restart.
    Returns (t1's row, the backward's launches in (c))."""
    rows = []
    for case in FLASH_BWD_CASES:
        row = run_flash_bwd_case(case, gen, dev)
        rows.append(row)
        print_row("flash_attention_bwd", row)
        print(f"  design={row['design']} (expected "
              f"{row['expected_design']}) readings in turns (ours, SDPA "
              f"backward, SDPA backward, ours; {BWD_ITERS} calls each): "
              f"ours={row['readings']['ours']} "
              f"sdpa_backward={row['readings']['sdpa_backward']} "
              f"seven_product_ms={row['seven_product_ms']}", flush=True)
        print(f"  launches per call={row['launches']} rel_errs(dq, dk, dv)="
              f"{row['rel_errs']} fwd_bwd_ms={row['fwd_bwd_ms']} "
              f"library_fwd_bwd_ms={row['library_fwd_bwd_ms']} "
              f"flops={row['flops']}"
              f" bytes={row['bound_bytes']}", flush=True)
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention_bwd disagrees with its plain "
                           f"version, is not one launch or took another "
                           f"design: {bad}")
    train_smoke_card_vs_cpu(args)
    torch.cuda.empty_cache()
    launches = train_phase(args)
    torch.cuda.empty_cache()
    return rows[0], launches


# ---------------------------------------------------------------------------
# phase 15: MLA and deepseek-v2-236b
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v2-236b"
# flash_attention at MLA's shapes: q / k at d 192 (128 nope + 64 rope), v at
# dv 128, 128 heads (MHA): (name, B, H, KV, Sq, Sk, d, dv, dtype, offsets or
# None).  m1 is the engine's (4, 64) prefill bucket, m2 a long causal call
# (~0.69 TFLOP: operations bound it), m3 the warm prefill of phase 8's
# shape (suffixes of 16 over a 96-row cache at per-row offsets)
FLASH_MLA_CASES = [
    ("m1: deepseek-v2 prefill bucket B4 S64 H128/KV128 d192 dv128 bf16 "
     "causal", 4, 128, 128, 64, 64, 192, 128, torch.bfloat16, None),
    ("m2: B1 S4096 H128/KV128 d192 dv128 bf16 causal", 1, 128, 128, 4096,
     4096, 192, 128, torch.bfloat16, None),
    ("m3: deepseek-v2 warm prefill B4 Sq16 Sk96 H128/KV128 d192 dv128 bf16 "
     "offsets 0/20/44/80", 4, 128, 128, 16, 96, 192, 128, torch.bfloat16,
     (0, 20, 44, 80)),
]
# the backward at m1's shape: 192 is no wgmma head dim, so the card pads
# v, o and do to 192 columns and runs the mma_sync design
FLASH_MLA_BWD_CASE = (
    "mb: deepseek-v2 backward B4 S64 H128/KV128 d192 dv128 bf16 causal "
    "(v, o, do zero-padded to 192)", 4, 128, 128, 64, 64, 192,
    torch.bfloat16, True, None, "mma_sync", 128)
# heads of the p-rounded control (its plain product holds every score)
CONTROL_HEADS = 16
DEEPSEEK_LAYERS = 4          # the dense prelude layer and 3 MoE layers


def sdpa_backend(fn) -> str:
    """Which of SDPA's backends one call of ``fn`` ran, read from the names
    of the kernels ``torch.profiler`` records ("not measured" when every
    try came back empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            low = " ".join(names).lower()
            for key, label in (("flash", "flash"), ("cudnn", "cudnn"),
                               ("fmha", "efficient"), ("efficient",
                                                       "efficient")):
                if key in low:
                    return label
            return f"math ({names[0][:48]})"
    return "not measured"


def mla_sdpa(q, k, v, causal, mask=None, pad=None):
    """SDPA on MLA's shapes, the yardstick: called with v at its own head
    dim; if SDPA refuses that (or ``pad`` is True), with v zero-padded to
    q's head dim and the output sliced (the scale is 1 / sqrt(d) either
    way).  ``pad`` False or True calls that form without trying the other
    (what a CUDA graph captures).  -> (output, how it was called)."""
    f = torch.nn.functional.scaled_dot_product_attention
    kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    if not pad:
        try:
            return f(q, k, v, **kw), "dv != d"
        except RuntimeError:
            if pad is False:
                raise
    dv = v.shape[-1]
    vpad = torch.nn.functional.pad(v, (0, q.shape[-1] - dv))
    return f(q, k, vpad, **kw)[..., :dv], "v zero-padded to d (SDPA " \
        "refused dv != d)"


def run_mla_flash_case(case, gen, dev) -> dict:
    """Phase 15(a): ``flash_attention`` at dv != d against its plain
    version with phase 2's tolerances and 16-bit controls (the p-rounded
    control on the first ``CONTROL_HEADS`` heads), one launch per call
    (the wrapper's count, and one CUDA kernel where the profiler records
    the call); timed beside its bound, its plain version and SDPA at dv !=
    d (the backend it took printed)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    name, B, H, KV, Sq, Sk, d, dv, dtype, offsets = case
    q, k = [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, H, Sq, d), (B, KV, Sk, d))]
    v = torch.randn((B, KV, Sk, dv), generator=gen, device=dev).to(dtype)
    off = None if offsets is None else torch.tensor(
        offsets, dtype=torch.int32, device=dev)

    def kernel():
        return flash_attention(q, k, v, q_offset=off)

    def plain():
        return flash_attention_plain(q, k, v, q_offset=off)

    before = flash_attention.launches
    got = kernel()
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    ref = plain()
    err = max_err(got, ref)
    atol = FLASH_ATOL[dtype]
    h = min(H, CONTROL_HEADS)
    controls = {"differ_share": differ_share(got, ref),
                "p_rounded_share": differ_share(
                    plain_p_rounded(q[:, :h], k[:, :h], v[:, :h], True, off),
                    ref[:, :h])}
    cuda_count = cuda_launches(kernel)
    ok = err <= atol and launches == 1 and cuda_count in (1, None) and \
        got.shape == (B, H, Sq, dv) and \
        controls["differ_share"] <= FLASH_DIFFER_SHARE < \
        controls["p_rounded_share"]
    iters = 5 if Sk >= 1024 else 50
    ms = cuda_ms(kernel, iters)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(plain, min(iters, 5))
    mask = None
    if off is not None:
        q_pos = off.long()[:, None] + torch.arange(Sq, device=dev)
        mask = (torch.arange(Sk, device=dev) <= q_pos[..., None])[:, None]
    _, called = mla_sdpa(q, k, v, True, mask)
    padded = called != "dv != d"

    def library():
        return mla_sdpa(q, k, v, True, mask, pad=padded)[0]
    backend = sdpa_backend(library)
    library_ms = cuda_ms(library, iters)
    library_device_ms = graph_ms(library)
    # the (query, key) pairs the mask keeps and the key rows some query reads
    if off is None:
        pairs, keys = B * window_pairs(Sq, Sk, True, None), B * min(Sq, Sk)
    else:
        pairs = sum(int(np.minimum(o + np.arange(Sq) + 1, Sk).sum())
                    for o in offsets)
        keys = sum(min(o + Sq, Sk) for o in offsets)
    nbytes = (q.numel() + B * H * Sq * dv + keys * KV * (d + dv)) * \
        q.element_size()
    flops = 2 * H * pairs * (d + dv)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(name=name, ok=ok, max_abs_err=err, tolerance=f"atol={atol}",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                library_backend=f"{backend}, {called}",
                bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                flops=flops, launches=launches, cuda_launches=cuda_count,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                controls=controls)


def mla_flash_cases(gen, dev):
    """Phase 15(a): m1-m3, then the backward at m1's shape (its padded
    ``mma_sync`` design against the f32 plain backward at dv columns)."""
    rows = []
    for case in FLASH_MLA_CASES:
        row = run_mla_flash_case(case, gen, dev)
        print_row("flash_attention", row)
        print(f"  launches={row['launches']} cuda_launches="
              f"{row['cuda_launches']} device_ms={row['device_ms']} (graph "
              f"replay) SDPA: library_device_ms={row['library_device_ms']} "
              f"backend={row['library_backend']} flops={row['flops']} "
              f"bytes={row['bound_bytes']}"
              + "".join(f" {k}={v}" for k, v in row["controls"].items()),
              flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    bwd = run_flash_bwd_case(FLASH_MLA_BWD_CASE, gen, dev)
    print_row("flash_attention_bwd", bwd)
    print(f"  design={bwd['design']} (expected {bwd['expected_design']}) "
          f"readings in turns (ours, SDPA backward, SDPA backward, ours): "
          f"ours={bwd['readings']['ours']} sdpa_backward="
          f"{bwd['readings']['sdpa_backward']} launches per call="
          f"{bwd['launches']} rel_errs(dq, dk, dv)={bwd['rel_errs']} "
          f"fwd_bwd_ms={bwd['fwd_bwd_ms']} library_fwd_bwd_ms="
          f"{bwd['library_fwd_bwd_ms']} seven_product_ms="
          f"{bwd['seven_product_ms']}", flush=True)
    torch.cuda.empty_cache()
    bad = [r["name"] for r in rows + [bwd] if not r["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention at MLA's shapes: {bad}")
    return rows, bwd


def deepseek_reference(args) -> None:
    """Phase 15(b): deepseek-v2-236b's float32 smoke model (4 layers, MLA,
    the dense prelude, 8 experts top-2, 2 shared) on the card and the CPU
    with the same weights: ``forward`` logits within 1e-4, ``loss_fn`` loss
    and gradient norm within 1e-4 (relative), then ``cache_reference``'s
    engines (card == CPU == cold tokens with the prefix cache on and off,
    greedy and at 0.8, a warm prefix trace)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.models import (RunCtx, forward, init_params, loss_fn,
                                    unembed)

    cfg = dataclasses.replace(get_config(DEEPSEEK, smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device="cpu")
    rng = np.random.default_rng(args.seed + 15)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    labels = torch.cat([toks[:, 1:], torch.full((2, 1), -1,
                                                dtype=torch.int32)], 1)
    out = {}
    for dev in ("cpu", "cuda"):
        p = pytree.tree_map(lambda t: t.to(dev), params)
        before = flash_attention.launches, flash_attention_bwd.launches
        with torch.no_grad():
            logits = unembed(p, cfg, forward(p, cfg, toks.to(dev)))
        leaves, spec = pytree.tree_flatten(p)
        req = [t.detach().clone().requires_grad_() for t in leaves]
        loss, _ = loss_fn(pytree.tree_unflatten(req, spec), cfg,
                          {"tokens": toks.to(dev), "labels": labels.to(dev)},
                          RunCtx(remat="none"))
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in grads if g is not None))
        out[dev] = (logits.cpu(), loss.item(), norm,
                    flash_attention.launches - before[0],
                    flash_attention_bwd.launches - before[1])
    err = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    loss_rel = abs(out["cpu"][1] - out["cuda"][1]) / abs(out["cpu"][1])
    norm_rel = abs(out["cpu"][2] - out["cuda"][2]) / out["cpu"][2]
    launches, bwd_launches = out["cuda"][3:]
    ok = err <= 1e-4 and loss_rel <= 1e-4 and norm_rel <= 1e-4 and \
        launches == 2 * cfg.num_layers and bwd_launches == cfg.num_layers
    print(f"deepseek reference ({cfg.name}, float32): "
          f"{'OK' if ok else 'MISMATCH'} forward logits max |card - cpu| = "
          f"{err} (atol 1e-4); loss_fn card {out['cuda'][1]} cpu "
          f"{out['cpu'][1]} (rel {loss_rel}), grad norm card "
          f"{out['cuda'][2]} cpu {out['cpu'][2]} (rel {norm_rel}; limit "
          f"1e-4); card flash_attention launches {launches} (forward + "
          f"loss, want {2 * cfg.num_layers}), backward launches "
          f"{bwd_launches} (want {cfg.num_layers})", flush=True)
    if not ok:
        raise RuntimeError("deepseek: the card's float32 smoke model differs "
                           "from the CPU's")
    vocab = cfg.vocab_size
    shared = rng.integers(1, vocab, 8).tolist()
    prompts = [(shared if rng.random() < 0.75 else []) +
               rng.integers(1, vocab, int(rng.integers(1, 7))).tolist()
               for _ in range(9)]
    cache_reference(args, DEEPSEEK, prompts, (8, 16),
                    "deepseek reference (MLA, dense prelude, 8 experts, "
                    "top-2, 2 shared)")


def deepseek_phase(args, segment_fold, flash_attention) -> None:
    """Phase 15(c): deepseek-v2-236b at full width cut in depth to
    ``DEEPSEEK_LAYERS`` layers (the dense prelude and 3 MoE layers of 160
    experts of 5120 x 1536, top-6, 2 shared; MLA at 128 heads; bf16,
    random weights from ``--seed``; the cut printed as ``reduced``) through
    ``build_engine`` with phase 3's traffic: 8 slots, buckets 16 / 32 / 64,
    ``--requests`` requests of 8-64 tokens at t = 0, 32 new tokens, greedy,
    the prefix cache on.  ``flash_attention`` must launch once per layer
    per prefill call and never in a decode step, ``segment_fold`` once per
    step, the three grouped expert products once per MoE layer per step
    and prefill call, and a (4, 64) forward's ``expert_load`` must sum to
    4 x 64 x 6 x 3.  Prints tokens/s, TTFT, the decode step eager against
    its CUDA-graph replay (equal bit for bit) and its byte bound (the
    experts the step hit, ``lm_head`` once at the model's dtype), the
    latent cache's bytes per token per layer against an up-projected K / V
    cache's, and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import (forward_with_stats, init_params, moe,
                                    num_params)
    from repro_torch.serving import (ServeConfig, build_engine,
                                     poisson_trace, serve_trace)

    full = get_config(DEEPSEEK)
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    n_moe = sum(cfg.ffn_type(i) == "moe" for i in range(cfg.num_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers (ffn "
          f"{[cfg.ffn_type(i) for i in range(cfg.num_layers)]}) d_model="
          f"{cfg.d_model} heads={cfg.num_heads} MLA q_lora={cfg.q_lora_rank} "
          f"kv_lora={cfg.kv_lora_rank} nope/rope/v={cfg.qk_nope_dim}/"
          f"{cfg.qk_rope_dim}/{cfg.v_head_dim} d_ff={cfg.d_ff} experts="
          f"{cfg.num_experts} top-{cfg.moe_top_k} shared="
          f"{cfg.num_shared_experts} x {cfg.d_ff_expert} vocab="
          f"{cfg.vocab_size} {cfg.dtype} params={num_params(params)} "
          f"(full depth {full.num_params()}) init_s="
          f"{time.perf_counter() - t0} reduced: num_layers "
          f"{full.num_layers} -> {cfg.num_layers}", flush=True)
    config = ServeConfig(arch=DEEPSEEK, full=True, num_slots=8,
                         prefill_buckets=(16, 32, 64), max_new_tokens=32,
                         prefill_batch=4, seed=args.seed)
    engine = build_engine(config, device="cuda", params=params,
                          model_config=cfg)
    # warm-up: one short request (cuBLAS handles, allocator) before timing
    engine.submit(list(range(1, 9)), max_new_tokens=2)
    for _ in engine.run(max_steps=64):
        pass
    torch.cuda.synchronize()
    rng = np.random.default_rng(args.seed)
    trace = poisson_trace(rng, args.requests, 0.0, 8, 64, cfg.vocab_size,
                          32)
    steps0, prefills0 = engine.stats.steps, engine.stats.prefill_calls
    segment_fold.launches = 0
    flash_attention.launches = 0
    moe.expert_compute.calls = 0
    results, wall = serve_trace(engine, trace)
    torch.cuda.synchronize()
    fold_launches, flash_launches = segment_fold.launches, \
        flash_attention.launches
    grouped_calls = moe.expert_compute.calls
    steps = engine.stats.steps - steps0
    prefills = engine.stats.prefill_calls - prefills0
    if len(results) != args.requests:
        raise RuntimeError(f"{len(results)} of {args.requests} completed")
    for r in results:
        if not (1 <= len(r.tokens) <= 32) or \
                not math.isfinite(r.logprob_sum):
            raise RuntimeError(f"bad result {r}")
        if any(not 0 <= t < cfg.vocab_size for t in r.tokens):
            raise RuntimeError(f"token outside the vocab in {r.tokens}")
        if len(r.tokens) < 32 and not r.stopped:
            raise RuntimeError(f"uid {r.uid} ended early without eos")
    if prefills <= 0 or flash_launches != cfg.num_layers * prefills:
        raise RuntimeError(f"flash_attention launched {flash_launches} times "
                           f"over {prefills} prefill calls; each must "
                           f"launch it once per layer ({cfg.num_layers}) "
                           f"and no decode step any")
    if fold_launches <= 0 or fold_launches != steps:
        raise RuntimeError(f"segment_fold launched {fold_launches} times "
                           f"over {steps} decode steps")
    if grouped_calls != n_moe * (steps + prefills):
        raise RuntimeError(f"expert_compute ran {grouped_calls} times over "
                           f"{steps} steps and {prefills} prefill calls of "
                           f"{n_moe} MoE layers")
    counts = engine.compile_counts()
    if sum(counts.values()) > engine.compile_bound():
        raise RuntimeError(f"program shapes {counts} exceed the bound "
                           f"{engine.compile_bound()}")
    gen_toks = sum(len(r.tokens) for r in results)
    ttft = np.array([r.ttft_s for r in results])
    ps = engine.prefix.stats
    print(f"{cfg.name} serve (build_engine, {cfg.num_layers} layers): "
          f"completed={len(results)} generated_tokens={gen_toks} wall_s="
          f"{wall} tokens_per_s={gen_toks / wall} ttft_p50_ms="
          f"{np.percentile(ttft, 50) * 1e3} ttft_p99_ms="
          f"{np.percentile(ttft, 99) * 1e3} decode_steps={steps} "
          f"prefill_calls={prefills} flash_attention.launches="
          f"{flash_launches} (== {cfg.num_layers} x prefill calls) "
          f"segment_fold.launches={fold_launches} (== steps) "
          f"grouped_mm products={3 * grouped_calls} (3 x {n_moe} MoE layers "
          f"x (steps + prefill calls)) prefix hit_rate={ps.hit_rate()} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)

    # the decode step at 8 busy slots: eager against its graph replay, the
    # experts it hits counted on the eager step's own rows
    be = engine.backend
    B = config.num_slots
    cache = be.init_cache(B, True)
    prompt = torch.randint(1, cfg.vocab_size, (B, 16), generator=gen,
                           device="cuda", dtype=torch.int32)
    tok = feed_prompt(cfg, params, cache, prompt)
    hits = []
    compute = moe.expert_compute

    def counted(p, xbuf, gs):     # no host read: it runs under capture too
        hits.append((gs > 0).sum())
        return compute(p, xbuf, gs)
    counted.calls = 0             # expert_compute counts on the module name
    moe.expert_compute = counted
    try:
        flash_attention.launches = 0
        eager_ms, replay_ms, equal = step_eager_vs_graph(
            cfg, params, cache, tok.to(torch.int32))
        step_launches = flash_attention.launches
    finally:
        moe.expert_compute = compute
    # the eager step whose logits and cache the replay must equal (the
    # last n_moe calls are the capture's)
    hits = [int(t) for t in hits[-2 * n_moe:-n_moe]]
    nbytes = recurrent_step_bytes(cfg, params, cache) + sum(
        moe_layer_bytes(cfg, h) - moe_layer_bytes(cfg, 0) for h in hits)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    lat = cache["layers"][0]
    per_token = sum(lat[n].shape[-1] * lat[n].element_size()
                    for n in ("lat_c", "lat_r"))
    kv_token = cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim +
                                cfg.v_head_dim) * cfg.dtype.itemsize
    print(f"{cfg.name} decode step ({B} slots): eager_wall_ms={eager_ms} "
          f"graph_replay_ms={replay_ms} replay == eager bit for bit: {equal}"
          f" flash_attention launches in decode steps={step_launches} "
          f"(want 0) bound_ms={bound_ms} (bytes={nbytes}, experts hit per "
          f"MoE layer {hits}, lm_head once at {cfg.dtype}) replay/bound="
          f"{replay_ms / bound_ms}; latent cache bytes per token per layer="
          f"{per_token} (an up-projected K / V cache: {kv_token}, "
          f"{kv_token / per_token}x)", flush=True)
    if not equal or step_launches:
        raise RuntimeError("the deepseek decode step's graph replay differs "
                           "from the eager step, or it launched "
                           "flash_attention")
    del cache, engine
    toks = torch.randint(1, cfg.vocab_size, (4, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    flash_attention.launches = 0
    h, stats = forward_with_stats(params, cfg, toks)
    torch.cuda.synchronize()
    launched = flash_attention.launches
    load = int(stats["expert_load"].sum())
    want_load = 4 * 64 * cfg.moe_top_k * n_moe
    print(f"{cfg.name} forward of (4, 64) tokens: flash_attention.launches="
          f"{launched} (want {cfg.num_layers}) expert_load sum={load} (want "
          f"{want_load}) finite={bool(torch.isfinite(h).all())} "
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)
    if launched != cfg.num_layers or load != want_load or \
            not bool(torch.isfinite(h).all()):
        raise RuntimeError(f"deepseek forward: {launched} launches, "
                           f"expert_load {load}")
    del params, h
    torch.cuda.empty_cache()


def mla_phase(args, gen, dev, segment_fold, flash_attention) -> tuple:
    """Phase 15: (a) the flash cases m1-m3 and the padded backward, (b) the
    smoke model card vs CPU, (c) deepseek-v2-236b at full width, 4 layers.
    -> (the m rows, the backward row)."""
    rows, bwd = mla_flash_cases(gen, dev)
    deepseek_reference(args)
    torch.cuda.empty_cache()
    deepseek_phase(args, segment_fold, flash_attention)
    return rows, bwd


# ---------------------------------------------------------------------------
# phase 16: the mesh tier — the monoid shuffle across ranks
# ---------------------------------------------------------------------------

# qwen3-0.6b's gradient tree for the gradient folds of 16(b): the embedding,
# the final norm and the first layers.  The whole tree is 2.38 GB in f32 a
# microbatch value for each of 4 ranks on one card, and gloo stages every
# collective through the host; PERF.md section 4 gives the measured cut
MESH_GRAD_LAYERS = 4
MESH_OVERLAP_REPS = 3     # runs of each schedule behind a measured overlap
MESH_KEYS = 65536
GLOO_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.uint8,
               torch.bool, torch.int8, torch.int32, torch.int64)


def _timed_ms(fn):
    """(fn(), wall ms) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _store(store_path, world):
    return torch.distributed.FileStore(store_path, world)


def _mesh_records(seed: int, dev):
    keys_np, vals_np = mapreduce_records(seed)
    return {"key": torch.from_numpy(keys_np).to(dev),
            "value": torch.from_numpy(vals_np).to(dev)}


def _mesh_jobs():
    from repro_torch.core import MapReduceJob, average_by_key_job, monoids
    return {"mean": average_by_key_job(MESH_KEYS),
            "max": MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                                monoid=monoids.max_, num_keys=MESH_KEYS)}


def _mesh_run_sharded(records, mesh, axis: str) -> list:
    """run_sharded for both jobs and every strategy (Algorithm 4 on the
    first 2**12 records: the scan tier is a per-record loop, as phase 6
    cuts it), with its segment_fold launches, per-axis bytes, the plan and
    its local phase (run_local of this rank's block) timed apart."""
    from repro_torch import dist
    from repro_torch.core import STRATEGIES
    from repro_torch.kernels.segment_fold import segment_fold

    P = dist.mesh_axis_sizes(mesh)[axis]
    rows = []
    for name, job in _mesh_jobs().items():
        for strategy in STRATEGIES:
            count = 1 << 12 if strategy == "in_mapper" else \
                records["key"].numel()
            recs = {k: v[:count] for k, v in records.items()}
            block = dist.local_block(recs, mesh, axis)
            job.run_sharded(recs, mesh, axis_name=axis, strategy=strategy)
            segment_fold.launches = 0
            dist.reset_counts()
            out, total_ms = _timed_ms(lambda: job.run_sharded(
                recs, mesh, axis_name=axis, strategy=strategy))
            launches, counts = segment_fold.launches, dist.counts()
            job.run_local(block, strategy=strategy, num_shards=1)
            _, local_ms = _timed_ms(lambda: job.run_local(
                block, strategy=strategy, num_shards=1))
            plan = job.plan(recs, strategy=strategy, num_shards=P,
                            axis_name=axis)
            rows.append(dict(
                job=name, strategy=strategy, count=count, out=out.cpu(),
                local=job.run_local(recs, strategy=strategy,
                                    num_shards=P).cpu(),
                launches=launches, tier=plan.local_tier.kind,
                shuffle=plan.shuffle_algorithm or "",
                plan_wire=plan.collective_wire_bytes,
                predicted_us=plan.predicted_us, counts=counts,
                total_ms=total_ms, local_ms=local_ms))
    return rows


def _mesh_nccl_rank(rank, world, store_path, seed, backend="nccl",
                    device="cuda:0"):
    """16(a): NCCL, a world of one on the card, mesh (1,) 'data'."""
    from repro_torch.core import execute_fold, monoids
    from repro_torch.launch.mesh import init_distributed, make_mesh

    dev = torch.device(device)
    init_distributed(backend, rank, world, _store(store_path, world),
                     device=dev)
    mesh = make_mesh((world,), ("data",), device=dev)
    backend = torch.distributed.get_backend(mesh.get_group("data"))
    records = _mesh_records(seed, dev)
    rows = _mesh_run_sharded(records, mesh, "data")
    keys, vals = records["key"], records["value"][:, None]
    table, plan = execute_fold(monoids.max_, vals, segment_ids=keys,
                               num_segments=MESH_KEYS, mesh_axes=("data",),
                               mesh=mesh, with_plan=True)
    keyed_ok = torch.equal(table, execute_fold(
        monoids.max_, vals, segment_ids=keys, num_segments=MESH_KEYS))
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn((16, 4096), generator=gen, device=dev)
    flat_ok = torch.equal(
        execute_fold(monoids.sum_, flat, mesh_axes=("data",), mesh=mesh),
        execute_fold(monoids.sum_, flat))
    return dict(backend=backend, rows=rows, keyed_ok=keyed_ok,
                keyed_plan=plan.describe(), flat_ok=flat_ok)


def _gloo_caps(mesh, dev) -> dict:
    """Which collectives gloo refuses for CUDA tensors, per dtype: the
    port's collectives call each one directly (``repro_torch.dist``)."""
    import torch.distributed as tdist

    g = mesh.get_group("data")
    n = tdist.get_world_size(g)
    refused = {}
    for dt in GLOO_DTYPES:
        x = torch.ones(4 * n, dtype=dt, device=dev)
        calls = {f"all_reduce[{op}]": (lambda op=op: tdist.all_reduce(
            x.clone(), getattr(tdist.ReduceOp, op), group=g))
            for op in ("SUM", "MAX", "MIN")}
        calls["all_gather_into_tensor"] = lambda: \
            tdist.all_gather_into_tensor(x.new_empty(4 * n * n), x, group=g)
        calls["reduce_scatter_tensor"] = lambda: \
            tdist.reduce_scatter_tensor(x.new_empty(4), x, group=g)
        calls["all_to_all_single"] = lambda: \
            tdist.all_to_all_single(torch.empty_like(x), x, group=g)
        for what, call in calls.items():
            try:
                call()
                torch.cuda.synchronize()
            except Exception as e:      # reported: the phase then fails
                refused[f"{what} {dt}"] = f"{type(e).__name__}: {e}"
    return refused


def _grad_shapes(layers: int):
    """qwen3-0.6b's parameter tree on meta: the embedding, the final norm
    and its first ``layers`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, torch.Generator(), device="meta")
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": params["layers"][:layers]}


def _grad_leaf(shape, seed, rank, leaf, dev, n=2):
    """Rank ``rank``'s n microbatch gradients of one leaf, f32 on the card
    (a generator per leaf, so the dense sum is built one leaf at a time)."""
    gen = torch.Generator(device=dev).manual_seed(
        (seed * 1000 + rank) * 1000 + leaf)
    return torch.randn((n,) + tuple(shape), generator=gen, device=dev)


def _grad_err(out, shapes, seed, world, dev) -> float:
    """max |out - the dense sum over every rank and microbatch|, leaf by
    leaf (the dense tree is never whole on the card)."""
    err = 0.0
    for i, (o, s) in enumerate(zip(pytree.tree_leaves(out),
                                   pytree.tree_leaves(shapes))):
        dense = torch.zeros(s.shape, device=dev)
        for r in range(world):
            dense += _grad_leaf(s.shape, seed, r, i, dev).sum(0)
        err = max(err, float((o - dense).abs().max()))
        del dense
    return err


def _median_ms(fn, reps=MESH_OVERLAP_REPS) -> float:
    return float(np.median([_timed_ms(fn)[1] for _ in range(reps)]))


def _mesh_grad_folds(mesh, seed, rank, world, layers, dev) -> list:
    """execute_fold(sum) over the gradient tree across ('data', 'pod'),
    scan and async, dense and lossy: output (+ the pod-summed error
    feedback) against the dense sum, the bytes each axis moved against
    the plan's, the plan's time beside the measured one, and for async
    the measured overlap: the serial, double-buffered and DCN-free
    schedules, each through async_microbatch_fold, each the median of
    MESH_OVERLAP_REPS runs after execute_fold's warm-up and timed run."""
    from repro_torch import dist
    from repro_torch.core import execute_fold, fold_stats, monoids
    from repro_torch.core.calibration import fit_overlap_frac
    from repro_torch.dist.collectives import async_microbatch_fold
    from repro_torch.optim.compress import LossySpec

    shapes = _grad_shapes(layers)
    leaves, spec_tree = pytree.tree_flatten(shapes)
    xs = pytree.tree_unflatten(
        [_grad_leaf(s.shape, seed, rank, i, dev)
         for i, s in enumerate(leaves)], spec_tree)
    value_bytes = sum(s.numel() * 4 for s in leaves)
    _, local_ms = _timed_ms(lambda: execute_fold(monoids.sum_, xs,
                                                 layout="scan"))
    rows = []
    for layout in ("scan", "async"):
        for lossy in (None, "topk:0.01", "int8"):
            def run():
                return execute_fold(monoids.sum_, xs, mesh_axes=("data",
                                                                 "pod"),
                                    layout=layout, lossy=lossy, mesh=mesh,
                                    with_plan=True)
            run()                                         # warm-up
            dist.reset_counts()
            (res, plan), ms = _timed_ms(run)
            counts = dist.counts()
            out, ef = res if lossy else (res, None)
            del res
            if ef is not None:
                with dist.use_mesh(mesh):
                    out = pytree.tree_map(torch.add, out,
                                          dist.psum(ef, "pod"))
                del ef
            err = _grad_err(out, shapes, seed, world, dev)
            del out
            stats = fold_stats(plan).with_measured(ms * 1e3)
            overlap = times = None
            if layout == "async":
                spec = LossySpec.parse(lossy) if lossy else None

                def amf(axes, overlap_on):
                    ef0 = None if spec is None else pytree.tree_map(
                        lambda t: torch.zeros_like(t[0]), xs)
                    with dist.use_mesh(mesh):
                        return async_microbatch_fold(
                            monoids.sum_, xs, axes, lossy=spec, ef=ef0,
                            overlap=overlap_on)
                times = {
                    "serial": _median_ms(lambda: amf(("data", "pod"), False)),
                    "dbuf": _median_ms(lambda: amf(("data", "pod"), True)),
                    "compute": _median_ms(lambda: amf(("data",), True))}
                overlap = fit_overlap_frac(
                    t_serial_us=times["serial"] * 1e3,
                    t_dbuf_us=times["dbuf"] * 1e3,
                    t_compute_us=times["compute"] * 1e3)
                stats = stats.with_measured(ms * 1e3, overlap=overlap)
            rows.append(dict(
                layout=layout, lossy=lossy or "dense", ms=ms,
                local_ms=local_ms, err=err, counts=counts,
                kind=plan.local_tier.kind,
                tier_wire=[(t.kind, t.wire_bytes) for t in plan.tiers],
                plan_wire=plan.collective_wire_bytes,
                dense_wire=plan.dense_wire_bytes,
                lossy_wire=plan.lossy_wire_bytes,
                predicted_us=plan.predicted_us, measured_us=ms * 1e3,
                overlap_modeled=stats.overlap_modeled,
                overlap_measured=stats.overlap_measured,
                schedule_ms=times, value_bytes=value_bytes))
    return rows


def _mesh_gloo_rank(rank, world, store_path, seed, layers, device="cuda:0"):
    """16(b): gloo, ``world`` ranks on cuda:0, mesh (2, 2) ('pod', 'data')."""
    from repro_torch import dist
    from repro_torch.core import execute_fold
    from repro_torch.data import (init_stats, make_stream_stats, sync_stats,
                                  update_stats)
    from repro_torch.dist.collectives import combine_keyed_table
    from repro_torch.kernels.cms import cms_counts
    from repro_torch.launch.mesh import init_distributed, make_mesh

    dev = torch.device(device)
    init_distributed("gloo", rank, world, _store(store_path, world),
                     device=dev)
    mesh = make_mesh((2, world // 2), ("pod", "data"), device=dev)
    backend = torch.distributed.get_backend(mesh.get_group("data"))
    refused = _gloo_caps(mesh, dev)
    records = _mesh_records(seed, dev)
    rows = _mesh_run_sharded(records, mesh, "data")
    # both shuffle algorithms, forced, over both axes: each rank's quarter
    forced = {}
    block = dist.local_block(records, mesh, ("pod", "data"))
    for name, job in _mesh_jobs().items():
        local = execute_fold(job.monoid, block["value"],
                             segment_ids=block["key"].to(torch.int32),
                             num_segments=MESH_KEYS, lifted=False)
        for algo in ("allreduce", "reduce_scatter"):
            with dist.use_mesh(mesh):
                t = combine_keyed_table(job.monoid, local, "data",
                                        algorithm=algo)
                t = combine_keyed_table(job.monoid, t, "pod",
                                        algorithm=algo)
            forced[(name, algo)] = torch.func.vmap(job.monoid.extract)(
                t).cpu()
        forced[(name, "local")] = job.run_local(
            records, strategy="combiner", num_shards=world).cpu()
    # stream stats: this host's 4 of the 16 batches, then sync_stats
    m = make_stream_stats()
    cms_counts.launches = 0
    state = init_stats(m, device=dev)
    for toks, mask in stream_batches(seed, dev, count=16 // world,
                                     start=rank * (16 // world)):
        state = update_stats(state, toks, valid_mask=mask)
    cms_launches = cms_counts.launches
    dist.reset_counts()
    synced, sync_ms = _timed_ms(lambda: sync_stats(
        m, state, ("data", "pod"), mesh=mesh))
    stats = dict(state={k: v.cpu() for k, v in synced.items()},
                 counts=dist.counts(), ms=sync_ms, cms_launches=cms_launches)
    del records, block
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grads = _mesh_grad_folds(mesh, seed, rank, world, layers, dev)
    grads_s = time.perf_counter() - t0
    return dict(backend=backend, refused=refused, rows=rows, forced=forced,
                stats=stats, grads=grads, grads_s=grads_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _mean_oracle(keys_np, vals_np, count):
    sums = np.zeros(MESH_KEYS, np.float64)
    np.add.at(sums, keys_np[:count], vals_np[:count].astype(np.float64))
    cnt = np.maximum(np.bincount(keys_np[:count], minlength=MESH_KEYS), 1)
    return sums / cnt


def _check_job_rows(rank, rows, keys_np, vals_np, on_card=True) -> None:
    """Max exact against run_local(num_shards=world); mean within 1e-5 of
    the float64 oracle (index_add_'s atomics sum in run-dependent order,
    so a float sum is never bit-exact on the card); segment_fold launched
    as the plan's tier says."""
    for r in rows:
        out = r["out"].numpy().astype(np.float64)
        if r["job"] == "max":
            if not torch.equal(r["out"], r["local"]):
                raise RuntimeError(f"rank {rank} max {r['strategy']}: "
                                   "run_sharded != run_local")
            err = 0.0
        else:
            err = float(np.abs(out - _mean_oracle(keys_np, vals_np,
                                                   r["count"])).max())
            if not err <= 1e-5:
                raise RuntimeError(f"rank {rank} mean {r['strategy']}: "
                                   f"max |out - f64 oracle| = {err}")
        want = 1 if r["tier"] == "kernel" else 0
        if r["launches"] != want:
            raise RuntimeError(
                f"rank {rank} {r['job']} {r['strategy']}: segment_fold "
                f"launched {r['launches']} times on the {r['tier']} tier")
        if on_card and r["job"] == "max" and r["strategy"] != "in_mapper" \
                and r["tier"] != "kernel":
            raise RuntimeError(f"max {r['strategy']} left the kernel tier")
        print(f"  rank {rank} {r['job']}_by_key {r['strategy']}: records="
              f"{r['count']} tier={r['tier']} shuffle={r['shuffle']} "
              f"segment_fold.launches={r['launches']} "
              f"local_ms={r['local_ms']} shuffle_ms="
              f"{r['total_ms'] - r['local_ms']} total_ms={r['total_ms']} "
              f"predicted_us={r['predicted_us']} bytes={r['counts']} "
              f"plan_shuffle_bytes_xla={r['plan_wire']} "
              f"max_abs_err_vs_f64={err}", flush=True)


def mesh_phase(args, dev) -> dict:
    """Phase 16: (a) NCCL, a world of one: run_sharded for both jobs and every strategy, a keyed and a flat
    execute_fold(mesh_axes=); (b) gloo, 4 ranks on cuda:0, mesh (2, 2)
    (pod, data): run_sharded, both shuffle algorithms forced,
    sync_stats over phase 5's 16 batches (== the single-host state bit
    for bit) and the gradient folds.  -> launches on this path."""
    from repro_torch.data import init_stats, make_stream_stats, update_stats
    from repro_torch.launch.mesh import run_world

    keys_np, vals_np = mapreduce_records(args.seed)
    t0 = time.perf_counter()
    (res_a,) = run_world(_mesh_nccl_rank, 1, args=(args.seed,),
                         timeout_s=300)
    print(f"mesh (a): backend={res_a['backend']} world=1 mesh=(1,) data; "
          f"spawn + run {time.perf_counter() - t0:.1f}s", flush=True)
    _check_job_rows(0, res_a["rows"], keys_np, vals_np)
    if not (res_a["keyed_ok"] and res_a["flat_ok"]):
        raise RuntimeError("mesh (a): execute_fold(mesh_axes=('data',)) != "
                           "the local fold")
    print(f"  execute_fold(mesh_axes=('data',)): keyed max-by-key == local "
          f"(plan {res_a['keyed_plan']}), flat sum == local", flush=True)
    launches = sum(r["launches"] for r in res_a["rows"])

    world = 4
    t0 = time.perf_counter()
    ranks = run_world(_mesh_gloo_rank, world,
                      args=(args.seed, args.mesh_layers), timeout_s=600)
    print(f"mesh (b): backend={ranks[0]['backend']} world={world} on one "
          f"card, mesh (2, 2) (pod, data); spawn + run "
          f"{time.perf_counter() - t0:.1f}s (host loopback wires: no link "
          "coefficient is fitted from these times)", flush=True)
    for rank, res in enumerate(ranks):
        if res["refused"]:
            raise RuntimeError(f"gloo refused CUDA tensors: {res['refused']}"
                               " (repro_torch.dist calls each directly)")
    print(f"  gloo took all_reduce sum / max / min, all_gather_into_tensor, "
          f"reduce_scatter_tensor and all_to_all_single on CUDA tensors of "
          f"{', '.join(str(d).replace('torch.', '') for d in GLOO_DTYPES)}",
          flush=True)
    for rank, res in enumerate(ranks):
        _check_job_rows(rank, res["rows"], keys_np, vals_np)
        launches += sum(r["launches"] for r in res["rows"])
        f = res["forced"]
        for algo in ("allreduce", "reduce_scatter"):
            if not torch.equal(f[("max", algo)], f[("max", "local")]):
                raise RuntimeError(f"rank {rank}: forced {algo} max != "
                                   "run_local(num_shards=4)")
            err = float(np.abs(f[("mean", algo)].numpy().astype(np.float64)
                               - _mean_oracle(keys_np, vals_np,
                                              keys_np.size)).max())
            if not err <= 1e-5:
                raise RuntimeError(f"rank {rank}: forced {algo} mean err "
                                   f"{err}")
        print(f"  rank {rank} combine_keyed_table over data then pod, both "
              "algorithms: max == run_local(num_shards=4), mean within "
              "1e-5 of f64", flush=True)
    # sync_stats == the single-host state of the 16 batches, bit for bit
    m = make_stream_stats()
    single = init_stats(m, device=dev)
    for toks, mask in stream_batches(args.seed, dev):
        single = update_stats(single, toks, valid_mask=mask)
    for rank, res in enumerate(ranks):
        st = res["stats"]
        for k, v in single.items():
            if not torch.equal(st["state"][k], v.cpu()):
                raise RuntimeError(f"rank {rank}: sync_stats {k} != the "
                                   "single-host state")
        if st["cms_launches"] != 16 // world:
            raise RuntimeError(f"rank {rank}: cms_update launched "
                               f"{st['cms_launches']} times")
        launches += st["cms_launches"]
        print(f"  rank {rank} sync_stats over (data, pod) of its "
              f"{16 // world} batches == the 16-batch single-host state "
              f"(cms, hll, bloom, count bit for bit); cms_update.launches="
              f"{st['cms_launches']} sync_ms={st['ms']} bytes={st['counts']}",
              flush=True)
    del single
    # the gradient folds
    for rank, res in enumerate(ranks):
        for g in res["grads"]:
            pod = g["counts"].get("pod", {})
            data = g["counts"].get("data", {})
            want = g["lossy_wire"] if g["lossy"] != "dense" else \
                g["dense_wire"]
            if not g["err"] <= 1e-4:
                raise RuntimeError(f"rank {rank} grad fold {g['layout']} "
                                   f"{g['lossy']}: |out (+ ef) - dense| = "
                                   f"{g['err']}")
            if pod.get("wire_bytes") != want:
                raise RuntimeError(f"rank {rank} grad fold {g['layout']} "
                                   f"{g['lossy']}: pod moved {pod} bytes, "
                                   f"the plan {want}")
            if g["lossy"] != "dense" and not want < g["dense_wire"]:
                raise RuntimeError(f"lossy DCN bytes {want} not below "
                                   f"dense {g['dense_wire']}")
            if g["kind"] != g["layout"]:
                raise RuntimeError(f"grad fold planned {g['kind']}")
            print(f"  rank {rank} grad fold {g['layout']} {g['lossy']}: "
                  f"value={g['value_bytes']}B x 2 microbatches "
                  f"local_ms={g['local_ms']} ms={g['ms']} "
                  f"predicted_us={g['predicted_us']} "
                  f"measured_us={g['measured_us']} max_abs_err={g['err']} "
                  f"pod_wire={pod.get('wire_bytes')} (plan lossy "
                  f"{g['lossy_wire']} / dense {g['dense_wire']}) "
                  f"data_wire={data.get('wire_bytes')} pod_calls="
                  f"{pod.get('calls')} plan_tiers={g['tier_wire']} "
                  f"overlap_modeled={g['overlap_modeled']} "
                  f"overlap_measured={g['overlap_measured']} "
                  f"schedule_median_ms={g['schedule_ms']}", flush=True)
        print(f"  rank {rank} grad_folds_s={res['grads_s']} "
              f"peak_mem_GiB={res['peak_gib']}", flush=True)
    # the cut, with what this run measured: the whole tree scaled linearly
    whole = sum(t.numel() * 4 for t in pytree.tree_leaves(_grad_shapes(28)))
    value = ranks[0]["grads"][0]["value_bytes"]
    scale = whole / value
    print(f"mesh: reduced: qwen3-0.6b gradient tree cut to the embedding, the "
          f"final norm and the first {args.mesh_layers} of 28 layers "
          f"({value} of {whole} B a microbatch value); at this run's "
          f"{max(r['grads_s'] for r in ranks):.1f} s and "
          f"{max(r['peak_gib'] for r in ranks):.2f} GiB a rank, the whole "
          f"tree would take ~{max(r['grads_s'] for r in ranks) * scale:.0f} "
          f"s and ~{world * max(r['peak_gib'] for r in ranks) * scale:.0f} "
          "GiB of the card for 4 ranks; Algorithm 4 on 2**12 records",
          flush=True)
    return {"segment_fold_and_cms_update": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--serve-only", action="store_true",
                    help="run phases 1 and 3 only and print no record (to "
                         "compare the serve path of two checkouts, each "
                         "with this script at its root, in one session)")
    ap.add_argument("--train-only", action="store_true",
                    help="run phases 1 and 14 (training) only and print no "
                         "record")
    ap.add_argument("--mla-only", action="store_true",
                    help="run phases 1 and 15 (MLA, deepseek-v2-236b) only "
                         "and print no record")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1 and 16 (the mesh tier) only and "
                         "print no record")
    ap.add_argument("--mesh-layers", type=int, default=MESH_GRAD_LAYERS,
                    help="qwen3-0.6b layers in phase 16's gradient tree")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(_HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.cms import LIBRARY as CMS_LIBRARY
    from repro_torch.kernels.flash_attention import BWD_LIBRARY
    from repro_torch.kernels.flash_attention import LIBRARY as FLASH_LIBRARY
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.segment_fold import LIBRARY as FOLD_LIBRARY
    from repro_torch.kernels.segment_fold import (segment_fold,
                                                  segment_fold_plain)
    from repro_torch.kernels.stripes import LIBRARY as STRIPES_LIBRARY

    # phase 1: environment
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.serve_only:
        serve_full(args, segment_fold, flash_attention)
        print(f"card: {card}")
        return 0

    # phase 2: build from the checkout's sources, then kernel vs plain
    t0 = time.perf_counter()
    libs = build_all([FOLD_LIBRARY, CMS_LIBRARY, STRIPES_LIBRARY,
                      FLASH_LIBRARY, BWD_LIBRARY])
    print(f"built {[os.path.relpath(p, _HERE) for p in libs]} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.train_only:
        t0 = time.perf_counter()
        training_phase(args, gen, dev)
        print(f"phase 14 took {time.perf_counter() - t0:.1f}s", flush=True)
        print(f"card: {card}")
        return 0
    if args.mla_only:
        t0 = time.perf_counter()
        mla_phase(args, gen, dev, segment_fold, flash_attention)
        print(f"phase 15 took {time.perf_counter() - t0:.1f}s", flush=True)
        print(f"card: {card}")
        return 0
    if args.mesh_only:
        t0 = time.perf_counter()
        mesh_phase(args, dev)
        print(f"phase 16 took {time.perf_counter() - t0:.1f}s", flush=True)
        print(f"card: {card}")
        return 0
    rows = []
    for case in kernel_cases(gen, dev):
        row = run_kernel_case(case, segment_fold, segment_fold_plain)
        rows.append(row)
        print_row("segment_fold", row)
        torch.cuda.empty_cache()

    batches = stream_batches(args.seed, dev)
    for case in path_fold_cases(batches[0], *mapreduce_records(args.seed),
                                dev):
        row = run_kernel_case(case, segment_fold, segment_fold_plain)
        rows.append(row)
        print_row("segment_fold", row)
    torch.cuda.empty_cache()
    zipf = corpus_tokens(151936, 1 << 24, args.seed + 1, dev)
    uniform = torch.randint(0, 151936, (1 << 24,), generator=gen, device=dev,
                            dtype=torch.int32)
    path_toks, path_mask = (t.reshape(-1) for t in batches[0])
    mask90 = torch.rand((zipf.numel(),), generator=gen, device=dev) < 0.9
    cms_rows = [
        run_cms_case("4x2048 N=2^24 Zipf (shared table)", zipf, 4, 2048,
                     None),
        run_cms_case("5x65536 N=2^24 Zipf (1.31 MB table)", zipf, 5, 65536,
                     None),
        run_cms_case("4x2048 N=2^24 Zipf, 90% mask", zipf, 4, 2048, mask90),
        run_cms_case("stream-stats batch: 4x2048 N=524288 ragged mask",
                     path_toks, 4, 2048, path_mask.to(torch.int32)),
        # the call update_stats makes: int32 ids, the bool mask as it is
        run_cms_case("stream-stats batch as update_stats passes it: int32 "
                     "tokens, bool mask", path_toks, 4, 2048, path_mask,
                     path=True),
        run_cms_case("stream-stats batch, int64 tokens and bool mask",
                     path_toks.long(), 4, 2048, path_mask),
        # uniform ids: no hot id, so what the global regime's sample costs
        run_cms_case("4x2048 N=2^24 uniform", uniform, 4, 2048, None),
        run_cms_case("5x65536 N=2^24 uniform (1.31 MB table)", uniform, 5,
                     65536, None),
    ]
    for row in cms_rows:
        print_row("cms_update", row)
    del mask90, uniform
    torch.cuda.empty_cache()
    toks4096 = corpus_tokens(4096, 1 << 24, args.seed + 2, dev)
    stripes_rows = [
        run_stripes_case("V=4096 W=4 N=2^24 corpus (64 MB global table)",
                         toks4096, 4096, 4, path=True),
        run_stripes_case("V=128 W=4 N=2^24 corpus (shared table)",
                         corpus_tokens(128, 1 << 24, args.seed + 3, dev),
                         128, 4),
        run_stripes_case("V=4096 W=4 N=2^24 uniform (64 MB global table)",
                         torch.randint(0, 4096, (1 << 24,), generator=gen,
                                       device=dev, dtype=torch.int32),
                         4096, 4),
    ]
    for row in stripes_rows:
        print_row("stripes", row)
        print(f"  pairs={row['pairs']}", flush=True)
    torch.cuda.empty_cache()
    flash_rows = [run_flash_case(case, gen, dev) for case in FLASH_CASES]
    for row in flash_rows:
        print_row("flash_attention", row)
        print(f"  flops={row['flops']} bytes={row['bound_bytes']} "
              f"device_ms={row['device_ms']} (graph replay; SDPA "
              f"{row['library_device_ms']})"
              + "".join(f" {k}={v}" for k, v in row["controls"].items()),
              flush=True)
    torch.cuda.empty_cache()
    bad = [r["name"] for r in rows + cms_rows + stripes_rows + flash_rows
           if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{bad}")

    # phase 3: the serving path (the prefix cache on, the default)
    serve_launches, flash_launches, engine = serve_full(
        args, segment_fold, flash_attention)
    # phase 4: small-input reference
    serve_reference(args)
    # phase 5: the stream-stats path
    stream_launches = stream_stats_phase(batches, dev)
    # phase 6: the MapReduce path
    mapreduce_phase(args.seed, dev,
                    torch.cat([t.reshape(-1) for t, _ in batches]))
    # phase 7: Algorithm 5
    stripes_launches = algorithm5_phase(toks4096, 4096, 4)
    del toks4096, zipf
    torch.cuda.empty_cache()
    # phase 8: the prefix cache's warm prefill
    prefix_rows, prefix_launches = prefix_phase(args, engine,
                                                flash_attention, gen, dev)
    print(f"prefix phase: flash_attention launches over the measured warm "
          f"and cold passes = {prefix_launches} (28 per prefill call)",
          flush=True)
    # phase 8, continued: the sliding window in flash_attention
    window_cases(gen, dev)
    torch.cuda.empty_cache()
    # phase 9: gemma3-1b's 5:1 local:global stack through the serve CLI
    gemma_reference(args)
    gemma_phase(args, segment_fold, flash_attention)
    torch.cuda.empty_cache()
    # phase 10: streaming windows on the card
    windows_phase(args, segment_fold, dev)
    # phase 11: the MoE family (the earlier phases' models freed first)
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_grouped_cases(args, dev)
    torch.cuda.empty_cache()
    moe_reference(args)
    moe_phase(args, segment_fold, flash_attention)
    print(f"phase 11 took {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 12: the context-conditioned family
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path_flash_cases(FLASH_CONTEXT_CASES, "the context shapes", gen, dev)
    context_reference(args)
    whisper_phase(args, flash_attention)
    vision_phase(args, flash_attention)
    print(f"phase 12 took {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 13: the recurrent family
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path_flash_cases(FLASH_JAMBA_CASES, "jamba's shape", gen, dev)
    recurrent_reference(args)
    xlstm_phase(args, segment_fold, flash_attention)
    jamba_phase(args, flash_attention)
    print(f"phase 13 took {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 14: training on flash_attention's backward
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bwd_row, bwd_launches = training_phase(args, gen, dev)
    print(f"phase 14 took {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 15: MLA and deepseek-v2-236b on flash_attention at dv != d
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mla_phase(args, gen, dev, segment_fold, flash_attention)
    print(f"phase 15 took {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 16: the mesh tier, the monoid shuffle across ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_phase(args, dev)
    print(f"phase 16 took {time.perf_counter() - t0:.1f}s", flush=True)

    def entry(name, source, replaces, launches, row):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row.get("bound_by", "bytes"),
                "library_ms": row["library_ms"]}

    record = {"kernels": [
        entry("segment_fold", "segment_fold.cu",
              "src/repro/kernels/segment_fold.py:86", serve_launches,
              next(r for r in rows if r["serve"])),
        entry("cms_update", "cms_update.cu", "src/repro/kernels/cms.py:50",
              stream_launches["cms_update"],
              next(r for r in cms_rows if r["path"])),
        entry("stripes", "stripes.cu", "src/repro/kernels/stripes.py:47",
              stripes_launches, next(r for r in stripes_rows if r["path"])),
        entry("flash_attention", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:68", flash_launches,
              next(r for r in flash_rows if r["path"])),
        dict(entry("flash_attention_bwd", "flash_attention_bwd.cu",
                   "src/repro/models/attention.py:151 (XLA autodiff of the "
                   "attention; no TPU kernel)", bwd_launches, bwd_row),
             fwd_bwd_ms=bwd_row["fwd_bwd_ms"],
             library_fwd_bwd_ms=bwd_row["library_fwd_bwd_ms"],
             design=bwd_row["design"]),
    ]}
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
