"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py [--seed 0] [--requests 16] [--serve-only]

Phases, each of which must pass or the script exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 off for every comparison.
2. kernels: build every CUDA kernel from the sources in
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once,
   sm_90a), launch each at real sizes and at each path's shapes (for
   ``segment_fold``: serve, ``packed_stats``, max-by-key; for
   ``flash_attention``: the prefill's 4 x 64 bucket in bf16 and f16, S
   4096, ragged, Sq != Sk, head_dim 8), and hold it against its plain
   PyTorch version (16-bit attention also against two lower-precision
   controls it must be told apart from); time kernel, plain version and
   the one-call PyTorch yardstick with CUDA events.  ``segment_fold``,
   ``cms_update`` (Zipf and uniform tokens at 4 x 2048 and 5 x 65536; the
   stream-stats batch with an int32 mask, a bool mask, and int64 tokens)
   and ``stripes`` rows (Zipf and uniform tokens at V 4096) also print the
   device time of kernel and yardstick replayed from a CUDA graph and the
   CUDA launches one call makes (``torch.profiler``'s device events).
3. serve: ``build_engine`` for qwen3-0.6b at full width (28 layers, bf16,
   random weights from ``--seed``) answers ``--requests`` requests; each
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

The last lines are the card, the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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


def cuda_launches(fn):
    """The kernels and memsets one call of ``fn`` puts on the card, counted
    from ``torch.profiler``'s device events; None when the profiler records
    no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return count or None


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
    decode_breakdown(engine)
    return launches, flash_launches


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
    graph_ms = cuda_ms(graph.replay, iters)
    print(f"decode step ({S} slots, full width): eager_wall_ms={eager_ms} "
          f"graph_replay_ms={graph_ms} host_bound_share="
          f"{1 - graph_ms / eager_ms}", flush=True)
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


def stream_batches(seed: int, dev, count: int = 16):
    """The stream-stats path's batches: ragged qwen3-0.6b training data
    (vocab 151936, seq 4096, global batch 128), tokens and masks."""
    from repro_torch.data import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(vocab_size=151936, seq_len=4096,
                                        global_batch=128, seed=seed,
                                        ragged=True), device=dev)
    return [(b["tokens"], b["valid_mask"])
            for b in (corpus(step) for step in range(count))]


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
# is the prefill path's shape (4 prompts x a 64-token bucket, qwen3-0.6b)
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
    i = np.arange(Sq)
    pairs = int(np.minimum(i + 1, Sk).sum()) if causal else Sq * Sk
    return 4 * B * H * pairs * d


def plain_p_rounded(q, k, v, causal):
    """The plain contract with p rounded once to q's 16-bit dtype before
    p v: what a kernel without the p_hi + p_lo split computes."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, KV, H // KV, Sq, d)
    kf = k.to(torch.float32)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(max(Sq, Sk), device=q.device)
        s = s.masked_fill(pos[None, :Sk] > pos[:Sq, None], -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(q.dtype).to(torch.float32),
                     v.to(torch.float32)[:, :, None])
    return (o / p.sum(dim=-1, keepdim=True)).reshape(B, H, Sq, d).to(q.dtype)


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
    if Sq == Sk:     # the yardstick's is_causal mask is ours only at Sq == Sk
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--serve-only", action="store_true",
                    help="run phases 1 and 3 only and print no record (to "
                         "compare the serve path of two checkouts, each "
                         "with this script at its root, in one session)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.cms import LIBRARY as CMS_LIBRARY
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
                      FLASH_LIBRARY])
    print(f"built {[os.path.relpath(p, _HERE) for p in libs]} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
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

    # phase 3: the serving path
    serve_launches, flash_launches = serve_full(args, segment_fold,
                                                flash_attention)
    # phase 4: small-input reference
    serve_reference(args)
    # phase 5: the stream-stats path
    stream_launches = stream_stats_phase(batches, dev)
    # phase 6: the MapReduce path
    mapreduce_phase(args.seed, dev,
                    torch.cat([t.reshape(-1) for t, _ in batches]))
    # phase 7: Algorithm 5
    stripes_launches = algorithm5_phase(toks4096, 4096, 4)

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
    ]}
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
