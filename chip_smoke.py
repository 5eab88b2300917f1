"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py [--seed 0] [--requests 16]

Phases, each of which must pass or the script exits non-zero:

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 off for every comparison.
2. kernels: build every CUDA kernel of the serving path from the sources in
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a), launch each at real sizes
   and hold it against its plain PyTorch version; time kernel, plain
   version and the one-call PyTorch yardstick with CUDA events.
3. serve: ``build_engine`` for qwen3-0.6b at full width (28 layers, bf16,
   random weights from ``--seed``) answers ``--requests`` requests; each
   decode step's metrics fold must have launched the CUDA kernel once.
   Then one decode step's eager wall time against its CUDA-graph replay.
4. reference: a small float32 model served on the card and on the CPU with
   the same weights gives the same tokens.

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
    out_elt = 4 if v.dtype.is_floating_point else v.element_size()
    nbytes = (n * d * v.element_size() + 4 * n
              + (n if mask is not None else 0) + S * (d + wc) * out_elt)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(name=case["name"], ok=ok, max_abs_err=err,
                tolerance=f"rtol={case['rtol']} atol={case['atol']}",
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_bytes=nbytes,
                serve=case.get("serve", False))


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------

def serve_full(args, segment_fold):
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
    results, wall = serve_trace(engine, trace)
    torch.cuda.synchronize()
    launches = segment_fold.launches
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
          f"peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30}",
          flush=True)
    print(f"program shapes: {counts} (bound {engine.compile_bound()})")
    decode_breakdown(engine)
    return launches


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


def serve_reference(args):
    """A float32 smoke model on the card vs the same weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousEngine, ServeConfig, make_backend

    config = ServeConfig(num_slots=3, prefill_buckets=(8, 16),
                         max_new_tokens=6, prefill_batch=2, seed=args.seed)
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(args.seed)
    params_cpu = init_params(cfg, gen, device="cpu")
    params_gpu = pytree.tree_map(lambda t: t.to("cuda"), params_cpu)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 16)))
               .tolist() for _ in range(7)]
    out = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = ContinuousEngine(make_backend(cfg, params, config, dev), config)
        uids = [eng.submit(p) for p in prompts]
        for _ in eng.run(max_steps=200):
            pass
        out[dev] = [eng.result(u) for u in uids]
    worst = 0.0
    for a, b in zip(out["cpu"], out["cuda"]):
        if a.tokens != b.tokens or a.stopped != b.stopped:
            raise RuntimeError(f"cuda tokens {b.tokens} != cpu {a.tokens}")
        worst = max(worst, abs(a.logprob_sum - b.logprob_sum))
    if worst > 1e-3:
        raise RuntimeError(f"logprob sums differ by {worst} (> 1e-3)")
    print(f"reference: f32 smoke model, {len(prompts)} requests, cuda tokens "
          f"== cpu tokens, max |logprob_sum diff| = {worst}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.segment_fold import (build, segment_fold,
                                                  segment_fold_plain)

    # phase 1: environment
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2: build from the checkout's sources, then kernel vs plain
    t0 = time.perf_counter()
    lib = build(verbose=True)
    print(f"built {os.path.relpath(lib, _HERE)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for case in kernel_cases(gen, dev):
        row = run_kernel_case(case, segment_fold, segment_fold_plain)
        rows.append(row)
        print(f"kernel segment_fold [{row['name']}]: "
              f"{'OK' if row['ok'] else 'MISMATCH'} "
              f"max_abs_err={row['max_abs_err']} ({row['tolerance']}) "
              f"kernel_ms={row['ms']} plain_ms={row['plain_ms']} "
              f"library_ms={row['library_ms']} bound_ms={row['bound_ms']}",
              flush=True)
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"segment_fold disagrees with its plain version: "
                           f"{bad}")

    # phase 3: the main path
    launches = serve_full(args, segment_fold)
    # phase 4: small-input reference
    serve_reference(args)

    serve_row = next(r for r in rows if r["serve"])
    record = {"kernels": [{
        "name": "segment_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_fold.cu",
        "replaces": "src/repro/kernels/segment_fold.py:86",
        "launches": launches, "max_abs_err": serve_row["max_abs_err"],
        "ms": serve_row["ms"], "plain_ms": serve_row["plain_ms"],
        "bound_ms": serve_row["bound_ms"], "bound_by": "bytes",
        "library_ms": serve_row["library_ms"]}]}
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
