"""Continuous-batching serving entry point on the card: decode as a rolling keyed
MapReduce.  The port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --full \\
      --requests 16 --slots 8 --buckets 16,32,64 --gen 32 --prefill-batch 4

This module wires the model substrate (configs + models) into the
model-agnostic :class:`repro_torch.runtime.engine.ContinuousEngine` and hosts
the CLI.  Requests arrive on a Poisson trace, queue FIFO, and are admitted
into rolling slots; each decode step folds the per-request metrics through
ONE planner-lowered keyed fold — on the card, one launch of the CUDA
``segment_fold`` kernel — and each admission's prefill runs the bucket in
one pass, one launch of the CUDA ``flash_attention`` kernel per layer.
Everything runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); there is no silent fallback.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..models import decode_step, init_cache, init_params, prefill
from ..models.common import ModelConfig
from ..runtime.engine import (ContinuousEngine, EngineBackend, ServeConfig,
                              decode_metrics_plan)


def make_backend(cfg: ModelConfig, params: Any, config: ServeConfig,
                 device) -> EngineBackend:
    """An :class:`EngineBackend` over the dense transformer: a one-token
    decode, a one-pass prefill of a padded bucket and a cache constructor
    with per-slot positions."""
    if config.model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1 needs the mesh tier, a later slice of the "
            "port (ROADMAP: mesh tier)")

    def decode(p, cache, cur):
        logits, cache = decode_step(p, cfg, cache, cur)
        return logits[:, -1].to(torch.float32), cache

    def prefill_bucket(p, cache, toks, lengths):
        return prefill(p, cfg, cache, toks, lengths)

    def make_cache(batch: int, pos_per_slot: bool):
        return init_cache(params, cfg, batch, config.max_seq,
                          pos_per_slot=pos_per_slot)

    return EngineBackend(decode=decode, init_cache=make_cache, params=params,
                         vocab_size=cfg.vocab_size, device=torch.device(device),
                         prefill=prefill_bucket)


def build_engine(config: ServeConfig, *, device="cuda",
                 params: Optional[Any] = None,
                 clock=time.perf_counter) -> ContinuousEngine:
    """A :class:`ContinuousEngine` over the real model substrate.

    ``params`` defaults to random weights drawn from ``config.seed`` with a
    ``torch.Generator`` on ``device`` (shapes and scales of the JAX
    package's init, not its numbers); pass carried-over weights
    (``models.convert.params_from_jax``) to serve those.
    """
    device = resolve_device(device)
    cfg = get_config(config.arch, smoke=not config.full)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed)
        params = init_params(cfg, gen, device=device)
    backend = make_backend(cfg, params, config, device)
    return ContinuousEngine(backend, config, clock=clock)


# ---------------------------------------------------------------------------
# CLI: Poisson arrival trace through the engine
# ---------------------------------------------------------------------------

def poisson_trace(rng: np.random.Generator, n: int, rate_hz: float,
                  min_prompt: int, max_prompt: int, vocab: int,
                  max_new: int, users: int = 1):
    """[(arrival_offset_s, prompt, max_new, user)] — synthetic open-loop
    traffic, draw for draw the JAX package's generator without a shared
    prefix (the prefix-cache slice brings that back)."""
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_hz)) if rate_hz > 0 else 0.0
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(1, vocab, plen).tolist()
        out.append((t, prompt, max_new, int(rng.integers(0, users))))
    return out


def serve_trace(engine: ContinuousEngine, trace, *,
                clock=time.perf_counter, quiet: bool = True):
    """Replay an arrival trace through the engine in real time.  Returns
    ``(results, wall_s)`` with results in submission order."""
    t0 = clock()
    uids = []
    i = 0
    while i < len(trace) or engine.pending or engine.num_active:
        now = clock() - t0
        while i < len(trace) and trace[i][0] <= now:
            _, prompt, max_new, *rest = trace[i]
            uids.append(engine.submit(prompt, max_new_tokens=max_new,
                                      user=rest[0] if rest else 0))
            i += 1
        if engine.pending or engine.num_active:
            for ev in engine.step():
                if not quiet and ev.kind == "done":
                    r = ev.result
                    print(f"  uid={r.uid} slot={r.slot} prompt={r.prompt_len} "
                          f"-> bucket={r.bucket} gen={len(r.tokens)} "
                          f"logprob_sum={r.logprob_sum:.2f} "
                          f"ttft={r.ttft_s * 1e3:.1f}ms")
        elif i < len(trace):
            time.sleep(min(max(trace[i][0] - now, 0.0), 0.01))
    wall = clock() - t0
    return [engine.result(u) for u in uids], wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--buckets", default="8,16",
                    help="comma-separated prefill bucket ladder")
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=12)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (requests/s); 0 = all at once")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-batch", type=int, default=4,
                    help="max same-bucket admissions per prefill program")
    args = ap.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.max_prompt > buckets[-1]:
        raise SystemExit(f"--max-prompt {args.max_prompt} exceeds the "
                         f"largest bucket {buckets[-1]}")
    config = ServeConfig(arch=args.arch, num_slots=args.slots,
                         prefill_buckets=buckets, max_new_tokens=args.gen,
                         temperature=args.temperature, seed=args.seed,
                         full=args.full, prefill_batch=args.prefill_batch)
    engine = build_engine(config, device=args.device)

    plan = decode_metrics_plan(config.num_slots, config.num_slots,
                               device=engine.backend.device)
    print(f"arch={args.arch} device={engine.backend.device} "
          f"slots={config.num_slots} buckets={buckets} gen<={args.gen} "
          f"requests={args.requests} rate={args.rate}/s")
    print(f"per-step aggregation plan: {plan.describe()}")

    rng = np.random.default_rng(args.seed)
    trace = poisson_trace(rng, args.requests, args.rate, args.min_prompt,
                          args.max_prompt, engine.backend.vocab_size,
                          args.gen)
    launches0 = flash_attention.launches
    results, wall = serve_trace(engine, trace, quiet=False)

    ttfts = np.array([r.ttft_s for r in results])
    new_tokens = sum(len(r.tokens) for r in results)
    st = engine.stats
    print(f"served {len(results)} requests, {new_tokens} tokens in "
          f"{wall:.2f}s ({new_tokens / wall:.0f} tok/s) | "
          f"steps={st.steps} slot_reuses={st.slot_reuses} "
          f"prefills={st.prefill_calls} batched={st.batched_admissions} "
          f"flash_attention.launches={flash_attention.launches - launches0} "
          f"ttft p50={np.percentile(ttfts, 50) * 1e3:.1f}ms "
          f"p99={np.percentile(ttfts, 99) * 1e3:.1f}ms")
    print(f"program shapes: {engine.compile_counts()} "
          f"(bound: {engine.compile_bound()})")
    return 0


if __name__ == "__main__":
    main()
