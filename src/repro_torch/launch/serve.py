"""Continuous-batching serving entry point on the card: decode as a rolling keyed
MapReduce.  The port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --full \\
      --requests 16 --slots 8 --buckets 16,32,64 --gen 32 --prefill-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --full \\
      --requests 16 --slots 8 --buckets 256,512,1024 --min-prompt 520 \\
      --max-prompt 1000 --gen 32 --rate 0 --users 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --full --requests 16 --slots 8 --buckets 16,32,64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --full --requests 16 --slots 8 --buckets 16,32 --min-prompt 8 \
      --max-prompt 32 --gen 32 --rate 0 --temperature 0
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --device cpu --requests 6 --slots 3 \
      --buckets 8,16 --gen 6 --rate 0 --temperature 0

This module wires the model substrate (configs + models) into the
model-agnostic :class:`repro_torch.runtime.engine.ContinuousEngine` and hosts
the CLI.  Requests arrive on a Poisson trace, queue FIFO, and are admitted
into rolling slots; each decode step folds the per-request metrics through
ONE planner-lowered keyed fold — on the card, one launch of the CUDA
``segment_fold`` kernel — and each admission's prefill runs the bucket in
one pass, one launch of the CUDA ``flash_attention`` kernel per layer (an
MoE model's expert products run as grouped products, ``models/moe.py``;
deepseek-v2's MLA attends at q / k 192, v 128 in that launch and decodes
over its latent cache).  deepseek-v2-236b's full config (~236 B parameters)
does not fit one card; its smoke config serves here, and
``build_engine(model_config=)`` serves a depth cut of the full width.
With the radix prefix cache (on by default; ``--no-prefix-cache``) an
admission prefills only its uncached suffix, in the same one pass, each
row's queries at its prefix length.  An arch with a recurrent layer
(xlstm, jamba) has no one-pass prefill: the engine runs the decode step over
the bucket, as the JAX package's engine does for every arch, so a prompt
shorter than its bucket folds its pad tokens into the state, as there; and
its cache is not positional, so the prefix cache stays off.  A
:class:`WindowedMetrics` consumer
subscribed to the engine folds every stream event into per-user sliding
windows and fleet tumbling counters, which the CLI prints at the end (the
``--users`` synthetic users).  ``build_serve_step`` and
``run_batched_decode`` are the pre-engine API, kept as the JAX package
keeps them; ``build_serve_step`` is the one path that serves the
context-conditioned archs (whisper-small, llama-3.2-vision-90b), its cache
holding the projected K/V of a random context, while the engine and the
CLI refuse them as the JAX package's do; with ``model_parallel > 1`` it
serves them across ranks, as the reference's does with a mesh.
Everything runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); there is no silent fallback.

``model_parallel > 1`` serves tensor and expert parallel across the ranks
of a bound ``torch.distributed`` world (``launch.mesh``), every family the
engine serves (MLA and the recurrent archs included): every rank builds
the same engine from the same seed, holding its blocks of the weights and
of the cache (its KV heads, or a recurrent state's channels or heads; an
MLA latent cache whole) (mesh ``(world / model_parallel, model_parallel)`` over
``('data', 'model')``, ``SERVE_RULES``), and runs the same schedule: the
logits are gathered whole on every rank, so every rank samples the same
tokens, and the engine's clock is rank 0's, broadcast at every reading,
so admissions and prefix-cache evictions agree.  Rank 0 reports.  The CLI's
``--model-parallel N`` starts that world itself (``launch.mesh.run_world``:
NCCL with one card a rank, gloo when ranks share a card or run on the
CPU).  Outside a bound world ``model_parallel > 1`` raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..configs import context_spec, get_config
from ..data.windows import WindowedMetrics
from ..device import resolve_device
from ..dist import sharding as shd
from ..kernels.flash_attention import flash_attention
from ..models import (RunCtx, context_conditioned, decode_step, init_cache,
                      init_params, positional_cache, prefill, recurrent)
from ..models.common import ModelConfig
from ..models.transformer import param_axes
from ..runtime.batcher import DecodeBatch
from ..runtime.engine import (ContinuousEngine, EngineBackend, ServeConfig,
                              decode_metrics_plan)


def _refuse_context(cfg: ModelConfig) -> None:
    if context_conditioned(cfg):
        raise NotImplementedError(
            f"{cfg.name}: context-conditioned archs (audio/vision) are not "
            f"supported by the continuous engine yet")


def serve_mesh(config: ServeConfig, device):
    """The mesh ``model_parallel > 1`` serves on: ``(world / mp, mp)`` over
    ``('data', 'model')`` of the bound world; None at ``model_parallel``
    1.  Raises ``ValueError`` outside a bound world."""
    mp = config.model_parallel
    if mp == 1:
        return None
    if not tdist.is_initialized():
        raise ValueError(
            f"model_parallel={mp} cuts the weights over the mesh axis "
            f"'model', which is not bound: start a torch.distributed world "
            f"(repro_torch.launch.mesh.init_distributed, or the CLI's "
            f"--model-parallel) and build the engine on every rank")
    from .mesh import make_host_mesh
    return make_host_mesh(model=mp, device=device)


def shard_for(cfg: ModelConfig, mesh):
    """``init_params``' ``shard=`` hook that keeps this rank's blocks under
    ``SERVE_RULES`` (None without a mesh)."""
    if mesh is None:
        return None
    return lambda tree, axes: shd.shard_params(tree, axes, mesh,
                                               shd.SERVE_RULES)


def agreed_clock(clock: Callable[[], float]) -> Callable[[], float]:
    """``clock`` as rank 0 reads it: one broadcast over the world per
    reading (a host tensor on gloo, the card's on NCCL), so every rank's
    engine takes the same time-dependent decisions."""
    dev = torch.device("cpu") if tdist.get_backend() == "gloo" else \
        torch.device("cuda", torch.cuda.current_device())

    def read() -> float:
        t = torch.tensor([clock()], dtype=torch.float64, device=dev)
        tdist.broadcast(t, src=0)
        return float(t.item())
    return read


def make_backend(cfg: ModelConfig, params: Any, config: ServeConfig,
                 device, mesh=None) -> EngineBackend:
    """An :class:`EngineBackend` over the model substrate: a one-token
    decode, a one-pass prefill of a padded bucket (after each row's cached
    prefix, given ``prefix_len``) and a cache constructor with per-slot
    positions; prefix sharing is on when every cache leaf is indexed by
    position (``positional_cache``).  An arch with a recurrent layer gets
    ``prefill=None``: the engine runs the decode step over the bucket.
    Context-conditioned archs raise the JAX package's
    NotImplementedError.  With a ``mesh`` (``model_parallel > 1``)
    ``params`` are this rank's blocks and every call runs on the mesh; an
    MoE model's expert capacity then holds every routed pair."""
    _refuse_context(cfg)
    if (mesh is None) != (config.model_parallel == 1):
        raise ValueError(f"model_parallel={config.model_parallel} with mesh "
                         f"{mesh}: see serve_mesh")
    ctx = RunCtx(mesh=mesh)
    if mesh is not None and cfg.num_experts:
        # the one-pass prefill routes a whole bucket at once, where the JAX
        # package's engine scans the decode step: an expert capacity of
        # every routed pair (capacity factor = the axis size) drops none,
        # so cutting the model changes no token
        P = shd.mesh_sizes(mesh).get("model", 1)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=max(
            cfg.moe_capacity_factor, float(P)))

    def decode(p, cache, cur):
        logits, cache = decode_step(p, cfg, cache, cur, ctx=ctx)
        return logits[:, -1].to(torch.float32), cache

    def prefill_bucket(p, cache, toks, lengths, prefix_len=None):
        return prefill(p, cfg, cache, toks, lengths, prefix_len, ctx=ctx)

    def make_cache(batch: int, pos_per_slot: bool):
        return init_cache(params, cfg, batch, config.max_seq,
                          pos_per_slot=pos_per_slot, ctx=ctx)

    return EngineBackend(decode=decode, init_cache=make_cache, params=params,
                         vocab_size=cfg.vocab_size, device=torch.device(device),
                         prefill=None if recurrent(cfg) else prefill_bucket,
                         prefix_sharing=positional_cache(cfg))


def build_engine(config: ServeConfig, *, device="cuda",
                 params: Optional[Any] = None,
                 model_config: Optional[ModelConfig] = None,
                 clock=time.perf_counter) -> ContinuousEngine:
    """A :class:`ContinuousEngine` over the real model substrate.

    ``params`` defaults to random weights drawn from ``config.seed`` with a
    ``torch.Generator`` on ``device`` (shapes and scales of the JAX
    package's init, not its numbers); pass carried-over weights
    (``models.convert.params_from_jax``) to serve those.  ``model_config``
    serves that config in place of the registry's for ``config.arch`` (a
    model cut in depth to fit one card, as ``chip_smoke.py`` serves
    deepseek-v2-236b's first 4 layers).

    ``config.model_parallel > 1`` needs a bound world (see the module
    docstring): the random weights are drawn whole leaf by leaf and each
    rank keeps its blocks; given ``params`` (the whole weights) are cut
    the same way.
    """
    device = resolve_device(device)
    cfg = model_config if model_config is not None else \
        get_config(config.arch, smoke=not config.full)
    _refuse_context(cfg)
    mesh = serve_mesh(config, device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed)
        params = init_params(cfg, gen, device=device,
                             shard=shard_for(cfg, mesh))
    elif mesh is not None:
        params = shd.shard_params(params, param_axes(cfg), mesh,
                                  shd.SERVE_RULES)
    backend = make_backend(cfg, params, config, device, mesh)
    if mesh is not None:
        clock = agreed_clock(clock)
    return ContinuousEngine(backend, config, clock=clock)


@dataclasses.dataclass(frozen=True)
class ServeStep:
    """The fixed-shape serve step: ``fn(params, cache, tokens)`` takes
    ``(num_slots, 1)`` int32 tokens and returns ``((num_slots, 1, V)
    float32 logits, cache)``, the cache updated in place."""

    fn: Callable[[Any, Any, torch.Tensor], Any]
    num_slots: int
    max_seq: int


def build_serve_step(config: ServeConfig, *, device="cuda",
                     params: Optional[Any] = None,
                     model_config: Optional[ModelConfig] = None,
                     context: Optional[torch.Tensor] = None):
    """(cfg, built, params, make_cache) for the FIXED-shape serve step.

    The pre-engine API, driven by the same :class:`ServeConfig`: one
    ``(num_slots, 1)`` decode step (a :class:`ServeStep`) against a
    ``max_seq`` cache with one position for the whole batch.
    Request-level serving goes through :func:`build_engine`.  ``params``
    are random weights drawn from ``config.seed`` on ``device``.  A
    context-conditioned arch's ``make_cache`` encodes (whisper) and
    projects a context of ``context_spec(cfg, num_slots)``, standard
    normal in ``cfg.dtype`` from a ``torch.Generator`` seeded with
    ``config.seed`` (drawn once, the same for every cache).  With
    ``model_parallel > 1`` (in a bound world) ``params`` and the cache are
    this rank's blocks and the step gathers the logits whole: every rank
    encodes (whisper) and projects the whole context into its own blocks
    of the cache (its KV heads of ``xk`` / ``xv``), as it runs every
    family.  ``params`` (the whole weights, cut the same way under a mesh),
    ``model_config`` and ``context`` take the place of the seeded ones, as
    :func:`build_engine`'s do.
    """
    device = resolve_device(device)
    cfg = model_config if model_config is not None else \
        get_config(config.arch, smoke=not config.full)
    mesh = serve_mesh(config, device)
    ctx = RunCtx(mesh=mesh)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(config.seed)
        params = init_params(cfg, gen, device=device,
                             shard=shard_for(cfg, mesh))
    elif mesh is not None:
        params = shd.shard_params(params, param_axes(cfg), mesh,
                                  shd.SERVE_RULES)
    built = ServeStep(fn=lambda p, cache, tok: decode_step(p, cfg, cache,
                                                           tok, ctx=ctx),
                      num_slots=config.num_slots, max_seq=config.max_seq)
    spec = context_spec(cfg, config.num_slots)
    if spec is not None and context is None:
        cgen = torch.Generator(device=device)
        cgen.manual_seed(config.seed)
        context = torch.randn(spec.shape, generator=cgen, device=device
                              ).to(spec.dtype)

    def make_cache():
        return init_cache(params, cfg, config.num_slots, config.max_seq,
                          context=context, ctx=ctx)

    return cfg, built, params, make_cache


@dataclasses.dataclass
class BatchResult:
    """Outcome of decoding one flushed batch (legacy shape, kept for the
    deprecated :func:`run_batched_decode` shim)."""

    batch: DecodeBatch
    tokens: np.ndarray            # (num_slots, max_new) generated ids (0-padded)
    metrics: Dict[str, np.ndarray]
    decode_steps: int
    prefill_s: float
    decode_s: float


def run_batched_decode(engine: ContinuousEngine, batch: DecodeBatch, *,
                       max_steps: Optional[int] = None) -> BatchResult:
    """DEPRECATED: decode one fixed batch to completion through the engine.

    Submits the batch's requests, drains the engine (or stops after
    ``max_steps`` steps), and reassembles a :class:`BatchResult` (slot
    ``i`` of the result is request ``i`` of the batch).  Use
    :meth:`ContinuousEngine.submit` / :meth:`~ContinuousEngine.run`
    directly: the engine overlaps requests instead of waiting for the
    slowest one.
    """
    warnings.warn(
        "run_batched_decode is deprecated: submit requests to "
        "repro_torch.serving.ContinuousEngine directly (continuous batching "
        "replaces batch-to-completion decode)", DeprecationWarning,
        stacklevel=2)
    t0 = time.perf_counter()
    uids = [engine.submit(r.prompt, max_new_tokens=r.max_new_tokens)
            for r in batch.requests]
    first_tok_s = None
    steps = 0
    while engine.pending or engine.num_active:
        for ev in engine.step():
            if ev.kind == "token" and ev.index == 0 and first_tok_s is None:
                first_tok_s = time.perf_counter() - t0
        steps += 1
        if max_steps is not None and steps >= max_steps:
            break
    total_s = time.perf_counter() - t0
    prefill_s = first_tok_s if first_tok_s is not None else total_s

    S = batch.num_slots
    budget = max(int(batch.max_new().max(initial=0)), 1)
    gen = np.zeros((S, budget), np.int64)
    logprob = np.zeros((S,), np.float32)
    tokens = np.zeros((S,), np.int64)
    stopped = np.zeros((S,), bool)
    for i, uid in enumerate(uids):
        if uid not in engine.results:      # cut off by max_steps
            continue
        res = engine.result(uid)
        gen[i, : len(res.tokens)] = res.tokens
        logprob[i] = res.logprob_sum
        tokens[i] = len(res.tokens)
        stopped[i] = res.stopped
    metrics = {"logprob_sum": logprob, "tokens": tokens, "stopped": stopped}
    return BatchResult(batch=batch, tokens=gen, metrics=metrics,
                       decode_steps=steps, prefill_s=prefill_s,
                       decode_s=max(total_s - prefill_s, 1e-9))


# ---------------------------------------------------------------------------
# CLI: Poisson arrival trace through the engine
# ---------------------------------------------------------------------------

def poisson_trace(rng: np.random.Generator, n: int, rate_hz: float,
                  min_prompt: int, max_prompt: int, vocab: int,
                  max_new: int, users: int = 1,
                  shared_frac: float = 0.0, shared_len: int = 0):
    """[(arrival_offset_s, prompt, max_new, user)] — synthetic open-loop
    traffic, draw for draw the JAX package's generator; requests attribute
    uniformly to ``users`` synthetic users.

    ``shared_frac`` of the requests open with a fixed ``shared_len``-token
    prefix (one "system prompt" drawn per trace): the workload shape the
    prefix KV cache exploits."""
    shared = rng.integers(1, vocab, shared_len).tolist() if shared_len else []
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate_hz)) if rate_hz > 0 else 0.0
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        if shared and plen > shared_len and rng.random() < shared_frac:
            prompt = shared + rng.integers(1, vocab,
                                           plen - shared_len).tolist()
        else:
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


def run_cli(argv=None) -> Dict[str, Any]:
    """The CLI's whole run: parse ``argv``, build the engine, subscribe a
    :class:`WindowedMetrics`, serve the Poisson trace and print the report.
    Returns what a caller measuring the run reads: ``engine``, ``metrics``
    (the subscribed consumer), ``trace``, ``results`` (submission order)
    and ``wall_s``."""
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
    ap.add_argument("--users", type=int, default=4,
                    help="synthetic user population for per-user windows")
    ap.add_argument("--prefill-batch", type=int, default=4,
                    help="max same-bucket admissions per prefill program")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the radix prefix KV cache")
    ap.add_argument("--prefix-block", type=int, default=4,
                    help="tokens per prefix-cache trie node")
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="fraction of requests opening with a shared prefix")
    ap.add_argument("--shared-len", type=int, default=0,
                    help="token length of the shared prefix")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks the weights are cut over (tensor and expert "
                         "parallel); > 1 starts a world of that many ranks")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.model_parallel > 1 and not tdist.is_initialized():
        from .mesh import run_world
        return run_world(_cli_rank, args.model_parallel,
                         args=(argv, args.device), timeout_s=3600.0)[0]
    return _serve_cli(args)


def _cli_rank(rank: int, world: int, store_path: str, argv, device):
    """One rank of the CLI's ``--model-parallel`` world: NCCL with a card
    a rank, gloo when ranks share a card or run on the CPU; only rank 0
    prints.  Returns what a caller reads (no engine: it stays here)."""
    import contextlib
    import io
    from .mesh import init_distributed

    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n)
        backend = "nccl" if n >= world else "gloo"
    else:
        backend = "gloo"
    init_distributed(backend, rank, world,
                     tdist.FileStore(store_path, world),
                     device=dev if dev.type == "cuda" else None)
    argv = list(argv) + ["--device", str(dev)]
    quiet = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        out = run_cli(argv)
    return {k: out[k] for k in ("trace", "results", "wall_s")}


def _serve_cli(args) -> Dict[str, Any]:
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.max_prompt > buckets[-1]:
        raise SystemExit(f"--max-prompt {args.max_prompt} exceeds the "
                         f"largest bucket {buckets[-1]}")
    config = ServeConfig(arch=args.arch, num_slots=args.slots,
                         prefill_buckets=buckets, max_new_tokens=args.gen,
                         temperature=args.temperature, seed=args.seed,
                         full=args.full, prefill_batch=args.prefill_batch,
                         prefix_cache=not args.no_prefix_cache,
                         prefix_block=args.prefix_block,
                         model_parallel=args.model_parallel)
    engine = build_engine(config, device=args.device)
    metrics = WindowedMetrics(window=32, half_life_s=60.0,
                              device=engine.backend.device)
    engine.subscribe(metrics.observe)

    plan = decode_metrics_plan(config.num_slots, config.num_slots,
                               device=engine.backend.device)
    print(f"arch={args.arch} device={engine.backend.device} "
          f"slots={config.num_slots} buckets={buckets} gen<={args.gen} "
          f"requests={args.requests} rate={args.rate}/s"
          + (f" model_parallel={args.model_parallel}"
             if args.model_parallel > 1 else ""))
    print(f"per-step aggregation plan: {plan.describe()}")

    rng = np.random.default_rng(args.seed)
    trace = poisson_trace(rng, args.requests, args.rate, args.min_prompt,
                          args.max_prompt, engine.backend.vocab_size,
                          args.gen, users=max(1, args.users),
                          shared_frac=args.shared_frac,
                          shared_len=args.shared_len)
    launches0 = flash_attention.launches
    results, wall = serve_trace(engine, trace, quiet=False,
                                clock=engine.clock)

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
    if engine.prefix is not None:
        ps = engine.prefix.stats
        print(f"prefix cache: nodes={engine.prefix.node_count} "
              f"resident={engine.prefix.total_bytes}B "
              f"(fold-accounted {engine.prefix.accounted_bytes()}B) "
              f"hit_rate={ps.hit_rate():.0%} "
              f"bytes_saved={ps.bytes_saved} evictions={ps.evictions} "
              f"folds={ps.folds}")
        fp = metrics.fleet_prefix()
        print(f"fleet prefix windows: hit_rate={fp['hit_rate']:.0%} "
              f"hit_tokens={fp['hit_tokens']:.0f}/"
              f"{fp['prompt_tokens']:.0f} "
              f"bytes_saved={fp['bytes_saved']:.0f}")
    now = time.perf_counter()
    print(f"per-user windows (last {metrics.window} requests, token-rate "
          f"half-life {metrics.half_life_s:g}s; fleet tokens "
          f"{metrics.fleet_tokens():.0f}):")
    for user, row in metrics.summary(now).items():
        print(f"  user={user} requests={row['requests']} "
              f"latency={row['latency_s'] * 1e3:.1f}ms "
              f"ttft={row['ttft_s'] * 1e3:.1f}ms "
              f"tokens/req={row['tokens']:.1f} "
              f"token_rate={row['token_rate']:.1f}")
    return {"engine": engine, "metrics": metrics, "trace": trace,
            "results": results, "wall_s": wall}


def main(argv=None):
    run_cli(argv)
    return 0


if __name__ == "__main__":
    main()
