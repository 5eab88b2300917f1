"""End-to-end training loop: data -> train step -> metrics -> checkpoint,
with preemption handling and monoid-merged restart.  The port of the JAX
package's ``launch/train.py``, on one device (``cuda`` unless the caller
passes ``device="cpu"``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt [--device cpu]

Restart is exact by construction: batch ``i`` is a pure function of the
seed and ``i``, the parameters and optimizer state come back from the
checkpoint, and the two Sum-monoid aggregates (the metrics accumulator and
the stream statistics) are checkpointed as monoid values and combined with
what the resumed run adds.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint import CheckpointStore
from ..configs import context_spec, get_config
from ..core import monoids
from ..data import DataConfig, SyntheticCorpus
from ..data.stats import init_stats, make_stream_stats, update_stats
from ..device import resolve_device
from ..models import ModelConfig, RunCtx, init_params
from ..optim import OptConfig, init_opt_state
from ..runtime.fault_tolerance import PreemptionHandler
from .steps import _MESH_TODO, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "qwen3-0.6b"
    smoke: bool = True
    steps: int = 20
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    microbatches: int = 1
    lossy: Optional[str] = None  # grad-compression annotation ("topk:0.01",
                                 #   "blocktopk:0.001", "int8"); EF residual
                                 #   rides opt_state["ef"]
    ragged: bool = False   # corpus emits valid_mask; stats fold only real tokens
    moe_impl: str = "replicated"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    model_parallel: int = 1
    log_every: int = 5
    device: str = "cuda"
    opt: OptConfig = dataclasses.field(default_factory=lambda: OptConfig(
        peak_lr=1e-3, warmup_steps=10, decay_steps=1000))


def _metrics_like(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Zeros shaped like one step's metrics (the restore template of the
    ``"metrics"`` aggregate)."""
    keys = ["loss_sum", "tokens", "correct", "lr", "grad_norm", "loss"]
    out = {k: torch.zeros((), dtype=torch.float32, device=device)
           for k in keys}
    if cfg.num_experts:
        out["expert_load"] = torch.zeros(cfg.num_experts,
                                         dtype=torch.float32, device=device)
        out["moe_dropped"] = torch.zeros((), dtype=torch.float32,
                                         device=device)
    return out


def train(tc: TrainerConfig, *, preemption: Optional[PreemptionHandler] = None
          ) -> Dict[str, Any]:
    """Train ``tc.steps`` steps (resuming from ``tc.ckpt_dir``'s latest
    checkpoint when there is one) -> ``{"history", "metrics_acc",
    "stream_stats", "params", "opt_state", "steps_done"}``; ``history``
    holds the metrics (floats) and the wall seconds since the previous
    entry (``dt``) every ``log_every`` steps."""
    if tc.model_parallel != 1:
        raise NotImplementedError(f"model_parallel > 1 {_MESH_TODO}")
    device = resolve_device(tc.device)
    cfg = get_config(tc.arch, smoke=tc.smoke)
    step_fn = make_train_step(cfg, opt=tc.opt,
                              ctx=RunCtx(moe_impl=tc.moe_impl),
                              num_microbatches=tc.microbatches,
                              lossy=tc.lossy)

    gen = torch.Generator(device=device).manual_seed(tc.seed)
    params = init_params(cfg, gen, device=device)
    opt_state = init_opt_state(params, with_ef=tc.lossy is not None)

    # data: the stateless synthetic corpus (+ stub modality context)
    ctx_spec = context_spec(cfg, tc.global_batch)
    corpus = SyntheticCorpus(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                   global_batch=tc.global_batch, seed=tc.seed,
                   ragged=tc.ragged),
        context_shape=None if ctx_spec is None else tuple(ctx_spec.shape[1:]),
        context_dtype=cfg.dtype, device=device)

    # metrics stream: a Sum-monoid accumulator across steps (in-mapper
    # combining), checkpointed and monoid-merged on restart
    msum = monoids.sum_
    metrics_acc = None
    stats_monoid = make_stream_stats()
    stream_stats = init_stats(stats_monoid, device=device)

    store = CheckpointStore(tc.ckpt_dir) if tc.ckpt_dir else None
    start_step = 0
    if store is not None and store.latest_step() is not None:
        start_step, (params, opt_state) = store.restore((params, opt_state))
        restored = store.restore_aggregate("metrics",
                                           like=_metrics_like(cfg, device))
        if restored is not None:
            metrics_acc = restored
        restored_ss = store.restore_aggregate("stream_stats",
                                              like=stream_stats)
        if restored_ss is not None:
            stream_stats = restored_ss
        print(f"restored checkpoint at step {start_step}")

    history = []
    step = start_step - 1
    t_last = time.time()
    for step in range(start_step, tc.steps):
        batch = corpus(step)
        # a ragged corpus carries a valid_mask: the step takes the model
        # inputs only, and the stream stats fold it through the planner's
        # mask path (padding tokens count nothing)
        mask = batch.pop("valid_mask", None)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        stream_stats = update_stats(stream_stats, batch["tokens"],
                                    valid_mask=mask)
        metrics_acc = metrics if metrics_acc is None else \
            msum.combine(metrics_acc, metrics)
        if (step + 1) % tc.log_every == 0 or step + 1 == tc.steps:
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            dt = time.time() - t_last
            t_last = time.time()
            print(f"step {step + 1:5d} loss={m['loss']:.4f} "
                  f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"({dt:.2f}s)", flush=True)
            history.append({"step": step + 1, "dt": dt, **m})
        stop = preemption is not None and preemption.should_stop
        if store is not None and ((step + 1) % tc.ckpt_every == 0 or stop
                                  or step + 1 == tc.steps):
            store.save_async(step + 1, (params, opt_state), aggregates={
                "metrics": ("sum", metrics_acc),
                "stream_stats": (stats_monoid.name, stream_stats),
            })
        if stop:
            print(f"preempted at step {step + 1}: checkpoint saved, exiting")
            break
    if store is not None:
        store.wait()
    return {"history": history, "metrics_acc": metrics_acc,
            "stream_stats": stream_stats, "params": params,
            "opt_state": opt_state,
            "steps_done": step + 1 if tc.steps > start_step else start_step}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="full (non-smoke) config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lossy", default=None,
                    help="gradient compression annotation: topk:R | "
                         "blocktopk:R | int8 (error feedback in opt state)")
    ap.add_argument("--ragged", action="store_true",
                    help="ragged corpus: whole docs + valid_mask, masked "
                         "stats")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    tc = TrainerConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                       global_batch=args.batch, seq_len=args.seq,
                       microbatches=args.microbatches, lossy=args.lossy,
                       ragged=args.ragged,
                       model_parallel=args.model_parallel,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every, device=args.device)
    handler = PreemptionHandler()
    try:
        out = train(tc, preemption=handler)
    finally:
        handler.restore()
    print(f"done: {out['steps_done']} steps")
    return out


if __name__ == "__main__":
    main()
