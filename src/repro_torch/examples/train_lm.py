"""End-to-end example: train a ~100M-parameter LM for a few hundred steps on
the synthetic corpus, with gradient accumulation (in-mapper combining),
monoid metrics, stream statistics, checkpointing and preemption handling.
The port of the JAX package's ``examples/train_lm.py``: the same config and
flags, plus ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
      [--dim 512] [--device cpu]

The checkpoints go to ``build/train_lm_ckpt`` (git-ignored) unless
``--ckpt-dir`` says otherwise; a second run resumes from them.
"""
import argparse
from pathlib import Path

from repro_torch import configs
from repro_torch.data import make_stream_stats, summarize
from repro_torch.launch.train import TrainerConfig, train
from repro_torch.models import ModelConfig
from repro_torch.runtime.fault_tolerance import PreemptionHandler

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / \
    "train_lm_ckpt"


def make_100m(dim: int) -> ModelConfig:
    """~100M params at dim=512: 8L, d_ff=2048, vocab 32k."""
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=8, d_model=dim,
        num_heads=8, num_kv_heads=4, head_dim=dim // 8, d_ff=4 * dim,
        vocab_size=32_768, qk_norm=True, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = make_100m(args.dim)
    n = cfg.num_params()
    print(f"model: {cfg.name} ({n/1e6:.1f}M params)")

    # register the config under its name so TrainerConfig can find it
    configs._MODULES["lm-100m"] = type(
        "M", (), {"ARCH_ID": "lm-100m",
                  "config": staticmethod(lambda: cfg),
                  "smoke_config": staticmethod(lambda: cfg)})

    tc = TrainerConfig(arch="lm-100m", smoke=False, steps=args.steps,
                       global_batch=args.batch, seq_len=args.seq,
                       microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10,
                       device=args.device)
    handler = PreemptionHandler()
    try:
        out = train(tc, preemption=handler)
    finally:
        handler.restore()
    hist = out["history"]
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {out['steps_done']} steps")
    stats = summarize(make_stream_stats(), out["stream_stats"])
    print(f"corpus stats (monoid stream): {stats['tokens']} tokens, "
          f"~{stats['approx_distinct']:.0f} distinct")
    return out


if __name__ == "__main__":
    main()
