"""Quickstart: the paper in 80 lines, on the port.

1. Monoidify a non-associative aggregation (mean) -> combiners become legal.
2. Run the paper's Algorithms 1/3/4 on a MapReduce job and print the
   shuffle-byte reduction (on the card, Algorithms 1 and 3 fold through the
   ``segment_fold`` CUDA kernel).
3. See Algorithm 2 get rejected by the combiner contract.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (STRATEGIES, MonoidTypeError, algorithm2_combiner,
                              average_by_key_job, monoids, validate_combiner)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # -- 1. the (sum, count) monoid — the paper's running example -----------
    mean = monoids.mean

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    a = mean.lift(f32(1.0))                    # (1.0, 1)
    b = mean.combine(mean.lift(f32(2.0)),
                     mean.combine(mean.lift(f32(3.0)), mean.lift(f32(4.0))))
    print("Avg(1,2,3,4) via any bracketing:",
          float(mean.extract(mean.combine(a, b))))
    # naive mean-of-means is WRONG — the motivating inequality:
    print("Avg(Avg(1,2), Avg(3,4,5)) =", (1.5 + 4.0) / 2,
          "!= Avg(1..5) =", 3.0)

    # -- 2. mean-by-key with all three strategies ----------------------------
    rng = np.random.default_rng(0)
    records = {
        "key": torch.from_numpy(rng.integers(0, 8, 4096).astype(np.int32)
                                ).to(dev),
        "value": torch.from_numpy(rng.normal(size=4096).astype(np.float32)
                                  ).to(dev)}
    job = average_by_key_job(num_keys=8)
    print(f"\n{'strategy':12s} {'intermediate':>12s} {'shuffle bytes':>14s} "
          f"{'reduction':>10s}")
    outs = {}
    for strat in STRATEGIES:
        outs[strat] = job.run_local(records, strategy=strat, num_shards=8)
        st = job.stats(records, strategy=strat, num_shards=8)
        print(f"{strat:12s} {st.intermediate_values:12d} "
              f"{st.shuffle_bytes_mapreduce:14d} "
              f"{st.reduction_vs_naive():9.1f}x")
    print("all strategies agree:", outs["in_mapper"].cpu().numpy()[:3], "...")

    # -- 3. Algorithm 2 is rejected ------------------------------------------
    try:
        validate_combiner(job.monoid, f32(1.0), algorithm2_combiner)
    except MonoidTypeError as e:
        print("\nAlgorithm 2 rejected by the combiner contract:\n ",
              str(e)[:100])

    # -- bonus: the same idea inside the LM stack -----------------------------
    # the attention softmax state is a monoid too (flash attention / decoding)
    s1 = (f32(0.5), f32(2.0), torch.ones((4,), device=dev))
    s2 = (f32(1.5), f32(1.0), 2 * torch.ones((4,), device=dev))
    merged = monoids.attn_state.combine(s1, s2)
    print("\nattn_state combine (m, l, o):",
          [x.cpu().numpy() for x in merged[:2]])
    print("=> chunked attention, flash-decoding and ring attention are all "
          "re-bracketings of this combine.")
    return {s: o.cpu() for s, o in outs.items()}


if __name__ == "__main__":
    main()
