"""Summingbird in miniature (paper §4), on the port: ONE monoid state serves
the low-latency streaming path (fold batch by batch as data arrives), the
batch path (tree-reduce over per-batch states) and the MapReduce engine —
and all three agree exactly.  On the card the count-min sketch updates run
the ``cms_update`` CUDA kernel.  (The JAX example's fourth path, windows,
waits for the port's windows slice.)

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_analytics \
          [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import monoids, tree_fold, word_count_job
from repro_torch.data import (DataConfig, SyntheticCorpus, init_stats,
                              make_stream_stats, summarize, update_stats)

VOCAB = 2_000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    corpus = SyntheticCorpus(DataConfig(vocab_size=VOCAB, seq_len=256,
                                        global_batch=8, seed=7),
                             device=device)
    batches = [corpus(i)["tokens"] for i in range(8)]
    all_tokens = torch.cat([b.reshape(-1) for b in batches])

    # -- path 1: STREAMING — in-mapper combining, one batch at a time --------
    m = make_stream_stats()
    state = init_stats(m, device=device)
    for b in batches:
        state = update_stats(state, b)         # O(1) state, any arrival order
    stream = summarize(m, state)

    # -- path 2: BATCH — the same monoid, tree-reduced over per-batch states -
    per_batch = [update_stats(init_stats(m, device=device), b)
                 for b in batches]
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *per_batch)
    batch_state = tree_fold(m, stacked)
    batch = summarize(m, batch_state)

    print("same monoid, two execution plans (the Summingbird property):")
    print(f"  streaming: tokens={stream['tokens']}, "
          f"distinct~{stream['approx_distinct']:.0f}")
    print(f"  batch    : tokens={batch['tokens']}, "
          f"distinct~{batch['approx_distinct']:.0f}")
    assert stream["tokens"] == batch["tokens"]
    assert all(torch.equal(state[k], batch_state[k]) for k in state)
    print("  CMS/HLL/Bloom states identical: True")

    # -- path 3: the MapReduce engine on the same query -----------------------
    job = word_count_job(VOCAB)
    counts = job.run_local(all_tokens, strategy="in_mapper",
                           num_shards=8).cpu().numpy()
    top = np.argsort(counts)[::-1][:5]
    print("\ntop-5 tokens by exact MapReduce word count:", top.tolist())
    estimates = {}
    for t in top[:3]:
        est = int(monoids.cms_query(state["cms"], int(t)))
        estimates[int(t)] = (int(counts[t]), est)
        print(f"  token {t}: exact={int(counts[t])}, cms_estimate={est} "
              "(>= exact)")

    true_distinct = len(np.unique(all_tokens.cpu().numpy()))
    err = abs(stream["approx_distinct"] - true_distinct) / true_distinct
    print(f"\nHLL distinct estimate error: {100*err:.1f}% "
          f"(true {true_distinct}, est {stream['approx_distinct']:.0f})")
    return {"tokens": stream["tokens"],
            "approx_distinct": stream["approx_distinct"],
            "top": top.tolist(), "estimates": estimates}


if __name__ == "__main__":
    main()
