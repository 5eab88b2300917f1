"""Summingbird in miniature (paper §4), on the port: ONE monoid state serves
the low-latency streaming path (fold batch by batch as data arrives), the
batch path (tree-reduce over per-batch states) and the MapReduce engine —
and all three agree exactly.  Path 4 runs the same monoids over a per-user
event stream as windows: a two-stacks sliding window, tumbling windows as
one keyed fold, a decayed per-user score and sessions as one keyed fold.
On the card the count-min sketch updates run the ``cms_update`` CUDA kernel
and the tumbling and session folds the ``segment_fold`` kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_analytics \
          [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import monoids, tree_fold, word_count_job
from repro_torch.data import (DataConfig, SlidingWindow, SyntheticCorpus,
                              init_stats, make_stream_stats, session_fold,
                              sessionize, summarize, tumbling_fold,
                              update_stats)

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

    # -- path 4: WINDOWED — the same monoids over an infinite event stream ---
    # a synthetic per-user event stream: (user, timestamp, value), drawn as
    # the JAX example draws it
    rng = np.random.default_rng(11)
    n_events, n_users = 400, 6
    users = rng.integers(0, n_users, n_events)
    ts = np.cumsum(rng.uniform(0.0, 0.4, n_events))
    vals = rng.integers(1, 20, n_events).astype(np.float32)
    vals_t = torch.from_numpy(vals).to(device)

    # sliding window: last-32-events sum via the two-stacks trick, O(1)
    # amortized combines per event, no inverse needed (works for max/CMS/HLL)
    win = SlidingWindow(monoids.sum_, 32, device=device)
    for v in vals_t:
        win.push(v)
    brute = float(vals[-32:].sum())
    slide = float(win.extract())
    print(f"\nsliding window (two-stacks, w=32): sum={slide:.0f} "
          f"== brute force {brute:.0f}; "
          f"{win.flip_combines / win.pushes:.2f} flip combines/event")
    assert slide == brute

    # tumbling windows: window id == segment id, ONE planner-lowered keyed
    # fold
    n_windows = int(ts[-1] // 10.0) + 1
    table = tumbling_fold(monoids.sum_, vals_t, ts, width=10.0,
                          num_windows=n_windows).cpu().numpy()
    print(f"tumbling windows (width 10s, one keyed fold): "
          f"{[f'{x:.0f}' for x in table]}")
    assert np.isclose(table.sum(), vals.sum())

    # decay monoid: exponentially time-decayed per-user activity score
    half_life = 20.0
    dm = monoids.decayed_sum(half_life)
    ts_t = torch.from_numpy(ts.astype(np.float32)).to(device)
    score = {}
    for i, u in enumerate(users.tolist()):
        s = dm.lift((vals_t[i], ts_t[i]))
        score[u] = s if u not in score else dm.combine(score[u], s)
    now = float(ts[-1])
    rate = {u: float(monoids.decayed_value(st, now, half_life))
            for u, st in score.items()}
    top_user = max(rate, key=rate.get)
    print(f"decayed activity (half-life {half_life:.0f}s): hottest user = "
          f"{top_user} (score {rate[top_user]:.1f})")

    # sessionization: session id == segment id -> per-session planner fold
    sids, n_sessions = sessionize(users, ts, gap=1.0)
    per_session = session_fold(monoids.sum_, vals_t, sids,
                               n_sessions).cpu().numpy()
    print(f"sessionized {n_events} events from {n_users} users into "
          f"{n_sessions} sessions (gap 1s); "
          f"largest session sum={per_session.max():.0f}")
    assert np.isclose(per_session.sum(), vals.sum())
    return {"tokens": stream["tokens"],
            "approx_distinct": stream["approx_distinct"],
            "top": top.tolist(), "estimates": estimates,
            "tumbling": table, "sessions": per_session}


if __name__ == "__main__":
    main()
