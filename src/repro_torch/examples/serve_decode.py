"""Continuous-batching serving through the public ``repro_torch.serving``
facade: requests with ragged prompts roll through a fixed population of
slots, a freed slot is handed to the next waiting request mid-decode, and
tokens stream back per request as they decode.  The port of the JAX
package's ``examples/serve_decode.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \
          [--arch qwen3-0.6b] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serving import ServeConfig, build_engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=1.0)
    args = ap.parse_args(argv)

    config = ServeConfig(arch=args.arch, num_slots=args.slots,
                         prefill_buckets=(8, 16), max_new_tokens=args.gen,
                         temperature=args.temperature)
    engine = build_engine(config, device=args.device)

    rng = np.random.default_rng(0)
    vocab = engine.backend.vocab_size
    uids = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, config.max_prompt + 1))
        uids.append(engine.submit(rng.integers(1, vocab, plen).tolist()))

    print(f"arch={args.arch}  slots={args.slots}  requests={args.requests}  "
          f"buckets={config.prefill_buckets}  gen<={args.gen}")

    # stream: every token event carries (uid, slot, index); "cache" reports
    # the admission's prefix-cache hit; "done" carries the final per-request
    # metrics folded by the engine's keyed masked fold
    streamed = {u: [] for u in uids}
    for event in engine.run():
        if event.kind == "token":
            streamed[event.uid].append(event.token)
            if event.index == 0:
                print(f"  uid={event.uid} first token on slot {event.slot} "
                      f"(ttft {event.ttft_s * 1e3:.0f}ms)")
        elif event.kind == "cache" and event.hit_tokens:
            print(f"  uid={event.uid} prefix hit: {event.hit_tokens}/"
                  f"{event.prompt_tokens} prompt tokens from the trie "
                  f"({event.bytes_saved} KV bytes not re-prefilled)")
        elif event.kind == "done":
            r = event.result
            print(f"  uid={r.uid} done: {len(r.tokens)} tokens, "
                  f"logprob_sum={r.logprob_sum:.2f}, "
                  f"{'eos' if r.stopped else 'budget'} stop")

    st = engine.stats
    assert all(streamed[u] == engine.result(u).tokens for u in uids)
    print(f"served {st.completed} requests / {st.generated_tokens} tokens in "
          f"{st.steps} rolling decode steps, {st.slot_reuses} slot reuses")
    if engine.prefix is not None:
        ps = engine.prefix.stats
        print(f"prefix cache: {engine.prefix.node_count} nodes, "
              f"hit_rate={ps.hit_rate():.0%}, {ps.bytes_saved} bytes saved")
    print(f"program shapes: {engine.compile_counts()} "
          f"(bound: {engine.compile_bound()})")
    return {u: engine.result(u) for u in uids}


if __name__ == "__main__":
    main()
