"""Deterministic, host-sharded, resumable data pipeline.

The port of the JAX package's ``data/pipeline.py``; the generation is the
same numpy code, so batch ``i`` is the JAX package's batch ``i`` bit for bit.

* **Stateless generation** — batch ``i`` is a pure function of
  ``(seed, step=i, host_id)``; resuming at step k needs only k.
* **Host sharding** — each host draws only its slice of the global batch.
* **Synthetic corpus** — Zipf-distributed tokens with document structure
  (EOS-terminated docs, geometric lengths), packed to a fixed seq_len.
* **Ragged batches** — with ``ragged=True`` a row ends at its last complete
  (EOS-terminated) document; the tail is padding carried in a
  ``valid_mask``, which every consumer folds through the planner's
  ``valid_mask=`` path (:func:`packed_stats`, ``data/stats.py``).
* **Prefetch** — a depth-bounded background thread (double buffering).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..core import monoids
from ..core.plan import execute_fold
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 256
    eos_id: int = 0
    pad_id: int = 0
    ragged: bool = False   # emit valid_mask; keep only whole packed docs


class SyntheticCorpus:
    """batch(step) -> {tokens, labels[, valid_mask][, context]} for this
    host's shard, deterministically, as tensors on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1,
                 context_shape: Optional[tuple] = None,
                 context_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not split "
                             f"over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.context_shape = context_shape
        self.context_dtype = context_dtype
        self.device = resolve_device(device)
        # Zipf over a fixed vocab via inverse-CDF on precomputed weights
        ranks = np.arange(1, cfg.vocab_size, dtype=np.float64)  # id 0 = EOS
        w = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(w) / w.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id]))

    def _numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The batch as numpy arrays (the JAX package's generation)."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self.local_batch, cfg.seq_len
        u = rng.random((B, S))
        toks = (np.searchsorted(self._cdf, u) + 1).astype(np.int32)
        # document structure: EOS with prob 1/mean_doc_len (geometric docs)
        eos_mask = rng.random((B, S)) < (1.0 / cfg.mean_doc_len)
        toks = np.where(eos_mask, cfg.eos_id, toks)
        batch: Dict[str, Any] = {}
        if cfg.ragged:
            # keep only whole documents: a row ends at its LAST EOS and the
            # tail (an incomplete doc) becomes padding under valid_mask
            is_eos = toks == cfg.eos_id
            has = is_eos.any(axis=1)
            last = np.where(has, (S - 1) - np.argmax(is_eos[:, ::-1], axis=1),
                            S - 1)   # no EOS: the whole row is one open doc
            valid = np.arange(S)[None, :] <= last[:, None]
            toks = np.where(valid, toks, cfg.pad_id)
            batch["valid_mask"] = valid
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                                axis=1)
        if cfg.ragged:
            # no loss on predicting padding
            next_valid = np.concatenate(
                [valid[:, 1:], np.zeros((B, 1), bool)], axis=1)
            labels = np.where(next_valid, labels, -1)
        batch["tokens"] = toks
        batch["labels"] = labels
        if self.context_shape is not None:
            batch["context"] = rng.standard_normal(
                (B,) + tuple(self.context_shape), dtype=np.float32)
        return batch

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self._numpy_batch(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "context":
                t = t.to(self.context_dtype)
            out[k] = t.to(self.device)
        return out


def packed_stats(tokens: torch.Tensor, valid_mask: torch.Tensor, *,
                 eos_id: int = 0) -> Dict[str, torch.Tensor]:
    """Per-row packed-sequence stats as ONE masked keyed fold.

    tokens/valid_mask: (B, S).  Returns ``{"tokens": (B,), "docs": (B,)}``
    int32 — real-token count and completed-document (EOS) count per row.
    Both columns ride a single planner-lowered keyed fold (segment id = row,
    ``valid_mask`` = the flattened padding mask; the ``segment_fold`` CUDA
    kernel on the card): the ragged batch is never densified.
    """
    B, S = tokens.shape
    flat = tokens.reshape(-1)
    rows = torch.stack([torch.ones_like(flat, dtype=torch.float32),
                        (flat == eos_id).to(torch.float32)], dim=-1)
    seg = torch.arange(B, dtype=torch.int32,
                       device=tokens.device).repeat_interleave(S)
    out = execute_fold(monoids.sum_, rows, segment_ids=seg, num_segments=B,
                       valid_mask=valid_mask.to(torch.bool).reshape(-1))
    return {"tokens": out[:, 0].to(torch.int32),
            "docs": out[:, 1].to(torch.int32)}


class Prefetcher:
    """Depth-bounded background prefetch over ``source(step)``.

    Exactly-once per step; ``close()`` joins the thread.  Resumable: pass
    the restart step to the constructor.
    """

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 num_steps: Optional[int] = None):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._steps = range(start_step, num_steps if num_steps is not None
                            else (1 << 62))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for step in self._steps:
            if self._stop.is_set():
                return
            batch = self.source(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
        self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
