"""Request batcher for the serving path: concurrent requests ARE records.

A copy of ``repro/runtime/batcher.py`` (pure Python + numpy), so the port
imports nothing of the JAX package.  A decode step over B concurrent
requests is a MapReduce pass where each request is a record and its
per-request aggregates (logprob sum, token count, stop condition) are
monoid values keyed by request: the **slot index is the segment id** of the
serve step's keyed fold, so the whole batch aggregates in ONE
planner-lowered fold per decode step.

Flush policies (host-side, deterministic, injectable clock):

* **max_batch_size** — flush as soon as a full batch is pending.
* **max_wait_s** — flush a partial batch once the OLDEST pending request has
  waited this long; the empty slots are masked out of the fold with
  ``valid_mask``.

The continuous engine uses the FIFO directly (``take()``): each step it
drains as many waiting requests as it has free slots and groups them by
prefill bucket into shared ``(k, bucket)`` prefill programs.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One decode request: a variable-length prompt plus a generation budget."""

    uid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    user: int = 0


@dataclasses.dataclass(frozen=True)
class DecodeBatch:
    """A flushed batch of ragged requests, slotted for the keyed fold.

    ``num_slots`` is the segment-id space of the serve step's fold (the
    batcher's max_batch_size, so every batch compiles to the same shapes);
    requests occupy slots [0, len(requests)).  ``pack`` pads the ragged
    prompts to a rectangle ONLY as the model-input layout — the validity
    mask rides along so every fold over the batch skips the padding.
    """

    requests: Tuple[Request, ...]
    num_slots: int

    def __post_init__(self):
        if not (0 < len(self.requests) <= self.num_slots):
            raise ValueError(
                f"{len(self.requests)} requests for {self.num_slots} slots")

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def segment_ids(self) -> np.ndarray:
        """slot id per request — THE segment ids of the serve step's fold."""
        return np.arange(self.num_slots, dtype=np.int32)

    @property
    def slot_valid(self) -> np.ndarray:
        """(num_slots,) bool: which slots hold a real request."""
        return np.arange(self.num_slots) < len(self.requests)

    def lengths(self) -> np.ndarray:
        """(num_slots,) prompt length per slot (0 for empty slots)."""
        out = np.zeros((self.num_slots,), np.int32)
        out[: len(self.requests)] = [len(r.prompt) for r in self.requests]
        return out

    def max_new(self) -> np.ndarray:
        """(num_slots,) generation budget per slot (0 for empty slots)."""
        out = np.zeros((self.num_slots,), np.int32)
        out[: len(self.requests)] = [r.max_new_tokens for r in self.requests]
        return out

    def pack(self, pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tokens (num_slots, L), lengths (num_slots,), valid (num_slots, L)).

        L is the longest prompt in the batch; shorter prompts and empty
        slots are right-padded with ``pad_id`` and False in the mask.
        """
        lengths = self.lengths()
        L = max(1, int(lengths.max()))
        toks = np.full((self.num_slots, L), pad_id, np.int32)
        for i, r in enumerate(self.requests):
            toks[i, : len(r.prompt)] = r.prompt
        valid = np.arange(L)[None, :] < lengths[:, None]
        return toks, lengths, valid


@dataclasses.dataclass
class BatcherStats:
    enqueued: int = 0
    flushed_batches: int = 0
    flushed_requests: int = 0
    waited_flushes: int = 0     # flushes fired by the max-wait policy

    def fill_rate(self, max_batch_size: int) -> float:
        """Mean slot occupancy of flushed batches (1.0 = always full)."""
        if self.flushed_batches == 0:
            return 0.0
        return self.flushed_requests / (self.flushed_batches * max_batch_size)


class RequestBatcher:
    """FIFO enqueue/flush with max-batch-size and max-wait policies.

    ``clock`` is injectable (tests drive time by hand); requests flush in
    arrival order, and slot assignment within a batch is arrival order too,
    so segment ids are deterministic.
    """

    def __init__(self, max_batch_size: int = 8, max_wait_s: float = 0.010,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self._clock = clock
        self._pending: Deque[Request] = deque()
        self._uids = itertools.count()
        self.stats = BatcherStats()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               user: int = 0) -> int:
        """Enqueue one request; returns its uid."""
        uid = next(self._uids)
        self._pending.append(Request(uid=uid, prompt=tuple(int(t) for t in prompt),
                                     max_new_tokens=max_new_tokens,
                                     arrival_s=self._clock(), user=user))
        self.stats.enqueued += 1
        return uid

    def _policy(self) -> Tuple[bool, bool]:
        """(full, waited) — THE one definition of both flush policies,
        shared by :meth:`ready` and :meth:`flush` so they cannot diverge."""
        full = len(self._pending) >= self.max_batch_size
        waited = (not full and bool(self._pending)
                  and self._clock() - self._pending[0].arrival_s
                  >= self.max_wait_s)
        return full, waited

    def ready(self) -> bool:
        """True when a flush policy fires: full batch, or oldest waited out."""
        return any(self._policy())

    def take(self, n: int) -> Tuple[Request, ...]:
        """Pop up to ``n`` oldest pending requests (continuous-batching
        admission: one request per freed slot, arrival order preserved).

        Unlike :meth:`flush` this never waits on a policy — a free slot is
        capacity going idle, so admission is immediate.
        """
        if n < 0:
            raise ValueError("n must be >= 0")
        take = min(n, len(self._pending))
        reqs = tuple(self._pending.popleft() for _ in range(take))
        self.stats.flushed_requests += take
        return reqs

    def flush(self, *, force: bool = False) -> Optional[DecodeBatch]:
        """Pop the next batch when ready (or unconditionally with ``force``).

        Returns None when no batch is due.  Always at most
        ``max_batch_size`` requests; the batch keeps ``num_slots ==
        max_batch_size`` so every flush compiles to identical shapes and a
        partial batch is just a ragged (masked) one.
        """
        if not self._pending:
            return None
        full, waited = self._policy()
        if not (force or full or waited):
            return None
        take = min(len(self._pending), self.max_batch_size)
        reqs = tuple(self._pending.popleft() for _ in range(take))
        self.stats.flushed_batches += 1
        self.stats.flushed_requests += take
        if waited:               # forced partials don't count as policy fires
            self.stats.waited_flushes += 1
        return DecodeBatch(requests=reqs, num_slots=self.max_batch_size)
