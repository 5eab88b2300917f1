"""Continuous-batching serve engine: rolling request slots, a bucket ladder,
streaming decode — the port of ``repro/runtime/engine.py``.

A freed slot (= segment id, the planner's keyed-fold key) is handed to the
next waiting request mid-decode, and the per-request metrics keep folding
through the SAME keyed masked fold (:func:`fold_decode_metrics`) over the
rolling slot population; the running table rides in as ``init=``.  On a
CUDA device the planner lowers that fold onto the hand-written
``segment_fold`` kernel, one launch per decode step.

PyTorch runs eagerly, so the JAX engine's compiled programs become program
*shapes*: ONE decode step at ``(num_slots, 1)``, ONE prefill per
``(k, bucket)`` — k same-bucket admissions run the decode step together over
their prompts padded to the bucket, as the JAX ``lax.scan`` does — and ONE
slot write per k.  :meth:`ContinuousEngine.compile_counts` counts the
distinct shapes each program ran with; :meth:`compile_bound` is the ceiling.

The cache and the metrics table stay on the device between steps; the host
reads the sampled tokens once per step and the table when a request
retires, where the JAX engine pulls them too.  The radix prefix cache is a
later slice of the port (``prefix_cache=True`` raises).
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import monoids
from ..core.plan import Plan, execute_fold, plan_fold
from .batcher import Request, RequestBatcher

# ---------------------------------------------------------------------------
# the per-request metrics fold (request slot == segment id)
# ---------------------------------------------------------------------------

# columns of the per-request metrics table — ONE additive fold carries all
# three: sum of sampled-token logprobs, count of generated tokens, and the
# stop condition as a summed indicator (eos_hits > 0 <=> OR of eos hits)
METRIC_COLS = ("logprob_sum", "tokens", "eos_hits")


def decode_metrics_init(num_slots: int, device="cuda") -> torch.Tensor:
    """The identity table: (num_slots, len(METRIC_COLS)) float32 zeros."""
    return torch.zeros((num_slots, len(METRIC_COLS)), dtype=torch.float32,
                       device=device)


def decode_metrics_plan(batch_rows: int, num_slots: int,
                        device="cuda") -> Plan:
    """The plan of ONE decode step's per-request aggregation (no FLOPs): B
    concurrent requests aggregate through a single keyed, masked fold.
    The rows are an uninitialised tensor on ``device`` (the kernel tier is
    feasible only for CUDA values); ids and mask are ``meta`` tensors."""
    return plan_fold(
        monoids.sum_,
        torch.empty((batch_rows, len(METRIC_COLS)), dtype=torch.float32,
                    device=device),
        segment_ids=torch.empty((batch_rows,), dtype=torch.int32,
                                device="meta"),
        num_segments=num_slots,
        valid_mask=torch.empty((batch_rows,), dtype=torch.bool,
                               device="meta"))


def metric_rows(logits: torch.Tensor, sampled: torch.Tensor,
                eos_id: int) -> torch.Tensor:
    """(B, V) logits + (B,) sampled ids -> (B, 3) metric rows to fold."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok_logp = torch.gather(logp, -1, sampled[:, None].long())[:, 0]
    return torch.stack([tok_logp, torch.ones_like(tok_logp),
                        (sampled == eos_id).to(torch.float32)], dim=-1)


def fold_decode_metrics(table: torch.Tensor, rows: torch.Tensor,
                        slot_ids: torch.Tensor, active: torch.Tensor,
                        num_slots: int) -> torch.Tensor:
    """ONE planner-lowered keyed masked fold of metric rows into the table."""
    return execute_fold(monoids.sum_, rows, segment_ids=slot_ids,
                        num_segments=num_slots, valid_mask=active, init=table)


def decode_metrics_step(table: torch.Tensor, logits: torch.Tensor,
                        sampled: torch.Tensor, slot_ids: torch.Tensor,
                        active: torch.Tensor, *, num_slots: int,
                        eos_id: int) -> torch.Tensor:
    """Fold one decode step's per-request aggregates into the running table.

    logits: (B, V) last-position logits; sampled: (B,) sampled token ids;
    slot_ids: (B,) int32 request slot per row (segment ids); active: (B,)
    bool — rows still generating.  Inactive slots are masked to the
    identity, and the running table rides in as ``init``.
    """
    rows = metric_rows(logits, sampled, eos_id)
    return fold_decode_metrics(table, rows, slot_ids, active, num_slots)


def extract_metrics(table: torch.Tensor) -> Dict[str, np.ndarray]:
    """Read the metrics table out into per-slot host arrays."""
    t = table.detach().cpu().numpy()
    return {
        "logprob_sum": t[:, 0],
        "tokens": t[:, 1].astype(np.int64),
        "stopped": t[:, 2] > 0,       # summed eos indicator == OR
    }


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One config object for the whole serving stack (the JAX package's
    fields).  ``prefix_cache`` defaults to False here: the radix prefix KV
    cache is a later slice of the port, and True raises."""

    arch: str = "qwen3-0.6b"
    num_slots: int = 4                       # rolling request slots (segment ids)
    prefill_buckets: Tuple[int, ...] = (16, 32)   # prompt-length ladder, ascending
    max_new_tokens: int = 16                 # per-request generation ceiling
    eos_id: int = 0
    pad_id: int = 0
    temperature: float = 0.0                 # 0 = greedy
    seed: int = 0                            # weights + sampling seed
    model_parallel: int = 1
    full: bool = False                       # full-size config (default: smoke)
    # batched same-bucket admission: up to this many waiting requests with
    # the same bucket prefill in ONE (k, bucket) program shape
    prefill_batch: int = 1
    prefix_cache: bool = False
    prefix_block: int = 4
    prefix_capacity: int = 256
    prefix_max_bytes: Optional[int] = None
    prefix_half_life_s: float = 60.0

    def __post_init__(self):
        buckets = tuple(int(b) for b in self.prefill_buckets)
        if not buckets or any(b < 1 for b in buckets) or \
                list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"prefill_buckets must be distinct ascending positive ints, "
                f"got {self.prefill_buckets}")
        object.__setattr__(self, "prefill_buckets", buckets)
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.prefill_batch < 1:
            raise ValueError("prefill_batch must be >= 1")
        if self.prefix_block < 1:
            raise ValueError("prefix_block must be >= 1")
        if self.prefix_capacity < 1:
            raise ValueError("prefix_capacity must be >= 1")

    @property
    def max_prompt(self) -> int:
        return self.prefill_buckets[-1]

    @property
    def prefill_k_ladder(self) -> Tuple[int, ...]:
        """Powers of two up to min(prefill_batch, num_slots) — the declared
        admission batch sizes (each is one (k, bucket) program shape)."""
        ks, k = [], 1
        while k <= min(self.prefill_batch, self.num_slots):
            ks.append(k)
            k *= 2
        return tuple(ks)

    @property
    def max_seq(self) -> int:
        """Cache length: the largest bucket plus the generation ceiling."""
        return self.prefill_buckets[-1] + self.max_new_tokens

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest ladder bucket that fits the prompt."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket ({self.prefill_buckets[-1]})")


# ---------------------------------------------------------------------------
# streaming API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestResult:
    """Final per-request record, built from the slot's metrics-table row."""

    uid: int
    slot: int
    prompt_len: int
    bucket: int
    user: int
    tokens: List[int]
    logprob_sum: float
    stopped: bool                 # hit eos (vs exhausted max_new_tokens)
    stop_step: int                # engine step count at retirement
    ttft_s: float                 # submit -> first streamed token
    latency_s: float              # submit -> retirement


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed serving event.

    kind == "token": ``token``/``index`` are set; ``ttft_s`` on index 0.
    kind == "done":  ``result`` carries the full :class:`RequestResult`.
    """

    uid: int
    kind: str                     # "token" | "done"
    slot: int
    step: int                     # engine step counter at emission
    time_s: float
    user: int = 0
    token: Optional[int] = None
    index: Optional[int] = None   # position in the generated sequence
    ttft_s: Optional[float] = None
    result: Optional[RequestResult] = None


# ---------------------------------------------------------------------------
# backend contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineBackend:
    """What the engine needs from a model substrate.

    ``decode(params, cache, cur)`` is row-independent: row b of the outputs
    depends only on row b of ``cache``/``cur``.  ``cur`` is ``(B, 1)``
    int32 on ``device``; it returns ``((B, V) float32 logits, cache)`` and
    may update the cache in place.  ``init_cache(batch, pos_per_slot)``
    builds a fresh cache pytree on ``device`` whose leaves carry the batch
    dim at axis 0, plus a ``pos`` leaf — ``(batch,)`` when
    ``pos_per_slot``.
    """

    decode: Callable[[Any, Any, torch.Tensor], Tuple[torch.Tensor, Any]]
    init_cache: Callable[[int, bool], Any]
    params: Any
    vocab_size: int
    device: torch.device


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    steps: int = 0                # decode steps over the rolling population
    slot_reuses: int = 0          # admissions into a previously-used slot
    generated_tokens: int = 0
    prefill_calls: int = 0        # prefill program invocations (k >= 1 each)
    batched_admissions: int = 0   # admissions that shared a k > 1 prefill


@dataclasses.dataclass
class _SlotState:
    uid: int
    user: int
    seed: int
    prompt_len: int
    bucket: int
    max_new: int
    arrival_s: float
    ttft_s: float
    tokens: List[int]
    cur: int                      # last sampled token (next step's input)

    @property
    def n_gen(self) -> int:
        return len(self.tokens)


def _mix_seed(base: int, seed: int, index: int) -> int:
    """One 63-bit generator seed per (engine seed, request seed, token)."""
    h = 0x9E3779B97F4A7C15
    for v in (base, seed, index):
        h = ((h ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


class ContinuousEngine:
    """Admit and retire requests *mid-decode* over rolling request slots.

    ``submit`` enqueues a request on the FIFO admission queue; when slots
    free, ``_admit`` groups same-bucket requests into one ``(k, bucket)``
    prefill over a fresh k-row cache, writes the result into the rolling
    cache (resetting each slot's position and metrics row) and streams each
    first token (TTFT).  Every ``step()`` then advances ALL occupied slots
    one token — model forward, per-row sampling, and ONE planner-lowered
    keyed masked fold of the per-request metrics — and retires slots that
    hit ``eos_id`` or their token budget.
    """

    def __init__(self, backend: EngineBackend, config: ServeConfig, *,
                 clock: Callable[[], float] = time.perf_counter,
                 consumers: Sequence[Callable[[StreamEvent], None]] = ()):
        if config.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True: the radix prefix KV cache is not ported "
                "yet (ROADMAP: prefix cache slice); use prefix_cache=False")
        self.backend = backend
        self.config = config
        self._clock = clock
        self._consumers: List[Callable[[StreamEvent], None]] = list(consumers)
        self.queue = RequestBatcher(max_batch_size=config.num_slots,
                                    max_wait_s=0.0, clock=clock)
        self.stats = EngineStats()
        self.results: Dict[int, RequestResult] = {}
        self._slots: List[Optional[_SlotState]] = [None] * config.num_slots
        self._used_before = [False] * config.num_slots
        self._seeds: Dict[int, int] = {}
        self._step_count = 0
        self._device = torch.device(backend.device)
        self._cache = backend.init_cache(config.num_slots, True)
        self._table = decode_metrics_init(config.num_slots, self._device)
        self._slot_ids = torch.arange(config.num_slots, dtype=torch.int32,
                                      device=self._device)
        # distinct input shapes each program ran with (eager "compiles")
        self._shapes: Dict[str, Set[Tuple]] = {}

    # -- program shapes ------------------------------------------------------

    def _ran(self, program: str, *tensors: torch.Tensor) -> None:
        self._shapes.setdefault(program, set()).add(
            tuple(tuple(t.shape) for t in tensors))

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input shapes per engine program that has run."""
        return {name: len(s) for name, s in sorted(self._shapes.items())}

    def compile_bound(self) -> int:
        """The declared ceiling on distinct program shapes over ANY trace:
        ``1 step + |k| x |buckets| prefills + |k| writes``."""
        cfg = self.config
        kk = len(cfg.prefill_k_ladder)
        return 1 + kk * len(cfg.prefill_buckets) + kk

    # -- sampling ------------------------------------------------------------

    def _sample_rows(self, logits: torch.Tensor, seeds: np.ndarray,
                     tok_idx: np.ndarray) -> torch.Tensor:
        temp = self.config.temperature
        if temp <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # per-request streams (seed, token index): sampling is independent
        # of slot assignment and neighbours
        probs = torch.softmax(logits.to(torch.float32) / temp, dim=-1)
        out = []
        for b in range(logits.shape[0]):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_mix_seed(self.config.seed, seeds[b], tok_idx[b]))
            out.append(torch.multinomial(probs[b], 1, generator=gen))
        return torch.cat(out).to(torch.int32)

    # -- request lifecycle ---------------------------------------------------

    @property
    def pending(self) -> int:
        """Requests waiting in the admission queue."""
        return len(self.queue)

    @property
    def num_active(self) -> int:
        """Slots currently occupied by a generating request."""
        return sum(s is not None for s in self._slots)

    @property
    def active_uids(self) -> List[int]:
        return [s.uid for s in self._slots if s is not None]

    def subscribe(self, consumer: Callable[[StreamEvent], None]) -> None:
        """Add a stream-event consumer (called once per event, in event
        order, at the end of each :meth:`step`)."""
        self._consumers.append(consumer)

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, user: int = 0) -> int:
        """Enqueue a request; returns its uid.  Admission happens on the
        next :meth:`step` as soon as a slot is free."""
        cfg = self.config
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        cfg.bucket_for(len(prompt))      # raises if it exceeds the ladder
        max_new = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if not (1 <= max_new <= cfg.max_new_tokens):
            raise ValueError(
                f"max_new_tokens must be in [1, {cfg.max_new_tokens}], "
                f"got {max_new}")
        uid = self.queue.submit(prompt, max_new_tokens=max_new,
                                user=int(user))
        self._seeds[uid] = uid if seed is None else int(seed)
        self.stats.submitted += 1
        return uid

    def result(self, uid: int) -> RequestResult:
        return self.results[uid]

    def _admit(self, events: List[StreamEvent]) -> None:
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return
        reqs = self.queue.take(len(free))
        if not reqs:
            return
        cfg = self.config
        jobs = [(req, slot, cfg.bucket_for(len(req.prompt)),
                 self._seeds.pop(req.uid, req.uid))
                for req, slot in zip(reqs, free)]
        # group same-bucket admissions into shared (k, bucket) prefills, k
        # drawn from the declared power-of-two ladder
        groups: Dict[int, List[Tuple[Request, int, int, int]]] = {}
        for job in jobs:
            groups.setdefault(job[2], []).append(job)
        first: Dict[int, int] = {}
        ladder = cfg.prefill_k_ladder
        for b, group in groups.items():
            while group:
                k = max(x for x in ladder if x <= len(group))
                first.update(self._admit_chunk(group[:k], b))
                group = group[k:]

        # stream in arrival order regardless of chunk grouping
        now = self._clock()
        retire: List[int] = []
        for req, slot, bucket, seed in jobs:
            tok = first[req.uid]
            st = _SlotState(uid=req.uid, user=req.user, seed=seed,
                            prompt_len=len(req.prompt), bucket=bucket,
                            max_new=req.max_new_tokens,
                            arrival_s=req.arrival_s,
                            ttft_s=now - req.arrival_s, tokens=[tok], cur=tok)
            self._slots[slot] = st
            self.stats.admitted += 1
            self.stats.generated_tokens += 1
            if self._used_before[slot]:
                self.stats.slot_reuses += 1
            self._used_before[slot] = True
            events.append(StreamEvent(uid=st.uid, kind="token", slot=slot,
                                      step=self._step_count, time_s=now,
                                      user=st.user, token=tok, index=0,
                                      ttft_s=st.ttft_s))
            if tok == cfg.eos_id or st.max_new <= 1:
                retire.append(slot)
        if retire:
            self._retire(retire, events, now)

    def _admit_chunk(self, jobs, bucket: int) -> Dict[int, int]:
        """Prefill up to k same-bucket requests together (the decode step
        run over the bucket's tokens), write their caches into the rolling
        cache at their slots, and return each request's first token."""
        cfg, dev = self.config, self._device
        k = len(jobs)
        toks = np.full((k, bucket), cfg.pad_id, np.int32)
        lengths = np.zeros((k,), np.int32)
        seeds = np.zeros((k,), np.int64)
        for r, (req, _, _, seed) in enumerate(jobs):
            toks[r, :len(req.prompt)] = req.prompt
            lengths[r] = len(req.prompt)
            seeds[r] = seed
        toks_t = torch.from_numpy(toks).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        self._ran(f"prefill_k{k}_b{bucket}", toks_t)
        cachek = self.backend.init_cache(k, True)
        last = torch.zeros((k, self.backend.vocab_size), dtype=torch.float32,
                           device=dev)
        for i in range(bucket):
            logits, cachek = self.backend.decode(self.backend.params, cachek,
                                                 toks_t[:, i:i + 1])
            last = torch.where((lengths_t - 1 == i)[:, None], logits, last)
        sampled = self._sample_rows(last, seeds, np.zeros((k,), np.int64))
        rows = metric_rows(last, sampled, cfg.eos_id)

        # write: each slot restarts at its prompt length, and its metrics
        # row is reset to the prefill's first-token row (one write)
        slots = torch.tensor([slot for _, slot, _, _ in jobs],
                             dtype=torch.long, device=dev)
        self._ran(f"write_k{k}", slots)
        for key, big in self._cache.items():
            if key == "pos":
                big[slots] = lengths_t.to(big.dtype)
            else:
                pytree.tree_map(lambda b, s: b.index_copy_(0, slots, s),
                                big, cachek[key])
        self._table[slots] = rows
        sampled_np = sampled.cpu().numpy()
        self.stats.prefill_calls += 1
        if k > 1:
            self.stats.batched_admissions += k
        return {req.uid: int(sampled_np[r])
                for r, (req, _, _, _) in enumerate(jobs)}

    def _retire(self, slots: List[int], events: List[StreamEvent],
                now: float) -> None:
        table = self._table.cpu().numpy()
        for slot in slots:
            st = self._slots[slot]
            res = RequestResult(
                uid=st.uid, slot=slot, prompt_len=st.prompt_len,
                bucket=st.bucket, user=st.user, tokens=list(st.tokens),
                logprob_sum=float(table[slot, 0]),
                stopped=bool(table[slot, 2] > 0),
                stop_step=self._step_count,
                ttft_s=st.ttft_s, latency_s=now - st.arrival_s)
            self.results[st.uid] = res
            self._slots[slot] = None
            self.stats.completed += 1
            events.append(StreamEvent(uid=st.uid, kind="done", slot=slot,
                                      step=self._step_count, time_s=now,
                                      user=st.user, result=res))

    # -- the rolling decode step ---------------------------------------------

    def step(self) -> List[StreamEvent]:
        """Admit waiting requests into free slots, then advance the whole
        rolling population one token.  Returns the streamed events."""
        events: List[StreamEvent] = []
        self._admit(events)
        S = self.config.num_slots
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if not occupied:
            return self._dispatch(events)

        cur = np.zeros((S, 1), np.int32)
        active = np.zeros((S,), bool)
        seeds = np.zeros((S,), np.int64)
        tok_idx = np.zeros((S,), np.int64)
        for i in occupied:
            st = self._slots[i]
            cur[i, 0] = st.cur
            active[i] = True
            seeds[i] = st.seed
            tok_idx[i] = st.n_gen
        dev = self._device
        cur_t = torch.from_numpy(cur).to(dev)
        active_t = torch.from_numpy(active).to(dev)
        self._ran("step", cur_t)
        logits, self._cache = self.backend.decode(self.backend.params,
                                                  self._cache, cur_t)
        sampled = self._sample_rows(logits, seeds, tok_idx)
        self._table = decode_metrics_step(
            self._table, logits, sampled, self._slot_ids, active_t,
            num_slots=S, eos_id=self.config.eos_id)
        self._step_count += 1
        self.stats.steps += 1

        sampled_np = sampled.cpu().numpy()
        now = self._clock()
        retired = []
        for i in occupied:
            st = self._slots[i]
            tok = int(sampled_np[i])
            index = st.n_gen
            st.tokens.append(tok)
            st.cur = tok
            self.stats.generated_tokens += 1
            events.append(StreamEvent(uid=st.uid, kind="token", slot=i,
                                      step=self._step_count, time_s=now,
                                      user=st.user, token=tok, index=index))
            if tok == self.config.eos_id or st.n_gen >= st.max_new:
                retired.append(i)
        if retired:
            self._retire(retired, events, now)
        return self._dispatch(events)

    def _dispatch(self, events: List[StreamEvent]) -> List[StreamEvent]:
        for ev in events:
            for consumer in self._consumers:
                consumer(ev)
        return events

    def run(self, *, max_steps: Optional[int] = None) -> Iterator[StreamEvent]:
        """Stream events until the queue and every slot drain."""
        steps = 0
        while self.pending or self.num_active:
            yield from self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps "
                    f"({self.pending} pending, {self.num_active} active)")
