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
``(k, bucket)``, ONE slot write per k and, with the prefix cache on, ONE
prefix gather per k.  A prefill takes k same-bucket admissions, their
prompts padded to the bucket, in ONE call of the backend's ``prefill``
(for the dense model: the full-sequence forward, its attention on the
``flash_attention`` kernel), which leaves the cache rows and first-token
logits that the JAX engine's ``lax.scan`` of the decode step over the
bucket leaves.  A backend without ``prefill`` (the recurrent families of
later slices) gets that scan, as a loop of decode steps.
:meth:`ContinuousEngine.compile_counts` counts the distinct shapes each
program ran with; :meth:`compile_bound` is the ceiling.

The radix prefix KV cache (``runtime/prefix_cache.py``, on by default as in
the JAX package): admission looks up each prompt's longest cached
block-aligned prefix, writes its KV rows into the fresh k-row cache and
prefills only the remaining SUFFIX, bucketed on suffix length.  The dense
backend's ``prefill`` runs the suffix in the same one pass, each row's
queries at its prefix length (``flash_attention``'s per-row query offset);
a backend without ``prefill`` starts each row's decode loop at its prefix
length.  The prefilled rows are gathered into one tensor per call, the
trie's payloads are slices of it kept on the device, and the cache's
bookkeeping is one keyed fold per engine step.

The cache and the metrics table stay on the device between steps; the host
reads the sampled tokens once per step and the table when a request
retires, where the JAX engine pulls them too.
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
from . import prng
from .batcher import Request, RequestBatcher
from .prefix_cache import PrefixCache, PrefixCacheConfig, PrefixHit

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
    fields and defaults)."""

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
    # radix prefix KV cache (runtime/prefix_cache.py): admissions look up
    # the longest cached block-aligned prefix, write its KV rows into the
    # prefill cache, and prefill only the remaining suffix
    prefix_cache: bool = True
    prefix_block: int = 4                    # tokens per trie node
    prefix_capacity: int = 256               # trie nodes == stats-table rows
    prefix_max_bytes: Optional[int] = None   # resident-KV budget (None = off)
    prefix_half_life_s: float = 60.0         # decayed-LRU eviction half life

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
    def prefix_slab(self) -> int:
        """Per-request prefix rows a prefill can take: the largest block
        multiple strictly below the biggest bucket (a hit must leave >= 1
        suffix token to produce the first logits)."""
        return ((self.max_prompt - 1) // self.prefix_block) \
            * self.prefix_block

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
    kind == "cache": emitted at admission when the prefix cache is on:
      ``hit_tokens``/``prompt_tokens``/``bytes_saved``.
    """

    uid: int
    kind: str                     # "token" | "done" | "cache"
    slot: int
    step: int                     # engine step counter at emission
    time_s: float
    user: int = 0
    token: Optional[int] = None
    index: Optional[int] = None   # position in the generated sequence
    ttft_s: Optional[float] = None
    result: Optional[RequestResult] = None
    hit_tokens: Optional[int] = None      # prompt tokens served from cache
    prompt_tokens: Optional[int] = None   # total prompt tokens
    bytes_saved: Optional[int] = None     # KV bytes not re-prefilled


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
    ``pos_per_slot``.  ``prefill(params, cache, toks, lengths[,
    prefix_len])``, where given, runs ``(k, bucket)`` int32 prompts padded
    to the bucket through the model in one pass over a fresh k-row cache
    and returns ``((k, V) float32 logits at each row's ``lengths - 1``,
    cache)``, the cache's K/V rows ``[0, bucket)`` written as the decode
    step run over the bucket writes them; with ``prefix_len`` ((k,) int32)
    the cache already holds each row's cached prefix in rows ``[0,
    prefix_len)``, the prompts are the suffixes, and the rows and logits
    are those of the decode step run over the suffix from ``pos =
    prefix_len``.  ``None`` makes the engine run that decode loop.

    ``prefix_sharing`` is True iff every non-``pos`` cache leaf is indexed
    by absolute position at axis 1 (``models.positional_cache``), the
    property prefix KV sharing needs; a recurrent-state backend sets it
    False and the engine keeps cold prefills.
    """

    decode: Callable[[Any, Any, torch.Tensor], Tuple[torch.Tensor, Any]]
    init_cache: Callable[[int, bool], Any]
    params: Any
    vocab_size: int
    device: torch.device
    prefill: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    prefix_sharing: bool = True


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


@dataclasses.dataclass
class _AdmitJob:
    """One admission in flight: request + slot + prefix-cache hit."""

    req: Request
    slot: int
    plen: int
    bucket: int                   # SUFFIX bucket (prompt minus cached prefix)
    seed: int
    hit: Optional[PrefixHit]
    first: int = 0                # first sampled token, set by _admit_chunk

    @property
    def hit_len(self) -> int:
        return self.hit.length if self.hit is not None else 0


class ContinuousEngine:
    """Admit and retire requests *mid-decode* over rolling request slots.

    ``submit`` enqueues a request on the FIFO admission queue; when slots
    free, ``_admit`` looks up each prompt's longest cached prefix, groups
    same-suffix-bucket requests into one ``(k, bucket)`` prefill over a
    fresh k-row cache holding the cached prefix rows, writes the result
    into the rolling cache (resetting each slot's position and metrics
    row), feeds the new KV blocks back into the trie and streams each first
    token (TTFT).  Every ``step()`` then advances ALL occupied slots
    one token — model forward, per-row sampling, and ONE planner-lowered
    keyed masked fold of the per-request metrics — and retires slots that
    hit ``eos_id`` or their token budget.
    """

    def __init__(self, backend: EngineBackend, config: ServeConfig, *,
                 clock: Callable[[], float] = time.perf_counter,
                 consumers: Sequence[Callable[[StreamEvent], None]] = ()):
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
        # -- radix prefix KV cache (runtime/prefix_cache.py) ----------------
        self.prefix: Optional[PrefixCache] = None
        self._slab = 0
        if config.prefix_cache and backend.prefix_sharing \
                and config.prefix_slab >= config.prefix_block:
            self.prefix = PrefixCache(
                PrefixCacheConfig(block=config.prefix_block,
                                  capacity=config.prefix_capacity,
                                  max_bytes=config.prefix_max_bytes,
                                  half_life_s=config.prefix_half_life_s),
                clock=clock, device=self._device)
            self._slab = config.prefix_slab
            dtypes = {leaf.dtype for leaf in self._kv_leaves(self._cache)}
            if len(dtypes) != 1:
                raise ValueError(f"prefix sharing packs the cache leaves "
                                 f"into one tensor; they must share a "
                                 f"dtype, got {sorted(map(str, dtypes))}")

    # -- program shapes ------------------------------------------------------

    def _ran(self, program: str, *tensors: torch.Tensor) -> None:
        self._shapes.setdefault(program, set()).add(
            tuple(tuple(t.shape) for t in tensors))

    @property
    def clock(self) -> Callable[[], float]:
        """The clock the engine reads (event times, TTFT, the prefix
        cache's scores)."""
        return self._clock

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input shapes per engine program that has run, plus the
        prefix cache's stats fold and row reset when it is on."""
        counts = {name: len(s) for name, s in sorted(self._shapes.items())}
        if self.prefix is not None:
            counts.update(self.prefix.compile_counts())
        return counts

    def compile_bound(self) -> int:
        """The declared ceiling on distinct program shapes over ANY trace:
        ``1 step + |k| x |buckets| prefills + |k| writes`` plus, with the
        prefix cache on, ``|k| gathers + stats fold + row reset``."""
        cfg = self.config
        kk = len(cfg.prefill_k_ladder)
        n = 1 + kk * len(cfg.prefill_buckets) + kk
        if self.prefix is not None:
            n += kk + 2
        return n

    # -- sampling ------------------------------------------------------------

    def _sample_rows(self, logits: torch.Tensor, seeds: np.ndarray,
                     tok_idx: np.ndarray) -> torch.Tensor:
        temp = self.config.temperature
        if temp <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # the JAX engine's per-request key streams: fold_in(fold_in(
        # PRNGKey(seed), request seed), token index), then categorical --
        # independent of slot assignment and neighbours, and the same
        # stream on every device; all rows at once
        dev = logits.device
        key = prng.fold_in(prng.fold_in(prng.prng_key(self.config.seed, dev),
                                        torch.from_numpy(seeds).to(dev)),
                           torch.from_numpy(tok_idx).to(dev))
        return prng.categorical(key, logits.to(torch.float32) / temp
                                ).to(torch.int32)

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
        jobs: List[_AdmitJob] = []
        for req, slot in zip(reqs, free):
            plen = len(req.prompt)
            # the trie walk: requests prefill only their uncached suffix,
            # and the prefill bucket is chosen on SUFFIX length
            hit = self.prefix.lookup(req.prompt) \
                if self.prefix is not None else None
            hit_len = hit.length if hit is not None else 0
            jobs.append(_AdmitJob(
                req=req, slot=slot, plen=plen, hit=hit,
                seed=self._seeds.pop(req.uid, req.uid),
                bucket=cfg.bucket_for(plen - hit_len)))
        # group same-bucket admissions into shared (k, bucket) prefills, k
        # drawn from the declared power-of-two ladder
        groups: Dict[int, List[_AdmitJob]] = {}
        for job in jobs:
            groups.setdefault(job.bucket, []).append(job)
        ladder = cfg.prefill_k_ladder
        for b, group in groups.items():
            while group:
                k = max(x for x in ladder if x <= len(group))
                self._admit_chunk(group[:k], b)
                group = group[k:]

        # stream in arrival order regardless of chunk grouping: the
        # admission accounting ("cache") event, then the first token
        now = self._clock()
        retire: List[int] = []
        for job in jobs:
            st = _SlotState(uid=job.req.uid, user=job.req.user,
                            seed=job.seed, prompt_len=job.plen,
                            bucket=job.bucket,
                            max_new=job.req.max_new_tokens,
                            arrival_s=job.req.arrival_s,
                            ttft_s=now - job.req.arrival_s,
                            tokens=[job.first], cur=job.first)
            self._slots[job.slot] = st
            self.stats.admitted += 1
            self.stats.generated_tokens += 1
            if self._used_before[job.slot]:
                self.stats.slot_reuses += 1
            self._used_before[job.slot] = True
            if job.hit is not None:
                events.append(StreamEvent(
                    uid=st.uid, kind="cache", slot=job.slot,
                    step=self._step_count, time_s=now, user=st.user,
                    hit_tokens=job.hit.length, prompt_tokens=job.plen,
                    bytes_saved=job.hit.nbytes))
            events.append(StreamEvent(uid=st.uid, kind="token",
                                      slot=job.slot, step=self._step_count,
                                      time_s=now, user=st.user,
                                      token=job.first, index=0,
                                      ttft_s=st.ttft_s))
            if job.first == cfg.eos_id or st.max_new <= 1:
                retire.append(job.slot)
        if retire:
            self._retire(retire, events, now)

    def _admit_chunk(self, jobs: List[_AdmitJob], bucket: int) -> None:
        """Prefill up to k same-bucket requests together (one backend
        ``prefill`` call, or the decode step run over the bucket's tokens)
        after their cached prefixes, write their caches into the rolling
        cache at their slots, feed each request's first-slab KV rows back
        into the trie, and set each job's first token."""
        cfg, dev = self.config, self._device
        k = len(jobs)
        toks = np.full((k, bucket), cfg.pad_id, np.int32)
        suffix_lens = np.zeros((k,), np.int32)
        plens = np.zeros((k,), np.int32)
        prefix_lens = np.zeros((k,), np.int32)
        seeds = np.zeros((k,), np.int64)
        for r, job in enumerate(jobs):
            suffix = job.req.prompt[job.hit_len:]
            toks[r, :len(suffix)] = suffix
            suffix_lens[r] = len(suffix)
            plens[r] = job.plen
            prefix_lens[r] = job.hit_len
            seeds[r] = job.seed
        toks_t = torch.from_numpy(toks).to(dev)
        lengths_t = torch.from_numpy(suffix_lens).to(dev)
        self._ran(f"prefill_k{k}_b{bucket}", toks_t)
        be = self.backend
        cachek = be.init_cache(k, True)
        prefix_t = None
        if prefix_lens.any():
            prefix_t = torch.from_numpy(prefix_lens).to(dev)
            self._load_prefix(cachek, jobs, int(prefix_lens.max()))
        if be.prefill is not None:
            extra = () if prefix_t is None else (prefix_t,)
            last, cachek = be.prefill(be.params, cachek, toks_t, lengths_t,
                                      *extra)
        else:
            if prefix_t is not None:
                # each row's decode loop starts at its prefix length
                cachek["pos"] = prefix_t.to(cachek["pos"].dtype)
            last = torch.zeros((k, be.vocab_size), dtype=torch.float32,
                               device=dev)
            for i in range(bucket):
                logits, cachek = be.decode(be.params, cachek,
                                           toks_t[:, i:i + 1])
                last = torch.where((lengths_t - 1 == i)[:, None], logits,
                                   last)
        sampled = self._sample_rows(last, seeds, np.zeros((k,), np.int64))
        rows = metric_rows(last, sampled, cfg.eos_id)
        # the first `slab` KV rows of every admitted request, one tensor
        packed = self._gather(cachek, k) if self.prefix is not None else None

        # write: each slot restarts at its full prompt length, and its
        # metrics row is reset to the prefill's first-token row (one write)
        slots = torch.tensor([job.slot for job in jobs], dtype=torch.long,
                             device=dev)
        self._ran(f"write_k{k}", slots)
        for key, big in self._cache.items():
            if key == "pos":
                big[slots] = torch.from_numpy(plens).to(dev, big.dtype)
            else:
                pytree.tree_map(lambda b, s: b.index_copy_(0, slots, s),
                                big, cachek[key])
        self._table[slots] = rows
        sampled_np = sampled.cpu().numpy()
        for r, job in enumerate(jobs):
            job.first = int(sampled_np[r])
        if packed is not None:
            B = cfg.prefix_block
            max_blocks = self._slab // B
            for r, job in enumerate(jobs):
                # a block's payload: one slice of the packed rows, on the
                # device (one copy, not one per cache leaf)
                self.prefix.insert(
                    job.req.prompt,
                    lambda i, r=r: [packed[r, i * B:(i + 1) * B].clone()],
                    max_blocks=max_blocks)
        self.stats.prefill_calls += 1
        if k > 1:
            self.stats.batched_admissions += k

    @staticmethod
    def _kv_leaves(cache) -> List[torch.Tensor]:
        """The cache's KV leaves (every leaf but ``pos``), batch at axis 0
        and position at axis 1."""
        return pytree.tree_leaves([leaf for key, leaf in cache.items()
                                   if key != "pos"])

    def _gather(self, cachek, k: int) -> torch.Tensor:
        """Rows ``[0, slab)`` of every KV leaf of a k-row cache packed into
        ONE (k, slab, F) tensor (F: the leaves' trailing sizes, in leaf
        order), from which each trie block's payload is one slice."""
        slab = self._slab
        packed = torch.cat([leaf[:, :slab].reshape(k, slab, -1)
                            for leaf in self._kv_leaves(cachek)], dim=2)
        self._ran(f"gather_k{k}", packed)
        return packed

    def _load_prefix(self, cachek, jobs: List[_AdmitJob], rows: int) -> None:
        """Write each job's cached prefix blocks into rows ``[0, hit_len)``
        of its row of a fresh k-row cache (the rest stay zero): the
        payloads concatenated into one (k, rows, F) tensor, then one copy
        per KV leaf."""
        leaves = self._kv_leaves(cachek)
        width = sum(leaf[0, 0].numel() for leaf in leaves)
        buf = leaves[0].new_zeros((len(jobs), rows, width))
        for r, job in enumerate(jobs):
            if job.hit_len:
                buf[r, :job.hit_len] = torch.cat(
                    [blk[0] for blk in job.hit.blocks])
        off = 0
        for leaf in leaves:
            f = leaf[0, 0].numel()
            leaf[:, :rows] = buf[..., off:off + f].reshape(
                leaf[:, :rows].shape)
            off += f

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
        if self.prefix is not None:
            # ONE keyed stats fold per engine step carries every cache
            # event this step produced (hits + inserts)
            self.prefix.flush_stats()
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
