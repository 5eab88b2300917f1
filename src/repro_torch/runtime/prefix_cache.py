"""Radix prefix KV cache with monoid-fold bookkeeping — the port of
``repro/runtime/prefix_cache.py``.

Concurrent requests share prompt prefixes (system prompts, few-shot
templates), yet a cold admission re-prefills the whole prompt.  This module
caches the KV rows of previously prefilled prompts in a *block-quantized
radix trie* over token ids: each trie node owns exactly ``block`` tokens'
worth of KV rows, so the longest cached prefix of a new prompt is a trie
walk, and admission prefills only the remaining suffix
(``runtime/engine.py`` buckets on *suffix* length).

The bookkeeping is the paper's angle.  Hit counts, resident bytes and the
eviction score are the columns of ONE per-node monoid state,
:func:`repro_torch.core.monoids.cache_stats` (a product of two additive
columns and a decayed-LRU score), and the stats table, keyed by trie-node
id, is a dict of tensors on the engine's device that updates through one
planner-lowered keyed fold (:func:`repro_torch.core.plan.execute_fold`,
node id == segment id) per engine step.  Host code appends event rows (hit,
insert) as they happen; :meth:`PrefixCache.flush_stats` folds them in
fixed ``events_per_fold``-row chunks, padding rows masked to the identity.
Eviction reads the table back, re-anchors the decayed scores to now
(:func:`~repro_torch.core.monoids.decayed_value`) and removes the
lowest-scoring childless node.

The trie is payload-agnostic: the engine hands it a list of tensors per
block (it keeps them on its device), a test may hand it anything with
``numel()`` and ``element_size()``.  PyTorch runs eagerly, so the JAX
package's compiled programs become program *shapes*:
:meth:`PrefixCache.compile_counts` counts the distinct input shapes the
stats fold and the row reset ran with.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core import monoids
from ..core.plan import execute_fold


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Sizing and behaviour of the prefix cache.

    block: tokens per trie node (prefix hits are quantized to multiples).
    capacity: max trie nodes == rows of the stats table (segment-id space).
    max_bytes: resident-KV byte budget (None = bounded by capacity only).
    half_life_s: decayed-LRU half life of the eviction score.
    events_per_fold: fixed row count of one stats fold (events are padded
      to this width with masked identity rows, so the fold has one shape).
    """

    block: int = 4
    capacity: int = 256
    max_bytes: Optional[int] = None
    half_life_s: float = 60.0
    events_per_fold: int = 64

    def __post_init__(self):
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.max_bytes is not None and self.max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {self.max_bytes}")
        if self.half_life_s <= 0:
            raise ValueError(
                f"half_life_s must be positive, got {self.half_life_s}")
        if self.events_per_fold < 1:
            raise ValueError(
                f"events_per_fold must be >= 1, got {self.events_per_fold}")


@dataclasses.dataclass
class PrefixHit:
    """Longest cached block-aligned prefix of a prompt.

    length: tokens covered (multiple of ``block``; 0 = miss).
    blocks: per-block KV payloads, each the list of tensors that was
      inserted for that block.
    node_ids: stats-table row per block (hit events were recorded).
    nbytes: resident bytes of the reused payloads (the bytes NOT
      re-prefilled).
    """

    length: int
    blocks: List[List[Any]]
    node_ids: List[int]
    nbytes: int


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 block
    hit_tokens: int = 0           # prompt tokens served from the cache
    prompt_tokens: int = 0        # all prompt tokens seen by lookup()
    bytes_saved: int = 0          # KV bytes not re-prefilled
    inserted_nodes: int = 0
    evictions: int = 0
    folds: int = 0                # planner folds executed
    fold_rows: int = 0            # event rows folded (excl. padding)

    def hit_rate(self) -> float:
        """Fraction of prompt tokens served from the cache."""
        return self.hit_tokens / max(self.prompt_tokens, 1)


class _Node:
    __slots__ = ("key", "node_id", "payload", "nbytes", "parent", "children")

    def __init__(self, key, node_id, payload, nbytes, parent):
        self.key = key                  # tuple of `block` token ids
        self.node_id = node_id          # row in the stats table
        self.payload = payload          # list of tensors (KV rows)
        self.nbytes = nbytes
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}


def _nbytes(arrays) -> int:
    """Bytes of a payload: numel x element size of each tensor."""
    return int(sum(int(a.numel()) * int(a.element_size()) for a in arrays))


class PrefixCache:
    """Block-quantized radix trie over tokenized prompts; KV rows per node;
    all bookkeeping through one keyed monoid fold (see module docstring).
    The stats table lives on ``device``; ``clock`` gives event times."""

    def __init__(self, config: PrefixCacheConfig = PrefixCacheConfig(), *,
                 clock: Callable[[], float] = time.monotonic,
                 device="cpu"):
        self.config = config
        self.monoid = monoids.cache_stats(config.half_life_s)
        self._clock = clock
        self._device = torch.device(device)
        self._root = _Node(key=None, node_id=-1, payload=None, nbytes=0,
                           parent=None)
        self._nodes: Dict[int, _Node] = {}
        self._free = list(range(config.capacity - 1, -1, -1))  # pop() -> 0
        self._bytes = 0      # host mirror of the table's bytes column
        self.stats = PrefixCacheStats()
        # pending event rows: (node_id, hits, bytes, score_weight, score_t)
        self._pending: List[Tuple[int, float, float, float, float]] = []
        C = config.capacity

        def zeros():
            return torch.zeros((C,), dtype=torch.float32, device=self._device)

        self._table = {
            "bytes": zeros(),
            "hits": zeros(),
            "score": (zeros(), torch.full((C,), -math.inf,
                                          dtype=torch.float32,
                                          device=self._device)),
        }
        # distinct input shapes each program ran with (eager "compiles")
        self._shapes: Dict[str, Set[Tuple]] = {"prefix_stats_fold": set(),
                                               "prefix_row_reset": set()}

    # -- sizes --------------------------------------------------------------

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    @property
    def total_bytes(self) -> int:
        """Resident KV bytes (host mirror; equals the table's bytes sum)."""
        return self._bytes

    # -- the keyed stats fold -----------------------------------------------

    def _event(self, nid: int, hits: float, nbytes: float, weight: float,
               t: float) -> None:
        self._pending.append((nid, hits, nbytes, weight, t))

    def flush_stats(self) -> int:
        """Fold pending event rows into the stats table.

        Called once per engine step: all of a step's cache events reduce in
        ONE fixed-shape keyed fold (more only if a step produced more than
        ``events_per_fold`` rows).  Padding rows are masked to the identity
        via ``valid_mask``.  Returns the number of folds run.
        """
        E = self.config.events_per_fold
        n = 0
        while self._pending:
            chunk = self._pending[:E]
            del self._pending[:E]
            ids = np.zeros((E,), np.int32)
            cols = np.zeros((4, E), np.float32)     # hits, bytes, w, t
            cols[3] = -np.inf                       # identity anchor
            valid = np.zeros((E,), bool)
            for i, (nid, h, b, w, t) in enumerate(chunk):
                ids[i] = nid
                cols[:, i] = (h, b, w, t)
                valid[i] = True
            dev = self._device
            ids_t = torch.from_numpy(ids).to(dev)
            hits, nb, sw, st = torch.from_numpy(cols).to(dev)
            rows = {"bytes": nb, "hits": hits, "score": (sw, st)}
            self._shapes["prefix_stats_fold"].add((tuple(ids_t.shape),))
            self._table = execute_fold(
                self.monoid, rows, segment_ids=ids_t,
                num_segments=self.config.capacity,
                valid_mask=torch.from_numpy(valid).to(dev), init=self._table)
            n += 1
            self.stats.folds += 1
            self.stats.fold_rows += len(chunk)
        return n

    def _reset_row(self, nid: int) -> None:
        """Set one row back to the identity: the monoid-consistent way to
        retire a node id (the bytes column drops by the node's bytes, so
        sum(bytes) keeps equalling resident bytes)."""
        self._shapes["prefix_row_reset"].add(())
        tab = self._table
        tab["bytes"][nid] = 0.0
        tab["hits"][nid] = 0.0
        tab["score"][0][nid] = 0.0
        tab["score"][1][nid] = -math.inf

    def table(self) -> Dict:
        """The folded stats table (host copies), pending events flushed."""
        self.flush_stats()

        def host(x):
            return x.to("cpu", copy=True)

        t = self._table
        return {"bytes": host(t["bytes"]), "hits": host(t["hits"]),
                "score": (host(t["score"][0]), host(t["score"][1]))}

    def accounted_bytes(self) -> int:
        """Resident bytes as accounted by the fold (sum of the bytes
        column), equal to :attr:`total_bytes` by construction."""
        return int(round(float(self.table()["bytes"].double().sum())))

    def scores(self, now: float) -> np.ndarray:
        """(capacity,) decayed eviction scores re-anchored to ``now``."""
        self.flush_stats()
        val = monoids.decayed_value(self._table["score"], now,
                                    self.config.half_life_s)
        return val.cpu().numpy()

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input shapes the stats fold and the row reset ran with
        (the JAX package's compiled-program counts)."""
        return {name: len(s) for name, s in self._shapes.items()}

    # -- lookup / insert / evict --------------------------------------------

    def lookup(self, prompt: Sequence[int]) -> PrefixHit:
        """Longest cached block-aligned prefix STRICTLY shorter than the
        prompt (at least one token must remain to prefill: the suffix
        prefill produces the first sampled token's logits)."""
        B = self.config.block
        self.stats.lookups += 1
        self.stats.prompt_tokens += len(prompt)
        limit = max(len(prompt) - 1, 0) // B
        node = self._root
        blocks: List[List[Any]] = []
        ids: List[int] = []
        nbytes = 0
        for i in range(limit):
            child = node.children.get(
                tuple(int(t) for t in prompt[i * B:(i + 1) * B]))
            if child is None:
                break
            node = child
            blocks.append(child.payload)
            ids.append(child.node_id)
            nbytes += child.nbytes
        t = float(self._clock())
        for nid in ids:
            self._event(nid, 1.0, 0.0, 1.0, t)
        length = len(blocks) * B
        if length:
            self.stats.hits += 1
            self.stats.hit_tokens += length
            self.stats.bytes_saved += nbytes
        return PrefixHit(length=length, blocks=blocks, node_ids=ids,
                         nbytes=nbytes)

    def insert(self, prompt: Sequence[int],
               payload: Callable[[int], List[Any]], *,
               max_blocks: Optional[int] = None) -> int:
        """Insert the full-block prefixes of ``prompt`` into the trie.

        ``payload(i)`` materializes block i's KV rows (a list of tensors),
        called only for blocks not already cached.  Returns the number of
        new nodes.  Evicts (childless, lowest decayed score first) when the
        node capacity or byte budget would overflow; nodes on the path
        being inserted are protected.
        """
        B = self.config.block
        n = len(prompt) // B
        if max_blocks is not None:
            n = min(n, max_blocks)
        node = self._root
        t = float(self._clock())
        protect: Set[int] = set()
        created = 0
        for i in range(n):
            key = tuple(int(x) for x in prompt[i * B:(i + 1) * B])
            child = node.children.get(key)
            if child is None:
                child = self._new_node(node, key, payload(i), t, protect)
                if child is None:
                    break          # budget exhausted, nothing evictable
                created += 1
            protect.add(child.node_id)
            node = child
        return created

    def _new_node(self, parent: _Node, key, arrays: List[Any], t: float,
                  protect) -> Optional[_Node]:
        nbytes = _nbytes(arrays)
        mb = self.config.max_bytes
        if mb is not None and nbytes > mb:
            return None
        if not self._free and not self._evict_one(protect):
            return None
        while mb is not None and self._bytes + nbytes > mb:
            if not self._evict_one(protect):
                return None
        nid = self._free.pop()
        node = _Node(key=key, node_id=nid, payload=list(arrays),
                     nbytes=nbytes, parent=parent)
        parent.children[key] = node
        self._nodes[nid] = node
        self._bytes += nbytes
        self.stats.inserted_nodes += 1
        # insertion event: bytes land in the accounting column, the score
        # anchors at now (a fresh node is as warm as a fresh hit)
        self._event(nid, 0.0, float(nbytes), 1.0, t)
        return node

    def evict(self, n: int = 1) -> int:
        """Evict up to ``n`` nodes (childless, lowest decayed score first).
        Returns how many were evicted."""
        done = 0
        while done < n and self._evict_one(frozenset()):
            done += 1
        return done

    def _evict_one(self, protect) -> bool:
        # pending hit events move scores: fold them BEFORE choosing a victim
        # (and no pending row may reference the id about to be freed)
        self.flush_stats()
        candidates = [nd for nd in self._nodes.values()
                      if not nd.children and nd.node_id not in protect]
        if not candidates:
            return False
        scores = self.scores(float(self._clock()))
        victim = min(candidates,
                     key=lambda nd: (float(scores[nd.node_id]), nd.node_id))
        del victim.parent.children[victim.key]
        del self._nodes[victim.node_id]
        self._bytes -= victim.nbytes
        self._reset_row(victim.node_id)
        self._free.append(victim.node_id)
        self.stats.evictions += 1
        return True
