"""Windowed streaming analytics: sliding / tumbling monoid windows,
sessionization, and live per-user serving metrics.

The port of ``repro/data/windows.py``.  A window aggregate is a merge tree of
partial monoid states, so the same ``(combine, identity)`` pair that powers
the batch planner powers every window shape here, with no inverses: the
non-invertible zoo (max, CMS, HLL, top-k, decayed-LRU) slides too.

* :class:`SlidingWindow`: the two-stacks / flip-when-empty FIFO.  Each event
  costs O(1) amortized combines, and eviction never needs an inverse.
* :class:`TumblingWindow` / :func:`tumbling_fold`: fixed-width time buckets.
  The streaming class closes windows as event time advances; the batch
  function is ONE keyed :func:`repro_torch.core.plan.execute_fold` with
  window id == segment id, so on the card a ``sum_`` / ``max_`` / ``min_``
  fold runs the CUDA ``segment_fold`` kernel.
* :func:`sessionize` / :func:`session_fold`: per-user sessions split on
  inactivity gaps (host-side, on numpy), then one keyed fold with session
  id == segment id.  Merging per-host session tables
  (``data.stats.sync_stats``) is the mesh tier, a later slice of the port.

:class:`WindowedMetrics` is the serving consumer: subscribed to a
:class:`repro_torch.runtime.engine.ContinuousEngine`, every stream event
folds into per-user sliding windows (latency / TTFT / tokens through the
mean-pair monoid), per-user decayed token rates (``monoids.decayed_sum``),
and fleet-wide tumbling token and prefix-cache counters.

Every class takes a ``device`` (``cuda`` unless the caller passes
``device="cpu"``) and keeps its window state as tensors there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import monoids
from ..core.monoid import Monoid, Pytree
from ..core.plan import execute_fold
from ..device import resolve_device


def _on(value: Pytree, device: torch.device) -> Pytree:
    return pytree.tree_map(lambda x: torch.as_tensor(x, device=device), value)


def _device_of(values: Pytree) -> torch.device:
    return pytree.tree_leaves(values)[0].device


# ---------------------------------------------------------------------------
# sliding windows — the two-stacks trick
# ---------------------------------------------------------------------------

class SlidingWindow:
    """Aggregate of the last ``size`` events, O(1) amortized combines/event.

    Two stacks of partial monoid states:

    * ``back``: raw lifted values in arrival order, plus their running
      aggregate (``push`` costs one combine);
    * ``front``: suffix aggregates built when an eviction finds the front
      empty: the back stack is flipped, each popped value combined onto an
      accumulator so entry ``i`` stores ``fold(v_i .. v_newest)`` in stream
      order.  Each element flips at most once.

    ``query() == combine(front_top, back_agg)`` keeps stream order, so
    non-commutative monoids are safe, and no step removes a value from an
    aggregate, so non-invertible ones are too.

    ``example=`` seeds the identity for queries before the first push;
    otherwise the identity is derived from the first pushed value.  Values
    are moved to ``device``.
    """

    def __init__(self, m: Monoid, size: int, *,
                 example: Optional[Pytree] = None, device="cuda"):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self.monoid = m
        self.size = int(size)
        self.device = resolve_device(device)
        self._front: List[Pytree] = []    # suffix aggregates, top = oldest
        self._back: List[Pytree] = []     # raw values, arrival order
        self._back_agg: Optional[Pytree] = None
        self._identity = None if example is None else \
            m.identity_like(_on(example, self.device))
        self.pushes = 0
        self.flip_combines = 0            # telemetry: amortization is visible

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def _e(self) -> Pytree:
        if self._identity is None:
            raise ValueError(
                "query on an empty SlidingWindow with no identity: pass "
                "example= at construction or push a value first")
        return self._identity

    def push(self, value: Pytree, *, lifted: bool = True) -> None:
        """Fold one event in; evicts the oldest when the window is full."""
        v = _on(value, self.device)
        if not lifted:
            v = self.monoid.lift(v)
        if self._identity is None:
            self._identity = self.monoid.identity_like(v)
        if len(self) == self.size:
            self.evict()
        self._back.append(v)
        self._back_agg = (v if self._back_agg is None
                          else self.monoid.combine(self._back_agg, v))
        self.pushes += 1

    def evict(self) -> None:
        """Drop the oldest event (flip the back stack if front is empty)."""
        if not self._front:
            acc = self._e()
            while self._back:
                acc = self.monoid.combine(self._back.pop(), acc)
                self._front.append(acc)
                self.flip_combines += 1
            self._back_agg = None
        if not self._front:
            raise ValueError("evict from an empty window")
        self._front.pop()

    def query(self) -> Pytree:
        """The window aggregate (the identity when empty)."""
        front = self._front[-1] if self._front else None
        if front is None and self._back_agg is None:
            return self._e()
        if front is None:
            return self._back_agg
        if self._back_agg is None:
            return front
        return self.monoid.combine(front, self._back_agg)

    def extract(self) -> Pytree:
        return self.monoid.extract(self.query())


# ---------------------------------------------------------------------------
# tumbling windows — streaming and planner-lowered batch forms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowResult:
    """One closed window: [start, end) and its folded monoid value."""

    index: int
    start: float
    end: float
    value: Pytree


class TumblingWindow:
    """Fixed-width time windows over a time-ordered stream.

    ``push(value, t)`` folds the event into the open window and returns the
    list of :class:`WindowResult` it closed (empty windows are skipped).
    ``flush()`` closes and returns the open window, if any.  An event
    earlier than the open window raises.
    """

    def __init__(self, m: Monoid, width: float, *, t0: float = 0.0,
                 example: Optional[Pytree] = None, device="cuda"):
        if width <= 0:
            raise ValueError(f"window width must be positive, got {width}")
        self.monoid = m
        self.width = float(width)
        self.t0 = float(t0)
        self.device = resolve_device(device)
        self._idx: Optional[int] = None   # open window index
        self._state: Optional[Pytree] = None
        self._identity = None if example is None else \
            m.identity_like(_on(example, self.device))
        self.events = 0

    def _window_of(self, t: float) -> int:
        return int(math.floor((float(t) - self.t0) / self.width))

    def _close(self) -> WindowResult:
        res = WindowResult(index=self._idx,
                           start=self.t0 + self._idx * self.width,
                           end=self.t0 + (self._idx + 1) * self.width,
                           value=self._state)
        self._idx, self._state = None, None
        return res

    def push(self, value: Pytree, t: float, *,
             lifted: bool = True) -> List[WindowResult]:
        v = _on(value, self.device)
        if not lifted:
            v = self.monoid.lift(v)
        if self._identity is None:
            self._identity = self.monoid.identity_like(v)
        w = self._window_of(t)
        closed: List[WindowResult] = []
        if self._idx is not None and w < self._idx:
            raise ValueError(
                f"event at t={t} precedes the open window "
                f"[{self.t0 + self._idx * self.width}, ...): tumbling "
                "windows need a time-ordered stream")
        if self._idx is not None and w > self._idx:
            closed.append(self._close())
        if self._idx is None:
            self._idx, self._state = w, self.monoid.identity_like(v)
        self._state = self.monoid.combine(self._state, v)
        self.events += 1
        return closed

    def flush(self) -> List[WindowResult]:
        """Close the open window (end-of-stream)."""
        return [self._close()] if self._idx is not None else []


def tumbling_ids(timestamps, *, width: float, t0: float = 0.0,
                 device="cuda") -> torch.Tensor:
    """Window index per event, int32 on ``device``: the segment ids of a
    tumbling fold, ``floor((t - t0) / width)`` in float32 as the JAX
    package computes it."""
    dev = resolve_device(device)
    ts = torch.as_tensor(timestamps, dtype=torch.float32, device=dev)
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which may round a timestamp on a window edge the other way
    width_t = torch.tensor(width, dtype=torch.float32, device=dev)
    return torch.floor((ts - t0) / width_t).to(torch.int32)


def tumbling_fold(m: Monoid, values: Pytree, timestamps, *, width: float,
                  num_windows: int, t0: float = 0.0, valid_mask=None,
                  lifted: bool = True, **kwargs) -> Pytree:
    """Batch tumbling-window aggregation through the execution planner.

    Window id == segment id: the whole stream folds in ONE keyed fold on
    whatever tier the planner picks, returning a ``(num_windows, ...)``
    table on the values' device.  Events outside ``[t0, t0 +
    num_windows * width)`` are masked to the identity (the planner's
    ``valid_mask`` ragged path), composed with any caller mask.  Extra
    ``kwargs`` (``mesh_axes=``, ``layout=``, ``with_plan=``, ...) pass
    straight through to :func:`repro_torch.core.plan.execute_fold`.
    """
    dev = _device_of(values)
    ids = tumbling_ids(timestamps, width=width, t0=t0, device=dev)
    in_range = (ids >= 0) & (ids < num_windows)
    mask = (in_range if valid_mask is None
            else in_range & torch.as_tensor(valid_mask, dtype=torch.bool,
                                            device=dev))
    ids = torch.clamp(ids, 0, num_windows - 1)
    return execute_fold(m, values, segment_ids=ids,
                        num_segments=num_windows, valid_mask=mask,
                        lifted=lifted, **kwargs)


# ---------------------------------------------------------------------------
# sessionization — session id == segment id
# ---------------------------------------------------------------------------

def sessionize(user_ids, timestamps, *, gap: float) -> Tuple[np.ndarray, int]:
    """Split a time-ordered per-user event stream into sessions.

    A user's event starts a NEW session when it is their first event or
    arrives more than ``gap`` after their previous one.  Returns
    ``(session_ids, num_sessions)``: int32 numpy ids dense in order of
    session birth, the ``segment_ids`` of :func:`session_fold`.  Host-side
    by construction: session assignment is serial per user, while
    everything downstream of the ids is a data-parallel fold.
    """
    users = np.asarray(user_ids)
    ts = np.asarray(timestamps, np.float64)
    if users.ndim != 1 or users.shape != ts.shape:
        raise ValueError(
            f"user_ids and timestamps must be matching 1-D arrays, got "
            f"{users.shape} vs {ts.shape}")
    if ts.size > 1 and np.any(np.diff(ts) < 0):
        raise ValueError("timestamps must be non-decreasing (time-ordered "
                         "stream); sort events before sessionizing")
    out = np.empty(users.shape, np.int32)
    last_t: Dict[Any, float] = {}
    current: Dict[Any, int] = {}
    n = 0
    for i, (u, t) in enumerate(zip(users.tolist(), ts.tolist())):
        if u not in last_t or t - last_t[u] > gap:
            current[u] = n
            n += 1
        last_t[u] = t
        out[i] = current[u]
    return out, n


def session_fold(m: Monoid, values: Pytree, session_ids, num_sessions: int, *,
                 valid_mask=None, lifted: bool = True, **kwargs) -> Pytree:
    """Per-session aggregation: ONE planner-lowered keyed fold, a
    ``(num_sessions, ...)`` table on the values' device.  ``session_ids``
    come from :func:`sessionize`.  A session table is itself a monoid value
    under the element-wise combine, so per-host tables merge exactly:
    ``mesh_axes=`` (and the other ``kwargs``) pass through to
    :func:`repro_torch.core.plan.execute_fold`, which combines the hosts'
    tables across the bound mesh."""
    dev = _device_of(values)
    ids = torch.as_tensor(np.asarray(session_ids), dtype=torch.int32,
                          device=dev)
    if valid_mask is not None:
        valid_mask = torch.as_tensor(valid_mask, dtype=torch.bool, device=dev)
    return execute_fold(m, values, segment_ids=ids,
                        num_segments=num_sessions, valid_mask=valid_mask,
                        lifted=lifted, **kwargs)


# ---------------------------------------------------------------------------
# the serving consumer — live per-user windows over engine stream events
# ---------------------------------------------------------------------------

class WindowedMetrics:
    """Per-user serving metrics as monoid windows (an engine consumer).

    Subscribe to a :class:`repro_torch.runtime.engine.ContinuousEngine`::

        metrics = WindowedMetrics(window=32, half_life_s=60.0,
                                  device=engine.backend.device)
        engine.subscribe(metrics.observe)

    Per stream event:

    * ``token`` events fold ``(1, t)`` into the user's decayed token rate
      (``monoids.decayed_sum``) and ``1`` into a fleet-wide
      :class:`TumblingWindow` token counter;
    * ``done`` events push ``(latency, ttft, tokens)`` into the user's
      sliding window of the last ``window`` completed requests (the
      mean-pair monoid: one two-stacks window carries all three means);
    * ``cache`` events (prefix-cache admissions) fold ``(hit_tokens,
      prompt_tokens, bytes_saved)`` into a fleet-wide tumbling counter.

    State is O(window) per user and O(1) for the fleet, as tensors on
    ``device``; each event is a few 0-d tensor ops there.
    """

    def __init__(self, *, window: int = 32, half_life_s: float = 60.0,
                 tumble_s: float = 1.0, device="cuda"):
        self.window = int(window)
        self.half_life_s = float(half_life_s)
        self.device = resolve_device(device)
        self._rate_m = monoids.decayed_sum(half_life_s)
        self._per_user: Dict[Any, SlidingWindow] = {}
        self._rate: Dict[Any, Tuple] = {}
        self._one = torch.ones((), dtype=torch.float32, device=self.device)
        self._fleet = TumblingWindow(monoids.sum_, tumble_s,
                                     example=self._one, device=self.device)
        # (hit_tokens, prompt_tokens, bytes_saved) per tumble: one
        # vector-valued sum carries all three prefix-cache counters
        self._prefix = TumblingWindow(
            monoids.sum_, tumble_s, device=self.device,
            example=torch.zeros((3,), dtype=torch.float32))
        self.closed_fleet_windows: List[WindowResult] = []
        self.closed_prefix_windows: List[WindowResult] = []
        self.events = 0

    # -- the consumer entry point -------------------------------------------
    def observe(self, event) -> None:
        """Fold one engine ``StreamEvent`` in (duck-typed: ``kind``,
        ``user``, ``time_s``, and ``result`` for done events)."""
        self.events += 1
        if event.kind == "token":
            # torch.full fills on the device: no host-to-device copy
            v = (self._one, torch.full((), event.time_s, dtype=torch.float32,
                                       device=self.device))
            st = self._rate.get(event.user)
            self._rate[event.user] = (v if st is None
                                      else self._rate_m.combine(st, v))
            self.closed_fleet_windows.extend(
                self._fleet.push(self._one, event.time_s))
        elif event.kind == "done":
            r = event.result
            w = self._per_user.get(event.user)
            if w is None:
                w = self._per_user[event.user] = SlidingWindow(
                    monoids.mean, self.window, device=self.device)
            w.push((torch.tensor([r.latency_s, r.ttft_s,
                                  float(len(r.tokens))],
                                 dtype=torch.float32, device=self.device),
                    torch.ones((), dtype=torch.int32, device=self.device)))
        elif event.kind == "cache":
            v = torch.tensor([event.hit_tokens, event.prompt_tokens,
                              event.bytes_saved], dtype=torch.float32,
                             device=self.device)
            self.closed_prefix_windows.extend(
                self._prefix.push(v, event.time_s))

    # -- queries ------------------------------------------------------------
    def users(self) -> List[Any]:
        return sorted(set(self._per_user) | set(self._rate))

    def user_window(self, user) -> Dict[str, float]:
        """Windowed means over the user's last ``window`` requests."""
        w = self._per_user.get(user)
        if w is None or len(w) == 0:
            return {"requests": 0, "latency_s": 0.0, "ttft_s": 0.0,
                    "tokens": 0.0}
        mean = w.extract().cpu().numpy()
        return {"requests": len(w), "latency_s": float(mean[0]),
                "ttft_s": float(mean[1]), "tokens": float(mean[2])}

    def user_token_rate(self, user, now: float) -> float:
        """Decayed token count for ``user`` re-anchored to ``now``."""
        st = self._rate.get(user)
        if st is None:
            return 0.0
        return float(monoids.decayed_value(st, now, self.half_life_s))

    @staticmethod
    def _totals(closed: List[WindowResult],
                tw: TumblingWindow) -> np.ndarray:
        """float64 sum of the closed windows' values and the open one's
        (read, not closed: a query leaves the stream as it was)."""
        values = [r.value for r in closed]
        if tw._state is not None:
            values.append(tw._state)
        if not values:
            return np.zeros(tuple(tw._identity.shape), np.float64)
        return torch.stack(values).cpu().numpy().astype(np.float64).sum(0)

    def fleet_tokens(self) -> float:
        """Total tokens across closed fleet windows plus the open one."""
        return float(self._totals(self.closed_fleet_windows, self._fleet))

    def fleet_prefix(self) -> Dict[str, float]:
        """Fleet prefix-cache counters across closed windows plus the open
        one: hit/prompt token totals, bytes saved, and the hit rate."""
        total = self._totals(self.closed_prefix_windows, self._prefix)
        return {"hit_tokens": float(total[0]),
                "prompt_tokens": float(total[1]),
                "bytes_saved": float(total[2]),
                "hit_rate": float(total[0] / max(total[1], 1.0))}

    def summary(self, now: float) -> Dict[Any, Dict[str, float]]:
        """Per-user snapshot: windowed means + decayed token rate."""
        out = {}
        for u in self.users():
            row = self.user_window(u)
            row["token_rate"] = self.user_token_rate(u, now)
            out[u] = row
        return out
