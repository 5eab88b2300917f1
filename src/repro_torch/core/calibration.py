"""The calibrated time model behind the execution planner's tier choice.

Per local tier (kernel / segment_ops / scan / tree):

    t(n, b) = t0_us + n * us_per_record + n * b * us_per_byte

where ``n`` is the record count and ``b`` the bytes of one lifted monoid
value.  ``layout='auto'`` in :func:`repro_torch.core.plan.plan_fold` is an
argmin of this prediction over the FEASIBLE tiers.  Per collective link
(ici / dcn), which prices the shuffle stages of a plan across a shard axis:

    t(bytes) = launches * t0_us + per_device_wire_bytes * us_per_byte

and, for the async tier, the share of a link's in-flight time that a
double-buffered schedule hides (``overlap_frac``, :func:`predict_overlap`).
Coefficients are keyed ``"{monoid}|{dtype}"`` with a fallback chain down to
the tier-wide ``"*"`` entry; the ``fit_*`` functions turn timings into
coefficients.

The table lives on disk as versioned JSON at ``$REPRO_TORCH_CALIB`` if set
(the values ``none``/``off``/``default`` disable the disk cache and pin the
shipped defaults), else ``~/.cache/repro_torch/calib.json``.  The port has
its own path and variable so a table measured for the JAX tiers never
prices the torch tiers, or the reverse.  A table whose ``version`` does not
match :data:`CALIB_VERSION` is ignored in favour of the shipped default.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Dict, Mapping, Optional, Tuple

CALIB_VERSION = 2

TIER_KINDS = ("kernel", "segment_ops", "scan", "tree")
LINK_DOMAINS = ("ici", "dcn")

_ENV_VAR = "REPRO_TORCH_CALIB"
_DISABLED = ("none", "off", "default", "")


@dataclasses.dataclass(frozen=True)
class TierCoeff:
    """Coefficients of one tier's time model, in microseconds.

    t0_us: fixed launch/dispatch overhead.
    us_per_byte: inverse throughput (for links: inverse wire bandwidth).
    us_per_record: serial per-record cost (dominant for the scan tier; 0
      for links).
    overlap_frac: links only — the fraction of this link's in-flight time a
      double-buffered schedule can hide under independent compute (0: the
      crossings serialize with compute).
    """

    t0_us: float
    us_per_byte: float
    us_per_record: float = 0.0
    overlap_frac: float = 0.0

    def local_us(self, num_records: int, record_bytes: int) -> float:
        return (self.t0_us + num_records * self.us_per_record
                + num_records * record_bytes * self.us_per_byte)

    def link_us(self, wire_bytes: float, launches: int = 1) -> float:
        return launches * self.t0_us + wire_bytes * self.us_per_byte


def _coeff_to_json(c: TierCoeff) -> Dict[str, float]:
    return {"t0_us": c.t0_us, "us_per_byte": c.us_per_byte,
            "us_per_record": c.us_per_record,
            "overlap_frac": c.overlap_frac}


def _coeff_from_json(d: Mapping[str, float]) -> TierCoeff:
    return TierCoeff(t0_us=float(d.get("t0_us", 0.0)),
                     us_per_byte=float(d.get("us_per_byte", 0.0)),
                     us_per_record=float(d.get("us_per_record", 0.0)),
                     overlap_frac=float(d.get("overlap_frac", 0.0)))


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A versioned table of measured (or default) tier coefficients.

    tiers: tier kind -> {"monoid|dtype" | "monoid|*" | "*|dtype" | "*": TierCoeff}.
    collectives: "ici" / "dcn" -> TierCoeff; a domain missing here falls
      back to the shipped prior.
    source: 'default' for the shipped table, 'measured' for a written one.
    """

    version: int
    backend: str
    source: str
    tiers: Mapping[str, Mapping[str, TierCoeff]]
    collectives: Mapping[str, TierCoeff] = dataclasses.field(
        default_factory=dict)

    def tier_coeff(self, kind: str, monoid: str = "*",
                   dtype: str = "*") -> TierCoeff:
        table = self.tiers.get(kind, {})
        for key in (f"{monoid}|{dtype}", f"{monoid}|*", f"*|{dtype}", "*"):
            if key in table:
                return table[key]
        return TierCoeff(0.0, 0.0, 0.0)

    def link_coeff(self, domain: str) -> TierCoeff:
        if domain in self.collectives:
            return self.collectives[domain]
        return _DEFAULT_COLLECTIVES.get(domain, TierCoeff(0.0, 0.0))

    def predict_local_us(self, kind: str, *, monoid: str, dtype: str,
                         num_records: int, record_bytes: int) -> float:
        return self.tier_coeff(kind, monoid, dtype).local_us(
            num_records, record_bytes)

    def predict_link_us(self, domain: str, wire_bytes: float,
                        launches: int = 1) -> float:
        return self.link_coeff(domain).link_us(wire_bytes, launches)

    def to_json(self) -> Dict:
        return {
            "version": self.version,
            "backend": self.backend,
            "source": self.source,
            "tiers": {k: {key: _coeff_to_json(c) for key, c in t.items()}
                      for k, t in self.tiers.items()},
            "collectives": {d: _coeff_to_json(c)
                            for d, c in self.collectives.items()},
        }

    @classmethod
    def from_json(cls, payload: Mapping) -> "Calibration":
        return cls(
            version=int(payload["version"]),
            backend=str(payload.get("backend", "unknown")),
            source=str(payload.get("source", "measured")),
            tiers={k: {key: _coeff_from_json(c) for key, c in t.items()}
                   for k, t in payload.get("tiers", {}).items()},
            collectives={d: _coeff_from_json(c)
                         for d, c in payload.get("collectives", {}).items()},
        )


# The shipped table: the uncalibrated planner prefers the kernel tier
# whenever the feasibility filter admits it, segment-ops over the serial
# scan, and the log-depth tree over the scan for flat folds.  The same
# numbers as the JAX package's defaults.
_DEFAULT_TIERS: Dict[str, Dict[str, TierCoeff]] = {
    "kernel":      {"*": TierCoeff(t0_us=1.5, us_per_byte=1e-5,
                                   us_per_record=4e-4)},
    "segment_ops": {"*": TierCoeff(t0_us=2.0, us_per_byte=5e-5,
                                   us_per_record=2e-3)},
    "scan":        {"*": TierCoeff(t0_us=2.0, us_per_byte=1e-4,
                                   us_per_record=1.5)},
    "tree":        {"*": TierCoeff(t0_us=2.0, us_per_byte=5e-5,
                                   us_per_record=2e-2)},
}

# The link priors, the JAX package's defaults: ICI ~ tens of GB/s with a
# ~10 us launch, DCN ~ sub-GB/s with ~100 us latency, and the share of a
# crossing a double-buffered schedule hides.  They are priors of the cost
# model for a TPU pod's links, not times measured on any card; a table
# fitted (``fit_link_coeff`` / ``fit_overlap_frac``) on NVLink or a network
# replaces them.
_DEFAULT_COLLECTIVES: Dict[str, TierCoeff] = {
    "ici": TierCoeff(t0_us=10.0, us_per_byte=1e-4, overlap_frac=0.25),
    "dcn": TierCoeff(t0_us=100.0, us_per_byte=2e-3, overlap_frac=0.75),
}

_DEFAULT = Calibration(version=CALIB_VERSION, backend="any", source="default",
                       tiers=_DEFAULT_TIERS, collectives=_DEFAULT_COLLECTIVES)


def default_calibration() -> Calibration:
    """The shipped fallback table (used when no valid cache exists)."""
    return _DEFAULT


def calibration_path() -> Optional[str]:
    """``$REPRO_TORCH_CALIB`` when set (None for the sentinels that pin the
    shipped defaults), else ``~/.cache/repro_torch/calib.json``."""
    env = os.environ.get(_ENV_VAR)
    if env is not None:
        if env.strip().lower() in _DISABLED:
            return None
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "calib.json")


def load_calibration(path: Optional[str] = None) -> Optional[Calibration]:
    """Load a table; None when missing, unreadable, or of another version."""
    path = path if path is not None else calibration_path()
    if path is None:
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or payload.get("version") != CALIB_VERSION:
        return None
    try:
        return Calibration.from_json(payload)
    except (KeyError, TypeError, ValueError):
        return None


def save_calibration(calib: Calibration, path: Optional[str] = None) -> str:
    """Write ``calib`` to ``path`` (default: the resolved cache path)."""
    path = path if path is not None else calibration_path()
    if path is None:
        raise ValueError(
            f"calibration cache is disabled (${_ENV_VAR}="
            f"{os.environ.get(_ENV_VAR)!r}); pass an explicit path")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(calib.to_json(), f, indent=1, sort_keys=True)
    return path


_lock = threading.Lock()
_active: Optional[Calibration] = None           # explicit override
_cache: Tuple[Optional[Tuple[str, float]], Optional[Calibration]] = (None, None)


def set_calibration(calib: Optional[Calibration]) -> None:
    """Install ``calib`` as the active table (None restores env/disk/default
    resolution)."""
    global _active
    with _lock:
        _active = calib


@contextlib.contextmanager
def use_calibration(calib: Calibration):
    """Scoped override of the active table (how tests pin a table)."""
    global _active
    with _lock:
        prev, _active = _active, calib
    try:
        yield calib
    finally:
        with _lock:
            _active = prev


def get_calibration() -> Calibration:
    """The table plan_fold predicts from: scoped override > valid disk
    cache (memoized by path + mtime) > shipped default."""
    global _cache
    with _lock:
        if _active is not None:
            return _active
    path = calibration_path()
    if path is None:
        return _DEFAULT
    try:
        key = (path, os.path.getmtime(path))
    except OSError:
        return _DEFAULT
    with _lock:
        if _cache[0] == key and _cache[1] is not None:
            return _cache[1]
    loaded = load_calibration(path) or _DEFAULT
    with _lock:
        _cache = (key, loaded)
    return loaded


# ---------------------------------------------------------------------------
# the double-buffered pipeline model (the async execution tier)
# ---------------------------------------------------------------------------

def pipeline_exposed_us(*, num_crossings: int, slot_us: float,
                        cross_us: float) -> Tuple[float, float]:
    """Exposed microseconds of ``num_crossings`` link crossings in a
    double-buffered microbatch pipeline, BEFORE the link's ``overlap_frac``.

    Crossing *i* is in flight while microbatch slot *i+1* computes, so each
    of the first ``n - 1`` crossings can hide up to one compute slot; the
    epilogue crossing has nothing left to hide under.  Returns
    ``(exposed_us, hideable_us)`` with
    ``exposed + hideable == num_crossings * cross_us``.
    """
    n = max(int(num_crossings), 0)
    total = n * max(cross_us, 0.0)
    if n <= 1 or total <= 0.0:
        return total, 0.0
    hideable = (n - 1) * min(max(slot_us, 0.0), cross_us)
    return total - hideable, hideable


def predict_overlap(calib: Calibration, domain: str, *, num_crossings: int,
                    slot_us: float, wire_bytes: float) -> Tuple[float, float]:
    """Predicted ``(exposed_us, overlap_fraction)`` for ``num_crossings``
    double-buffered crossings of ``wire_bytes`` each over ``domain``: the
    link's ``overlap_frac`` scales the structurally hideable time."""
    coeff = calib.link_coeff(domain)
    cross_us = coeff.link_us(wire_bytes)
    exposed, hideable = pipeline_exposed_us(
        num_crossings=num_crossings, slot_us=slot_us, cross_us=cross_us)
    hidden = hideable * min(max(coeff.overlap_frac, 0.0), 1.0)
    total = num_crossings * cross_us
    if total <= 0.0:
        return 0.0, 0.0
    return total - hidden, hidden / total


# ---------------------------------------------------------------------------
# coefficient fitting
# ---------------------------------------------------------------------------

def fit_tier_coeff(*, n1: int, b1: int, t11_us: float, n2: int,
                   t21_us: float, b2: int, t22_us: float) -> TierCoeff:
    """Fit ``t(n, b) = t0 + n*us_per_record + n*b*us_per_byte`` from three
    measurements: (n1, b1), (n2, b1), (n2, b2).  Negative slopes (timing
    noise) clamp to 0, so a fitted table never predicts negative time."""
    if n2 <= n1 or b2 <= b1:
        raise ValueError(f"need n2 > n1 and b2 > b1; got n=({n1},{n2}) "
                         f"b=({b1},{b2})")
    us_per_byte = max((t22_us - t21_us) / (n2 * (b2 - b1)), 0.0)
    slope_n = max((t21_us - t11_us) / (n2 - n1), 0.0)
    us_per_record = max(slope_n - b1 * us_per_byte, 0.0)
    t0 = max(t11_us - n1 * slope_n, 0.0)
    return TierCoeff(t0_us=t0, us_per_byte=us_per_byte,
                     us_per_record=us_per_record)


def fit_link_coeff(*, bytes1: int, t1_us: float, bytes2: int, t2_us: float,
                   overlap_frac: float = 0.0) -> TierCoeff:
    """Fit ``t(bytes) = t0 + bytes*us_per_byte`` from two payload sizes."""
    if bytes2 <= bytes1:
        raise ValueError(f"need bytes2 > bytes1; got ({bytes1}, {bytes2})")
    us_per_byte = max((t2_us - t1_us) / (bytes2 - bytes1), 0.0)
    t0 = max(t1_us - bytes1 * us_per_byte, 0.0)
    return TierCoeff(t0_us=t0, us_per_byte=us_per_byte,
                     overlap_frac=overlap_frac)


def fit_overlap_frac(*, t_serial_us: float, t_dbuf_us: float,
                     t_compute_us: float) -> float:
    """A link's measured overlap from three timings of one microbatch fold:
    crossings waited after each compute slot (``t_serial``), crossings
    double-buffered against the next slot (``t_dbuf``), and no crossings
    (``t_compute``).  The crossings cost ``t_serial - t_compute``
    un-overlapped; the double-buffered schedule recovered
    ``t_serial - t_dbuf`` of it.  Clamped to [0, 1]."""
    crossings_us = t_serial_us - t_compute_us
    if crossings_us <= 0.0:
        return 0.0
    return min(max((t_serial_us - t_dbuf_us) / crossings_us, 0.0), 1.0)
