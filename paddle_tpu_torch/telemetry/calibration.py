"""Predicted-vs-measured calibration: the pair registry with its drift
rule, and the fitted constants' DB.

Port of ``paddle_tpu/telemetry/calibration.py``.

**Pair registry** — instrumentation sites call ``record(key, predicted,
measured)`` with a stable key per model. The port's one site today is
``tuner:<kernel>``: the tuning DB's ``mean_us`` for a key against a fresh
timing of the same key on the card (``ops.tuner.tune``). The reference's
other keys (``step_time``, ``serving_queue_wait``, ``collective_<link>``,
``planner_step_time``) arrive with the modules that predict them.

Every record exports ``calibration_drift_ratio{key}`` (= measured /
predicted) and ``calibration_samples_total{key}`` when telemetry is
enabled; :func:`summary` and :func:`pair` read the pairs without a
telemetry scope. A drift rule latches per key: once at least
``min_samples`` pairs exist and ``|log(measured/predicted)|`` exceeds
``drift_log_bound`` (default ln 4), it fires ONE reason-tagged flight
dump (``flight_calibration_drift_*.json``) and counts
``calibration_drift_breaches_total{key}``; the latch re-arms only after
the drift recovers to half the bound in log space (slo.py's hysteresis).

**Fitting** — :func:`fit` regresses measured collective time against the
ring wire model (``t = latency + bytes / bandwidth``, least squares per
link class, :func:`fit_link`), measured step time against the step's
FLOPs (the effective ``peak_flops_per_sec`` is the median of
flops/second) and measured serving batches into rows/s, then saves the
constants into a ``calibration_db.json`` overlay with the tuning DB's
conventions: the seed shipped beside this module under the overlay
(``PADDLE_TPU_TORCH_CALIBRATION_DB``, else
``~/.cache/paddle_tpu_torch/calibration_db.json``), the overlay winning
per device kind (``ops.tuner.device_kind``), an atomic save, a corrupt
file read as empty with one warning. ``telemetry.peak_flops_per_sec()``
reads the fitted rate. Nothing in the port reads
:func:`link_bandwidth_override` or :func:`link_latency_override` until
``mesh.link_bandwidth`` and the cost model are ported (ROADMAP item 16),
and :func:`serving_rates` seeds ``DecodeServer``'s admission EWMA only
with ROADMAP item 13. Precedence everywhere: an explicit environment
override, then the calibration DB, then the shipped defaults.
"""
from __future__ import annotations

import json
import math
import os
import threading
import warnings
from typing import Dict, List, Optional, Tuple

from .metrics import StreamingQuantile

__all__ = [
    "record", "drift", "summary", "pair", "reset",
    "CalibrationRegistry", "CalibrationDB",
    "default_db_path", "overlay_db_path", "get_db", "clear_cache",
    "constants", "device_kind", "GENERIC_DEVICE",
    "link_bandwidth_override", "link_latency_override",
    "peak_flops_override", "serving_rates",
    "fit", "fit_link",
    "DRIFT_LOG_BOUND", "MIN_SAMPLES_FOR_BREACH",
]

GENERIC_DEVICE = "any"   # device-agnostic fallback entry (tuner convention)

_VERSION = 1

# |log(measured/predicted)| above this fires the drift rule: ln(4) means
# the model is off by more than 4x in either direction.
DRIFT_LOG_BOUND = math.log(4.0)
# a single noisy pair must not dump the flight ring
MIN_SAMPLES_FOR_BREACH = 5


# ---------------------------------------------------------------------------
# pair registry
# ---------------------------------------------------------------------------

class _KeyState:
    __slots__ = ("n", "predicted", "measured", "log_drifts", "latched",
                 "breaches")

    def __init__(self):
        self.n = 0
        self.predicted: Optional[float] = None   # most recent pair
        self.measured: Optional[float] = None
        self.log_drifts = StreamingQuantile(maxlen=256)
        self.latched = False                     # breach fired, not recovered
        self.breaches = 0


class CalibrationRegistry:
    """(prediction, measurement) pairs per stable key, with the latched
    drift rule. One module-global instance backs :func:`record`."""

    def __init__(self, drift_log_bound: float = DRIFT_LOG_BOUND,
                 min_samples: int = MIN_SAMPLES_FOR_BREACH):
        self._lock = threading.Lock()
        self._keys: Dict[str, _KeyState] = {}
        self.drift_log_bound = float(drift_log_bound)
        self.min_samples = int(min_samples)

    def record(self, key: str, predicted: float, measured: float,
               step: Optional[int] = None) -> Optional[float]:
        """Record one pair; returns the drift ratio measured/predicted
        (None when either side is non-positive — a ratio needs two
        positive quantities, and a cold-start model that predicted 0 has
        nothing to calibrate)."""
        try:
            predicted = float(predicted)
            measured = float(measured)
        except (TypeError, ValueError):
            return None
        if predicted <= 0.0 or measured <= 0.0:
            return None
        ratio = measured / predicted
        log_drift = math.log(ratio)
        breach = False
        with self._lock:
            st = self._keys.setdefault(key, _KeyState())
            st.n += 1
            st.predicted, st.measured = predicted, measured
            st.log_drifts.add(log_drift)
            if st.n >= self.min_samples and \
                    abs(log_drift) > self.drift_log_bound:
                if not st.latched:
                    st.latched = True
                    st.breaches += 1
                    breach = True
            elif abs(log_drift) <= self.drift_log_bound / 2.0:
                # hysteresis (slo.py's latch): re-arm only once drift
                # recovers to half the bound in log space
                st.latched = False
        from paddle_tpu_torch import telemetry
        if telemetry.enabled():
            telemetry.gauge(
                "calibration_drift_ratio",
                "measured / predicted per calibration key (1.0 = the "
                "cost model is exact)").set(ratio, key=key)
            telemetry.counter(
                "calibration_samples_total",
                "(prediction, measurement) pairs recorded").inc(key=key)
            if breach:
                telemetry.counter(
                    "calibration_drift_breaches_total",
                    "latched |log drift| > bound events per key"
                ).inc(key=key)
        if breach:
            from . import flight
            flight.dump("calibration_drift", step=step, extra={
                "key": key, "predicted": predicted, "measured": measured,
                "drift": ratio, "log_drift": log_drift,
                "bound": self.drift_log_bound})
        return ratio

    def drift(self, key: str) -> Optional[float]:
        """Most recent drift ratio for ``key`` (None before any pair)."""
        with self._lock:
            st = self._keys.get(key)
            if st is None or not st.predicted or not st.measured:
                return None
            return st.measured / st.predicted

    def pair(self, key: str) -> Optional[dict]:
        """The ``{key, predicted, measured, drift, n}`` block for one key
        (None before any pair)."""
        with self._lock:
            st = self._keys.get(key)
            if st is None or st.predicted is None:
                return None
            return {"key": key, "predicted": st.predicted,
                    "measured": st.measured,
                    "drift": st.measured / st.predicted, "n": st.n}

    def summary(self) -> Dict[str, dict]:
        """Per-key drift summary (the streaming quantiles come from the
        shared ``metrics.StreamingQuantile``)."""
        out = {}
        with self._lock:
            for key, st in self._keys.items():
                out[key] = {
                    "n": st.n,
                    "predicted": st.predicted,
                    "measured": st.measured,
                    "drift": (st.measured / st.predicted
                              if st.predicted else None),
                    "log_drift_p50": st.log_drifts.median(),
                    "log_drift_p90": st.log_drifts.quantile(0.9),
                    "breaches": st.breaches,
                    "latched": st.latched,
                }
        return out

    def reset(self):
        with self._lock:
            self._keys.clear()


_registry = CalibrationRegistry()


def record(key: str, predicted: float, measured: float,
           step: Optional[int] = None) -> Optional[float]:
    return _registry.record(key, predicted, measured, step=step)


def drift(key: str) -> Optional[float]:
    return _registry.drift(key)


def pair(key: str) -> Optional[dict]:
    return _registry.pair(key)


def summary() -> Dict[str, dict]:
    return _registry.summary()


def reset():
    """Drop every recorded pair and latch (tests / fresh runs)."""
    _registry.reset()


# ---------------------------------------------------------------------------
# calibration DB (tuner-DB conventions: seed + overlay, atomic, fail-soft)
# ---------------------------------------------------------------------------

def default_db_path() -> str:
    """The in-repo seed DB shipped next to this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "calibration_db.json")


def overlay_db_path() -> str:
    """User-writable overlay: ``PADDLE_TPU_TORCH_CALIBRATION_DB`` or a
    cache-dir default. ``fit()`` writes here so the seed stays pristine."""
    env = os.environ.get("PADDLE_TPU_TORCH_CALIBRATION_DB")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "calibration_db.json")


def device_kind() -> str:
    """Normalized accelerator name keying the DB — the tuner's, so one
    notion of device identity serves both databases."""
    from ..ops.tuner import device_kind as _dk
    return _dk()


class CalibrationDB:
    """A {device_kind: entry} map with JSON round-trip. An entry is::

        {"links": {"ici": {"bandwidth_bps": 9.0e10, "latency_s": 2e-6,
                           "residual_rms_s": ..., "n": 4},
                   "dcn": {...}},
         "peak_flops_per_sec": 1.1e10,
         "serving": {"rows_per_s": 180.0, "batch_s": 0.05},
         "fitted": {"n_collective": 4, "n_compute": 3, "n_serving": 0}}

    Every field is optional — a partial fit (say, collectives only)
    overlays just what it measured and the consumers fall back to the
    shipped defaults for the rest.
    """

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.path = path

    # -- io -----------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "CalibrationDB":
        """Missing or corrupt files yield an EMPTY db (warn once on
        corruption) — a broken overlay must never take down pricing."""
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or \
                    not isinstance(raw.get("entries", {}), dict):
                raise ValueError("not a calibration DB object")
            return cls(raw.get("entries", {}), path=path)
        except (OSError, ValueError) as e:
            warnings.warn(f"calibration DB {path!r} unreadable ({e}); "
                          "treating as empty", stacklevel=2)
            return cls(path=path)

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            raise ValueError("CalibrationDB.save: no path")
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "entries": self.entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)

    # -- access -------------------------------------------------------------
    def lookup(self, device: str) -> Optional[dict]:
        return self.entries.get(device)

    def put(self, device: str, entry: dict):
        self.entries[device] = entry

    def merged_over(self, base: "CalibrationDB") -> "CalibrationDB":
        """self (overlay) wins per device over ``base``."""
        merged = dict(base.entries)
        merged.update(self.entries)
        return CalibrationDB(merged)

    def __len__(self):
        return len(self.entries)


_db_cache: Dict[str, object] = {}


def get_db(refresh: bool = False) -> CalibrationDB:
    """The merged (seed + overlay) DB, cached per (seed, overlay) paths."""
    key = (default_db_path(), overlay_db_path())
    if refresh or _db_cache.get("key") != key:
        base = CalibrationDB.load(key[0])
        overlay = CalibrationDB.load(key[1])
        _db_cache["key"] = key
        _db_cache["db"] = overlay.merged_over(base)
    return _db_cache["db"]


def clear_cache():
    """Drop the cached merged DB (tests / after a fit)."""
    _db_cache.clear()


def constants(device: Optional[str] = None) -> dict:
    """The calibration entry consumers price with: exact device kind
    first, then the :data:`GENERIC_DEVICE` entry, else empty (= shipped
    defaults everywhere)."""
    try:
        db = get_db()
        kinds = (device,) if device else (device_kind(), GENERIC_DEVICE)
        for dev in kinds:
            e = db.lookup(dev)
            if isinstance(e, dict):
                return e
    except Exception:  # pragma: no cover - pricing must never crash
        pass
    return {}


def _positive(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f > 0.0 and math.isfinite(f) else None


def link_bandwidth_override(link: str) -> Optional[float]:
    """Calibrated bytes/sec for one link class, or None to use the
    shipped link constant (read by nothing in the port until ROADMAP item
    16)."""
    return _positive(constants().get("links", {})
                     .get(link, {}).get("bandwidth_bps"))


def link_latency_override(link: str) -> Optional[float]:
    """Calibrated fixed per-collective latency (seconds), or None."""
    try:
        v = float(constants().get("links", {})
                  .get(link, {}).get("latency_s"))
    except (TypeError, ValueError):
        return None
    return v if v >= 0.0 and math.isfinite(v) else None


def peak_flops_override() -> Optional[float]:
    """Calibrated effective peak FLOP/s, or None."""
    return _positive(constants().get("peak_flops_per_sec"))


def serving_rates() -> Optional[Tuple[float, float]]:
    """Calibrated (rows_per_s, batch_s) seeding the serving admission
    EWMA, or None when the DB has no serving entry."""
    e = constants().get("serving") or {}
    rate = _positive(e.get("rows_per_s"))
    if rate is None:
        return None
    try:
        batch_s = max(0.0, float(e.get("batch_s") or 0.0))
    except (TypeError, ValueError):
        batch_s = 0.0
    return rate, batch_s


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def fit_link(samples: List[Tuple[float, float]]
             ) -> Optional[Tuple[float, float, float]]:
    """Least-squares ``t = latency + bytes / bandwidth`` over
    ``(wire_bytes, seconds)`` samples -> (bandwidth_bps, latency_s,
    residual_rms_s), or None when the samples cannot pin a positive
    bandwidth. With one sample (or no byte spread) latency stays 0 and
    bandwidth is the aggregate bytes/second; a fit whose slope comes out
    non-positive (timing noise swamped the size sweep) falls back to the
    same through-origin estimate."""
    pts = [(float(b), float(t)) for b, t in samples
           if float(b) > 0.0 and float(t) > 0.0]
    if not pts:
        return None
    n = len(pts)
    sx = sum(b for b, _ in pts)
    sy = sum(t for _, t in pts)

    def _origin():
        bw = sx / sy
        resid = math.sqrt(sum((t - b / bw) ** 2 for b, t in pts) / n)
        return bw, 0.0, resid

    mx, my = sx / n, sy / n
    sxx = sum((b - mx) ** 2 for b, _ in pts)
    if n == 1 or sxx <= 0.0:
        return _origin()
    sxy = sum((b - mx) * (t - my) for b, t in pts)
    slope = sxy / sxx                 # seconds per byte = 1 / bandwidth
    intercept = my - slope * mx       # fixed latency
    if slope <= 0.0:
        return _origin()
    if intercept < 0.0:
        # negative latency is unphysical: refit the slope through origin
        slope = sum(b * t for b, t in pts) / sum(b * b for b, _ in pts)
        intercept = 0.0
        if slope <= 0.0:
            return _origin()
    bw = 1.0 / slope
    resid = math.sqrt(sum((t - (intercept + b / bw)) ** 2
                          for b, t in pts) / n)
    return bw, intercept, resid


def _median(xs: List[float]) -> Optional[float]:
    xs = sorted(x for x in xs if x > 0.0)
    if not xs:
        return None
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def fit(collective_samples: Optional[List[dict]] = None,
        compute_samples: Optional[List[dict]] = None,
        serving_samples: Optional[List[dict]] = None,
        save: bool = True, db_path: Optional[str] = None,
        device: Optional[str] = None) -> dict:
    """Regress measured runtimes into corrected model constants.

    - ``collective_samples``: ``{"link", "wire_bytes", "seconds"}`` per
      measured exchange -> per-link ``bandwidth_bps`` + ``latency_s``
      (:func:`fit_link`'s wire-model least squares).
    - ``compute_samples``: ``{"flops", "seconds"}`` per measured step ->
      ``peak_flops_per_sec`` = median(flops / seconds) — the effective
      rate the MFU denominator and the overlap model's compute stream
      should actually use on this backend.
    - ``serving_samples``: ``{"rows", "seconds"}`` per measured batch ->
      ``serving.rows_per_s`` / ``batch_s`` seeding the admission EWMA.

    Merges into the existing overlay entry for ``device`` (default: this
    process's device kind), saves atomically to ``db_path`` (default:
    the overlay path) when ``save``, and clears the DB cache so every
    consumer picks the constants up on its next pricing call. Returns
    ``{"device", "path", "entry"}``.
    """
    dev = device or device_kind()
    path = db_path or overlay_db_path()
    db = CalibrationDB.load(path) if save else get_db()
    entry = dict(db.lookup(dev) or {})

    fitted = dict(entry.get("fitted") or {})
    if collective_samples:
        by_link: Dict[str, List[Tuple[float, float]]] = {}
        for s in collective_samples:
            by_link.setdefault(str(s.get("link", "ici")), []).append(
                (float(s["wire_bytes"]), float(s["seconds"])))
        links = dict(entry.get("links") or {})
        for link, pts in sorted(by_link.items()):
            res = fit_link(pts)
            if res is None:
                continue
            bw, lat, resid = res
            links[link] = {"bandwidth_bps": bw, "latency_s": lat,
                           "residual_rms_s": resid, "n": len(pts)}
        entry["links"] = links
        fitted["n_collective"] = sum(len(v) for v in by_link.values())
    if compute_samples:
        peak = _median([float(s["flops"]) / float(s["seconds"])
                        for s in compute_samples
                        if float(s.get("seconds", 0.0)) > 0.0])
        if peak:
            entry["peak_flops_per_sec"] = peak
        fitted["n_compute"] = len(compute_samples)
    if serving_samples:
        rates = [float(s["rows"]) / float(s["seconds"])
                 for s in serving_samples
                 if float(s.get("seconds", 0.0)) > 0.0]
        rate = _median(rates)
        batch_s = _median([float(s["seconds"]) for s in serving_samples])
        if rate:
            entry["serving"] = {"rows_per_s": rate,
                                "batch_s": batch_s or 0.0}
        fitted["n_serving"] = len(serving_samples)
    entry["fitted"] = fitted

    if save:
        db.put(dev, entry)
        db.save(path)
        clear_cache()
    return {"device": dev, "path": path if save else None, "entry": entry}
