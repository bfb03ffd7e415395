"""Labeled metrics: Counter / Gauge / Histogram behind a Registry.

Port of ``paddle_tpu/telemetry/metrics.py`` (stdlib only). Three metric
kinds, each holding a family of series keyed by a sorted label set.

- Recording is host-side and cheap: one dict lookup and one lock per op.
- Metrics always record once you hold the object; the instrumentation
  sites gate on ``telemetry.enabled()`` so the disabled cost is one
  module-global read.
- With ``marks_enabled`` set on the registry every update also appends a
  timestamped mark (``time.perf_counter_ns`` timebase), which the flight
  recorder dumps.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
           "StreamingQuantile"]

# seconds, wide enough for microsecond launches through minute-long builds
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


class StreamingQuantile:
    """Quantile over the most recent ``maxlen`` observations. The sorted
    view is recomputed at most every ``recompute_every`` appends, so a read
    can be that many samples stale. Not thread-safe on its own: callers
    that share one hold their own lock."""

    __slots__ = ("_values", "_adds", "_sorted", "recompute_every")

    def __init__(self, maxlen: int = 512, recompute_every: int = 64):
        self._values = deque(maxlen=maxlen)
        self._adds = 0
        self._sorted: Optional[List[float]] = None
        self.recompute_every = max(1, int(recompute_every))

    def add(self, v: float):
        self._values.append(float(v))
        self._adds += 1
        if self._sorted is not None and \
                self._adds % self.recompute_every == 0:
            self._sorted = None

    def __len__(self) -> int:
        return len(self._values)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank ``q``-quantile (None when empty)."""
        n = len(self._values)
        if n == 0:
            return None
        if self._sorted is None or len(self._sorted) != n:
            self._sorted = sorted(self._values)
        return self._sorted[min(n - 1, int(float(q) * n))]

    def median(self) -> Optional[float]:
        return self.quantile(0.5)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry: "Registry" = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}
        self._registry = registry

    def _mark(self, key: LabelKey, value: float):
        reg = self._registry
        if reg is not None and reg.marks_enabled:
            reg._mark(self.name, key, value)

    def series(self) -> Dict[LabelKey, object]:
        with self._lock:
            return dict(self._series)

    def reset(self):
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonic sum per label set."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            v = self._series.get(key, 0.0) + n
            self._series[key] = v
        self._mark(key, v)
        return v

    def value(self, **labels) -> float:
        with self._lock:
            if labels:
                return float(self._series.get(_label_key(labels), 0.0))
            return float(sum(self._series.values()))


class Gauge(_Metric):
    """Last-set value per label set."""

    kind = "gauge"

    def set(self, v: float, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(v)
        self._mark(key, float(v))
        return float(v)

    def value(self, **labels) -> float:
        with self._lock:
            if labels:
                return float(self._series.get(_label_key(labels), 0.0))
            if not self._series:
                return 0.0
            if len(self._series) == 1:
                return float(next(iter(self._series.values())))
            return float(self._series.get((), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Bucketed distribution per label set (Prometheus-style le buckets)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", registry: "Registry" = None,
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, registry)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_BUCKETS))

    def observe(self, v: float, **labels):
        v = float(v)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            # first bucket whose upper bound holds v; past-the-end = +Inf
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    s.counts[i] += 1
                    break
            s.sum += v
            s.count += 1
        self._mark(key, v)

    def count(self, **labels) -> int:
        with self._lock:
            if labels:
                s = self._series.get(_label_key(labels))
                return s.count if s else 0
            return sum(s.count for s in self._series.values())

    def sum(self, **labels) -> float:
        with self._lock:
            if labels:
                s = self._series.get(_label_key(labels))
                return s.sum if s else 0.0
            return float(sum(s.sum for s in self._series.values()))


class Registry:
    """Name -> metric map plus the (optional) timestamped mark buffer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.marks_enabled = False
        self._marks = deque(maxlen=65536)  # (t_ns, name, labelkey, value)

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, registry=self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def _mark(self, name: str, key: LabelKey, value: float):
        self._marks.append((time.perf_counter_ns(), name, key, value))

    def marks(self) -> List[Tuple[int, str, LabelKey, float]]:
        return list(self._marks)

    def reset(self):
        """Drop every metric and mark (tests / fresh runs)."""
        with self._lock:
            self._metrics.clear()
        self._marks.clear()

    def to_dict(self) -> Dict[str, dict]:
        """JSON-friendly snapshot: ``{name: {type, help, series}}``."""
        out = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                series = {_fmt_key(k): {"count": s.count, "sum": s.sum}
                          for k, s in m.series().items()}
            else:
                series = {_fmt_key(k): v for k, v in m.series().items()}
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out


def _fmt_key(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key) if key else ""
