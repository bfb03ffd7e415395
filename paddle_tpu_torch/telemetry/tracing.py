"""paddle_tpu_torch.telemetry.tracing — tail-sampled request tracing.

Port of ``paddle_tpu/telemetry/tracing.py`` (stdlib only). A trace follows
one unit of work (a serving request) through every thread it touches.

- Recording is cheap: a span is a plain object; ending it appends one
  dict to the flight-recorder ring (``telemetry.flight``) and bumps
  ``spans_recorded_total``.
- The keep/drop decision happens once, at trace close, when the outcome
  is known: traces that ended shed / expired / failed, failed over, blew
  a fraction of their deadline, or landed above a rolling latency
  percentile are kept (``traces_kept_total{reason}``); the rest drop.
- Disabled (the default), instrumentation sites read one module global
  (``enabled()``) and allocate nothing.

Cross-thread context is handed off explicitly: a ``Span`` rides on the
request object. ``use_span``/``add_event`` attach *ambient* events (the KV
cache reporting hits and evictions) to the thread's current span and never
propagate across threads. Accounting is closed:
``recorded == kept + dropped + still-open``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "Span", "Trace", "Tracer", "KeepPolicy",
    "enable", "disable", "enabled", "get_tracer", "reset",
    "start_trace", "use_span", "current_span", "add_event", "child_span",
    "snapshot_kept", "write_kept", "accounting", "accounted",
    "chrome_events", "thread_names", "min_t0_ns",
]

_KEEP_OUTCOMES = ("shed", "expired", "failed", "failover", "divergence")


def _registry():
    from paddle_tpu_torch import telemetry
    return telemetry.get_registry()


class KeepPolicy:
    """Tail-sampling rules evaluated once, at trace close (first match
    wins; the reason becomes the ``traces_kept_total`` label): bad outcome,
    failover, duration over ``deadline_fraction`` of the deadline, duration
    above the rolling ``latency_percentile`` (after
    ``percentile_min_samples`` closes). ``keep_all``/``keep_none`` override
    everything."""

    def __init__(self, keep_outcomes=_KEEP_OUTCOMES, deadline_fraction=0.9,
                 latency_percentile=0.99, percentile_min_samples=50,
                 keep_all=False, keep_none=False, reservoir=512):
        from .metrics import StreamingQuantile
        self.keep_outcomes = frozenset(keep_outcomes)
        self.deadline_fraction = deadline_fraction
        self.latency_percentile = latency_percentile
        self.percentile_min_samples = percentile_min_samples
        self.keep_all = keep_all
        self.keep_none = keep_none
        self._latencies = StreamingQuantile(maxlen=reservoir,
                                            recompute_every=64)

    def decide(self, outcome: str, duration_s: float,
               deadline_s: Optional[float], failover: bool) -> Optional[str]:
        """Return the keep reason, or None to drop."""
        try:
            if self.keep_none:
                return None
            if self.keep_all:
                return "forced"
            if outcome in self.keep_outcomes:
                return outcome
            if failover:
                return "failover"
            if deadline_s and duration_s > self.deadline_fraction * deadline_s:
                return "deadline"
            if len(self._latencies) >= self.percentile_min_samples and \
                    duration_s > self._latencies.quantile(
                        self.latency_percentile):
                return "latency_percentile"
            return None
        finally:
            self._latencies.add(duration_s)


class Span:
    """One timed operation inside a trace. Carry the object across threads
    for explicit handoff; ``end`` may run on another thread than the one
    that opened it."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "t0_ns", "t1_ns",
                 "attrs", "tid", "thread_name", "status", "events", "_ended")

    def __init__(self, trace: "Trace", span_id: int, parent_id: Optional[int],
                 name: str, attrs: Dict[str, Any]):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = None
        self.attrs = attrs
        cur = threading.current_thread()
        self.tid = cur.ident
        self.thread_name = cur.name
        self.status = "open"
        self.events: List[dict] = []
        self._ended = False

    def event(self, name: str, **attrs):
        """Attach a point-in-time event to this span."""
        self.events.append({"t_ns": time.perf_counter_ns(), "name": name,
                            **attrs})

    def end(self, status: str = "ok", **attrs):
        if self._ended:
            return
        self._ended = True
        self.t1_ns = time.perf_counter_ns()
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        end_thread = threading.current_thread()
        if end_thread.ident != self.tid:
            self.attrs.setdefault("end_thread", end_thread.name)
        self.trace._span_ended(self)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
            "tid": self.tid, "thread": self.thread_name,
            "status": self.status, "attrs": self.attrs,
            "events": list(self.events),
        }


class Trace:
    """A tree of spans under one root; closed exactly once with an outcome."""

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: List[dict] = []       # ended spans, recorded order
        self._ended_pending = 0            # ended spans awaiting close
        self.closed = False
        self.outcome: Optional[str] = None
        self.keep_reason: Optional[str] = None
        self.root = self.span(name, parent=None, **attrs)

    def span(self, name: str, parent: Optional[Span] = None, **attrs) -> Span:
        """Open a child span; ``parent`` defaults to the root span."""
        with self._lock:
            sid = next(self._ids)
        pid = None
        if sid > 1:
            pid = parent.span_id if parent is not None else self.root.span_id
        return Span(self, sid, pid, name, dict(attrs))

    def _span_ended(self, span: Span):
        rec = span.to_dict()
        with self._lock:
            late = self.closed
            if not late:
                self._spans.append(rec)
                self._ended_pending += 1
        self.tracer._record(rec, late=late)

    def close(self, outcome: str, deadline_s: Optional[float] = None,
              failover: bool = False, **attrs):
        """End the root (if still open) and run the keep/drop decision."""
        if attrs:
            self.root.attrs.update(attrs)
        if not self.root._ended:
            self.root.end(outcome)
        with self._lock:
            if self.closed:
                return
            self.closed = True
            spans = list(self._spans)
            pending = self._ended_pending
            self._ended_pending = 0
        dur_s = (self.root.t1_ns - self.root.t0_ns) / 1e9
        self.outcome = outcome
        self.tracer._close(self, spans, pending, outcome, dur_s,
                           deadline_s, failover)


class Tracer:
    """Process-wide span recorder with tail sampling and closed accounting."""

    def __init__(self, policy: Optional[KeepPolicy] = None, kept_max=256):
        self.policy = policy or KeepPolicy()
        self._lock = threading.Lock()
        self._kept = deque(maxlen=kept_max)   # trace dicts
        self._ids = itertools.count(1)
        self.traces_started = 0
        self.traces_closed = 0
        self.spans_recorded = 0
        self.spans_kept = 0
        self.spans_dropped = 0
        self._pending = 0    # ended spans inside still-open traces

    def start_trace(self, name: str, **attrs) -> Trace:
        with self._lock:
            self.traces_started += 1
            tid = f"t{next(self._ids):08x}"
        return Trace(self, tid, name, attrs)

    def _record(self, rec: dict, late: bool = False):
        from . import flight
        with self._lock:
            self.spans_recorded += 1
            if late:
                self.spans_dropped += 1   # trace already closed: drop now
            else:
                self._pending += 1
        flight.record(rec)
        _registry().counter("spans_recorded_total").inc()

    def _close(self, trace: Trace, spans: List[dict], pending: int,
               outcome: str, dur_s: float, deadline_s, failover: bool):
        reason = self.policy.decide(outcome, dur_s, deadline_s, failover)
        with self._lock:
            self.traces_closed += 1
            self._pending -= pending
            if reason is None:
                self.spans_dropped += pending
            else:
                self.spans_kept += pending
                trace.keep_reason = reason
                self._kept.append({
                    "trace_id": trace.trace_id, "name": trace.name,
                    "outcome": outcome, "keep_reason": reason,
                    "duration_s": dur_s, "deadline_s": deadline_s,
                    "spans": spans,
                })
        if reason is not None:
            _registry().counter("traces_kept_total").inc(reason=reason)

    def snapshot_kept(self) -> List[dict]:
        with self._lock:
            return list(self._kept)

    def accounting(self) -> dict:
        with self._lock:
            return {
                "traces_started": self.traces_started,
                "traces_closed": self.traces_closed,
                "recorded": self.spans_recorded,
                "kept": self.spans_kept,
                "dropped": self.spans_dropped,
                "open": self._pending,
            }

    def accounted(self) -> bool:
        """Every recorded span is kept, dropped, or inside an open trace."""
        a = self.accounting()
        return a["recorded"] == a["kept"] + a["dropped"] + a["open"]


# ---------------------------------------------------------------------------
# module-level state: one tracer, one enabled flag, a thread-local span stack

_enabled = False
_tracer = Tracer()
_local = threading.local()


def enable(on: bool = True, policy: Optional[KeepPolicy] = None,
           kept_max: int = 256):
    """Turn span recording on; passing ``policy`` swaps in a fresh tracer
    so accounting starts from zero."""
    global _enabled, _tracer
    if policy is not None:
        _tracer = Tracer(policy=policy, kept_max=kept_max)
    _enabled = bool(on)


def disable():
    enable(False)


def enabled() -> bool:
    """The one check every instrumentation site makes per span."""
    return _enabled


def reset(policy: Optional[KeepPolicy] = None, kept_max: int = 256):
    """Fresh tracer (zeroed accounting); keeps the enabled flag as-is."""
    global _tracer
    _tracer = Tracer(policy=policy, kept_max=kept_max)


def get_tracer() -> Tracer:
    return _tracer


def start_trace(name: str, **attrs) -> Optional[Trace]:
    """Open a trace, or return None when tracing is disabled."""
    if not _enabled:
        return None
    return _tracer.start_trace(name, **attrs)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class use_span:
    """Make ``span`` the thread's ambient span for ``add_event`` /
    ``child_span``. Accepts None (no-op) so call sites need no branch."""

    def __init__(self, span: Optional[Span]):
        self.span = span

    def __enter__(self):
        if self.span is not None:
            _stack().append(self.span)
        return self.span

    def __exit__(self, *exc):
        if self.span is not None:
            st = _stack()
            if st and st[-1] is self.span:
                st.pop()
            elif self.span in st:
                st.remove(self.span)
        return False


def current_span() -> Optional[Span]:
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def add_event(name: str, **attrs):
    """Attach an event to the thread's ambient span; no-op without one."""
    if not _enabled:
        return
    sp = current_span()
    if sp is not None and not sp._ended:
        sp.event(name, **attrs)


def child_span(name: str, **attrs) -> Optional[Span]:
    """Open a child of the thread's ambient span; None without one."""
    if not _enabled:
        return None
    sp = current_span()
    if sp is None:
        return None
    return sp.trace.span(name, parent=sp, **attrs)


def snapshot_kept() -> List[dict]:
    return _tracer.snapshot_kept()


def write_kept(path: str) -> Optional[str]:
    """Write the kept traces to ``path`` as JSON; None when nothing was
    kept."""
    kept = _tracer.snapshot_kept()
    if not kept:
        return None
    with open(path, "w") as f:
        json.dump({"traces": kept}, f, indent=1)
    return path


def accounting() -> dict:
    return _tracer.accounting()


def accounted() -> bool:
    return _tracer.accounted()


def chrome_events(base_ns: int) -> List[dict]:
    """Kept-trace spans as chrome-trace ``ph:"X"`` events rebased to
    ``base_ns``, for ``telemetry.export.chrome_trace``."""
    out = []
    pid = os.getpid()
    for tr in _tracer.snapshot_kept():
        for sp in tr["spans"]:
            if sp["t1_ns"] is None:
                continue
            out.append({
                "name": sp["name"], "cat": "trace", "ph": "X",
                "ts": (sp["t0_ns"] - base_ns) / 1e3,
                "dur": (sp["t1_ns"] - sp["t0_ns"]) / 1e3,
                "pid": pid, "tid": sp["tid"],
                "args": {"trace_id": sp["trace_id"],
                         "status": sp["status"], **sp["attrs"]},
            })
    return out


def thread_names() -> Dict[int, str]:
    """tid -> thread name observed on the kept traces' spans."""
    names: Dict[int, str] = {}
    for tr in _tracer.snapshot_kept():
        for sp in tr["spans"]:
            names[sp["tid"]] = sp["thread"]
    return names


def min_t0_ns() -> Optional[int]:
    """The earliest span start among the kept traces (export rebasing)."""
    t0s = [sp["t0_ns"] for tr in _tracer.snapshot_kept()
           for sp in tr["spans"]]
    return min(t0s) if t0s else None
