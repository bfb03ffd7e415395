"""Exporters: Prometheus text exposition, JSONL event sink, chrome-trace
counter merge.

Port of ``paddle_tpu/telemetry/export.py`` (stdlib only).

Three consumers, three formats:
- ``prometheus_text(registry)`` — the pull-scrape format, for dashboards;
- ``JsonlSink`` — append-only machine log, one JSON object per line, the
  artifact bench/CI diffing reads;
- ``chrome_trace(path, registry)`` — the profiler's host RecordEvent
  ranges plus the registry's metric marks as ``"ph": "C"`` counter
  events on ONE shared timebase, so step_time / mfu counters line up
  under the ``train_step`` ranges in chrome://tracing / Perfetto.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Optional

from .metrics import Histogram, Registry

__all__ = ["prometheus_text", "JsonlSink", "chrome_trace"]


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _esc_help(v: str) -> str:
    # HELP text escapes only backslash and newline — a double quote is
    # legal there and escaping it corrupts the exposition.
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _labels_str(key, extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry: Registry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    lines = []
    for m in registry.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            series = sorted(m.series().items())
            if not series:
                # A declared-but-unobserved histogram still needs a
                # consistent scrape: +Inf bucket, _sum and _count at 0.
                lines.append(f'{m.name}_bucket{{le="+Inf"}} 0')
                lines.append(f"{m.name}_sum 0")
                lines.append(f"{m.name}_count 0")
            for key, s in series:
                cum = 0
                for ub, c in zip(m.buckets, s.counts):
                    cum += c
                    if not math.isfinite(ub):
                        # a user-supplied inf bound would duplicate the
                        # +Inf line (and render as le="inf")
                        continue
                    le = 'le="%s"' % _num(ub)
                    lines.append(
                        f"{m.name}_bucket{_labels_str(key, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(
                    f"{m.name}_bucket{_labels_str(key, inf)} {s.count}")
                lines.append(f"{m.name}_sum{_labels_str(key)} {_num(s.sum)}")
                lines.append(f"{m.name}_count{_labels_str(key)} {s.count}")
        else:
            for key, v in sorted(m.series().items()):
                lines.append(f"{m.name}{_labels_str(key)} {_num(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


class JsonlSink:
    """Append-only JSON-lines event log (one flush per event: the file is
    readable mid-run and survives a killed process)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, obj: dict):
        line = json.dumps(obj, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def chrome_trace(path: str, registry: Optional[Registry] = None) -> dict:
    """Write a chrome://tracing JSON merging profiler host ranges, the
    registry's metric marks (counter events), and kept-trace spans from
    ``telemetry.tracing``; returns the trace dict.

    All sources share the ``perf_counter_ns`` timebase and are rebased to
    one origin = the earliest timestamp seen — never negative.  Threads
    observed by the profiler or on kept spans get ``ph:"M"``
    ``thread_name`` metadata so the committer / batcher / replica-worker
    rows are readable in the viewer.
    """
    from .. import profiler as _profiler  # lazy: keep import graph acyclic
    from . import tracing as _tracing

    events, start_wall_ns = _profiler.snapshot_events()
    marks = registry.marks() if registry is not None else []

    stamps = [start_wall_ns]
    stamps += [t0 for (_n, _p, t0, _t1, _tid) in events]
    stamps += [t for (t, _n, _k, _v) in marks]
    span_t0 = _tracing.min_t0_ns()
    if span_t0 is not None:
        stamps.append(span_t0)
    base = min(stamps)

    pid = os.getpid()
    trace_events = []
    for name, parent, t0, t1, tid in events:
        trace_events.append({
            "name": name, "cat": "host", "ph": "X",
            "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
            "pid": pid, "tid": tid,
            "args": {"parent": parent},
        })
    for t, name, key, value in marks:
        args_key = ",".join(f"{k}={v}" for k, v in key) or name
        trace_events.append({
            "name": name, "cat": "telemetry", "ph": "C",
            "ts": (t - base) / 1e3, "pid": pid, "tid": 0,
            "args": {args_key: value},
        })
    trace_events += _tracing.chrome_events(base)

    tid_names = {}
    try:
        tid_names.update(_profiler.thread_names())
    except AttributeError:  # pragma: no cover - older profiler
        pass
    tid_names.update(_tracing.thread_names())
    for th in threading.enumerate():   # fallback for still-live threads
        tid_names.setdefault(th.ident, th.name)
    seen_tids = {e["tid"] for e in trace_events}
    for tid in sorted(t for t in seen_tids if t):
        name = tid_names.get(tid)
        if name:
            trace_events.append({
                "name": "thread_name", "ph": "M", "ts": 0,
                "pid": pid, "tid": tid, "args": {"name": name},
            })
    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return trace
