"""``telemetry.scope(run_dir)`` — one context wiring registry + profiler +
JSONL sink together for a run.

Port of ``paddle_tpu/telemetry/scope.py``. On entry: swaps in a fresh
default registry (unless ``fresh=False``), flips the global enabled flag,
starts the host profiler (unless one is already running or
``profile=False``), opens ``run_dir/events.jsonl`` and points the flight
recorder's dumps at ``run_dir``. On exit: writes ``run_dir/metrics.prom``
(Prometheus text), ``run_dir/trace.json`` (host ranges + metric counter
track) and ``run_dir/traces_kept.json`` (when a trace was kept), emits a
final ``summary`` event with the full registry snapshot, and restores
every global it touched. ``run_dir=None`` is legal: metrics are
collected in memory only.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from .metrics import Registry

__all__ = ["scope", "TelemetryScope"]


class TelemetryScope:
    """Handle yielded by ``scope()``: the run's registry + artifact paths."""

    def __init__(self, registry: Registry, run_dir: Optional[str]):
        self.registry = registry
        self.run_dir = run_dir
        self.jsonl_path = os.path.join(run_dir, "events.jsonl") if run_dir else None
        self.prom_path = os.path.join(run_dir, "metrics.prom") if run_dir else None
        self.trace_path = os.path.join(run_dir, "trace.json") if run_dir else None

    def prometheus_text(self) -> str:
        from .export import prometheus_text
        return prometheus_text(self.registry)


@contextlib.contextmanager
def scope(run_dir: Optional[str] = None, fresh: bool = True,
          profile: bool = True, registry: Optional[Registry] = None):
    """Enable telemetry for the duration of the block. See module docstring."""
    from . import (_set_registry, _set_sink, enable, get_registry,
                   is_enabled)
    from .export import JsonlSink, chrome_trace, prometheus_text

    prev_registry = get_registry()
    prev_enabled = is_enabled()
    reg = registry if registry is not None else (
        Registry() if fresh else prev_registry)
    _set_registry(reg)
    enable(True)

    sink = None
    sc = TelemetryScope(reg, str(run_dir) if run_dir else None)
    prev_flight_dir = None
    if sc.run_dir:
        os.makedirs(sc.run_dir, exist_ok=True)
        sink = JsonlSink(sc.jsonl_path)
        _set_sink(sink)
        sink.emit({"event": "scope_start", "ts": time.time(),
                   "run_dir": sc.run_dir})
        reg.marks_enabled = True  # marks feed the chrome counter track
        # flight-recorder dumps land next to the run's other artifacts
        from . import flight
        prev_flight_dir = flight.get_recorder().out_dir
        flight.configure(sc.run_dir,
                         process_index=flight.get_recorder().process_index)

    own_profiler = False
    if profile:
        from .. import profiler as _profiler
        if not _profiler.is_profiler_enabled():
            _profiler.start_profiler("CPU")  # host ranges only; device
            own_profiler = True              # tracing stays opt-in
    try:
        yield sc
    finally:
        try:
            if own_profiler:
                from .. import profiler as _profiler
                _profiler.stop_profiler(profile_path="", verbose=False)
            if sc.run_dir:
                with open(sc.prom_path, "w", encoding="utf-8") as f:
                    f.write(prometheus_text(reg))
                chrome_trace(sc.trace_path, reg)
                from . import tracing
                tracing.write_kept(
                    os.path.join(sc.run_dir, "traces_kept.json"))
                if sink is not None:
                    sink.emit({"event": "summary", "ts": time.time(),
                               "metrics": reg.to_dict()})
        finally:
            reg.marks_enabled = False
            if sc.run_dir:
                from . import flight
                flight.configure(
                    prev_flight_dir,
                    process_index=flight.get_recorder().process_index)
            if sink is not None:
                _set_sink(None)
                sink.close()
            enable(prev_enabled)
            _set_registry(prev_registry)
