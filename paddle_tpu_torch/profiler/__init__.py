"""paddle_tpu_torch.profiler — host event ranges and device tracing.

Port of ``paddle_tpu/profiler/__init__.py``:

- ``RecordEvent`` / ``record_event``: named host ranges that nest on a
  thread-local stack; each records (name, parent path, start, end, thread)
  while the profiler is on and costs nothing while it is off.
- ``start_profiler`` / ``stop_profiler`` / ``reset_profiler`` and the
  ``profiler`` context manager: ``state`` ``"CPU"`` records host ranges
  only; ``"GPU"`` (or ``"TPU"``, the reference's spelling) and ``"All"``
  also trace the card with ``torch.profiler`` (CPU and CUDA activities),
  where the reference starts ``jax.profiler``. While the card is traced,
  every ``RecordEvent`` also opens a ``torch.profiler.record_function`` so
  the range shows in the device trace. The reference swallows a device
  trace that fails to start; here the failure raises, and ``"GPU"``
  without a card raises (``"All"`` without one records host ranges only).
  ``device_profile()`` returns the last device trace (its
  ``key_averages()``); ``stop_profiler`` writes it as
  ``device_trace.json`` under ``trace_dir`` when one was given.
- ``snapshot_events``, ``thread_names``, ``get_events`` and
  ``export_chrome_tracing``: the recorded ranges for exporters
  (``telemetry.export.chrome_trace`` merges them with the metric marks).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

__all__ = [
    "RecordEvent", "record_event", "start_profiler", "stop_profiler",
    "reset_profiler", "profiler", "is_profiler_enabled",
    "export_chrome_tracing", "snapshot_events", "thread_names",
    "get_events", "device_profile",
]

_state = threading.local()
_lock = threading.Lock()
_enabled = False
_events = []          # completed: (name, parent_path, start_ns, end_ns, tid)
_tid_names = {}       # tid -> thread name at record time (export metadata)
_device = None        # the torch.profiler.profile tracing the card, if any
_last_device = None   # the last finished device trace
_trace_dir = None     # where stop_profiler writes the device trace
_start_wall_ns = 0
_session = 0          # bumped by start/stop; pairs RecordEvent begin/end

DEVICE_STATES = ("GPU", "TPU", "All")


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def is_profiler_enabled() -> bool:
    return _enabled


class RecordEvent:
    """Named host range; a context manager or a begin()/end() pair.

    Pair-safe across profiler restarts: ``begin()`` captures the session
    it started in, and ``end()`` records the range only if the same
    session is still on. The nesting stack holds the event objects
    (removed by identity), so an ``end()`` out of LIFO order never pops
    another event's entry."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._scope = None
        self._session = None

    def begin(self):
        if _enabled:
            self._session = _session
            self._t0 = time.perf_counter_ns()
            _stack().append(self)
            if _device is not None:
                import torch
                self._scope = torch.profiler.record_function(self.name)
                self._scope.__enter__()
        return self

    def end(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter_ns()
        stack = _stack()
        try:
            stack.remove(self)
        except ValueError:
            pass  # the stack was cleared by a profiler restart
        if _enabled and self._session == _session:
            parent = "/".join(e.name for e in stack
                              if e._session == _session)
            cur = threading.current_thread()
            with _lock:
                _events.append((self.name, parent, self._t0, t1, cur.ident))
                _tid_names[cur.ident] = cur.name
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None
        self._t0 = None
        self._session = None

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False


@contextlib.contextmanager
def record_event(name: str):
    ev = RecordEvent(name)
    ev.begin()
    try:
        yield ev
    finally:
        ev.end()


def reset_profiler():
    global _events
    with _lock:
        _events = []


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   trace_dir: Optional[str] = None):
    """Start recording host ranges; with ``state`` in :data:`DEVICE_STATES`
    (and ``tracer_option`` not ``"HostOnly"``) also trace the card with
    ``torch.profiler``."""
    global _enabled, _device, _trace_dir, _start_wall_ns, _session
    if state not in ("CPU",) + DEVICE_STATES:
        raise ValueError(f"state must be CPU/GPU/TPU/All, got {state}")
    device = None
    if state in DEVICE_STATES and tracer_option != "HostOnly":
        import torch
        if torch.cuda.is_available():
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            device = torch.profiler.profile(activities=acts)
            device.__enter__()
        elif state != "All":
            raise RuntimeError(f"start_profiler(state={state!r}): no CUDA "
                               "device to trace")
    reset_profiler()
    _session += 1  # invalidate RecordEvents begun before this point
    _start_wall_ns = time.perf_counter_ns()
    _device, _trace_dir = device, trace_dir
    _enabled = True


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None,
                  verbose: bool = True):
    """Stop recording; write the host ranges as chrome-trace JSON to
    ``profile_path`` (default ``profile`` in the temporary directory; ""
    writes nothing), the device trace to ``trace_dir/device_trace.json``
    when ``start_profiler`` was given a ``trace_dir``, and, with
    ``verbose``, print a summary table sorted by ``sorted_key``
    (total/calls/max/min/ave)."""
    global _enabled, _device, _last_device, _trace_dir, _session
    if not _enabled:
        return
    _enabled = False
    _session += 1  # RecordEvents still open do not record into the next run
    if _device is not None:
        prof, _device = _device, None
        prof.__exit__(None, None, None)
        _last_device = prof
        if _trace_dir:
            os.makedirs(_trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(_trace_dir, "device_trace.json"))
    _trace_dir = None
    if profile_path is None:
        profile_path = os.path.join(tempfile.gettempdir(), "profile")
    if profile_path:
        try:
            export_chrome_tracing(profile_path)
        except OSError:
            pass
    if verbose:
        _print_summary(sorted_key)


def device_profile():
    """The last finished ``torch.profiler.profile`` of the card (None if
    the card was never traced)."""
    return _last_device


def _aggregate():
    agg = defaultdict(lambda: [0, 0.0, 0.0, float("inf")])  # calls,total,max,min
    with _lock:
        events = list(_events)
    for name, parent, t0, t1, _tid in events:
        ms = (t1 - t0) / 1e6
        key = f"{parent}/{name}" if parent else name
        a = agg[key]
        a[0] += 1
        a[1] += ms
        a[2] = max(a[2], ms)
        a[3] = min(a[3], ms)
    return agg


def _print_summary(sorted_key):
    agg = _aggregate()
    if not agg:
        return
    rows = [(k, c, tot, tot / c, mx, mn)
            for k, (c, tot, mx, mn) in agg.items()]
    order = {"total": 2, "calls": 1, "ave": 3, "max": 4, "min": 5}
    rows.sort(key=lambda r: r[order.get(sorted_key or "total", 2)],
              reverse=True)
    name_w = max(len(r[0]) for r in rows)
    name_w = max(name_w, len("Event"))
    print(f"{'Event':<{name_w}}  {'Calls':>7} {'Total(ms)':>11} "
          f"{'Avg(ms)':>9} {'Max(ms)':>9} {'Min(ms)':>9}")
    for name, calls, tot, ave, mx, mn in rows:
        print(f"{name:<{name_w}}  {calls:>7} {tot:>11.3f} {ave:>9.3f} "
              f"{mx:>9.3f} {mn:>9.3f}")


def snapshot_events():
    """Raw completed events and the session start, for exporters that
    merge host ranges with other timelines (telemetry.export)."""
    with _lock:
        return list(_events), _start_wall_ns


def thread_names():
    """tid -> thread name observed while recording."""
    with _lock:
        return dict(_tid_names)


def export_chrome_tracing(path: str):
    """Write the completed host ranges as chrome://tracing JSON, rebased to
    the earlier of the session start and the first range's begin (chrome
    drops negative timestamps)."""
    events, start_ns = snapshot_events()
    base = min([start_ns] + [t0 for _n, _p, t0, _t1, _tid in events])
    trace = []
    for name, parent, t0, t1, tid in events:
        trace.append({
            "name": name, "cat": "host", "ph": "X",
            "ts": (t0 - base) / 1e3,
            "dur": (t1 - t0) / 1e3,
            "pid": os.getpid(), "tid": tid,
            "args": {"parent": parent} if parent else {},
        })
    with open(path, "w") as f:
        json.dump({"traceEvents": trace}, f)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None,
             tracer_option: str = "Default"):
    """The ``with profiler(...)`` guard: start, then stop with the
    summary."""
    start_profiler(state, tracer_option=tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key=sorted_key, profile_path=profile_path)


def get_events():
    """Completed host ranges as dicts (tests and tooling)."""
    with _lock:
        return [dict(name=n, parent=p, dur_ms=(t1 - t0) / 1e6, tid=tid)
                for n, p, t0, t1, tid in _events]
