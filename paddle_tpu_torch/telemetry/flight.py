"""paddle_tpu_torch.telemetry.flight — always-on flight recorder.

Port of the recorder in ``paddle_tpu/telemetry/flight.py``: a bounded ring
of the most recent completed spans (fed by ``telemetry.tracing`` on every
span end) plus the registry's recent metric marks, dumped to
``flight_<reason>_<step>.json`` when something anomalous happens. Serving
dumps on drain; the SLO monitor dumps on a burn-rate breach.

Dumps land in the directory given to ``configure(out_dir)`` (which
``telemetry.scope(run_dir)`` sets to the run directory) or in
``PADDLE_TPU_FLIGHT_DIR``. Without either, ``dump`` is a no-op returning
None; the ring itself always records.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder", "get_recorder", "configure", "record", "dump",
           "reset"]


def _registry():
    from paddle_tpu_torch import telemetry
    return telemetry.get_registry()


class FlightRecorder:
    """Ring of recent span records + dump-to-JSON on demand."""

    def __init__(self, capacity: int = 2048, marks_tail: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._marks_tail = marks_tail
        self.out_dir: Optional[str] = None
        self.process_index: int = 0
        self.dumps: List[str] = []

    def record(self, span_rec: dict):
        self._ring.append(span_rec)   # deque.append is atomic

    def configure(self, out_dir: Optional[str], process_index: int = 0):
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.process_index = process_index

    def _resolve_dir(self) -> Optional[str]:
        if self.out_dir:
            return self.out_dir
        env = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
        if env:
            os.makedirs(env, exist_ok=True)
            return env
        return None

    def dump(self, reason: str, step: Optional[int] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring + a registry snapshot; returns the path or None
        when no output directory is configured."""
        out_dir = self._resolve_dir()
        if out_dir is None:
            return None
        with self._lock:
            spans = list(self._ring)
        reg = _registry()
        payload = {
            "reason": reason,
            "step": int(step) if step is not None else 0,
            "pid": os.getpid(),
            "process_index": self.process_index,
            "wall_time": time.time(),
            "perf_counter_ns": time.perf_counter_ns(),
            "spans": spans,
            "metrics": reg.to_dict(),
            "marks": [list(m) for m in reg.marks()[-self._marks_tail:]],
        }
        if extra:
            payload["extra"] = extra
        base = f"flight_{reason}_{payload['step']}"
        path = os.path.join(out_dir, base + ".json")
        k = 0
        while os.path.exists(path):  # same reason+step twice / shared dir
            k += 1
            path = os.path.join(out_dir, f"{base}_{os.getpid()}_{k}.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self.dumps.append(path)
        reg.counter("flight_dumps_total").inc(reason=reason)
        return path


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def reset(capacity: int = 2048):
    """Fresh recorder (tests); drops configuration and dump history."""
    global _recorder
    _recorder = FlightRecorder(capacity=capacity)


def configure(out_dir: Optional[str], process_index: int = 0):
    """Where dumps land (``telemetry.scope`` points it at the run directory)
    and the process index each dump records."""
    _recorder.configure(out_dir, process_index=process_index)


def record(span_rec: dict):
    _recorder.record(span_rec)


def dump(reason: str, step: Optional[int] = None,
         extra: Optional[dict] = None) -> Optional[str]:
    return _recorder.dump(reason, step=step, extra=extra)
