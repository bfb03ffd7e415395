"""paddle_tpu_torch.monitor — named int gauges over the telemetry registry.

Port of ``paddle_tpu/monitor.py`` (reference platform/monitor.h:44
``StatValue``: thread-safe named gauges with add/sub/set/reset in a global
registry). Every ``StatValue`` stores through the telemetry ``Gauge`` of
the same name in the CURRENT default registry (looked up per operation,
so a ``telemetry.scope(fresh=True)`` swap is seen at once), so monitor
stats appear in ``telemetry.prometheus_text()`` with one source of truth.
"""
from __future__ import annotations

import threading
from typing import Dict

from . import telemetry as _telemetry

__all__ = ["StatValue", "stat", "get_all_stats", "reset_all_stats"]

_registry: Dict[str, "StatValue"] = {}
_reg_lock = threading.Lock()


class StatValue:
    """reference: platform/monitor.h:44 — an int view over a Gauge."""

    def __init__(self, name: str, value: int = 0):
        self.name = name
        if value:
            self._gauge().set(int(value))

    def _gauge(self):
        return _telemetry.gauge(self.name, "monitor.StatValue bridge")

    def increase(self, n: int = 1) -> int:
        return int(self._gauge().inc(int(n)))

    def decrease(self, n: int = 1) -> int:
        return int(self._gauge().dec(int(n)))

    def set(self, v: int) -> int:
        return int(self._gauge().set(int(v)))

    def reset(self) -> int:
        return self.set(0)

    def get(self) -> int:
        return int(self._gauge().value())

    def __repr__(self):
        return f"StatValue({self.name}={self.get()})"


def stat(name: str) -> StatValue:
    """Get-or-create the gauge named ``name`` (DEFINE_INT_STATUS +
    USE_INT_STAT in one call; monitor.h:154,165)."""
    with _reg_lock:
        sv = _registry.get(name)
        if sv is None:
            sv = _registry[name] = StatValue(name)
        return sv


def get_all_stats() -> Dict[str, int]:
    with _reg_lock:
        return {k: v.get() for k, v in _registry.items()}


def reset_all_stats():
    with _reg_lock:
        for v in _registry.values():
            v.reset()
