"""paddle_tpu_torch.telemetry.slo — rolling-window burn-rate monitoring.

Port of ``paddle_tpu/telemetry/slo.py``. Each rule watches the ratio of
two counter families (summed across label series) over a rolling window
and fires when it crosses a threshold, bumping ``slo_alerts_total{rule}``
and running its alert actions; with none registered the default action
dumps the flight recorder (reason ``slo_<rule>``). A fired rule stays
latched until its burn falls below half the threshold; ``on_clear``
actions run once at that unlatch (a fleet's SLO-driven scale-up pairs
``on_alert(fleet.scale_up_action())`` with them). Action exceptions are
swallowed: monitoring must never take down the monitored.

Serving pokes ``maybe_poll`` on every shed; it is a no-op until a monitor
is installed (``install_shed_rule``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

__all__ = ["SloRule", "SloMonitor", "get_monitor", "set_monitor",
           "maybe_poll", "install_shed_rule", "reset", "default_alert"]


def _registry():
    from paddle_tpu_torch import telemetry
    return telemetry.get_registry()


def _counter_total(reg, family: str) -> float:
    m = reg.get(family)
    if m is None:
        return 0.0
    return float(sum(m.series().values()))


class SloRule:
    """Burn rate = Δnumerator / Δdenominator over ``window_s``."""

    def __init__(self, name: str, numerator: str, denominator: str,
                 threshold: float, window_s: float = 5.0,
                 min_denominator: float = 10.0,
                 on_alert: Optional[Callable] = None):
        self.name = name
        self.numerator = numerator
        self.denominator = denominator
        self.threshold = threshold
        self.window_s = window_s
        self.min_denominator = min_denominator
        self._alert_actions: List[Callable] = []
        self._clear_actions: List[Callable] = []
        if on_alert is not None:
            self._alert_actions.append(on_alert)
        self._samples = deque()   # (t, num_total, den_total)
        self.latched = False
        self.alerts = 0
        self.clears = 0
        self.last_burn = 0.0

    def on_alert(self, fn: Callable) -> Callable:
        """Register ``fn(rule, burn)`` to run when this rule fires (this
        replaces the default flight dump). Works as a decorator."""
        self._alert_actions.append(fn)
        return fn

    def on_clear(self, fn: Callable) -> Callable:
        """Register ``fn(rule, burn)`` to run when a latched rule
        unlatches (burn fell below threshold/2). Works as a decorator."""
        self._clear_actions.append(fn)
        return fn

    def sample(self, now: float, reg) -> Optional[float]:
        """Record a sample; return the burn rate when the rule fires. An
        unlatch bumps ``clears``; ``SloMonitor.poll`` runs the
        ``on_clear`` actions on that edge."""
        num = _counter_total(reg, self.numerator)
        den = _counter_total(reg, self.denominator)
        self._samples.append((now, num, den))
        while self._samples and self._samples[0][0] < now - self.window_s:
            self._samples.popleft()
        _, num0, den0 = self._samples[0]
        d_num, d_den = num - num0, den - den0
        if d_den < self.min_denominator:
            return None
        burn = d_num / d_den if d_den > 0 else 0.0
        self.last_burn = burn
        if self.latched:
            if burn < self.threshold / 2.0:
                self.latched = False
                self.clears += 1
            return None
        if burn > self.threshold:
            self.latched = True
            self.alerts += 1
            return burn
        return None


class SloMonitor:
    def __init__(self, rules: List[SloRule], registry=None,
                 min_poll_interval_s: float = 0.25):
        self.rules = rules
        self._registry = registry
        self.min_poll_interval_s = min_poll_interval_s
        self._lock = threading.Lock()
        self._last_poll = 0.0

    def poll(self, now: Optional[float] = None):
        """Sample every rule; run the actions of rules that fired, and the
        clear actions of rules that unlatched."""
        now = time.monotonic() if now is None else now
        reg = self._registry if self._registry is not None else _registry()
        fired = []
        cleared = []
        with self._lock:
            self._last_poll = now
            for rule in self.rules:
                was_latched = rule.latched
                burn = rule.sample(now, reg)
                if burn is not None:
                    fired.append((rule, burn))
                elif was_latched and not rule.latched:
                    cleared.append((rule, rule.last_burn))
        for rule, burn in fired:
            reg.counter("slo_alerts_total").inc(rule=rule.name)
            for cb in rule._alert_actions or [default_alert]:
                try:
                    cb(rule, burn)
                except Exception:  # noqa: BLE001 - see module docstring
                    pass
        for rule, burn in cleared:
            for cb in rule._clear_actions:
                try:
                    cb(rule, burn)
                except Exception:  # noqa: BLE001 - see module docstring
                    pass
        return fired

    def maybe_poll(self, now: Optional[float] = None):
        """Rate-limited poll for hot-path callers."""
        now = time.monotonic() if now is None else now
        if now - self._last_poll < self.min_poll_interval_s:
            return []
        return self.poll(now)


def default_alert(rule: SloRule, burn: float):
    """The default alert action: a reason-tagged flight dump."""
    from . import flight
    flight.dump(f"slo_{rule.name}",
                extra={"burn_rate": burn, "threshold": rule.threshold,
                       "window_s": rule.window_s})


#: The reference's name for :func:`default_alert`.
_default_alert = default_alert


_monitor: Optional[SloMonitor] = None


def get_monitor() -> Optional[SloMonitor]:
    return _monitor


def set_monitor(monitor: Optional[SloMonitor]):
    global _monitor
    _monitor = monitor


def reset():
    set_monitor(None)


def install_shed_rule(threshold: float = 0.3, window_s: float = 5.0,
                      min_denominator: float = 10.0,
                      on_alert: Optional[Callable] = None) -> SloMonitor:
    """The default serving SLO: ``serving_requests_shed_total /
    serving_requests_total`` over the window."""
    mon = SloMonitor([
        SloRule("shed_burn",
                numerator="serving_requests_shed_total",
                denominator="serving_requests_total",
                threshold=threshold, window_s=window_s,
                min_denominator=min_denominator, on_alert=on_alert),
    ])
    set_monitor(mon)
    return mon


def maybe_poll():
    """Module-level poke used by hot paths; no-op without a monitor."""
    mon = _monitor
    if mon is not None:
        mon.maybe_poll()
