"""Deterministic fault injection for the serving and checkpoint recovery
paths.

Port of ``paddle_tpu/resilience/faults.py``, limited to the kinds whose
instrumentation sites the port has:

==================  ======================================================
kind                effect at the instrumented site
==================  ======================================================
``ckpt_io``         a checkpoint save (``CheckpointManager.save``,
                    ``save_checkpoint``) raises ``IOError`` before the
                    write; recovery is the byte-budgeted retry, then
                    local staging
``ckpt_torn``       the commit after a checkpoint write truncates one data
                    file, skips the manifest and raises
                    ``SimulatedCrash``, a ``kill -9`` mid-save
``serving_io``      the serving replica's batch execute raises ``IOError``;
                    recovery is failover to the surviving replicas
``replica_stall``   the serving replica wedges inside the batch execute
                    like a stuck device call; recovery is the per-call
                    deadline firing and the requests requeuing
==================  ======================================================

A fault is armed with the ``inject`` context manager::

    with faults.inject("replica_stall") as spec:
        ...
    assert spec.fired == 1

``at_step`` fires exactly when the site reports that step; ``prob`` draws
from ``random.Random`` seeded per (seed, call index), so a spec fires at
the same call sites in every run. Each armed fault fires at most ``times``
times. Fired faults count ``resilience_faults_injected_total{kind, site}``.
"""
from __future__ import annotations

import contextlib
import random
import threading
from typing import List, Optional

__all__ = ["KINDS", "SimulatedCrash", "inject", "fires", "fire_spec",
           "maybe_raise", "reset"]

KINDS = ("ckpt_io", "ckpt_torn", "serving_io", "replica_stall")


class SimulatedCrash(RuntimeError):
    """An injected hard crash (a ``kill -9``). Not an OSError, so the retry
    decorator does not absorb it."""


class _Fault:
    def __init__(self, kind: str, at_step: Optional[int], prob: float,
                 seed: int, times: int):
        self.kind = kind
        self.at_step = at_step
        self.prob = prob
        self.seed = seed
        self.remaining = times
        self.calls = 0          # site consultations of this spec
        self.fired = 0

    def should_fire(self, step: Optional[int]) -> bool:
        if self.remaining <= 0:
            return False
        self.calls += 1
        if self.at_step is not None:
            if step is None or step != self.at_step:
                return False
        elif self.prob > 0.0:
            # per-call deterministic draw, independent of global RNG state
            draw = random.Random(self.seed * 1000003 + self.calls).random()
            if draw >= self.prob:
                return False
        # at_step=None, prob=0: fire unconditionally (until times exhausted)
        self.remaining -= 1
        self.fired += 1
        return True


_lock = threading.Lock()
_ACTIVE: List[_Fault] = []


@contextlib.contextmanager
def inject(kind: str, at_step: Optional[int] = None, prob: float = 0.0,
           seed: int = 0, times: int = 1):
    """Arm a fault for the duration of the block; yields the spec so
    callers can assert ``spec.fired``."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
    f = _Fault(kind, at_step, prob, seed, times)
    with _lock:
        _ACTIVE.append(f)
    try:
        yield f
    finally:
        with _lock:
            _ACTIVE.remove(f)


def fire_spec(kind: str, step: Optional[int] = None,
              site: Optional[str] = None) -> Optional[_Fault]:
    """Consult the armed faults at an instrumentation site; returns the
    spec that fired, or None."""
    hit = None
    with _lock:
        # every matching spec is consulted (each keeps its own call index
        # and shot budget); the first that fires is returned
        for f in _ACTIVE:
            if f.kind == kind and f.should_fire(step):
                hit = hit or f
    if hit is not None:
        from .. import telemetry
        if telemetry.enabled():
            telemetry.counter(
                "resilience_faults_injected_total",
                "faults fired by the injection harness").inc(
                    kind=kind, site=site or "unspecified")
    return hit


def fires(kind: str, step: Optional[int] = None,
          site: Optional[str] = None) -> bool:
    """Boolean form of :func:`fire_spec`."""
    return fire_spec(kind, step=step, site=site) is not None


def maybe_raise(kind: str, step: Optional[int] = None, exc=IOError,
                msg: Optional[str] = None, site: Optional[str] = None):
    """``fires`` that raises ``exc`` on a hit."""
    if fires(kind, step=step, site=site):
        raise exc(msg or f"injected fault: {kind}"
                  + (f" at step {step}" if step is not None else ""))


def reset():
    """Disarm everything (test teardown safety net)."""
    with _lock:
        _ACTIVE.clear()
