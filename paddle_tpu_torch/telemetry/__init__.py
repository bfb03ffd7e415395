"""paddle_tpu_torch.telemetry — the metrics registry, its exporters and
the run scope.

Port of ``paddle_tpu/telemetry/__init__.py``: ``enable``/``enabled``
(``is_enabled``), ``get_registry`` and the ``counter``/``gauge``/
``histogram`` accessors; ``prometheus_text`` and ``emit`` (an event into
the run's ``events.jsonl``, a no-op outside ``scope(run_dir)``);
``peak_flops_per_sec``; and the submodules ``export`` (Prometheus text,
the JSONL sink, the merged chrome trace), ``scope`` (one context that
wires registry, profiler and sink together for a run and writes
``metrics.prom``, ``events.jsonl``, ``trace.json`` and
``traces_kept.json``), ``aggregate`` (the per-process merge),
``calibration`` (predicted-vs-measured pairs and the fitted constants),
``tracing``, ``flight`` and ``slo``. Instrumentation sites call
``enabled()`` first (one module-global read) and touch the registry only
when it returns True.

Typical use::

    with paddle_tpu_torch.telemetry.scope("runs/gpt") as tel:
        for batch in loader:
            trainer.train_step(*batch)
    # -> runs/gpt/{events.jsonl, metrics.prom, trace.json, traces_kept.json}

The serving sites record: ``serving_requests_total{outcome}``,
``serving_requests_shed_total{cause}``, ``serving_queue_wait_seconds``,
``serving_execute_seconds``, ``serving_e2e_seconds``,
``serving_batch_occupancy``, ``serving_queue_depth``,
``serving_batches_total``, ``serving_recompiles_total``,
``serving_tokens_total``, ``serving_replica_failover_total``,
``serving_replica_unhealthy_total{reason}``, ``serving_replicas_healthy``,
``serving_requeued_requests_total``, ``serving_execute_errors_total``,
``kv_cache_pages_{total,used}``, ``kv_cache_prefix_hits_total``,
``kv_cache_evictions_total{cause}``, ``decode_tokens_total``,
``spec_*`` (speculative decoding), ``kernel_fallbacks_total{kernel}``,
``resilience_faults_injected_total{kind,site}``, ``spans_recorded_total``,
``traces_kept_total{reason}``, ``flight_dumps_total{reason}`` and
``slo_alerts_total{rule}``. The trainer (``distributed/engine.py``)
records ``step_time_seconds``, ``tokens_per_sec`` and, for its gradient
exchange, ``grad_sync_bytes_total{policy,link,bucket}``,
``grad_sync_compression_x`` and ``grad_sync_residual_norm``. The tuner
records ``kernel_config_resolved_total{kernel,source}``; checkpointing
``checkpoint_save_seconds``, ``checkpoint_restore_seconds``,
``checkpoint_bytes_total{op}``, ``ckpt_step_stall_ms``,
``ckpt_restore_fallbacks_total{reason}`` and
``ckpt_retry_bytes_abandoned_total``; retries ``retries_total{site}``,
``retry_exhausted_total{site}`` and ``retry_bytes_abandoned_total{site}``;
calibration ``calibration_drift_ratio{key}``,
``calibration_samples_total{key}`` and
``calibration_drift_breaches_total{key}``.

The JAX package's MFU denominator on a TPU (its peak) is not carried over:
``peak_flops_per_sec`` is ``PADDLE_TPU_TORCH_PEAK_FLOPS``, else the
calibration DB's fitted rate, else a nominal 1e12, as the reference uses
off a TPU.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from .metrics import (Counter, DEFAULT_BUCKETS, Gauge, Histogram,  # noqa: F401
                      Registry)
from .scope import TelemetryScope, scope  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "scope", "TelemetryScope", "aggregate", "tracing", "flight", "slo",
    "calibration", "enable", "disable", "enabled", "is_enabled",
    "get_registry", "counter", "gauge", "histogram", "prometheus_text",
    "emit", "peak_flops_per_sec",
]

_enabled = False
_registry = Registry()
_sink = None  # the active JsonlSink, installed by scope(run_dir=...)


def enable(on: bool = True):
    """Turn the instrumentation sites on (or off with ``enable(False)``)."""
    global _enabled
    _enabled = bool(on)


def disable():
    enable(False)


def enabled() -> bool:
    """The one check every instrumentation site makes per event."""
    return _enabled


is_enabled = enabled


def get_registry() -> Registry:
    return _registry


def _set_registry(reg: Registry):
    global _registry
    _registry = reg


def _set_sink(sink):
    global _sink
    _sink = sink


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return _registry.histogram(name, help, buckets=buckets)


def prometheus_text(registry: Optional[Registry] = None) -> str:
    from .export import prometheus_text as _pt
    return _pt(registry if registry is not None else _registry)


def emit(event: str, **fields):
    """Append an event to the run's JSONL log (a no-op outside
    ``scope(run_dir)``)."""
    s = _sink
    if s is not None:
        s.emit({"event": event, "ts": time.time(), **fields})


from . import aggregate  # noqa: E402,F401
from . import calibration  # noqa: E402,F401
from . import flight  # noqa: E402,F401
from . import slo  # noqa: E402,F401
from . import tracing  # noqa: E402,F401


def peak_flops_per_sec() -> float:
    """The MFU denominator: ``PADDLE_TPU_TORCH_PEAK_FLOPS`` (e.g. the card's
    bf16 peak), else the calibration DB's fitted effective rate for this
    device kind, else a nominal 1e12 FLOP/s so that MFU stays a positive
    number comparable within a run."""
    env = os.environ.get("PADDLE_TPU_TORCH_PEAK_FLOPS")
    if env:
        return float(env)
    fitted = calibration.peak_flops_override()
    if fitted is not None:
        return fitted
    return 1e12
