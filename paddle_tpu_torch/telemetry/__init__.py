"""paddle_tpu_torch.telemetry — the metrics registry and its on/off switch.

Port of the parts of ``paddle_tpu/telemetry/__init__.py`` that serving
and the trainer use: ``enable``/``enabled``, ``get_registry`` and the
``counter``/``gauge``/``histogram`` accessors. Instrumentation sites call
``enabled()`` first (one module-global read) and touch the registry only
when it returns True.

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
``grad_sync_compression_x`` and ``grad_sync_residual_norm``.

The JAX package's MFU denominator (a TPU peak) is deliberately not carried
over: the port states no TPU number as its own.
"""
from __future__ import annotations

from .metrics import (Counter, DEFAULT_BUCKETS, Gauge, Histogram,  # noqa: F401
                      Registry)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "enable", "disable", "enabled", "get_registry", "counter", "gauge",
    "histogram",
]

_enabled = False
_registry = Registry()


def enable(on: bool = True):
    """Turn the instrumentation sites on (or off with ``enable(False)``)."""
    global _enabled
    _enabled = bool(on)


def disable():
    enable(False)


def enabled() -> bool:
    """The one check every instrumentation site makes per event."""
    return _enabled


def get_registry() -> Registry:
    return _registry


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return _registry.histogram(name, help, buckets=buckets)
