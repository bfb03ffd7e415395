"""Jittered exponential backoff with timeout + telemetry.

Port of ``paddle_tpu/resilience/retry.py``: one decorator applied at the
I/O seams (checkpoint save and restore, ``distributed/checkpoint.py``);
serving sizes a replica's probation with :func:`_backoff`.

Every absorbed failure counts ``retries_total{site=...}``; giving up
counts ``retry_exhausted_total{site=...}`` and re-raises the last error.
Jitter is deterministic per (site, seed, attempt) so tests replay
byte-identical schedules; ``sleep`` is injectable for zero-wall-time
tests.

Byte budget: attempts bounded by wall time alone let a flaky remote fs
re-upload a multi-GB checkpoint every retry.  ``attempt_bytes`` declares
what one attempt moves and ``byte_budget`` caps the total; once the NEXT
attempt would exceed the cap, :class:`RetryBytesExhausted` is raised
(``retry_bytes_abandoned_total{site}``) so the caller can degrade — the
checkpoint layer falls back to local-disk staging instead of re-uploading
(``ckpt_retry_bytes_abandoned_total``).  The first attempt always runs,
whatever the budget.
"""
from __future__ import annotations

import functools
import random
import time
import zlib
from typing import Callable, Optional, Tuple, Type

__all__ = ["retry", "call_with_retry", "RetryBytesExhausted"]


class RetryBytesExhausted(RuntimeError):
    """Retrying was stopped by the byte budget, not by the error going
    away. ``last`` is the final underlying exception; ``bytes_spent``
    what the attempts already moved."""

    def __init__(self, site: str, bytes_spent: float, byte_budget: float,
                 last: Optional[BaseException]):
        super().__init__(
            f"retry[{site}]: next attempt would exceed the byte budget "
            f"({bytes_spent:.0f} of {byte_budget:.0f} bytes already "
            f"spent); last error: {last!r}")
        self.site = site
        self.bytes_spent = bytes_spent
        self.byte_budget = byte_budget
        self.last = last


def _backoff(attempt: int, base_delay: float, factor: float,
             max_delay: float, jitter: float, site: str, seed: int) -> float:
    delay = min(max_delay, base_delay * (factor ** (attempt - 1)))
    if jitter:
        u = random.Random(
            zlib.crc32(f"{site}:{seed}:{attempt}".encode())).random()
        delay *= 1.0 + jitter * u
    return delay


def retry(tries: int = 3, base_delay: float = 0.05, factor: float = 2.0,
          max_delay: float = 2.0, jitter: float = 0.5,
          timeout: Optional[float] = None,
          retry_on: Tuple[Type[BaseException], ...] = (OSError,),
          site: str = "", seed: int = 0,
          sleep: Callable[[float], None] = time.sleep,
          attempt_bytes: Optional[float] = None,
          byte_budget: Optional[float] = None):
    """Decorator: retry ``fn`` on ``retry_on`` with jittered exponential
    backoff, at most ``tries`` attempts, within ``timeout`` seconds of the
    first attempt, and — when ``attempt_bytes``/``byte_budget`` are given
    — within a total moved-bytes budget (the first attempt always runs;
    a retry that would push past the budget raises
    :class:`RetryBytesExhausted` instead of re-running)."""

    def deco(fn):
        label = site or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            deadline = (time.monotonic() + timeout) if timeout else None
            last: Optional[BaseException] = None
            bytes_spent = 0.0
            for attempt in range(1, tries + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:  # noqa: PERF203 - the whole point
                    last = e
                    if attempt_bytes:
                        bytes_spent += attempt_bytes
                    from .. import telemetry
                    tel = telemetry.enabled()
                    if attempt >= tries:
                        break
                    if attempt_bytes and byte_budget is not None and \
                            bytes_spent + attempt_bytes > byte_budget:
                        if tel:
                            telemetry.counter(
                                "retry_bytes_abandoned_total",
                                "retries abandoned by the byte budget, "
                                "by call site"
                            ).inc(site=label)
                        raise RetryBytesExhausted(
                            label, bytes_spent, byte_budget, last) from last
                    delay = _backoff(attempt, base_delay, factor, max_delay,
                                     jitter, label, seed)
                    if deadline is not None and \
                            time.monotonic() + delay > deadline:
                        break
                    if tel:
                        telemetry.counter(
                            "retries_total",
                            "absorbed transient failures, by call site"
                        ).inc(site=label)
                    sleep(delay)
            from .. import telemetry
            if telemetry.enabled():
                telemetry.counter(
                    "retry_exhausted_total",
                    "operations that failed after all retries"
                ).inc(site=label)
            raise last

        return wrapper

    return deco


def call_with_retry(fn, *args, **retry_kwargs):
    """One-shot form: ``call_with_retry(fn, site="ckpt_save", tries=5)``.
    Positional args beyond ``fn`` are passed to ``fn``."""
    return retry(**retry_kwargs)(fn)(*args)
