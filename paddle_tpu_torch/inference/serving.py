"""Overload-robust inference serving runtime, and decode-native serving
over the paged KV cache.

Port of ``paddle_tpu/inference/serving.py``. The loop is the JAX
package's: bounded admission, continuous batching, a worker thread per
replica, health-driven failover. What changed:

- Executors may return device tensors. :class:`InferenceServer` copies
  outputs to the host; :class:`DecodeServer` copies only the next tokens
  and hands the chunk K/V, still on the card, to ``cache.append``.
- The service-rate EWMA starts from the calibration DB's serving rates
  when one was fitted on this device (``calibration.fit(serving_samples=
  ...)``, ``modeled_wait_source`` ``"calibrated"``), else unseeded, and
  learns from the first batch (``"ewma"``). A request admitted with a
  modeled wait records the pair (modeled, measured wait) under
  ``serving_queue_wait`` in the calibration registry at its first
  dispatch.
- ``InferenceServer.from_config(config, replicas)`` serves a ``jit.save``
  artifact through a ``PredictorPool``; ``predictor_executor`` adapts one
  ``Predictor``. ``shape_observer`` and ``warm_start`` are the executor
  cache's hooks (``inference/executor_cache.py``).

- **Admission control + deadlines**: ``submit`` places a request in a
  bounded queue; it is shed when the queue is full (``queue_full``) or
  when the queue's modeled wait already exceeds its deadline
  (``deadline_infeasible``); a request whose deadline passes while it
  waits is dropped (``deadline_expired_in_queue``). Every shed cause is
  counted in ``serving_requests_shed_total{cause=...}``.
- **Continuous batching**: a batcher thread coalesces compatible requests
  into padded batches whose sizes are bucketed to powers of two, so every
  batch hits one of a closed set of shapes. ``serving_recompiles_total``
  counts first-seen (signature, bucket) pairs and must stop growing after
  warm-up.
- **Replica health + failover**: batches round-robin over healthy
  replicas. Each dispatch arms a per-call deadline; on fire the replica is
  benched, its worker respawned (a stuck device call cannot be
  interrupted), its in-flight requests requeued at the front, and it
  re-enters through jittered-backoff probation. ``serving_io`` and
  ``replica_stall`` faults (``resilience.faults``) make both paths
  testable.
- **Graceful drain**: ``shutdown(drain=True)`` (or the SIGTERM handler)
  stops admitting while accepted work runs to completion: it returns once
  every accepted request is terminal. The reference waits for an empty
  queue and no batch in flight, which holds for a moment while a batch
  passes from the queue to a replica, or a result from its replica to its
  request, so its drain can return before the last answers are delivered.

Accounting invariant: every submitted request terminates in exactly one
of ``completed`` / ``shed`` / ``expired`` / ``failed``.

Predictor serving::

    server = InferenceServer.from_config(config, replicas=2)
    with server:
        out = server.submit([x], deadline_s=0.2).result(timeout=1.0)

Decode serving::

    cache = PagedKVCache(num_pages, page_size, heads, head_dim)   # on the card
    step = make_step_fn(init_decode_model(...), cache)
    server = DecodeServer(step, cache, replicas=2,
                          config=ServingConfig(max_batch=256))
    with server:
        tokens = server.submit_generate(prompt, 32).result(timeout=60)[0]
"""
from __future__ import annotations

import collections
import queue as _queue_mod
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from ..ops.tuner import shape_bucket
from ..resilience import faults
from ..resilience.retry import _backoff
from ..telemetry import tracing as _tracing

__all__ = [
    "InferenceServer", "ServingConfig", "Request",
    "RequestShed", "DeadlineExpired", "ServingError",
    "SHED_CAUSES", "predictor_executor", "DecodeServer",
    "GenerationRequest",
]

# terminal request states (the accounting universe)
PENDING = "pending"
COMPLETED = "completed"
SHED = "shed"
EXPIRED = "expired"
FAILED = "failed"

SHED_CAUSES = ("queue_full", "deadline_infeasible",
               "deadline_expired_in_queue", "draining")


class RequestShed(RuntimeError):
    """The request was rejected by admission control / drain."""

    def __init__(self, cause: str):
        super().__init__(f"request shed: {cause}")
        self.cause = cause


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it could execute."""


class ServingError(RuntimeError):
    """The request failed terminally (executor error past recovery)."""


class Request:
    """One inference request: a list of arrays sharing a leading row
    dim, an optional absolute deadline, and a future-style result."""

    _ids = iter(range(1, 2 ** 62))
    _ids_lock = threading.Lock()

    def __init__(self, inputs: Sequence[np.ndarray],
                 deadline_s: Optional[float] = None,
                 tokens: Optional[int] = None):
        self.inputs = [np.ascontiguousarray(x) for x in inputs]
        if not self.inputs:
            raise ValueError("a request needs at least one input array")
        for x in self.inputs:
            if x.ndim < 1:
                raise ValueError("request inputs must have a leading "
                                 "batch (row) dimension")
        rows = self.inputs[0].shape[0]
        if any(x.shape[0] != rows for x in self.inputs):
            raise ValueError("all request inputs must share the leading "
                             "row dimension")
        with Request._ids_lock:
            self.id = next(Request._ids)
        self.rows = int(rows)
        self.tokens = int(tokens) if tokens is not None else self.rows
        self.arrival = time.monotonic()
        self.deadline = (None if deadline_s is None
                         else self.arrival + float(deadline_s))
        self.state = PENDING
        self.attempts = 0  # dispatches that ended in a failover requeue
        self.cause: Optional[str] = None
        self.outputs: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.t_dispatch: Optional[float] = None  # first dispatch only
        # admission's modeled wait (x admission_safety) at submit time;
        # paired with the measured wait at first dispatch by
        # telemetry.calibration ("serving_queue_wait")
        self.t_predicted_wait: Optional[float] = None
        self.t_done: Optional[float] = None
        # invoked exactly once, after the request reaches ANY terminal
        # state (resource owners — e.g. the KV cache — hook cleanup here
        # so every seal path releases, not just the happy one)
        self.on_terminal: Optional[Callable[["Request"], None]] = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        # tail-sampled tracing (telemetry.tracing): populated only when
        # tracing is enabled — the disabled hot path allocates no spans
        self._trace = None
        self._span_wait = None      # admission -> first dispatch
        self._attempt_span = None   # current dispatch attempt

    def signature(self):
        """Batch-compatibility key: per-row shape + dtype of each input."""
        return tuple((x.shape[1:], x.dtype.str) for x in self.inputs)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)

    def _seal(self, state: str, outputs=None, error=None,
              cause=None) -> bool:
        """Move to a terminal state exactly once (first sealer wins —
        the requeue path and a late result from a wedged replica race)."""
        with self._lock:
            if self.state != PENDING:
                return False
            self.state = state
            self.outputs = outputs
            self.error = error
            self.cause = cause
            self.t_done = time.monotonic()
        if self._trace is not None:
            self._close_trace(state)
        cb = self.on_terminal
        if cb is not None:
            try:
                cb(self)
            except Exception as e:  # noqa: BLE001 - cleanup must not unseal
                import warnings
                warnings.warn(f"request {self.id} on_terminal hook "
                              f"failed: {e!r}", stacklevel=2)
        self._done.set()
        return True

    def _close_trace(self, outcome: str):
        """Run the tail-sampling keep/drop decision for this request's
        trace; any span the seal raced still open is ended with the
        outcome so the trace tree is complete at close."""
        tr = self._trace
        for sp in (self._span_wait, self._attempt_span):
            if sp is not None and not sp._ended:
                sp.end(outcome)
        rel = None if self.deadline is None else self.deadline - self.arrival
        tr.close(outcome, deadline_s=rel, failover=self.attempts > 0,
                 attempts=self.attempts, cause=self.cause)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still pending")
        if self.state == COMPLETED:
            return self.outputs
        if self.state == SHED:
            raise RequestShed(self.cause)
        if self.state == EXPIRED:
            raise DeadlineExpired(
                f"request {self.id} expired ({self.cause})")
        raise ServingError(
            f"request {self.id} failed: {self.error!r}") from self.error

    @property
    def latency(self) -> Optional[float]:
        return (None if self.t_done is None
                else self.t_done - self.arrival)


class ServingConfig:
    """Knobs for :class:`InferenceServer` (defaults sized for tests /
    CPU smoke; production raises queue depth and call timeout)."""

    def __init__(self, max_queue: int = 256, max_batch: int = 8,
                 batch_wait_s: float = 0.002,
                 call_timeout_s: float = 2.0,
                 admission_safety: float = 1.0,
                 probation_base_s: float = 0.05,
                 probation_factor: float = 2.0,
                 probation_max_s: float = 2.0,
                 probation_jitter: float = 0.5,
                 rate_ewma: float = 0.3,
                 default_deadline_s: Optional[float] = None,
                 max_attempts: int = 6,
                 seed: int = 0):
        if max_queue < 1 or max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.batch_wait_s = float(batch_wait_s)
        self.call_timeout_s = float(call_timeout_s)
        self.admission_safety = float(admission_safety)
        self.probation_base_s = float(probation_base_s)
        self.probation_factor = float(probation_factor)
        self.probation_max_s = float(probation_max_s)
        self.probation_jitter = float(probation_jitter)
        self.rate_ewma = float(rate_ewma)
        self.default_deadline_s = default_deadline_s
        self.max_attempts = int(max_attempts)
        self.seed = int(seed)


class _BatchJob:
    """One padded batch in flight on a replica. ``try_finish`` /
    ``try_cancel`` are mutually exclusive: whichever side wins decides
    whether the results are published or the requests requeued."""

    def __init__(self, requests: List[Request], arrays: List[np.ndarray],
                 bucket: int, rows: int, seq: int):
        self.requests = requests
        self.arrays = arrays
        self.bucket = bucket
        self.rows = rows
        self.seq = seq
        self.timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._done = False
        self._cancelled = False

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def try_finish(self) -> bool:
        with self._lock:
            if self._cancelled or self._done:
                return False
            self._done = True
            return True

    def try_cancel(self) -> bool:
        with self._lock:
            if self._done or self._cancelled:
                return False
            self._cancelled = True
            return True


class _Replica:
    """One executor: a callable over padded input arrays, a work queue,
    and a worker thread. Health is probation-based: a strike benches
    the replica for a jittered-backoff interval, then it is optimistically
    re-admitted (a still-wedged replica strikes again, longer)."""

    def __init__(self, idx: int, fn: Callable, server: "InferenceServer"):
        self.idx = idx
        self.fn = fn
        self.server = server
        self.healthy = True
        self.strikes = 0
        self.probation_until = 0.0
        self.generation = 0
        self.lock = threading.Lock()
        self.queue: _queue_mod.Queue = _queue_mod.Queue()
        self.thread: Optional[threading.Thread] = None

    def start(self):
        self._spawn(self.generation, self.queue)

    def _spawn(self, gen: int, q: _queue_mod.Queue):
        self.thread = threading.Thread(
            target=self.server._worker_loop, args=(self, gen, q),
            name=f"serving-replica-{self.idx}-g{gen}", daemon=True)
        self.thread.start()

    def mark_unhealthy(self, reason: str, respawn: bool = False):
        abandoned = None
        with self.lock:
            self.strikes += 1
            self.healthy = False
            delay = _backoff(self.strikes, self.server.cfg.probation_base_s,
                             self.server.cfg.probation_factor,
                             self.server.cfg.probation_max_s,
                             self.server.cfg.probation_jitter,
                             site=f"replica{self.idx}",
                             seed=self.server.cfg.seed)
            self.probation_until = time.monotonic() + delay
            if respawn:
                # the old worker is wedged inside the executor; abandon
                # it together with its queue so a fresh thread serves
                # the replica when probation ends
                abandoned = self.queue
                self.generation += 1
                self.queue = _queue_mod.Queue()
                self._spawn(self.generation, self.queue)
        if abandoned is not None:
            abandoned.put(None)  # stop the old worker if it ever returns
            self.server._abandon_queue(abandoned)
        self.server._count("serving_replica_unhealthy_total", reason=reason)
        self.server._set_healthy_gauge()

    def pending(self) -> int:
        return self.queue.qsize()

    def maybe_readmit(self, now: float) -> bool:
        with self.lock:
            if not self.healthy and now >= self.probation_until:
                self.healthy = True
                self.server._set_healthy_gauge()
            return self.healthy


class InferenceServer:
    """The serving runtime: admission queue -> continuous batcher ->
    replica dispatch. ``model_fns`` is one callable per replica taking
    the padded input arrays and returning the output arrays (leading
    dim = batch)."""

    def __init__(self, model_fns, replicas: Optional[int] = None,
                 config: Optional[ServingConfig] = None):
        if callable(model_fns):
            model_fns = [model_fns] * (replicas or 1)
        model_fns = list(model_fns)
        if not model_fns:
            raise ValueError("need at least one replica")
        self.cfg = config or ServingConfig()
        self.replicas = [_Replica(i, fn, self) for i, fn in
                         enumerate(model_fns)]
        self._cv = threading.Condition()
        self._deque: collections.deque = collections.deque()
        self._inflight: set = set()
        self._inflight_rows = 0
        self._seen_shapes: set = set()
        # executor-cache hook: called with (sig, bucket) whenever a
        # first-seen shape is served, so a persistent cache can record it
        # and prime future replicas (see executor_cache.py)
        self.shape_observer: Optional[Callable[[tuple, int], None]] = None
        self._seq = 0
        self._rr = 0
        self._ewma_rows_per_s: Optional[float] = None
        self._ewma_batch_s: Optional[float] = None
        # EWMA cold start: seed the service rate from the calibration DB
        # when one was fitted, so the first admissions price wait with a
        # measured rate instead of modeling zero wait until the first
        # batch completes. _rate_source ({ewma|calibrated|default}) is
        # surfaced by stats() as modeled_wait_source.
        self._rate_source = "default"
        try:
            from ..telemetry import calibration as _calibration
            seeded = _calibration.serving_rates()
        except Exception:  # pragma: no cover - admission must not crash
            seeded = None
        if seeded is not None:
            self._ewma_rows_per_s, self._ewma_batch_s = seeded
            self._rate_source = "calibrated"
        self._draining = False
        self._stopped = False
        self._started = False
        self._batcher: Optional[threading.Thread] = None
        self._prev_sigterm = None
        # server-owned accounting (mirrored to telemetry when enabled)
        self._clock = threading.Lock()
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.shed_causes: Dict[str, int] = collections.defaultdict(int)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceServer":
        if self._started:
            return self
        self._started = True
        for r in self.replicas:
            r.start()
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="serving-batcher", daemon=True)
        self._batcher.start()
        self._set_healthy_gauge()
        return self

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=not any(exc))

    def warm_start(self, shape_pairs) -> int:
        """Pre-seed the seen-shape set with ``(sig, bucket)`` pairs whose
        executors were already run (primed from the executor cache), so
        serving them does not count as a recompile. Returns the number of
        newly seeded pairs."""
        added = 0
        for sig, bucket in shape_pairs:
            pair = (sig, int(bucket))
            if pair not in self._seen_shapes:
                self._seen_shapes.add(pair)
                added += 1
        return added

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        """Stop the server. With ``drain`` accepted work finishes first
        while new admissions are shed with cause ``draining``."""
        first = not self._draining and not self._stopped
        self._draining = True
        if drain and first:
            # flight-recorder snapshot of the last seconds before drain
            # (no-op unless a dump directory is configured)
            from ..telemetry import flight as _flight
            _flight.dump("drain")
        if drain:
            # done when every accepted request is terminal: a batch on its
            # way from the queue to a replica, or a result on its way from
            # a replica to its request, is in neither the queue nor the
            # in-flight set (the reference's test, which returns early)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if self.accounted():
                    break
                time.sleep(0.005)
        self._stopped = True
        with self._cv:
            self._cv.notify_all()
        for r in self.replicas:
            r.queue.put(None)  # poison
        if self._batcher is not None:
            self._batcher.join(timeout=2.0)
        for r in self.replicas:
            if r.thread is not None:
                r.thread.join(timeout=0.5)
        # anything still queued can no longer run
        with self._cv:
            leftovers = list(self._deque)
            self._deque.clear()
        for req in leftovers:
            self._terminal(req, SHED, cause="draining")

    def install_sigterm_drain(self):
        """SIGTERM -> graceful drain (finish accepted work, reject new
        admissions), chaining any previous handler."""
        self._prev_sigterm = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            self._draining = True
            threading.Thread(target=self.shutdown, name="serving-drain",
                             kwargs={"drain": True}, daemon=True).start()
            prev = self._prev_sigterm
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- admission -----------------------------------------------------------

    def submit(self, inputs: Sequence[np.ndarray],
               deadline_s: Optional[float] = None,
               tokens: Optional[int] = None) -> Request:
        """Admit a request (or shed it — the returned request is then
        already terminal with the shed cause recorded)."""
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        req = Request(inputs, deadline_s=deadline_s, tokens=tokens)
        if _tracing.enabled():
            req._trace = _tracing.start_trace(
                "serving_request", req_id=req.id, rows=req.rows)
            req._span_wait = req._trace.span("admission_wait")
        self._count_only("submitted")
        if self._draining or self._stopped:
            self._terminal(req, SHED, cause="draining")
            return req
        with self._cv:
            wait = self._modeled_wait_locked(req.rows) \
                * self.cfg.admission_safety
            if len(self._deque) >= self.cfg.max_queue:
                cause = "queue_full"
            elif req.deadline is not None and \
                    wait + req.arrival > req.deadline:
                cause = "deadline_infeasible"
            else:
                req.t_predicted_wait = wait
                self._deque.append(req)
                self._gauge("serving_queue_depth", len(self._deque))
                self._cv.notify_all()
                return req
        self._terminal(req, SHED, cause=cause)
        return req

    def _modeled_wait_locked(self, rows: int) -> float:
        """Expected wait for a request of ``rows`` arriving now: queued +
        in-flight rows over the EWMA service rate, plus one batch
        latency. The EWMA is a PER-REPLICA rate (one batch over its own
        execute time), so the drain rate scales with the healthy replica
        count: admission tightens by itself while a replica sits in
        probation. Cold start (no completed batch yet) uses the
        calibration DB's rate when one was fitted (``modeled_wait_source``
        ``"calibrated"``), else models zero wait: admission cannot reject
        what it cannot estimate.
        """
        if self._ewma_rows_per_s is None or self._ewma_rows_per_s <= 0:
            return 0.0
        healthy = max(1, sum(1 for r in self.replicas if r.healthy))
        ahead = sum(r.rows for r in self._deque) + self._inflight_rows
        return (ahead + rows) / (self._ewma_rows_per_s * healthy) \
            + (self._ewma_batch_s or 0.0)

    def modeled_wait(self, rows: int = 1) -> float:
        with self._cv:
            return self._modeled_wait_locked(rows)

    # -- batcher -------------------------------------------------------------

    def _bucket(self, rows: int) -> int:
        return min(shape_bucket(rows, floor=1), self.cfg.max_batch)

    def _batcher_loop(self):
        while True:
            batch = self._form_batch()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    def _pop_expired_locked(self, now: float) -> List[Request]:
        expired = [r for r in self._deque if r.expired(now)]
        if expired:
            for r in expired:
                self._deque.remove(r)
        return expired

    def _form_batch(self) -> Optional[List[Request]]:
        """Pull a head-of-line-compatible group from the queue (waiting
        up to ``batch_wait_s`` to coalesce more rows), dropping expired
        requests. Returns None when the server stops."""
        expired: List[Request] = []
        try:
            with self._cv:
                while not self._deque and not self._stopped:
                    self._cv.wait(0.05)
                if self._stopped:
                    return None
                now = time.monotonic()
                expired.extend(self._pop_expired_locked(now))
                if not self._deque:
                    return []
                first = self._deque[0]
                sig = first.signature()
                batch = [first]
                rows = first.rows
                deadline = now + self.cfg.batch_wait_s
                while rows < self.cfg.max_batch:
                    # take every queued compatible request that fits
                    for r in list(self._deque):
                        if r is first or r in batch:
                            continue
                        if (r.signature() == sig
                                and self._fits(batch, rows, r)):
                            batch.append(r)
                            rows += r.rows
                    remaining = deadline - time.monotonic()
                    if rows >= self.cfg.max_batch or remaining <= 0 \
                            or self._stopped:
                        break
                    self._cv.wait(remaining)
                for r in batch:
                    self._deque.remove(r)
                self._gauge("serving_queue_depth", len(self._deque))
        finally:
            for r in expired:
                self._terminal(r, EXPIRED, cause="deadline_expired_in_queue")
        return batch

    def _dispatch(self, batch: List[Request]):
        now = time.monotonic()
        live = [r for r in batch if not r.expired(now) and not r.done()]
        for r in batch:
            if r not in live:
                self._terminal(r, EXPIRED,
                               cause="deadline_expired_in_queue")
        if not live:
            return
        rows = sum(r.rows for r in live)
        bucket = self._bucket(rows)
        arrays = self._pad_concat(live, bucket)
        sig = live[0].signature()
        if (sig, bucket) not in self._seen_shapes:
            self._seen_shapes.add((sig, bucket))
            self._count("serving_recompiles_total")
            obs = self.shape_observer
            if obs is not None:
                try:
                    obs(sig, bucket)
                except Exception:  # noqa: BLE001
                    pass  # cache bookkeeping must never fail a batch
        replica = self._pick_replica(live)
        if replica is None:
            return  # everyone expired while no replica was healthy
        with self._cv:
            self._seq += 1
            job = _BatchJob(live, arrays, bucket, rows, self._seq)
            self._inflight.add(job)
            self._inflight_rows += rows
        for r in live:
            if r.t_dispatch is None:
                r.t_dispatch = time.monotonic()
                self._observe("serving_queue_wait_seconds",
                              r.t_dispatch - r.arrival)
                if r.t_predicted_wait:
                    # admission's modeled wait against the wait that
                    # happened (recorded whatever the telemetry gate)
                    from ..telemetry import calibration as _calibration
                    _calibration.record("serving_queue_wait",
                                        r.t_predicted_wait,
                                        r.t_dispatch - r.arrival)
            sp = r._span_wait
            if sp is not None and not sp._ended:
                sp.end("ok")
            if r._trace is not None and not r._trace.closed:
                # one span per dispatch attempt — failovers and decode
                # re-entry steps each get their own
                r._attempt_span = r._trace.span(
                    "execute", attempt=r.attempts, replica=replica.idx,
                    generation=replica.generation, batch_seq=job.seq,
                    bucket=bucket, rows=r.rows, phase=self._phase_of(r))
        self._count("serving_batches_total")
        self._gauge("serving_batch_occupancy", rows / float(bucket))
        replica.queue.put(job)

    def _pick_replica(self, live: List[Request]) -> Optional[_Replica]:
        """Round-robin over healthy replicas; unhealthy ones are probed
        out of probation. Blocks while none is available (requests keep
        their deadlines and are shed here if they all expire)."""
        while not self._stopped:
            now = time.monotonic()
            n = len(self.replicas)
            for k in range(n):
                r = self.replicas[(self._rr + k) % n]
                # the pending cap is backpressure: excess work waits in
                # the admission queue (where deadlines apply), not in a
                # replica queue where a slow replica would strand it
                if r.maybe_readmit(now) and r.pending() < 2:
                    self._rr = (self._rr + k + 1) % n
                    return r
            still = [r for r in live if not r.expired(now)]
            if not still:
                for r in live:
                    self._terminal(r, EXPIRED,
                                   cause="deadline_expired_in_queue")
                return None
            # while blocked here the batcher is not forming batches, so
            # reap deadline-expired queue entries in place — an expired
            # request must terminate promptly, not wait for capacity
            with self._cv:
                reap = self._pop_expired_locked(now)
            for r in reap:
                self._terminal(r, EXPIRED, cause="deadline_expired_in_queue")
            time.sleep(0.005)
        return None

    def _fits(self, batch: List[Request], rows: int, r: Request) -> bool:
        """May ``r`` join the forming batch? Base packs by summed rows;
        subclasses add their own capacity axes (token budget + row cap)."""
        return rows + r.rows <= self.cfg.max_batch

    def _phase_of(self, r: Request) -> str:
        """Trace-span phase label for a dispatch of ``r``."""
        return "infer"

    def _pad_concat(self, batch: List[Request], bucket: int) -> List[np.ndarray]:
        n_inputs = len(batch[0].inputs)
        arrays = []
        for i in range(n_inputs):
            cat = np.concatenate([r.inputs[i] for r in batch], axis=0)
            pad = bucket - cat.shape[0]
            if pad > 0:
                # repeat the last row: stays in-domain for token inputs
                cat = np.concatenate(
                    [cat, np.repeat(cat[-1:], pad, axis=0)], axis=0)
            arrays.append(cat)
        return arrays

    # -- replica execution ---------------------------------------------------

    def _worker_loop(self, replica: _Replica, gen: int,
                     q: _queue_mod.Queue):
        while not self._stopped:
            try:
                job = q.get(timeout=0.1)
            except _queue_mod.Empty:
                continue
            if job is None:
                return
            with replica.lock:
                stale = replica.generation != gen
            if stale:
                # abandoned generation: this worker raced the respawn's
                # queue drain and won the get() — requeue, never drop
                if job.try_cancel():
                    if job.timer is not None:
                        job.timer.cancel()
                    self._finish_inflight(job)
                    self._requeue(job.requests)
                continue
            self._execute_on(replica, job)

    def _execute_on(self, replica: _Replica, job: _BatchJob):
        # the per-call deadline measures EXECUTION, not queue time — it
        # is armed here, when the worker picks the job up, so a busy
        # (healthy) replica with queued work is never mistaken for a
        # wedged one
        job.timer = threading.Timer(self.cfg.call_timeout_s,
                                    self._on_call_timeout, (replica, job))
        job.timer.daemon = True
        job.timer.start()
        t0 = time.monotonic()
        try:
            spec = faults.fire_spec("replica_stall", step=job.seq,
                                    site="serving_execute")
            if spec is not None:
                # simulated wedged device call: block until the per-call
                # deadline cancels the job (or the server stops)
                while not (job.cancelled or self._stopped):
                    time.sleep(0.005)
                return
            faults.maybe_raise("serving_io", step=job.seq,
                               site="serving_execute")
            outs = replica.fn(job.arrays)
        except Exception as e:  # noqa: BLE001 - any executor error fails over
            self._on_execute_error(replica, job, e)
            return
        self._on_batch_done(replica, job, outs, time.monotonic() - t0)

    def _on_batch_done(self, replica: _Replica, job: _BatchJob,
                       outs, dt: float):
        if not job.try_finish():
            return  # per-call deadline already fired; requests requeued
        if job.timer is not None:
            job.timer.cancel()
        self._finish_inflight(job)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        outs = [_to_host(o) for o in outs]
        self._observe("serving_execute_seconds", dt)
        # service-rate EWMA feeds the admission wait model
        a = self.cfg.rate_ewma
        rate = job.rows / max(dt, 1e-9)
        with self._cv:
            # a calibrated seed decays into the live EWMA from batch 1
            self._ewma_rows_per_s = rate if self._ewma_rows_per_s is None \
                else a * rate + (1 - a) * self._ewma_rows_per_s
            self._ewma_batch_s = dt if self._ewma_batch_s is None \
                else a * dt + (1 - a) * self._ewma_batch_s
            self._rate_source = "ewma"
        off = 0
        for r in job.requests:
            sl = [o[off:off + r.rows] for o in outs]
            off += r.rows
            sp = r._attempt_span
            if sp is not None and not sp._ended:
                sp.end("ok")
            if r._seal(COMPLETED, outputs=sl):
                self._count_outcome(COMPLETED)
                self._count("serving_tokens_total", n=r.tokens)
                self._observe("serving_e2e_seconds", r.t_done - r.arrival)

    def _on_execute_error(self, replica: _Replica, job: _BatchJob,
                          err: BaseException):
        if not job.try_cancel():
            return
        if job.timer is not None:
            job.timer.cancel()
        self._finish_inflight(job)
        self._count("serving_execute_errors_total",
                    error=type(err).__name__)
        self._count("serving_replica_failover_total")
        self._count_only("failovers")
        replica.mark_unhealthy("io_error")
        self._requeue(job.requests)

    def _on_call_timeout(self, replica: _Replica, job: _BatchJob):
        if not job.try_cancel():
            return
        self._finish_inflight(job)
        self._count("serving_replica_failover_total")
        self._count_only("failovers")
        # the wedged thread cannot be interrupted — bench the replica
        # and serve it with a fresh worker after probation
        replica.mark_unhealthy("stall", respawn=True)
        self._requeue(job.requests)

    def _abandon_queue(self, q: _queue_mod.Queue):
        """Requeue every job still sitting in a dead replica's queue —
        nothing in an abandoned queue may be silently lost."""
        while True:
            try:
                job = q.get_nowait()
            except _queue_mod.Empty:
                return
            if job is None:
                continue
            if job.try_cancel():
                if job.timer is not None:
                    job.timer.cancel()
                self._finish_inflight(job)
                self._requeue(job.requests)

    def _finish_inflight(self, job: _BatchJob):
        with self._cv:
            if job in self._inflight:
                self._inflight.discard(job)
                self._inflight_rows -= job.rows

    def _requeue(self, requests: List[Request]):
        """Return a failed batch's requests to the FRONT of the queue
        (they were already admitted — no re-admission checks), shedding
        the ones whose deadline has meanwhile passed."""
        now = time.monotonic()
        back: List[Request] = []
        for r in requests:
            sp = r._attempt_span
            if sp is not None and not sp._ended:
                sp.end("failover")
            if r.done():
                continue
            if r.expired(now):
                self._terminal(r, EXPIRED,
                               cause="deadline_expired_in_queue")
                continue
            r.attempts += 1
            if r.attempts >= self.cfg.max_attempts:
                # a deadline-less request must still terminate: cap the
                # failover bounces so a poisoned batch cannot circulate
                if r._seal(FAILED, error=ServingError(
                        f"request {r.id} failed after {r.attempts} "
                        f"dispatch attempts")):
                    self._count_outcome(FAILED)
                continue
            back.append(r)
        if not back:
            return
        self._count("serving_requeued_requests_total", n=len(back))
        self._count_only("requeues", n=len(back))
        with self._cv:
            for r in reversed(back):
                self._deque.appendleft(r)
            self._gauge("serving_queue_depth", len(self._deque))
            self._cv.notify_all()

    # -- accounting / telemetry ---------------------------------------------

    def _terminal(self, req: Request, state: str, cause: str):
        if not req._seal(state, cause=cause):
            return
        self._count_outcome(state)
        self._count("serving_requests_shed_total", cause=cause)
        with self._clock:
            self.shed_causes[cause] += 1
        # burn-rate watch: a shed spike is exactly when the rolling-window
        # SLO monitor should look (no-op unless one is installed)
        from ..telemetry import slo as _slo
        _slo.maybe_poll()

    def _count_outcome(self, outcome: str):
        with self._clock:
            self.counts[outcome] += 1
        from .. import telemetry
        if telemetry.enabled():
            telemetry.counter(
                "serving_requests_total",
                "serving requests by terminal outcome").inc(outcome=outcome)

    def _count_only(self, key: str, n: int = 1):
        with self._clock:
            self.counts[key] += n

    def _count(self, name: str, n: float = 1, **labels):
        if name in ("serving_recompiles_total", "serving_batches_total",
                    "serving_tokens_total"):
            with self._clock:
                self.counts[name.replace("serving_", "")
                            .replace("_total", "")] += int(n)
        from .. import telemetry
        if telemetry.enabled():
            telemetry.counter(name, "").inc(n, **labels)

    def _gauge(self, name: str, v: float):
        from .. import telemetry
        if telemetry.enabled():
            telemetry.gauge(name, "").set(v)

    def _observe(self, name: str, v: float):
        from .. import telemetry
        if telemetry.enabled():
            telemetry.histogram(name, "").observe(v)

    def _set_healthy_gauge(self):
        self._gauge("serving_replicas_healthy",
                    sum(1 for r in self.replicas if r.healthy))

    def stats(self) -> Dict[str, object]:
        """Snapshot of the server-owned accounting (independent of the
        telemetry registry so tests and the bench need no scope)."""
        with self._clock:
            counts = dict(self.counts)
            causes = dict(self.shed_causes)
        with self._cv:
            depth = len(self._deque)
            inflight = len(self._inflight)
        return {
            "submitted": counts.get("submitted", 0),
            "completed": counts.get(COMPLETED, 0),
            "shed": counts.get(SHED, 0),
            "expired": counts.get(EXPIRED, 0),
            "failed": counts.get(FAILED, 0),
            "shed_causes": causes,
            "failovers": counts.get("failovers", 0),
            "requeues": counts.get("requeues", 0),
            "batches": counts.get("batches", 0),
            "recompiles": counts.get("recompiles", 0),
            "tokens": counts.get("tokens", 0),
            "queue_depth": depth,
            "inflight_batches": inflight,
            "replicas_healthy": sum(1 for r in self.replicas if r.healthy),
            # where the admission wait model's service rate came from:
            # "ewma" once a batch completed, "calibrated" while running
            # on the calibration DB's seed, "default" cold (models 0 wait)
            "modeled_wait_source": self._rate_source,
        }

    def accounted(self) -> bool:
        """The zero-silent-loss invariant: every submitted request is in
        a terminal bucket."""
        s = self.stats()
        return s["submitted"] == (s["completed"] + s["shed"]
                                  + s["expired"] + s["failed"])

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_config(cls, config, replicas: int = 1,
                    serving: Optional[ServingConfig] = None
                    ) -> "InferenceServer":
        """A server over ``replicas`` Predictors of an inference
        ``Config`` (the pool shares one loaded layer through the
        per-prefix load cache)."""
        from . import PredictorPool
        pool = PredictorPool(config, replicas)
        fns = [predictor_executor(pool.retrieve(i))
               for i in range(replicas)]
        return cls(fns, config=serving)


def predictor_executor(pred) -> Callable:
    """Adapt a ``Predictor`` to the server's executor signature."""

    def fn(arrays: List[np.ndarray]) -> List[np.ndarray]:
        return pred.run(list(arrays))

    return fn


def _to_host(o) -> np.ndarray:
    """An executor output as a host array (device tensors are copied)."""
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    return np.asarray(o)


# ===========================================================================
# decode-native serving: autoregressive generation over the
# paged KV cache, scheduled through the same batcher/admission machinery
# ===========================================================================

class GenerationRequest(Request):
    """One autoregressive generation: prompt in, ``max_new`` greedy
    tokens out (``result()`` -> ``[np.int32 generated tokens]``).

    The SAME object rides the queue for every step of its life — prefill
    chunks, then one-token decode steps — re-entering at the FRONT after
    each completed step so in-flight sequences outrank new admissions.
    ``rows`` is reinterpreted as the tokens the request wants to compute
    in its NEXT step (prefill chunk size, or 1 for decode), which makes
    the base scheduler's row arithmetic — packing, buckets, in-flight
    accounting, the EWMA service rate, the modeled-wait admission model —
    token-denominated without touching it."""

    def __init__(self, prompt_tokens, max_new_tokens: int,
                 deadline_s: Optional[float] = None,
                 eos_token: Optional[int] = None):
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("generation needs a non-empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        super().__init__([np.asarray(prompt, np.int32).reshape(1, -1)],
                         deadline_s=deadline_s,
                         tokens=len(prompt) + int(max_new_tokens))
        self.prompt = prompt
        self.max_new = int(max_new_tokens)
        self.eos_token = None if eos_token is None else int(eos_token)
        self.generated: List[int] = []
        self.seq = None                 # kv_cache.CacheSeq (set at admission)
        self.chunk: List[int] = []      # tokens of the NEXT step

    def signature(self):
        # every generation is batch-compatible with every other: the
        # decode executor consumes the flattened varlen layout
        return ("__generate__",)


class DecodeServer(InferenceServer):
    """Decode-native serving: mixed prefill/decode continuous batching
    over a :class:`~paddle_tpu_torch.inference.kv_cache.PagedKVCache`.

    ``step_fns`` are per-replica executors with the decode contract —
    ``fn([tokens, row_id, positions, valid, tables, ctx_lens, last_idx])
    -> [next_tokens (T,), k_new (L, T, H, D), v_new (L, T, H, D)]``
    where ``next_tokens[t]`` is the greedy next token AT flattened slot
    ``t`` — a plain step consumes its chunk's last slot, a
    speculative-verify chunk consumes every slot at once (see
    ``inference.decode_model.make_step_fn``); ``T`` is the token-budget
    bucket, ``R = min(T, max_batch_rows)`` the row bucket, so the
    compiled-shape set stays closed. The executor only COMPUTES; the
    cache is written here, after ``try_finish`` — a cancelled or wedged
    call can never corrupt cache state, and a requeued step re-runs
    idempotently (greedy decode is deterministic).

    Admission folds cache pressure into the modeled wait: pages the
    prompt + generation will need beyond the free + evictable supply add
    ``pages * page_size / rate`` of wait, so tight caches surface as
    ``deadline_infeasible`` shedding, not mid-decode OOM. Prefix pages
    matched at admission are pinned (ref-counted) until the request
    reaches a terminal state — ``Request.on_terminal`` releases them on
    EVERY seal path, including drain and failover exhaustion.

    ``cfg.max_batch`` is the per-dispatch TOKEN budget (decode steps
    cost 1, prefill chunks up to ``prefill_chunk``)."""

    def __init__(self, step_fns, cache, replicas: Optional[int] = None,
                 config: Optional[ServingConfig] = None,
                 prefill_chunk: int = 32,
                 max_pages_per_seq: Optional[int] = None,
                 max_batch_rows: Optional[int] = None):
        super().__init__(step_fns, replicas=replicas, config=config)
        self.cache = cache
        self.prefill_chunk = max(1, min(int(prefill_chunk),
                                        self.cfg.max_batch))
        self.max_batch_rows = max(1, int(max_batch_rows
                                         or self.cfg.max_batch))
        self.max_pages_per_seq = int(max_pages_per_seq or cache.num_pages)

    # -- admission -----------------------------------------------------------

    def submit(self, *a, **kw):
        raise TypeError("DecodeServer serves generations: use "
                        "submit_generate(prompt_tokens, max_new_tokens)")

    def submit_generate(self, prompt_tokens, max_new_tokens: int,
                        deadline_s: Optional[float] = None,
                        eos_token: Optional[int] = None
                        ) -> GenerationRequest:
        """Admit a generation (or shed it: the returned request is then
        already terminal with the cause recorded). ``eos_token`` seals
        the request early when greedy decode emits it."""
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        req = GenerationRequest(prompt_tokens, max_new_tokens,
                                deadline_s=deadline_s,
                                eos_token=eos_token)
        if _tracing.enabled():
            req._trace = _tracing.start_trace(
                "serving_request", req_id=req.id, kind="generate",
                prompt_tokens=len(req.prompt), max_new=req.max_new)
            req._span_wait = req._trace.span("admission_wait")
        self._count_only("submitted")
        if self._draining or self._stopped:
            self._terminal(req, SHED, cause="draining")
            return req
        total = len(req.prompt) + req.max_new
        if self.cache.pages_needed(total) > self.max_pages_per_seq:
            raise ValueError(
                f"generation spans {self.cache.pages_needed(total)} pages "
                f"> max_pages_per_seq={self.max_pages_per_seq}")
        # ambient span: the cache reports prefix hits / evictions into
        # the admission_wait span without signature changes
        with _tracing.use_span(req._span_wait), self._cv:
            if len(self._deque) >= self.cfg.max_queue:
                cause = "queue_full"
            else:
                # prefix pages the prompt already shares don't need
                # allocating; everything else must fit the pool
                matched, _ = self.cache.match_prefix(req.prompt[:-1])
                needed = self.cache.pages_needed(total) \
                    - matched // self.cache.page_size
                wait = self._decode_wait_locked(req, needed)
                if needed > self.cache.num_pages:
                    cause = "deadline_infeasible"  # can never fit
                elif req.deadline is not None and \
                        wait * self.cfg.admission_safety + req.arrival \
                        > req.deadline:
                    cause = "deadline_infeasible"
                else:
                    req.t_predicted_wait = wait * self.cfg.admission_safety
                    req.seq = self.cache.create(req.prompt[:-1])
                    req.on_terminal = self._release_request
                    self._assign_chunk(req)
                    self._deque.append(req)
                    self._gauge("serving_queue_depth", len(self._deque))
                    self._cv.notify_all()
                    return req
        self._terminal(req, SHED, cause=cause)
        return req

    def _decode_wait_locked(self, req: GenerationRequest,
                            needed_pages: int) -> float:
        """Base modeled wait (token-denominated) plus the cache-pressure
        term: pages short of the free + evictable supply each cost a
        page worth of tokens at the EWMA service rate — eviction keeps
        up with decode, so shortfall is time, not failure."""
        first_chunk = min(self.prefill_chunk,
                          max(1, len(req.prompt) - 1))
        wait = self._modeled_wait_locked(first_chunk)
        if self._ewma_rows_per_s and needed_pages > 0:
            short = needed_pages - (self.cache.free_pages()
                                    + self.cache.evictable_pages())
            if short > 0:
                healthy = max(1, sum(1 for r in self.replicas if r.healthy))
                wait += (short * self.cache.page_size
                         / (self._ewma_rows_per_s * healthy))
        return wait

    def _release_request(self, req: Request):
        # a speculative draft fork may still be pinned if the request
        # seals mid-verify (drain, failover exhaustion, deadline)
        fork = getattr(req, "draft_fork", None)
        if fork is not None:
            self.cache.release(fork)
            req.draft_fork = None
        if getattr(req, "seq", None) is not None:
            self.cache.release(req.seq)

    def _assign_chunk(self, req: GenerationRequest):
        """Point the request at its next step's tokens. Prefill walks
        the prompt from the cache frontier (``seq.length`` — prefix hits
        land past them for free); decode feeds back the last generated
        token. ``rows`` tracks the chunk's token cost for the packer."""
        done = req.seq.length
        if done < len(req.prompt):
            req.chunk = req.prompt[done:done + self.prefill_chunk]
        else:
            req.chunk = [req.generated[-1]]
        req.rows = len(req.chunk)

    # -- batching ------------------------------------------------------------

    def _fits(self, batch: List[Request], rows: int, r: Request) -> bool:
        # token budget AND a row cap (the executor's R dimension)
        return (len(batch) < self.max_batch_rows
                and rows + r.rows <= self.cfg.max_batch)

    def _phase_of(self, r: Request) -> str:
        return ("decode" if r.seq is not None
                and r.seq.length >= len(r.prompt) else "prefill")

    def _pad_concat(self, batch: List[Request],
                    bucket: int) -> List[np.ndarray]:
        """Flattened varlen layout: every request's chunk tokens
        concatenated on one axis of width ``bucket`` (the token bucket),
        plus per-row block tables / context lengths. The row dimension is
        ``min(bucket, max_batch_rows)`` — deterministic in the token
        bucket, so it adds no recompile axis."""
        t_b = bucket
        r_b = min(bucket, self.max_batch_rows)
        tokens = np.zeros(t_b, np.int32)
        row_id = np.zeros(t_b, np.int32)
        positions = np.zeros(t_b, np.int32)
        valid = np.zeros(t_b, np.int32)
        tables = np.zeros((r_b, self.max_pages_per_seq), np.int32)
        ctx_lens = np.zeros(r_b, np.int32)
        last_idx = np.zeros(r_b, np.int32)
        off = 0
        for i, r in enumerate(batch):
            n = len(r.chunk)
            tokens[off:off + n] = r.chunk
            row_id[off:off + n] = i
            positions[off:off + n] = np.arange(
                r.seq.length, r.seq.length + n, dtype=np.int32)
            valid[off:off + n] = 1
            tables[i] = self.cache.block_table(r.seq,
                                               self.max_pages_per_seq)
            ctx_lens[i] = r.seq.length
            last_idx[i] = off + n - 1
            off += n
        return [tokens, row_id, positions, valid, tables, ctx_lens,
                last_idx]

    # -- completion ----------------------------------------------------------

    def _on_batch_done(self, replica: _Replica, job: _BatchJob,
                       outs, dt: float):
        if not job.try_finish():
            return  # per-call deadline fired; the step re-runs elsewhere
        if job.timer is not None:
            job.timer.cancel()
        self._finish_inflight(job)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        # only the next tokens come to the host; the chunk K/V stay where
        # the executor made them (on the card) and go into cache.append
        next_tokens, k_new, v_new = outs
        next_tokens = _to_host(next_tokens)
        self._observe("serving_execute_seconds", dt)
        a = self.cfg.rate_ewma
        rate = job.rows / max(dt, 1e-9)
        with self._cv:
            # a calibrated seed decays into the live EWMA from batch 1
            self._ewma_rows_per_s = rate if self._ewma_rows_per_s is None \
                else a * rate + (1 - a) * self._ewma_rows_per_s
            self._ewma_batch_s = dt if self._ewma_batch_s is None \
                else a * dt + (1 - a) * self._ewma_batch_s
            self._rate_source = "ewma"
        # cache writes + sequence advance happen HERE (post-try_finish):
        # a cancelled job never touched the cache, so its requests re-run
        # the identical step on a survivor
        back: List[Request] = []
        off = 0
        for i, r in enumerate(job.requests):
            n = len(r.chunk)
            sp = r._attempt_span
            try:
                # ambient span: cache append/evict events land on this
                # step's execute span
                with _tracing.use_span(sp):
                    self._advance(r, next_tokens[off:off + n],
                                  k_new[:, off:off + n],
                                  v_new[:, off:off + n], back)
            except Exception as e:  # noqa: BLE001 - CacheOOM et al.
                if r._seal(FAILED, error=e if isinstance(e, ServingError)
                           else ServingError(
                               f"request {r.id} step failed: {e!r}")):
                    self._count_outcome(FAILED)
            if sp is not None and not sp._ended:
                sp.end("ok", tokens=n)
            off += n
        if back:
            with self._cv:
                for r in reversed(back):
                    self._deque.appendleft(r)
                self._gauge("serving_queue_depth", len(self._deque))
                self._cv.notify_all()

    def _commit_chunk(self, r: GenerationRequest, nxt: np.ndarray,
                      k_chunk, v_chunk):
        """Write the chunk's K/V and consume its sampled token(s).
        ``nxt`` is the per-slot next-token slice for this chunk; the
        plain path samples from the last slot only. Speculative serving
        overrides this to accept a draft run from the full slice."""
        self.cache.append(r.seq, r.chunk, k_chunk, v_chunk)
        if r.seq.length >= len(r.prompt):
            # the step's last token was prompt-final or a decode token:
            # its logits sample the next generated token
            r.generated.append(int(nxt[-1]))
            self._count_only("decode_tokens")
            self._count("decode_tokens_total")

    def _advance(self, r: GenerationRequest, nxt: np.ndarray,
                 k_chunk, v_chunk, back: List[Request]):
        """Commit one completed step (``_commit_chunk``), then
        complete / expire / re-enqueue."""
        if r.done():
            return  # sealed while in flight (e.g. drain-expire race)
        self._commit_chunk(r, nxt, k_chunk, v_chunk)
        eos_hit = (r.eos_token is not None and r.generated
                   and r.generated[-1] == r.eos_token)
        if len(r.generated) >= r.max_new or eos_hit:
            if r._seal(COMPLETED,
                       outputs=[np.asarray(r.generated, np.int32)]):
                self._count_outcome(COMPLETED)
                self._count("serving_tokens_total", n=r.tokens)
                self._observe("serving_e2e_seconds",
                              r.t_done - r.arrival)
            return
        if r.expired():
            self._terminal(r, EXPIRED, cause="deadline_expired_in_queue")
            return
        self._assign_chunk(r)
        back.append(r)

    def stats(self) -> Dict[str, object]:
        s = super().stats()
        with self._clock:
            s["decode_tokens"] = self.counts.get("decode_tokens", 0)
        s["kv_cache"] = self.cache.stats()
        return s
