"""paddle_tpu_torch.inference.fleet — the self-healing serving fleet.

Port of ``paddle_tpu/inference/fleet.py``: serving that survives
membership churn, scales with load and rolls new model versions live,
over the ``InferenceServer``/``DecodeServer`` of ``serving.py``, the
``FileCoordinator`` shared-filesystem membership of
``resilience/elastic.py``, ``CheckpointManager.latest_valid_step()``, the
int8/int4 weight quantizer (``inference.quant``) and the action-bearing
burn-rate rules of ``telemetry/slo.py``:

- **Fleet = N members**, each one whole server built by a
  :class:`ModelGeneration` factory. ``submit`` routes to the member with
  the lowest modeled wait, so admission control stays per member (a
  member in trouble sheds only its own queue). Members advertise
  themselves through heartbeated files under the coordinator root (two
  fleets sharing the root see each other's members); stale files are
  reaped on poll.
- **SLO-driven autoscaling**: ``poll_once`` (or the background control
  thread) scales up on modeled wait or queue depth; a rule armed with
  ``rule.on_alert(fleet.scale_up_action())`` scales up the moment
  shedding crosses its threshold. ``fleet_scale_events_total{direction}``
  counts the moves, ``fleet_replicas`` is the live size. New members
  prime their shapes from the executor cache's manifest, so scale-up pays
  no ``serving_recompiles_total`` cold start.
- **Hot swap with automatic rollback**: a poller watches ``watch_fn``
  (e.g. ``CheckpointManager.latest_valid_step``); a newly committed step
  is published by ``publish_fn`` (typically saved and quantized) and
  **canaried**: a shadow member takes a copy of a fraction of live
  traffic (its results discarded), and its completion rate, failure
  burn, output sanity and latency are judged against the incumbents that
  served the primaries. A failing canary is rolled back: the fleet stays
  on the incumbent generation, whose layer-cache entry is pinned
  (``inference.pin_layer``) so the overwritten artifact cannot poison a
  rebuild, and the step is remembered as rejected. A passing canary is
  promoted by rolling members one at a time through drain, rebuild at
  the new generation, rejoin, keeping ``accounted()`` (zero silent loss)
  fleet-wide: every server ever spawned stays in the accounting.

One deliberate difference: the fleet is idle when no member has work
queued or in flight. The reference also counts a modeled wait above 1 ms
as busy, and a member that served a batch always models at least that
batch's latency, so its fleet of members slower than 1 ms a batch never
scales down.

``FleetConfig``'s defaults are the reference's, sized for the CPU; a
fleet of GPT-base members on the card sets its canary's latency bars and
timeouts for its call (``chip_smoke.py``'s ``serving_tier`` phase).

Typical use::

    gen0 = predictor_generation(0, prefix, quant=("int8", None))
    fleet = ServingFleet(gen0, config=FleetConfig(min_members=2),
                         membership_root=coord.root,
                         watch_fn=manager.latest_valid_step,
                         publish_fn=publish)
    with fleet:
        req = fleet.submit([x], deadline_s=0.2)
"""
from __future__ import annotations

import itertools
import os
import json
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .serving import (COMPLETED, FAILED, InferenceServer, ServingConfig,
                      predictor_executor)

__all__ = ["FleetConfig", "ModelGeneration", "ServingFleet",
           "predictor_generation"]


def _default_sanity(outputs) -> bool:
    """A served result must at least be finite — the cheapest possible
    model-quality gate, and exactly what a bit-rotted / NaN-poisoned
    checkpoint fails."""
    try:
        for o in outputs or []:
            a = np.asarray(o)
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                return False
        return True
    except Exception:
        return False


class ModelGeneration:
    """One deployable model version: an id (checkpoint step), a factory
    for fresh server instances, and the hooks a rollout needs — priming
    (executor cache), layer-cache pin/release, and the canary's output
    sanity check."""

    def __init__(self, gen_id: int, make_server: Callable[[], object],
                 prime: Optional[Callable[[object], int]] = None,
                 pin: Optional[Callable[[], None]] = None,
                 release: Optional[Callable[[], None]] = None,
                 sanity_fn: Optional[Callable] = None,
                 meta: Optional[dict] = None):
        self.gen_id = int(gen_id)
        self._make_server = make_server
        self._prime = prime
        self._pin = pin
        self._release = release
        self.sanity_fn = sanity_fn or _default_sanity
        self.meta = dict(meta or {})
        self._pinned = False

    def build(self) -> object:
        """A fresh UNSTARTED server for this generation; primed (its
        executors run at every recorded shape, then warm_start) when a
        prime hook was provided."""
        server = self._make_server()
        if self._prime is not None:
            try:
                self._prime(server)
            except Exception:
                pass  # priming is an optimization, never a build failure
        return server

    def pin(self):
        if self._pin is not None and not self._pinned:
            self._pin()
            self._pinned = True

    def release(self):
        if self._release is not None and self._pinned:
            self._release()
            self._pinned = False


def predictor_generation(gen_id: int, prefix: str, quant=None,
                         replicas: int = 1,
                         serving: Optional[ServingConfig] = None,
                         executor_cache=None,
                         sanity_fn: Optional[Callable] = None,
                         executor_wrap: Optional[Callable] = None,
                         device: Optional[str] = None
                         ) -> ModelGeneration:
    """Build a :class:`ModelGeneration` over the Predictor path for the
    artifact currently at ``prefix``. The layer-cache key is captured
    NOW and pinned for the generation's lifetime, so a later hot-swap
    overwriting the files cannot change what this generation serves —
    the rollback guarantee. ``device`` is the Config's (None: the card;
    ``"cpu"``: ``disable_gpu()``)."""
    from . import (Config, Predictor, layer_cache_key, pin_layer,
                   unpin_layer)
    key = layer_cache_key(prefix, quant)

    def make_server():
        cfg = Config(prefix)
        cfg._device = device
        if quant is not None:
            cfg.enable_weight_quantize(*quant)
        preds = [Predictor(cfg, layer_key=key) for _ in range(replicas)]
        fns = [predictor_executor(p) for p in preds]
        if executor_wrap is not None:
            # e.g. a fixed service pad making capacity machine-independent
            fns = [executor_wrap(fn) for fn in fns]
        server = InferenceServer(fns, config=serving)
        if executor_cache is not None:
            from . import executor_cache as ec
            akey = ec.artifact_key(prefix, quant)
            ec.prime(server, akey, executor_cache)
            ec.attach(server, akey, executor_cache)
        return server

    gen = ModelGeneration(gen_id, make_server,
                          pin=lambda: pin_layer(key),
                          release=lambda: unpin_layer(key),
                          sanity_fn=sanity_fn,
                          meta={"prefix": prefix, "quant": quant,
                                "layer_key": key})
    gen.pin()
    return gen


class FleetConfig:
    """Knobs for :class:`ServingFleet` (the reference's defaults, sized
    for tests on the CPU)."""

    def __init__(self,
                 min_members: int = 1,
                 max_members: int = 4,
                 scale_up_wait_s: float = 0.5,
                 scale_up_queue_depth: int = 32,
                 scale_down_idle_s: float = 10.0,
                 cooldown_s: float = 2.0,
                 poll_interval_s: float = 0.25,
                 member_stale_after_s: float = 10.0,
                 canary_shadow_fraction: float = 0.2,
                 canary_min_shadow: int = 8,
                 canary_timeout_s: float = 30.0,
                 canary_min_completion_frac: float = 0.5,
                 canary_max_failure_frac: float = 0.2,
                 canary_latency_factor: float = 3.0,
                 canary_latency_slack_s: float = 0.05,
                 drain_timeout_s: float = 30.0,
                 seed: int = 0):
        if min_members < 1 or max_members < min_members:
            raise ValueError("need 1 <= min_members <= max_members")
        self.min_members = int(min_members)
        self.max_members = int(max_members)
        self.scale_up_wait_s = float(scale_up_wait_s)
        self.scale_up_queue_depth = int(scale_up_queue_depth)
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.cooldown_s = float(cooldown_s)
        self.poll_interval_s = float(poll_interval_s)
        self.member_stale_after_s = float(member_stale_after_s)
        self.canary_shadow_fraction = float(canary_shadow_fraction)
        self.canary_min_shadow = int(canary_min_shadow)
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_min_completion_frac = float(canary_min_completion_frac)
        self.canary_max_failure_frac = float(canary_max_failure_frac)
        self.canary_latency_factor = float(canary_latency_factor)
        self.canary_latency_slack_s = float(canary_latency_slack_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.seed = int(seed)


class _Member:
    """One fleet member: a whole server instance at some generation."""

    _ids = itertools.count(0)

    def __init__(self, server, generation: ModelGeneration):
        self.idx = next(_Member._ids)
        self.server = server
        self.generation = generation
        self.active = False          # taking fleet traffic
        self.name = f"m{self.idx}"


class _Canary:
    """Bookkeeping for an in-flight canary rollout: the shadow member
    plus the (primary, shadow) request pairs used for the verdict."""

    def __init__(self, member: _Member, generation: ModelGeneration):
        self.member = member
        self.generation = generation
        self.pairs: List[tuple] = []   # (primary Request, shadow Request)
        self.lock = threading.Lock()


class ServingFleet:
    """N serving members + autoscaler + hot-swap canary controller.

    ``generation`` is the initial :class:`ModelGeneration`; ``watch_fn``
    (e.g. ``CheckpointManager.latest_valid_step``) and ``publish_fn``
    (step -> ModelGeneration, typically quantizing via
    ``inference.quant``) enable the hot-swap poller. All control actions
    run through :meth:`poll_once` — call it directly for deterministic
    tests, or ``start(control=True)`` for the background thread.
    """

    def __init__(self, generation: ModelGeneration,
                 config: Optional[FleetConfig] = None,
                 membership_root: Optional[str] = None,
                 fleet_id: str = "serving",
                 host: Optional[str] = None,
                 watch_fn: Optional[Callable[[], Optional[int]]] = None,
                 publish_fn: Optional[Callable[[int], ModelGeneration]]
                 = None):
        self.cfg = config or FleetConfig()
        self.generation = generation
        self.fleet_id = fleet_id
        self.host = host or f"pid-{os.getpid()}"
        self._watch_fn = watch_fn
        self._publish_fn = publish_fn
        self._members: List[_Member] = []
        self._all_servers: List[object] = []   # every server ever, for
        #                                        fleet-wide accounted()
        self._canary: Optional[_Canary] = None
        self._rejected_steps: set = set()
        self._lock = threading.RLock()
        self._rng = random.Random(self.cfg.seed)
        self._started = False
        self._stopped = False
        self._draining = False
        self._last_scale = 0.0
        self._idle_since: Optional[float] = None
        self._control: Optional[threading.Thread] = None
        self._prev_sigterm = None
        self._shutdowns = 0
        self.last_canary_checks: Optional[dict] = None
        # fleet-owned control-plane accounting (mirrors telemetry)
        self.counts: Dict[str, int] = {
            "scale_up": 0, "scale_down": 0, "promoted": 0,
            "rolled_back": 0, "canary_checks": 0, "hot_swap_polls": 0}
        self._members_dir = None
        if membership_root is not None:
            self._members_dir = os.path.join(membership_root, "members",
                                             fleet_id)
            os.makedirs(self._members_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self, control: bool = False) -> "ServingFleet":
        if self._started:
            return self
        self._started = True
        with self._lock:
            while len(self._members) < self.cfg.min_members:
                self._add_member_locked(reason="bootstrap", count=False)
        self._heartbeat()
        self._set_replica_gauge()
        if control:
            self._control = threading.Thread(
                target=self._control_loop, name="fleet-control", daemon=True)
            self._control.start()
        return self

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=not any(exc))

    def shutdown(self, drain: bool = True):
        """Drain every member (and any canary) exactly once; the fleet
        admits nothing afterwards."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._draining = True
            members = list(self._members)
            canary = self._canary
            self._shutdowns += 1
        for m in members:
            m.active = False
            m.server.shutdown(drain=drain,
                              timeout=self.cfg.drain_timeout_s)
        if canary is not None:
            canary.member.server.shutdown(
                drain=drain, timeout=self.cfg.drain_timeout_s)
        if self._control is not None:
            self._control.join(timeout=2.0)
        self._remove_member_files()
        self._set_replica_gauge()

    def install_sigterm_drain(self):
        """SIGTERM -> one graceful fleet-wide drain (every member exactly
        once), chaining any previous handler — the fleet analogue of
        ``InferenceServer.install_sigterm_drain``."""
        import signal
        self._prev_sigterm = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            self._draining = True
            threading.Thread(target=self.shutdown, name="fleet-drain",
                             kwargs={"drain": True}, daemon=True).start()
            prev = self._prev_sigterm
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- membership ----------------------------------------------------------

    def _member_file(self, member: _Member) -> Optional[str]:
        if self._members_dir is None:
            return None
        return os.path.join(self._members_dir,
                            f"{self.host}-{member.name}.json")

    def _heartbeat(self):
        """Advertise every active member under the coordinator root
        (atomic replace, the FileCoordinator write discipline)."""
        if self._members_dir is None:
            return
        with self._lock:
            members = [m for m in self._members if m.active]
        for m in members:
            path = self._member_file(m)
            tmp = path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"host": self.host, "member": m.name,
                               "generation": m.generation.gen_id,
                               "t": time.time()}, f)
                os.replace(tmp, path)
            except OSError:
                pass   # shared FS hiccup; next heartbeat retries

    def _remove_member_files(self):
        if self._members_dir is None:
            return
        for m in self._members:
            path = self._member_file(m)
            try:
                os.remove(path)
            except OSError:
                pass

    def live_members(self) -> List[dict]:
        """Cluster-wide membership view: every non-stale member file
        under the root (includes members other fleets/hosts advertise)."""
        if self._members_dir is None:
            with self._lock:
                return [{"host": self.host, "member": m.name,
                         "generation": m.generation.gen_id}
                        for m in self._members if m.active]
        out = []
        now = time.time()
        try:
            names = os.listdir(self._members_dir)
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            full = os.path.join(self._members_dir, fn)
            try:
                mtime = os.path.getmtime(full)
                with open(full) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue   # mid-replace: next poll sees it
            if now - mtime > self.cfg.member_stale_after_s:
                continue
            out.append(payload)
        return out

    def reap_stale_members(self) -> int:
        """Remove member files whose heartbeat went stale (a fleet that
        died without shutdown); returns the number reaped."""
        if self._members_dir is None:
            return 0
        reaped = 0
        now = time.time()
        try:
            names = os.listdir(self._members_dir)
        except OSError:
            return 0
        for fn in names:
            if not fn.endswith(".json"):
                continue
            full = os.path.join(self._members_dir, fn)
            try:
                if now - os.path.getmtime(full) \
                        > self.cfg.member_stale_after_s:
                    os.remove(full)
                    reaped += 1
            except OSError:
                continue
        return reaped

    def _add_member_locked(self, reason: str, count: bool = True,
                           generation: Optional[ModelGeneration] = None
                           ) -> _Member:
        gen = generation or self.generation
        member = _Member(gen.build(), gen)
        member.server.start()
        self._members.append(member)
        self._all_servers.append(member.server)
        member.active = True
        if count:
            self.counts["scale_up"] += 1
            self._count("fleet_scale_events_total", direction="up",
                        reason=reason)
        self._last_scale = time.monotonic()
        return member

    def _retire_member(self, member: _Member, direction: str, reason: str):
        member.active = False
        path = self._member_file(member)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass
        member.server.shutdown(drain=True,
                               timeout=self.cfg.drain_timeout_s)
        with self._lock:
            if member in self._members:
                self._members.remove(member)
            if direction == "down":
                self.counts["scale_down"] += 1
                self._count("fleet_scale_events_total", direction="down",
                            reason=reason)
            self._last_scale = time.monotonic()
        self._set_replica_gauge()

    # -- traffic -------------------------------------------------------------

    def _pick_member(self, include_inactive: bool = False) -> _Member:
        with self._lock:
            members = [m for m in self._members if m.active]
            if not members and include_inactive:
                # draining/stopped: any member will shed the admission
                # with cause "draining", which keeps accounting closed
                members = list(self._members)
        if not members:
            raise RuntimeError("fleet has no active members")
        return min(members, key=lambda m: m.server.modeled_wait())

    def _maybe_shadow(self, kind: str, args: tuple, kwargs: dict,
                      primary):
        """Mirror a fraction of live traffic onto the canary member;
        shadow results are never returned to callers, only judged."""
        with self._lock:
            canary = self._canary
            if canary is None or self._stopped:
                return
            if self._rng.random() >= self.cfg.canary_shadow_fraction:
                return
        try:
            if kind == "generate":
                shadow = canary.member.server.submit_generate(
                    *args, **kwargs)
            else:
                shadow = canary.member.server.submit(*args, **kwargs)
        except Exception:
            return   # a canary that cannot even admit fails the verdict
        #              via its completion fraction, not the caller
        with canary.lock:
            canary.pairs.append((primary, shadow))

    def submit(self, inputs: Sequence[np.ndarray],
               deadline_s: Optional[float] = None,
               tokens: Optional[int] = None):
        """Admit one request to the least-loaded member (and possibly a
        shadow copy to the canary)."""
        if self._draining or self._stopped:
            member = self._pick_member(include_inactive=True)
            return member.server.submit(inputs, deadline_s=deadline_s,
                                        tokens=tokens)
        member = self._pick_member()
        req = member.server.submit(inputs, deadline_s=deadline_s,
                                   tokens=tokens)
        self._maybe_shadow(
            "infer",
            ([np.copy(x) for x in inputs],),
            {"deadline_s": deadline_s, "tokens": tokens}, req)
        return req

    def submit_generate(self, prompt_tokens, max_new_tokens: int,
                        deadline_s: Optional[float] = None,
                        eos_token: Optional[int] = None):
        """Decode-fleet admission (members must be DecodeServers)."""
        member = self._pick_member()
        req = member.server.submit_generate(
            prompt_tokens, max_new_tokens, deadline_s=deadline_s,
            eos_token=eos_token)
        if not (self._draining or self._stopped):
            self._maybe_shadow(
                "generate", (list(prompt_tokens), max_new_tokens),
                {"deadline_s": deadline_s, "eos_token": eos_token}, req)
        return req

    def modeled_wait(self, rows: int = 1) -> float:
        with self._lock:
            members = [m for m in self._members if m.active]
        if not members:
            return float("inf")
        return min(m.server.modeled_wait(rows) for m in members)

    # -- autoscaling ---------------------------------------------------------

    def scale_up_action(self) -> Callable:
        """An ``SloRule.on_alert`` action: burn-rate breach -> scale up.

        ::

            rule.on_alert(fleet.scale_up_action())
        """

        def _action(rule, burn):
            self.request_scale_up(reason=f"slo_{rule.name}")

        return _action

    def request_scale_up(self, reason: str = "manual") -> bool:
        """Add a member now (SLO actions and operators call this); false
        when at max_members or stopped. Deliberately ignores the
        cooldown — an SLO breach IS the arbiter."""
        with self._lock:
            if self._stopped or self._draining:
                return False
            if sum(1 for m in self._members if m.active) \
                    >= self.cfg.max_members:
                return False
            self._add_member_locked(reason=reason)
        self._heartbeat()
        self._set_replica_gauge()
        return True

    def _autoscale(self, now: float):
        with self._lock:
            members = [m for m in self._members if m.active]
            n = len(members)
            if not members or self._stopped or self._draining:
                return
            in_cooldown = now - self._last_scale < self.cfg.cooldown_s
            stats = [m.server.stats() for m in members]
            depth = sum(st["queue_depth"] for st in stats)
            wait = min(m.server.modeled_wait() for m in members)
            # idle = nothing queued and nothing in flight. The reference
            # reads busy from wait > 1 ms, but a served member's modeled
            # wait never falls below one batch's latency, so once every
            # member has served a batch slower than 1 ms it never idles
            busy = depth > 0 or any(st["inflight_batches"] for st in stats)
            if busy:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            if in_cooldown:
                return
            if n < self.cfg.max_members and (
                    wait > self.cfg.scale_up_wait_s
                    or depth > self.cfg.scale_up_queue_depth):
                reason = ("modeled_wait" if wait > self.cfg.scale_up_wait_s
                          else "queue_depth")
                self._add_member_locked(reason=reason)
                self._set_replica_gauge()
                return
            idle_long = (self._idle_since is not None and
                         now - self._idle_since
                         >= self.cfg.scale_down_idle_s)
            victim = None
            if n > self.cfg.min_members and idle_long:
                victim = members[-1]
        if victim is not None:
            self._retire_member(victim, direction="down", reason="idle")

    # -- hot swap ------------------------------------------------------------

    def _maybe_hot_swap(self):
        if self._watch_fn is None or self._publish_fn is None:
            return
        if self._canary is not None or self._stopped or self._draining:
            return
        self.counts["hot_swap_polls"] += 1
        try:
            step = self._watch_fn()
        except Exception:
            return
        if step is None:
            return
        step = int(step)
        if step <= self.generation.gen_id or step in self._rejected_steps:
            return
        try:
            gen = self._publish_fn(step)
        except Exception:
            # a checkpoint that cannot even be published is rejected the
            # same way a failing canary is — don't retry it every poll
            self._rejected_steps.add(step)
            self._count("hot_swap_total", outcome="rolled_back")
            self.counts["rolled_back"] += 1
            return
        self.hot_swap(gen)

    def hot_swap(self, generation: ModelGeneration) -> bool:
        """Canary ``generation`` against live traffic; promote it to
        every member on pass, roll it back on fail. Returns promotion."""
        generation.pin()
        self.generation.pin()   # the rollback target must stay loadable
        canary_member = _Member(generation.build(), generation)
        canary_member.server.start()
        with self._lock:
            self._all_servers.append(canary_member.server)
            self._canary = _Canary(canary_member, generation)
        healthy, checks = self._canary_verdict(self._canary)
        self.counts["canary_checks"] += 1
        self._count("canary_health_checks_total",
                    outcome="pass" if healthy else "fail")
        with self._lock:
            canary = self._canary
            self._canary = None   # stop shadowing before the rollout
        if not healthy:
            self._rejected_steps.add(generation.gen_id)
            canary.member.server.shutdown(
                drain=True, timeout=self.cfg.drain_timeout_s)
            generation.release()
            self.counts["rolled_back"] += 1
            self._count("hot_swap_total", outcome="rolled_back")
            self.last_canary_checks = checks
            return False
        # promote: the canary already serves the new generation — adopt
        # it as a member, then roll the incumbents one at a time,
        # rebuilding each at the new generation so capacity is preserved
        # through the rollout (the adopted canary covers the first)
        old_gen = self.generation
        with self._lock:
            self.generation = generation
            incumbents = [m for m in self._members
                          if m.active and m.generation is old_gen]
            target = len([m for m in self._members if m.active])
            canary.member.active = True
            self._members.append(canary.member)
        for m in incumbents:
            # one-at-a-time: drain this member out of rotation while the
            # rest of the fleet (including the adopted canary) serves
            self._retire_member(m, direction="roll", reason="hot_swap")
            with self._lock:
                if len([x for x in self._members if x.active]) < target:
                    self._add_member_locked(reason="hot_swap", count=False,
                                            generation=generation)
        old_gen.release()
        self.counts["promoted"] += 1
        self._count("hot_swap_total", outcome="promoted")
        self._heartbeat()
        self._set_replica_gauge()
        self.last_canary_checks = checks
        return True

    def _canary_verdict(self, canary: _Canary):
        """Judge the canary on its shadow traffic: enough samples,
        completion fraction, failure burn, output sanity, and latency
        against the incumbent primaries of the SAME requests."""
        cfg = self.cfg
        deadline = time.monotonic() + cfg.canary_timeout_s
        while time.monotonic() < deadline:
            with canary.lock:
                done = sum(1 for _, s in canary.pairs if s.done())
            if done >= cfg.canary_min_shadow:
                break
            if self._stopped:
                break
            time.sleep(0.01)
        with canary.lock:
            pairs = list(canary.pairs)
        done = [(p, s) for p, s in pairs if s.done()]
        completed = [(p, s) for p, s in done if s.state == COMPLETED]
        failed = [s for _, s in done if s.state == FAILED]
        sanity_fn = canary.generation.sanity_fn
        insane = sum(1 for _, s in completed
                     if not sanity_fn(s.outputs))
        checks = {
            "enough_shadow": len(done) >= cfg.canary_min_shadow,
            "completion": (len(done) > 0 and
                           len(completed) >= cfg.canary_min_completion_frac
                           * len(done)),
            "failure_burn": len(failed) <= cfg.canary_max_failure_frac
            * max(1, len(done)),
            "sanity": insane == 0,
        }
        # latency: the primaries of the shadowed pairs are the incumbent
        # baseline for the very same traffic
        base = [p.latency for p, _ in completed
                if p.done() and p.state == COMPLETED
                and p.latency is not None]
        shad = [s.latency for _, s in completed if s.latency is not None]
        if base and shad:
            checks["latency"] = (
                float(np.median(shad)) <= cfg.canary_latency_factor
                * float(np.median(base)) + cfg.canary_latency_slack_s)
        else:
            checks["latency"] = True
        checks["shadow_count"] = len(done)
        checks["insane_outputs"] = insane
        healthy = all(v for k, v in checks.items()
                      if isinstance(v, bool))
        return healthy, checks

    # -- control loop --------------------------------------------------------

    def poll_once(self, now: Optional[float] = None):
        """One control-plane tick: heartbeat + reap + autoscale + the
        hot-swap poller. Deterministic entry point for tests/tools."""
        now = time.monotonic() if now is None else now
        self._heartbeat()
        self.reap_stale_members()
        self._autoscale(now)
        self._maybe_hot_swap()
        self._set_replica_gauge()

    def _control_loop(self):
        while not self._stopped:
            try:
                self.poll_once()
            except Exception:
                pass   # the control plane must never kill serving
            time.sleep(self.cfg.poll_interval_s)

    # -- accounting / telemetry ----------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Fleet-wide aggregate over every server EVER owned (retired
        generations and rolled-back canaries included), plus control-
        plane counters."""
        with self._lock:
            servers = list(self._all_servers)
            members = [m for m in self._members if m.active]
            counts = dict(self.counts)
            gen_id = self.generation.gen_id
        agg = {k: 0 for k in ("submitted", "completed", "shed", "expired",
                              "failed", "failovers", "requeues", "batches",
                              "recompiles", "queue_depth")}
        shed_causes: Dict[str, int] = {}
        for s in servers:
            st = s.stats()
            for k in agg:
                agg[k] += int(st.get(k, 0))
            for cause, n in st.get("shed_causes", {}).items():
                shed_causes[cause] = shed_causes.get(cause, 0) + int(n)
        agg.update({
            "shed_causes": shed_causes,
            "members": len(members),
            "servers_ever": len(servers),
            "generation": gen_id,
            "member_generations": sorted(m.generation.gen_id
                                         for m in members),
            "scale_ups": counts["scale_up"],
            "scale_downs": counts["scale_down"],
            "promoted": counts["promoted"],
            "rolled_back": counts["rolled_back"],
            "canary_checks": counts["canary_checks"],
        })
        return agg

    def accounted(self) -> bool:
        """Zero silent loss, fleet-wide: every request ever submitted to
        ANY server this fleet spawned — members, rolled generations,
        rolled-back canaries, shadow copies — is in a terminal bucket."""
        with self._lock:
            servers = list(self._all_servers)
        return all(s.accounted() for s in servers)

    def _set_replica_gauge(self):
        self._gauge("fleet_replicas", len(self.live_members()))

    def _count(self, name: str, n: float = 1, **labels):
        from .. import telemetry
        if telemetry.enabled():
            telemetry.counter(name, "").inc(n, **labels)

    def _gauge(self, name: str, v: float):
        from .. import telemetry
        if telemetry.enabled():
            telemetry.gauge(name, "").set(v)
