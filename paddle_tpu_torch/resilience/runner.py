"""Preemption-safe resilient training loop.

Port of ``paddle_tpu/resilience/runner.py``. ``run_resilient`` wraps a
``ParallelTrainer``'s step loop with every recovery path:

- **auto-resume**: on entry, restores the newest VALID checkpoint
  (parameters, optimizer state, residuals, NaN guard, the data-epoch
  cursor and the generator states) and continues from the next step.
- **graceful preemption**: SIGTERM/SIGINT set a flag; the loop finishes
  the step in flight, writes a final checkpoint (unless its last save was
  of that very step: the reference saves it again, which on the deep
  cadence can replace a deep step with a cheap one and send the next
  ``prefer_deep`` resume further back), waits for it to commit (an
  asynchronous manager's device-to-host copy and commit included) and
  returns the conventional exit code (143 / 130).
- **in-process restart**: a ``faults.SimulatedCrash`` (the injected
  ``kill -9`` mid-commit) unwinds to the loop, which restores and
  replays; bounded by ``max_restarts``.
- **elastic restart**: when an ``ElasticManager`` sees a membership
  change (``ElasticStatus.RESTART``) the loop checkpoints and returns exit
  code 75 (EX_TEMPFAIL: run me again). An ``elastic.ElasticRuntime``
  (``reenter=True``) handles the RESTART in place: drain, commit, remesh,
  the coordinated restore barrier, continue from the restored cursor.
  ``elastic=True`` builds an ``ElasticManager`` from the
  ``PADDLE_ELASTIC_*`` environment (the launcher's contract).
- **faulty input**: batch fetches run under retry with backoff (site
  ``dataloader_fetch``); the ``nan_grad`` fault goes in through the
  step's ``grad_taint``, so the trainer's NaN guard does the skipping.
  ``host_loss`` raises ``faults.HostLost`` through the loop (only a
  supervisor recovers it); ``host_join`` adds a synthetic elastic member.
- **silent corruption**: with ``integrity_check_every`` set on the
  trainer, a check step that flags diverged replicas makes the loop
  quarantine the outlier (``integrity.quarantine_outliers``), keep the
  corrupt state off the disk and ROLL BACK through the restore path to
  the last clean checkpoint, bounded by ``max_rollbacks``. The ranks of
  one world roll back together. ``param_flip`` injects the corruption.
- **hang watchdog**: with ``hang_timeout`` each step runs under a
  deadline (``integrity.HangWatchdog``): a firing stops the heartbeat,
  dumps the flight recorder and, with ``hang_exit``, ends the process.
  ``host_hang`` wedges a step on purpose.

The checkpoint holds ``{"trainer": trainer.state, "meta": {"step",
"epoch", "batch", "rng"}}``. The reference saves its global JAX key in
``rng``; the port saves the states of ``framework.random``'s generators,
``{"cpu": ...}`` and, for a trainer on the card, ``{"cuda": ...}`` (the
philox seed and offset), so dropout masks and the flash kernels' dropout
seeds resume where they were.

With an asynchronous manager and a ``ckpt_torn`` fault armed, each save
waits for its commit (``_save``): the injected crash then surfaces at the
save it tore, as a real ``kill -9`` mid-commit would end the run there.
Without an armed fault the step loop never waits on a commit.

The runner never moves a trainer: it runs where the trainer runs.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Iterable, List, Optional

import torch

from . import faults
from .retry import call_with_retry

__all__ = ["RunResult", "run_resilient", "EXIT_OK", "EXIT_SIGTERM",
           "EXIT_SIGINT", "EXIT_RESTART"]

# 128 + signum for a signal-terminated run (what a shell reports), and
# EX_TEMPFAIL for "transient: run me again"
EXIT_OK = 0
EXIT_SIGTERM = 128 + signal.SIGTERM   # 143
EXIT_SIGINT = 128 + signal.SIGINT     # 130
EXIT_RESTART = 75                     # os.EX_TEMPFAIL


@dataclasses.dataclass
class RunResult:
    exit_code: int
    status: str            # completed | sigterm | sigint | restart
    steps_done: int        # global steps completed, resumed ones included
    last_step: int         # index of the last completed step (-1: none)
    loss: Optional[float]
    restarts: int          # in-process SimulatedCrash recoveries
    skipped_steps: int     # NaN-guard skips (from the trainer's state)
    restore_fallbacks: int  # corrupt checkpoints skipped during restores
    remeshes: int = 0      # in-place elastic remeshes (the runtime's total)
    barrier_steps: List[int] = dataclasses.field(default_factory=list)
    # common step of each restore-barrier entry
    divergences: int = 0   # fingerprint-check divergences observed
    hosts_quarantined: int = 0   # outlier replicas quarantined
    rollback_steps: List[int] = dataclasses.field(default_factory=list)
    # checkpoint step each divergence rolled back to
    hangs: int = 0         # hang-watchdog firings


class _StopFlag:
    """Signal -> flag. The handlers only record the signal; the loop acts
    at the next step boundary, so the final checkpoint is never torn by a
    handler. Installed only on the main thread; :meth:`uninstall` puts the
    previous handlers back."""

    def __init__(self):
        self.signum: Optional[int] = None
        self._prev = {}

    def _handler(self, signum, frame):
        self.signum = signum

    def install(self):
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:      # not the main thread: run unguarded
                pass

    def uninstall(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}


def _rng_state(device=None) -> dict:
    """The generators' states: ``cpu`` always, ``cuda`` for a trainer on
    the card (its philox seed and offset)."""
    from ..framework.random import get_generator
    out = {"cpu": get_generator("cpu").get_state()}
    if device is not None and torch.device(device).type == "cuda":
        out["cuda"] = get_generator(device).get_state()
    return out


def _set_rng_state(state: dict, device=None):
    from ..framework.random import get_generator
    for key, value in state.items():
        gen = get_generator("cpu" if key == "cpu" else device)
        gen.set_state(torch.as_tensor(value).to("cpu", torch.uint8))


def _meta(step: int, epoch: int, batch: int, device=None) -> dict:
    return {"step": torch.tensor(int(step), dtype=torch.int64),
            "epoch": torch.tensor(int(epoch), dtype=torch.int64),
            "batch": torch.tensor(int(batch), dtype=torch.int64),
            "rng": _rng_state(device)}


def _save(manager, trainer, step: int, epoch: int, batch: int) -> bool:
    ok = manager.save(step, {"trainer": trainer.state,
                             "meta": _meta(step, epoch, batch,
                                           trainer.device)})
    if getattr(manager, "async_commit", False) and \
            faults.active("ckpt_torn"):
        # an armed ckpt_torn stands for the process dying mid-commit: wait
        # for the commit, so its SimulatedCrash surfaces at the save that
        # tore, as with the synchronous pipeline, and not some steps later
        manager.flush()
    return ok


def _checked(trainer) -> bool:
    """Whether the step that just ran was a check step."""
    ce = int(getattr(trainer, "integrity_check_every", 0) or 0)
    return bool(ce) and int(getattr(trainer, "_steps_run", 0)) % ce == 0


def _restore(manager, trainer):
    """Newest-valid restore -> the restored (step, epoch, batch) cursor, or
    None when starting fresh. Falls back past torn checkpoints (counted by
    the manager)."""
    if manager is None:
        return None
    template = {"trainer": trainer.state,
                "meta": _meta(0, 0, 0, trainer.device)}
    kw = {}
    if getattr(manager, "deep_every", 0):
        # tiered layout: the newest deep-verified step first, then the
        # cheap ones
        kw["prefer_deep"] = True
    restored = manager.restore(template=template, **kw)
    if restored is None:
        return None
    trainer.state = restored["trainer"]
    meta = restored["meta"]
    _set_rng_state(meta["rng"], trainer.device)
    return (int(meta["step"]), int(meta["epoch"]), int(meta["batch"]))


def run_resilient(trainer, loader: Iterable, steps: int,
                  manager=None, save_every: int = 1,
                  deep_every: int = 0,
                  elastic=None, lr: Optional[float] = None,
                  max_restarts: int = 2,
                  handle_signals: bool = True,
                  max_rollbacks: int = 2,
                  hang_timeout: Optional[float] = None,
                  hang_exit: Optional[int] = None) -> RunResult:
    """Run ``steps`` training steps with checkpoint and resume, signal
    drain, retried fetches and the fault-injection sites. ``loader`` must
    be re-iterable in a fixed order (the epoch/batch cursor fast-forwards
    it on resume) and yield ``(inputs, labels)``.

    ``max_rollbacks`` bounds divergence rollbacks; past it, or when a
    divergence comes before anything was committed, the run goes on with
    the corrupt state but saves nothing until a later check step passes
    clean. ``hang_timeout`` (seconds) arms a ``HangWatchdog`` around each
    step; ``hang_exit`` makes a firing end the process with that code.
    ``deep_every=M`` makes every M-th save a deep one (content digests),
    forwarded to the manager; with an asynchronous manager the loop sets
    its ``dirty_probe``, so a quarantine verdict that lands while a
    snapshot is in flight keeps that snapshot off the disk."""
    from .. import telemetry
    from ..distributed.fleet.elastic import ElasticManager, ElasticStatus
    from ..telemetry import flight as _flight
    from ..telemetry import tracing as _tracing
    from . import integrity
    tel = telemetry.enabled()
    usr2 = _flight.install_signal_handler()   # SIGUSR2 -> dump (main thread)
    if elastic is True:
        elastic = ElasticManager()
    # an elastic object that re-enters in place (ElasticRuntime) vs a plain
    # manager whose RESTART means "exit 75, get relaunched"
    runtime = elastic if getattr(elastic, "reenter", False) else None
    stop = _StopFlag()
    if handle_signals:
        stop.install()
    restarts = 0
    rollbacks = 0
    divergences = 0
    quarantined = 0
    # the live state is known-divergent and was NOT rolled back: keep
    # training but never checkpoint it (a save would launder the
    # corruption into a "clean" restore). Cleared by a later clean check
    # step or by a rollback that restores committed state.
    dirty = False
    if manager is not None:
        if deep_every and hasattr(manager, "deep_every"):
            manager.deep_every = int(deep_every)
        if hasattr(manager, "dirty_probe"):
            # asked by the committer at commit time
            manager.dirty_probe = lambda: dirty
    rollback_steps: List[int] = []
    step, epoch, batch = 0, 0, 0
    last_saved: Optional[int] = None   # the step of the loop's last save
    last_loss = None
    watchdog = None
    if hang_timeout:
        # an ElasticRuntime's heartbeat is its wrapped manager's
        beat_src = getattr(elastic, "manager", elastic)
        watchdog = integrity.HangWatchdog(
            hang_timeout,
            heartbeat_fn=getattr(beat_src, "heartbeat", None),
            # the flight dump happens inside on_fire, before a hang_exit
            # ends the process
            on_fire=lambda s: _flight.dump("hang_watchdog", step=s),
            exit_code=hang_exit).start()

    def _result(exit_code, status, loss=None):
        return RunResult(
            exit_code=exit_code, status=status,
            steps_done=step, last_step=step - 1,
            loss=loss, restarts=restarts,
            skipped_steps=trainer.skipped_steps(),
            restore_fallbacks=getattr(manager, "restore_fallbacks_total", 0),
            remeshes=runtime.remeshes if runtime is not None else 0,
            barrier_steps=(list(runtime.barrier_steps)
                           if runtime is not None else []),
            divergences=divergences, hosts_quarantined=quarantined,
            rollback_steps=list(rollback_steps),
            hangs=watchdog.fired if watchdog is not None else 0)

    def _enter(remeshed: bool = False):
        """(Re)entry through the runtime's restore barrier; a plain
        newest-valid restore without a runtime. Returns the restored
        (step, epoch, batch) cursor or None.

        A checkpoint holds this rank's own residual rows. After a remesh
        the trainer keeps the rows the remesh carried (every old rank's,
        gathered before the old group went away) and the restored ones
        are dropped: one rank's row cannot be remapped alone."""
        nonlocal last_saved
        last_saved = None          # the live state is about to change
        if runtime is None:
            return _restore(manager, trainer)
        template = {"trainer": trainer.state,
                    "meta": _meta(0, 0, 0, trainer.device)}
        restored = runtime.enter(manager, template)
        if restored is None:
            return None
        rt = dict(restored["trainer"])
        if remeshed:
            rt["comm_err"] = trainer.comm_err
        trainer.state = rt
        meta = restored["meta"]
        _set_rng_state(meta["rng"], trainer.device)
        return (int(meta["step"]), int(meta["epoch"]), int(meta["batch"]))

    def _drain_save():
        """The final checkpoint of a drain: step - 1, unless the loop just
        saved it (a second save of the same state would only replace it,
        and on the deep cadence could turn a deep step into a cheap one),
        then wait for the commit (an asynchronous manager's copy off the
        card included)."""
        if last_saved != step - 1:
            _save(manager, trainer, step - 1, epoch, batch)
        manager.wait_until_finished()

    def _resume():
        nonlocal step, epoch, batch, dirty
        cur = _enter()
        if cur is not None:
            dirty = False  # restored state comes from a committed save
            step, epoch, batch = cur[0] + 1, cur[1], cur[2]
            if tel:
                telemetry.counter(
                    "resilience_resumes_total",
                    "runs that resumed from a checkpoint").inc()

    def _iter_from_cursor():
        """A fresh iterator fast-forwarded to the saved batch cursor."""
        it = iter(loader)
        for _ in range(batch):
            try:
                next(it)
            except StopIteration:
                return iter(loader)
        return it

    try:
        _resume()
        it = _iter_from_cursor()
        while step < steps:
            if faults.fires("sigterm", step, site="runner_loop"):
                signal.raise_signal(signal.SIGTERM)
            if faults.fires("host_loss", step, site="runner_loop"):
                raise faults.HostLost(f"injected host_loss at step {step}")
            if faults.fires("host_join", step, site="runner_loop") and \
                    hasattr(elastic, "simulate_join"):
                elastic.simulate_join()
            if stop.signum is not None:
                _flight.dump("drain", step=step)
                if manager is not None and step > 0 and not dirty:
                    _drain_save()
                sig = stop.signum
                return _result(
                    128 + sig,
                    "sigterm" if sig == signal.SIGTERM else "sigint",
                    loss=last_loss if last_loss is None
                    else float(last_loss))
            if elastic is not None:
                st = elastic.watch()
                if st == ElasticStatus.RESTART:
                    if manager is not None and step > 0 and not dirty:
                        _drain_save()
                    n_remesh = runtime.remeshes if runtime is not None \
                        else 0
                    if runtime is not None and runtime.on_restart(trainer):
                        cur = _enter(remeshed=runtime.remeshes > n_remesh)
                        if cur is not None:
                            dirty = False
                            step, epoch, batch = cur[0] + 1, cur[1], cur[2]
                        # else: a coordinated fresh start on a joiner: keep
                        # the live cursor, never rewind on RESTART
                        it = _iter_from_cursor()
                        continue
                    return _result(EXIT_RESTART, "restart",
                                   loss=last_loss if last_loss is None
                                   else float(last_loss))

            def _fetch():
                nonlocal it, epoch, batch
                faults.maybe_raise("data_fetch", step=step,
                                   site="dataloader_fetch",
                                   msg=f"injected data_fetch at step {step}")
                try:
                    return next(it)
                except StopIteration:
                    epoch += 1
                    batch = 0
                    it = iter(loader)
                    return next(it)

            # one trace a step (tail-sampled: kept when slow, diverged or
            # crashed)
            tr_step = _tracing.start_trace("train_step", step=step)
            sp_fetch = tr_step.span("fetch") if tr_step is not None else None
            inputs, labels = call_with_retry(
                _fetch, site="dataloader_fetch", tries=3, base_delay=0.01)
            if sp_fetch is not None:
                sp_fetch.end()

            taint = float("nan") if faults.fires(
                "nan_grad", step, site="train_step") else None
            flip = faults.fire_spec("param_flip", step, site="train_step")
            if flip is not None:
                # deterministic SDC: one mantissa bit on one replica, seen
                # only by the fingerprint check
                integrity.inject_param_flip(trainer, seed=flip.seed,
                                            step=step)
            try:
                if watchdog is not None:
                    watchdog.arm(step)
                sp_run = (tr_step.span("step") if tr_step is not None
                          else None)
                try:
                    if faults.fires("host_hang", step, site="train_step"):
                        # wedge like a stuck collective; released by the
                        # watchdog firing (or its time backstop)
                        integrity.simulate_hang()
                    with _tracing.use_span(sp_run):
                        last_loss = trainer.train_step(
                            inputs, labels, lr=lr, grad_taint=taint)
                finally:
                    if sp_run is not None:
                        sp_run.end()
                    if watchdog is not None:
                        watchdog.disarm()
                diverged = (trainer.consume_divergence()
                            if hasattr(trainer, "consume_divergence")
                            else [])
                if diverged:
                    # taint AT ONCE: an asynchronous snapshot of this state
                    # may be in flight, and the commit-time probe must see
                    # it; cleared only by a rollback that restores
                    dirty = True
                    divergences += 1
                    _flight.dump("divergence", step=step,
                                 extra={"leaves": [str(x)
                                                   for x in diverged]})
                    q = integrity.quarantine_outliers(
                        trainer, leaves=diverged, elastic=elastic)
                    quarantined += q["quarantined"]
                    if q["action"] == "self_evict":
                        # this host holds the corrupt replica: die, so the
                        # survivors' elastic runtime remeshes around it
                        raise faults.HostLost(
                            f"quarantined after replica divergence at "
                            f"step {step}: {diverged}")
                    if rollbacks < max_rollbacks:
                        rollbacks += 1
                        cur = _enter()
                        rollback_steps.append(
                            cur[0] if cur is not None else -1)
                        if cur is not None:
                            dirty = False
                            if tr_step is not None:
                                tr_step.close("divergence",
                                              rollback_to=cur[0])
                            step, epoch, batch = cur[0] + 1, cur[1], cur[2]
                            it = _iter_from_cursor()
                            continue
                        # nothing restorable (divergence before the first
                        # commit): keep the live cursor and state, dirty
                        dirty = True
                    else:
                        # rollback budget spent: go on (the divergence
                        # counters keep climbing) but never save
                        dirty = True
                elif dirty and _checked(trainer):
                    dirty = False  # a later check step came back clean
                batch += 1
                if manager is not None and not dirty and (
                        step % save_every == 0 or step == steps - 1):
                    if _save(manager, trainer, step, epoch, batch):
                        last_saved = step
                if tr_step is not None:
                    tr_step.close("divergence" if diverged else "ok")
                step += 1
            except faults.SimulatedCrash:
                if tr_step is not None:
                    tr_step.close("failed")
                restarts += 1
                if tel:
                    telemetry.counter(
                        "resilience_restarts_total",
                        "in-process crash recoveries").inc()
                if restarts > max_restarts:
                    raise
                step, epoch, batch = 0, 0, 0
                _resume()
                it = _iter_from_cursor()

        if manager is not None:
            manager.wait_until_finished()
        loss_val = None if last_loss is None else float(last_loss)
        skipped = trainer.skipped_steps()
        if tel:
            telemetry.gauge(
                "resilience_steps_skipped",
                "steps the NaN guard skipped (from trainer state)"
            ).set(skipped)
        return _result(EXIT_OK, "completed", loss=loss_val)
    finally:
        if watchdog is not None:
            watchdog.stop()
        if handle_signals:
            stop.uninstall()
        if usr2 is not None:
            _flight.uninstall_signal_handler(usr2)
