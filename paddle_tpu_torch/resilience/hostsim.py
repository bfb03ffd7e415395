"""Multi-host simulation on one machine: N subprocess "hosts" over the
file-backed ``ElasticManager`` and the ``FileCoordinator`` barrier.

Port of ``paddle_tpu/resilience/hostsim.py``. Each simulated host is a
real process (``python -m paddle_tpu_torch.resilience.hostsim``) with its
own trainer, its own ``CheckpointManager`` directory and its own elastic
runtime; the only shared state is the membership and coordinator
directories, the shape of a real multi-host job. That makes the elastic
story (the restore barrier over divergent checkpoints, host loss seen as
heartbeat staleness, remesh and resume) testable on one machine.

:class:`SimCluster` is the supervisor: it seeds (optionally divergent)
checkpoints, launches the hosts with their faults, and collects one
result JSON per surviving host. Hosts that finish wait for each other at
a last barrier before they deregister, so a peer one step behind never
reads an early finisher's departure as a membership change. A host killed by ``host_loss`` dies with
``os._exit(9)`` (no deregister, no flush), so survivors learn of it only
when its heartbeat goes stale; a host whose watchdog fires on
``host_hang`` exits with 10; a host whose supplied schedule fingerprints
disagree with its peers' exits with 11.

**The degree differs from the reference's.** A reference host holds a
2-wide data mesh in its one process and drops to 1 after a loss, so its
``data_degree_final`` reads 2 -> 1 and its ``residual_dropped_norm`` is
positive. A port process drives one rank, so a port host trains at data
degree 1 throughout: ``data_degree_final`` is 1 and
``residual_dropped_norm`` 0 after a host loss. The 2 -> 1 residual
remap is held instead by ``remap_comm_err`` against the reference, and by
a planned scale-down of a gloo world of 2 ranks to 1.

Each host trains the reference's hostsim MLP (8 -> 16 -> 4, Momentum
0.05/0.9, the int8 exchange with 8-element blocks) on ``--device`` (the
card unless the caller asks for the CPU).

Layout under the cluster root::

    kv/            the ElasticManager member files (<host>.alive)
    coord/         FileCoordinator generations
    ckpt/<h>/      one CheckpointManager directory a host
    reshard/<h>/   a host's remesh staging
    results/<h>.json  one result a surviving host
    flight/        flight-recorder dumps
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["SimCluster", "worker_main", "seed_checkpoints",
           "HOST_LOSS_EXIT", "HOST_HANG_EXIT", "SCHEDULE_MISMATCH_EXIT"]

HOST_LOSS_EXIT = 9   # a host_loss death (distinct from every runner code)
HOST_HANG_EXIT = 10  # the hang watchdog ended the host (a wedged step)
SCHEDULE_MISMATCH_EXIT = 11  # the bootstrap schedule cross-check failed

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _host_name(i: int) -> str:
    return f"host{i}"


class _SlowLoader:
    """A re-iterable loader in a fixed order with a delay a batch, so a run
    spans enough wall time for a heartbeat to go stale mid-run."""

    def __init__(self, batches, delay: float = 0.0):
        self.batches = batches
        self.delay = delay

    def __iter__(self):
        for b in self.batches:
            if self.delay:
                time.sleep(self.delay)
            yield b


def _tiny_batches(n: int = 4, batch: int = 8, seed: int = 3):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 8).astype(np.float32),
             rng.randn(batch, 4).astype(np.float32)) for _ in range(n)]


def _tiny_trainer(seed: int = 7, device: Optional[str] = None):
    """The reference's hostsim trainer at data degree 1: the int8 exchange
    (non-empty residuals) on a one-rank data mesh."""
    import torch

    from .. import framework, nn, optimizer
    from ..distributed.engine import ParallelTrainer
    from ..distributed.mesh import build_mesh

    framework.seed(seed)

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 16)
            self.l2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.l2(torch.relu(self.l1(x)))

    model = MLP()
    opt = optimizer.Momentum(0.05, momentum=0.9,
                             parameters=model.parameters())
    return ParallelTrainer(model, opt,
                           lambda out, y: torch.mean((out - y) ** 2),
                           mesh=build_mesh({"data": 1}), grad_sync="int8",
                           grad_sync_block=8, device=device)


def seed_checkpoints(ckpt_dir: str, upto_step: int, seed: int = 7,
                     device: Optional[str] = None):
    """Fill a host's checkpoint directory with steps ``0..upto_step`` in the
    runner's own format and cursor, so a worker resumes them. Two hosts
    seeded to the same step hold the same state."""
    from ..distributed.checkpoint import CheckpointManager
    from .runner import _save

    trainer = _tiny_trainer(seed=seed, device=device)
    batches = _tiny_batches()
    mgr = CheckpointManager(ckpt_dir, max_to_keep=upto_step + 1)
    it = iter(batches)
    epoch, batch = 0, 0
    for step in range(upto_step + 1):
        try:
            x, y = next(it)
        except StopIteration:
            epoch, batch = epoch + 1, 0
            it = iter(batches)
            x, y = next(it)
        trainer.train_step(x, y)
        batch += 1
        _save(mgr, trainer, step, epoch, batch)
    mgr.close()


# -- one simulated host (runs as __main__ in its own process) -------------------

def _counter_total(snapshot: dict, name: str) -> float:
    series = snapshot.get(name, {}).get("series", {})
    return float(sum(v for v in series.values()
                     if isinstance(v, (int, float))))


def worker_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="one simulated elastic host")
    p.add_argument("--root", required=True)
    p.add_argument("--host", required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--np", dest="np_spec", default="2:3")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--hb-timeout", type=float, default=1.0)
    p.add_argument("--step-delay", type=float, default=0.15)
    p.add_argument("--max-remeshes", type=int, default=3)
    p.add_argument("--hang-timeout", type=float, default=0.0,
                   help="arm the hang watchdog with this step deadline "
                        "(seconds); a firing exits with HOST_HANG_EXIT")
    p.add_argument("--fault", action="append", default=[],
                   metavar="KIND:STEP",
                   help="arm a deterministic fault, e.g. host_loss:12")
    p.add_argument("--desync-schedule", action="store_true",
                   help="advertise another schedule fingerprint than the "
                        "peers', so the bootstrap cross-check aborts")
    args = p.parse_args(argv)

    from .. import telemetry
    from ..distributed.checkpoint import CheckpointManager
    from ..distributed.fleet.elastic import ElasticManager
    from ..telemetry import flight, tracing
    from . import faults, integrity
    from .elastic import (CoordinatorTimeout, ElasticRuntime,
                          FileCoordinator, ScheduleMismatch,
                          data_parallel_remesh_fn)
    from .runner import run_resilient

    telemetry.enable()
    pidx = int(args.host[len("host"):] or 0) \
        if args.host.startswith("host") else 0
    flight.configure(os.path.join(args.root, "flight"), process_index=pidx)
    tracing.enable()  # the always-on ring: a hang dump shows recent spans
    trainer = _tiny_trainer(seed=args.seed, device=args.device)
    loader = _SlowLoader(_tiny_batches(), delay=args.step_delay)

    em = ElasticManager(elastic_server=os.path.join(args.root, "kv"),
                        job_id="sim", np=args.np_spec, host=args.host,
                        timeout=args.hb_timeout)
    em.register()
    # a heartbeat thread: the step loop's own heartbeat stalls through
    # restore barriers; an os._exit host_loss kills the thread, which is
    # how a machine loss looks
    hb_stop = threading.Event()

    def _beat():
        while not hb_stop.is_set():
            if integrity.hang_event.is_set():
                # the watchdog fired: this host is wedged; stop
                # advertising liveness so peers see it as lost
                return
            try:
                em.heartbeat()
            except Exception:
                pass
            hb_stop.wait(min(0.2, args.hb_timeout / 4))

    threading.Thread(target=_beat, name="elastic-heartbeat",
                     daemon=True).start()
    # rendezvous: wait for the whole first world
    deadline = time.time() + 60.0
    while len(em.hosts()) < args.world and time.time() < deadline:
        time.sleep(0.05)

    coord = FileCoordinator(os.path.join(args.root, "coord"), job_id="sim",
                            host=args.host,
                            stale_after=max(5.0, 4 * args.hb_timeout))
    mgr = CheckpointManager(os.path.join(args.root, "ckpt", args.host),
                            max_to_keep=4)
    # the bootstrap schedule fingerprint: every host hashes the program it
    # is about to run (its traced step) and cross-checks it before the
    # first step and after each remesh; a --desync-schedule host hashes the
    # integrity-check step instead, as if it thought this a check step.
    # The hosts are replicas at data degree 1, whose steps issue no
    # collective, so the whole program is hashed (structure=True), not
    # only its collective schedule
    from ..analysis.schedule import program_fingerprint
    x0, y0 = _tiny_batches()[0]
    fps = {"train-step": program_fingerprint(
        trainer.staged_graph(x0, y0, do_check=args.desync_schedule),
        trainer.mesh, structure=True)}
    runtime = ElasticRuntime(
        em, coordinator=coord,
        remesh_fn=data_parallel_remesh_fn(
            os.path.join(args.root, "reshard", args.host),
            degrees_fn=lambda hosts: {"data": 1}),
        max_remeshes=args.max_remeshes,
        poll=0.1, stabilize_polls=3, stabilize_timeout=30.0,
        barrier_timeout=60.0, schedule_fingerprints=fps)

    def _write_result(out: dict):
        results_dir = os.path.join(args.root, "results")
        os.makedirs(results_dir, exist_ok=True)
        tmp = os.path.join(results_dir, f".{args.host}.tmp")
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, os.path.join(results_dir, args.host + ".json"))

    with contextlib.ExitStack() as stack:
        for spec in args.fault:
            kind, _, at = spec.partition(":")
            stack.enter_context(faults.inject(kind, at_step=int(at)))
        try:
            res = run_resilient(trainer, loader, args.steps, manager=mgr,
                                save_every=1, elastic=runtime,
                                hang_timeout=args.hang_timeout or None,
                                hang_exit=HOST_HANG_EXIT)
        except faults.HostLost:
            # an abrupt machine death: no deregister, no flush, no result
            os._exit(HOST_LOSS_EXIT)
        except ScheduleMismatch as e:
            _write_result({
                "host": args.host,
                "exit_code": SCHEDULE_MISMATCH_EXIT,
                "status": "schedule_mismatch",
                "schedule_diff": e.diff,
                "telemetry": telemetry.get_registry().to_dict(),
            })
            mgr.close()
            hb_stop.set()
            em.close()
            return SCHEDULE_MISMATCH_EXIT

    snap = telemetry.get_registry().to_dict()
    out = {
        "host": args.host,
        "exit_code": res.exit_code,
        "status": res.status,
        "steps_done": res.steps_done,
        "last_step": res.last_step,
        "loss": None if res.loss is None else float(res.loss),
        "restarts": res.restarts,
        "remeshes": res.remeshes,
        "barrier_steps": res.barrier_steps,
        "disagreements": _counter_total(
            snap, "elastic_step_disagreements_total"),
        "residual_dropped_norm": _counter_total(
            snap, "elastic_residual_dropped_norm_total"),
        "data_degree_final": int(trainer.mesh.shape.get("data", 1)),
        "telemetry": snap,
    }
    _write_result(out)
    mgr.close()
    # leave together: a host that deregistered as it finished would look,
    # to a peer one step behind, like a membership change (a RESTART that
    # cannot stabilise below np_min)
    try:
        coord.barrier("run_end", runtime._coord_hosts, timeout=60.0)
    except CoordinatorTimeout:
        pass
    hb_stop.set()
    em.close()
    return res.exit_code


# -- the supervisor -------------------------------------------------------------

class SimCluster:
    """Launch and supervise N simulated hosts sharing one cluster root.
    ``device=None`` trains each host on the card; pass ``"cpu"`` for the
    CPU."""

    def __init__(self, root: str, n_hosts: int = 3, np_spec: str = "2:3",
                 steps: int = 24, hb_timeout: float = 1.0,
                 step_delay: float = 0.15, seed: int = 7,
                 hang_timeout: float = 0.0, device: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.n_hosts = n_hosts
        self.np_spec = np_spec
        self.steps = steps
        self.hb_timeout = hb_timeout
        self.step_delay = step_delay
        self.seed = seed
        self.hang_timeout = hang_timeout
        self.device = "cuda" if device is None else str(device)
        os.makedirs(self.root, exist_ok=True)

    def host_ckpt_dir(self, i: int) -> str:
        return os.path.join(self.root, "ckpt", _host_name(i))

    def seed_divergent(self, steps_by_host: Dict[int, int]):
        """Seed each host's checkpoint directory up to its own step (the
        divergence the restore barrier must reconcile)."""
        for i, upto in steps_by_host.items():
            seed_checkpoints(self.host_ckpt_dir(i), upto, seed=self.seed,
                             device=self.device)

    def _spawn(self, i: int, faults_for: List[tuple],
               desync: bool = False) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.resilience.hostsim",
               "--root", self.root, "--host", _host_name(i),
               "--world", str(self.n_hosts), "--np", self.np_spec,
               "--steps", str(self.steps), "--seed", str(self.seed),
               "--device", self.device,
               "--hb-timeout", str(self.hb_timeout),
               "--step-delay", str(self.step_delay)]
        if self.hang_timeout:
            cmd += ["--hang-timeout", str(self.hang_timeout)]
        if desync:
            cmd += ["--desync-schedule"]
        for kind, at in faults_for:
            cmd += ["--fault", f"{kind}:{at}"]
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.setdefault("OMP_NUM_THREADS", "1")
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def run(self, faults: Optional[Dict[int, List[tuple]]] = None,
            timeout: float = 300.0,
            desync_hosts: Optional[set] = None) -> dict:
        """Run the cluster to the end. ``faults`` maps a host index to
        ``[(kind, at_step), ...]``; ``desync_hosts`` are launched with
        ``--desync-schedule``. Returns the exit codes by host, the result
        JSONs (None for a dead host) and the lost and hung counts."""
        faults = faults or {}
        desync_hosts = desync_hosts or set()
        procs = {i: self._spawn(i, faults.get(i, []),
                                desync=i in desync_hosts)
                 for i in range(self.n_hosts)}
        deadline = time.time() + timeout
        exit_codes: Dict[str, Optional[int]] = {}
        stderr: Dict[str, str] = {}
        for i, proc in procs.items():
            budget = max(1.0, deadline - time.time())
            try:
                _, err = proc.communicate(timeout=budget)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            exit_codes[_host_name(i)] = proc.returncode
            stderr[_host_name(i)] = (err or "")[-4000:]
        results: Dict[str, Optional[dict]] = {}
        for i in range(self.n_hosts):
            h = _host_name(i)
            path = os.path.join(self.root, "results", h + ".json")
            try:
                with open(path) as f:
                    results[h] = json.load(f)
            except (OSError, ValueError):
                results[h] = None
        hosts_lost = sum(1 for c in exit_codes.values()
                         if c == HOST_LOSS_EXIT)
        hosts_hung = sum(1 for c in exit_codes.values()
                         if c == HOST_HANG_EXIT)
        return {"exit_codes": exit_codes, "results": results,
                "hosts_lost": hosts_lost, "hosts_hung": hosts_hung,
                "stderr": stderr}


if __name__ == "__main__":
    sys.exit(worker_main())
