"""The elastic multi-host runtime: the coordinated restore barrier and
remesh.

Port of ``paddle_tpu/resilience/elastic.py``. The fleet
``ElasticManager`` (file-backed membership, HOLD/RESTART/EXIT) only
decides; this module makes the decision safe to act on:

- :class:`FileCoordinator`: allgather and barrier over a shared
  directory, so hosts agree on anything without a service. Each
  collective round lives in a numbered generation directory;
  participants touch their entry while waiting, so an abandoned round
  (every writer stale) is skipped rather than reused.
- :func:`coordinated_restore`: the restore barrier. Every host reports
  its ``CheckpointManager.latest_valid_step()`` (an asynchronous commit in
  flight lands first), the values are min-reduced to the newest step
  valid on EVERY host, each host restores exactly that step, and a
  barrier holds everyone until all restores finished. Counted in
  ``elastic_restore_barrier_total`` / ``elastic_step_disagreements_total``.
- :func:`reshard_trainer` / :func:`remap_comm_err`: scale-up and
  scale-down. Parameters, buffers, optimizer state and the NaN guard go
  through a checkpoint (saved before the remesh, restored after: for a
  trainer with ZeRO slices the one directory of the world, so any
  ``data`` x ``sharding`` layout takes its slices from the logical
  arrays); the error-feedback residuals, whose replica dimension follows
  the mesh, are remapped on the host. The reference holds them
  replica-major, ``(R, ...)``, in one process; a port rank holds only its
  own row, so :func:`gather_comm_err` all-gathers every rank's row over
  the old ``("data", "sharding")`` group (data-major) before that group
  goes away, and :func:`remap_comm_err` takes
  that ``(R_old, ...)`` array, carries the surviving rows as a prefix,
  drops the rest (their L2 norm counted in
  ``elastic_residual_dropped_norm_total``), zero-fills new ranks, and
  gives each rank row ``rank`` of the ``(R_new, ...)`` result, bit for
  bit the reference's.
- :class:`ElasticRuntime`: manager + coordinator + remesh policy, the
  object ``run_resilient(elastic=...)`` re-enters through instead of
  exiting 75: drain, commit, stable membership, (bounded) remesh, the
  restore barrier, continue.

A remesh is a new process group. ``reshard_trainer`` takes the new mesh
as a factory and calls it after the last collective on the old group, so
the factory may destroy the old group (or the default group) and form one
over the survivors (``destroy_process_group``, then
``init_process_group`` over a fresh store). ``schedule_fingerprints``
(``{program: fingerprint}``, or a callable giving it, e.g. from
``analysis.schedule.program_fingerprint`` of ``ParallelTrainer.
staged_graph``) are cross-checked on each entry through
``analysis.schedule.crossrank_verify``, which raises
:class:`ScheduleMismatch` with a per-host diff.

Retention caveat: the min-reduce can only roll back as far as every
host's retention window (``CheckpointManager(max_to_keep=...)``) still
holds the common step; a divergence deeper than the window raises.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# the schedule cross-check is the analysis layer's (re-exported here)
from ..analysis.schedule import ScheduleMismatch, crossrank_verify

__all__ = ["CoordinatorTimeout", "FileCoordinator", "coordinated_restore",
           "gather_comm_err", "remap_comm_err", "reshard_trainer",
           "ElasticRuntime", "data_parallel_remesh_fn", "ScheduleMismatch",
           "crossrank_verify"]

RESHARD_STATE_KEYS = ("params", "buffers", "opt", "guard")


class CoordinatorTimeout(RuntimeError):
    """An allgather or barrier round did not complete before its deadline
    (a participant died mid-round or never arrived)."""





class FileCoordinator:
    """Allgather and barrier over a shared directory, for N processes (or
    threads) that share a filesystem.

    Each named collective is a sequence of *generation* directories
    ``<root>/<name>/<g>/``. A participant joins the first generation that
    is neither complete (every expected host present) nor abandoned
    (incomplete with every entry stale), writes ``<host>.json``
    atomically, then polls, touching its own entry so live rounds stay
    distinguishable from dead ones, until the expected host set (re-read
    from ``hosts_fn`` every poll, so a member lost mid-round shrinks the
    wait) is present.
    """

    def __init__(self, root: str, job_id: str = "job",
                 host: Optional[str] = None, stale_after: float = 10.0,
                 poll: float = 0.05):
        self.root = os.path.join(root, job_id + ".coord")
        self.host = host or f"pid-{os.getpid()}"
        self.stale_after = float(stale_after)
        self.poll = float(poll)
        os.makedirs(self.root, exist_ok=True)

    def _entries(self, gen_dir: str) -> Dict[str, tuple]:
        out = {}
        try:
            names = os.listdir(gen_dir)
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            full = os.path.join(gen_dir, fn)
            try:
                mtime = os.path.getmtime(full)
                with open(full) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace or gone: the next poll sees it
            out[fn[:-len(".json")]] = (payload["v"], mtime)
        return out

    def _pick_generation(self, name: str, expected: set) -> int:
        base = os.path.join(self.root, name)
        try:
            gens = sorted(int(g) for g in os.listdir(base) if g.isdigit())
        except OSError:
            gens = []
        for g in gens:
            entries = self._entries(os.path.join(base, str(g)))
            if expected <= set(entries):
                continue                      # a completed round
            if not entries:
                # a peer made the directory and its entry has not landed:
                # joinable, not abandoned (else the round would split
                # across two generations)
                return g
            now = time.time()
            if any(now - m <= self.stale_after
                   for _, m in entries.values()):
                return g                      # a live incomplete round
            # incomplete with every writer stale: abandoned, skip it
        return (gens[-1] + 1) if gens else 0

    def _write(self, gen_dir: str, value):
        tmp = os.path.join(gen_dir, f".{self.host}.tmp")
        with open(tmp, "w") as f:
            json.dump({"v": value}, f)
        os.replace(tmp, os.path.join(gen_dir, self.host + ".json"))

    def allgather(self, name: str, value, hosts_fn: Callable[[], List[str]],
                  timeout: float = 120.0) -> Dict[str, object]:
        """Contribute ``value`` under ``name`` and return every expected
        host's contribution as ``{host: value}``."""
        expected = set(hosts_fn()) | {self.host}
        gen_dir = os.path.join(
            self.root, name, str(self._pick_generation(name, expected)))
        os.makedirs(gen_dir, exist_ok=True)
        self._write(gen_dir, value)
        mine = os.path.join(gen_dir, self.host + ".json")
        deadline = time.time() + timeout
        while True:
            try:
                os.utime(mine)
            except OSError:
                self._write(gen_dir, value)
            expected = set(hosts_fn()) | {self.host}
            entries = self._entries(gen_dir)
            if expected <= set(entries):
                return {h: entries[h][0] for h in sorted(expected)}
            if time.time() > deadline:
                raise CoordinatorTimeout(
                    f"allgather {name!r}: waited {timeout:.0f}s for "
                    f"{sorted(expected - set(entries))} in {gen_dir}")
            time.sleep(self.poll)

    def barrier(self, name: str, hosts_fn: Callable[[], List[str]],
                timeout: float = 120.0):
        self.allgather(name, 1, hosts_fn, timeout=timeout)


def coordinated_restore(manager, template, coordinator: FileCoordinator,
                        hosts_fn: Callable[[], List[str]],
                        timeout: float = 120.0):
    """The restore barrier. Returns ``(restored, common_step)``:
    ``restored`` is the checkpoint (None on a coordinated fresh start),
    ``common_step`` the min-reduced step (-1 when any host has no valid
    checkpoint)."""
    from .. import telemetry
    from . import faults
    if manager is not None and getattr(manager, "async_commit", False):
        # a commit in flight lands (or is suppressed) before this host
        # reports: the barrier min-reduces COMMITTED steps only
        manager.flush()
    local = manager.latest_valid_step() if manager is not None else None
    local = -1 if local is None else int(local)
    if faults.fires("restore_divergence", site="restore_barrier"):
        # pretend the newest checkpoint is torn: report one step older
        local = max(local - 1, -1)
    steps = coordinator.allgather("restore_step", local, hosts_fn,
                                  timeout=timeout)
    values = [int(v) for v in steps.values()]
    common = min(values)
    tel = telemetry.enabled()
    if tel and len(set(values)) > 1:
        telemetry.counter(
            "elastic_step_disagreements_total",
            "restore barriers where hosts reported divergent steps").inc()
    restored = None
    if common >= 0:
        if common not in set(manager.all_steps() or []):
            raise RuntimeError(
                f"common step {common} not in local retention "
                f"{sorted(manager.all_steps() or [])}; divergence exceeds "
                f"the checkpoint retention window")
        restored = manager.restore(step=common, template=template)
    coordinator.barrier("restore_barrier", hosts_fn, timeout=timeout)
    if tel:
        telemetry.counter(
            "elastic_restore_barrier_total",
            "coordinated restore barriers completed").inc()
    return restored, common


def gather_comm_err(trainer) -> Dict[str, np.ndarray]:
    """Every rank's residual rows as the reference's replica-major host
    arrays, ``{name: (R, *shape)}``, rows data-major over ``("data",
    "sharding")``: an ``all_gather`` over that group (a collective: every
    rank calls it), or this rank's row at one rank."""
    import torch.distributed as dist
    group = trainer.mesh.group_of(("data", "sharding"))
    out = {}
    for k, row in trainer.comm_err.items():
        if group is None:
            rows = [row.detach()]
        else:
            rows = [torch.empty_like(row) for _ in
                    range(dist.get_world_size(group))]
            dist.all_gather(rows, row.detach().contiguous(), group=group)
        out[k] = torch.stack(rows).cpu().numpy()
    return out


def remap_comm_err(old_host_arrays: Dict[str, np.ndarray], trainer):
    """Remap replica-major residuals ``{name: (R_old, *shape)}`` onto the
    trainer's CURRENT ranks (module docstring); sets and returns the
    trainer's own rows."""
    from .. import telemetry
    dropped_sq = 0.0
    new = {}
    current = trainer.comm_err
    n_new = int(getattr(trainer, "n_reduce", trainer.n_data))
    rank = int(getattr(trainer, "reduce_rank", trainer.data_rank))
    for k, fresh in current.items():
        old = old_host_arrays.get(k)
        if old is None:
            new[k] = fresh
            continue
        old = np.asarray(old)
        if old.shape[1:] != tuple(fresh.shape):
            dropped_sq += float((old.astype(np.float64) ** 2).sum())
            new[k] = fresh
            continue
        buf = np.zeros((n_new,) + tuple(fresh.shape),
                       dtype=str(fresh.dtype).rsplit(".", 1)[-1])
        rows = min(old.shape[0], n_new)
        buf[:rows] = old[:rows]
        if old.shape[0] > n_new:
            extra = old[n_new:].astype(np.float64)
            dropped_sq += float((extra ** 2).sum())
        new[k] = torch.from_numpy(np.ascontiguousarray(buf[rank])).to(
            fresh.device)
    for k, old in old_host_arrays.items():
        if k not in current:
            dropped_sq += float((np.asarray(old).astype(np.float64) ** 2)
                                .sum())
    if dropped_sq > 0.0 and telemetry.enabled():
        telemetry.counter(
            "elastic_residual_dropped_norm_total",
            "L2 norm of error-feedback residual rows dropped by remesh"
        ).inc(float(np.sqrt(dropped_sq)))
    with torch.no_grad():
        for k, v in new.items():
            if v is not current[k]:
                current[k].copy_(v)
    return current


def _split_state(trainer) -> bool:
    """Whether the trainer holds a leaf as a slice (a ZeRO leaf)."""
    return bool(getattr(trainer, "zero3_dims", None)
                or getattr(trainer, "_update_dims", None))


def reshard_trainer(trainer, new_mesh, reshard_dir: str):
    """Carry a live trainer onto a new mesh: every rank's residual rows are
    gathered over the old group, parameters, buffers, optimizer state and
    guard are saved to ``reshard_dir``, then ``new_mesh`` (a mesh, or a
    callable giving one: it may destroy the old process group and start
    another, since every collective on the old group has finished) takes
    the trainer (``ParallelTrainer.remesh``), the checkpoint is restored
    on it and the residuals are remapped.

    A trainer with ZeRO slices saves the one directory of its world
    (``reshard_dir`` shared by every rank; stage-3 parameters are gathered
    into the model first), and each rank of the new mesh takes its slices
    from the logical arrays, so any ``data`` x ``sharding`` layout (one
    process included) restores it; otherwise ``reshard_dir`` is this
    process's own. A callable ``new_mesh`` that returns None on a rank
    takes that rank out: its trainer stops after the save and the call
    returns None."""
    from .. import telemetry
    from ..distributed.checkpoint import load_checkpoint, save_checkpoint
    old_comm = gather_comm_err(trainer)
    sharded = _split_state(trainer)
    state = trainer.state
    if sharded:
        trainer.sync_to_model()
        save_checkpoint(reshard_dir, state.subset(RESHARD_STATE_KEYS),
                        overwrite=True)
    else:
        save_checkpoint(reshard_dir,
                        {k: state[k] for k in RESHARD_STATE_KEYS},
                        overwrite=True)
    mesh = new_mesh() if callable(new_mesh) else new_mesh
    if mesh is None:
        return None
    trainer.remesh(mesh)
    state = trainer.state
    restored = load_checkpoint(
        reshard_dir, template=state.subset(RESHARD_STATE_KEYS))
    full = dict(state)
    full.update({k: restored[k] for k in RESHARD_STATE_KEYS})
    trainer.state = full
    remap_comm_err(old_comm, trainer)
    if telemetry.enabled():
        telemetry.counter("elastic_remesh_total",
                          "trainer remesh/reshard operations").inc()
    return trainer


def data_parallel_remesh_fn(reshard_dir: str,
                            degrees_fn: Optional[Callable] = None):
    """A ``remesh_fn`` for :class:`ElasticRuntime`: a data mesh sized to
    the healthy hosts (``degrees_fn(hosts) -> degrees`` overrides the
    one-axis policy, any ``data`` x ``sharding`` degrees whose product is
    the default process group's size), resharded through ``reshard_dir``
    (shared by every rank when the trainer holds ZeRO slices)."""
    def _remesh(trainer, hosts: List[str]):
        import torch.distributed as dist
        from ..distributed.mesh import build_mesh
        if degrees_fn is not None:
            degrees = degrees_fn(hosts)
        else:
            world = dist.get_world_size() if dist.is_initialized() else 1
            degrees = {"data": max(1, min(world, len(hosts)))}
        reshard_trainer(trainer, lambda: build_mesh(degrees), reshard_dir)
    return _remesh


class ElasticRuntime:
    """Manager + coordinator + remesh policy, for
    ``run_resilient(elastic=...)``. ``reenter=True`` tells the runner a
    RESTART is handled in place (drain, :meth:`on_restart`,
    :meth:`enter`) instead of exiting 75; ``on_restart`` returning False
    (no stable membership, remesh budget spent, remesh failed) falls back
    to the relaunch path."""

    reenter = True

    def __init__(self, manager, coordinator: Optional[FileCoordinator] = None,
                 remesh_fn: Optional[Callable] = None, max_remeshes: int = 2,
                 poll: float = 0.25, stabilize_polls: int = 3,
                 stabilize_timeout: float = 60.0,
                 barrier_timeout: float = 120.0,
                 schedule_fingerprints=None):
        self.manager = manager
        self.coordinator = coordinator
        self.remesh_fn = remesh_fn
        self.max_remeshes = max_remeshes
        self.poll = poll
        self.stabilize_polls = stabilize_polls
        self.stabilize_timeout = stabilize_timeout
        self.barrier_timeout = barrier_timeout
        # {program: fingerprint} (or a zero-argument callable giving it),
        # cross-checked with every other host on each enter()
        self.schedule_fingerprints = schedule_fingerprints
        self.remeshes = 0
        self.barrier_steps: List[int] = []   # common step of each entry
        self._adopted: Optional[set] = None  # the host set training runs on
        self._synthetic: List[str] = []      # host_join member files

    # -- simulated membership (the host_join fault) ------------------------
    def simulate_join(self) -> str:
        """Add a synthetic member to the membership directory; watch()
        heartbeats it until it is removed."""
        name = f"sim-join-{len(self._synthetic)}"
        path = self.manager._member_file(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("synthetic")
        self._synthetic.append(path)
        return path

    def _synthetic_names(self) -> set:
        return {os.path.basename(p)[:-len(".alive")]
                for p in self._synthetic}

    def _heartbeat_synthetic(self):
        for p in list(self._synthetic):
            try:
                os.utime(p)
            except OSError:
                self._synthetic.remove(p)   # removed: it "left"

    # -- membership ---------------------------------------------------------
    def _coord_hosts(self) -> List[str]:
        """Barrier participants: live members that are real processes
        (synthetic members cannot write barrier entries)."""
        out = set(self.manager.hosts()) - self._synthetic_names()
        out.add(self.coordinator.host if self.coordinator is not None
                else self.manager.host)
        return sorted(out)

    def _stable_hosts(self) -> Optional[List[str]]:
        """``stabilize_polls`` identical host sets in a row inside the np
        range; None on timeout."""
        deadline = time.time() + self.stabilize_timeout
        last, streak = None, 0
        while time.time() < deadline:
            self.manager.heartbeat()
            self._heartbeat_synthetic()
            cur = tuple(self.manager.hosts())
            streak = streak + 1 if cur == last else 1
            last = cur
            if (streak >= self.stabilize_polls
                    and self.manager.np_min <= len(cur)
                    <= self.manager.np_max):
                return list(cur)
            time.sleep(self.poll)
        return None

    def watch(self, proc_alive=lambda: True) -> str:
        """The manager's watch, plus: a host-set change INSIDE the np
        range (HOLD to the manager) is a RESTART here, since the mesh was
        built for the adopted set."""
        from ..distributed.fleet.elastic import ElasticStatus
        self._heartbeat_synthetic()
        st = self.manager.watch(proc_alive)
        if st == ElasticStatus.HOLD and self._adopted is not None:
            if set(self.manager.hosts()) != self._adopted:
                return ElasticStatus.RESTART
        return st

    # -- restart and entry ----------------------------------------------------
    def on_restart(self, trainer) -> bool:
        """Handle a RESTART in place: wait for stable membership, remesh
        when the healthy set changed (at most ``max_remeshes``). False
        gives up to the relaunch path (exit 75)."""
        from .. import telemetry
        hosts = self._stable_hosts()
        if hosts is None:
            return False
        changed = (self._adopted is not None
                   and set(hosts) != self._adopted)
        if changed and self.remesh_fn is not None:
            if self.remeshes >= self.max_remeshes:
                return False
            try:
                self.remesh_fn(trainer, list(hosts))
            except Exception:
                if telemetry.enabled():
                    telemetry.counter(
                        "elastic_remesh_failed_total",
                        "remesh attempts that fell back to relaunch").inc()
                return False
            self.remeshes += 1
        self._adopted = set(hosts)
        return True

    def enter(self, ckpt_manager, template, timeout: Optional[float] = None):
        """(Re)enter training through the restore barrier; returns the
        restored checkpoint (None: a coordinated fresh start)."""
        from .. import telemetry
        timeout = self.barrier_timeout if timeout is None else timeout
        if self._adopted is None:
            hosts = self._stable_hosts()
            self._adopted = set(hosts if hosts is not None
                                else self.manager.hosts())
        if (self.schedule_fingerprints is not None
                and self.coordinator is not None):
            fps = self.schedule_fingerprints
            if callable(fps):
                fps = fps()
            # a name per entry: a re-entry must not read the previous
            # round's files
            crossrank_verify(
                self.coordinator, fps, self._coord_hosts, timeout=timeout,
                name=f"schedule_fp_{len(self.barrier_steps)}")
        if self.coordinator is not None and ckpt_manager is not None:
            restored, common = coordinated_restore(
                ckpt_manager, template, self.coordinator,
                self._coord_hosts, timeout=timeout)
        else:
            restored = (ckpt_manager.restore(template=template)
                        if ckpt_manager is not None else None)
            common = getattr(ckpt_manager, "last_restored_step", None) \
                if restored is not None else None
            common = -1 if common is None else int(common)
            if telemetry.enabled():
                telemetry.counter(
                    "elastic_restore_barrier_total",
                    "coordinated restore barriers completed").inc()
        self.barrier_steps.append(common)
        return restored
