"""Silent-corruption defense: replica fingerprints, the quarantine vote,
content digests, step replay and the hang watchdog.

Port of ``paddle_tpu/resilience/integrity.py``.

- **Replica fingerprints** (:func:`fingerprint_array`,
  :func:`fingerprint_tree`): a chunked, position-weighted checksum of an
  array's bytes, bit-identical to the reference's for every dtype. The
  bytes are bitcast to 32-bit lanes (never summed in float: NaN payloads
  and -0.0 count), each lane is multiplied by an odd weight of its
  position in its 1024-lane chunk, the chunk sums by an odd weight of the
  chunk, and everything adds modulo 2**32. PyTorch has no uint32
  arithmetic, so the lanes live in ``int64`` and every product is taken
  modulo 2**32 with explicit masks (the weight split into 16-bit halves,
  so no product leaves 58 bits); sums of masked terms stay far inside
  ``int64``. Modular addition is order independent, so the value is the
  same on any device and in any reduction order. The engine compares them
  across data ranks on check steps (``ParallelTrainer(
  integrity_check_every=N)``).
- **Quarantine** (:func:`quarantine_outliers`): once a check step flags
  a divergence, each rank's CRC32 chain over its replicated parameters is
  gathered and majority-voted (:func:`vote_outliers`). The port runs one
  rank per process, and the ranks of one ``torch.distributed`` world play
  the reference's single-process mesh: every replica is observed through
  an ``all_gather_object`` over the data group, and the verdict is a
  rollback on every rank. :func:`_gather_digest_chains` merges views
  across hosts over the elastic coordinator, for replicas that span
  hosts.
- **Content digests** (:func:`array_digest`, :func:`tree_digests`,
  :func:`compare_digests`): ``"crc32:<8 hex>:<nbytes>"`` over the dtype's
  numpy name, the shape and the row-major bytes, as the reference's;
  a tree's digests are keyed by the checkpoint manifest's dotted paths
  (``params.gpt.h.0.attn.qkv_proj.weight``), so
  ``CheckpointManager.verify(step, deep=True)`` and :func:`replay_step`
  compare against what a manifest recorded.
- **Replay** (:func:`replay_step`): re-run step *s* from checkpoint *s-1*
  with its data cursor and generator states, twice, and compare the
  digests with those recorded at *s*: SDC (the replays agree with each
  other and not with the record) separates from nondeterminism (the
  replays disagree).
- **Hang watchdog** (:class:`HangWatchdog`): a deadline around the step.
  It cannot interrupt a wedged CUDA call (the reference cannot interrupt
  XLA either); it stops the heartbeat, so peers see the host as lost, and
  with ``exit_code`` ends the process.

:func:`count_fingerprint_collectives` counts the fingerprint collectives
of a traced step (``ParallelTrainer.staged_graph``, ``analysis/walker.py``):
the check step's ``all_reduce`` of the stacked ``int64`` fingerprints with
``MIN`` and with ``MAX`` (:data:`FINGERPRINT_COLLECTIVES`), which the
trainer tags while it is traced (:data:`FINGERPRINT_TAG`, a node's
``meta["custom"]``), since a traced c10d node does not show its reduce
op. The reference counts the uint32 pmin/pmax of a jaxpr.
"""
from __future__ import annotations

import contextlib
import json
import os
import random as _pyrandom
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = [
    "FINGERPRINT_COLLECTIVES", "FINGERPRINT_TAG", "fingerprint_array",
    "fingerprint_tree",
    "count_fingerprint_collectives", "array_digest", "tree_digests",
    "compare_digests", "replica_coords", "vote_outliers",
    "quarantine_outliers", "inject_param_flip", "HangWatchdog",
    "hang_event", "simulate_hang", "replay_step",
]

# the reduce ops of the engine's fingerprint compare (on int64 tensors; the
# int8/int4 exchange reduces float scales with MAX, so the dtype tells them
# apart, as the reference tells them apart by uint32)
FINGERPRINT_COLLECTIVES = ("min", "max")
#: the annotation a traced check step carries on its fingerprint
#: collectives (``torch.fx.traceback.annotate``)
FINGERPRINT_TAG = {"integrity": "fingerprint"}

# odd 32-bit mixing constants (Knuth / xxhash primes), as the reference's
_P1 = 2654435761
_P2 = 0x9E3779B9
_P3 = 0x85EBCA6B
_MASK = 0xFFFFFFFF


# -- fingerprints -------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).rsplit(".", 1)[-1]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


def _as_uint32(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as 32-bit lanes, each held in an ``int64`` in
    [0, 2**32), row-major. 1- and 2-byte dtypes widen one element to one
    lane; 8-byte dtypes give two lanes an element, low word first (the
    order of the reference's bitcast). Never goes through float."""
    t = t.contiguous().reshape(-1)
    if t.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=t.device)
    if t.dtype == torch.bool:
        return t.to(torch.int64)
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).to(torch.int64)
    if size == 2:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    if size in (4, 8):
        return t.view(torch.int32).to(torch.int64) & _MASK
    raise TypeError(f"fingerprint: unsupported dtype {t.dtype}")


def _mulmod(a: torch.Tensor, b: Tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """a * b mod 2**32 for a in [0, 2**42) and b in [0, 2**32) held in
    int64, b given as its 16-bit halves (lo, hi): each product stays below
    2**58, and only the low 16 bits of a * hi reach the result."""
    lo, hi = b
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


# the odd weights of a chunk's lanes and of a leaf's rows, as 16-bit
# halves, by (length, device): computed once
_WEIGHTS: Dict[Tuple[str, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _weights(kind: str, n: int, device: torch.device, cache: bool = True):
    """The weights, from the cache unless ``cache`` is False (a traced
    step computes them in its graph, neither reading nor filling the
    cache, so its graph does not depend on what ran before)."""
    key = (kind, n, str(device))
    w = _WEIGHTS.get(key) if cache else None
    if w is None:
        mul = _P1 if kind == "lane" else _P3
        full = ((torch.arange(n, dtype=torch.int64) * mul + _P2)
                & _MASK) | 1
        w = ((full & 0xFFFF).to(device), (full >> 16).to(device))
        if cache:
            _WEIGHTS[key] = w
    return w


def fingerprint_array(x, chunk: int = 1024) -> torch.Tensor:
    """The reference's uint32 checksum of an array's bytes, as a 0-d
    ``int64`` tensor in [0, 2**32) on the array's device (module
    docstring)."""
    t = _as_tensor(x)
    cache = not is_fake(t)
    dt_mix = zlib.crc32(_dtype_name(t.dtype).encode()) & _MASK
    u = _as_uint32(t)
    n = int(u.numel())
    meta = (n * _P2 + dt_mix) & _MASK
    if n == 0:
        return torch.full((), meta, dtype=torch.int64, device=t.device)
    pad = (-n) % chunk
    if pad:
        u = torch.cat([u, u.new_zeros(pad)])
    m = u.view(-1, chunk)
    rows = _mulmod(m, _weights("lane", chunk, t.device, cache)).sum(1)
    if chunk > 1024:
        rows = rows & _MASK   # else a row's sum stays below 2**42
    rw = _weights("row", rows.numel(), t.device, cache)
    return (_mulmod(rows, rw).sum() + meta) & _MASK


def _keystr(path: Sequence) -> str:
    """The reference's ``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves_with_path(tree, path=()):
    """(path, leaf) over a nested dict in the reference's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def fingerprint_tree(tree, chunk: int = 1024) -> Dict[str, torch.Tensor]:
    """Per-leaf fingerprints keyed by the reference's keystr path
    (``"['params']['l1.weight']"``)."""
    return {_keystr(p): fingerprint_array(v, chunk)
            for p, v in _leaves_with_path(tree)}


def count_fingerprint_collectives(graph) -> int:
    """How many fingerprint collectives (the ``MIN``/``MAX``
    ``all_reduce`` of the int64 fingerprints, tagged
    :data:`FINGERPRINT_TAG`) a traced step holds: 2 in a check step over
    replicas, 0 in a plain step (reference ``integrity.py:141``)."""
    from ..analysis.walker import walk
    n = 0
    for site in walk(graph):
        custom = site.node.meta.get("custom") or {}
        if site.is_collective and all(custom.get(k) == v for k, v in
                                      FINGERPRINT_TAG.items()):
            n += 1
    return n


# -- host content digests (the checkpoint's deep tier) ------------------------

def _host_bytes(x):
    """(dtype name, shape tuple, row-major bytes as a uint8 array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return (_dtype_name(t.dtype), tuple(t.shape),
                t.reshape(-1).view(torch.uint8).numpy())
    a = np.asarray(x)
    return str(a.dtype), a.shape, \
        np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def array_digest(x) -> str:
    """Content digest of one array (module docstring)."""
    name, shape, raw = _host_bytes(x)
    c = zlib.crc32(name.encode())
    c = zlib.crc32(repr(tuple(shape)).encode(), c)
    c = zlib.crc32(raw, c)
    return "crc32:%08x:%d" % (c & 0xFFFFFFFF, raw.size)


def _walk(tree, prefix: str, out: Dict[str, str]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = array_digest(tree)
    return out


def tree_digests(tree) -> Dict[str, str]:
    """``{dotted path: array_digest}`` over a nested dict's leaves."""
    return _walk(tree, "", {})


def compare_digests(recorded: Dict[str, str],
                    actual: Dict[str, str]) -> List[str]:
    """Keys present in both maps whose digests differ, sorted."""
    return sorted(k for k in recorded
                  if k in actual and recorded[k] != actual[k])


# -- replica geometry and quarantine ------------------------------------------

def _n_replicas(trainer) -> int:
    n = 1
    for ax in tuple(getattr(trainer, "integrity_axes", ()) or ()):
        n *= int(trainer.mesh.shape.get(ax, 1))
    return n


def replica_coords(mesh, axes: Sequence[str]) -> Dict[int, int]:
    """Process rank -> replica index over ``axes`` (the reference maps
    devices; a port replica is a rank of the axes' process group)."""
    import torch.distributed as dist
    axes = [ax for ax in axes if ax in mesh.shape]
    if not axes or mesh.axes_size(axes) <= 1:
        return {dist.get_rank() if dist.is_initialized() else 0: 0}
    ranks = dist.get_process_group_ranks(mesh.group_of(axes))
    return {int(r): i for i, r in enumerate(ranks)}


def _voting_leaves(trainer) -> List[str]:
    """Trainable parameters replicated over the check axes: their bytes
    must agree on every replica, so they vote (a ZeRO-3 leaf is a slice
    on each sharding rank and does not)."""
    split = getattr(trainer, "zero3_dims", {})
    return [k for k in trainer.params if k not in split]


def _replica_rank(trainer) -> int:
    """This rank's replica index over the check axes (data-major)."""
    return int(getattr(trainer, "replica_rank", trainer.data_rank))


def vote_outliers(chains: Dict[int, int],
                  n_rep: int) -> Tuple[List[int], bool]:
    """Majority vote over observed per-replica digest chains.

    Returns ``(outliers, quorum)``: replicas whose chain differs from the
    largest agreeing group (ties break toward the group holding replica
    0, the save-source replica), and whether that group is a provable
    majority of ALL ``n_rep`` replicas, not only of the observed ones."""
    votes: Dict[int, List[int]] = {}
    for r, c in chains.items():
        votes.setdefault(c, []).append(r)
    if len(votes) <= 1:
        return [], bool(votes) and 2 * len(chains) > n_rep
    majority = max(votes, key=lambda c: (len(votes[c]), 0 in votes[c]))
    outliers = sorted(r for c, rs in votes.items() if c != majority
                      for r in rs)
    return outliers, 2 * len(votes[majority]) > n_rep


def _local_digest_chains(trainer) -> Dict[int, int]:
    """{this rank's replica: CRC32 chain over its voting leaves' bytes, in
    :func:`_voting_leaves` order}: each rank attests the replica it
    holds."""
    crc = 0
    for name in _voting_leaves(trainer):
        _, _, raw = _host_bytes(trainer.params[name])
        crc = zlib.crc32(raw, crc)
    return {_replica_rank(trainer): crc}


def _world_digest_chains(local: Dict[int, int], mesh,
                         axes=("data",)) -> Dict[int, int]:
    """Every replica's chain, gathered over the check axes' group (the
    reference's one process observes every device of its mesh)."""
    import torch.distributed as dist
    group = mesh.group_of(axes)
    if group is None:
        return dict(local)
    views: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(views, local, group=group)
    merged: Dict[int, int] = {}
    for v in views:
        merged.update(v or {})
    return merged


def _gather_digest_chains(local: Dict[int, int], elastic) -> Dict[int, int]:
    """Merge every host's observed chains through the elastic
    coordinator's file allgather (all hosts reach this on the same check
    step). Returns the local view unchanged when no coordinator is
    reachable; the caller's quorum check then decides whether that partial
    view may evict anyone."""
    coord = getattr(elastic, "coordinator", None)
    if coord is None:
        return dict(local)
    hosts_fn = getattr(elastic, "_coord_hosts", None)
    if hosts_fn is None:
        mgr = getattr(elastic, "manager", None)
        hosts_fn = getattr(mgr, "hosts", None)
    if hosts_fn is None:
        return dict(local)
    try:
        gathered = coord.allgather(
            "integrity_digests",
            {str(r): int(c) for r, c in local.items()}, hosts_fn)
    except Exception:
        return dict(local)
    merged: Dict[int, int] = {}
    for h in sorted(gathered):
        for k, c in (gathered[h] or {}).items():
            merged.setdefault(int(k), int(c))
    merged.update(local)
    return merged


def quarantine_outliers(trainer, leaves: Optional[List[str]] = None,
                        elastic=None) -> Dict[str, Any]:
    """Which replica(s) diverged, and the action. Returns::

        {"outlier_replicas": [...], "outlier_hosts": [...],
         "quarantined": n, "action": "rollback", "abstained": False,
         "leaves": [...]}

    Every rank of the world must call it on the same check step (the
    chains are gathered over the data group). The ranks of one world are
    one host here, as one process's mesh is in the reference, so the
    action is a rollback through the restore path on every rank; eviction
    (``HostLost`` on the outlier) happens only across hosts. ``elastic``
    is accepted for the reference's signature."""
    from .. import telemetry
    n_rep = _n_replicas(trainer)
    base = {"outlier_replicas": [], "outlier_hosts": [], "quarantined": 0,
            "action": "rollback", "abstained": False,
            "leaves": list(leaves or [])}
    if n_rep <= 1:
        return base
    chains = _world_digest_chains(
        _local_digest_chains(trainer), trainer.mesh,
        tuple(getattr(trainer, "integrity_axes", ("data",))))
    outliers, _quorum = vote_outliers(chains, n_rep)
    if not outliers:
        return base
    if telemetry.enabled():
        telemetry.counter(
            "hosts_quarantined_total",
            "replicas/hosts evicted by majority-vote divergence quarantine",
        ).inc(len(outliers))
    return {"outlier_replicas": outliers, "outlier_hosts": [0],
            "quarantined": len(outliers), "action": "rollback",
            "abstained": False, "leaves": list(leaves or [])}


def inject_param_flip(trainer, seed: int = 0, step: Optional[int] = None,
                      leaf: Optional[str] = None,
                      replica: Optional[int] = None,
                      bit: Optional[int] = None) -> Dict[str, Any]:
    """Flip one low mantissa bit of one parameter element on ONE replica
    (the ``param_flip`` fault: simulated SDC from a bad chip).

    Deterministic in (seed, step), with the reference's draws: the same
    leaf, replica, bit and element. Every rank draws; only the rank
    holding the chosen replica (a non-zero one by default, so checkpoints
    saved from rank 0 stay clean) flips its bit, in place."""
    n_rep = _n_replicas(trainer)
    rng = _pyrandom.Random((int(seed) * 1000003) ^ (0 if step is None
                                                    else int(step)))
    cands = [k for k in _voting_leaves(trainer)
             if trainer.params[k].is_floating_point()]
    if not cands:
        raise ValueError("no data-replicated floating param to flip")
    name = leaf if leaf is not None else cands[rng.randrange(len(cands))]
    v = trainer.params[name]
    if replica is None:
        replica = rng.randrange(1, n_rep) if n_rep > 1 else 0
    if bit is None:
        bit = rng.randrange(0, 3)  # lowest mantissa bits
    elem = rng.randrange(max(1, v.numel()))
    if _replica_rank(trainer) == int(replica):
        lane = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            v.element_size()]
        with torch.no_grad():
            bits = v.data.view(-1).view(lane)
            i = elem % max(1, bits.numel())
            bits[i:i + 1].bitwise_xor_(1 << bit)
    return {"leaf": name, "replica": int(replica), "element": int(elem),
            "bit": int(bit)}


# -- hang watchdog --------------------------------------------------------------

# set when any watchdog fires: heartbeat pumps (the watchdog's own,
# hostsim's beat thread) stop renewing the host's liveness file, which is
# how peers learn of a wedged host
hang_event = threading.Event()


class HangWatchdog:
    """Deadline monitor around the step.

    While running, a daemon thread pumps ``heartbeat_fn`` (the elastic
    membership heartbeat) every ``poll`` seconds; if ``timeout`` passes
    between :meth:`arm` and :meth:`disarm`, it fires ONCE per arm: counts
    ``hang_watchdog_fired_total``, sets :data:`hang_event` (stopping every
    heartbeat pump in the process, so peers see this host as lost), runs
    ``on_fire(step)`` and, with ``exit_code``, ends the process with
    ``os._exit``. A fired watchdog cannot unwedge the device; eviction and
    remesh by the survivors is the recovery."""

    def __init__(self, timeout: float, heartbeat_fn: Optional[Callable] = None,
                 on_fire: Optional[Callable] = None,
                 exit_code: Optional[int] = None,
                 poll: Optional[float] = None):
        self.timeout = float(timeout)
        self.heartbeat_fn = heartbeat_fn
        self.on_fire = on_fire
        self.exit_code = exit_code
        self.poll = poll if poll is not None else max(
            0.02, min(0.25, self.timeout / 8.0))
        self.fired = 0
        self._deadline: Optional[float] = None
        self._step: Optional[int] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HangWatchdog":
        hang_event.clear()
        self._thread = threading.Thread(
            target=self._run, name="hang-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def arm(self, step: Optional[int] = None):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout
            self._step = step

    def disarm(self):
        with self._lock:
            self._deadline = None

    @contextlib.contextmanager
    def guarding(self, step: Optional[int] = None):
        self.arm(step)
        try:
            yield self
        finally:
            self.disarm()

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                deadline, step = self._deadline, self._step
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    self._deadline = None  # one fire per arm
                self._fire(step)
            elif self.heartbeat_fn is not None and not hang_event.is_set():
                try:
                    self.heartbeat_fn()
                except Exception:
                    pass
            self._stop.wait(self.poll)

    def _fire(self, step):
        from .. import telemetry
        self.fired += 1
        if telemetry.enabled():
            telemetry.counter(
                "hang_watchdog_fired_total",
                "steps whose watchdog deadline expired (host presumed hung)",
            ).inc()
        hang_event.set()
        if self.on_fire is not None:
            try:
                self.on_fire(step)
            except Exception:
                pass
        if self.exit_code is not None:
            os._exit(self.exit_code)


def simulate_hang(max_seconds: float = 120.0):
    """The ``host_hang`` fault body: block like a wedged collective until a
    watchdog fires (:data:`hang_event`) or ``max_seconds`` pass. Under
    hostsim the armed watchdog has an ``exit_code``, so the process dies
    inside this call."""
    deadline = time.monotonic() + max_seconds
    while not hang_event.is_set() and time.monotonic() < deadline:
        time.sleep(0.02)


# -- deterministic step replay --------------------------------------------------

def _fast_forward(loader, batch: int):
    """The runner's cursor semantics: skip ``batch`` items; a short epoch
    restarts the iterator."""
    it = iter(loader)
    for _ in range(batch):
        try:
            next(it)
        except StopIteration:
            return iter(loader)
    return it


def replay_step(ckpt_dir, step: int, trainer_factory: Callable,
                loader, repeats: int = 2, lr=None) -> Dict[str, Any]:
    """Re-run global step ``step`` from checkpoint ``step - 1`` and compare
    the digests of the state after it with those recorded in step
    ``step``'s manifest (a deep save).

    Each repeat builds a FRESH trainer (``trainer_factory()``), restores
    step - 1 into it, restores the saved generator states and data cursor,
    fetches the same batch with the runner's epoch rollover and runs one
    step. Verdicts:

    - ``"ok"``: the replays agree with each other and with the record;
    - ``"sdc"``: the replays agree with each other, not with the record:
      the recorded state could not come from this code on these inputs;
    - ``"nondeterminism"``: the replays disagree with each other;
    - ``"no_reference"``: the step's manifest has no array digests.
    """
    from ..distributed.checkpoint import MANIFEST_NAME, CheckpointManager
    from .runner import _meta, _set_rng_state
    if hasattr(ckpt_dir, "restore"):
        mgr = ckpt_dir
    else:
        mgr = CheckpointManager(str(ckpt_dir))
    manifest = os.path.join(mgr._step_dir(step), MANIFEST_NAME)
    try:
        with open(manifest, "r", encoding="utf-8") as f:
            recorded = json.load(f).get("arrays") or {}
    except (OSError, ValueError):
        recorded = {}
    report: Dict[str, Any] = {"step": int(step), "repeats": int(repeats),
                              "restored_from": int(step) - 1}
    if not recorded:
        report.update(verdict="no_reference", mismatched_keys=[],
                      replay_mismatch_keys=[])
        return report
    runs: List[Dict[str, str]] = []
    for _ in range(max(1, int(repeats))):
        trainer = trainer_factory()
        template = {"trainer": trainer.state,
                    "meta": _meta(0, 0, 0, trainer.device)}
        try:
            restored = mgr.restore(step=step - 1, template=template)
        except Exception:
            restored = None
        if restored is None:
            report.update(verdict="no_reference", mismatched_keys=[],
                          replay_mismatch_keys=[],
                          error="checkpoint %d unrestorable" % (step - 1))
            return report
        trainer.state = restored["trainer"]
        meta = restored["meta"]
        _set_rng_state(meta["rng"], trainer.device)
        epoch, batch = int(meta["epoch"]), int(meta["batch"])
        it = _fast_forward(loader, batch)
        try:
            inputs, labels = next(it)
        except StopIteration:
            epoch, batch = epoch + 1, 0
            it = iter(loader)
            inputs, labels = next(it)
        trainer.train_step(inputs, labels, lr=lr)
        if hasattr(trainer, "consume_divergence"):
            trainer.consume_divergence()
        runs.append(tree_digests(
            {"trainer": trainer.state,
             "meta": _meta(step, epoch, batch + 1, trainer.device)}))
        del trainer
    replay_mismatch = (compare_digests(runs[0], runs[1])
                       if len(runs) > 1 else [])
    record_mismatch = compare_digests(recorded, runs[0])
    if replay_mismatch:
        verdict = "nondeterminism"
    elif record_mismatch:
        verdict = "sdc"
    else:
        verdict = "ok"
    report.update(verdict=verdict, mismatched_keys=record_mismatch,
                  replay_mismatch_keys=replay_mismatch)
    return report
