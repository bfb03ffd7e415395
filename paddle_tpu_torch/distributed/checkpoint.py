"""Checkpoints: step-numbered saves with a two-phase commit, restore that
falls back past a torn step, and epoch-level auto-resume.

Port of the synchronous core of ``paddle_tpu/distributed/checkpoint.py``.
The reference writes through orbax; here a checkpoint is plain files.

- **Layout.** The state is a dict. A checkpoint directory holds one
  ``torch.save`` file per top-level key, ``<key>.pt``: a flat ``{dotted
  path: CPU tensor}`` dict (a top-level tensor is stored under ``""``).
  Leaves are copied to the host after one device synchronise; numbers and
  numpy arrays become tensors. :func:`load_checkpoint` reads each file
  with ``torch.load(weights_only=True)``. Given a ``template`` (the live
  state, e.g. ``trainer.state``) it rebuilds the template's structure on
  the template's device, each leaf with the dtype it was saved in (bf16
  parameters stay bf16, float32 slots float32), and raises on a missing
  path, an extra one or another shape; without one it returns the flat
  dicts by key.
- **Two-phase commit** (:class:`CheckpointManager`). A step is written
  into ``<root>/<step>.tmp-<pid>`` and renamed to ``<root>/<step>``; then
  every file is fsynced and a CRC32 ``MANIFEST.json`` is written last
  (tmp + fsync + rename + dir fsync, :func:`write_manifest`), so its
  presence proves every byte it attests reached storage.
  :func:`verify_manifest` is three-valued (True, False for a torn step,
  None without a manifest) at the ``"size"`` or ``"full"`` level.
  ``restore()`` falls back from a step that fails verification or
  raises to the newest one that restores, counting
  ``ckpt_restore_fallbacks_total{reason}``; retention keeps the newest
  ``max_to_keep`` valid steps, runs only after a verified commit and never
  removes the last valid step.
- **Byte-budgeted retry.** A save retries ``OSError`` with backoff until
  its attempts have moved ``CKPT_RETRY_BYTE_BUDGET_X`` times the state's
  bytes; past that it degrades to local staging (``staging_root()``,
  ``PADDLE_TPU_TORCH_CKPT_STAGING`` or the temporary directory), counted in
  ``ckpt_retry_bytes_abandoned_total``; ``restore()`` reads a staged step
  when no primary step restores.
- **Telemetry**: ``checkpoint_save_seconds``,
  ``checkpoint_restore_seconds``, ``checkpoint_bytes_total{op}``,
  ``ckpt_step_stall_ms`` (a synchronous save stalls the step for its whole
  wall time) and a ``checkpoint`` event per save and restore.
- :class:`TrainEpochRange` / :func:`train_epoch_range`: epoch-level
  save and resume over a manager.

Not ported yet, and raising ``NotImplementedError`` that names ROADMAP
item 25: the asynchronous commit pipeline (``async_commit=True``, its
PENDING markers, double buffer and ``dirty_probe``), an asynchronous
``save_checkpoint``, and the deep tier with its content digests
(``deep_digests``, ``deep_every``, ``deep=True``, ``prefer_deep=True``).
``use_async`` of the manager is accepted for the reference's signature and
changes nothing: every save here commits before it returns.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "TrainEpochRange", "train_epoch_range",
           "write_manifest", "verify_manifest", "MANIFEST_NAME",
           "CKPT_RETRY_BYTE_BUDGET_X", "staging_root", "STALL_BUCKETS_MS"]

MANIFEST_NAME = "MANIFEST.json"
FILE_SUFFIX = ".pt"

# ms-denominated buckets for the step-stall histogram
STALL_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

# retries may move at most this multiple of the state size before the
# save degrades to local staging (the first attempt always runs)
CKPT_RETRY_BYTE_BUDGET_X = 3.0


def _later(what: str):
    raise NotImplementedError(
        f"checkpoint: {what} is not ported yet; it waits in ROADMAP.md "
        "Queue 1, item 25 (the asynchronous commit pipeline and the deep "
        "tier)")


def staging_root() -> str:
    """Local-disk home for degraded saves: ``PADDLE_TPU_TORCH_CKPT_STAGING``
    or the temporary directory."""
    env = os.environ.get("PADDLE_TPU_TORCH_CKPT_STAGING")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(),
                        "paddle_tpu_torch_ckpt_staging")


# -- the state as files -------------------------------------------------------

def _leaf_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    if isinstance(x, (bool, int, float)):
        return torch.tensor(x)
    raise TypeError(f"checkpoint: cannot save a leaf of type {type(x)}")


def _flatten(tree, prefix: str, out: Dict[str, Any]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            _flatten(v, f"{prefix}.{k}" if prefix else k, out)
    else:
        out[prefix] = tree
    return out


def _check_state(state):
    if not isinstance(state, dict):
        raise TypeError("checkpoint: the state must be a dict of "
                        f"top-level keys, got {type(state)}")
    for key in state:
        if not isinstance(key, str) or not key or "/" in key or \
                key.startswith("."):
            raise ValueError(f"checkpoint: top-level key {key!r} cannot "
                             "name a file")


def _host_files(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """{top-level key: {dotted path: CPU tensor}}: one device synchronise,
    then a host copy of every leaf (a copy on the CPU too: the snapshot
    owns its storage, so a view does not save its whole base)."""
    _check_state(state)
    flat = {key: {p: _leaf_tensor(v)
                  for p, v in _flatten(sub, "", {}).items()}
            for key, sub in state.items()}
    if torch.cuda.is_available() and any(
            t.is_cuda for f in flat.values() for t in f.values()):
        torch.cuda.synchronize()
    return {key: {p: t.to("cpu", copy=True) for p, t in f.items()}
            for key, f in flat.items()}


def _nbytes(files) -> float:
    return float(sum(t.numel() * t.element_size()
                     for f in files.values() for t in f.values()))


def _write_dir(dest: str, files):
    """Write ``files`` into ``dest.tmp-<pid>``, then rename it to ``dest``
    (an older ``dest`` is removed first)."""
    dest = os.path.abspath(dest)
    tmp = f"{dest}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for key, flat in files.items():
        torch.save(flat, os.path.join(tmp, key + FILE_SUFFIX))
    if os.path.isdir(dest):
        shutil.rmtree(dest)
    os.replace(tmp, dest)
    _fsync_dir(os.path.dirname(dest))


def _first_device(tree) -> Optional[torch.device]:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _first_device(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


def _rebuild(template, flat: Dict[str, torch.Tensor], key: str):
    """The template's structure over the saved leaves."""
    want = _flatten(template, "", {})
    if set(want) != set(flat):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"checkpoint {key!r}: paths differ from the "
                         f"template: missing {missing[:4]}, extra "
                         f"{extra[:4]}")
    for p, t in want.items():
        shape = tuple(_leaf_tensor(t).shape)
        if tuple(flat[p].shape) != shape:
            raise ValueError(f"checkpoint {key}.{p}: shape "
                             f"{tuple(flat[p].shape)}, template {shape}")

    def build(tree, prefix):
        if isinstance(tree, dict):
            return type(tree)((k, build(v, f"{prefix}.{k}" if prefix
                                        else str(k)))
                              for k, v in tree.items())
        return flat[prefix]
    return build(template, "")


def _read_dir(path: str, template=None, map_location=None):
    path = os.path.abspath(path)
    if map_location is None and template is not None:
        map_location = _first_device(template)
    keys = sorted(n[:-len(FILE_SUFFIX)] for n in os.listdir(path)
                  if n.endswith(FILE_SUFFIX))
    if template is not None:
        _check_state(template)
        if set(keys) != set(template):
            raise ValueError(f"checkpoint {path}: keys {keys}, template "
                             f"{sorted(template)}")
    out = {}
    for key in keys:
        flat = torch.load(os.path.join(path, key + FILE_SUFFIX),
                          weights_only=True, map_location=map_location)
        if template is not None:
            out[key] = _rebuild(template[key], flat, key)
        else:
            out[key] = flat[""] if list(flat) == [""] else flat
    return type(template)((k, out[k]) for k in template) \
        if template is not None else out


# -- telemetry ------------------------------------------------------------------

def _record_stall(dt: float):
    from .. import telemetry
    if telemetry.enabled():
        telemetry.histogram(
            "ckpt_step_stall_ms",
            "time the step loop blocked on a checkpoint save (a "
            "synchronous save: the whole write and commit)",
            buckets=STALL_BUCKETS_MS).observe(dt * 1000.0)


def _save_retry_kwargs(nbytes: float) -> dict:
    """With a known state size the byte budget binds first (3 attempts,
    then degrade) and the try count is a backstop."""
    if not nbytes:
        return {"tries": 3}
    return {"tries": 6, "attempt_bytes": nbytes,
            "byte_budget": CKPT_RETRY_BYTE_BUDGET_X * nbytes}


def _count_staged(nbytes: float):
    from .. import telemetry
    if telemetry.enabled():
        telemetry.counter(
            "ckpt_retry_bytes_abandoned_total",
            "checkpoint bytes NOT re-uploaded because the retry byte "
            "budget degraded the save to local staging").inc(nbytes)


def _record(op: str, dt: float, nbytes: float, **fields):
    from .. import telemetry
    if not telemetry.enabled():
        return
    telemetry.histogram(
        f"checkpoint_{op}_seconds",
        f"checkpoint {op} wall time (host-blocking part)").observe(dt)
    if nbytes:
        telemetry.counter(
            "checkpoint_bytes_total", "checkpointed bytes").inc(
                nbytes, op=op)
    telemetry.emit("checkpoint", op=op, seconds=dt, bytes=nbytes, **fields)


# -- checksum manifest (two-phase commit) -------------------------------------

def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    try:
        _fsync_file(path)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename is atomic


def _crc_file(path: str, chunk: int = 1 << 20) -> int:
    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


def write_manifest(step_dir: str) -> dict:
    """Commit marker: fsync every file under ``step_dir``, then atomically
    write a CRC32/size manifest, last (tmp + fsync + rename + dir fsync):
    a kill at any point leaves no manifest (the step is invalid) or a
    complete one."""
    files = {}
    for root, _dirs, names in os.walk(step_dir):
        for n in sorted(names):
            if n in (MANIFEST_NAME, MANIFEST_NAME + ".tmp"):
                continue
            p = os.path.join(root, n)
            _fsync_file(p)  # durability before attestation
            files[os.path.relpath(p, step_dir)] = {
                "size": os.path.getsize(p), "crc32": _crc_file(p)}
    manifest = {"version": 1, "files": files}
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(step_dir, MANIFEST_NAME))
    _fsync_dir(step_dir)
    return manifest


def verify_manifest(step_dir: str, level: str = "full") -> Optional[bool]:
    """True: the manifest is present and every attested file matches;
    False: the manifest is unreadable, or a file is missing or differs (a
    torn checkpoint); None: no manifest. ``level="size"`` checks existence
    and byte size only (a stat per file); ``"full"`` also re-CRCs every
    file."""
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    for rel, meta in manifest.get("files", {}).items():
        p = os.path.join(step_dir, rel)
        try:
            if os.path.getsize(p) != meta["size"]:
                return False
            if level != "size" and _crc_file(p) != meta["crc32"]:
                return False
        except OSError:
            return False
    return True


def _corrupt_one_file(step_dir: str):
    """Fault injection (``ckpt_torn``): truncate the largest data file, what
    a machine lost mid-flush leaves."""
    best, size = None, -1
    for root, _dirs, names in os.walk(step_dir):
        for n in names:
            p = os.path.join(root, n)
            s = os.path.getsize(p)
            if s > size:
                best, size = p, s
    if best is not None:
        with open(best, "r+b") as f:
            f.truncate(max(1, size // 2))


def _stage_save(dest: str, files, nbytes: float, err: BaseException) -> str:
    """The degraded save: a plain write onto local disk, no fault hooks
    and no retry, manifested like a committed step."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    _write_dir(dest, files)
    write_manifest(dest)
    _count_staged(nbytes)
    warnings.warn(
        f"checkpoint save exceeded its retry byte budget ({err}); "
        f"staged to local disk at {dest}", RuntimeWarning)
    return dest


# -- one-shot save and load -----------------------------------------------------

def save_checkpoint(path: str, state: Dict[str, Any], overwrite: bool = True,
                    use_async: bool = False,
                    staging_dir: Optional[str] = None) -> str:
    """Save ``state`` (a dict of tensor trees) as a checkpoint directory.
    Retries are byte-budgeted; past the budget the save lands in
    ``staging_dir`` (default ``staging_root()/<basename(path)>``). Returns
    the directory written."""
    from ..resilience import faults
    from ..resilience.retry import RetryBytesExhausted, call_with_retry
    if use_async:
        _later("save_checkpoint(use_async=True)")
    path = os.path.abspath(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists")
    t0 = time.perf_counter()
    files = _host_files(state)
    nbytes = _nbytes(files)

    def _write():
        faults.maybe_raise("ckpt_io", site="save_checkpoint",
                           msg="injected ckpt_io on save")
        _write_dir(path, files)

    out = path
    try:
        call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                        **_save_retry_kwargs(nbytes))
    except RetryBytesExhausted as e:
        out = staging_dir or os.path.join(staging_root(),
                                          os.path.basename(path))
        _stage_save(out, files, nbytes, e)
    dt = time.perf_counter() - t0
    _record("save", dt, nbytes)
    _record_stall(dt)
    return out


def load_checkpoint(path: str, template: Optional[Dict[str, Any]] = None,
                    map_location=None):
    """Read a checkpoint directory: with ``template``, the template's
    structure on its device (or ``map_location``); without, the flat
    ``{dotted path: tensor}`` dict of each top-level key (a bare tensor
    where the key held one)."""
    from ..resilience.retry import call_with_retry
    t0 = time.perf_counter()
    out = call_with_retry(_read_dir, path, template, map_location,
                          site="ckpt_restore", tries=2, base_delay=0.01)
    _record("restore", time.perf_counter() - t0, _tree_nbytes(out))
    return out


def _tree_nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in _flatten(tree, "", {}).values()
                     if isinstance(t, torch.Tensor)))


# -- the manager ----------------------------------------------------------------

class CheckpointManager:
    """Step-numbered checkpoints under ``directory`` with retention, a save
    interval and the two-phase commit (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, use_async: bool = True,
                 staging_dir: Optional[str] = None,
                 deep_digests: bool = False, async_commit: bool = False,
                 deep_every: int = 0, dirty_probe=None,
                 commit_delay: float = 0.0):
        if async_commit or dirty_probe is not None or commit_delay:
            _later("the asynchronous commit pipeline (async_commit, "
                   "dirty_probe, commit_delay)")
        if deep_digests or deep_every:
            _later("the deep tier (deep_digests, deep_every)")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._staging = staging_dir or os.path.join(
            staging_root(), os.path.basename(self._dir))
        self._max_to_keep = max_to_keep
        self._save_interval = max(1, int(save_interval_steps))
        self._vcache: Dict[int, Optional[bool]] = {}
        self.restore_fallbacks_total = 0   # torn steps skipped over
        self.last_restored_step: Optional[int] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _staged_step_dir(self, step: int) -> str:
        return os.path.join(self._staging, str(step))

    @staticmethod
    def _steps_in(root: str) -> List[int]:
        if not os.path.isdir(root):
            return []
        return sorted(int(n) for n in os.listdir(root)
                      if n.isdigit() and os.path.isdir(os.path.join(root, n)))

    def all_steps(self) -> List[int]:
        return self._steps_in(self._dir)

    def staged_steps(self) -> List[int]:
        """Steps that degraded to local staging (newest last)."""
        return self._steps_in(self._staging)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _verify(self, step: int) -> Optional[bool]:
        if step not in self._vcache:
            self._vcache[step] = verify_manifest(self._step_dir(step))
        return self._vcache[step]

    def _delete(self, step: int):
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        self._vcache.pop(step, None)

    def _gc(self):
        """Retention after a verified commit: keep the newest
        ``max_to_keep`` valid steps and delete the rest (torn debris
        included); if nothing verifies, delete nothing."""
        if not self._max_to_keep:
            return
        steps = self.all_steps()
        valid = [s for s in steps if self._verify(s) is not False]
        if not valid:
            return
        keep = set(valid[-self._max_to_keep:])
        for s in steps:
            if s not in keep:
                self._delete(s)

    def save(self, step: int, state: Dict[str, Any],
             deep: Optional[bool] = None) -> bool:
        """Persist ``state`` as ``step`` and commit it; False when the
        save interval or an existing newer step skips it. A step that
        exists already (a restart replaying it) is replaced."""
        from ..resilience import faults
        from ..resilience.retry import RetryBytesExhausted, call_with_retry
        if deep:
            _later("save(deep=True)")
        step = int(step)
        if step in self.all_steps():
            self._delete(step)
        latest = self.latest_step()
        if (latest is not None and latest >= step) or \
                step % self._save_interval:
            return False
        t0 = time.perf_counter()
        files = _host_files(state)
        nbytes = _nbytes(files)
        sdir = self._step_dir(step)

        def _write():
            faults.maybe_raise("ckpt_io", step=step, site="manager_save",
                               msg=f"injected ckpt_io at step {step}")
            _write_dir(sdir, files)

        try:
            call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                            **_save_retry_kwargs(nbytes))
        except RetryBytesExhausted as e:
            # the primary directory is too costly to keep re-writing:
            # stage locally; restore() reads staged steps only when no
            # primary step restores
            _stage_save(self._staged_step_dir(step), files, nbytes, e)
        else:
            if faults.fires("ckpt_torn", step=step, site="ckpt_commit"):
                _corrupt_one_file(sdir)
                self._vcache.pop(step, None)
                raise faults.SimulatedCrash(
                    f"simulated kill -9 committing checkpoint step {step}")
            write_manifest(sdir)
            self._vcache[step] = True
            self._gc()
        dt = time.perf_counter() - t0
        _record("save", dt, nbytes, step=step)
        _record_stall(dt)  # a synchronous save stalls the step for its wall
        return True

    def _count_fallbacks(self, n: int, reason: str = "manifest"):
        if not n:
            return
        self.restore_fallbacks_total += n
        from .. import telemetry
        if telemetry.enabled():
            telemetry.counter(
                "ckpt_restore_fallbacks_total",
                "restores that skipped corrupt/torn checkpoints").inc(
                    n, reason=reason)

    def _restore_dir(self, path: str, template, step: int):
        from ..resilience.retry import call_with_retry
        t0 = time.perf_counter()
        out = call_with_retry(_read_dir, path, template, None,
                              site="ckpt_restore", tries=2, base_delay=0.01)
        _record("restore", time.perf_counter() - t0, _tree_nbytes(out),
                step=step)
        self.last_restored_step = step
        return out

    def verify(self, step: int, deep: bool = False) -> Optional[bool]:
        """Re-verify a committed step's files (size and CRC32) from disk."""
        if deep:
            _later("verify(deep=True)")
        self._vcache.pop(step, None)
        return self._verify(step)

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None,
                deep: bool = False, prefer_deep: bool = False):
        """Read ``step`` (verified, no fallback), or without one the newest
        step that verifies and reads, then the newest staged one; None when
        nothing restores. ``template``: as :func:`load_checkpoint`."""
        if deep or prefer_deep:
            _later("restore(deep=True / prefer_deep=True)")
        if step is not None:
            self._vcache.pop(step, None)
            if self._verify(step) is False:
                raise OSError(
                    f"checkpoint step {step} failed manifest verification")
            return self._restore_dir(self._step_dir(step), template, step)
        for s in reversed(self.all_steps()):
            self._vcache.pop(s, None)
            if self._verify(s) is False:
                self._count_fallbacks(1, reason="manifest")
                continue
            try:
                return self._restore_dir(self._step_dir(s), template, s)
            except Exception:  # noqa: BLE001 — any unreadable step falls back
                self._count_fallbacks(1, reason="restore")
        for s in reversed(self.staged_steps()):
            sdir = self._staged_step_dir(s)
            if verify_manifest(sdir) is False:
                self._count_fallbacks(1, reason="staged")
                continue
            try:
                return self._restore_dir(sdir, template, s)
            except Exception:  # noqa: BLE001
                self._count_fallbacks(1, reason="staged")
        return None

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes (or predates) manifest verification: a
        size-only pass rejects truncated or missing files before the full
        CRC pass."""
        for s in reversed(self.all_steps()):
            if verify_manifest(self._step_dir(s), level="size") is False:
                self._vcache[s] = False
                continue
            if self._verify(s) is not False:
                return s
        return None

    def wait_until_finished(self):
        """Every save commits before it returns: nothing to wait for."""

    def close(self):
        """Nothing stays open between saves."""


class TrainEpochRange:
    """Epoch-level checkpoint and resume over :class:`CheckpointManager`.

    Usage::

        r = TrainEpochRange(max_epoch, name, checkpoint_dir=...)
        for epoch in r.get():          # resumes after the last saved epoch
            ...train...
            r.save(trainer.state)
        restored = r.restored_state    # non-None when resuming
    """

    def __init__(self, max_epoch_num: int, name: str,
                 checkpoint_dir: Optional[str] = None, save_last_only=False,
                 template: Optional[Dict[str, Any]] = None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        base = checkpoint_dir or os.environ.get(
            "PADDLE_AUTO_CHECKPOINT_DIR", "./auto_checkpoint")
        job = os.environ.get("PADDLE_JOB_ID", "job_default")
        self._dir = os.path.join(base, job, name)
        self._mngr = CheckpointManager(
            self._dir, max_to_keep=1 if save_last_only else 2,
            use_async=False)
        self._epoch = -1
        last = self._mngr.latest_step()
        self.restored_state = None
        if last is not None:
            self._epoch = last
            self.restored_state = self._mngr.restore(last, template=template)

    def get(self):
        for e in range(self._epoch + 1, self.max_epoch_num):
            self._epoch = e
            yield e

    def save(self, state: Dict[str, Any]):
        self._mngr.save(self._epoch, state)


def train_epoch_range(max_epoch_num: int, name: str = "default",
                      get_state=None, **kwargs):
    """Generator form: with ``get_state`` (a callable returning the state)
    the state is saved at each epoch's end; without it nothing is saved."""
    r = TrainEpochRange(max_epoch_num, name, **kwargs)
    for e in r.get():
        yield e
        if get_state is not None:
            r.save(get_state())
