"""Checkpoints: step-numbered saves with a two-phase commit, an
asynchronous commit pipeline, a deep tier of content digests, restore that
falls back past a torn step, and epoch-level auto-resume.

Port of ``paddle_tpu/distributed/checkpoint.py``. The reference writes
through orbax; here a checkpoint is plain files.

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
- **Asynchronous commit** (``async_commit=True``). ``save()`` copies the
  state into a host buffer and returns; a committer thread runs the whole
  commit (write, fsync, CRC, manifest, retention). On the card the copy
  is enqueued on the current stream without a wait, into pinned buffers
  that later saves reuse, so the next step's in-place writes are ordered
  after it; the committer waits on the copy's event before it reads. One
  snapshot is committing and one is staged: a newer snapshot supersedes
  the staged one (``ckpt_suppressed_total{reason="superseded"}``) and the
  step loop never waits on a commit. ``dirty_probe`` is asked at commit
  time: True keeps that snapshot off the disk (``reason="dirty"``). Every
  snapshot ends as committed, superseded, suppressed, failed or
  abandoned (``accounted()``). Before writing step N the committer
  durably writes a ``PENDING.N`` marker in the root and removes it after
  the manifest: a step with a marker and no manifest is an aborted commit,
  which restores skip without counting a fallback and retention removes.
  A committer's error is raised at ``flush()`` (which ``restore()``,
  ``wait_until_finished()`` and ``close()`` call): the injected kill
  (``SimulatedCrash``) as itself, any other as a RuntimeWarning counted in
  ``failed_total``. ``PADDLE_TPU_TORCH_TEST_COMMIT_CRASH=<step>`` (a chaos
  test hook) makes the committer ``SIGKILL`` its own process after step
  ``<step>``'s payload is written and before its manifest.
- **Deep tier.** ``deep_digests=True`` or ``deep_every=M`` (every M-th
  save, the first included) records each array's content digest
  (``resilience/integrity.py``) in the manifest, from the host snapshot
  (on the committer thread for an asynchronous save). ``verify(step,
  deep=True)`` reads the step back and re-hashes it, catching a
  corruption the file CRCs were rewritten over; ``restore(deep=True)``
  falls back past a step whose values fail (``reason="deep"``), and
  ``restore(prefer_deep=True)`` takes the newest deep step that verifies
  before any cheap one.
- **Telemetry**: ``checkpoint_save_seconds``,
  ``checkpoint_restore_seconds``, ``checkpoint_bytes_total{op}``,
  ``ckpt_step_stall_ms`` (the time the step loop blocked: a synchronous
  save's whole wall time, an asynchronous save's snapshot), with
  :func:`stall_seconds`, the process's total, and
  :class:`attributing_stall`; ``ckpt_snapshot_ms``, ``ckpt_commit_ms``,
  the ``ckpt_inflight`` gauge; a ``checkpoint`` event per save and
  restore, ``ckpt_snapshot`` and ``ckpt_commit`` events, and a
  ``ckpt_save`` trace whose commit span ends on the committer thread.
- **The one directory of a world**, the port's form of the reference's
  orbax checkpoint of logical arrays (``checkpoint.py:389-450``). The
  format follows the state: a :class:`ShardedState` (``trainer.state``)
  whose mesh spans 2+ ranks, saved by every rank of it into the same
  directory, is written as one directory of the world; its ``layout``
  gives each split leaf's :class:`Piece` of its logical array (a ZeRO
  slice, a residual row), and every other leaf is replicated. Each rank
  writes the pieces it owns with their ranges into
  ``shards-<r>-of-<n>.pt`` (a replicated leaf by rank 0 only, a slice by
  the first data rank holding it, a residual row by its owner), rank 0
  writes ``LAYOUT.json`` (each leaf's logical shape and dtype), and after
  a barrier rank 0 checks that every rank's file is there, renames the
  step into place and writes the manifest (the deep tier's digests are
  the pieces', keyed ``<key>/<path>@<rank>``). Ranks that each name their
  own directory write their own state in the one-rank format instead,
  unless it holds ZeRO slices (only a world's directory places them):
  that raises, as does a directory some ranks share and others do not. A read, given
  a template, assembles each of the template's own pieces from the
  stored pieces that overlap it (the shard files are memory-mapped, so a
  rank reads those ranges only), so a restore onto another ``data`` x
  ``sharding`` layout (one process included) takes each rank's slice, as
  orbax reshards to its template; without a template it assembles the
  logical arrays. The manager keeps its manifests, CRCs, torn-step
  fallback, retention (rank 0), deep tier and asynchronous commit (each
  rank's committer writes its file into a directory named from rank 0;
  rank 0's waits for every rank's file, then seals; a staged snapshot is
  never superseded, and ``flush`` ends in a barrier). An armed
  ``ckpt_torn`` tears the step on rank 0 and raises ``SimulatedCrash`` on
  every rank. Past the retry budget a world's save raises: its pieces
  cannot stage on one host.
- ``save_checkpoint(use_async=True)`` returns an :class:`AsyncSave` after
  the host copy; the module keeps one such write in flight.
- :class:`TrainEpochRange` / :func:`train_epoch_range`: epoch-level
  save and resume over a manager.

``use_async`` of the manager is accepted for the reference's signature
(there it selects orbax's own asynchronous writer) and changes nothing;
``async_commit`` is the pipeline.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..resilience.integrity import (array_digest, compare_digests,
                                    tree_digests)

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncSave", "Piece",
           "ShardedState", "is_sharded_dir", "LAYOUT_NAME",
           "CheckpointManager", "TrainEpochRange", "train_epoch_range",
           "write_manifest", "verify_manifest", "MANIFEST_NAME",
           "PENDING_PREFIX", "CKPT_RETRY_BYTE_BUDGET_X", "staging_root",
           "stall_seconds", "attributing_stall", "STALL_BUCKETS_MS"]

MANIFEST_NAME = "MANIFEST.json"
PENDING_PREFIX = "PENDING."
FILE_SUFFIX = ".pt"

# ms-denominated buckets for the step-stall histogram
STALL_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

# retries may move at most this multiple of the state size before the
# save degrades to local staging (the first attempt always runs)
CKPT_RETRY_BYTE_BUDGET_X = 3.0


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
    if is_sharded_dir(path):
        return _read_world(path, template, map_location)
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


# -- the one directory of a world -------------------------------------------------

class Piece(NamedTuple):
    """Where one rank's leaf sits in its logical array (the reference's
    global ``jax.Array``): ``shape`` is the logical shape; the leaf is
    chunk ``index`` of ``count`` along ``dim`` (with ``row``, row
    ``index`` of a ``(count, *leaf.shape)`` array), and also chunk ``i``
    of ``c`` along ``d`` for each ``(d, i, c)`` of ``extra`` (a leaf split
    over several axes: a tensor-parallel slice of a pipeline stage's
    members; dims of the logical array); ``write`` says whether this rank
    writes it (one writer per set of equal copies)."""
    shape: Tuple[int, ...]
    dim: int
    index: int
    count: int
    row: bool
    write: bool
    extra: Tuple[Tuple[int, int, int], ...] = ()


class ShardedState(dict):
    """A state dict that knows its placement: ``layout`` maps a leaf's
    dotted path to its :class:`Piece` (a path it does not list is the
    whole array, replicated on every rank and written by rank 0), and
    ``world`` is the mesh the state lives on (its ``rank``, ``size`` and
    whole-mesh group)."""
    layout: Dict[str, Piece] = {}
    world = None

    def subset(self, keys) -> "ShardedState":
        """The top-level ``keys`` of this state, with their pieces."""
        out = ShardedState((k, self[k]) for k in keys)
        out.layout = {p: pc for p, pc in self.layout.items()
                      if p.split(".", 1)[0] in out}
        out.world = self.world
        return out


LAYOUT_NAME = "LAYOUT.json"
# how long rank 0's committer waits for the other ranks' shard files
WORLD_PARTS_TIMEOUT_S = 600.0


def _shard_file(rank: int, size: int) -> str:
    return f"shards-{rank:05d}-of-{size:05d}{FILE_SUFFIX}"


def is_sharded_dir(path: str) -> bool:
    """Whether ``path`` holds a world's checkpoint (a ``LAYOUT.json``)."""
    return os.path.exists(os.path.join(path, LAYOUT_NAME))


class _World:
    """Rank, size and the collectives of the mesh a state lives on."""

    def __init__(self, mesh):
        self.rank = int(getattr(mesh, "rank", 0)) if mesh is not None else 0
        self.size = int(getattr(mesh, "size", 1)) if mesh is not None else 1
        self.group = None
        self.src = 0
        if self.size > 1:
            import torch.distributed as dist
            from .mesh import AXES_ORDER
            self.group = mesh.group_of(AXES_ORDER)
            self.src = dist.get_global_rank(self.group, 0) \
                if self.group is not dist.group.WORLD else 0

    def barrier(self):
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def from_rank0(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _find_world(tree):
    """The mesh of the first :class:`ShardedState` in ``tree`` (None)."""
    if isinstance(tree, ShardedState) and tree.world is not None:
        return tree.world
    if isinstance(tree, dict):
        for v in tree.values():
            w = _find_world(v)
            if w is not None:
                return w
    return None


def _world_of(state, path: str) -> Optional[_World]:
    """The world that writes ``path`` as its one directory: the mesh of
    the first :class:`ShardedState` in ``state`` when it spans 2+ ranks and
    every rank of it names the same ``path`` (a collective of the mesh).
    None: the one-rank format (no such mesh, or each rank names its own
    directory and writes its own state there: replicated leaves and its
    own residual rows). On every rank, raises for a directory that some
    ranks share and others do not, and for a directory each when the
    state holds ZeRO slices, which only a world's directory places."""
    mesh = _find_world(state)
    if mesh is None or int(getattr(mesh, "size", 1)) < 2:
        return None
    world = _World(mesh)
    paths = world.gather(os.path.abspath(path))
    if len(set(paths)) == 1:
        return world
    if len(set(paths)) < len(paths):
        raise ValueError("checkpoint: the ranks of a mesh save into one "
                         "directory, or each into its own; got "
                         f"{sorted(set(paths))[:4]} over {len(paths)} ranks")
    sliced = sorted(p for p, pc in _layout_of(state, "", {}).items()
                    if (pc.dim >= 0 and not pc.row) or pc.extra)
    if sliced:
        raise ValueError("checkpoint: a state with ZeRO slices (e.g. "
                         f"{sliced[:2]}) is saved by every rank into one "
                         "directory, the world's; got a directory a rank")
    return None


def _layout_of(tree, prefix: str, out: Dict[str, Piece]):
    """Every :class:`ShardedState`'s pieces in ``tree``, by full dotted
    path."""
    if isinstance(tree, dict):
        if isinstance(tree, ShardedState):
            for p, pc in tree.layout.items():
                out[f"{prefix}.{p}" if prefix else p] = pc
        for k, v in tree.items():
            _layout_of(v, f"{prefix}.{k}" if prefix else str(k), out)
    return out


def _entries(state) -> Dict[str, Tuple[str, Any, Optional[Piece]]]:
    """``{"<key>/<path>": (dotted path, leaf, piece or None)}`` over the
    top-level keys of ``state``."""
    _check_state(state)
    layout = _layout_of(state, "", {})
    out = {}
    for key, sub in state.items():
        for p, v in _flatten(sub, "", {}).items():
            dotted = f"{key}.{p}" if p else key
            out[f"{key}/{p}"] = (dotted, v, layout.get(dotted))
    return out


def _piece_box(pc: Optional[Piece], shape) -> List[List[int]]:
    """[[start, stop]] per dim: the part of its logical array of ``shape``
    that a piece covers (None: all of it)."""
    box = [[0, int(n)] for n in shape]
    if pc is None:
        return box
    for d, i, c in ((pc.dim, pc.index, pc.count),) + tuple(pc.extra):
        if d >= 0:
            step = int(shape[d]) // c
            box[d] = [i * step, (i + 1) * step]
    return box


class _WorldPart(dict):
    """A rank's staged part of a world's asynchronous save."""


def _world_snapshot(state, world: _World):
    """This rank's part of a world checkpoint: the pieces it writes (host
    copies, after one device synchronise), their ranges, and every leaf's
    logical shape and dtype."""
    entries = _entries(state)
    leaves, pieces, index = {}, {}, {}
    for ekey, (_, v, pc) in entries.items():
        t = _leaf_tensor(v)
        shape = tuple(pc.shape) if pc is not None else tuple(t.shape)
        leaves[ekey] = {"shape": list(shape),
                        "dtype": str(t.dtype).replace("torch.", "")}
        write = pc.write if pc is not None else world.rank == 0
        if write:
            pieces[ekey] = t.unsqueeze(0) if (pc is not None and pc.row) \
                else t
            index[ekey] = _piece_box(pc, shape)
    if torch.cuda.is_available() and any(
            t.is_cuda for t in pieces.values()):
        torch.cuda.synchronize()
    pieces = {k: t.to("cpu", copy=True) for k, t in pieces.items()}
    return {"pieces": pieces, "index": index, "leaves": leaves,
            "keys": list(state)}


def _write_world_part(tmp: str, world: _World, part: dict,
                      digests: Optional[dict] = None):
    """Write this rank's shard file (and rank 0 the layout) into ``tmp``;
    each file lands whole (written beside, then renamed)."""
    name = _shard_file(world.rank, world.size)
    torch.save({"pieces": part["pieces"], "index": part["index"]},
               os.path.join(tmp, name + ".part"))
    os.replace(os.path.join(tmp, name + ".part"), os.path.join(tmp, name))
    if digests is not None:
        _write_json(os.path.join(tmp, f"digests-{world.rank:05d}.json"),
                    digests)
    if world.rank == 0:
        _write_json(os.path.join(tmp, LAYOUT_NAME),
                    {"format": "sharded", "version": 1,
                     "world": world.size, "keys": part["keys"],
                     "leaves": part["leaves"]})


def _write_json(path: str, obj):
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".part", path)


def _part_digests(part: dict, rank: int) -> Dict[str, str]:
    return {f"{k}@{rank}": array_digest(t) for k, t in part["pieces"].items()}


def _missing_parts(tmp: str, size: int) -> List[str]:
    """The ranks' shard files not (yet) in ``tmp``."""
    return [n for n in (_shard_file(r, size) for r in range(size))
            if not os.path.exists(os.path.join(tmp, n))]


def _wait_parts(tmp: str, size: int, timeout: float):
    """Rank 0: wait until every rank's shard file is in ``tmp``."""
    deadline = time.monotonic() + timeout
    while _missing_parts(tmp, size):
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint {tmp}: shard files "
                               f"{_missing_parts(tmp, size)} not written "
                               f"after {timeout} s")
        time.sleep(0.01)


def _seal_world(tmp: str, dest: str) -> Optional[dict]:
    """Rank 0: rename the finished ``tmp`` to ``dest`` (an older ``dest``
    removed first) and return the merged piece digests (None: none
    recorded)."""
    arrays = {}
    for n in sorted(os.listdir(tmp)):
        if n.startswith("digests-"):
            with open(os.path.join(tmp, n)) as f:
                arrays.update(json.load(f))
            os.remove(os.path.join(tmp, n))
        elif n.endswith(".part"):
            os.remove(os.path.join(tmp, n))
    if os.path.isdir(dest):
        shutil.rmtree(dest)
    os.replace(tmp, dest)
    _fsync_dir(os.path.dirname(dest))
    return arrays or None


def _box(shape, dim: int, a: int, b: int):
    """[(start, stop)] per dim: the part of an array of ``shape`` that a
    range ``[a, b)`` along ``dim`` covers (``dim`` -1: all of it)."""
    return [(a, b) if i == dim else (0, int(n)) for i, n in enumerate(shape)]


def _world_index(path: str):
    """(layout, {ekey: [(box, tensor, rank)]}) of a world's directory. The
    shard files are memory-mapped: a piece's bytes are read when a range
    of it is copied."""
    with open(os.path.join(path, LAYOUT_NAME)) as f:
        layout = json.load(f)
    size = int(layout["world"])
    index: Dict[str, list] = {}
    for r in range(size):
        blob = torch.load(os.path.join(path, _shard_file(r, size)),
                          weights_only=True, map_location="cpu", mmap=True)
        for ekey, t in blob["pieces"].items():
            where = blob["index"][ekey]
            shape = layout["leaves"][ekey]["shape"]
            # a box per dim, or (the format before multi-axis pieces) one
            # (dim, start, stop)
            box = ([tuple(int(x) for x in ab) for ab in where]
                   if not where or isinstance(where[0], (list, tuple))
                   else _box(shape, *(int(x) for x in where)))
            index.setdefault(ekey, []).append((box, t, r))
    return layout, index


def _copy_overlap(dst, dst_box, src, src_box) -> int:
    """Copy where two boxes of one logical array meet; the count copied."""
    for i, ((da, db), (sa, sb)) in enumerate(zip(dst_box, src_box)):
        lo, hi = max(da, sa), min(db, sb)
        if hi <= lo:
            return 0
        dst = dst.narrow(i, lo - da, hi - lo)
        src = src.narrow(i, lo - sa, hi - lo)
    dst.copy_(src)
    return dst.numel()


def _assemble(ekey: str, meta: dict, pieces, box) -> torch.Tensor:
    """The part ``box`` of leaf ``ekey``'s logical array, from the stored
    pieces that overlap it; a part some element of which no piece covers
    raises."""
    out = torch.empty(tuple(b - a for a, b in box),
                      dtype=getattr(torch, meta["dtype"]))
    covered = sum(_copy_overlap(out, box, t, pbox)
                  for pbox, t, _ in pieces)
    if covered < out.numel():
        raise ValueError(f"checkpoint: no piece covers part of {ekey}")
    return out


def _read_world(path: str, template=None, map_location=None):
    """A world's directory: with ``template``, its structure with each leaf
    assembled where the template's layout places it (any ``data`` x
    ``sharding`` layout), from the pieces that overlap it; without, the
    logical arrays as ``{key: {dotted path: tensor}}``."""
    path = os.path.abspath(path)
    layout, index = _world_index(path)
    leaves = layout["leaves"]
    if template is None:
        out = {}
        for ekey, meta in leaves.items():
            key, p = ekey.split("/", 1)
            out.setdefault(key, {})[p] = _assemble(
                ekey, meta, index.get(ekey, ()), _box(meta["shape"], -1, 0, 0))
        return {k: (v[""] if list(v) == [""] else v) for k, v in out.items()}
    if map_location is None:
        map_location = _first_device(template)
    entries = _entries(template)
    if set(entries) != set(leaves):
        missing = sorted(set(entries) - set(leaves))
        extra = sorted(set(leaves) - set(entries))
        raise ValueError(f"checkpoint {path}: paths differ from the "
                         f"template: missing {missing[:4]}, extra {extra[:4]}")
    local = {}
    for ekey, (dotted, v, pc) in entries.items():
        meta = leaves[ekey]
        want = tuple(pc.shape) if pc is not None else \
            tuple(_leaf_tensor(v).shape)
        if tuple(meta["shape"]) != want:
            raise ValueError(f"checkpoint {dotted}: logical shape "
                             f"{tuple(meta['shape'])}, template {want}")
        t = _assemble(ekey, meta, index.get(ekey, ()),
                      [tuple(ab) for ab in _piece_box(pc, want)])
        if pc is not None and pc.row:
            t = t[0]
        local[dotted] = t.to(map_location) if map_location is not None \
            else t

    def build(tree, prefix):
        if isinstance(tree, dict):
            return dict((k, build(v, f"{prefix}.{k}" if prefix else str(k)))
                        for k, v in tree.items())
        return local[prefix]
    return {k: build(template[k], k) for k in template}


def _world_digests(path: str) -> Dict[str, str]:
    """Each piece's content digest, as a deep save records them."""
    _, index = _world_index(path)
    return {f"{ekey}@{r}": array_digest(t)
            for ekey, pieces in index.items() for _, t, r in pieces}


def _write_world(tmp: str, state, world: _World, deep: bool,
                 step: Optional[int], site: str) -> float:
    """Every rank: rank 0 clears ``tmp``, each rank writes its pieces (and
    with ``deep`` their digests) into it, retried and byte-budgeted;
    barriers before and after. Returns this rank's bytes."""
    from ..resilience import faults
    from ..resilience.retry import call_with_retry
    if world.rank == 0:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    world.barrier()
    part = _world_snapshot(state, world)
    digests = _part_digests(part, world.rank) if deep else None

    def _write():
        faults.maybe_raise("ckpt_io", step=step, site=site,
                           msg=f"injected ckpt_io at {site}")
        _write_world_part(tmp, world, part, digests)

    nbytes = _part_nbytes(part)
    call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                    **_save_retry_kwargs(nbytes))
    world.barrier()
    missing = _missing_parts(tmp, world.size) if world.rank == 0 else None
    missing = world.from_rank0(missing)
    if missing:
        raise OSError(f"checkpoint {tmp}: rank 0 does not see the shard "
                      f"files {missing[:4]}; the ranks of a world save into "
                      "one directory that every rank can read")
    return nbytes


def _save_world(path: str, state, world: _World) -> str:
    """A world's one-shot save (every rank calls it): the pieces into
    ``<path>.tmp-world``, then rank 0 renames it into place."""
    path = os.path.abspath(path)
    world.barrier()
    _write_world(f"{path}.tmp-world", state, world, False, None,
                 "save_checkpoint")
    if world.rank == 0:
        _seal_world(f"{path}.tmp-world", path)
    world.barrier()
    return path


def _part_nbytes(part) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in part["pieces"].values()))


# -- telemetry ------------------------------------------------------------------

_stall_lock = threading.Lock()
_stall_seconds_total = 0.0


def stall_seconds() -> float:
    """Seconds the step loop has blocked on checkpoint saves in this
    process: a step-time reading diffs it across its window to leave the
    save's stall out."""
    with _stall_lock:
        return _stall_seconds_total


def _record_stall(dt: float):
    """``dt`` seconds of the step loop blocked on a save: the
    ``ckpt_step_stall_ms`` histogram and the process's ledger."""
    global _stall_seconds_total
    with _stall_lock:
        _stall_seconds_total += dt
    from .. import telemetry
    if telemetry.enabled():
        telemetry.histogram(
            "ckpt_step_stall_ms",
            "time the step loop blocked on a checkpoint save (asynchronous: "
            "the snapshot; synchronous: the whole write and commit)",
            buckets=STALL_BUCKETS_MS).observe(dt * 1000.0)


class attributing_stall:
    """Context manager: the block's wall time counts as checkpoint stall
    (for save paths outside this module)."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _record_stall(time.perf_counter() - self._t0)
        return False


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


def write_manifest(step_dir: str, arrays: Optional[dict] = None) -> dict:
    """Commit marker: fsync every file under ``step_dir``, then atomically
    write a CRC32/size manifest, last (tmp + fsync + rename + dir fsync):
    a kill at any point leaves no manifest (the step is invalid) or a
    complete one. ``arrays`` (dotted path -> content digest) goes under
    ``"arrays"``: the file CRCs attest the bytes on disk, the digests the
    values they decode to (the deep tier)."""
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
    if arrays:
        manifest["arrays"] = dict(arrays)
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


# -- intent markers of the asynchronous commit ----------------------------------

def _pending_marker(root: str, step: int) -> str:
    return os.path.join(root, PENDING_PREFIX + str(step))


def _write_pending_marker(root: str, step: int):
    """Record durably that ``step`` is being committed, before any byte of
    it is written (the marker fsynced, then the root): a step found with
    a marker and no manifest is an aborted commit, never a committed
    step."""
    path = _pending_marker(root, step)
    with open(path, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(root)


def _clear_pending_marker(root: str, step: int):
    try:
        os.remove(_pending_marker(root, step))
    except OSError:
        pass


def _is_uncommitted(root: str, step: int) -> bool:
    """An aborted asynchronous commit: a marker and no manifest (a marker
    beside a manifest is a commit that finished before its marker went;
    retention clears it)."""
    return (os.path.exists(_pending_marker(root, step))
            and not os.path.exists(
                os.path.join(root, str(step), MANIFEST_NAME)))


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


def _stage_save(dest: str, files, nbytes: float, err: BaseException,
                arrays: Optional[dict] = None) -> str:
    """The degraded save: a plain write onto local disk, no fault hooks
    and no retry, manifested like a committed step."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    _write_dir(dest, files)
    write_manifest(dest, arrays)
    _count_staged(nbytes)
    warnings.warn(
        f"checkpoint save exceeded its retry byte budget ({err}); "
        f"staged to local disk at {dest}", RuntimeWarning)
    return dest


# -- one-shot save and load -----------------------------------------------------

def _save_files(path: str, files, nbytes: float,
                staging_dir: Optional[str]) -> str:
    """Write a snapshot as the checkpoint directory ``path``, retried and
    byte-budgeted; past the budget into staging. Returns the directory."""
    from ..resilience import faults
    from ..resilience.retry import RetryBytesExhausted, call_with_retry

    def _write():
        faults.maybe_raise("ckpt_io", site="save_checkpoint",
                           msg="injected ckpt_io on save")
        _write_dir(path, files)

    try:
        call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                        **_save_retry_kwargs(nbytes))
    except RetryBytesExhausted as e:
        out = staging_dir or os.path.join(staging_root(),
                                          os.path.basename(path))
        return _stage_save(out, files, nbytes, e)
    return path


class AsyncSave:
    """A ``save_checkpoint(use_async=True)`` in flight: the write runs on
    a daemon thread; :meth:`wait_until_finished` returns the directory
    written or raises the write's error."""

    def __init__(self, path: str, write: Callable[[], str]):
        self.path = path
        self._result: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(write,),
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self, write):
        try:
            self._result = write()
        except BaseException as e:  # noqa: BLE001 — raised at the wait
            self._error = e

    def wait_until_finished(self, timeout: Optional[float] = None) -> str:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint write of {self.path} still "
                               f"running after {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result


_writer_lock = threading.Lock()
_writer: Optional[AsyncSave] = None   # the module's one in-flight write


def save_checkpoint(path: str, state: Dict[str, Any], overwrite: bool = True,
                    use_async: bool = False,
                    staging_dir: Optional[str] = None):
    """Save ``state`` (a dict of tensor trees) as a checkpoint directory.
    Retries are byte-budgeted; past the budget the save lands in
    ``staging_dir`` (default ``staging_root()/<basename(path)>``). Returns
    the directory written; with ``use_async`` an :class:`AsyncSave` whose
    write runs after the host copy. The module keeps one write in flight:
    a save first waits for the one before it (and raises its error).

    A :class:`ShardedState` over 2+ ranks is saved by every rank of its
    mesh (a collective): into one ``path``, as the one directory of the
    world (module docstring), whose write is synchronous (``use_async``
    gives an :class:`AsyncSave` that has finished) and raises past the
    retry budget, since a world's pieces cannot stage on one host's
    disk; into a ``path`` of each rank's own, in the one-rank format
    (a state with ZeRO slices raises)."""
    global _writer
    path = os.path.abspath(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists")
    with _writer_lock:
        prev, _writer = _writer, None
    if prev is not None:
        prev.wait_until_finished()
    t0 = time.perf_counter()
    world = _world_of(state, path)
    if world is not None:
        out = _save_world(path, state, world)
        dt = time.perf_counter() - t0
        _record("save", dt, 0.0)
        _record_stall(dt)
        return AsyncSave(path, lambda: out) if use_async else out
    files = _host_files(state)
    nbytes = _nbytes(files)
    if use_async:
        _record_stall(time.perf_counter() - t0)

        def _write():
            out = _save_files(path, files, nbytes, staging_dir)
            _record("save", time.perf_counter() - t0, nbytes)
            return out

        handle = AsyncSave(path, _write)
        with _writer_lock:
            _writer = handle
        return handle
    out = _save_files(path, files, nbytes, staging_dir)
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


# -- the asynchronous pipeline's host buffers --------------------------------

class _HostBuffer:
    """A host copy of one state: ``{key: {path: tensor}}``, pinned where
    the source is on the card, reused by every later snapshot of the same
    structure (``sig``: paths, shapes, dtypes, devices)."""

    def __init__(self, sig, flat):
        self.sig = sig
        self.files = {key: {p: torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=t.is_cuda)
                            for p, t in f.items()}
                      for key, f in flat.items()}


def _signature(flat) -> tuple:
    return tuple((key, p, tuple(t.shape), t.dtype, t.device.type)
                 for key, f in flat.items() for p, t in f.items())


def _file_digests(files) -> Dict[str, str]:
    """Content digests of a snapshot, keyed by the manifest's dotted path
    (``<key>.<path>``; a top-level tensor by its key)."""
    return {(f"{key}.{p}" if p else key): array_digest(t)
            for key, f in files.items() for p, t in f.items()}


# -- the manager ----------------------------------------------------------------

class CheckpointManager:
    """Step-numbered checkpoints under ``directory`` with retention, a save
    interval, the two-phase commit, the asynchronous commit pipeline and
    the deep tier (module docstring).

    ``deep_digests=True`` makes every save deep; ``deep_every=M`` every
    M-th (saves #0, #M, #2M, ...); ``save(step, state, deep=)`` pins one
    save's tier. ``async_commit=True``: ``save()`` returns after the host
    snapshot and a committer thread commits. ``dirty_probe`` (settable at
    any time) is asked at commit time: True suppresses the commit.
    ``commit_delay`` sleeps that many seconds before each commit (a test
    knob that holds a commit in flight). Every rank of a mesh that saves
    a :class:`ShardedState` over 2+ ranks into the same ``directory``
    writes the one directory of the world (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, use_async: bool = True,
                 staging_dir: Optional[str] = None,
                 deep_digests: bool = False, async_commit: bool = False,
                 deep_every: int = 0,
                 dirty_probe: Optional[Callable[[], bool]] = None,
                 commit_delay: float = 0.0):
        self._dir = os.path.abspath(directory)
        # the world whose one directory this is (None: one-rank format),
        # worked out from the first state saved on each mesh
        self._world: Optional[_World] = None
        self._world_mesh = None
        os.makedirs(self._dir, exist_ok=True)
        self._staging = staging_dir or os.path.join(
            staging_root(), os.path.basename(self._dir))
        self._max_to_keep = max_to_keep
        self._save_interval = max(1, int(save_interval_steps))
        self._deep_digests = bool(deep_digests)
        self._deep_every = max(0, int(deep_every))
        self._save_seq = 0              # save() calls: the tier cadence
        self._vcache: Dict[int, Optional[bool]] = {}
        self.restore_fallbacks_total = 0   # torn steps skipped over
        self.last_restored_step: Optional[int] = None
        # -- the asynchronous pipeline --
        self._async_commit = bool(async_commit)
        self.dirty_probe = dirty_probe
        self.commit_delay = float(commit_delay)
        self._fs_lock = threading.RLock()  # disk work, step vs committer
        self._cv = threading.Condition()
        # the one staged snapshot: (step, files, deep, trace, buffer, events)
        self._staged: Optional[tuple] = None
        self._committing: Optional[int] = None
        self._committing_buf: Optional[_HostBuffer] = None
        self._buffers: List[_HostBuffer] = []
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_gate = threading.Event()   # cleared: commits paused
        self._commit_gate.set()
        self._stopping = False
        self._thread_error: Optional[BaseException] = None
        # every snapshot ends as exactly one of these (or is in flight)
        self.snapshots_total = 0
        self.committed_total = 0
        self.superseded_total = 0
        self.suppressed_dirty_total = 0
        self.failed_total = 0
        self.abandoned_total = 0

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

    def _uncommitted(self, step: int) -> bool:
        """An aborted asynchronous commit: never a restore candidate, never
        a counted fallback."""
        return _is_uncommitted(self._dir, step)

    def _delete(self, step: int):
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        self._vcache.pop(step, None)

    def _gc(self):
        """Retention after a verified commit: keep the newest
        ``max_to_keep`` valid steps and delete the rest, torn steps and the
        debris of aborted commits (with their markers) included; if
        nothing verifies, delete nothing. A marker whose step never
        reached the disk goes too."""
        if not self._max_to_keep:
            return
        steps = self.all_steps()
        debris = {s for s in steps if self._uncommitted(s)}
        valid = [s for s in steps
                 if s not in debris and self._verify(s) is not False]
        if not valid:
            return
        keep = set(valid[-self._max_to_keep:])
        for s in steps:
            if s in keep or s == self._committing:
                continue
            self._delete(s)
            _clear_pending_marker(self._dir, s)
        for name in os.listdir(self._dir):
            if name.startswith(PENDING_PREFIX) and \
                    name[len(PENDING_PREFIX):].isdigit():
                s = int(name[len(PENDING_PREFIX):])
                if not os.path.isdir(self._step_dir(s)):
                    _clear_pending_marker(self._dir, s)

    # -- the tiers -----------------------------------------------------------

    @property
    def deep_every(self) -> int:
        return self._deep_every

    @deep_every.setter
    def deep_every(self, value: int):
        self._deep_every = max(0, int(value))

    def _tier_deep(self, explicit: Optional[bool]) -> bool:
        """This save's tier: ``deep`` when given, else ``deep_digests``,
        else the ``deep_every`` cadence (save #0 is deep, so a run always
        has a deep anchor)."""
        if explicit is not None:
            return bool(explicit)
        if self._deep_digests:
            return True
        if self._deep_every:
            return self._save_seq % self._deep_every == 0
        return False

    def _manifest_arrays(self, step: int) -> Optional[dict]:
        """The step's recorded content digests (None: a cheap step, or no
        readable manifest)."""
        try:
            with open(os.path.join(self._step_dir(step), MANIFEST_NAME)) as f:
                return json.load(f).get("arrays") or None
        except (OSError, ValueError):
            return None

    # -- saving --------------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any],
             deep: Optional[bool] = None) -> bool:
        """Persist ``state`` as ``step``; False when the save interval or
        an existing newer step skips it. A step that exists already (a
        restart replaying it) is replaced. ``deep`` pins this save's tier.
        With ``async_commit`` the call returns after the host snapshot."""
        from ..resilience import faults
        from ..resilience.retry import RetryBytesExhausted, call_with_retry
        step = int(step)
        tier_deep = self._tier_deep(deep)
        self._save_seq += 1
        mesh = _find_world(state)
        if mesh is not self._world_mesh:
            self._world = _world_of(state, self._dir)
            self._world_mesh = mesh
        if self._world is not None:
            if self._async_commit:
                return self._save_world_async(step, state, tier_deep)
            return self._save_world(step, state, tier_deep)
        if self._async_commit:
            return self._save_async(step, state, tier_deep)
        if step in self.all_steps():
            self._delete(step)
        latest = self.latest_step()
        if (latest is not None and latest >= step) or \
                step % self._save_interval:
            return False
        t0 = time.perf_counter()
        files = _host_files(state)
        nbytes = _nbytes(files)
        arrays = _file_digests(files) if tier_deep else None
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
            _stage_save(self._staged_step_dir(step), files, nbytes, e,
                        arrays)
        else:
            if faults.fires("ckpt_torn", step=step, site="ckpt_commit"):
                _corrupt_one_file(sdir)
                self._vcache.pop(step, None)
                raise faults.SimulatedCrash(
                    f"simulated kill -9 committing checkpoint step {step}")
            write_manifest(sdir, arrays)
            # a synchronous replay of an aborted commit: retire its marker
            _clear_pending_marker(self._dir, step)
            self._vcache[step] = True
            self._gc()
        dt = time.perf_counter() - t0
        _record("save", dt, nbytes, step=step)
        _record_stall(dt)  # a synchronous save stalls the step for its wall
        return True

    # -- the one directory of a world ----------------------------------------

    def _save_world(self, step: int, state, deep: bool) -> bool:
        """A world's synchronous save (every rank calls it): rank 0
        decides and clears, each rank writes its pieces into
        ``<step>.tmp-world``, rank 0 renames, writes the manifest (with
        every rank's piece digests on a deep save) and applies retention;
        barriers between. An armed ``ckpt_torn`` tears the step on rank 0
        and every rank raises ``SimulatedCrash`` after the last barrier."""
        from ..resilience import faults
        world = self._world
        go = None
        if world.rank == 0:
            if step in self.all_steps():
                self._delete(step)
            latest = self.latest_step()
            go = not ((latest is not None and latest >= step)
                      or step % self._save_interval)
        if not world.from_rank0(go):
            return False
        t0 = time.perf_counter()
        tmp = os.path.join(self._dir, f"{step}.tmp-world")
        nbytes = _write_world(tmp, state, world, deep, step, "manager_save")
        torn = faults.fires("ckpt_torn", step=step, site="ckpt_commit")
        if world.rank == 0:
            sdir = self._step_dir(step)
            arrays = _seal_world(tmp, sdir)
            if torn:
                _corrupt_one_file(sdir)
                self._vcache.pop(step, None)
            else:
                write_manifest(sdir, arrays if deep else None)
                _clear_pending_marker(self._dir, step)
                self._vcache[step] = True
                self._gc()
        world.barrier()
        if torn:
            raise faults.SimulatedCrash(
                f"simulated kill -9 committing checkpoint step {step}")
        dt = time.perf_counter() - t0
        _record("save", dt, nbytes, step=step)
        _record_stall(dt)
        return True

    def _save_world_async(self, step: int, state, deep: bool) -> bool:
        """A world's asynchronous save: the host copy of this rank's pieces
        and a directory name agreed from rank 0, then the committer. No
        snapshot is superseded (every rank commits every save it staged):
        a save waits until the committer has taken the one before."""
        self._raise_thread_error()
        if step % self._save_interval:
            return False
        import uuid
        world = self._world
        token = world.from_rank0(uuid.uuid4().hex[:12])
        t0 = time.perf_counter()
        with self._cv:
            while self._staged is not None:
                self._cv.wait(timeout=0.05)
            self.snapshots_total += 1
        part = _WorldPart(_world_snapshot(state, world))
        part["token"] = token
        part["world"] = world
        dt = time.perf_counter() - t0
        with self._cv:
            self._staged = (step, part, deep, None, None, [])
            self._cv.notify_all()
        self._ensure_committer()
        self._set_inflight_gauge()
        _record_stall(dt)
        return True

    def _commit_world(self, step: int, part, deep: bool):
        """The committer's half of a world's save: this rank's pieces into
        the agreed directory; on rank 0 also the wait for every rank's
        file, the dirty probe, the seal, the manifest and retention."""
        from ..resilience import faults
        from ..resilience.retry import call_with_retry
        world = part["world"]
        tmp = os.path.join(self._dir, f"{step}.tmp-{part['token']}")
        os.makedirs(tmp, exist_ok=True)
        digests = _part_digests(part, world.rank) if deep else None

        def _write():
            faults.maybe_raise("ckpt_io", step=step, site="async_commit",
                               msg=f"injected ckpt_io committing step {step}")
            _write_world_part(tmp, world, part, digests)

        t0 = time.perf_counter()
        nbytes = _part_nbytes(part)
        call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                        **_save_retry_kwargs(nbytes))
        if world.rank != 0:
            with self._cv:
                self.committed_total += 1
            return
        _wait_parts(tmp, world.size, WORLD_PARTS_TIMEOUT_S)
        with self._fs_lock:
            _write_pending_marker(self._dir, step)
            if step in self.all_steps():
                self._delete(step)
            latest = self.latest_step()
            probe = self.dirty_probe
            dirty = probe is not None and probe()
            if dirty or (latest is not None and latest >= step):
                shutil.rmtree(tmp, ignore_errors=True)
                _clear_pending_marker(self._dir, step)
                with self._cv:
                    self._count_suppressed("dirty" if dirty else "superseded")
                return
            sdir = self._step_dir(step)
            arrays = _seal_world(tmp, sdir)
            if faults.fires("ckpt_torn", step=step, site="ckpt_commit"):
                _corrupt_one_file(sdir)
                self._vcache.pop(step, None)
                raise faults.SimulatedCrash(
                    f"simulated kill -9 committing checkpoint step {step}")
            write_manifest(sdir, arrays if deep else None)
            _clear_pending_marker(self._dir, step)
            self._vcache[step] = True
            with self._cv:
                self.committed_total += 1
            self._gc()
        _record("save", time.perf_counter() - t0, nbytes, step=step)

    # -- the asynchronous pipeline -------------------------------------------

    @property
    def async_commit(self) -> bool:
        return self._async_commit

    def accounted(self) -> bool:
        """Every snapshot ended (committed, superseded, suppressed, failed
        or abandoned) and none is in flight."""
        with self._cv:
            in_flight = (self._staged is not None
                         or self._committing is not None)
            total = (self.committed_total + self.superseded_total
                     + self.suppressed_dirty_total + self.failed_total
                     + self.abandoned_total)
            return not in_flight and total == self.snapshots_total

    def inflight(self) -> int:
        """Snapshots staged or mid-commit (0, 1 or 2)."""
        with self._cv:
            return int(self._staged is not None) + \
                int(self._committing is not None)

    def pause_commits(self):
        """Hold the committer before its next commit (the deterministic
        window between a snapshot and its commit, for tests)."""
        self._commit_gate.clear()

    def resume_commits(self):
        self._commit_gate.set()
        with self._cv:
            self._cv.notify_all()

    def _count_suppressed(self, reason: str):
        from .. import telemetry
        if reason == "dirty":
            self.suppressed_dirty_total += 1
        else:
            self.superseded_total += 1
        if telemetry.enabled():
            telemetry.counter(
                "ckpt_suppressed_total",
                "asynchronous snapshots whose commit was suppressed (dirty: "
                "the dirty probe answered True at commit time; superseded: "
                "a newer snapshot replaced it)").inc(reason=reason)

    def _set_inflight_gauge(self):
        from .. import telemetry
        if telemetry.enabled():
            telemetry.gauge(
                "ckpt_inflight",
                "snapshots staged or mid-commit (asynchronous pipeline)"
            ).set(self.inflight())

    def _take_buffer(self, sig, step: int) -> Optional[_HostBuffer]:
        """Under ``_cv``: a buffer of this structure that no staged or
        committing snapshot holds. With both slots full the staged
        snapshot is superseded here and its buffer reused. None: allocate
        one (free buffers of another structure are dropped)."""
        staged_buf = self._staged[4] if self._staged is not None else None
        busy = [b for b in (staged_buf, self._committing_buf)
                if b is not None]
        for b in self._buffers:
            if b.sig == sig and all(b is not x for x in busy):
                return b
        if staged_buf is not None and self._committing is not None and \
                staged_buf.sig == sig:
            self._supersede_staged(step)
            return staged_buf
        self._buffers = busy
        return None

    def _supersede_staged(self, by_step: int):
        """Under ``_cv``: the staged snapshot ends as superseded."""
        tr = self._staged[3]
        self._staged = None
        self._count_suppressed("superseded")
        if tr is not None:
            tr.close("superseded", superseded_by=by_step)

    def _snapshot_host(self, state, step: int) -> tuple:
        """The step-path half of an asynchronous save: every leaf copied
        into a reused host buffer, from the card on the current stream
        without a wait (``non_blocking`` into pinned memory: ordered
        before the next step's in-place writes). Returns (buffer, events):
        the committer waits on the events before it reads the buffer."""
        _check_state(state)
        flat = {key: {p: _leaf_tensor(v)
                      for p, v in _flatten(sub, "", {}).items()}
                for key, sub in state.items()}
        sig = _signature(flat)
        with self._cv:
            buf = self._take_buffer(sig, step)
        if buf is None:
            buf = _HostBuffer(sig, flat)   # pinned: raises if it cannot be
            with self._cv:
                self._buffers.append(buf)
        devices = set()
        with torch.no_grad():
            for key, f in flat.items():
                for p, t in f.items():
                    buf.files[key][p].copy_(t, non_blocking=t.is_cuda)
                    if t.is_cuda:
                        devices.add(t.device)
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return buf, events

    def _save_async(self, step: int, state, deep: bool) -> bool:
        """Snapshot, stage, return; a staged snapshot not yet taken by the
        committer is superseded (the step loop never waits on a commit)."""
        from .. import telemetry
        from ..telemetry import tracing
        self._raise_thread_error()
        if step % self._save_interval:
            return False
        t0 = time.perf_counter()
        tr = tracing.start_trace("ckpt_save", step=step, deep=bool(deep))
        sp = tr.span("snapshot", step=step) if tr is not None else None
        with self._cv:
            self.snapshots_total += 1
        buf, events = self._snapshot_host(state, step)
        dt = time.perf_counter() - t0
        if sp is not None:
            sp.end("ok")
        with self._cv:
            if self._staged is not None:
                self._supersede_staged(step)
            self._staged = (step, buf.files, deep, tr, buf, events)
            self._cv.notify_all()
        self._ensure_committer()
        self._set_inflight_gauge()
        _record_stall(dt)
        if telemetry.enabled():
            telemetry.histogram(
                "ckpt_snapshot_ms",
                "device-to-host copy into the snapshot buffer, host time "
                "(the only part of an asynchronous save on the step path)",
                buckets=STALL_BUCKETS_MS).observe(dt * 1000.0)
            telemetry.emit("ckpt_snapshot", step=step, deep=bool(deep),
                           snapshot_ms=dt * 1000.0)
        return True

    def _ensure_committer(self):
        if self._commit_thread is None or not self._commit_thread.is_alive():
            self._stopping = False
            self._commit_thread = threading.Thread(
                target=self._commit_loop, name="ckpt-committer", daemon=True)
            self._commit_thread.start()

    def _commit_loop(self):
        while True:
            with self._cv:
                while not self._stopping and (
                        self._staged is None
                        or not self._commit_gate.is_set()):
                    self._cv.wait(timeout=0.05)
                if self._staged is None or not self._commit_gate.is_set():
                    if self._stopping:
                        return
                    continue
                step, files, deep, trace, buf, events = self._staged
                self._staged = None
                self._committing = step
                self._committing_buf = buf
            try:
                if isinstance(files, _WorldPart):
                    self._commit_world(step, files, deep)
                else:
                    self._commit_one(step, files, deep, trace, events)
            except BaseException as e:  # noqa: BLE001 — raised at flush()
                with self._cv:
                    self.failed_total += 1
                    self._thread_error = e
                if trace is not None:
                    trace.close("failed", error=repr(e))
            finally:
                with self._cv:
                    self._committing = None
                    self._committing_buf = None
                    self._cv.notify_all()
                self._set_inflight_gauge()

    def _commit_one(self, step: int, files, deep: bool, trace, events):
        """The committer's half: the dirty probe, the PENDING marker, the
        write (retried and byte-budgeted as a synchronous save), the
        manifest, retention."""
        from .. import telemetry
        from ..resilience import faults
        from ..resilience.retry import RetryBytesExhausted, call_with_retry
        sp = trace.span("commit", step=step) if trace is not None else None

        def _finish(outcome: str, **attrs):
            if sp is not None:
                sp.end(outcome, **attrs)
            if trace is not None:
                trace.close(outcome)

        if self.commit_delay > 0:
            time.sleep(self.commit_delay)
        # asked at commit time: a verdict that arrived after the snapshot
        # keeps the tainted state off the disk
        probe = self.dirty_probe
        if probe is not None and probe():
            with self._cv:
                self._count_suppressed("dirty")
            if telemetry.enabled():
                telemetry.emit("ckpt_commit", step=step, outcome="dirty")
            _finish("dirty")
            return
        for ev in events:
            ev.synchronize()       # the snapshot's copies have landed
        t0 = time.perf_counter()
        nbytes = _nbytes(files)
        arrays = _file_digests(files) if deep else None
        with self._fs_lock:
            # the marker is durable before any byte of the step
            _write_pending_marker(self._dir, step)
            if step in self.all_steps():
                self._delete(step)
            latest = self.latest_step()
            if latest is not None and latest >= step:
                _clear_pending_marker(self._dir, step)
                with self._cv:
                    self._count_suppressed("superseded")
                _finish("superseded")
                return
            sdir = self._step_dir(step)

            def _write():
                faults.maybe_raise(
                    "ckpt_io", step=step, site="async_commit",
                    msg=f"injected ckpt_io committing step {step}")
                _write_dir(sdir, files)

            try:
                call_with_retry(_write, site="ckpt_save", base_delay=0.01,
                                **_save_retry_kwargs(nbytes))
            except RetryBytesExhausted as e:
                _stage_save(self._staged_step_dir(step), files, nbytes, e,
                            arrays)
                _clear_pending_marker(self._dir, step)
                with self._cv:
                    self.committed_total += 1   # durable, degraded
                _finish("degraded", bytes_budget=True)
                return
            if faults.fires("ckpt_torn", step=step, site="ckpt_commit"):
                # the kill -9 window: a torn payload, no manifest, the
                # marker left: the step stays invisible to restores
                _corrupt_one_file(sdir)
                self._vcache.pop(step, None)
                raise faults.SimulatedCrash(
                    f"simulated kill -9 committing checkpoint step {step}")
            if os.environ.get("PADDLE_TPU_TORCH_TEST_COMMIT_CRASH") == \
                    str(step):
                # the chaos hook: a REAL kill -9 after the payload write and
                # before the manifest, the torn-directory window
                import signal as _signal
                os.kill(os.getpid(), _signal.SIGKILL)
            write_manifest(sdir, arrays)
            _clear_pending_marker(self._dir, step)
            self._vcache[step] = True
            with self._cv:
                self.committed_total += 1
            self._gc()
        dt = time.perf_counter() - t0
        _record("save", dt, nbytes, step=step)
        if telemetry.enabled():
            telemetry.histogram(
                "ckpt_commit_ms",
                "write, fsync, CRC, manifest and retention of one committed "
                "step on the committer thread (off the step path)",
                buckets=STALL_BUCKETS_MS).observe(dt * 1000.0)
            telemetry.emit("ckpt_commit", step=step, outcome="committed",
                           deep=bool(deep), commit_ms=dt * 1000.0)
        _finish("committed", commit_ms=dt * 1000.0)

    def _raise_thread_error(self):
        """A committer's ``SimulatedCrash`` (the injected kill -9) is raised
        here, at the step boundary, as the synchronous pipeline raises it;
        any other commit failure is a RuntimeWarning (it is counted in
        ``failed_total``)."""
        with self._cv:
            err, self._thread_error = self._thread_error, None
        if err is not None:
            from ..resilience import faults
            if isinstance(err, faults.SimulatedCrash):
                raise err
            warnings.warn(f"asynchronous checkpoint commit failed: {err!r}",
                          RuntimeWarning)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until no snapshot is staged or mid-commit (resuming paused
        commits); False on timeout. Raises a committer's
        ``SimulatedCrash``."""
        if self._async_commit and not self._commit_gate.is_set() and \
                self.inflight():
            warnings.warn("flush() while commits are paused: resuming",
                          RuntimeWarning)
            self.resume_commits()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._staged is not None or self._committing is not None:
                wait = 0.1 if deadline is None else min(
                    0.1, deadline - time.monotonic())
                if wait <= 0:
                    return False
                self._cv.wait(timeout=wait)
        self._raise_thread_error()
        if self._async_commit and self._world is not None:
            self._world.barrier()     # every rank's commit has landed
        return True

    def abandon(self):
        """Drop the staged snapshot without committing it (a process that
        dies mid-pipeline, in process)."""
        with self._cv:
            if self._staged is not None:
                tr = self._staged[3]
                if tr is not None:
                    tr.close("abandoned")
                self._staged = None
                self.abandoned_total += 1
            self._cv.notify_all()

    # -- restoring -----------------------------------------------------------

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

    def _read(self, path: str, template):
        from ..resilience.retry import call_with_retry
        return call_with_retry(_read_dir, path, template, None,
                               site="ckpt_restore", tries=2, base_delay=0.01)

    def _restored(self, out, step: int, t0: float):
        _record("restore", time.perf_counter() - t0, _tree_nbytes(out),
                step=step)
        self.last_restored_step = step
        return out

    def _deep_verify(self, step: int, template=None):
        """(verdict, payload): the step read back and every array re-hashed
        against the digests recorded at save time. True: all match, and
        the payload is the restore; False: a mismatch or an unreadable
        payload; None: no digests recorded. The payload is None unless the
        verdict is True."""
        recorded = self._manifest_arrays(step)
        if not recorded:
            return None, None
        try:
            out = self._read(self._step_dir(step), template)
        except Exception:  # noqa: BLE001 — an unreadable payload fails
            return False, None
        if compare_digests(recorded, self._digests(step, out)):
            return False, None
        return True, out

    def _digests(self, step: int, out) -> Dict[str, str]:
        """The digests of a step as read back: a world's per piece, as its
        save recorded them; otherwise per leaf of ``out``."""
        sdir = self._step_dir(step)
        if is_sharded_dir(sdir):
            return _world_digests(sdir)
        return tree_digests(out)

    def verify(self, step: int, deep: bool = False) -> Optional[bool]:
        """Re-verify a committed step from disk: the files (size and
        CRC32); with ``deep`` also the values against the recorded
        digests (the shallow verdict where none were recorded)."""
        self._vcache.pop(step, None)
        shallow = self._verify(step)
        if shallow is False or not deep:
            return shallow
        dv, _ = self._deep_verify(step)
        return shallow if dv is None else dv

    def restore(self, step: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None,
                deep: bool = False, prefer_deep: bool = False):
        """Read ``step`` (verified, no fallback; with ``deep`` its values
        must match its digests, else OSError), or without one the newest
        step that verifies and reads, then the newest staged one; None
        when nothing restores. ``prefer_deep``: the newest deep step whose
        values verify wins first, the cheap steps are the fallback.
        ``deep``: a step with digests must match them. Aborted commits are
        skipped and not counted. The pipeline is flushed first.
        ``template``: as :func:`load_checkpoint`."""
        if self._async_commit:
            self.flush()
        if step is not None:
            if self._uncommitted(step):
                raise OSError(f"checkpoint step {step} was never committed "
                              "(an aborted asynchronous save)")
            self._vcache.pop(step, None)
            if self._verify(step) is False:
                raise OSError(
                    f"checkpoint step {step} failed manifest verification")
            t0 = time.perf_counter()
            out = self._read(self._step_dir(step), template)
            recorded = self._manifest_arrays(step) if deep else None
            if recorded:
                bad = compare_digests(recorded, self._digests(step, out))
                if bad:
                    raise OSError(f"checkpoint step {step} failed deep "
                                  f"verification: {bad[:4]}")
            return self._restored(out, step, t0)
        steps_desc = [s for s in reversed(self.all_steps())
                      if not self._uncommitted(s)]
        deep_failed = set()
        if prefer_deep:
            # pass 1: the newest deep step whose values verify; cheap steps
            # are no candidates here and cost no fallback
            for s in steps_desc:
                if self._manifest_arrays(s) is None:
                    continue
                self._vcache.pop(s, None)
                if self._verify(s) is False:
                    self._count_fallbacks(1, reason="manifest")
                    deep_failed.add(s)
                    continue
                t0 = time.perf_counter()
                dv, out = self._deep_verify(s, template)
                if dv:
                    return self._restored(out, s, t0)
                self._count_fallbacks(1, reason="deep")
                deep_failed.add(s)
        for s in steps_desc:
            if s in deep_failed:
                continue
            self._vcache.pop(s, None)
            if self._verify(s) is False:
                self._count_fallbacks(1, reason="manifest")
                continue
            t0 = time.perf_counter()
            if deep:
                dv, out = self._deep_verify(s, template)
                if dv is False:
                    # the bytes check out, the values do not
                    self._count_fallbacks(1, reason="deep")
                    continue
                if dv:
                    return self._restored(out, s, t0)
            try:
                out = self._read(self._step_dir(s), template)
            except Exception:  # noqa: BLE001 — any unreadable step falls back
                self._count_fallbacks(1, reason="restore")
                continue
            return self._restored(out, s, t0)
        for s in reversed(self.staged_steps()):
            sdir = self._staged_step_dir(s)
            if verify_manifest(sdir) is False:
                self._count_fallbacks(1, reason="staged")
                continue
            t0 = time.perf_counter()
            try:
                out = self._read(sdir, template)
            except Exception:  # noqa: BLE001
                self._count_fallbacks(1, reason="staged")
                continue
            return self._restored(out, s, t0)
        return None

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes (or predates) manifest verification,
        aborted commits skipped: a size-only pass rejects truncated or
        missing files before the full CRC pass."""
        for s in reversed(self.all_steps()):
            if self._uncommitted(s):
                continue
            if verify_manifest(self._step_dir(s), level="size") is False:
                self._vcache[s] = False
                continue
            if self._verify(s) is not False:
                return s
        return None

    def wait_until_finished(self):
        """Wait for the asynchronous pipeline to drain (a synchronous save
        has committed before it returned)."""
        if self._async_commit:
            self.flush()

    def close(self):
        """Drain the pipeline, stop the committer and free the snapshot
        buffers."""
        try:
            if self._async_commit:
                self.flush()
        finally:
            with self._cv:
                self._stopping = True
                self._cv.notify_all()
            if self._commit_thread is not None:
                self._commit_thread.join(timeout=5.0)
            self._buffers = []


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
