"""HeterEmbedding: a hot embedding tier on the card over the host
parameter server.

Port of ``paddle_tpu/distributed/ps/heter.py`` (reference HeterPS:
framework/fleet/heter_ps/hashtable.h:47, heter_comm.h:50). The hash table
is split by what each side does best:

- the card owns the row data: a fixed ``(capacity, dim)`` parameter
  ``hot``, gathered on the card (``embedding``: its backward sums the
  rows' gradients in a fixed order, so a step is deterministic) and
  updated by the model's optimizer (the device optimizer of the hot
  tier);
- the host owns the hash map: key -> slot as sorted key/slot arrays
  (``np.searchsorted``), LRU eviction by a per-slot last-used tick
  (``np.argpartition``), and the promote/flush traffic with the PS table,
  in :meth:`HeterEmbedding.prepare` between steps; the step sees only
  integer slot ids.

Tier handoff moves whole rows (value and optimizer-slot columns) through
``SparseTable.export_rows``/``import_rows``: a promoted row brings its host
accumulator into the device optimizer's slots, an evicted row takes the
device's back. Where the device slots are not reachable (no trainer), an
eviction keeps the table's slot columns and rewrites the values only.

**Live state.** ``ParallelTrainer`` binds the layer at construction
(``_on_trainer_built``). The trainer updates its parameters in place and
replaces its optimizer slots each step; the tier writes in place, with
``index_copy_``, into the parameter and into the slot tensors the trainer
holds at that moment, which are the ones the next step reads. Every
write takes the trainer's state lock, which ``train_step`` holds while it
issues a step, so no write lands while a step is being issued, and runs on
the stream the trainer was bound on, after the step already queued there:
:meth:`prepare_async` (one worker thread, in submission order) therefore
gives the same bits as calling :meth:`prepare` between the steps.

**Sharded mode** (``shard_axis="model"``): ``hot`` is split by rows over
the mesh's ``model`` axis (``pspec`` ``("model", None)``); the lookup
gathers this rank's rows, zeroes the others and sums over ``model``
(``reduce_from_parallel_region``: identity backward). Every rank runs the
same host map on the same ids and keeps its own copy of the table; an
eviction sums the evicted rows' pieces over ``model`` (one all-reduce) so
every rank's table takes the same rows.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...nn.layer import Layer
from .table import SparseTable

__all__ = ["HeterEmbedding"]

# the native row layout per optimizer: value columns, then these slot
# columns, named as the device optimizer's slots
_SLOT_COLUMNS = {"sgd": (), "adagrad": ("moment",), "adam": ("m", "v")}


class HeterEmbedding(Layer):
    """Two-tier embedding: hot rows on the card, the cold store on the host.

    Call ``slots = emb.prepare(ids)`` (or ``emb.prepare_async(ids)``) on
    the host before each step, then run the step on ``slots``."""

    def __init__(self, dim: int, capacity: int,
                 optimizer: str = "adagrad",
                 table: Optional[SparseTable] = None,
                 pooling: Optional[str] = None, seed: int = 0,
                 init_range: float = 0.01,
                 shard_axis: Optional[str] = None):
        super().__init__()
        from ...nn.initializer import Constant
        if table is not None and not hasattr(table, "export_rows"):
            raise TypeError("HeterEmbedding needs a table with the "
                            "export_rows/import_rows tier-exchange API "
                            "(local SparseTable)")
        self.dim = dim
        self.capacity = int(capacity)
        self.pooling = pooling
        self.table = table if table is not None else SparseTable(
            dim, optimizer=optimizer, seed=seed, init_range=init_range)
        assert self.table.dim == dim
        self._slot_names = _SLOT_COLUMNS.get(self.table.optimizer, ())
        self._shard_axis = shard_axis
        n, _ = self._shard()
        self._check_shard_capacity(n)
        self.hot = self.create_parameter((self.capacity // n, dim),
                                         initializer=Constant(0.0))
        if shard_axis:
            self.hot.pspec = (shard_axis, None)
        self._slot2key = np.full(self.capacity, -1, np.int64)
        self._skeys = np.empty(0, np.int64)    # resident keys, sorted
        self._sslots = np.empty(0, np.int64)   # their slots
        self._last_used = np.zeros(self.capacity, np.int64)
        self._tick = 0
        self._prep_pool = None
        self._trainer = None
        self._pname = None
        self._stream = None
        self._lock = threading.RLock()
        self.stats = {"lookups": 0, "hits": 0, "misses": 0, "evicts": 0,
                      "prepare_s": 0.0, "tier_exchange_s": 0.0}

    # -- the shard --------------------------------------------------------------
    def _shard(self):
        """(degree, rank) of the shard axis on the current mesh."""
        if not self._shard_axis:
            return 1, 0
        from ..mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or self._shard_axis not in mesh.shape:
            return 1, 0
        return mesh.shape[self._shard_axis], mesh.coord[self._shard_axis]

    def _check_shard_capacity(self, n):
        if self.capacity % n:
            raise ValueError(
                f"HeterEmbedding capacity ({self.capacity}) must be "
                f"divisible by mesh axis {self._shard_axis!r} size ({n}) "
                f"to shard the hot tier")

    # -- live state -------------------------------------------------------------
    def attach(self, trainer):
        """Bind to a ``ParallelTrainer`` so that promote and evict act on
        its live state (its parameter, its optimizer slots, its lock and
        its stream). The trainer calls this at construction."""
        name = trainer.param_name_of(self.hot)
        if name is None:
            raise ValueError("this HeterEmbedding's hot parameter is not "
                             "part of the trainer's model")
        self._check_shard_capacity(self._shard()[0])
        self._trainer = trainer
        self._pname = name
        self._lock = trainer._state_lock
        dev = trainer.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        return self

    _on_trainer_built = attach

    def _values(self) -> torch.Tensor:
        if self._trainer is not None:
            return self._trainer.get_param(self._pname)
        return self.hot.detach()

    def _get_slot(self, slot_name):
        if self._trainer is not None:
            return self._trainer.get_opt_slot(self._pname, slot_name)
        return None

    def _device_slot_names(self):
        if self._trainer is not None:
            return self._trainer.opt_slot_names(self._pname)
        return ()

    def _on_stream(self):
        if self._stream is None:
            import contextlib
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- tier exchange ----------------------------------------------------------
    def _local(self, slots: np.ndarray, rows_of):
        """(positions in ``slots`` this rank holds, their local row
        indices on ``rows_of``'s device)."""
        n, rank = self._shard()
        per = self.capacity // n
        mine = np.flatnonzero((slots >= rank * per) &
                              (slots < (rank + 1) * per))
        idx = torch.from_numpy(slots[mine] - rank * per).to(rows_of.device)
        return mine, idx

    def _read(self, arr: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """Rows ``slots`` of a (local piece of a) hot array as float32
        numpy; under sharding, summed over the shard axis."""
        n, _ = self._shard()
        mine, idx = self._local(slots, arr)
        if n == 1:
            return arr.index_select(0, idx).float().cpu().numpy()
        out = torch.zeros((slots.size, arr.shape[1]), dtype=torch.float32,
                          device=arr.device)
        out[torch.from_numpy(mine).to(arr.device)] = \
            arr.index_select(0, idx).float()
        from ..meta_parallel.parallel_layers.mp_layers import model_parallel
        import torch.distributed as dist
        group, _, _ = model_parallel(self._shard_axis)
        dist.all_reduce(out, group=group)
        return out.cpu().numpy()

    @torch.no_grad()
    def _write(self, arr: torch.Tensor, slots: np.ndarray, rows):
        """Rows ``slots`` of ``arr`` (in place) := ``rows`` (numpy, or 0)."""
        mine, idx = self._local(slots, arr)
        if not mine.size:
            return
        if isinstance(rows, np.ndarray):
            src = torch.from_numpy(np.ascontiguousarray(rows[mine]))
            src = src.to(arr.device, arr.dtype)
        else:
            src = torch.full((mine.size, arr.shape[1]), float(rows),
                             dtype=arr.dtype, device=arr.device)
        arr.index_copy_(0, idx, src)

    def _flush(self, slots: np.ndarray, keys: np.ndarray):
        """Evicted rows -> the table, with the optimizer slots where
        reachable."""
        vals = self._read(self._values(), slots)
        slot_arrays = [self._get_slot(sn) for sn in self._slot_names]
        if all(a is not None for a in slot_arrays):
            cols = [vals] + [self._read(a, slots) for a in slot_arrays]
            self.table.import_rows(keys, np.concatenate(cols, axis=1))
        else:
            cur = self.table.export_rows(keys, create_missing=True)
            cur[:, :self.dim] = vals
            self.table.import_rows(keys, cur)

    def _promote(self, slots: np.ndarray, keys: np.ndarray):
        """Table rows -> the card (values and optimizer-slot columns). Every
        reachable device slot of the reused slots is written: mapped
        columns take the table's state, the others 0, so a promoted key
        never inherits an evicted key's accumulator."""
        rows = self.table.export_rows(keys, create_missing=True)
        self._write(self._values(), slots, rows[:, :self.dim])
        mapped = {sn: rows[:, (1 + j) * self.dim:(2 + j) * self.dim]
                  for j, sn in enumerate(self._slot_names)}
        for sn in self._device_slot_names():
            arr = self._get_slot(sn)
            if arr is not None:
                self._write(arr, slots, mapped.get(sn, 0.0))

    def _check_handoff(self):
        """Warn once when optimizer state cannot move between the tiers
        (no trainer, or a device optimizer whose slots differ from the
        table's): values still move, the trajectories will differ from the
        host-PS path."""
        if getattr(self, "_handoff_checked", False):
            return
        self._handoff_checked = True
        if not self._slot_names:
            return
        reachable = [sn for sn in self._slot_names
                     if self._get_slot(sn) is not None]
        if len(reachable) != len(self._slot_names):
            warnings.warn(
                f"HeterEmbedding: table optimizer "
                f"{self.table.optimizer!r} keeps slot columns "
                f"{self._slot_names} but the device optimizer exposes "
                f"{self._device_slot_names() or 'none'}: optimizer state "
                f"will NOT migrate on evict/promote (values still do). "
                f"Match the training optimizer to the table optimizer, or "
                f"train through a ParallelTrainer.", stacklevel=3)

    # -- the host step ----------------------------------------------------------
    def _lookup_resident(self, keys: np.ndarray):
        """(hit mask, slot of each hit) through the sorted key arrays."""
        if self._skeys.size == 0:
            return np.zeros(keys.shape, bool), np.empty(0, np.int64)
        pos = np.searchsorted(self._skeys, keys)
        pos_c = np.minimum(pos, self._skeys.size - 1)
        hit = self._skeys[pos_c] == keys
        return hit, self._sslots[pos_c[hit]]

    def prepare(self, ids) -> np.ndarray:
        """Map raw keys to hot slots, promoting misses and evicting LRU
        rows as needed. Returns int32 slots shaped like ``ids`` (-1
        padding kept). Host work between steps; ``stats["prepare_s"]``
        adds up its time."""
        t0 = time.perf_counter()
        self._check_handoff()
        ids_np = np.asarray(ids.detach().cpu().numpy()
                            if isinstance(ids, torch.Tensor) else ids)
        flat = ids_np.reshape(-1).astype(np.int64, copy=False)
        valid = flat >= 0
        uniq = np.unique(flat[valid])
        self._tick += 1

        hit, hit_slots = self._lookup_resident(uniq)
        miss_keys = uniq[~hit]
        self.stats["lookups"] += int(uniq.size)
        self.stats["misses"] += int(miss_keys.size)
        self.stats["hits"] += int(uniq.size - miss_keys.size)
        # this batch's keys are never eviction victims
        self._last_used[hit_slots] = self._tick

        occupied = self._slot2key >= 0
        need = int(miss_keys.size) - int(self.capacity - occupied.sum())
        with self._lock, self._on_stream():
            if need > 0:
                cand = occupied & (self._last_used < self._tick)
                if int(cand.sum()) < need:
                    raise RuntimeError(
                        f"HeterEmbedding capacity {self.capacity} cannot "
                        f"hold the {uniq.size} distinct keys of this batch")
                scores = np.where(cand, self._last_used,
                                  np.iinfo(np.int64).max)
                evict_slots = np.argpartition(scores, need - 1)[:need] \
                    .astype(np.int64)
                evict_keys = self._slot2key[evict_slots]
                t_x = time.perf_counter()
                self._flush(evict_slots, evict_keys)
                self.stats["tier_exchange_s"] += time.perf_counter() - t_x
                self._slot2key[evict_slots] = -1
                keep = np.ones(self._skeys.size, bool)
                keep[np.searchsorted(self._skeys, np.sort(evict_keys))] = \
                    False
                self._skeys = self._skeys[keep]
                self._sslots = self._sslots[keep]
                self.stats["evicts"] += need

            if miss_keys.size:
                free_slots = np.flatnonzero(self._slot2key < 0)
                new_slots = free_slots[:miss_keys.size].astype(np.int64)
                t_x = time.perf_counter()
                self._promote(new_slots, miss_keys)
                self.stats["tier_exchange_s"] += time.perf_counter() - t_x
                self._slot2key[new_slots] = miss_keys
                self._last_used[new_slots] = self._tick
                ins = np.searchsorted(self._skeys, miss_keys)
                self._skeys = np.insert(self._skeys, ins, miss_keys)
                self._sslots = np.insert(self._sslots, ins, new_slots)

        out = np.full(flat.shape, -1, np.int64)
        pos = np.searchsorted(self._skeys, flat[valid])
        out[valid] = self._sslots[pos]
        res = out.reshape(ids_np.shape).astype(np.int32)
        self.stats["prepare_s"] += time.perf_counter() - t0
        return res

    def prepare_async(self, ids):
        """:meth:`prepare` on the one background worker; returns a Future.
        The host map work and the table traffic of batch k+1 overlap the
        card running step k; the worker runs preparations in submission
        order, and the caller feeds each ``.result()`` to its step."""
        if self._prep_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._prep_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="heter-prepare")
        return self._prep_pool.submit(self.prepare, ids)

    # -- the lookup -------------------------------------------------------------
    def forward(self, slot_ids):
        slot_ids = torch.as_tensor(slot_ids, device=self.hot.device).long()
        mask = slot_ids >= 0
        safe = torch.where(mask, slot_ids, 0)
        n, rank = self._shard()
        if n > 1:
            from ..meta_parallel.parallel_layers.mp_layers import (
                reduce_from_parallel_region)
            per = self.hot.shape[0]
            local = safe - rank * per
            mine = (local >= 0) & (local < per)
            rows = F.embedding(torch.where(mine, local, 0), self.hot)
            rows = rows * mine[..., None].to(rows.dtype)
            emb = reduce_from_parallel_region(rows, self._shard_axis)
        else:
            emb = F.embedding(safe, self.hot)
        emb = emb * mask[..., None].to(emb.dtype)
        if self.pooling is None:
            return emb
        s = emb.sum(dim=-2)          # padded rows are zero already
        if self.pooling == "sum":
            return s
        cnt = mask.to(torch.float32)[..., None].sum(dim=-2).clamp(min=1.0)
        return s / cnt

    # -- persistence ------------------------------------------------------------
    def flush_all(self):
        """Write every hot row back to the table (a checkpoint or export
        boundary; the cache stays valid)."""
        live = np.flatnonzero(self._slot2key >= 0)
        if live.size:
            with self._lock, self._on_stream():
                self._flush(live, self._slot2key[live])

    def save(self, path: str):
        self.flush_all()
        self.table.save(path)

    def load(self, path: str):
        self.table.load(path)
        # drop the cache: rows promote again, lazily, from the table
        self._slot2key[:] = -1
        self._skeys = np.empty(0, np.int64)
        self._sslots = np.empty(0, np.int64)
        self._last_used[:] = 0
        self._tick = 0

    @property
    def hit_rate(self) -> float:
        n = self.stats["lookups"]
        return self.stats["hits"] / n if n else 0.0
