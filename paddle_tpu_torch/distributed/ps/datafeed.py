"""The MultiSlot dataset over the native parallel parser.

Port of ``paddle_tpu/distributed/ps/datafeed.py`` (reference
framework/data_feed.h:208 DataFeed, :757 MultiSlotDataFeed, data_set.h:43
Dataset, :101 LoadIntoMemory, :157 global shuffle). Slots are declared up
front; each line holds, per slot, a count followed by that many int64 ids
(sparse) or floats (dense). ``load_into_memory`` parses files with the
native multi-threaded parser (``csrc/ps/datafeed.cc``); ``global_shuffle``
permutes examples, across processes through a shared directory; batches
come out padded with -1 (sparse slots) or stacked (dense slots).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .native import lib


class _Slot:
    def __init__(self, name: str, dense: bool):
        self.name = name
        self.dense = dense
        self.offsets = np.zeros((1,), np.int64)   # CSR over examples
        self.values = np.zeros((0,), np.float32 if dense else np.int64)


class InMemoryDataset:
    """reference: data_set.h:43 / python InMemoryDataset. load_into_memory
    parses files with the native multi-threaded parser; global_shuffle
    permutes examples; batches come out padded (sparse) or stacked (dense).
    """

    def __init__(self, slot_names: Sequence[str],
                 dense_slots: Sequence[str] = ()):
        self.slot_names = list(slot_names)
        self._slots = [_Slot(n, n in set(dense_slots)) for n in slot_names]
        self._order: Optional[np.ndarray] = None
        self._n = 0

    def __len__(self):
        return self._n

    def load_into_memory(self, filelist: Sequence[str], nthreads: int = 8):
        l = lib()
        kinds = np.array([1 if s.dense else 0 for s in self._slots],
                         dtype=np.int32)
        kp = kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        # per-file pieces accumulated in lists, concatenated once at the end
        # (a rolling per-file concatenate would copy O(files^2) bytes)
        piece_offs: List[List[np.ndarray]] = [[] for _ in self._slots]
        piece_vals: List[List[np.ndarray]] = [[] for _ in self._slots]
        bases = [s.values.size for s in self._slots]
        for path in filelist:
            h = l.ps_datafeed_parse(path.encode(), len(self._slots), kp,
                                    nthreads)
            if not h:
                raise IOError(f"cannot parse {path}")
            try:
                n = int(l.ps_datafeed_num_lines(h))
                for i, s in enumerate(self._slots):
                    offs = np.empty((n + 1,), np.int64)
                    l.ps_datafeed_slot_offsets(
                        h, i, offs.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)))
                    total = int(l.ps_datafeed_slot_total(h, i))
                    if s.dense:
                        vals = np.empty((total,), np.float32)
                        l.ps_datafeed_slot_vals(
                            h, i, vals.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_float)))
                    else:
                        vals = np.empty((total,), np.int64)
                        l.ps_datafeed_slot_ids(
                            h, i, vals.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int64)))
                    piece_offs[i].append(offs[1:] + bases[i])
                    piece_vals[i].append(vals)
                    bases[i] += vals.size
            finally:
                l.ps_datafeed_destroy(h)
        for i, s in enumerate(self._slots):
            s.offsets = np.concatenate([s.offsets] + piece_offs[i])
            s.values = np.concatenate([s.values] + piece_vals[i])
        self._n = self._slots[0].offsets.size - 1
        for s in self._slots:
            if s.dense and s.offsets.size > 1:
                widths = np.diff(s.offsets)
                if widths.min() != widths.max():
                    bad = int(np.argmax(widths != widths[0]))
                    raise ValueError(
                        f"dense slot {s.name!r} has ragged widths: example "
                        f"{bad} has {int(widths[bad])} floats, expected "
                        f"{int(widths[0])} — check the input files")
        self._order = np.arange(self._n)

    def global_shuffle(self, seed: int = 0, rank: Optional[int] = None,
                       nprocs: Optional[int] = None,
                       exchange_dir: Optional[str] = None,
                       timeout: float = 120.0):
        """reference: data_set.h:157 global shuffle. Single-host form
        (rank None): permute the example order. Multi-PROCESS form: every
        example is routed to a uniformly random destination trainer and
        physically EXCHANGED (the reference ships examples through the PS;
        here through a shared filesystem ``exchange_dir`` — each rank
        writes per-destination shards, barriers on done-markers, then
        ingests the shards addressed to it), followed by a local
        permutation."""
        if rank is None or not nprocs or nprocs == 1:
            rng = np.random.RandomState(seed)
            self._order = rng.permutation(self._n)
            return
        assert exchange_dir, "multi-process global_shuffle needs a shared " \
                             "exchange_dir"
        import os
        import pickle
        import time
        os.makedirs(exchange_dir, exist_ok=True)
        # shards/markers are keyed by seed so each shuffle ROUND is its own
        # namespace — reusing (exchange_dir, seed) would let a rank sail
        # through the barrier on the previous round's stale markers and
        # read old shards (duplicating/losing examples). Fail loudly.
        done_mine = os.path.join(exchange_dir, f"done.{seed}.{rank}")
        if os.path.exists(done_mine):
            raise ValueError(
                f"global_shuffle(seed={seed}) was already run in "
                f"{exchange_dir!r}; use a fresh seed (e.g. the epoch "
                "number) or a fresh exchange_dir per shuffle round")
        rng = np.random.RandomState(seed * 100003 + rank)
        dest = rng.randint(0, nprocs, size=self._n)
        for d in range(nprocs):
            idxs = np.nonzero(dest == d)[0]
            payload = {"n": int(idxs.size),
                       "slots": [(s.name, s.dense) + self._gather(s, idxs)
                                 for s in self._slots]}
            tmp = os.path.join(exchange_dir, f".ex.{seed}.{rank}.{d}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
            os.replace(tmp, os.path.join(exchange_dir,
                                         f"ex.{seed}.{rank}.{d}.pkl"))
        open(done_mine, "w").close()
        deadline = time.time() + timeout
        while not all(os.path.exists(os.path.join(exchange_dir,
                                                  f"done.{seed}.{r}"))
                      for r in range(nprocs)):
            if time.time() > deadline:
                raise TimeoutError("global_shuffle barrier timed out")
            time.sleep(0.05)
        parts = []
        for src in range(nprocs):
            with open(os.path.join(
                    exchange_dir, f"ex.{seed}.{src}.{rank}.pkl"),
                    "rb") as f:
                parts.append(pickle.load(f))
        # rebuild slots from the shards addressed to this rank
        self._n = sum(p["n"] for p in parts)
        for si, s in enumerate(self._slots):
            offs = [np.zeros((1,), np.int64)]
            vals = []
            base = 0
            for p in parts:
                _, _, po, pv = p["slots"][si]
                offs.append(po[1:] + base)
                vals.append(pv)
                base += pv.size
            s.offsets = np.concatenate(offs)
            s.values = (np.concatenate(vals) if vals else
                        np.zeros((0,), s.values.dtype))
        self._order = np.random.RandomState(
            seed * 7919 + rank).permutation(self._n)

    @staticmethod
    def _gather(s: "_Slot", idxs: np.ndarray):
        """(offsets, values) of the examples `idxs` as a packed pair.
        Vectorized: one fancy-index instead of a per-example slice loop
        (this runs once per destination rank per slot in global_shuffle)."""
        starts = s.offsets[idxs]
        lens = s.offsets[idxs + 1] - starts
        offsets = np.concatenate([np.zeros((1,), np.int64),
                                  np.cumsum(lens)])
        if not idxs.size or offsets[-1] == 0:
            return offsets, np.zeros((0,), s.values.dtype)
        # flat source index for every value: repeat each start, then add
        # the within-example ramp (global ramp minus repeated segment base)
        seg_base = np.repeat(offsets[:-1], lens)
        flat = np.repeat(starts, lens) + (np.arange(offsets[-1]) - seg_base)
        return offsets, s.values[flat]

    def _example_slice(self, s: _Slot, idx: int):
        a, b = s.offsets[idx], s.offsets[idx + 1]
        return s.values[a:b]

    def batch(self, start: int, size: int,
              pad: int = -1) -> Dict[str, np.ndarray]:
        """Examples [start, start+size) in the (possibly shuffled) order.
        Sparse slots pad to the longest example with ``pad`` (=-1, the
        DistributedEmbedding padding id); dense slots stack."""
        idxs = self._order[start:start + size]
        out: Dict[str, np.ndarray] = {}
        for s in self._slots:
            rows = [self._example_slice(s, int(i)) for i in idxs]
            if s.dense:
                out[s.name] = np.stack([r.astype(np.float32) for r in rows])
            else:
                L = max((r.size for r in rows), default=1) or 1
                m = np.full((len(rows), L), pad, dtype=np.int64)
                for j, r in enumerate(rows):
                    m[j, :r.size] = r
                out[s.name] = m
        return out

    def batches(self, batch_size: int, drop_last: bool = True):
        n = (self._n // batch_size) * batch_size if drop_last else self._n
        for st in range(0, n, batch_size):
            yield self.batch(st, min(batch_size, n - st))


# QueueDataset-style streaming is one pass over batches()
QueueDataset = InMemoryDataset
