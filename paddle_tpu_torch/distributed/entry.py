"""Sparse-feature admission policies for the parameter-server embedding.

Port of ``paddle_tpu/distributed/entry.py`` (reference
python/paddle/distributed/entry_attr.py: ProbabilityEntry:59,
CountFilterEntry:100): a new feature id is not admitted into the sparse
table unconditionally. ProbabilityEntry admits a new id with probability
p (a stable hash of the key against p, so every trainer decides alike);
CountFilterEntry admits an id once it has been seen n times.
Non-admitted ids read as zero rows and their gradients are dropped.

Admission is host-side: the table lives in host memory, so
``_AdmissionTable`` wraps its pull and push and the model's device compute
is unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["EntryAttr", "ProbabilityEntry", "CountFilterEntry"]


class EntryAttr:
    """Base admission policy (reference entry_attr.py EntryAttr)."""

    _name = "entry_attr"

    def _to_attr(self) -> str:
        raise NotImplementedError("EntryAttr is base class")

    # -- filter protocol used by _AdmissionTable -------------------------
    def accumulate_and_admit(self, keys: np.ndarray) -> np.ndarray:
        """Observe one occurrence of each element of ``keys`` (duplicates
        count) and return a bool mask: True = admitted (row may be
        created)."""
        raise NotImplementedError

    def is_admitted(self, keys: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ProbabilityEntry(EntryAttr):
    """Admit a new id with fixed probability (reference entry_attr.py:59).
    Deterministic per key (stable 64-bit hash vs threshold), so every
    trainer makes the same admission decision without coordination."""

    def __init__(self, probability: float):
        if not isinstance(probability, float) or not 0 < probability <= 1:
            raise ValueError(
                "probability must be a float in (0, 1], got "
                f"{probability!r}")
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self) -> str:
        return f"{self._name}:{self._probability}"

    def _hash01(self, keys: np.ndarray) -> np.ndarray:
        h = keys.astype(np.uint64, copy=True)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
        return (h % np.uint64(1 << 24)).astype(np.float64) / float(1 << 24)

    def accumulate_and_admit(self, keys: np.ndarray) -> np.ndarray:
        return self._hash01(np.asarray(keys, np.int64)) < self._probability

    is_admitted = accumulate_and_admit


class CountFilterEntry(EntryAttr):
    """Admit an id once it has been seen >= ``count_filter`` times
    (reference entry_attr.py:100). Counts are per-process (each trainer
    sees its own shard of the stream, like the reference's per-shard
    counters)."""

    def __init__(self, count_filter: int):
        if not isinstance(count_filter, int) or count_filter < 0:
            raise ValueError(
                "count_filter must be a non-negative integer, got "
                f"{count_filter!r}")
        self._name = "count_filter_entry"
        self._count = count_filter
        self._seen: Dict[int, int] = {}

    def _to_attr(self) -> str:
        return f"{self._name}:{self._count}"

    def accumulate_and_admit(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        for k, c in zip(uniq.tolist(), counts.tolist()):
            self._seen[k] = self._seen.get(k, 0) + c
        return self.is_admitted(keys)

    def is_admitted(self, keys: np.ndarray) -> np.ndarray:
        n = self._count
        return np.fromiter((self._seen.get(int(k), 0) >= n
                            for k in np.asarray(keys).ravel()),
                           dtype=bool,
                           count=int(np.asarray(keys).size))


class _AdmissionTable:
    """pull/push view of a sparse table with an EntryAttr gate: rows are
    only created for admitted keys; pushes for non-admitted keys are
    dropped; existing rows (e.g. from load()) always read."""

    def __init__(self, table, entry: EntryAttr):
        self._table = table
        self.entry = entry

    @property
    def dim(self):
        return self._table.dim

    def pull(self, keys, create_missing: bool = True) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        shape = keys.shape
        flat = keys.reshape(-1)
        if not create_missing:
            return self._table.pull(keys, create_missing=False)
        admitted = self.entry.accumulate_and_admit(flat)
        out = np.zeros((flat.size, self.dim), np.float32)
        if admitted.any():
            out[admitted] = self._table.pull(flat[admitted],
                                             create_missing=True) \
                .reshape(-1, self.dim)
        rest = ~admitted
        if rest.any():  # not admitted, but may pre-exist via load()
            out[rest] = self._table.pull(flat[rest],
                                         create_missing=False) \
                .reshape(-1, self.dim)
        return out.reshape(shape + (self.dim,))

    def push(self, keys, grads, lr: float):
        keys = np.asarray(keys, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(keys.size, -1)
        m = self.entry.is_admitted(keys)
        if m.any():
            self._table.push(keys[m], grads[m], lr)

    def __len__(self):
        return len(self._table)

    def __getattr__(self, name):  # save/load/flush/... delegate
        return getattr(self._table, name)
