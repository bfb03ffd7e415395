"""The parameter server's tables over the native core (``native.py``).

Port of ``paddle_tpu/distributed/ps/table.py``: ``SparseTable`` (rows made
on first touch, the host optimizer applied at push; ``export_rows`` and
``import_rows`` move whole rows, value then optimizer-slot columns, for the
device hot tier), ``DenseTable``, ``GraphTable`` (adjacency, node features,
neighbour sampling) and ``shard_keys`` (the 64-bit hash mix the native
table shards by, which ``service.py`` routes keys with). Host memory and
numpy arrays only: these tables never touch the card.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from .native import lib

_OPTIMIZERS = {"sgd": 0, "adagrad": 1, "adam": 2}


def _as_f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class SparseTable:
    """Unbounded-vocabulary embedding table with host-side optimizer.

    Rows materialize on first touch (no [vocab, dim] dense alloc) — the
    trillion-parameter recsys pattern of the reference's PS tier.
    """

    def __init__(self, dim: int, optimizer: str = "adagrad", seed: int = 0,
                 init_range: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {list(_OPTIMIZERS)}")
        self.dim = dim
        self.optimizer = optimizer
        self._lib = lib()
        self._h = self._lib.ps_sparse_create(
            dim, _OPTIMIZERS[optimizer], seed, init_range, beta1, beta2, eps)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ps_sparse_destroy(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.ps_sparse_size(self._h))

    def pull(self, keys, create_missing: bool = True) -> np.ndarray:
        keys = _as_i64(keys)
        flat = keys.reshape(-1)
        out = np.empty((flat.size, self.dim), dtype=np.float32)
        self._lib.ps_sparse_pull(self._h, _ip(flat), flat.size, _fp(out),
                                 1 if create_missing else 0)
        return out.reshape(keys.shape + (self.dim,))

    def push(self, keys, grads, lr: float):
        keys = _as_i64(keys).reshape(-1)
        grads = _as_f32(grads).reshape(keys.size, self.dim)
        self._lib.ps_sparse_push(self._h, _ip(keys), keys.size, _fp(grads),
                                 lr)

    @property
    def row_width(self) -> int:
        """dim * (1 + optimizer slot columns) — the full-row stride used
        by the tier-exchange API."""
        return int(self._lib.ps_sparse_row_width(self._h))

    def export_rows(self, keys, create_missing: bool = True) -> np.ndarray:
        """Read FULL rows — (N, row_width): value columns then optimizer
        slot columns — for handing rows to a device-resident hot tier
        (HeterPS promote; reference heter_ps/heter_comm.h)."""
        keys = _as_i64(keys).reshape(-1)
        out = np.empty((keys.size, self.row_width), dtype=np.float32)
        self._lib.ps_sparse_export_rows(self._h, _ip(keys), keys.size,
                                        _fp(out),
                                        1 if create_missing else 0)
        return out

    def import_rows(self, keys, rows):
        """Write FULL rows back (HeterPS flush on eviction): inverse of
        export_rows, creating absent keys."""
        keys = _as_i64(keys).reshape(-1)
        rows = _as_f32(rows).reshape(keys.size, self.row_width)
        self._lib.ps_sparse_import_rows(self._h, _ip(keys), keys.size,
                                        _fp(rows))

    def spill(self, path: str, max_hot_rows: int):
        """Evict least-recently-touched rows beyond ``max_hot_rows`` to a
        disk file (reference table/ssd_sparse_table.cc cold tier); spilled
        rows are promoted back transparently on the next pull/push."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not self._lib.ps_sparse_spill(self._h, path.encode(),
                                         int(max_hot_rows)):
            raise IOError(f"failed to spill sparse table to {path}")

    @property
    def hot_rows(self) -> int:
        return int(self._lib.ps_sparse_hot_rows(self._h))

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not self._lib.ps_sparse_save(self._h, path.encode()):
            raise IOError(f"failed to save sparse table to {path}")

    def load(self, path: str):
        if not self._lib.ps_sparse_load(self._h, path.encode()):
            raise IOError(f"failed to load sparse table from {path} "
                          f"(missing file or dim/optimizer mismatch)")


class DenseTable:
    """Host-resident dense parameter block with host optimizer
    (reference: common_dense_table.cc)."""

    def __init__(self, size: int, optimizer: str = "sgd", beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 init: Optional[np.ndarray] = None):
        self.size = int(size)
        self._lib = lib()
        self._h = self._lib.ps_dense_create(
            self.size, _OPTIMIZERS[optimizer], beta1, beta2, eps)
        if init is not None:
            self.set(init)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ps_dense_destroy(self._h)
            self._h = None

    def set(self, values):
        v = _as_f32(values).reshape(-1)
        assert v.size == self.size
        self._lib.ps_dense_set(self._h, _fp(v))

    def pull(self) -> np.ndarray:
        out = np.empty((self.size,), dtype=np.float32)
        self._lib.ps_dense_pull(self._h, _fp(out))
        return out

    def push(self, grad, lr: float):
        g = _as_f32(grad).reshape(-1)
        assert g.size == self.size
        self._lib.ps_dense_push(self._h, _fp(g), lr)


class GraphTable:
    """Graph store + neighbor sampling for graph-learning PS workloads
    (reference: distributed/table/common_graph_table.cc — adjacency store,
    random_sample_neighboors, node features). Multi-host sharding by node
    key hash happens above (``shard_keys``), like the sparse table."""

    def __init__(self, feat_dim: int = 0, seed: int = 0):
        self.feat_dim = int(feat_dim)
        self._lib = lib()
        self._h = self._lib.ps_graph_create(self.feat_dim, seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ps_graph_destroy(self._h)
            self._h = None

    def add_edges(self, src, dst, weights=None):
        src = _as_i64(src).reshape(-1)
        dst = _as_i64(dst).reshape(-1)
        assert src.size == dst.size
        wp = _fp(_as_f32(weights).reshape(-1)) if weights is not None \
            else None
        self._lib.ps_graph_add_edges(self._h, _ip(src), _ip(dst), wp,
                                     src.size)

    def set_node_feature(self, keys, feats):
        keys = _as_i64(keys).reshape(-1)
        feats = _as_f32(feats).reshape(keys.size, self.feat_dim)
        self._lib.ps_graph_set_feature(self._h, _ip(keys), _fp(feats),
                                       keys.size)

    def node_feature(self, keys) -> np.ndarray:
        keys = _as_i64(keys).reshape(-1)
        out = np.empty((keys.size, self.feat_dim), dtype=np.float32)
        self._lib.ps_graph_get_feature(self._h, _ip(keys), _fp(out),
                                       keys.size)
        return out

    def degree(self, key: int) -> int:
        return int(self._lib.ps_graph_degree(self._h, int(key)))

    def sample_neighbors(self, keys, k: int, seed: int = 0,
                         weighted: bool = False):
        """Sample without replacement: returns (neighbors (N, k) with -1
        padding, counts (N,)). ``weighted=True`` draws edge-weight-
        proportional (Efraimidis-Spirakis); unweighted edges count 1.0."""
        keys = _as_i64(keys).reshape(-1)
        out = np.empty((keys.size, k), dtype=np.int64)
        counts = np.empty((keys.size,), dtype=np.int64)
        self._lib.ps_graph_sample_neighbors(self._h, _ip(keys), keys.size,
                                            int(k), int(seed), _ip(out),
                                            _ip(counts),
                                            1 if weighted else 0)
        return out, counts

    def __len__(self):
        return int(self._lib.ps_graph_num_nodes(self._h))


def shard_keys(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """Hash-shard assignment for multi-host key routing (same mix as the
    native table's internal sharding)."""
    h = keys.astype(np.uint64).copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(num_shards)).astype(np.int64)
