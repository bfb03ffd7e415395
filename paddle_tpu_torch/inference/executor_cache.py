"""paddle_tpu_torch.inference.executor_cache — the persistent warm set of
served shapes, so scale-up and respawn stop paying
``serving_recompiles_total`` cold starts.

Port of ``paddle_tpu/inference/executor_cache.py``. The serving batcher
keeps every batch inside a small closed set of ``(input signature, row
bucket)`` shapes; the first batch of each pays the first call of the
program at that shape (in the port: the kernels' first launches at it,
cuBLAS's set-up, the allocator's first blocks). That set is a property of
the ARTIFACT, not of one server, so this module persists it (a JSON
manifest, atomic replace, a corrupt file read as empty with a warning,
an environment override) and replays it into new servers:

- ``attach(server, key, cache)`` hooks the server's ``shape_observer`` so
  every first-seen shape is recorded (and the manifest saved).
- ``prime(server, key, cache)`` runs one zero batch per recorded shape
  through every replica executor BEFORE the server takes traffic, then
  seeds ``server.warm_start`` so those shapes never count as recompiles.

Signatures are stored as the ``repr`` of the request signature (per-row
shape + numpy dtype str per input) and parsed back with
``ast.literal_eval``. The manifest format is the reference's, so a
manifest the reference wrote loads here. Executors whose inputs cannot be
made from the signature alone (decode steps over a live KV cache) pass a
``prime_fn``.

The manifest's default home is ``~/.cache/paddle_tpu_torch/
executor_cache.json``; ``PADDLE_TPU_TORCH_EXECUTOR_CACHE`` overrides it.
"""
from __future__ import annotations

import ast
import json
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ExecutorCache", "artifact_key", "default_cache_path",
           "attach", "prime"]

_VERSION = 1


def default_cache_path() -> str:
    """``PADDLE_TPU_TORCH_EXECUTOR_CACHE`` or a user-cache-dir default."""
    env = os.environ.get("PADDLE_TPU_TORCH_EXECUTOR_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "executor_cache.json")


def artifact_key(prefix: str, quant=None) -> str:
    """Stable per-artifact key: the model path + quant spec. Deliberately
    NOT the mtime/size layer-cache key — a hot-swapped generation at the
    same path serves the same shape set, so the warm set survives model
    updates."""
    return f"{os.path.abspath(prefix)}|quant={quant}"


class ExecutorCache:
    """``{artifact_key: [[sig_repr, bucket], ...]}`` with JSON round-trip."""

    def __init__(self, entries: Optional[Dict[str, list]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, list] = {k: list(v)
                                         for k, v in (entries or {}).items()}
        self.path = path
        self._lock = threading.Lock()

    # -- io -----------------------------------------------------------------
    @classmethod
    def load(cls, path: Optional[str] = None) -> "ExecutorCache":
        """Missing or corrupt manifests yield an EMPTY cache (warn on
        corruption) — a broken warm set must never block serving."""
        path = path or default_cache_path()
        if not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict) or \
                    not isinstance(raw.get("entries", {}), dict):
                raise ValueError("not an executor cache object")
            return cls(raw.get("entries", {}), path=path)
        except (OSError, ValueError) as e:
            warnings.warn(f"executor cache {path!r} unreadable ({e}); "
                          "treating as empty", stacklevel=2)
            return cls(path=path)

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            raise ValueError("ExecutorCache.save: no path")
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        with self._lock:
            payload = {"version": _VERSION, "entries": self.entries}
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)

    # -- access -------------------------------------------------------------
    def record(self, key: str, sig, bucket: int) -> bool:
        """Record a first-seen shape; returns True when it was new."""
        row = [repr(sig), int(bucket)]
        with self._lock:
            rows = self.entries.setdefault(key, [])
            if row in rows:
                return False
            rows.append(row)
            return True

    def shapes(self, key: str) -> List[Tuple[tuple, int]]:
        """Recorded ``(signature, bucket)`` pairs for an artifact.
        Unparseable rows are skipped (forward/backward compatible)."""
        with self._lock:
            rows = list(self.entries.get(key, []))
        out = []
        for sig_repr, bucket in rows:
            try:
                out.append((ast.literal_eval(sig_repr), int(bucket)))
            except (ValueError, SyntaxError):
                continue
        return out

    def __len__(self):
        with self._lock:
            return sum(len(v) for v in self.entries.values())


def attach(server, key: str, cache: ExecutorCache,
           autosave: bool = True) -> None:
    """Record every first-seen shape the server serves under ``key``."""

    def _observe(sig, bucket):
        if cache.record(key, sig, bucket) and autosave and cache.path:
            try:
                cache.save()
            except OSError:
                pass  # a read-only cache dir must not fail serving

    server.shape_observer = _observe


def _synth_batch(sig, bucket: int) -> List[np.ndarray]:
    """Zero arrays matching one recorded ``(sig, bucket)`` shape."""
    return [np.zeros((bucket,) + tuple(tail), dtype=np.dtype(dtype_str))
            for tail, dtype_str in sig]


def prime(server, key: str, cache: ExecutorCache,
          prime_fn: Optional[Callable] = None) -> int:
    """Run the recorded shape set through ``server``'s replicas BEFORE it
    takes traffic, then seed ``warm_start`` so the shapes never count as
    recompiles. ``prime_fn(sig, bucket)`` replaces the zero-batch call for
    executors with out-of-band state (decode). Returns the number of
    primed shapes."""
    pairs = cache.shapes(key)
    primed = []
    for sig, bucket in pairs:
        try:
            if prime_fn is not None:
                prime_fn(sig, bucket)
            else:
                arrays = _synth_batch(sig, bucket)
                for replica in server.replicas:
                    replica.fn(arrays)
        except Exception as e:  # noqa: BLE001 - stale entry, skip it
            warnings.warn(f"executor-cache prime skipped {sig!r} x "
                          f"{bucket}: {e!r}", stacklevel=2)
            continue
        primed.append((sig, bucket))
    server.warm_start(primed)
    return len(primed)
