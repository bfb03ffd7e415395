"""Host content digests of a checkpoint's arrays, for the deep tier.

Port of the digest functions of ``paddle_tpu/resilience/integrity.py``
(``array_digest``, ``tree_digests``, ``compare_digests``). A manifest's
file CRCs attest the bytes on disk; these attest the decoded values, so
``CheckpointManager.verify(step, deep=True)`` catches a corruption that a
file CRC written after it would cover.

An array's digest is ``"crc32:<8 hex>:<nbytes>"``: CRC32 over the dtype's
numpy name (``"float32"``, ``"bfloat16"``, ``"int64"``), the ``repr`` of
the shape as a Python tuple, then the row-major bytes. The same values
give the same string as the reference's, from a tensor on any device, a
numpy array or a Python number. A tree's digests are keyed by the dotted
paths of the checkpoint manifest (``params.gpt.h.0.attn.qkv_proj.weight``).

The rest of the reference module (in-step replica fingerprints, the
quarantine vote, step replay and the hang watchdog) waits in ROADMAP.md
Queue 1, item 8.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

__all__ = ["array_digest", "tree_digests", "compare_digests"]


def _host_bytes(x):
    """(dtype name, shape tuple, row-major bytes as a uint8 array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).rsplit(".", 1)[-1]
        return name, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy()
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
