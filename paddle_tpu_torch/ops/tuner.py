"""Shape bucketing, the flash-attention rows of the tuning DB, and
kernel-fallback accounting.

Port of pieces of ``paddle_tpu/ops/pallas/tuner.py``: ``shape_bucket``
(the power-of-two bucket axis that keeps the serving batch shapes in a
closed set), ``flash_dims``, ``ce_dims``, ``resolve`` over the DB's
device-generic (``"any"``) ``flash_attention`` and ``fused_ce`` rows,
copied here as data, and ``record_fallback``. The port needs the flash
rows only for the blocks that key the flash kernels' dropout mask
(``ops/flash_attention.py``) and the fused-CE rows only to answer as the
reference does (``ops/fused_ce.py``); its own CUDA tiling is its own.
``resolve`` answers as the reference does off a TPU: a generic row if one
matches, else the defaults.

``record_fallback(kernel)`` is called when a dispatcher sends a shape that
the kernel's gate rejects to the plain path. It always bumps
``FALLBACKS[kernel]`` (read by ``chip_smoke.py``) and, with telemetry on,
``kernel_fallbacks_total{kernel}``.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Tuple

__all__ = ["shape_bucket", "flash_dims", "ce_dims", "make_key", "resolve",
           "DB_ROWS", "record_fallback", "FALLBACKS"]

FALLBACKS: "collections.Counter[str]" = collections.Counter()
_lock = threading.Lock()

GENERIC_DEVICE = "any"

# the "any"-device flash_attention and fused_ce rows of
# paddle_tpu/ops/pallas/tuning_db.json: key -> config
DB_ROWS: Dict[str, Dict[str, int]] = {
    "flash_attention|any|bfloat16|d64,sk1024,sq1024":
        {"block_q": 256, "block_k": 512},
    "flash_attention|any|bfloat16|d64,sk128,sq128":
        {"block_q": 128, "block_k": 128},
    "flash_attention|any|bfloat16|d64,sk2048,sq2048":
        {"block_q": 256, "block_k": 512},
    "flash_attention|any|float32|d64,sk128,sq128":
        {"block_q": 128, "block_k": 128},
    "flash_attention|any|float32|d64,sk256,sq256":
        {"block_q": 128, "block_k": 128},
    "flash_attention|any|float32|d64,sk512,sq512":
        {"block_q": 256, "block_k": 512},
    "fused_ce|any|bfloat16|h768,t8192,v50304":
        {"block_tokens": 256, "block_vocab": 2048},
    "fused_ce|any|float32|h128,t512,v1024":
        {"block_tokens": 256, "block_vocab": 1024},
    "fused_ce|any|float32|h64,t128,v512":
        {"block_tokens": 128, "block_vocab": 512},
}


def shape_bucket(n: int, floor: int = 128) -> int:
    """Next power of two >= n (min ``floor``)."""
    n = max(int(n), 1)
    b = floor
    while b < n:
        b <<= 1
    return b


def flash_dims(d: int, sq: int, sk: int) -> Dict[str, int]:
    """Bucketed dims of a flash-attention call: head_dim exact, sq bucketed
    with floor 1 (decode-shaped calls keep exact keys), sk with floor 128."""
    return {"d": int(d), "sq": shape_bucket(sq, floor=1),
            "sk": shape_bucket(sk)}


def ce_dims(h: int, v: int, tokens: int) -> Dict[str, int]:
    """Bucketed dims of a fused-CE call: hidden and vocab exact (vocab is a
    model constant, not a batch axis), the token count bucketed."""
    return {"h": int(h), "v": int(v), "t": shape_bucket(tokens)}


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def make_key(kernel: str, device: str, dtype, dims: Dict[str, int]) -> str:
    dim_s = ",".join(f"{k}{int(v)}" for k, v in sorted(dims.items()))
    return f"{kernel}|{device}|{_dtype_name(dtype)}|{dim_s}"


def resolve(kernel: str, dtype, dims: Dict[str, int],
            defaults: Dict[str, int]) -> Tuple[Dict[str, int], str]:
    """(config, source): the generic DB row for the key ("db"), else
    ``defaults`` ("default")."""
    row = DB_ROWS.get(make_key(kernel, GENERIC_DEVICE, dtype, dims))
    if row is None:
        return dict(defaults), "default"
    cfg = dict(defaults)
    cfg.update(row)
    return cfg, "db"


def record_fallback(kernel: str):
    """Count one dispatch of ``kernel``'s work to the plain path."""
    with _lock:
        FALLBACKS[kernel] += 1
    from .. import telemetry
    if telemetry.enabled():
        telemetry.counter(
            "kernel_fallbacks_total",
            "kernel dispatches sent to the plain path by the shape gate"
        ).inc(kernel=kernel)
