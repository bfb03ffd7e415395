"""Int8/int4 block weight quantization for served models.

Port of ``paddle_tpu/inference/quant.py``. The EQuARX-style block
quantizer of ``distributed/compressed.py`` (arXiv:2506.17615), applied to
the weights of a loaded ``jit.load`` model instead of the gradient wire:
each float parameter is flattened, padded to a block multiple, and kept
as int8 (or nibble-packed int4) plus one float32 scale per block, ~3.9x
(int8) / ~7x (int4) smaller at rest than float32. Compute still runs in
the program's dtype (weight-only quantization), so the error is the block
rounding alone (at most amax/127 resp. amax/7 per block).

The port quantizes with its torch quantizers on the weights' own device
(the card, when the program is the card's), bit for bit the reference's
numpy results. The reference quantizes weights eagerly, outside any jit:
its block scale is an IEEE division ``amax / 127`` (``/ 7``), where its
jitted gradient exchange multiplies by the reciprocal (what
``compressed``'s own scale copies). So the scale is computed here, as a
division, and handed to the block quantizers.

Non-finite weights behave as in the reference. Its scale
``where(amax > 0, amax / 127, 1)`` is 1 for a block holding a NaN, and the
NaN casts to an int8 0, so the block is served as rounded small weights
(mostly zeros): a NaN checkpoint serves finite answers. A block holding an
inf has an inf scale and dequantizes to NaN (0 * inf), so an inf
checkpoint serves NaN.

As in the reference, a bfloat16 tensor is not quantized:
the reference asks ``np.issubdtype(dtype, np.floating)``, which is false
for ml_dtypes' bfloat16, so every bfloat16 leaf passes through and a
bfloat16 model reports ``compression_x`` 1.0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed import compressed as C

__all__ = ["QuantizedArray", "quantize_array", "dequantize_array",
           "quantize_state", "dequantize_state", "state_bytes",
           "quantized_layer"]

# numpy's floating dtypes (bfloat16 is not one of them; see above)
_QUANTIZABLE = (torch.float16, torch.float32, torch.float64)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


class QuantizedArray:
    """One block-quantized tensor: ``q`` (int8, or packed uint8 nibbles
    for int4) + per-block float32 ``scale`` + the original shape/dtype."""

    __slots__ = ("policy", "block", "q", "scale", "shape", "dtype", "size")

    def __init__(self, policy: str, block: int, q: torch.Tensor,
                 scale: torch.Tensor, shape: Tuple[int, ...], dtype,
                 size: int):
        self.policy = policy
        self.block = block
        self.q = q
        self.scale = scale
        self.shape = shape
        self.dtype = dtype
        self.size = size  # unpadded element count

    @property
    def nbytes(self) -> int:
        return int(_nbytes(self.q) + _nbytes(self.scale))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_array(x, policy: str = "int8",
                   block: Optional[int] = None) -> QuantizedArray:
    """Block-quantize one tensor (any shape, any float dtype), on its
    device."""
    if policy not in ("int8", "int4"):
        raise ValueError(f"weight quant policy must be int8/int4, "
                         f"got {policy!r}")
    block = C.resolve_block(policy, block)
    t = _tensor(x)
    flat = t.detach().reshape(-1).to(torch.float32)
    size = flat.numel()
    pad = (-size) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    levels = 127.0 if policy == "int8" else 7.0
    amax = flat.reshape(-1, block).abs().amax(dim=1)
    # the reference's where(amax > 0, amax / levels, 1). The divisor is a
    # tensor: PyTorch's CUDA division by a Python scalar multiplies by its
    # reciprocal, which would part the card from the CPU
    scale = torch.where(amax > 0, amax / torch.full_like(amax, levels),
                        torch.ones_like(amax))
    if policy == "int8":
        q, scale = C.quantize_int8_blocks(flat, block, scale=scale)
    else:
        q, scale = C.quantize_int4_blocks(flat, block, scale=scale)
        q = C.pack_int4(q.reshape(-1))
    return QuantizedArray(policy, block, q, scale.to(torch.float32),
                          tuple(t.shape), t.dtype, size)


def dequantize_array(qa: QuantizedArray) -> torch.Tensor:
    if qa.policy == "int8":
        flat = C.dequantize_int8_blocks(qa.q, qa.scale, qa.block)
    else:
        flat = C.dequantize_int4_blocks(C.unpack_int4(qa.q), qa.scale,
                                        qa.block)
    return flat.reshape(-1)[:qa.size].reshape(qa.shape).to(qa.dtype)


def _quantizable(x, block: int) -> bool:
    t = _tensor(x)
    return t.dtype in _QUANTIZABLE and t.numel() >= block


def quantize_state(params: Dict[str, object], policy: str = "int8",
                   block: Optional[int] = None) -> Dict[str, object]:
    """Quantize every float parameter large enough to amortize a scale
    block; small, integer and bfloat16 leaves pass through unchanged."""
    rblock = C.resolve_block(policy, block)
    out: Dict[str, object] = {}
    for k, v in params.items():
        out[k] = (quantize_array(v, policy, rblock)
                  if _quantizable(v, rblock) else _tensor(v))
    return out


def dequantize_state(state: Dict[str, object]) -> Dict[str, torch.Tensor]:
    return {k: dequantize_array(v) if isinstance(v, QuantizedArray)
            else _tensor(v) for k, v in state.items()}


def state_bytes(state: Dict[str, object]) -> int:
    return int(sum(v.nbytes if isinstance(v, QuantizedArray)
                   else _nbytes(_tensor(v)) for v in state.values()))


def quantized_layer(layer, policy: str = "int8",
                    block: Optional[int] = None):
    """Return (a TranslatedLayer over the same program with dequantized
    weights, stats dict). Buffers are left exact."""
    from .. import jit, telemetry

    raw = dict(layer._params)
    qstate = quantize_state(raw, policy, block)
    deq = dequantize_state(qstate)
    fp_bytes = state_bytes(raw)
    q_bytes = state_bytes(qstate)
    stats = {
        "policy": policy,
        "params_bytes_fp": fp_bytes,
        "params_bytes_quant": q_bytes,
        "compression_x": (fp_bytes / q_bytes) if q_bytes else 1.0,
        "n_quantized": sum(1 for v in qstate.values()
                           if isinstance(v, QuantizedArray)),
    }
    if telemetry.enabled():
        telemetry.gauge(
            "serving_weight_compression_x",
            "fp weight bytes / quantized weight bytes").set(
                stats["compression_x"], policy=policy)
    out = jit.TranslatedLayer(layer._exported, deq, dict(layer._buffers),
                              device=layer.device)
    out.quant_stats = stats
    return out, stats
