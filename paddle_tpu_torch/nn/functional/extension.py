"""``diag_embed``, ``gather_tree`` and ``temporal_shift``.

Port of ``paddle_tpu/nn/functional/extension.py``. ``gather_tree`` walks
the beam-search steps from the last to the first, following the parent
beam of each step, as a loop over time.
"""
from __future__ import annotations

import torch

__all__ = ["diag_embed", "gather_tree", "temporal_shift"]


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last axis of ``input`` as the ``offset`` diagonal of a new
    (dim1, dim2) plane."""
    x = torch.as_tensor(input)
    n = x.shape[-1] + abs(offset)
    rows = torch.arange(x.shape[-1], device=x.device)
    out = x.new_zeros(tuple(x.shape[:-1]) + (n, n))
    if offset >= 0:
        out[..., rows, rows + offset] = x
    else:
        out[..., rows - offset, rows] = x
    nd = out.dim()
    return torch.movedim(out, (nd - 2, nd - 1), (dim1 % nd, dim2 % nd))


def gather_tree(ids, parents):
    """Full beam-search sequences from each step's ids and parent beams:
    (max_time, batch, beam) -> (max_time, batch, beam)."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents).long()
    beam = ids.shape[-1]
    beams = torch.arange(beam, device=ids.device).expand(
        tuple(ids.shape[1:])).contiguous()
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(ids[t].gather(-1, beams))
        beams = parents[t].gather(-1, beams)
    return torch.stack(out[::-1])


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """The Temporal Shift Module on (N*T, C, H, W): the first
    ``C * shift_ratio`` channels take the next segment's values, the next
    as many the previous segment's, zero at the ends."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format}")
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    pad = torch.nn.functional.pad(x5, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([pad[:, 2:, :c1], pad[:, :-2, c1:c2], x5[:, :, c2:]],
                    dim=2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out
