"""Shape and layout manipulation ops (reference:
python/paddle/tensor/manipulation.py).

Port of ``paddle_tpu/tensor/manipulation.py``. The ops whose output size
depends on the data (``masked_select``, ``unique``, ``nonzero``) run
eagerly, as in the reference.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ._util import as_tensor

__all__ = [
    "reshape", "transpose", "t", "moveaxis", "concat", "stack", "unstack",
    "split", "chunk", "squeeze", "unsqueeze", "flatten", "flip", "rot90",
    "roll", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "cast", "slice", "strided_slice", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "scatter_nd", "index_select",
    "index_sample", "take_along_axis", "put_along_axis", "masked_select",
    "unique", "unique_consecutive", "unbind", "where", "nonzero", "sort",
    "argsort", "topk", "argmax", "argmin", "searchsorted", "bucketize",
    "repeat_interleave", "crop", "pad", "as_complex", "as_real", "view",
    "tensordot", "rank", "reverse", "crop_tensor", "shard_index",
    "set_printoptions",
]


def _ints(seq):
    if isinstance(seq, torch.Tensor):
        return [int(s) for s in seq.reshape(-1).tolist()]
    if isinstance(seq, int):
        return [seq]
    return [int(s) for s in seq]


def reshape(x, shape, name=None):
    return torch.reshape(x, tuple(_ints(shape)))


def transpose(x, perm, name=None):
    return x.permute(*_ints(perm))


def t(x, name=None):
    if x.ndim <= 1:
        return x
    return x.transpose(-1, -2)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not split into {num_or_sections}")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    sections = list(num_or_sections)
    total = x.shape[axis]
    if builtins.any(s in (-1, None) for s in sections):
        known = builtins.sum(s for s in sections if s not in (-1, None))
        sections = [total - known if s in (-1, None) else s
                    for s in sections]
    return list(torch.split(x, [int(s) for s in sections], dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return list(torch.tensor_split(x, chunks, dim=axis))


def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    axes = (axis,) if isinstance(axis, int) else tuple(_ints(axis))
    out_ndim = x.ndim + len(axes)
    for a in sorted(a % out_ndim for a in axes):
        x = torch.unsqueeze(x, a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flip(x, axis, name=None):
    return torch.flip(x, _ints(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, _ints(axes))


def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(x, tuple(_ints(repeat_times)))


def expand(x, shape, name=None):
    shape = [-1 if s is None else int(s) for s in shape]
    lead = len(shape) - x.ndim
    shape = [x.shape[i - lead] if s == -1 and i >= lead else s
             for i, s in enumerate(shape)]
    return x.expand(*shape)


def expand_as(x, y, name=None):
    return x.expand_as(y)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, tuple(_ints(shape)))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def cast(x, dtype):
    return x.to(dtype_mod.convert_dtype(dtype))


def slice(x, axes, starts, ends, name=None):
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(st), int(en))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        rows = range(*builtins.slice(int(st), int(en), int(sd)).indices(
            x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(list(rows),
                                                   dtype=torch.long,
                                                   device=x.device))
    return x


def gather(x, index, axis=0, name=None):
    return torch.index_select(x, axis, index.reshape(-1).long())


def gather_nd(x, index, name=None):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    index = index.reshape(-1).long()
    out = x.clone()
    if overwrite:
        out[index] = updates.to(x.dtype)
        return out
    # accumulate: zero the target rows, then add
    out[index] = torch.zeros_like(updates, dtype=x.dtype)
    return out.index_put_((index,), updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    idx = tuple(torch.movedim(index.long(), -1, 0))
    return x.clone().index_put_(idx, updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    x = torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(x, index, updates)


def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, axis, index.reshape(-1).long())


def index_sample(x, index):
    return torch.gather(x, 1, index.long())


def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(arr, indices.long(), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    idx = indices.long()
    values = torch.broadcast_to(
        torch.as_tensor(values, dtype=arr.dtype, device=arr.device),
        idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, values)
    if reduce == "add":
        return arr.scatter_add(axis, idx, values)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, idx, values, "prod")
    raise ValueError(f"unknown reduce {reduce!r}")


def masked_select(x, mask, name=None):
    return x[mask.bool()]


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    vals, inverse, counts = torch.unique(x, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    out = [vals]
    if return_index:
        # the first position of each value: the least index mapping to it
        flat_inv = inverse.reshape(-1)
        pos = torch.arange(flat_inv.numel(), device=x.device)
        first = torch.full((vals.shape[0] if axis is not None else
                            vals.numel(),), flat_inv.numel(),
                           dtype=torch.long, device=x.device)
        out.append(first.scatter_reduce(0, flat_inv, pos, "amin"))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    res = torch.unique_consecutive(
        x if axis is not None else x.reshape(-1),
        return_inverse=return_inverse, return_counts=return_counts,
        dim=axis)
    return res


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return torch.where(condition.bool(), x, y)


def nonzero(x, as_tuple=False):
    return torch.nonzero(x, as_tuple=as_tuple)


def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


def argsort(x, axis=-1, descending=False, name=None):
    out = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(out, [axis]) if descending else out


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    res = torch.topk(x, k, dim=-1 if axis is None else axis,
                     largest=largest, sorted=sorted)
    return res.values, res.indices


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    if axis is None and keepdim:
        out = torch.argmax(x).reshape((1,) * x.ndim)
    else:
        out = torch.argmax(x, dim=axis, keepdim=keepdim)
    return out.to(dtype_mod.convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    if axis is None and keepdim:
        out = torch.argmin(x).reshape((1,) * x.ndim)
    else:
        out = torch.argmin(x, dim=axis, keepdim=keepdim)
    return out.to(dtype_mod.convert_dtype(dtype))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.bucketize(x, sorted_sequence, out_int32=out_int32,
                           right=right)


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def crop(x, shape=None, offsets=None, name=None):
    offsets = offsets or [0] * x.ndim
    shape = shape or list(x.shape)
    idx = tuple(builtins.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return x[idx]


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """The reference's ``nn.functional.pad``: a pad list of ``2 * ndim``
    entries pads every dim in order (before, after); a shorter one pads
    the spatial dims, the last one first."""
    pad = _ints(pad)
    if len(pad) == 2 * x.ndim:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.ndim)]
    else:
        n_spatial = len(pad) // 2
        cfg = [(0, 0)] * x.ndim
        channel_last = data_format[-1] == "C"
        spatial = (list(range(1, 1 + n_spatial)) if channel_last
                   else list(range(x.ndim - n_spatial, x.ndim)))
        for i, ax in enumerate(reversed(spatial)):
            cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
    mode_map = {"constant": "constant", "reflect": "reflect",
                "replicate": "replicate", "circular": "circular"}
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    # torch pads the trailing dims of a (batch, channel, ...) tensor: fold
    # the dims before the first padded one into the channel dim
    padded = [i for i, c in enumerate(cfg) if c != (0, 0)]
    if not padded:
        return x.clone()
    lead = padded[0]
    y = x.reshape((1, -1) + tuple(x.shape[lead:]))
    out = torch.nn.functional.pad(y, flat[:2 * (x.ndim - lead)],
                                  mode=mode_map[mode])
    return out.reshape(tuple(x.shape[:lead]) + tuple(out.shape[2:]))


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def view(x, shape):
    return torch.reshape(x, tuple(_ints(shape)))


def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(x, y, dims=axes)


def rank(input):
    """Number of dimensions (reference operators/rank_op)."""
    return torch.tensor(as_tensor(input).ndim, dtype=torch.int32)


def reverse(x, axis, name=None):
    return flip(x, axis)


crop_tensor = crop


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Recompute a global index into a shard-local one (reference
    operators/shard_index_op.cc)."""
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range [0, {nshards})")
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") == \
        shard_id
    return torch.where(in_shard, torch.remainder(input, shard_size),
                       torch.full_like(input, ignore_value))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """The reference's print options on torch's (and numpy's) printer."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not bool(sci_mode)
    np.set_printoptions(**kw)
