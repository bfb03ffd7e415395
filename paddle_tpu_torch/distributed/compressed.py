"""Compressed gradient exchange: bucketed block-scaled int8/int4 collectives
with error feedback, over ``torch.distributed``.

Port of ``paddle_tpu/distributed/compressed.py`` (EQuARX-style two-phase
quantized all-reduce). The arithmetic is the reference's as XLA compiles
it, operation for operation in float32 (a division by a constant is a
multiply by its float32 reciprocal, :func:`div_const`), so payloads,
scales and means are the same bits on the same inputs; only the
collectives change:

  phase 0   per-block abs-max, ``all_reduce(MAX)`` over the axis's group
            so every rank quantizes with the same scale (int4: the abs-max
            crosses as bfloat16);
  phase 1   quantize, then ``all_to_all_single`` of the int8 chunks (int4:
            nibble-packed uint8) and a local exact integer sum (int32; int4
            in int16 up to ``INT16_SAFE_RANKS`` ranks);
  phase 2   dequantize the own chunk, re-quantize it with a fresh local
            scale (int4: rounded to its bfloat16 wire format first) and
            ``all_gather`` the int8/packed payload and the scales.

A mesh axis of one rank still quantizes and dequantizes, and updates the
residual, as the reference does for a bound axis of size 1; only ``fp32``
and ``bf16`` are no-ops there. Where no mesh holds the axis (the
reference's unbound axis) :func:`compressed_tree_mean` is the identity.

Trees flatten as ``jax.tree_util`` flattens them (dict keys sorted,
OrderedDict and list/tuple in order, None empty), because the leaves'
order fixes where the blocks and buckets fall.

The last collective of each bucket is issued with ``async_op=True``:
:func:`start_tree_mean` returns a function that waits for it and finishes
the mean, so the trainer can issue a bucket inside the backward and
collect it before the optimizer. :func:`compressed_tree_mean` is the same
call finished at once.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, get_mesh

__all__ = [
    "GRAD_SYNC_POLICIES", "QUANTIZED_POLICIES", "DEFAULT_BLOCK",
    "DEFAULT_INT4_BLOCK", "DEFAULT_BUCKET_BYTES", "INT16_SAFE_RANKS",
    "resolve_block", "int4_accum_dtype",
    "quantize_int8_blocks", "dequantize_int8_blocks",
    "quantize_int4_blocks", "dequantize_int4_blocks",
    "pack_int4", "unpack_int4", "bucket_sizes",
    "compressed_tree_mean", "start_tree_mean", "compressed_psum_scatter",
    "psum_scatter", "all_gather_dim",
    "init_residuals", "normalize_axis_policies", "wire_bytes_per_rank",
    "tree_wire_bytes", "residual_norm", "tree_flatten", "tree_unflatten",
]

GRAD_SYNC_POLICIES = ("fp32", "bf16", "int8", "int4")
QUANTIZED_POLICIES = ("int8", "int4")
DEFAULT_BLOCK = 256          # int8 quantization block
DEFAULT_INT4_BLOCK = 64      # int4: 4-bit steps are coarse -> smaller blocks
DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB of fp32 per collective chunk

# int16 holds a sum of n int4-range (|q| <= 7) values while n * 7 fits
INT16_SAFE_RANKS = (2 ** 15 - 1) // 7   # 4681


def resolve_block(policy: str, block: Optional[int]) -> int:
    """Per-policy default quantization block (block=None)."""
    if block is not None:
        return int(block)
    return DEFAULT_INT4_BLOCK if policy == "int4" else DEFAULT_BLOCK


def int4_accum_dtype(n: int) -> torch.dtype:
    """int16 while n * 7 < 2**15, int32 above."""
    assert n * 7 < 2 ** 31, f"int4 accumulation over n={n} ranks overflows int32"
    return torch.int16 if n <= INT16_SAFE_RANKS else torch.int32


# --------------------------------------------------------------------------
# block quantization
# --------------------------------------------------------------------------

def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as XLA compiles the reference: a
    multiply by the reciprocal rounded to float32 (not an IEEE division;
    the two differ in the last bit of about one result in three)."""
    return x * float(np.float32(1.0) / np.float32(c))


def _quantize(x, block, scale, levels):
    xb = x.reshape(-1, block)
    if scale is None:
        amax = xb.abs().amax(dim=1)
        scale = torch.where(amax > 0, div_const(amax, levels),
                            torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(xb / scale[:, None]), -levels, levels)
    return q.to(torch.int8).reshape(x.shape), scale


def quantize_int8_blocks(x, block: int = DEFAULT_BLOCK, scale=None):
    """Per-block symmetric int8 quantization of a flat float32 tensor
    (size a multiple of ``block``) -> (q int8, scale float32 per block).
    A given ``scale`` is used as it is (the shared-scale path)."""
    return _quantize(x, block, scale, 127.0)


def dequantize_int8_blocks(q, scale, block: int = DEFAULT_BLOCK):
    xb = q.float().reshape(-1, block) * scale[:, None]
    return xb.reshape(q.shape)


def quantize_int4_blocks(x, block: int = DEFAULT_INT4_BLOCK, scale=None):
    """Per-block symmetric int4 quantization: values in [-7, 7] carried in
    int8 (``pack_int4`` packs two per byte for the wire)."""
    return _quantize(x, block, scale, 7.0)


def dequantize_int4_blocks(q, scale, block: int = DEFAULT_INT4_BLOCK):
    """Dequantize int4-range values of any integer dtype (the int16/int32
    sums go straight in)."""
    xb = q.float().reshape(-1, block) * scale[:, None]
    return xb.reshape(q.shape)


def pack_int4(q):
    """Two int4-range int8 values per uint8: element 2i in the low nibble,
    2i+1 in the high one."""
    pairs = q.reshape(-1, 2).to(torch.uint8)
    return (pairs[:, 0] & 0x0F) | ((pairs[:, 1] & 0x0F) << 4)


def unpack_int4(p):
    """Invert :func:`pack_int4`: uint8 -> flat int8, sign-extended."""
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(-1)


# --------------------------------------------------------------------------
# trees, flattened as jax.tree_util flattens them
# --------------------------------------------------------------------------

def tree_flatten(tree):
    """(leaves, spec): dict keys sorted, OrderedDict/list/tuple in order,
    None holds no leaf."""
    if tree is None:
        return [], ("none",)
    if isinstance(tree, OrderedDict):
        keys = list(tree)
        kind = "odict"
    elif isinstance(tree, dict):
        keys = sorted(tree)
        kind = "dict"
    elif isinstance(tree, (list, tuple)):
        keys = list(range(len(tree)))
        kind = type(tree).__name__
    else:
        return [tree], ("leaf",)
    leaves, specs = [], []
    for k in keys:
        sub, spec = tree_flatten(tree[k])
        leaves += sub
        specs.append(spec)
    return leaves, (kind, keys, specs)


def tree_unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s[0] == "none":
            return None
        if s[0] == "leaf":
            return next(it)
        kind, keys, specs = s
        vals = [build(sp) for sp in specs]
        if kind in ("dict", "odict"):
            out = OrderedDict() if kind == "odict" else {}
            for k, v in zip(keys, vals):
                out[k] = v
            return out
        return tuple(vals) if kind == "tuple" else list(vals)

    return build(spec)


# --------------------------------------------------------------------------
# one mesh axis group's collectives
# --------------------------------------------------------------------------

_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _axis_tuple(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class _Axis:
    """The ranks of one exchange group: size ``n``, this rank's index and
    the process group (None for one rank, where nothing is sent)."""

    def __init__(self, mesh: Mesh, axes):
        self.n = mesh.axes_size(axes)
        self.group = mesh.group_of(axes)
        self.rank = mesh.rank_in(axes)

    def pmax_(self, t):
        if self.n > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_to_all(self, x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        return out

    def all_gather_start(self, x) -> Callable[[], torch.Tensor]:
        """Tiled all_gather of a flat tensor, issued now, waited by the
        returned function."""
        out = torch.empty(self.n * x.numel(), dtype=x.dtype, device=x.device)
        work = _all_gather_single(out, x.contiguous(), group=self.group,
                                  async_op=True)
        return lambda: (work.wait(), out)[1]

    def sum_start(self, x) -> Callable[[], torch.Tensor]:
        """all_reduce(SUM) of a copy of ``x``, issued now."""
        x = x.clone(memory_format=torch.contiguous_format)
        work = dist.all_reduce(x, group=self.group, async_op=True)
        return lambda: (work.wait(), x)[1]


def _ready(x):
    return lambda: x


# --------------------------------------------------------------------------
# the two-phase quantized all-reduce over one flat bucket
# --------------------------------------------------------------------------

def _int8_bucket_sum(flat, ax: _Axis, block: int):
    """All-reduce SUM of one flat float32 bucket (size % (n*block) == 0)
    -> (finish, local_recon): ``finish()`` gives the sum; local_recon is
    this rank's dequantized contribution (the residual is flat - it)."""
    _, local_scale = quantize_int8_blocks(flat, block)
    amax = ax.pmax_(local_scale * 127.0)
    scale = div_const(amax.clamp_min(1e-30), 127.0)
    q, _ = quantize_int8_blocks(flat, block, scale=scale)
    recon = dequantize_int8_blocks(q, scale, block)
    n = ax.n
    if n == 1:
        return _ready(recon), recon
    c = flat.numel() // n
    recv = ax.all_to_all(q.reshape(n, c))
    acc = recv.to(torch.int32).sum(dim=0, dtype=torch.int32)     # exact
    nb = c // block
    my_scales = scale[ax.rank * nb:(ax.rank + 1) * nb]
    red = dequantize_int8_blocks(acc, my_scales, block)
    q2, s2 = quantize_int8_blocks(red, block)
    get_q = ax.all_gather_start(q2)
    get_s = ax.all_gather_start(s2)
    return (lambda: dequantize_int8_blocks(get_q(), get_s(), block)), recon


def _int4_bucket_sum(flat, ax: _Axis, block: int):
    """:func:`_int8_bucket_sum` through the packed int4 exchange: nibbles on
    the wire, bfloat16 scales, an int16 (int32 past ``INT16_SAFE_RANKS``)
    local sum."""
    _, local_scale = quantize_int4_blocks(flat, block)
    amax = ax.pmax_((local_scale * 7.0).to(torch.bfloat16))
    scale = div_const(amax.float().clamp_min(1e-30), 7.0)
    q, _ = quantize_int4_blocks(flat, block, scale=scale)
    recon = dequantize_int4_blocks(q, scale, block)
    n = ax.n
    if n == 1:
        return _ready(recon), recon
    c = flat.numel() // n
    recv = ax.all_to_all(pack_int4(q).reshape(n, c // 2))
    vals = unpack_int4(recv.reshape(-1)).reshape(n, c)
    acc_dtype = int4_accum_dtype(n)
    acc = vals.to(acc_dtype).sum(dim=0, dtype=acc_dtype)          # exact
    nb = c // block
    my_scales = scale[ax.rank * nb:(ax.rank + 1) * nb]
    red = dequantize_int4_blocks(acc, my_scales, block)
    # the fresh local scale, rounded to its bf16 wire format BEFORE
    # quantizing, so q2 * gathered scale is self-consistent
    _, s2 = quantize_int4_blocks(red, block)
    s2 = s2.to(torch.bfloat16)
    q2, _ = quantize_int4_blocks(red, block, scale=s2.float())
    get_q = ax.all_gather_start(pack_int4(q2))
    get_s = ax.all_gather_start(s2)
    return (lambda: dequantize_int4_blocks(unpack_int4(get_q()),
                                           get_s().float(), block)), recon


def _bucket_mean(flat, groups, axes, blocks):
    """Mean of one flat float32 bucket over every (axes, policy) group, in
    order (lossless groups first) -> (finish, err): err is this rank's
    total quantization error (None when no group quantizes)."""
    x, err, pending = flat, None, None
    for (_, pol), ax, blk in zip(groups, axes, blocks):
        if pending is not None:
            x, pending = pending(), None
        n = ax.n
        if pol in QUANTIZED_POLICIES:
            fn = _int8_bucket_sum if pol == "int8" else _int4_bucket_sum
            get_sum, recon = fn(x, ax, blk)
            e = x - recon
            err = e if err is None else err + e
            pending = (lambda g=get_sum, n=n: div_const(g(), n))
        elif n > 1:
            if pol == "bf16":
                get_sum = ax.sum_start(x.to(torch.bfloat16))
                pending = (lambda g=get_sum, n=n, dt=x.dtype:
                           div_const(g(), n).to(dt))
            else:
                get_sum = ax.sum_start(x)
                pending = (lambda g=get_sum, n=n: div_const(g(), n))
    return (pending if pending is not None else _ready(x)), err


def normalize_axis_policies(axis, policy):
    """``policy`` (one name, or {axis: policy} with unlisted axes fp32) ->
    ordered exchange groups [(axes_tuple, policy)], lossless first."""
    axes = _axis_tuple(axis)
    if isinstance(policy, str):
        per = {ax: policy for ax in axes}
    else:
        per = {ax: policy.get(ax, "fp32") for ax in axes}
    for ax, p in per.items():
        if p not in GRAD_SYNC_POLICIES:
            raise ValueError(f"grad_sync policy {p!r} for axis {ax!r} "
                             f"not in {GRAD_SYNC_POLICIES}")
    groups = []
    for p in GRAD_SYNC_POLICIES:    # fp32, bf16, int8, int4: lossless first
        g = tuple(ax for ax in axes if per[ax] == p)
        if g:
            groups.append((g, p))
    return groups


# --------------------------------------------------------------------------
# flatten / bucket / exchange / unflatten
# --------------------------------------------------------------------------

def _dtype_groups(leaves):
    """Leaf indices by dtype, in first-appearance order."""
    groups = {}
    for i, v in enumerate(leaves):
        groups.setdefault(v.dtype, []).append(i)
    return groups


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_sizes(total: int, bucket_numel: int, align: int):
    """Split ``total`` (a multiple of ``align``) into bucket sizes, each a
    multiple of ``align``; all but the last are ``bucket_numel``."""
    bucket_numel = max(_round_up(bucket_numel, align), align)
    sizes = []
    done = 0
    while done < total:
        s = min(bucket_numel, total - done)
        sizes.append(s)
        done += s
    return sizes


def _bound(axis, mesh) -> bool:
    return mesh is not None and all(ax in mesh.axis_names
                                    for ax in _axis_tuple(axis))


def start_tree_mean(tree, axis, policy: Union[str, Mapping] = "int8",
                    block: Optional[int] = None,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    residuals=None, mesh: Optional[Mesh] = None):
    """Issue :func:`compressed_tree_mean`'s exchange and return a function
    that finishes it -> (mean_tree, new_residuals). Every phase but the
    last collective of each bucket runs now."""
    groups = normalize_axis_policies(axis, policy)   # also validates
    mesh = mesh if mesh is not None else get_mesh()
    if not _bound(axis, mesh):
        return _ready((tree, residuals))
    axes = [_Axis(mesh, g) for g, _ in groups]
    blocks = [resolve_block(p, block) for _, p in groups]
    align = 1
    for (_, p), ax, blk in zip(groups, axes, blocks):
        if p in QUANTIZED_POLICIES:
            if p == "int4" and blk % 2:
                raise ValueError(f"int4 block must be even, got {blk}")
            align = math.lcm(align, ax.n * blk)
    quantized = any(p in QUANTIZED_POLICIES for _, p in groups)

    leaves, spec = tree_flatten(tree)
    res_leaves, res_spec = (tree_flatten(residuals) if residuals is not None
                            else (None, None))
    use_ef = quantized and res_leaves is not None
    out_leaves = [None] * len(leaves)
    new_res = list(res_leaves) if res_leaves is not None else None
    all_axes = tuple(a for g, _ in groups for a in g)
    whole = _Axis(mesh, all_axes)
    finishers = []

    for dtype, idxs in _dtype_groups(leaves).items():
        if not dtype.is_floating_point:
            # non-float leaves (counters) never quantize: a plain mean
            for i in idxs:
                if whole.n > 1:
                    get_sum = whole.sum_start(leaves[i])
                    finishers.append(
                        lambda i=i, g=get_sum, n=whole.n:
                        out_leaves.__setitem__(i, g() / n))
                else:
                    out_leaves[i] = leaves[i] / 1   # pmean's dtype
            continue
        parts = [leaves[i].reshape(-1).float() for i in idxs]
        if use_ef:
            parts = [p + new_res[i].reshape(-1) for p, i in zip(parts, idxs)]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        total = _round_up(flat.numel(), align)
        if total != flat.numel():
            flat = torch.cat([flat, flat.new_zeros(total - flat.numel())])
        means, errs = [], []
        off = 0
        for s in bucket_sizes(total, max(bucket_bytes // 4, align), align):
            m, e = _bucket_mean(flat[off:off + s], groups, axes, blocks)
            means.append(m)
            errs.append(e)
            off += s
        if use_ef:
            err = errs[0] if len(errs) == 1 else torch.cat(errs)
            off = 0
            for i in idxs:
                sz = leaves[i].numel()
                new_res[i] = err[off:off + sz].reshape(leaves[i].shape)
                off += sz

        def finish_group(idxs=idxs, means=means, dtype=dtype):
            got = [m() for m in means]
            mean = got[0] if len(got) == 1 else torch.cat(got)
            off = 0
            for i in idxs:
                sz = leaves[i].numel()
                out_leaves[i] = mean[off:off + sz].reshape(
                    leaves[i].shape).to(dtype)
                off += sz

        finishers.append(finish_group)

    def finish():
        for f in finishers:
            f()
        out = tree_unflatten(spec, out_leaves)
        res_out = (tree_unflatten(res_spec, new_res)
                   if res_leaves is not None else residuals)
        return out, res_out

    return finish


def compressed_tree_mean(tree, axis, policy: Union[str, Mapping] = "int8",
                         block: Optional[int] = None,
                         bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                         residuals=None, mesh: Optional[Mesh] = None):
    """Mean-reduce a gradient tree over the mesh axes ``axis`` through the
    bucketed compressed exchange -> (mean_tree, new_residuals).

    ``policy`` is one name for every axis, or {axis: policy} (unlisted
    axes fp32): lossless groups pre-reduce first. ``block=None`` takes 256
    for int8 and 64 for int4. ``residuals`` (the error-feedback state,
    same structure, float32) is consumed whenever a group quantizes: the
    exchanged value is ``g + residual`` and the new residual is what the
    quantizer dropped; for fp32/bf16 it passes through. ``mesh`` defaults
    to the current one; with no mesh holding ``axis`` this is the
    identity."""
    return start_tree_mean(tree, axis, policy, block, bucket_bytes,
                           residuals, mesh)()


def _psum_scatter0(x, ax: _Axis):
    """Tiled reduce-scatter SUM along dim 0: ``reduce_scatter_tensor`` on
    NCCL; on gloo, which has no reduce-scatter of one tensor, an
    all_reduce and this rank's chunk."""
    if ax.n == 1:
        return x
    if dist.get_backend(ax.group) == "nccl":
        x = x.contiguous()
        out = torch.empty((x.shape[0] // ax.n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=ax.group)
        return out
    full = ax.sum_start(x)()
    return torch.chunk(full, ax.n, dim=0)[ax.rank].contiguous()


def psum_scatter(x, axis, scatter_dim: int = 0,
                 mesh: Optional[Mesh] = None):
    """Lossless tiled reduce-scatter SUM of ``x`` over ``axis`` along
    ``scatter_dim`` (the reference's ``lax.psum_scatter(tiled=True)``):
    this rank's chunk of the sum."""
    ax = _Axis(mesh if mesh is not None else get_mesh(), axis)
    if ax.n == 1:
        return x
    if x.shape[scatter_dim] % ax.n:
        raise ValueError(f"scatter dim size {x.shape[scatter_dim]} not "
                         f"divisible by axis size {ax.n}")
    out = _psum_scatter0(torch.movedim(x, scatter_dim, 0), ax)
    return torch.movedim(out, 0, scatter_dim).contiguous()


def all_gather_dim(x, axis, dim: int = 0, mesh: Optional[Mesh] = None):
    """Tiled all_gather of ``x`` over ``axis`` along ``dim`` (the
    reference's ``lax.all_gather(tiled=True)``): the ranks' chunks in
    rank order."""
    ax = _Axis(mesh if mesh is not None else get_mesh(), axis)
    if ax.n == 1:
        return x
    xm = torch.movedim(x, dim, 0).contiguous()
    flat = ax.all_gather_start(xm.reshape(-1))()
    out = flat.reshape((ax.n * xm.shape[0],) + tuple(xm.shape[1:]))
    return torch.movedim(out, 0, dim).contiguous()


def compressed_psum_scatter(x, axis, scatter_dim: int = 0,
                            policy: str = "int8",
                            block: Optional[int] = None,
                            residual=None, mesh: Optional[Mesh] = None):
    """Block-quantized reduce-scatter SUM over ``axis`` (phase 1 of the
    exchange, no gather): the compressed counterpart of a tiled
    reduce-scatter along ``scatter_dim``. Returns the SUM (callers divide
    by the axis size). With ``residual`` (float32, x's shape) the input is
    ``x + residual`` and the call returns ``(out, new_residual)``, this
    rank's full-tensor quantization error. Lossless policies reduce-scatter
    plainly (bf16: through a bfloat16 cast) and pass a residual through."""
    if policy not in GRAD_SYNC_POLICIES:
        raise ValueError(f"grad_sync policy {policy!r} not in "
                         f"{GRAD_SYNC_POLICIES}")
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        mesh = Mesh({})
    ax = _Axis(mesh, axis)
    n = ax.n
    if policy not in QUANTIZED_POLICIES:
        y = x.to(torch.bfloat16) if (policy == "bf16" and
                                     x.dtype == torch.float32) else x
        out = torch.movedim(_psum_scatter0(torch.movedim(y, scatter_dim, 0),
                                           ax), 0, scatter_dim).to(x.dtype)
        return out if residual is None else (out, residual)
    blk = resolve_block(policy, block)
    if policy == "int4":
        if blk % 2:
            raise ValueError(f"int4 block must be even, got {blk}")
        quant, dequant, levels = (quantize_int4_blocks,
                                  dequantize_int4_blocks, 7.0)
    else:
        quant, dequant, levels = (quantize_int8_blocks,
                                  dequantize_int8_blocks, 127.0)
    xm = torch.movedim(x, scatter_dim, 0)
    if residual is not None:
        xm = xm.float() + torch.movedim(residual, scatter_dim, 0).float()
    d0 = xm.shape[0]
    if d0 % n:
        raise ValueError(f"scatter dim size {d0} not divisible by axis "
                         f"size {n}")
    chunk_shape = (d0 // n,) + tuple(xm.shape[1:])
    m = math.prod(chunk_shape)
    m_pad = _round_up(max(m, 1), blk)
    rows = xm.float().reshape(n, m)
    if m_pad != m:
        rows = torch.cat([rows, rows.new_zeros(n, m_pad - m)], dim=1)
    flat = rows.reshape(-1)
    _, local_scale = quant(flat, blk)
    amax = local_scale * levels
    if policy == "int4":
        amax = ax.pmax_(amax.to(torch.bfloat16)).float()
    else:
        amax = ax.pmax_(amax)
    scale = div_const(amax.clamp_min(1e-30), levels)
    q, _ = quant(flat, blk, scale=scale)
    if n > 1:
        if policy == "int4":
            recv = ax.all_to_all(pack_int4(q).reshape(n, m_pad // 2))
            vals = unpack_int4(recv.reshape(-1)).reshape(n, m_pad)
            acc_dtype = int4_accum_dtype(n)
            acc = vals.to(acc_dtype).sum(dim=0, dtype=acc_dtype)
        else:
            recv = ax.all_to_all(q.reshape(n, m_pad))
            acc = recv.to(torch.int32).sum(dim=0, dtype=torch.int32)
        nsc = m_pad // blk
        my_scales = scale[ax.rank * nsc:(ax.rank + 1) * nsc]
    else:
        acc, my_scales = q, scale
    red = dequant(acc, my_scales, blk)
    out = red[:m].reshape(chunk_shape)
    out = torch.movedim(out, 0, scatter_dim).to(x.dtype)
    if residual is None:
        return out
    recon = dequant(q, scale, blk).reshape(n, m_pad)
    err = (rows - recon)[:, :m].reshape((d0,) + chunk_shape[1:])
    return out, torch.movedim(err, 0, scatter_dim)


def init_residuals(tree):
    """Zero error-feedback state for a gradient tree (float32 leaves)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [torch.zeros(v.shape, dtype=torch.float32,
                                             device=v.device)
                                 for v in leaves])


# --------------------------------------------------------------------------
# wire accounting
# --------------------------------------------------------------------------

def wire_bytes_per_rank(numel: int, n: int, policy: str,
                        block: Optional[int] = None,
                        dtype_bytes: int = 4) -> float:
    """Bytes each rank moves for one mean over ``numel`` elements, ring
    algorithms (all-reduce 2(n-1)/n payloads, reduce-scatter and
    all-gather (n-1)/n each); the quantized figures count both phases and
    every scale exchange. Zero for one rank."""
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    nscales = numel / resolve_block(policy, block)
    if policy == "fp32":
        return 2 * ring * numel * dtype_bytes
    if policy == "bf16":
        return 2 * ring * numel * 2
    if policy == "int8":
        return (2 * ring * nscales * 4        # phase 0: scale max
                + ring * numel * 1            # phase 1: int8 all_to_all
                + ring * (numel * 1 + nscales * 4))  # phase 2: all_gather
    if policy == "int4":
        return (2 * ring * nscales * 2        # phase 0: bf16 scale max
                + ring * numel * 0.5          # phase 1: packed all_to_all
                + ring * (numel * 0.5 + nscales * 2))  # phase 2: all_gather
    raise ValueError(f"unknown policy {policy!r}")


def tree_wire_bytes(tree, n: int, policy: str,
                    block: Optional[int] = None) -> float:
    """Bytes one :func:`compressed_tree_mean` over ``n`` ranks moves per
    rank for this tree: float leaves coalesce per dtype into one float32
    flat padded to ``n * block``; other leaves take a per-leaf mean."""
    if n <= 1:
        return 0.0
    blk = resolve_block(policy, block)
    leaves, _ = tree_flatten(tree)
    align = n * blk
    total = 0.0
    for dtype, idxs in _dtype_groups(leaves).items():
        sizes = [int(leaves[i].numel()) for i in idxs]
        if not dtype.is_floating_point:
            itemsize = torch.empty((), dtype=dtype).element_size()
            total += sum(2 * (n - 1) / n * s * itemsize for s in sizes)
            continue
        padded = _round_up(sum(sizes), align)
        total += wire_bytes_per_rank(padded, n, policy, blk)
    return total


def residual_norm(tree) -> float:
    """L2 norm of the error-feedback residual state (one host sync)."""
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return 0.0
    sq = sum(torch.sum(torch.square(v.float())) for v in leaves)
    return float(torch.sqrt(sq))
