"""Megatron-style tensor-parallel layers.

Port of ``paddle_tpu/distributed/meta_parallel/parallel_layers/mp_layers.py``
(reference ``fleet/meta_parallel/parallel_layers/mp_layers.py``:
``VocabParallelEmbedding:30``, ``ColumnParallelLinear:97``,
``RowParallelLinear:170``, ``ParallelCrossEntropy:249``). The port takes the
reference's shard_map branch, its explicit-collective algebra: one process
per card, and each rank of the current mesh's ``model`` axis holds ITS
slice of each split weight, made at construction as the full weight's
chunk (so a seed gives the same logical weights at every degree). A
parameter's ``pspec`` names the axis each of its dims is split over, as
the reference's ``Parameter.pspec``; checkpoints and
``Layer.set_state_dict_from_numpy`` read it. Build the mesh
(``build_mesh`` or ``fleet.init``) before the model: without one, or with
a ``model`` axis of 1, every layer holds whole weights and issues no
collective.

Megatron's operators are ``torch.autograd.Function``s over the mesh's
``model`` group:

- :func:`copy_to_model_parallel` ("f"): identity forward, all-reduce
  backward;
- :func:`reduce_from_parallel_region` ("g"): all-reduce forward, IDENTITY
  backward. ``torch.distributed.nn.functional.all_reduce`` is not used:
  its backward is another all-reduce, which would scale every upstream
  gradient by the degree (the trap the reference's docstring describes);
- :func:`gather_from_model_parallel`: all-gather along the last dim
  forward, this rank's chunk backward.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ....nn import functional as F
from ....nn.initializer import XavierUniform
from ....nn.layer import Layer
from ...mesh import get_mesh

__all__ = ["MODEL_AXIS", "copy_to_model_parallel",
           "reduce_from_parallel_region", "gather_from_model_parallel",
           "model_parallel", "VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "ParallelColumnLinearWithGeluFused"]

MODEL_AXIS = "model"


def model_parallel(axis: str = MODEL_AXIS):
    """``(group, degree, rank)`` of the current mesh's ``axis``;
    ``(None, 1, 0)`` without a mesh or at degree 1."""
    mesh = get_mesh()
    if mesh is None or mesh.shape[axis] == 1:
        return None, 1, 0
    return mesh.group_of(axis), mesh.shape[axis], mesh.coord[axis]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.n = rank, n
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.rank].contiguous(), None, None, None


def copy_to_model_parallel(x, axis: str = MODEL_AXIS):
    """Megatron's "f": identity forward; the backward all-reduces the
    cotangent over ``axis``, so the gradient of a replicated input (and of
    every replicated parameter upstream) is whole on every rank."""
    group, n, _ = model_parallel(axis)
    return x if n == 1 else _CopyToModel.apply(x, group)


def reduce_from_parallel_region(x, axis: str = MODEL_AXIS):
    """Megatron's "g": the sum over ``axis`` forward, identity backward
    (the cotangent of the replicated sum is each partial term's)."""
    group, n, _ = model_parallel(axis)
    return x if n == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model_parallel(x, axis: str = MODEL_AXIS):
    """The ranks' last-dim chunks concatenated (all-gather); the backward
    keeps this rank's chunk of the cotangent."""
    group, n, rank = model_parallel(axis)
    return x if n == 1 else _GatherFromModel.apply(x, group, n, rank)


def _split_param(layer, name, shape, dim, initializer, spec, is_bias=False):
    """Register this rank's chunk along ``dim`` of a full parameter of
    ``shape`` (``dim`` None: the whole parameter), with ``pspec``."""
    full = layer.create_parameter(shape, initializer=initializer,
                                  is_bias=is_bias)
    _, n, rank = model_parallel()
    if dim is not None and n > 1:
        if shape[dim] % n:
            raise ValueError(f"{type(layer).__name__}.{name}: dim {dim} of "
                             f"{tuple(shape)} does not split over {n} "
                             f"model ranks")
        full = torch.nn.Parameter(
            full.detach().chunk(n, dim=dim)[rank].clone())
    full.pspec = spec
    setattr(layer, name, full)
    return full


class VocabParallelEmbedding(Layer):
    """An embedding split over the vocab dim (reference ``mp_layers.py:
    100``): each rank looks up the ids in its row range, zeroes the
    others, and the reduce sums the ranks' rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        _split_param(self, "weight", (num_embeddings, embedding_dim), 0,
                     weight_attr or XavierUniform(), (MODEL_AXIS, None))

    def forward(self, x):
        _, n, rank = model_parallel()
        if n == 1:
            return F.embedding(x, self.weight)
        per = self.num_embeddings // n
        local = x.long() - rank * per
        mask = (local >= 0) & (local < per)
        out = F.embedding(torch.where(mask, local, 0), self.weight)
        out = out * mask[..., None].to(out.dtype)
        return reduce_from_parallel_region(out)


class ColumnParallelLinear(Layer):
    """A linear split over its output dim (reference ``mp_layers.py:130``):
    a rank computes its columns; ``gather_output`` all-gathers them."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        _split_param(self, "weight", (in_features, out_features), 1,
                     weight_attr or XavierUniform(), (None, MODEL_AXIS))
        if has_bias:
            _split_param(self, "bias", (out_features,), 0, None,
                         (MODEL_AXIS,), is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        y = F.linear(copy_to_model_parallel(x), self.weight, self.bias)
        return gather_from_model_parallel(y) if self.gather_output else y


class RowParallelLinear(Layer):
    """A linear split over its input dim (reference ``mp_layers.py:166``):
    a rank multiplies its chunk of the input (``input_is_parallel``, or
    its chunk of a replicated input), the reduce sums the partial
    products, and the (replicated) bias is added after it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        _split_param(self, "weight", (in_features, out_features), 0,
                     weight_attr or XavierUniform(), (MODEL_AXIS, None))
        if has_bias:
            _split_param(self, "bias", (out_features,), None, None, None,
                         is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        _, n, rank = model_parallel()
        if not self.input_is_parallel and n > 1:
            x = copy_to_model_parallel(x)
            per = x.shape[-1] // n
            x = x[..., rank * per:(rank + 1) * per]
        y = reduce_from_parallel_region(F.linear(x, self.weight))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ParallelCrossEntropy(Layer):
    """Cross entropy over class-split logits (reference ``mp_layers.py:
    208``), per token, float32: the max of the DETACHED local maxima over
    ``model`` (a stability shift that needs no gradient), then the
    sum-exp and the picked logit through the reduce. The logits are never
    gathered. A label outside every rank's range picks 0."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()

    def forward(self, input, label):
        group, n, rank = model_parallel()
        x = input.float()
        n_local = x.shape[-1]
        gmax = x.detach().amax(dim=-1, keepdim=True)
        if n > 1:
            gmax = gmax.contiguous()
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        sumexp = reduce_from_parallel_region(
            torch.exp(x - gmax).sum(dim=-1, keepdim=True))
        logz = torch.log(sumexp) + gmax
        lbl = label.long()
        if lbl.dim() == x.dim():
            lbl = lbl[..., 0]
        local = lbl - rank * n_local
        in_range = (local >= 0) & (local < n_local)
        picked = x.gather(-1, torch.where(in_range, local, 0)[..., None])
        picked = torch.where(in_range, picked[..., 0], 0.0)
        return logz[..., 0] - reduce_from_parallel_region(picked)


class ParallelColumnLinearWithGeluFused(ColumnParallelLinear):
    """A column linear and GELU in one layer (reference ``mp_layers.py:
    245``): the activation stays split, so GELU runs on 1/mp of it."""

    def forward(self, x):
        return F.gelu(super().forward(x), approximate=True)
