"""Normalization layers (port of ``paddle_tpu/nn/layers/norm.py``, whole).

Batch norm's running statistics are the buffers ``_mean`` (zeros) and
``_variance`` (ones), float32 at construction and cast with the model
(``bfloat16()`` casts them, as the reference's ``astype``); their names
are the reference's, so ``set_state_dict_from_numpy`` carries them
across. A training forward computes the new statistics as the
reference's functional does and then REPLACES the buffers with them (the
reference's ``self._mean = new_rm``; a new tensor, so the dtype follows
the arithmetic as the reference's does), once a forward:

- a forward recomputed inside the backward (``recompute``, the trainer's
  ``remat``: the recompute runs while the autograd engine runs) computes
  the same output and leaves the buffers alone, so a recomputed block
  moves them once, as the reference's one functional call does;
- ``ParallelTrainer`` puts the buffers back when its NaN guard skips the
  step (the buffers of every layer that names them in ``_stat_buffers``),
  and otherwise averages them over its batch axes other than those in
  ``_stat_sync_axes`` (``data`` for ``SyncBatchNorm``), so that the
  replicas keep one copy.

``SyncBatchNorm`` averages the batch statistics over the current mesh's
``data`` axis, with one all-reduce of the stacked per-rank mean and mean
square (the reference's two ``pmean``s): ``var = E[x²] - E[x]²``, ``rsqrt``
in the input's dtype, as the reference's sync branch. The all-reduce is
differentiable: its backward is the mean of the cotangents over the
group, the transpose of ``pmean``. Without a mesh it is ``BatchNorm``, as
the reference's outside ``shard_map``; with one it takes the sync formula
at any degree (a degree of one issues no collective).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import functional as F
from ..initializer import Constant, initializer_of
from ..layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm", "in_recompute"]


def in_recompute() -> bool:
    """True while the autograd engine runs: a forward called now is a
    checkpoint's recompute, whose side effects already happened once."""
    return torch._C._current_graph_task_id() != -1


def _affine(layer, num_features, weight_attr, bias_attr):
    layer.weight = None if weight_attr is False else layer.create_parameter(
        (num_features,), attr=weight_attr,
        initializer=initializer_of(weight_attr, Constant(1.0)))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        (num_features,), attr=bias_attr,
        initializer=initializer_of(bias_attr, None),
        is_bias=True)


class _BatchNormBase(Layer):
    _stat_buffers = ("_mean", "_variance")
    # batch statistics, agreeing over no mesh axis: ParallelTrainer
    # averages them over its batch axes after each step
    _stat_sync_axes = ()

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine(self, num_features, weight_attr, bias_attr)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def _set_stats(self, mean, var):
        if not in_recompute():
            self._mean = mean.detach()
            self._variance = var.detach()

    def forward(self, x):
        if self.training and not self.use_global_stats:
            out, new_rm, new_rv = F.batch_norm(
                x, self._mean, self._variance, self.weight, self.bias,
                training=True, momentum=self.momentum, epsilon=self.epsilon,
                data_format=self.data_format,
                use_global_stats=self.use_global_stats)
            self._set_stats(new_rm, new_rv)
            return out
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=False, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy ``BatchNorm(num_channels, act=...)``."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCW" if data_format in ("NCL", "NCW")
                         else "NWC")


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format)


class _GroupMean(torch.autograd.Function):
    """The mean over ``group`` (the reference's ``pmean``); its backward is
    the mean of the cotangents over the group, pmean's transpose."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


class SyncBatchNorm(_BatchNormBase):
    axis_name = "data"
    _stat_sync_axes = (axis_name,)

    def forward(self, x):
        from ...distributed.mesh import get_mesh
        mesh = get_mesh()
        if not self.training or self.use_global_stats or mesh is None:
            return super().forward(x)
        axis = x.dim() - 1 if self.data_format[-1] == "C" else 1
        dims = tuple(i for i in range(x.dim()) if i != axis)
        stats = torch.stack([x.mean(dim=dims), x.square().mean(dim=dims)])
        n = mesh.shape[self.axis_name]
        if n > 1:
            stats = _GroupMean.apply(stats, mesh.group_of(self.axis_name), n)
        mean, mean_sq = stats[0], stats[1]
        var = mean_sq - mean.square()
        self._set_stats(self.momentum * self._mean + (1 - self.momentum) * mean,
                        self.momentum * self._variance +
                        (1 - self.momentum) * var)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        out = (x - mean.reshape(shape)) * torch.rsqrt(
            var + self.epsilon).reshape(shape)
        if self.weight is not None:
            out = out * self.weight.reshape(shape)
        if self.bias is not None:
            out = out + self.bias.reshape(shape)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm under ``layer`` replaced by a ``SyncBatchNorm``
        sharing its parameters and buffers (``layer`` itself when it is
        one)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon, data_format=layer.data_format)
            if layer.weight is not None:
                new.weight = layer.weight
            if layer.bias is not None:
                new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self.normalized_shape,
            attr=weight_attr,
            initializer=initializer_of(weight_attr, Constant(1.0)))
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, attr=bias_attr,
            initializer=initializer_of(bias_attr, None),
            is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        _affine(self, num_channels, weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False:
            self.weight, self.bias = None, None
        else:
            _affine(self, num_features, weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon, data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """A weight over its largest singular value, by power iteration on the
    buffers ``weight_u`` (h) and ``weight_v`` (w), drawn normal from the
    CPU generator (the reference draws them from its key: load them to
    compare)."""

    _stat_buffers = ("weight_u", "weight_v")

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        from ...framework.random import get_generator
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        gen = get_generator("cpu")
        self.register_buffer("weight_u", torch.randn(h, generator=gen))
        self.register_buffer("weight_v", torch.randn(w, generator=gen))

    def forward(self, weight):
        mat = weight.movedim(self.dim, 0)
        mat = mat.reshape(mat.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.norm(u) + self.eps)
        if not in_recompute():
            self.weight_u, self.weight_v = u.detach(), v.detach()
        return weight / (u @ mat @ v)
