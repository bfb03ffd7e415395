"""paddle_tpu_torch.static.nn — static-graph layer functions.

Port of ``paddle_tpu/static/nn.py`` (reference:
python/paddle/static/nn/__init__.py, 40 names re-exported from
fluid/layers/nn.py et al). In the reference these append OpDescs and
create persistable parameters in the default Program; here they are
ordinary functions on tensors, eager or traced by ``Program.trace``,
whose parameters are created once per ``name`` in the global scope
(``static.Scope``), so every trace reuses the weights and ``static.save``
persists them. A parameter is made concretely (on the CPU generator, then
moved to its input's device) even while a trace runs on fakes.

LoDTensor translation: the reference's sequence_* ops consume LoDTensors
(ragged rows encoded by offset tables — framework/lod_tensor.h). The
encoding here is a dense padded batch (batch, max_len, ...) plus an
explicit ``length`` vector; the ragged ops whose output size depends on
the data run eagerly only and raise under a trace.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..nn import functional as F
from ..nn import initializer as init_mod

__all__ = [
    "fc", "batch_norm", "embedding", "bilinear_tensor_product", "case",
    "cond", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "crf_decoding", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "multi_box_head", "nce", "prelu",
    "py_func", "row_conv", "spectral_norm", "switch_case", "while_loop",
    "sparse_embedding", "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_concat", "sequence_first_step", "sequence_last_step",
    "sequence_slice", "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate", "sequence_reverse",
]


def _t(x, dtype=None):
    if isinstance(x, torch.Tensor):
        return x
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t if dtype is None else t.to(dtype)


# -- parameter creation in the global scope ---------------------------------
def _param(name, shape, dtype="float32", initializer=None, is_bias=False,
           device=None):
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing
    from . import global_scope
    scope = global_scope()
    found = scope.find_var(name)
    if found is not None:
        return found
    if initializer is None:
        initializer = (init_mod.Constant(0.0) if is_bias
                       else init_mod.XavierUniform())
    # Parameter creation must be CONCRETE even when the layer function is
    # being traced by Program.trace: with the fake and proxy modes off the
    # initializer draws real numbers from the real generator, and no fake
    # lands in the scope (the reference's jax.ensure_compile_time_eval)
    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        value = initializer(tuple(shape), dtype_mod.convert_dtype(dtype))
        if device is not None:
            value = value.to(torch.device(device.type, device.index))
    scope.var(name, value)
    return value


def _is_traced(*vals):
    """True if any value is a traced tensor (Program.trace, to_static)."""
    from ..jit.dy2static import _is_tracer
    return any(_is_tracer(v) for v in vals)


def _host_only(op_name, *vals):
    """Raise a clear error when a host-side (ragged) sequence op is hit
    under a trace: its output shape depends on the data."""
    if _is_traced(*vals):
        raise TypeError(
            f"paddle_tpu_torch.static.nn.{op_name} is eager-only: its output "
            "shape depends on runtime data (ragged sequences), which cannot "
            "be staged by Program.trace / to_static. Call it eagerly, or "
            "use a padded+mask formulation (e.g. sequence_pool with a "
            "length vector) which is traceable.")


def _uname(prefix):
    from ..framework.naming import unique_name
    return unique_name(prefix)


def _act(out, act):
    return getattr(F, act)(out) if act else out


# -- dense layers ------------------------------------------------------------
def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """reference static/nn/common.py fc (operators/math/fc.cc)."""
    x = _t(x)
    name = name or _uname("fc")
    lead = int(np.prod(x.shape[num_flatten_dims:]))
    flat = x.reshape(tuple(x.shape[:num_flatten_dims]) + (lead,))
    w = _param(f"{name}.w_0", (lead, size), device=x.device)
    out = torch.matmul(flat, w)
    if bias_attr is not False:
        out = out + _param(f"{name}.b_0", (size,), is_bias=True,
                           device=x.device)
    return _act(out, activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    ids = _t(input).long()
    name = name or _uname("embedding")
    table = _param(f"{name}.w_0", tuple(size), dtype,
                   initializer=init_mod.Normal(0.0, 0.02), device=ids.device)
    out = table[ids]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else size[0] + padding_idx
        out = out * (ids != pad)[..., None].to(out.dtype)
    return out


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     is_test=False, entry=None, name=None):
    """reference static/nn/common.py sparse_embedding — the PS-backed
    table. Dense here (``entry`` admission policies have nothing to gate
    and are accepted); the host-table path with entry-gated admission is
    ``distributed.ps`` (``DistributedEmbedding(entry=...)``)."""
    if entry is not None:
        from ..distributed.entry import EntryAttr
        if not isinstance(entry, EntryAttr):
            raise ValueError(
                "entry must be a ProbabilityEntry/CountFilterEntry "
                f"(paddle.distributed), got {type(entry).__name__}")
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, name=name)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x W_k y^T (reference operators/bilinear_tensor_product_op)."""
    x, y = _t(x), _t(y)
    name = name or _uname("bilinear")
    w = _param(f"{name}.w_0", (size, x.shape[-1], y.shape[-1]),
               device=x.device)
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if bias_attr is not False:
        out = out + _param(f"{name}.b_0", (size,), is_bias=True,
                           device=x.device)
    return _act(out, act)


def _norm_params(name, c, device):
    scale = _param(f"{name}.w_0", (c,), initializer=init_mod.Constant(1.0),
                   device=device)
    bias = _param(f"{name}.b_0", (c,), is_bias=True, device=device)
    return scale, bias


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               **kwargs):
    """Batch norm over the batch statistics (running statistics belong to
    ``nn.BatchNorm`` layers; reference static/nn/common.py batch_norm)."""
    input = _t(input)
    name = name or _uname("batch_norm")
    ch = 1 if data_layout == "NCHW" else input.ndim - 1
    c = input.shape[ch]
    scale, bias = _norm_params(name, c, input.device)
    axes = tuple(i for i in range(input.ndim) if i != ch)
    mean = torch.mean(input, dim=axes, keepdim=True)
    var = torch.var(input, dim=axes, keepdim=True, correction=0)
    shape = [1] * input.ndim
    shape[ch] = c
    out = (input - mean) / torch.sqrt(var + epsilon)
    out = out * scale.reshape(shape) + bias.reshape(shape)
    return _act(out, act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, name=None,
              **kwargs):
    """reference static/nn/common.py data_norm — scale-shift by the batch
    statistics (PS CTR models); single-batch form here."""
    input = _t(input)
    return batch_norm(input, act=act, epsilon=epsilon, name=name or
                      _uname("data_norm"), data_layout="NHWC"
                      if input.ndim == 2 else "NCHW")


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    input = _t(input)
    name = name or _uname("group_norm")
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale, bias = _norm_params(name, c, input.device)
    out = F.group_norm(input, groups, epsilon=epsilon, weight=scale,
                       bias=bias, data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    input = _t(input)
    name = name or _uname("instance_norm")
    scale, bias = _norm_params(name, input.shape[1], input.device)
    return F.instance_norm(input, weight=scale, bias=bias, eps=epsilon)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    input = _t(input)
    name = name or _uname("layer_norm")
    n = int(np.prod(input.shape[begin_norm_axis:]))
    w = _param(f"{name}.w_0", (n,), initializer=init_mod.Constant(1.0),
               device=input.device) if scale else None
    b = _param(f"{name}.b_0", (n,), is_bias=True, device=input.device) \
        if shift else None
    flat = input.reshape(tuple(input.shape[:begin_norm_axis]) + (n,))
    out = F.layer_norm(flat, (n,), weight=w, bias=b, epsilon=epsilon)
    return _act(out.reshape(input.shape), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Power-iteration spectral normalization of a weight tensor
    (reference operators/spectral_norm_op)."""
    w = torch.movedim(_t(weight), dim, 0)
    mat = w.reshape(w.shape[0], -1)
    u = torch.ones((mat.shape[0],), dtype=mat.dtype, device=mat.device)
    for _ in range(max(1, power_iters)):
        v = mat.T @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.norm(u) + eps)
    sigma = u @ mat @ v
    return torch.movedim(w / (sigma + eps), 0, dim)


def prelu(x, mode="all", param_attr=None, name=None):
    x = _t(x)
    name = name or _uname("prelu")
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (x.shape[1],)
    else:  # element
        shape = tuple(x.shape[1:])
    alpha = _param(f"{name}.w_0", shape,
                   initializer=init_mod.Constant(0.25), device=x.device)
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x > 0, x, alpha * x)


# -- convolutions ------------------------------------------------------------
def _conv_param(name, shape, device):
    return _param(f"{name}.w_0", shape,
                  initializer=init_mod.XavierUniform(fan_in=int(
                      np.prod(shape[1:]))), device=device)


def _ks(filter_size, n):
    return (filter_size,) * n if isinstance(filter_size, int) \
        else tuple(filter_size)


def _bias(name, bias_attr, n, device):
    return None if bias_attr is False else _param(
        f"{name}.b_0", (n,), is_bias=True, device=device)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    input = _t(input)
    name = name or _uname("conv2d")
    cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w = _conv_param(name, (num_filters, cin // groups) + _ks(filter_size, 2),
                    input.device)
    b = _bias(name, bias_attr, num_filters, input.device)
    out = F.conv2d(input, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    input = _t(input)
    name = name or _uname("conv2d_transpose")
    cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w = _conv_param(name, (cin, num_filters // groups) + _ks(filter_size, 2),
                    input.device)
    b = _bias(name, bias_attr, num_filters, input.device)
    out = F.conv2d_transpose(input, w, b, stride=stride, padding=padding,
                             dilation=dilation, groups=groups,
                             output_size=output_size,
                             data_format=data_format)
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    input = _t(input)
    name = name or _uname("conv3d")
    w = _conv_param(name, (num_filters, input.shape[1] // groups)
                    + _ks(filter_size, 3), input.device)
    b = _bias(name, bias_attr, num_filters, input.device)
    out = F.conv3d(input, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    return _act(out, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    input = _t(input)
    name = name or _uname("conv3d_transpose")
    w = _conv_param(name, (input.shape[1], num_filters // groups)
                    + _ks(filter_size, 3), input.device)
    b = _bias(name, bias_attr, num_filters, input.device)
    out = F.conv3d_transpose(input, w, b, stride=stride, padding=padding,
                             dilation=dilation, groups=groups,
                             output_size=output_size)
    return _act(out, act)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    """Delegates to ``vision.ops.deform_conv2d``, as the reference does;
    its filter and bias are this scope's ``<name>.w_0`` and
    ``<name>.b_0``."""
    from ..vision.ops import deform_conv2d as _dc
    x = _t(x)
    name = name or _uname("deform_conv2d")
    w = _conv_param(name, (num_filters, x.shape[1] // groups)
                    + _ks(filter_size, 2), x.device)
    b = _bias(name, bias_attr, num_filters, x.device)
    return _dc(x, _t(offset), w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=None if mask is None else _t(mask))


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead row convolution (reference operators/row_conv_op.cc —
    DeepSpeech2): out[t] = sum_{k=0..K} in[t+k] * w[k] per channel.
    Input (batch, time, dim)."""
    input = _t(input)
    name = name or _uname("row_conv")
    k = future_context_size + 1
    w = _param(f"{name}.w_0", (k, input.shape[-1]),
               initializer=init_mod.Constant(1.0 / k), device=input.device)
    pad = torch.nn.functional.pad(input, (0, 0, 0, future_context_size))
    t = input.shape[1]
    out = sum(pad[:, i:i + t] * w[i] for i in range(k))
    return _act(out, act)


# -- control flow --------------------------------------------------------------
# Eagerly each runs as Python; traced, each is a ``cond`` / ``while_loop``
# node (the dy2static converters, which lift what the branches read)
def _staged_if(pred, true_fn, false_fn):
    from ..jit.dy2static import convert_ifelse
    pred = pred.reshape(()) if isinstance(pred, torch.Tensor) else pred
    return convert_ifelse(pred, lambda: (true_fn(),), lambda: (false_fn(),),
                          (), ["out"])[0]


def cond(pred, true_fn=None, false_fn=None, name=None):
    """reference static/nn/control_flow cond (a staged conditional)."""
    return _staged_if(pred, true_fn, false_fn)


def case(pred_fn_pairs, default=None, name=None):
    """First true predicate wins (reference control_flow.py case; with no
    default, the last pair's fn is the fallback — reference semantics)."""
    fns = list(pred_fn_pairs)
    if not fns:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    fallback = default if default is not None else fns[-1][1]

    def build(i):
        if i == len(fns):
            return fallback()
        pred, fn = fns[i]
        return _staged_if(pred, fn, lambda: build(i + 1))

    return build(0)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """reference control_flow.py switch_case: the branch of the index
    (clipped to the branches), ``default`` past the last."""
    if isinstance(branch_fns, dict):
        max_idx = max(branch_fns)
        fns = [branch_fns.get(i, default or branch_fns[max_idx])
               for i in range(max_idx + 1)]
    else:
        fns = [f for _, f in branch_fns] if isinstance(branch_fns[0], tuple) \
            else list(branch_fns)
    if default is not None:
        fns.append(default)
    if not _is_traced(branch_index):
        idx = int(branch_index)
        return fns[min(max(idx, 0), len(fns) - 1)]()
    idx = torch.clamp(branch_index.reshape(()), 0, len(fns) - 1)

    def build(i):
        if i == len(fns) - 1:
            return fns[i]()
        return _staged_if(idx == i, fns[i], lambda: build(i + 1))

    return build(0)


def while_loop(cond_fn, body, loop_vars, is_test=False, name=None):
    """reference control_flow.py while_loop: a loop of the graph (no
    per-iteration host sync) when traced, Python eagerly."""
    from ..jit.dy2static import convert_while
    loop_vars = tuple(loop_vars)
    return tuple(convert_while(
        lambda *vs: cond_fn(*vs), lambda *vs: tuple(body(*vs)), loop_vars,
        [f"v{i}" for i in range(len(loop_vars))]))


# -- host functions --------------------------------------------------------------
# key -> (func, output specs); a key is never reused, so a graph's node
# always reaches the function it was traced with
_PY_FUNCS = {}
_PY_FUNC_KEYS = itertools.count()


@torch.library.custom_op("paddle_tpu_torch::static_py_func", mutates_args=())
def _py_func_op(xs: list[torch.Tensor], key: int) -> list[torch.Tensor]:
    func, specs = _PY_FUNCS[key]
    outs = func(*[x.detach().cpu().numpy() for x in xs])
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    dev = xs[0].device if xs else torch.device("cpu")
    return [torch.as_tensor(np.asarray(o)).to(device=dev, dtype=dt)
            for o, (_, dt) in zip(outs, specs)]


@_py_func_op.register_fake
def _(xs, key):
    _, specs = _PY_FUNCS[key]
    dev = xs[0].device if xs else torch.device("cpu")
    return [torch.empty(shape, dtype=dt, device=dev) for shape, dt in specs]


def py_func(func, x, out=None, backward_func=None,
            skip_vars_in_backward_input=None):
    """reference static/nn/common.py py_func: a host function on numpy
    arrays, an op of the graph (it runs when the graph runs)."""
    xs = [_t(v) for v in (x if isinstance(x, (list, tuple)) else [x])]
    if out is None:
        # the host function's output spec, from zero-filled numpy inputs
        probe = func(*[np.zeros(tuple(v.shape),
                                dtype=str(v.dtype).replace("torch.", ""))
                       for v in xs])
        single = not isinstance(probe, (list, tuple))
        probes = [probe] if single else list(probe)
        specs = [(tuple(np.shape(o)),
                  dtype_mod.convert_dtype(np.asarray(o).dtype))
                 for o in probes]
    else:
        single = not isinstance(out, (list, tuple))
        outs = [out] if single else list(out)
        specs = [(tuple(o.shape), dtype_mod.convert_dtype(o.dtype))
                 for o in outs]
    key = next(_PY_FUNC_KEYS)
    _PY_FUNCS[key] = (func, specs)
    res = _py_func_op(xs, key)
    return res[0] if single else list(res)


# -- CRF / NCE ---------------------------------------------------------------
def _sequence_mask(lengths, maxlen, dtype=torch.int64):
    row = torch.arange(maxlen, device=lengths.device)
    return (row[None, :] < lengths[..., None]).to(dtype)


def crf_decoding(input, transition, length=None, label=None, name=None):
    """Viterbi decode of a linear-chain CRF (reference
    operators/crf_decoding_op.cc). ``input`` (batch, seq, n_tags) emission
    scores; ``transition`` (n_tags+2, n_tags): rows 0/1 are start/stop.
    Returns the best tag path (batch, seq): the reference's scan over time
    as a loop over the (static) time steps."""
    emis = _t(input)
    trans = _t(transition)
    start, stop, pair = trans[0], trans[1], trans[2:]
    b, t, n = emis.shape
    lens = torch.full((b,), t, device=emis.device) if length is None \
        else _t(length).reshape(-1).to(emis.device)
    ar = torch.arange(n, device=emis.device)
    alpha = start[None] + emis[:, 0]
    backptrs = []
    for ti in range(1, t):
        scores = alpha[:, :, None] + pair[None]   # (b, n_prev, n)
        best_prev = torch.argmax(scores, dim=1)
        alpha_t = torch.amax(scores, dim=1) + emis[:, ti]
        # beyond a row's length: freeze alpha and thread identity backptrs
        valid = (ti < lens)[:, None]
        alpha = torch.where(valid, alpha_t, alpha)
        backptrs.append(torch.where(valid, best_prev, ar[None, :]))
    alpha = alpha + stop[None]
    cur = torch.argmax(alpha, dim=-1)
    path = [cur]
    for bp in reversed(backptrs):
        cur = torch.take_along_dim(bp, cur[:, None], dim=1)[:, 0]
        path.append(cur)
    out = torch.stack(path[::-1], dim=1)
    if length is not None:
        out = out * _sequence_mask(lens, t)
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference operators/nce_op.cc):
    binary logistic on the true class + k uniform negatives, drawn fresh
    from the port's generator at every call (or from ``seed``)."""
    from ..framework.random import get_generator
    input = _t(input)
    name = name or _uname("nce")
    d = input.shape[-1]
    w = _param(f"{name}.w_0", (num_total_classes, d), device=input.device)
    b = _param(f"{name}.b_0", (num_total_classes,), is_bias=True,
               device=input.device)
    label = _t(label).reshape(-1).long().to(input.device)
    batch = label.shape[0]
    gen = get_generator(input.device)
    if seed:
        gen = torch.Generator(device=input.device)
        gen.manual_seed(int(seed))
    negs = torch.randint(0, num_total_classes, (batch, num_neg_samples),
                         generator=gen, device=input.device)
    pos_logit = torch.sum(input * w[label], -1) + b[label]
    neg_logit = torch.einsum("bd,bkd->bk", input, w[negs]) + b[negs]
    pos_loss = -F.log_sigmoid(pos_logit)
    neg_loss = -torch.sum(F.log_sigmoid(-neg_logit), dim=-1)
    return (pos_loss + neg_loss)[:, None]


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=True,
                   kernel_size=1, pad=0, stride=1, name=None, **kwargs):
    """SSD detection head (reference static/nn/common multi_box_head +
    operators/detection/prior_box_op): per feature map, conv loc/conf heads
    + prior boxes. Returns (mbox_locs, mbox_confs, boxes, variances)."""
    name = name or _uname("multi_box_head")
    inputs = [_t(f) for f in inputs]
    locs, confs, priors, vars_ = [], [], [], []
    img_h, img_w = image.shape[2], image.shape[3]
    n_in = len(inputs)
    if min_sizes is None:
        # reference ratio schedule
        min_ratio = min_ratio or 20
        max_ratio = max_ratio or 90
        step = int((max_ratio - min_ratio) / max(n_in - 2, 1))
        min_sizes, max_sizes = [base_size * 0.1], [base_size * 0.2]
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = min_sizes[:n_in]
        max_sizes = max_sizes[:n_in]
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        n_prior = 2 + len(ar) * (2 if flip else 1)
        fh, fw = feat.shape[2], feat.shape[3]
        loc = conv2d(feat, n_prior * 4, kernel_size, stride=stride,
                     padding=pad, name=f"{name}.loc{i}")
        conf = conv2d(feat, n_prior * num_classes, kernel_size, stride=stride,
                      padding=pad, name=f"{name}.conf{i}")
        locs.append(loc.permute(0, 2, 3, 1).reshape(feat.shape[0], -1, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(feat.shape[0], -1,
                                                      num_classes))
        # prior boxes
        sk_w = min_sizes[i] / img_w
        sk_h = min_sizes[i] / img_h
        sk2_w = (max_sizes[i] / img_w) if max_sizes else sk_w
        sk2_h = (max_sizes[i] / img_h) if max_sizes else sk_h
        widths = [sk_w, float(np.sqrt(sk_w * sk2_w))]
        heights = [sk_h, float(np.sqrt(sk_h * sk2_h))]
        for a in ar:
            widths.append(sk_w * float(np.sqrt(a)))
            heights.append(sk_h / float(np.sqrt(a)))
            if flip:
                widths.append(sk_w / float(np.sqrt(a)))
                heights.append(sk_h * float(np.sqrt(a)))
        cy, cx = np.meshgrid((np.arange(fh) + offset) / fh,
                             (np.arange(fw) + offset) / fw, indexing="ij")
        boxes_i = [np.stack([cx - wd / 2, cy - ht / 2, cx + wd / 2,
                             cy + ht / 2], -1)
                   for wd, ht in zip(widths, heights)]
        box = np.clip(np.stack(boxes_i, 2).reshape(-1, 4), 0, 1)
        priors.append(torch.as_tensor(box, dtype=torch.float32,
                                      device=feat.device))
        vars_.append(torch.full((box.shape[0], 4), 0.1, dtype=torch.float32,
                                device=feat.device))
    return (torch.cat(locs, 1), torch.cat(confs, 1), torch.cat(priors, 0),
            torch.cat(vars_, 0))


# -- sequence ops on padded (x, length) --------------------------------------
def _len_mask(x, length):
    return _sequence_mask(_t(length).reshape(-1).to(x.device), x.shape[1],
                          x.dtype)


def _expand_mask(mask, ndim):
    while mask.ndim < ndim:
        mask = mask[..., None]
    return mask


def sequence_softmax(input, length=None, name=None):
    input = _t(input)
    if length is None:
        return torch.softmax(input, dim=1)
    mask = _expand_mask(_len_mask(input, length), input.ndim)
    neg = torch.finfo(input.dtype).min
    return torch.softmax(torch.where(mask > 0, input,
                                     torch.full_like(input, neg)),
                         dim=1) * mask


def sequence_pool(input, pool_type, length=None, pad_value=0.0):
    input = _t(input)
    pool_type = pool_type.lower()
    if length is None:
        length = torch.full((input.shape[0],), input.shape[1],
                            device=input.device)
    length = _t(length).reshape(-1).to(input.device)
    mask = _expand_mask(_len_mask(input, length), input.ndim)
    ln = torch.clamp(length.to(input.dtype), min=1).reshape(
        (-1,) + (1,) * (input.ndim - 2))
    if pool_type == "sum":
        return torch.sum(input * mask, dim=1)
    if pool_type == "average":
        return torch.sum(input * mask, dim=1) / ln
    if pool_type == "sqrt":
        return torch.sum(input * mask, dim=1) / torch.sqrt(ln)
    if pool_type == "max":
        neg = torch.finfo(input.dtype).min
        return torch.amax(torch.where(mask > 0, input,
                                      torch.full_like(input, neg)), dim=1)
    if pool_type == "first":
        return input[:, 0]
    if pool_type == "last":
        rows = torch.arange(input.shape[0], device=input.device)
        return input[rows, (length - 1).long()]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_concat(input: Sequence, lengths=None, name=None):
    """Concatenate along time; with lengths, packs the valid steps of each
    row contiguously (eager only: ragged packing has no static shape)."""
    if lengths is None:
        return torch.cat([_t(x) for x in input], dim=1)
    _host_only("sequence_concat", *list(input), *[ln for ln in lengths])
    outs = []
    for b in range(input[0].shape[0]):
        parts = [np.asarray(_t(x)[b, :int(ln[b])].cpu())
                 for x, ln in zip(input, lengths)]
        outs.append(np.concatenate(parts, 0))
    maxlen = max(o.shape[0] for o in outs)
    padded = [np.pad(o, [(0, maxlen - o.shape[0])] + [(0, 0)] * (o.ndim - 1))
              for o in outs]
    return torch.as_tensor(np.stack(padded))


def sequence_slice(input, offset, length, name=None):
    """Per-row slice [offset, offset+length) along time (reference
    operators/sequence_ops/sequence_slice_op). Traced, the output time dim
    is the static upper bound ``input.shape[1]`` and positions past
    ``length`` are zeros; eagerly it is ``max(length)``."""
    input = _t(input)
    offset = _t(offset).reshape(-1).to(input.device).long()
    length = _t(length).reshape(-1).to(input.device).long()
    out_t = input.shape[1] if _is_traced(input, offset, length) \
        else int(torch.max(length))
    idx = offset[:, None] + torch.arange(out_t, device=input.device)[None]
    idx = torch.clamp(idx, 0, input.shape[1] - 1)
    if input.ndim > 2:
        idx = _expand_mask(idx, input.ndim).expand(
            (-1, -1) + tuple(input.shape[2:]))
    gathered = torch.take_along_dim(input, idx, dim=1)
    mask = torch.arange(out_t, device=input.device)[None] < length[:, None]
    return gathered * _expand_mask(mask, gathered.ndim).to(gathered.dtype)


def sequence_expand(x, y, ref_level=-1, length=None, name=None):
    """Repeat each row of x per the ragged row-count of y (reference
    sequence_expand_op). Padded form: length (batch,) gives repeats."""
    x = _t(x)
    reps = _t(length).reshape(-1) if length is not None else \
        torch.full((x.shape[0],), y.shape[1])
    _host_only("sequence_expand", x, reps)
    return torch.repeat_interleave(x, reps.to(x.device).long(), dim=0)


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y, length=torch.full((x.shape[0],),
                                                   y.shape[1]))


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Pad a packed ragged batch into dense (batch, maxlen, ...) + lengths
    (reference sequence_pad_op). x is a list of variable-length arrays or
    a (rows, dim) packed array + length. Eager only."""
    if isinstance(x, (list, tuple)):
        _host_only("sequence_pad", *x)
        seqs = [np.asarray(_t(s).cpu()) for s in x]
    else:
        assert length is not None, "packed input needs length"
        _host_only("sequence_pad", x, length)
        flat = np.asarray(_t(x).cpu())
        offs = np.concatenate([[0], np.cumsum(np.asarray(length))])
        seqs = [flat[offs[i]:offs[i + 1]] for i in range(len(length))]
    ml = maxlen or max(s.shape[0] for s in seqs)
    out = np.full((len(seqs), ml) + seqs[0].shape[1:],
                  np.asarray(pad_value), dtype=seqs[0].dtype)
    lens = []
    for i, s in enumerate(seqs):
        out[i, :s.shape[0]] = s[:ml]
        lens.append(min(s.shape[0], ml))
    return torch.as_tensor(out), torch.as_tensor(lens)


def sequence_unpad(x, length, name=None):
    """Dense padded (batch, maxlen, ...) -> list of per-row tensors."""
    x = _t(x)
    _host_only("sequence_unpad", x, length)
    length = np.asarray(_t(length).cpu()).reshape(-1)
    return [x[i, :int(length[i])] for i in range(x.shape[0])]


def sequence_reshape(input, new_dim, name=None):
    input = _t(input)
    return input.reshape(input.shape[0], -1, new_dim)


def sequence_scatter(input, index, updates, length=None, name=None):
    """Scatter-add updates at (row, index) positions (reference
    sequence_scatter_op). index (batch, k), updates (batch, k)."""
    input = _t(input)
    idx = _t(index).long().to(input.device)
    upd = _t(updates).to(device=input.device, dtype=input.dtype)
    rows = torch.arange(idx.shape[0], device=input.device)[:, None].expand(
        idx.shape)
    return input.clone().index_put_((rows.reshape(-1), idx.reshape(-1)),
                                    upd.reshape(-1), accumulate=True)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """All win_size-grams per row (reference sequence_enumerate_op):
    (batch, t) -> (batch, t, win_size) padded with pad_value."""
    x = _t(input)
    t = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, win_size - 1), value=pad_value)
    return torch.stack([pad[:, i:i + t] for i in range(win_size)], dim=-1)


def sequence_reverse(x, length=None, name=None):
    """Reverse the valid prefix of each row (reference
    sequence_reverse_op)."""
    x = _t(x)
    if length is None:
        return torch.flip(x, [1])
    t = x.shape[1]
    length = _t(length).reshape(-1).to(x.device)
    ar = torch.arange(t, device=x.device)[None]
    idx = torch.where(ar < length[:, None], length[:, None] - 1 - ar,
                      ar.expand(length.shape[0], t))
    idx = _expand_mask(idx, x.ndim).expand(x.shape)
    return torch.take_along_dim(x, idx.long(), dim=1)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, act=None,
                  param_attr=None, bias_attr=None, name=None):
    """Context-window convolution over time (reference sequence_conv_op):
    concat [t+padding_start, ...] context rows then project."""
    input = _t(input)
    name = name or _uname("sequence_conv")
    d = input.shape[-1]
    start = padding_start if padding_start is not None \
        else -(filter_size // 2)
    w = _param(f"{name}.w_0", (filter_size * d, num_filters),
               device=input.device)
    b = _bias(name, bias_attr, num_filters, input.device)
    t = input.shape[1]
    cols = []
    for k in range(filter_size):
        shift = start + k
        if shift < 0:
            sl = torch.nn.functional.pad(input[:, :t + shift],
                                         (0, 0, -shift, 0))
        elif shift > 0:
            sl = torch.nn.functional.pad(input[:, shift:], (0, 0, 0, shift))
        else:
            sl = input
        cols.append(sl)
    out = torch.einsum("btd,df->btf", torch.cat(cols, dim=-1), w)
    if b is not None:
        out = out + b
    return _act(out, act)
