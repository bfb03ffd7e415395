"""Model summary and FLOPs (port of ``paddle_tpu/hapi/model_summary.py``;
reference python/paddle/hapi/model_summary.py, dynamic_flops.py).

``summary`` runs one forward of zeros on the network's device with a hook
on every leaf layer and prints the reference's table; it returns the same
``{"total_params", "trainable_params"}`` dict.

``flops`` counts the forward's operations the way the reference's number
comes about, which is XLA's cost analysis of the jitted forward
(``compiled.cost_analysis()["flops"]``), over the forward's ``make_fx``
graph (``analysis.walker``, fake tensors: nothing runs):

- a matrix product: 2 M N K (``addmm``'s bias add: one more an element);
- a convolution: 2 for each multiply-add whose input tap lies inside the
  unpadded input (XLA leaves out the taps that fall on padding, where
  ``torch.utils.flop_counter`` counts the whole window), plus one an
  element for its bias;
- a max or average pool: the window's size less one for each output
  element (the reduction inside the window), and an average pool's
  divide one more (none for a window sum, ``divisor_override=1``);
- an elementwise op (``torch.Tag.pointwise``): one an element of its
  output, but none for a copy and none for a transcendental (``exp``,
  ``rsqrt``, ``tanh`` ...: XLA counts those apart from its FLOPs);
- a reduction: its input's elements less its output's;
- everything else (views, copies, casts, gathers): nothing.

That matches the reference exactly on ``Linear(16,32)-ReLU-Linear(32,4)``
(1,348), on ``LeNet`` at 1x1x28x28 (696,078) and on a convolution, batch
norm (which the trace decomposes into XLA's elementwise ops), ReLU and
average pool. An op that the trace keeps whole where XLA expands it
(softmax, layer norm) counts as one elementwise op, so such models read
lower than the reference (ROADMAP.md, Oracle caveats).
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["summary", "flops"]


def _device_of(net) -> torch.device:
    for t in list(net.parameters()) + list(net.buffers()):
        return t.device
    return torch.device("cpu")


def _zeros_inputs(net, input_sizes: Sequence, dtypes):
    from ..framework.dtype import convert_dtype
    dev = _device_of(net)
    out = []
    for shape, dt in zip(input_sizes, dtypes):
        shape = tuple(1 if s in (None, -1) else int(s) for s in shape)
        out.append(torch.zeros(shape, dtype=convert_dtype(dt), device=dev))
    return out


def summary(net, input_size, dtypes=None):
    """Print a table of the leaf layers a forward reaches (name, output
    shape, parameters) and the parameter counts. ``input_size``: a shape
    tuple or a list of them (a None or -1 batch dimension is taken as
    1)."""
    input_sizes = [input_size] if isinstance(input_size, tuple) \
        else list(input_size)
    dtypes = dtypes or ["float32"] * len(input_sizes)
    if isinstance(dtypes, str):
        dtypes = [dtypes] * len(input_sizes)
    inputs = _zeros_inputs(net, input_sizes, dtypes)

    rows = []
    hooks = []

    def make_hook(layer):
        def hook(l, inp, out):
            out_shape = list(out.shape) if hasattr(out, "shape") else "-"
            n_params = sum(p.numel() for p in l._parameters.values()
                           if p is not None)
            rows.append((f"{type(l).__name__}-{len(rows) + 1}", out_shape,
                         n_params))
        return layer.register_forward_hook(hook)

    for _, layer in net.named_modules():
        if layer is not net and not any(True for _ in layer.children()):
            hooks.append(make_hook(layer))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total_params = sum(p.numel() for p in net.parameters())
    trainable_params = sum(p.numel() for p in net.parameters()
                           if p.requires_grad)
    header = f"{'Layer (type)':<30}{'Output Shape':<25}{'Param #':<12}"
    line = "-" * len(header)
    print(line)
    print(header)
    print("=" * len(header))
    for name, shape, n in rows:
        print(f"{name:<30}{str(shape):<25}{n:<12}")
    print("=" * len(header))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    print(f"Non-trainable params: {total_params - trainable_params:,}")
    print(line)
    return {"total_params": total_params, "trainable_params": trainable_params}


# elementwise by tag, but no arithmetic (XLA counts a copy as 0 FLOPs)
_NO_FLOPS = frozenset({"aten.clone", "aten.copy", "aten.copy_",
                       "aten.lift_fresh_copy", "aten.alias", "aten.fill_",
                       "aten.zeros_like", "aten.ones_like", "aten.full_like",
                       "aten.empty_like"})
# XLA counts these among "transcendentals", not FLOPs
_TRANSCENDENTAL = frozenset({"aten.exp", "aten.exp2", "aten.expm1",
                             "aten.log", "aten.log2", "aten.log10",
                             "aten.log1p", "aten.sqrt", "aten.rsqrt",
                             "aten.tanh", "aten.sin", "aten.cos", "aten.tan",
                             "aten.pow", "aten.sigmoid", "aten.erf",
                             "aten.atan2"})
_POOLS = {"aten.max_pool1d": 1, "aten.max_pool2d": 2,
          "aten.max_pool2d_with_indices": 2, "aten.max_pool3d": 3,
          "aten.max_pool3d_with_indices": 3, "aten.avg_pool1d": 1,
          "aten.avg_pool2d": 2, "aten.avg_pool3d": 3}


def _valid_taps(n_in, n_out, k, stride, pad, dil) -> int:
    """(output position, kernel tap) pairs of one spatial dimension whose
    input index lies inside the unpadded input."""
    return sum(1 for o in range(n_out) for t in range(k)
               if 0 <= o * stride - pad + t * dil < n_in)


def _conv_flops(node) -> float:
    x = node.args[0].meta["val"]
    w = node.args[1].meta["val"]
    out = node.meta["val"]
    stride, pad, dil = node.args[3], node.args[4], node.args[5]
    transposed, groups = bool(node.args[6]), int(node.args[8])
    if transposed:     # not a case XLA's rule was checked against here
        in_ch = w.shape[0] // groups
        taps = 1
        for k in w.shape[2:]:
            taps *= int(k)
        fma = out.numel() * taps * in_ch
    else:
        taps = 1
        for i, k in enumerate(w.shape[2:]):
            taps *= _valid_taps(int(x.shape[2 + i]), int(out.shape[2 + i]),
                                int(k), int(stride[i]), int(pad[i]),
                                int(dil[i]))
        fma = out.shape[0] * out.shape[1] * w.shape[1] * taps
    bias = out.numel() if node.args[2] is not None else 0
    return 2.0 * fma + bias


def _pool_flops(site) -> float:
    node = site.node
    dims = _POOLS[site.op]
    k = node.args[1]
    k = list(k) * dims if len(k) == 1 else list(k)
    window = 1
    for d in k[:dims]:
        window *= int(d)
    out = site.outs[0].numel
    # an average pool divides, unless its divisor is 1 (a window sum)
    divides = "avg" in site.op and not (
        len(node.args) > 6 and node.args[6] == 1)
    return out * (window - 1) + (out if divides else 0)


def _node_flops(site) -> float:
    from ..analysis import cost
    op = site.op
    if op in ("aten.mm", "aten.bmm", "aten.matmul"):
        return cost.matmul_node_flops(site)
    if op == "aten.addmm":
        return cost.matmul_node_flops(site) + site.outs[0].numel
    if op == "aten.convolution":
        return _conv_flops(site.node)
    if op in _POOLS:
        return _pool_flops(site)
    target = site.node.target
    tags = getattr(target, "tags", ())
    if torch.Tag.pointwise in tags and op not in _NO_FLOPS \
            and op not in _TRANSCENDENTAL:
        return float(sum(m.numel for m in site.outs[:1]))
    if torch.Tag.reduction in tags:
        return float(max(0, site.ins[0].numel - site.outs[0].numel))
    return 0.0


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The forward's FLOPs at ``input_size`` (a None or -1 batch
    dimension is taken as 1), counted by XLA's rules over its ``make_fx``
    graph (module docstring)."""
    from ..analysis import walker
    (x,) = _zeros_inputs(net, [input_size], ["float32"])
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            graph = walker.trace_program(lambda xx: net(xx), x)
    finally:
        if was_training:
            net.train()
    total = 0.0
    for site in walker.walk(graph):
        f = _node_flops(site)
        if print_detail and f:
            print(f"{site.op:<40}{f:>16,.0f}")
        total += f
    return int(total)
