"""The port's convolutions, pooling, normalization, activations and
containers against the JAX package's, on the same numpy inputs and
weights.

- every functional and layer of ``nn/functional/{conv,pooling,norm,
  activation}.py`` and ``nn/layers/{conv,pooling,norm,activation}.py`` in
  float32: the output, and for the convolutions, pooling and batch norm
  the gradients of ``sum(out * r)`` (``r`` fixed random) with respect to
  the input and the weights. Bar: rtol 1e-5, atol 1e-6 (both sides run
  float32 sums of at most a few hundred terms in other orders: inputs are
  N(0, 1) and weights N(0, 1/fan_in), so the outputs are of order 1 and
  their rounding a few 1e-7); max pooling bit for bit (it moves values).
  A gradient sums over the batch and the positions, so its rounding
  scales with its largest element: atol 1e-6 · max|g| (``_check_grad``);
- the reference's pooling ignores ``ceil_mode`` and ``return_mask``
  (``paddle_tpu/nn/functional/pooling.py:12-45``): the planted cases,
  where PyTorch's own ``ceil_mode`` would add a row and ``return_mask``
  would return a pair, give the reference's floor-rule output alone;
- batch norm in training and evaluation, float32 and bfloat16 (the model
  cast whole, running stats included), its running statistics after
  each of three forwards. bfloat16 bar: 2 bf16 ulps relative (2^-7) plus
  2^-7 absolute on outputs of order 1 — both sides compute the
  statistics in float32 and round them to bfloat16, but in other orders,
  so one rounding of a statistic, or of the normalized value, may land
  on either side;
- ``SyncBatchNorm`` on gloo worlds of 2 and 4 (``torch_ep_worker.py``)
  against the reference's under ``shard_map`` over a ``data`` mesh of as
  many CPU devices: each rank's output and input gradient, the weight
  and bias gradients summed over the ranks (the reference's transpose of
  a replicated parameter sums them), and the running statistics;
- the running statistics under ``ParallelTrainer`` at ``{"data": n}``
  (n 2 and 4): a ``BatchNorm2D``'s, which each rank computes from its
  slice of the batch, are averaged over the ranks after every step: they
  equal ``m · old + (1 − m) · mean over ranks of the slice's statistic``
  (float64 expectation, rtol 1e-6: one float32 rounding of a sum of n
  terms), a ``SyncBatchNorm``'s the whole batch's; on every rank the same
  bit for bit, and so is the evaluation-mode output; a step the NaN guard
  skips leaves them as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.nn import functional as rF

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

import torch_ep_worker as worker

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2.0 ** -7
SYNCBN_KINDS = ("syncbn", "bnstats")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _w(shape, fan_in, seed=1):
    return (np.random.RandomState(seed).randn(*shape) /
            np.sqrt(fan_in)).astype(np.float32)


def _both(name, arrays, kw, grad=True):
    """(reference output, port output, reference grads, port grads) of
    functional ``name`` on ``arrays``; grads of sum(out * r) w.r.t. every
    float array."""
    rfn, pfn = getattr(rF, name), getattr(F, name)
    ref_out = rfn(*[jnp.asarray(a) for a in arrays], **kw)
    ts = [torch.from_numpy(a.copy()).requires_grad_(
        grad and a.dtype == np.float32) for a in arrays]
    out = pfn(*ts, **kw)
    assert tuple(out.shape) == tuple(ref_out.shape), (name, kw)
    if not grad:
        return ref_out, out, None, None
    r = _x(tuple(ref_out.shape), seed=7)
    idx = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def loss(*fl):
        args = [jnp.asarray(a) for a in arrays]
        for i, v in zip(idx, fl):
            args[i] = v
        return jnp.sum(rfn(*args, **kw) * r)

    rg = jax.grad(loss, argnums=tuple(range(len(idx))))(
        *[jnp.asarray(arrays[i]) for i in idx])
    pg = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                             [ts[i] for i in idx])
    return ref_out, out, rg, pg


def _check(ref, got, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(ref, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _check_grad(ref, got, msg=""):
    """A gradient sums up to a few hundred products over the batch and the
    positions, so its rounding scales with its largest element: rtol 1e-5
    and atol 1e-6 of max|g| (about 8 float32 ulps of it)."""
    ref = np.asarray(ref, dtype=np.float32)
    _check(ref, got, atol=ATOL * max(1.0, float(np.abs(ref).max())),
           msg=msg)


# -- convolutions -------------------------------------------------------------

CONV = [
    ("conv1d", (2, 4, 12), (6, 4, 3), dict(padding=1, stride=2)),
    ("conv1d", (2, 12, 4), (6, 2, 3), dict(padding="SAME", stride=2,
                                           groups=2, data_format="NLC")),
    ("conv1d", (2, 4, 12), (6, 4, 3), dict(padding=[2, 0], dilation=2)),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), dict(padding=1)),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), dict(padding=[1, 2], stride=2)),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 2), dict(padding=[0, 1, 2, 0])),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), dict(padding=[(1, 0), (0, 2)])),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), dict(padding="SAME", stride=2,
                                                dilation=2)),
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), dict(padding="VALID")),
    ("conv2d", (2, 9, 9, 4), (6, 2, 3, 3), dict(padding=1, groups=2,
                                                data_format="NHWC")),
    ("conv2d", (2, 4, 8, 8), (8, 4, 1, 1), dict(stride=2)),
    ("conv3d", (1, 2, 5, 6, 6), (3, 2, 3, 3, 3), dict(padding=1,
                                                      stride=(1, 2, 2))),
    ("conv3d", (1, 5, 6, 6, 2), (3, 2, 2, 3, 3), dict(padding="SAME",
                                                      data_format="NDHWC")),
]

CONV_T = [
    ("conv1d_transpose", (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1,
                                                    output_padding=1)),
    ("conv1d_transpose", (2, 7, 4), (4, 3, 3), dict(stride=2, padding="SAME",
                                                    data_format="NLC")),
    ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3), dict(stride=2,
                                                          padding=1)),
    ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
     dict(stride=2, padding=[1, 0, 2, 1], output_padding=1)),
    ("conv2d_transpose", (2, 4, 5, 5), (4, 2, 3, 3),
     dict(stride=1, padding="SAME", groups=2, dilation=2)),
    ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
     dict(stride=2, output_size=[9, 10])),
    ("conv2d_transpose", (2, 5, 5, 4), (4, 3, 2, 2),
     dict(stride=2, data_format="NHWC")),
    ("conv3d_transpose", (1, 2, 3, 4, 4), (2, 3, 2, 3, 3), dict(stride=2,
                                                                padding=1)),
]


@pytest.mark.parametrize("case", CONV + CONV_T,
                         ids=lambda c: f"{c[0]}-{c[3]}")
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv_functional(case, with_bias):
    name, xs, ws, kw = case
    fan_in = int(np.prod(ws[1:]))
    arrays = [_x(xs), _w(ws, fan_in)]
    if with_bias:
        out_c = ws[1] * kw.get("groups", 1) if "transpose" in name else ws[0]
        arrays.append(_x((out_c,), seed=2))
    ref, got, rg, pg = _both(name, arrays, kw)
    _check(ref, got, msg=name)
    for a, b in zip(rg, pg):
        _check_grad(a, b, msg=f"{name} grad")


LAYERS = [
    ("Conv1D", (4, 6, 3), dict(padding=1), (2, 4, 10)),
    ("Conv2D", (3, 4, 3), dict(padding=1, stride=2), (2, 3, 9, 9)),
    ("Conv2D", (4, 4, 3), dict(padding=1, groups=2, bias_attr=False),
     (2, 4, 6, 6)),
    ("Conv3D", (2, 3, 3), dict(padding=1), (1, 2, 4, 5, 5)),
    ("Conv1DTranspose", (4, 3, 3), dict(stride=2), (2, 4, 6)),
    ("Conv2DTranspose", (4, 3, 3), dict(stride=2, padding=1), (2, 4, 5, 5)),
    ("Conv3DTranspose", (2, 3, 2), dict(stride=2), (1, 2, 3, 3, 3)),
]


def _load(ref_layer, port_layer):
    """The reference layer's state into the port's layer."""
    port_layer.set_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in ref_layer.state_dict().items()})
    return port_layer


@pytest.mark.parametrize("case", LAYERS, ids=lambda c: c[0] + str(c[2]))
def test_conv_layers(case):
    cls, args, kw, xs = case
    paddle.seed(3)
    ref = getattr(rnn, cls)(*args, **kw)
    port = _load(ref, getattr(nn, cls)(*args, **kw))
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    x = _x(xs)
    _check(ref(jnp.asarray(x)), port(torch.from_numpy(x)), msg=cls)


def test_conv_layer_init_follows_the_reference_rule():
    """KaimingUniform(fan_in) weights and a Uniform(±1/sqrt(fan_in)) bias:
    the bounds and the spread of a large layer."""
    conv = nn.Conv2D(64, 128, 3)
    fan_in = 64 * 9
    w, b = conv.weight.detach(), conv.bias.detach()
    lim = np.sqrt(2.0) * np.sqrt(3.0 / fan_in)
    assert w.shape == (128, 64, 3, 3) and float(w.abs().max()) <= lim
    assert abs(float(w.std()) - lim / np.sqrt(3.0)) < 0.02 * lim
    assert float(b.abs().max()) <= 1.0 / np.sqrt(fan_in)
    t = nn.Conv2DTranspose(8, 6, 3, groups=2)
    assert tuple(t.weight.shape) == (8, 3, 3, 3)


# -- pooling ------------------------------------------------------------------

POOL = [
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool1d", (2, 11, 3), dict(kernel_size=2, data_format="NLC")),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=2, padding="SAME")),
    ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=(3, 2), stride=(2, 1),
                                      padding=[1, 0, 0, 1])),
    ("max_pool2d", (2, 9, 9, 3), dict(kernel_size=3, stride=2,
                                      data_format="NHWC")),
    ("max_pool3d", (1, 2, 5, 6, 6), dict(kernel_size=2, stride=2)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, padding=1,
                                    exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 8, 8), dict(kernel_size=2)),
    ("avg_pool2d", (2, 9, 9, 3), dict(kernel_size=3, padding="SAME",
                                      data_format="NHWC")),
    ("avg_pool3d", (1, 2, 5, 6, 6), dict(kernel_size=3, stride=2,
                                         padding=1)),
    ("adaptive_avg_pool1d", (2, 3, 12), dict(output_size=4)),
    ("adaptive_avg_pool1d", (2, 3, 11), dict(output_size=4)),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), dict(output_size=(1, 1))),
    ("adaptive_avg_pool2d", (2, 3, 9, 7), dict(output_size=(4, 3))),
    ("adaptive_avg_pool2d", (2, 9, 7, 3), dict(output_size=(2, 3),
                                               data_format="NHWC")),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), dict(output_size=(2, 3, 3))),
    ("adaptive_max_pool1d", (2, 3, 11), dict(output_size=3)),
    ("adaptive_max_pool2d", (2, 3, 9, 7), dict(output_size=(4, 3))),
    ("adaptive_max_pool2d", (2, 3, 8, 8), dict(output_size=2)),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 7), dict(output_size=2)),
]


@pytest.mark.parametrize("case", POOL, ids=lambda c: f"{c[0]}-{c[2]}")
def test_pool_functional(case):
    name, xs, kw = case
    ref, got, rg, pg = _both(name, [_x(xs)], kw)
    if "max" in name:
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    else:
        _check(ref, got, msg=name)
    _check_grad(rg[0], pg[0], msg=f"{name} grad")


def test_max_pool_of_integers_pads_with_the_least_value():
    x = np.random.RandomState(0).randint(-50, 50, (2, 3, 7, 7)).astype(
        np.int32)
    ref = rF.max_pool2d(jnp.asarray(x), 3, stride=2, padding=1)
    got = F.max_pool2d(torch.from_numpy(x), 3, stride=2, padding=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,kw", [
    ("max_pool2d", dict(kernel_size=2, stride=2, ceil_mode=True)),
    ("max_pool2d", dict(kernel_size=3, stride=2, return_mask=True)),
    ("max_pool1d", dict(kernel_size=2, stride=2, ceil_mode=True,
                        return_mask=True)),
    ("avg_pool2d", dict(kernel_size=2, stride=2, ceil_mode=True)),
    ("avg_pool2d", dict(kernel_size=2, stride=2, divisor_override=3)),
])
def test_pooling_ignores_ceil_mode_and_return_mask(name, kw):
    """Planted: a 9-wide input where ceil_mode would add an output and
    return_mask would return (values, indices); the reference's output is
    the floor rule's values alone, and so is the port's."""
    shape = (2, 3, 9) if name.endswith("1d") else (2, 3, 9, 9)
    x = _x(shape)
    ref = getattr(rF, name)(jnp.asarray(x), **kw)
    got = getattr(F, name)(torch.from_numpy(x), **kw)
    assert isinstance(got, torch.Tensor) and not isinstance(ref, tuple)
    k, s = kw["kernel_size"], kw["stride"]
    floor = (9 - k) // s + 1
    assert got.shape[-1] == floor == ref.shape[-1]
    _check(ref, got)
    if name == "max_pool2d" and kw.get("ceil_mode"):
        torch_ceil = torch.nn.functional.max_pool2d(
            torch.from_numpy(x), k, s, ceil_mode=True)
        assert torch_ceil.shape[-1] == floor + 1   # the planted difference


POOL_LAYERS = [
    ("MaxPool1D", (3,), dict(stride=2, padding=1), (2, 3, 10)),
    ("MaxPool2D", (3,), dict(stride=2, padding=1, ceil_mode=True,
                             return_mask=True), (2, 3, 9, 9)),
    ("MaxPool3D", (2,), dict(), (1, 2, 4, 4, 4)),
    ("AvgPool1D", (3,), dict(padding=1, exclusive=False), (2, 3, 10)),
    ("AvgPool2D", (3,), dict(stride=2, padding=1), (2, 3, 9, 9)),
    ("AvgPool3D", (2,), dict(stride=2), (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool1D", (3,), dict(), (2, 3, 10)),
    ("AdaptiveAvgPool2D", ((1, 1),), dict(), (2, 3, 7, 7)),
    ("AdaptiveAvgPool3D", (2,), dict(), (1, 2, 5, 5, 5)),
    ("AdaptiveMaxPool1D", (3,), dict(), (2, 3, 10)),
    ("AdaptiveMaxPool2D", (3,), dict(), (2, 3, 7, 7)),
    ("AdaptiveMaxPool3D", (2,), dict(), (1, 2, 5, 5, 5)),
]


@pytest.mark.parametrize("case", POOL_LAYERS, ids=lambda c: c[0])
def test_pool_layers(case):
    cls, args, kw, xs = case
    x = _x(xs)
    ref = getattr(rnn, cls)(*args, **kw)(jnp.asarray(x))
    got = getattr(nn, cls)(*args, **kw)(torch.from_numpy(x))
    _check(ref, got, msg=cls)


# -- normalization ------------------------------------------------------------

NORM_FN = [
    ("instance_norm", (2, 3, 5, 5), dict()),
    ("instance_norm", (2, 5, 5, 3), dict(data_format="NHWC")),
    ("group_norm", (2, 6, 4, 4), dict(num_groups=3)),
    ("group_norm", (2, 4, 4, 6), dict(num_groups=2, data_format="NHWC")),
    ("normalize", (4, 6), dict()),
    ("normalize", (4, 6, 3), dict(p=1, axis=-1)),
    ("normalize", (4, 6), dict(p=3, axis=0)),
    ("local_response_norm", (2, 7, 4, 4), dict(size=5)),
    ("local_response_norm", (2, 4, 4, 6), dict(size=4, alpha=1e-2, beta=0.5,
                                               k=2.0, data_format="NHWC")),
]


@pytest.mark.parametrize("case", NORM_FN, ids=lambda c: f"{c[0]}-{c[2]}")
def test_norm_functional(case):
    name, xs, kw = case
    ref, got, rg, pg = _both(name, [_x(xs)], kw)
    _check(ref, got, msg=name)
    _check_grad(rg[0], pg[0], msg=f"{name} grad")


def test_norm_functional_affine():
    x, w, b = _x((2, 6, 4, 4)), _x((6,), 1), _x((6,), 2)
    for name, kw in (("group_norm", dict(num_groups=2)),
                     ("instance_norm", dict())):
        ref = getattr(rF, name)(jnp.asarray(x), weight=jnp.asarray(w),
                                bias=jnp.asarray(b), **kw)
        got = getattr(F, name)(torch.from_numpy(x), weight=torch.from_numpy(w),
                               bias=torch.from_numpy(b), **kw)
        _check(ref, got, msg=name)


@pytest.mark.parametrize("data_format,shape", [
    ("NCHW", (4, 3, 5, 5)), ("NHWC", (4, 5, 5, 3)), ("NCW", (4, 3, 7)),
    ("NC", (8, 3))])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_functional(data_format, shape, training):
    c = shape[-1] if data_format[-1] == "C" else shape[1]
    x = _x(shape)
    rm, rv = _x((c,), 3) * 0.1, np.abs(_x((c,), 4)) + 0.5
    w, b = _x((c,), 5), _x((c,), 6)
    arrays = [x, rm, rv, w, b]
    kw = dict(training=training, momentum=0.8,
              data_format=data_format if data_format != "NC" else "NCHW")
    ref = rF.batch_norm(*[jnp.asarray(a) for a in arrays], **kw)
    got = F.batch_norm(*[torch.from_numpy(a) for a in arrays], **kw)
    if training:
        for a, g in zip(ref, got):
            _check(a, g)
    else:
        _check(ref, got)
    # gradients of sum(out * r) w.r.t. x, weight and bias
    r = _x(shape, 9)

    def loss(xx, ww, bb):
        o = rF.batch_norm(xx, jnp.asarray(rm), jnp.asarray(rv), ww, bb, **kw)
        return jnp.sum((o[0] if training else o) * r)

    rg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    o = F.batch_norm(ts[0], torch.from_numpy(rm), torch.from_numpy(rv),
                     ts[1], ts[2], **kw)
    pg = torch.autograd.grad(((o[0] if training else o) *
                              torch.from_numpy(r)).sum(), ts)
    for a, g in zip(rg, pg):
        _check_grad(a, g)


BN_LAYERS = [
    ("BatchNorm1D", (3,), dict(), (6, 3, 5)),
    ("BatchNorm1D", (3,), dict(), (6, 3)),
    ("BatchNorm2D", (3,), dict(momentum=0.8), (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(data_format="NHWC"), (4, 5, 5, 3)),
    ("BatchNorm3D", (2,), dict(), (2, 2, 3, 4, 4)),
    ("BatchNorm", (3,), dict(act="relu"), (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(weight_attr=False, bias_attr=False),
     (4, 3, 5, 5)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BN_LAYERS, ids=lambda c: c[0] + str(c[2]))
def test_batch_norm_layers_and_running_stats(case, dtype):
    """Three training forwards (stats after each), then one in eval mode
    on the moved statistics; bfloat16: both models cast whole."""
    cls, args, kw, xs = case
    paddle.seed(4)
    ref = getattr(rnn, cls)(*args, **kw)
    port = _load(ref, getattr(nn, cls)(*args, **kw))
    tol = dict(rtol=RTOL, atol=ATOL)
    if dtype == "bfloat16":
        ref.bfloat16()
        port.bfloat16()
        tol = dict(rtol=BF16_TOL, atol=BF16_TOL)
        assert port._mean.dtype == torch.bfloat16
    for i in range(3):
        x = _x(xs, seed=10 + i) * (1.0 + i) + i
        xr, xp = jnp.asarray(x, dtype=dtype), torch.from_numpy(x).to(
            getattr(torch, dtype))
        _check(ref(xr).astype(jnp.float32), port(xp), **tol,
               msg=f"{cls} step {i}")
        _check(ref._mean.astype(jnp.float32), port._mean, **tol)
        _check(ref._variance.astype(jnp.float32), port._variance, **tol)
        assert port._mean.dtype == getattr(torch, dtype)
    ref.eval()
    port.eval()
    x = _x(xs, seed=20)
    _check(ref(jnp.asarray(x, dtype=dtype)).astype(jnp.float32),
           port(torch.from_numpy(x).to(getattr(torch, dtype))), **tol)


def test_batch_norm_bf16_input_with_float32_stats_promotes():
    """bfloat16 x against float32 running stats: the new stats stay
    float32 and the evaluation output promotes to float32, as jnp's."""
    paddle.seed(4)
    ref = rnn.BatchNorm2D(3)
    port = _load(ref, nn.BatchNorm2D(3))
    x = _x((4, 3, 5, 5))
    ref(jnp.asarray(x, dtype=jnp.bfloat16))
    port(torch.from_numpy(x).bfloat16())
    assert port._mean.dtype == torch.float32 and ref._mean.dtype == \
        jnp.float32
    _check(ref._mean, port._mean, rtol=BF16_TOL, atol=BF16_TOL)
    ref.eval()
    port.eval()
    out_r = ref(jnp.asarray(x, dtype=jnp.bfloat16))
    out_p = port(torch.from_numpy(x).bfloat16())
    assert out_p.dtype == torch.float32 and out_r.dtype == jnp.float32
    _check(out_r, out_p, rtol=BF16_TOL, atol=BF16_TOL)


OTHER_NORM = [
    ("GroupNorm", (2, 6), dict(), (2, 6, 4, 4)),
    ("GroupNorm", (3, 6), dict(data_format="NHWC"), (2, 4, 4, 6)),
    ("InstanceNorm1D", (3,), dict(), (2, 3, 8)),
    ("InstanceNorm2D", (3,), dict(), (2, 3, 5, 5)),
    ("InstanceNorm3D", (2,), dict(weight_attr=False), (2, 2, 3, 4, 4)),
    ("LocalResponseNorm", (3,), dict(), (2, 5, 4, 4)),
    ("LayerNorm", (5,), dict(), (2, 3, 5)),
]


@pytest.mark.parametrize("case", OTHER_NORM, ids=lambda c: c[0] + str(c[2]))
def test_other_norm_layers(case):
    cls, args, kw, xs = case
    paddle.seed(5)
    ref = getattr(rnn, cls)(*args, **kw)
    port = _load(ref, getattr(nn, cls)(*args, **kw))
    x = _x(xs)
    _check(ref(jnp.asarray(x)), port(torch.from_numpy(x)), msg=cls)


def test_spectral_norm_on_the_reference_buffers():
    """The power iteration from the reference's own u and v (loaded: each
    side draws them from its own generator), two forwards."""
    ref = rnn.SpectralNorm((6, 4, 3), dim=1, power_iters=2)
    port = _load(ref, nn.SpectralNorm((6, 4, 3), dim=1, power_iters=2))
    for seed in (0, 1):
        w = _x((6, 4, 3), seed)
        _check(ref(jnp.asarray(w)), port(torch.from_numpy(w)), rtol=1e-5,
               atol=1e-5)
        _check(ref.weight_u, port.weight_u, atol=1e-5)


def test_sync_batch_norm_without_a_mesh_is_batch_norm():
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.set_mesh(None)
    torch.manual_seed(0)
    bn, sbn = nn.BatchNorm2D(3), nn.SyncBatchNorm(3)
    x = torch.from_numpy(_x((4, 3, 5, 5)))
    torch.testing.assert_close(bn(x), sbn(x), rtol=0, atol=0)
    torch.testing.assert_close(bn._variance, sbn._variance, rtol=0, atol=0)


def test_convert_sync_batchnorm_shares_parameters_and_buffers():
    model = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                          nn.Sequential(nn.BatchNorm1D(4)))
    bn, inner = model[1], model[2][0]
    out = nn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert out is model
    assert isinstance(model[1], nn.SyncBatchNorm)
    assert isinstance(model[2][0], nn.SyncBatchNorm)
    assert model[1].weight is bn.weight and model[1]._mean is bn._mean
    assert model[2][0].data_format == inner.data_format
    assert list(model.state_dict()) == ["0.weight", "0.bias", "1.weight",
                                        "1.bias", "1._mean", "1._variance",
                                        "2.0.weight", "2.0.bias",
                                        "2.0._mean", "2.0._variance"]


def _ref_sync_bn(x, n, r, weights):
    """The reference's SyncBatchNorm under shard_map over a data mesh of
    ``n`` CPU devices: (out, x grad, weight and bias grads, new stats)."""
    paddle.seed(6)
    layer = rnn.SyncBatchNorm(3, momentum=worker.SYNCBN_MOMENTUM)
    layer.set_state_dict({k: jnp.asarray(v) for k, v in weights.items()})
    params, buffers = state_of(layer)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("data",))

    fm = jax.shard_map(
        lambda pp, bb, xl: functional_call(layer, pp, bb, xl), mesh=mesh,
        in_specs=(P(), P(), P("data")), out_specs=(P("data"), P()),
        check_vma=False)

    def outer(p, xx):
        out, nb = fm(p, dict(buffers), xx)
        return jnp.sum(out * jnp.asarray(r)), (out, nb)

    (_, (out, nb)), (gp, gx) = jax.value_and_grad(
        outer, argnums=(0, 1), has_aux=True)(dict(params), jnp.asarray(x))
    return (np.asarray(out), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()},
            {k: np.asarray(v) for k, v in nb.items()})


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_matches_the_reference_pmean(n, tmp_path_factory):
    x, r, weights = worker.syncbn_data()
    ranks = worker.world(n, tmp_path_factory, kinds=SYNCBN_KINDS)
    out, gx, gp, stats = _ref_sync_bn(x, n, r, weights)
    c = x.shape[0] // n
    for rank, got in enumerate(ranks):
        g = got["syncbn"]
        _check(out[rank * c:(rank + 1) * c], g["out"])
        _check_grad(gx[rank * c:(rank + 1) * c], g["grad_x"])
        for k in ("_mean", "_variance"):
            _check(stats[k], g["stats"][k])
    for k in ("weight", "bias"):
        _check_grad(gp[k], sum(got["syncbn"]["grads"][k] for got in ranks))


def _expected_stats(x, n, sync, steps, skipped):
    """The running statistics after each trainer step (float64)."""
    m = worker.SYNCBN_MOMENTUM
    x = x.astype(np.float64)
    if sync:
        mean = x.mean(axis=(0, 2, 3))
        var = (x ** 2).mean(axis=(0, 2, 3)) - mean ** 2
    else:
        parts = np.split(x, n)
        mean = np.mean([p.mean(axis=(0, 2, 3)) for p in parts], axis=0)
        var = np.mean([p.var(axis=(0, 2, 3)) for p in parts], axis=0)
    rm, rv = np.zeros(3), np.ones(3)
    out = []
    for step in range(steps):
        if step not in skipped:
            rm, rv = m * rm + (1 - m) * mean, m * rv + (1 - m) * var
        out.append({"_mean": rm, "_variance": rv})
    return out


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "sync"])
def test_trainer_keeps_one_copy_of_the_running_stats(n, kind,
                                                     tmp_path_factory):
    x, _, _ = worker.syncbn_data()
    ranks = worker.world(n, tmp_path_factory, kinds=SYNCBN_KINDS)
    want = _expected_stats(x, n, kind == "sync", worker.BNSTATS_STEPS,
                           skipped={2})
    first = ranks[0]["bnstats"][kind]
    assert first["skipped"] == 1
    for got in ranks:
        g = got["bnstats"][kind]
        for step, (gs, ws) in enumerate(zip(g["stats"], want)):
            for k in ("_mean", "_variance"):
                np.testing.assert_array_equal(gs[k], first["stats"][step][k])
                np.testing.assert_allclose(gs[k], ws[k], rtol=1e-6,
                                           atol=1e-7, err_msg=(step, k))
        np.testing.assert_array_equal(g["eval"], first["eval"])
    # the ranks' own slices differ, so unaveraged statistics would too
    if kind == "plain":
        parts = np.split(x.astype(np.float64), n)
        assert np.ptp([p.mean(axis=(0, 2, 3)) for p in parts], axis=0).max() \
            > 1e-2


# -- activations and containers -------------------------------------------------

ACTS = [("CELU", {}), ("ELU", dict(alpha=0.5)), ("GELU", {}),
        ("GELU", dict(approximate=True)), ("Hardshrink", {}),
        ("Hardsigmoid", {}), ("Hardswish", {}), ("Hardtanh", {}),
        ("LogSigmoid", {}), ("Mish", {}), ("ReLU", {}), ("ReLU6", {}),
        ("SELU", {}), ("Sigmoid", {}), ("Silu", {}), ("Softplus", {}),
        ("Softplus", dict(beta=2.0, threshold=1.0)), ("Softshrink", {}),
        ("Softsign", {}), ("Swish", {}), ("Tanh", {}), ("Tanhshrink", {}),
        ("ThresholdedReLU", {}), ("LeakyReLU", {}), ("PReLU", {}),
        ("PReLU", dict(num_parameters=6)), ("RReLU", {}), ("Softmax", {}),
        ("LogSoftmax", dict(axis=1)), ("Maxout", dict(groups=3)),
        ("GLU", dict(axis=1))]


@pytest.mark.parametrize("case", ACTS, ids=lambda c: c[0] + str(c[1]))
def test_activation_layers(case):
    cls, kw = case
    x = _x((2, 6, 5)) * 3.0
    ref = getattr(rnn, cls)(**kw)
    port = _load(ref, getattr(nn, cls)(**kw))
    ref.eval()
    port.eval()
    _check(ref(jnp.asarray(x)), port(torch.from_numpy(x)), msg=cls)


def test_rrelu_in_training_draws_slopes_in_range():
    x = -torch.ones(1000)
    y = nn.RReLU(0.1, 0.3)(x)
    assert float(y.min()) >= -0.3 and float(y.max()) <= -0.1
    assert float(y.std()) > 0.01


def test_containers_name_as_the_reference():
    from collections import OrderedDict
    paddle.seed(0)
    ref = rnn.Sequential(rnn.Linear(3, 4), rnn.ReLU(),
                         rnn.Sequential(("head", rnn.Linear(4, 2))))
    port = nn.Sequential(nn.Linear(3, 4), nn.ReLU(),
                         nn.Sequential(("head", nn.Linear(4, 2))))
    assert list(port.named_state()) == list(ref.state_dict())
    x = _x((2, 3))
    _load(ref, port)
    _check(ref(jnp.asarray(x)), port(torch.from_numpy(x)))
    named = nn.Sequential(OrderedDict([("x", nn.ReLU()), ("y", nn.Tanh())]))
    assert [n for n, _ in named.named_children()] == ["x", "y"]
    assert isinstance(port[1:], nn.Sequential) and len(port[1:]) == 2
    plist = nn.ParameterList([torch.nn.Parameter(torch.zeros(2)),
                              torch.nn.Parameter(torch.ones(3))])
    rlist = rnn.ParameterList([rnn.layer.Parameter(jnp.zeros(2)),
                               rnn.layer.Parameter(jnp.ones(3))])
    assert [n for n, _ in plist.named_parameters()] == \
        [n for n, _ in rlist.named_parameters()]
    rdict = rnn.LayerDict({"a": rnn.Linear(2, 2), "b": rnn.Linear(2, 3)})
    pdict = nn.LayerDict({"a": nn.Linear(2, 2)})
    pdict["b"] = nn.Linear(2, 3)
    assert list(pdict.keys()) == ["a", "b"] and "b" in pdict
    assert list(pdict.named_state()) == list(rdict.state_dict())
