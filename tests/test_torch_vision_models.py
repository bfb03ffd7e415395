"""The port's LeNet, MobileNet V1/V2 and VGG (``vision/models``) against
the JAX package's, on the CPU.

- Each family at a narrow width (LeNet at 1x28x28; ``mobilenet_v1`` and
  ``mobilenet_v2`` at ``scale=0.25``; ``VGG`` on a short ``make_layers``
  cfg with batch norm; ``num_classes`` 10), from
  ``recipes.zoo_weights`` (every ``Dropout`` at p 0, whose masks the
  packages draw from their own generators): the forward, the gradients
  of ``sum(out * r)`` (input and parameters) and the batch-norm buffers
  after it, at the conv tests' bars (rtol 1e-5, atol 1e-5 of the largest
  element). LeNet and VGG in training mode; the MobileNets in eval mode
  (batch 2 at 32x32): in training mode at any batch this CPU can afford,
  their batch norms over a few values a channel turn float32's rounding
  into gradients 1e-4 apart and, after one step, losses 6% apart (measured,
  MobileNetV1 at 4 x 32x32), so their training is held where it is
  conditioned: MobileNetV2's golden (batch 8 at 64x64) below and on the
  card. VGG's check runs in ``test_torch_vision_train.py`` (its
  102M-weight classifier is the costly build), beside LeNet's two
  trainer steps against the reference's trainer.
- The full-width models (``mobilenet_v2()``, ``vgg16()``, ``LeNet()``):
  the state names and shapes in order and the parameter counts against
  ``paddle_tpu_torch/testdata/vision_zoo_golden.json`` (written by
  ``tests/torch_vision_zoo_golden.py``); LeNet's and MobileNetV2's
  golden step-0 loss (rtol 1e-4) and gradient norm (2e-3, the ResNet
  golden's bar) on the CPU.
- ``pretrained=True`` raises, as in the reference.

Both packages' models are built with constant initializers (the recipe
overwrites every weight): the reference's random initializers take
seconds a model on this CPU, and VGG's 102M-weight classifier the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.nn import initializer as rinit
from paddle_tpu.vision import models as rmodels

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.testdata import recipes
from paddle_tpu_torch.vision import models as pmodels

import torch_vision_zoo_golden as golden

SHORT = [8, "M", 512, "M"]
NARROW = {
    # name: (build(models), batch, channels, image, training mode)
    "lenet": (lambda m: m.LeNet(num_classes=10), 4, 1, 28, True),
    "mobilenet_v1": (lambda m: m.mobilenet_v1(scale=0.25, num_classes=10),
                     2, 3, 32, False),
    "mobilenet_v2": (lambda m: m.mobilenet_v2(scale=0.25, num_classes=10),
                     2, 3, 32, False),
    "vgg_bn": (lambda m: m.VGG(m.vgg.make_layers(SHORT, batch_norm=True),
                               num_classes=10), 4, 3, 16, True),
}
# the reference's fwd/bwd compiled without XLA's costly passes: the same
# ops, a third of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
_WEIGHTS = {}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: beside other test
    processes on the same cores, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _constant_built(init, fn):
    """``fn()`` under ``init``'s constant global initializers (the recipe
    overwrites every weight after)."""
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    try:
        return fn()
    finally:
        init.set_global_initializer(None)


def pair(name):
    """(reference model, port model, recipe state), Dropout at p 0."""
    build = NARROW[name][0]
    rm = _constant_built(rinit, lambda: build(rmodels))
    pm = _constant_built(pinit, lambda: build(pmodels))
    recipes.no_dropout(rm)
    recipes.no_dropout(pm)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in rm.state_dict().items()]
    assert [(n, tuple(t.shape)) for n, t in pm.named_state().items()] == \
        names_shapes
    if name not in _WEIGHTS:
        _WEIGHTS[name] = recipes.zoo_weights(names_shapes, 0)
    w = _WEIGHTS[name]
    rm.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    pm.set_state_dict_from_numpy(w)
    return rm, pm, w


def data(name, seed=1, batch=None, size=None):
    _, b, c, s, _ = NARROW[name]
    return recipes.zoo_data(seed, batch or b, c, size or s, 10)


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=msg)


@pytest.mark.parametrize("name", ["lenet", "mobilenet_v1", "mobilenet_v2"])
def test_forward_and_backward_match_the_reference(name):
    check_forward_and_backward(name, *pair(name)[:2])


def check_forward_and_backward(name, rm, pm):
    if not NARROW[name][4]:
        rm.eval()
        pm.eval()
    x, _ = data(name)
    r = np.random.RandomState(3).randn(x.shape[0], 10).astype(np.float32)
    params, buffers = state_of(rm)

    def loss(p, xx):
        out, nb = functional_call(rm, p, buffers, xx)
        return jnp.sum(out * r), (out, nb)

    (_, (out, nb)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)).lower(
        dict(params), jnp.asarray(x)).compile(
        compiler_options=FAST_COMPILE)(dict(params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pm(xt)
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                [xt] + list(pm.parameters()))
    _close(y.detach().numpy(), out, "out")
    _close(grads[0].numpy(), gx, "x grad")
    for k, g in zip(names, grads[1:]):
        _close(g.numpy(), gp[k], k)
    for k, v in nb.items():
        _close(pm.state_dict()[k].numpy(), v, k)


FULL = {"mobilenet_v2": pmodels.mobilenet_v2, "vgg16": pmodels.vgg16,
        "lenet": pmodels.LeNet}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_state_matches_the_golden(name):
    gold = golden.load()["models"][name]
    model = FULL[name](num_classes=gold["config"]["num_classes"])
    names_shapes = [[n, list(t.shape)] for n, t in
                    model.named_state().items()]
    assert names_shapes == gold["names_shapes"]
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == gold["config"]["parameters"]
    assert n_params == {"mobilenet_v2": 3_504_872, "vgg16": 138_357_544,
                        "lenet": 61_610}[name]


@pytest.mark.parametrize("name", ["lenet", "mobilenet_v2"])
def test_golden_step0_on_the_cpu(name):
    gold = golden.load()
    g = gold["models"][name]
    model = FULL[name](num_classes=g["config"]["num_classes"])
    recipes.no_dropout(model)
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    model.set_state_dict_from_numpy(golden.weights(
        names_shapes, gold["recipe"]["weights"]["seed"]))
    x, y = golden.data(name, gold["recipe"]["data"]["seed"])
    loss = nn.functional.cross_entropy(model(torch.from_numpy(x)),
                                       torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    gnorm = torch.sqrt(sum(t.double().square().sum() for t in grads)).item()
    np.testing.assert_allclose(float(loss), g["losses"][0], rtol=1e-4)
    np.testing.assert_allclose(gnorm, g["step0_grad_norm"], rtol=2e-3)


@pytest.mark.parametrize("ctor", ["mobilenet_v1", "mobilenet_v2", "vgg11",
                                  "vgg13", "vgg16", "vgg19"])
def test_pretrained_raises(ctor):
    with pytest.raises(NotImplementedError):
        getattr(pmodels, ctor)(pretrained=True)
    with pytest.raises(NotImplementedError):
        getattr(rmodels, ctor)(pretrained=True)


def test_every_public_name_is_ported():
    import importlib
    for mod in ("", ".lenet", ".mobilenet", ".vgg"):
        ref = importlib.import_module("paddle_tpu.vision.models" + mod)
        port = importlib.import_module("paddle_tpu_torch.vision.models" + mod)
        public = {n for n, v in vars(ref).items() if not n.startswith("__")
                  and getattr(v, "__module__", ref.__name__).startswith(
                      "paddle_tpu.vision")}
        missing = sorted(n for n in public if not hasattr(port, n))
        assert not missing, (mod, missing)
    assert pmodels.vgg.cfgs == rmodels.vgg.cfgs
    for bn in (False, True):
        rl = _constant_built(rinit, lambda: rmodels.vgg.make_layers(
            SHORT, batch_norm=bn))
        pl = pmodels.vgg.make_layers(SHORT, batch_norm=bn)
        assert [(n, tuple(v.shape)) for n, v in rl.state_dict().items()] \
            == [(n, tuple(t.shape)) for n, t in pl.named_state().items()]
    for v in (7, 10, 33.6, 1280 * 0.25):
        assert pmodels.mobilenet._make_divisible(v) == \
            rmodels.mobilenet._make_divisible(v)
