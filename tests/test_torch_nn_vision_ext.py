"""The port's vision and extension functionals and the shuffle layers
(``nn/functional/vision.py``, ``nn/functional/extension.py``,
``nn/layers/vision.py``) against the JAX package's on the same numpy
inputs from a seed, float32: the shuffles and ``diag_embed``,
``gather_tree`` and ``temporal_shift`` move values and must be equal;
``affine_grid`` and ``grid_sample`` (every mode, padding mode and
``align_corners``) within rtol 1e-5, atol 1e-6, and ``grid_sample``'s
gradients against ``jax.grad``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port

RS = np.random.RandomState(9)
RF, PF = ref.nn.functional, port.nn.functional


def _eq(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_shuffles_and_their_layers(fmt):
    x = RS.randn(2, 8, 6, 4).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    for fn, layer, arg in (("pixel_shuffle", "PixelShuffle", 2),
                           ("pixel_unshuffle", "PixelUnshuffle", 2),
                           ("channel_shuffle", "ChannelShuffle", 4)):
        want = getattr(RF, fn)(jnp.asarray(x), arg, data_format=fmt)
        _eq(getattr(PF, fn)(torch.from_numpy(x), arg, data_format=fmt),
            want)
        _eq(getattr(port.nn, layer)(arg, data_format=fmt)(
            torch.from_numpy(x)), want)


@pytest.mark.parametrize("offset,dims", [(0, (-2, -1)), (1, (0, 2)),
                                         (-2, (-1, 1))])
def test_diag_embed(offset, dims):
    x = RS.randn(2, 3, 4).astype(np.float32)
    _eq(PF.diag_embed(torch.from_numpy(x), offset, *dims),
        RF.diag_embed(jnp.asarray(x), offset, *dims))


def test_gather_tree():
    t, b, k = 5, 3, 4
    ids = RS.randint(0, 10, (t, b, k))
    parents = RS.randint(0, k, (t, b, k))
    _eq(PF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents)),
        RF.gather_tree(jnp.asarray(ids), jnp.asarray(parents)))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_temporal_shift(fmt):
    x = RS.randn(6, 8, 2, 3).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    _eq(PF.temporal_shift(torch.from_numpy(x), 3, 0.25, data_format=fmt),
        RF.temporal_shift(jnp.asarray(x), 3, 0.25, data_format=fmt))


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid(align_corners):
    theta = RS.randn(2, 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        PF.affine_grid(torch.from_numpy(theta), [2, 3, 5, 4],
                       align_corners).numpy(),
        np.asarray(RF.affine_grid(jnp.asarray(theta), [2, 3, 5, 4],
                                  align_corners)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(mode, padding, align_corners):
    x = RS.randn(2, 3, 5, 6).astype(np.float32)
    grid = RS.uniform(-1.3, 1.3, (2, 4, 7, 2)).astype(np.float32)
    kw = dict(mode=mode, padding_mode=padding, align_corners=align_corners)
    want = RF.grid_sample(jnp.asarray(x), jnp.asarray(grid), **kw)
    xt = torch.from_numpy(x).requires_grad_()
    got = PF.grid_sample(xt, torch.from_numpy(grid), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    w = RS.randn(*got.shape).astype(np.float32)
    gx = jax.grad(lambda a: jnp.sum(RF.grid_sample(
        a, jnp.asarray(grid), **kw) * w))(jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
