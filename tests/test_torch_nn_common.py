"""The port's common functionals and layers (``nn/functional/common.py``,
``nn/layers/common.py``) against the JAX package's on the same numpy
inputs from a seed, float32, rtol 1e-5 and atol 1e-6 (the resizes'
weighted sums in another order). ``interpolate`` is held in every mode,
both ``align_corners``, up and down (``jax.image.resize``'s antialiased
kernels when shrinking). The random functionals (the dropouts,
``class_center_sample``) draw from each package's own generator, so they
are held by their structure: masks whole channels, kept values scaled,
evaluation mode the identity, every positive class sampled and the
labels remapped onto it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port

RS = np.random.RandomState(5)
RTOL, ATOL = 1e-5, 1e-6
RF, PF = ref.nn.functional, port.nn.functional


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


X4 = RS.randn(2, 3, 5, 7).astype(np.float32)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(9, 12), (3, 4), (5, 14)])
def test_interpolate_2d(mode, align_corners, size):
    want = RF.interpolate(jnp.asarray(X4), size=size, mode=mode,
                          align_corners=align_corners)
    got = PF.interpolate(torch.from_numpy(X4), size=size, mode=mode,
                         align_corners=align_corners)
    _close(got, want, atol=2e-6)


@pytest.mark.parametrize("mode,fmt,x", [
    ("linear", "NCW", RS.randn(2, 3, 6).astype(np.float32)),
    ("trilinear", "NCDHW", RS.randn(1, 2, 4, 5, 3).astype(np.float32)),
    ("bilinear", "NHWC", RS.randn(2, 5, 4, 3).astype(np.float32))])
def test_interpolate_other_ranks_and_layouts(mode, fmt, x):
    kw = dict(scale_factor=2, mode=mode, data_format=fmt)
    _close(PF.upsample(torch.from_numpy(x), **kw),
           RF.upsample(jnp.asarray(x), **kw))


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("pad", [[1, 2], [1, 2, 2, 1],
                                 [0, 0, 1, 0, 2, 1, 0, 3]])
def test_pad(mode, pad):
    kw = dict(mode=mode, value=0.5)
    _close(PF.pad(torch.from_numpy(X4), pad, **kw),
           RF.pad(jnp.asarray(X4), pad, **kw))


def test_pad_channel_last():
    x = RS.randn(2, 5, 4, 3).astype(np.float32)
    kw = dict(mode="reflect", data_format="NHWC")
    _close(PF.pad(torch.from_numpy(x), [1, 2, 2, 1], **kw),
           RF.pad(jnp.asarray(x), [1, 2, 2, 1], **kw))


def test_fold_unfold():
    kw = dict(strides=[1, 2], paddings=1, dilations=[2, 1])
    want = RF.unfold(jnp.asarray(X4), [2, 3], **kw)
    got = PF.unfold(torch.from_numpy(X4), [2, 3], **kw)
    _close(got, want)
    _close(PF.fold(got, [5, 7], [2, 3], **kw),
           RF.fold(want, [5, 7], [2, 3], **kw))


def test_small_functionals():
    ids = RS.randint(0, 6, (3, 4))
    ids[0, 0] = 7                                   # out of range: zeros
    _close(PF.one_hot(torch.from_numpy(ids), 6), RF.one_hot(
        jnp.asarray(ids), 6))
    lab = RS.rand(3, 6).astype(np.float32)
    prior = RS.rand(6).astype(np.float32)
    _close(PF.label_smooth(torch.from_numpy(lab), epsilon=0.2),
           RF.label_smooth(jnp.asarray(lab), epsilon=0.2))
    _close(PF.label_smooth(torch.from_numpy(lab), torch.from_numpy(prior)),
           RF.label_smooth(jnp.asarray(lab), jnp.asarray(prior)))
    a, b = RS.randn(4, 5).astype(np.float32), RS.randn(4, 5).astype(
        np.float32)
    _close(PF.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)),
           RF.cosine_similarity(jnp.asarray(a), jnp.asarray(b)))
    w, bias = RS.randn(3, 5, 5).astype(np.float32), RS.randn(3).astype(
        np.float32)
    _close(PF.bilinear(*map(torch.from_numpy, (a, b, w, bias))),
           RF.bilinear(*map(jnp.asarray, (a, b, w, bias))))
    lens = np.array([[1, 4], [0, 3]])
    for kw in ({}, {"maxlen": 6, "dtype": "float32"}):
        got = PF.sequence_mask(torch.from_numpy(lens), **kw)
        want = RF.sequence_mask(jnp.asarray(lens), **kw)
        assert got.shape == want.shape
        _close(got.float(), np.asarray(want, np.float32))


def test_dropouts_structure():
    x = torch.ones(8, 16, 4, 4)
    port.seed(3)
    y = PF.dropout2d(x, p=0.5)
    per_channel = y.reshape(8, 16, -1)
    assert torch.all(per_channel.amax(-1) == per_channel.amin(-1))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    y3 = PF.dropout3d(torch.ones(4, 8, 2, 3, 3), p=0.25)
    assert torch.all(y3.reshape(4, 8, -1).std(-1) == 0)
    for f in (PF.dropout2d, PF.alpha_dropout):
        assert torch.equal(f(x, p=0.5, training=False), x)
    z = torch.from_numpy(RS.randn(200000).astype(np.float32))
    a = PF.alpha_dropout(z, p=0.2)
    assert abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1) < 0.02


def test_class_center_sample():
    label = torch.tensor([3, 9, 3, 17, 0])
    port.seed(0)
    remapped, sampled = PF.class_center_sample(label, 20, 8)
    assert sampled.shape == (8,) and len(set(sampled.tolist())) == 8
    assert {0, 3, 9, 17} <= set(sampled.tolist())
    assert torch.equal(sampled[remapped], label)
    r2, s2 = RF.class_center_sample(jnp.asarray(label.numpy()), 20, 8)
    assert set(np.asarray(s2)[np.asarray(r2)]) == {0, 3, 9, 17}
    with pytest.raises(ValueError):
        PF.class_center_sample(torch.tensor([25]), 20, 8)


def _carry(rl, pl):
    pl.set_state_dict({k: np.asarray(v) for k, v in rl.state_dict().items()})


@pytest.mark.parametrize("name,args,inputs", [
    ("Identity", (), lambda: (X4,)),
    ("Flatten", (1, 2), lambda: (X4,)),
    ("Pad1D", (2,), lambda: (RS.randn(2, 3, 5).astype(np.float32),)),
    ("Pad2D", ([1, 0, 2, 1], "reflect"), lambda: (X4,)),
    ("Pad3D", (1, "replicate"),
     lambda: (RS.randn(1, 2, 3, 4, 5).astype(np.float32),)),
    ("ZeroPad2D", (2,), lambda: (X4,)),
    ("Upsample", (None, 2, "bilinear"), lambda: (X4,)),
    ("UpsamplingNearest2D", ((4, 9),), lambda: (X4,)),
    ("UpsamplingBilinear2D", (None, 3), lambda: (X4,)),
    ("Unfold", ([3, 2], 1, 1), lambda: (X4,)),
    ("Fold", ([5, 7], [2, 2]),
     lambda: (RS.randn(2, 12, 24).astype(np.float32),)),
    ("Bilinear", (4, 5, 3), lambda: (RS.randn(6, 4).astype(np.float32),
                                     RS.randn(6, 5).astype(np.float32))),
    ("CosineSimilarity", (1,), lambda: (X4, X4[::-1].copy())),
    ("PairwiseDistance", (3.0,), lambda: (RS.randn(5, 4).astype(
        np.float32), RS.randn(5, 4).astype(np.float32))),
    ("Dropout2D", (), lambda: (X4,)),
    ("Dropout3D", (), lambda: (RS.randn(1, 2, 3, 4, 5).astype(
        np.float32),)),
    ("AlphaDropout", (0.3,), lambda: (X4,))])
def test_common_layers_match_the_reference(name, args, inputs):
    ref.seed(0)
    rl, pl = getattr(ref.nn, name)(*args), getattr(port.nn, name)(*args)
    _carry(rl, pl)
    rl.eval()
    pl.eval()
    xs = inputs()
    _close(pl(*map(torch.from_numpy, xs)), rl(*map(jnp.asarray, xs)))
