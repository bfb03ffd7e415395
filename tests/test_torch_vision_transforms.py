"""``paddle_tpu_torch.vision.transforms`` and the image backend against
the JAX package's, on the CPU.

Both are host code in numpy: every functional op and every transform
class runs in both packages on the same seeded images (uint8 and float32
HWC arrays, CHW where the class takes it, and PIL images: PIL is
installed here), the random ones after the same ``random.seed``, so both
draw the same crop, flip, angle or jitter. Results equal exactly, except
where the reference resamples with ``jax.image.resize``: the port's
numpy resample (``functional.resize_array``) sums its float32 products in
another order, so float results are held within rtol 1e-5 and atol 1e-4
and uint8 results (rounded after the float resample) within 1, or 1/std
once normalized.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.vision as rvision
import paddle_tpu.vision.transforms as RT
import paddle_tpu.vision.transforms.functional as RF
import paddle_tpu_torch.vision as pvision
import paddle_tpu_torch.vision.transforms as PT
import paddle_tpu_torch.vision.transforms.functional as PF

RESAMPLED = dict(rtol=1e-5, atol=1e-4)


def _img(dtype="uint8", h=9, w=12, c=3, seed=0):
    rs = np.random.RandomState(seed)
    if dtype == "uint8":
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    return rs.rand(h, w, c).astype(np.float32)


def _pil(arr):
    from PIL import Image
    return Image.fromarray(arr)


def _same(got, want, tol=None):
    from PIL import Image
    if isinstance(want, Image.Image):
        assert isinstance(got, Image.Image) and got.mode == want.mode
        got, want = np.asarray(got), np.asarray(want)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if tol is None:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("shape,method", [
    ((5, 7, 3), "linear"), ((20, 30, 3), "linear"), ((5, 30, 3), "cubic"),
    ((13, 4, 3), "cubic"), ((5, 17, 3), "nearest"), ((9, 12, 1), "linear")])
def test_resize_array_is_jax_image_resize(shape, method):
    for img in (_img("float32"), _img("uint8")):
        want = jax.image.resize(jnp.asarray(img), shape, method)
        got = PF.resize_array(img, shape, method)
        _same(got, want, RESAMPLED)


# -- the functional ops -------------------------------------------------------
FUNCTIONAL = {
    "to_tensor": lambda F, x: F.to_tensor(x),
    "to_tensor_hwc": lambda F, x: F.to_tensor(x, data_format="HWC"),
    "resize_short": lambda F, x: F.resize(x, 6),
    "resize_pair": lambda F, x: F.resize(x, (14, 8)),
    "resize_nearest": lambda F, x: F.resize(x, (5, 16), "nearest"),
    "resize_bicubic": lambda F, x: F.resize(x, (7, 7), "bicubic"),
    "pad_const": lambda F, x: F.pad(x, 2, fill=3),
    "pad_pair_edge": lambda F, x: F.pad(x, (1, 2), padding_mode="edge"),
    "pad_four_reflect": lambda F, x: F.pad(x, (1, 2, 3, 0),
                                           padding_mode="reflect"),
    "pad_symmetric": lambda F, x: F.pad(x, 2, padding_mode="symmetric"),
    "crop": lambda F, x: F.crop(x, 1, 2, 5, 6),
    "center_crop": lambda F, x: F.center_crop(x, 5),
    "center_crop_pair": lambda F, x: F.center_crop(x, (4, 11)),
    "hflip": lambda F, x: F.hflip(x),
    "vflip": lambda F, x: F.vflip(x),
    "to_grayscale": lambda F, x: F.to_grayscale(x),
    "to_grayscale_3": lambda F, x: F.to_grayscale(x, 3),
    "adjust_brightness": lambda F, x: F.adjust_brightness(x, 1.4),
    "adjust_contrast": lambda F, x: F.adjust_contrast(x, 0.6),
    "adjust_saturation": lambda F, x: F.adjust_saturation(x, 1.7),
    "adjust_hue": lambda F, x: F.adjust_hue(x, 0.2),
    "adjust_hue_neg": lambda F, x: F.adjust_hue(x, -0.45),
}
NOT_PIL = {"to_tensor_hwc"}
RESAMPLING = {"resize_short", "resize_pair", "resize_nearest",
              "resize_bicubic"}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_matches_the_reference(name):
    fn = FUNCTIONAL[name]
    tol = RESAMPLED if name in RESAMPLING else None
    for dtype in ("uint8", "float32"):
        img = _img(dtype)
        _same(fn(PF, img), fn(RF, img), tol)
    if name not in NOT_PIL:
        img = _pil(_img("uint8"))
        _same(fn(PF, img), fn(RF, img), tol)


@pytest.mark.parametrize("kw", [dict(angle=30), dict(angle=90, expand=True),
                                dict(angle=-17, center=(3, 4), fill=7),
                                dict(angle=45, interpolation="bilinear",
                                     expand=True)])
def test_rotate(kw):
    for img in (_img("uint8"), _img("float32"), _pil(_img("uint8"))):
        _same(PF.rotate(img, **kw), RF.rotate(img, **kw))


@pytest.mark.parametrize("fmt", ["CHW", "HWC"])
def test_normalize(fmt):
    img = _img("float32")
    if fmt == "CHW":
        img = img.transpose(2, 0, 1)
    kw = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225],
              data_format=fmt)
    _same(PF.normalize(img, **kw), RF.normalize(img, **kw))
    _same(PT.Normalize(**kw)(img), RT.Normalize(**kw)(img))
    _same(PT.Normalize(0.5, 0.25, fmt)(img), RT.Normalize(0.5, 0.25, fmt)(img))


def test_adjust_hue_rejects_a_factor_out_of_range():
    with pytest.raises(ValueError, match="hue_factor"):
        PF.adjust_hue(_img(), 0.7)


# -- the transform classes ----------------------------------------------------
def _classes(M):
    return {
        "ToTensor": M.ToTensor(),
        "ToTensor_HWC": M.ToTensor("HWC"),
        "Resize_chw": M.Resize((5, 8)),
        "Resize_hwc": M.Resize(7),
        "CenterCrop": M.CenterCrop((4, 6)),
        "RandomCrop": M.RandomCrop(5),
        "RandomCrop_pad": M.RandomCrop((8, 8), padding=2),
        "RandomHorizontalFlip": M.RandomHorizontalFlip(0.5),
        "RandomVerticalFlip": M.RandomVerticalFlip(0.7),
        "Transpose": M.Transpose(),
        "BrightnessTransform": M.BrightnessTransform(0.4),
        "ContrastTransform": M.ContrastTransform(0.5),
        "SaturationTransform": M.SaturationTransform(0.5),
        "HueTransform": M.HueTransform(0.3),
        "ColorJitter": M.ColorJitter(0.3, 0.3, 0.3, 0.1),
        "Grayscale": M.Grayscale(3),
        "Pad": M.Pad((1, 2), fill=5),
        "RandomResizedCrop": M.RandomResizedCrop(6),
        "RandomResizedCrop_narrow": M.RandomResizedCrop(
            (4, 7), scale=(0.9, 1.0), ratio=(3.0, 4.0)),
        "RandomRotation": M.RandomRotation(25),
        "RandomRotation_range": M.RandomRotation((10, 50), expand=True),
        "Compose": M.Compose([M.RandomResizedCrop(8),
                              M.RandomHorizontalFlip(),
                              M.Normalize([0.5] * 3, [0.2] * 3, "HWC"),
                              M.Transpose()]),
    }


CHW_INPUT = {"Resize_chw", "CenterCrop", "RandomCrop", "RandomCrop_pad",
             "RandomHorizontalFlip", "RandomVerticalFlip"}
UINT8_RESAMPLED = {"RandomResizedCrop", "RandomResizedCrop_narrow"}


@pytest.mark.parametrize("name", sorted(_classes(RT)))
def test_transform_draws_and_returns_as_the_reference(name):
    port, ref = _classes(PT)[name], _classes(RT)[name]
    tol = RESAMPLED if name.startswith(("Resize", "RandomResizedCrop",
                                        "Compose")) else None
    for seed in range(3):
        for dtype in ("uint8", "float32"):
            img = _img(dtype, seed=seed)
            if name in CHW_INPUT:
                img = np.ascontiguousarray(img.transpose(2, 0, 1))
            random.seed(seed)
            want = ref(img)
            after = random.random()
            random.seed(seed)
            got = port(img)
            assert random.random() == after     # the same number of draws
            if name == "Compose" and dtype == "uint8":
                # a rounded pixel 1 apart, normalized by std 0.2
                tol = dict(rtol=1e-5, atol=1 / 0.2 + 1e-4)
            _same(got, want, tol)


def test_pil_images_through_the_random_transforms():
    img = _pil(_img("uint8", h=20, w=24))
    for name in ("RandomResizedCrop", "Grayscale", "Pad"):
        random.seed(4)
        want = _classes(RT)[name](img)
        random.seed(4)
        _same(_classes(PT)[name](img), want,
              RESAMPLED if name in UINT8_RESAMPLED else None)


def test_transforms_reject_bad_arguments():
    for cls, arg in (("ContrastTransform", -1), ("SaturationTransform", -1),
                     ("HueTransform", 0.6), ("RandomRotation", -3)):
        with pytest.raises(ValueError):
            getattr(PT, cls)(arg)


# -- the image backend and the surface ----------------------------------------
def test_image_backend(tmp_path):
    path = str(tmp_path / "a.png")
    _pil(_img("uint8")).save(path)
    assert pvision.get_image_backend() == rvision.get_image_backend() == "pil"
    np.testing.assert_array_equal(np.asarray(pvision.image_load(path)),
                                  np.asarray(rvision.image_load(path)))
    with pytest.raises(ValueError):
        pvision.set_image_backend("opencv")
    pvision.set_image_backend("cv2")
    try:
        assert pvision.get_image_backend() == "cv2"
    finally:
        pvision.set_image_backend("pil")


def test_every_public_name_is_ported():
    for ref_mod, port_mod in ((RT, PT), (RF, PF), (rvision, pvision)):
        public = {n for n in dir(ref_mod) if not n.startswith("_")
                  and not isinstance(getattr(ref_mod, n), type(np))}
        public -= {"annotations", "numbers", "random", "np", "datasets"}
        missing = [n for n in public if not hasattr(port_mod, n)]
        assert not missing, (ref_mod.__name__, missing)
