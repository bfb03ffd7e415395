"""Functional image ops (port of ``paddle_tpu/vision/transforms/
functional.py``).

Host-side preprocessing, run where the data is loaded: plain numpy, and
PIL passed through where it is installed (imported only when an image
is one). Accepts a PIL image or an ndarray; an ndarray is HWC (the
reference's cv2/ndarray convention). Each function returns what the
reference's returns; ``resize`` is ``jax.image.resize`` computed in
numpy (:func:`resize_array`): half-pixel centres, the triangle (linear)
or Keys cubic (a = -0.5) kernel widened by the downscale factor
(antialiasing), nearest by ``floor((o + 0.5) * in / out)``, in float32.
"""
from __future__ import annotations

import numbers

import numpy as np

__all__ = [
    "resize_array", "to_tensor", "resize", "pad", "crop", "center_crop",
    "hflip", "vflip",
    "normalize", "rotate", "to_grayscale", "adjust_brightness",
    "adjust_contrast", "adjust_saturation", "adjust_hue",
]


def _is_pil(img):
    try:
        from PIL import Image
        return isinstance(img, Image.Image)
    except ImportError:  # pragma: no cover
        return False


def _to_hwc(img):
    """A PIL image or an ndarray as an HWC ndarray (its dtype kept)."""
    if _is_pil(img):
        arr = np.asarray(img)
        return arr if arr.ndim == 3 else arr[..., None]
    arr = np.asarray(img)
    return arr if arr.ndim == 3 else arr[..., None]


def to_tensor(pic, data_format="CHW"):
    """PIL/HWC-ndarray → float32 tensor in [0,1], CHW by default."""
    arr = _to_hwc(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if data_format == "CHW":
        arr = np.transpose(arr, (2, 0, 1))
    return arr


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _weights(n_in, n_out, kernel):
    """(n_in, n_out) float32 weights of ``jax.image.resize`` along one
    axis: half-pixel centres, the kernel widened by the downscale factor,
    columns normalized, samples outside the input zero."""
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = np.maximum(inv, np.float32(1.0))
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kscale
    w = kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    ok = (f >= -0.5) & (f <= n_in - 0.5)
    return np.where(ok[None, :], w, np.float32(0)).astype(np.float32)


def resize_array(arr, shape, method="linear"):
    """``jax.image.resize(arr, shape, method)`` in numpy: ``linear``,
    ``cubic`` or ``nearest`` over every axis whose size changes; an
    integer array is resampled (and returned) as float32, except by
    ``nearest``, which gathers."""
    arr = np.asarray(arr)
    out = arr
    for ax, (i, o) in enumerate(zip(arr.shape, shape)):
        if i == o:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(o, dtype=np.float32) + np.float32(0.5))
                           * np.float32(i) / np.float32(o)).astype(np.int64)
            out = np.take(out, idx, axis=ax)
            continue
        if out.dtype.kind not in "fc":
            out = out.astype(np.float32)
        w = _weights(i, o, _keys_cubic if method == "cubic" else _triangle)
        out = np.moveaxis(np.tensordot(out, w.astype(out.dtype),
                                       axes=([ax], [0])), -1, ax)
    if method != "nearest" and out.dtype.kind not in "fc":
        out = out.astype(np.float32)
    return out


def resize(img, size, interpolation="bilinear"):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    h, w = arr.shape[:2]
    if isinstance(size, int):
        # shorter edge to `size`, keep aspect (reference semantics)
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    method = {"bilinear": "linear", "nearest": "nearest",
              "bicubic": "cubic"}.get(interpolation, "linear")
    out = resize_array(arr.astype(np.float32), (oh, ow, arr.shape[2]),
                       method)
    if arr.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(arr.dtype)
    return _restore(out, pil)


def _restore(arr, was_pil):
    if was_pil:
        from PIL import Image
        return Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    return arr


def pad(img, padding, fill=0, padding_mode="constant"):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(p) for p in padding)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(arr, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kw)
    return _restore(out, pil)


def crop(img, top, left, height, width):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    out = arr[top:top + height, left:left + width]
    return _restore(out, pil)


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _to_hwc(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    return crop(img, max((h - th) // 2, 0), max((w - tw) // 2, 0), th, tw)


def hflip(img):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    return _restore(arr[:, ::-1].copy(), pil)


def vflip(img):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    return _restore(arr[::-1].copy(), pil)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        return (arr - mean[:, None, None]) / std[:, None, None]
    return (arr - mean) / std


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by ``angle`` degrees. PIL path uses PIL;
    ndarray path is an inverse-affine nearest/bilinear resample in numpy."""
    if _is_pil(img):
        from PIL import Image
        resample = {"nearest": Image.NEAREST,
                    "bilinear": Image.BILINEAR}.get(interpolation,
                                                    Image.NEAREST)
        return img.rotate(angle, resample=resample, expand=expand,
                          center=center, fillcolor=fill)
    arr = _to_hwc(img)
    h, w = arr.shape[:2]
    theta = np.deg2rad(angle)
    cos, sin = np.cos(theta), np.sin(theta)
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    if expand:
        # round before ceil: cos(90 deg) is ~6e-17, not 0, and the stray
        # epsilon would inflate the expanded canvas by one pixel
        oh = int(np.ceil(np.round(abs(h * cos) + abs(w * sin), 7)))
        ow = int(np.ceil(np.round(abs(w * cos) + abs(h * sin), 7)))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    ys, xs = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    # inverse map: rotate output coords by -angle around the center
    sy = (ys - ocy) * cos - (xs - ocx) * sin + cy
    sx = (ys - ocy) * sin + (xs - ocx) * cos + cx
    syi = np.round(sy).astype(np.int64)
    sxi = np.round(sx).astype(np.int64)
    valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
    out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
    out[valid] = arr[syi[valid], sxi[valid]]
    return out


def to_grayscale(img, num_output_channels=1):
    pil = _is_pil(img)
    arr = _to_hwc(img).astype(np.float32)
    if arr.shape[-1] >= 3:
        gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2])
    else:
        gray = arr[..., 0]
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    if _to_hwc(img).dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return _restore(out, pil)


def _blend(a, b, factor):
    out = a.astype(np.float32) * (1.0 - factor) + \
        b.astype(np.float32) * factor
    return out


def adjust_brightness(img, brightness_factor):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    out = _blend(np.zeros_like(arr, dtype=np.float32), arr, brightness_factor)
    return _finish_color(out, arr.dtype, pil)


def adjust_contrast(img, contrast_factor):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    g = to_grayscale(arr, 1).astype(np.float32)
    mean = np.full_like(arr, g.mean(), dtype=np.float32)
    out = _blend(mean, arr, contrast_factor)
    return _finish_color(out, arr.dtype, pil)


def adjust_saturation(img, saturation_factor):
    pil = _is_pil(img)
    arr = _to_hwc(img)
    g = np.repeat(to_grayscale(arr, 1).astype(np.float32)[..., :1],
                  arr.shape[-1], axis=-1)
    out = _blend(g, arr, saturation_factor)
    return _finish_color(out, arr.dtype, pil)


def adjust_hue(img, hue_factor):
    """Shift hue by ``hue_factor`` (in [-0.5, 0.5] turns), RGB→HSV→RGB."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    pil = _is_pil(img)
    arr = _to_hwc(img)
    dtype = arr.dtype
    x = arr.astype(np.float32)
    if dtype == np.uint8:
        x = x / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = np.max(x[..., :3], axis=-1)
    minc = np.min(x[..., :3], axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    hr = np.where(maxc == r, ((g - b) / dz) % 6.0, 0.0)
    hg = np.where(maxc == g, (b - r) / dz + 2.0, 0.0)
    hb = np.where(maxc == b, (r - g) / dz + 4.0, 0.0)
    hue = np.where(delta > 0, np.where(maxc == r, hr,
                                       np.where(maxc == g, hg, hb)), 0.0) / 6.0
    hue = (hue + hue_factor) % 1.0
    i = np.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2] + [x[..., c] for c in range(3, x.shape[-1])],
                   axis=-1)
    if dtype == np.uint8:
        out = out * 255.0
    return _finish_color(out, dtype, pil)


def _finish_color(out, dtype, was_pil):
    if dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(dtype)
    return _restore(out, was_pil)
