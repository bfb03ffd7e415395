"""The vision functionals (port of ``paddle_tpu/nn/functional/vision.py``):
the pixel and channel shuffles, ``affine_grid`` and ``grid_sample``.

``grid_sample`` is the reference's: ``bilinear`` (four taps, each out of
range tap read as zero) or ``nearest`` (round half to even), padding
``zeros``, ``border`` or ``reflection``, and ``align_corners``; written
out with gathers, not ``torch.nn.functional.grid_sample``, so that every
mode rounds as the reference does.
"""
from __future__ import annotations

import torch

__all__ = ["pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "affine_grid", "grid_sample"]


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta (N, 2, 3) -> the (N, H, W, 2) grid of (x, y) sample
    coordinates in [-1, 1]."""
    out_shape = [int(v) for v in out_shape]
    h, w = (out_shape[2], out_shape[3]) if len(out_shape) == 4 else \
        (out_shape[1], out_shape[2])

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        return (torch.arange(size, device=theta.device) * 2 + 1) / size - 1.0

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nqk->nhwq", base.to(theta.dtype), theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x (N, C, H, W) sampled at grid (N, Hg, Wg, 2) in [-1, 1] ->
    (N, C, Hg, Wg)."""
    n, c, h, w = x.shape

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    gx = unnormalize(grid[..., 0], w)
    gy = unnormalize(grid[..., 1], h)
    if padding_mode == "border":
        gx = gx.clamp(0, w - 1)
        gy = gy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        def reflect(v, size):
            if align_corners:
                span = 2 * (size - 1)
                v = torch.remainder(v.abs(), span)
                return torch.where(v > size - 1, span - v, v)
            span = 2 * size
            v = torch.remainder((v + 0.5).abs(), span)
            v = torch.where(v > size, span - v, v) - 0.5
            return v.clamp(0, size - 1)
        gx = reflect(gx, w)
        gy = reflect(gy, h)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def tap(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return v * inb[..., None].to(x.dtype)              # (N, Hg, Wg, C)

    if mode == "nearest":
        out = tap(torch.round(gx).long(), torch.round(gy).long())
        return out.movedim(-1, 1)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    wx = (gx - x0).to(x.dtype)[..., None]
    wy = (gy - y0).to(x.dtype)[..., None]
    out = (tap(x0, y0) * ((1 - wx) * (1 - wy)) + tap(x0 + 1, y0) *
           (wx * (1 - wy)) + tap(x0, y0 + 1) * ((1 - wx) * wy) +
           tap(x0 + 1, y0 + 1) * (wx * wy))
    return out.movedim(-1, 1)
