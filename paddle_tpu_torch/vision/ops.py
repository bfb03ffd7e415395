"""paddle.vision.ops (port of ``paddle_tpu/vision/ops.py``): the YOLOv3 box
decode and loss, deformable convolution (v1/v2), image IO and the
detection suite (priors and anchors, box coding, IoU and matching, the
NMS family, RoI pooling, proposals).

Where each op runs:

- the dense and grid ops (``yolo_box``, ``yolo_loss``, ``deform_conv2d``,
  ``box_coder``, ``box_clip``, ``iou_similarity``, ``roi_align``,
  ``roi_pool``, ``psroi_pool``, ``polygon_box_transform``) are tensor ops
  on the input's device, differentiable wherever the reference is;
- the prior and anchor generators compute their grids with numpy on the
  host (they depend on shapes only, as the reference's do) and return
  tensors on the feature map's device;
- the selection ops (``nms``, ``multiclass_nms``, ``matrix_nms``,
  ``bipartite_match``, ``generate_proposals``) copy their inputs to the
  host and select there, in float64 as the reference does (a data-
  dependent output length, a sequential suppression loop); they accept
  card tensors and return on the input's device;
- ``read_file`` and ``decode_jpeg`` are host IO and return CPU tensors.

No op here has a kernel of its own: the reference computes each with XLA
ops (no Pallas kernel), and the port with PyTorch's (cuDNN and cuBLAS for
the convolution and matmul inside ``deform_conv2d`` on the card).

What the port does differently: ``yolo_box`` lays its boxes out as its
scores, a row per (anchor, y, x), where the reference transposes the
stacked (N, A, H, W, 4) boxes as if the 4 were its class axis and
returns them scrambled across rows (the values are the same, in other
places; ROADMAP "Oracle caveats"). ``roi_align`` gathers each sample from
the feature map by (image, y, x), where the reference first copies the
feature map of every RoI's image (``x[img_idx]``, R × C × H × W); the
values are the same. ``yolo_loss`` writes each target cell once: where
two boxes of an image fall on the same cell and anchor, the later box is
the one written, the order in which XLA's scatter applies them on the
CPU, and a deterministic one on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn import initializer as I
from ..nn.layer import Layer

__all__ = ["yolo_box", "yolo_loss", "deform_conv2d", "DeformConv2D",
           "read_file", "decode_jpeg", "prior_box", "density_prior_box",
           "anchor_generator", "box_coder", "box_clip", "iou_similarity",
           "bipartite_match", "nms", "multiclass_nms", "matrix_nms",
           "roi_align", "roi_pool", "psroi_pool", "polygon_box_transform",
           "generate_proposals"]


def _tensor(x, device=None, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _host(x, dtype=None):
    """A numpy copy of ``x`` (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x, dtype=dtype)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# YOLO box decode
# ---------------------------------------------------------------------------
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode a YOLOv3 head's output into boxes and scores (reference
    vision/ops.py:27).

    x: [N, A*(5+C), H, W]; img_size: [N, 2] (h, w). Returns boxes
    [N, A*H*W, 4] (x1, y1, x2, y2 in image scale) and scores
    [N, A*H*W, C], a row per (anchor, y, x) in both (module docstring);
    predictions with objectness < conf_thresh zeroed. Tensor ops on
    ``x``'s device."""
    n, c, h, w = x.shape
    an = len(anchors) // 2
    if c != an * (5 + class_num):
        raise ValueError(f"yolo_box: {c} channels for {an} anchors of "
                         f"{class_num} classes")
    dev = x.device
    anchors_wh = torch.as_tensor(anchors, dtype=torch.float32,
                                 device=dev).reshape(an, 2)
    img = _tensor(img_size, dev)
    pred = x.reshape(n, an, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=dev).reshape(
        1, 1, 1, w)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev).reshape(
        1, 1, h, 1)
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(pred[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(pred[:, :, 1]) * alpha + beta + grid_y) / h
    input_w = downsample_ratio * w
    input_h = downsample_ratio * h
    bw = torch.exp(pred[:, :, 2]) * anchors_wh[:, 0].reshape(
        1, an, 1, 1) / input_w
    bh = torch.exp(pred[:, :, 3]) * anchors_wh[:, 1].reshape(
        1, an, 1, 1) / input_h
    conf = torch.sigmoid(pred[:, :, 4])
    keep = (conf >= conf_thresh).to(x.dtype)
    conf = conf * keep
    scores = torch.sigmoid(pred[:, :, 5:]) * conf[:, :, None]
    img_h = img[:, 0].to(torch.float32).reshape(n, 1, 1, 1)
    img_w = img[:, 1].to(torch.float32).reshape(n, 1, 1, 1)
    x1 = (bx - bw / 2) * img_w
    y1 = (by - bh / 2) * img_h
    x2 = (bx + bw / 2) * img_w
    y2 = (by + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    boxes = boxes.reshape(n, an * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, an * h * w,
                                                   class_num)
    return boxes, scores


# ---------------------------------------------------------------------------
# YOLOv3 loss
# ---------------------------------------------------------------------------
def _box_iou_xywh(b1, b2):
    """IoU of centre-format boxes; b1 [..., 4], b2 [..., 4] broadcastable."""
    b1x1, b1x2 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
    b1y1, b1y2 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
    b2x1, b2x2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    b2y1, b2y2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    ix = torch.clamp(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1),
                     min=0.0)
    iy = torch.clamp(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1),
                     min=0.0)
    inter = ix * iy
    a1 = torch.clamp(b1x2 - b1x1, min=0.0) * torch.clamp(b1y2 - b1y1,
                                                         min=0.0)
    a2 = torch.clamp(b2x2 - b2x1, min=0.0) * torch.clamp(b2y2 - b2y1,
                                                         min=0.0)
    return inter / torch.clamp(a1 + a2 - inter, min=1e-10)


def _bce(logit, target):
    return torch.clamp(logit, min=0) - logit * target + torch.log1p(
        torch.exp(-logit.abs()))


def _last_writer(key):
    """(N, B) bool: box b is the last of its image to carry its ``key``
    (XLA's scatter on the CPU applies the updates in order, so the last
    one of a cell is what stays)."""
    b = key.shape[1]
    same = key[:, :, None] == key[:, None, :]               # (N, B, B')
    later = torch.ones(b, b, dtype=torch.bool,
                       device=key.device).triu(diagonal=1)
    return ~(same & later).any(dim=-1)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (reference vision/ops.py:101).

    x: [N, A*(5+C), H, W]; gt_box: [N, B, 4] (cx, cy, w, h normalized);
    gt_label: [N, B] int; returns the per-sample loss [N]. Tensor ops on
    ``x``'s device, differentiable in ``x``.

    Each gt picks its best anchor of the full set by width/height IoU; if
    that anchor is in ``anchor_mask`` the gt is assigned to its grid
    cell. Objectness negatives whose best IoU with a gt exceeds
    ``ignore_thresh`` are left out, as in the reference. Targets are
    written by index, each cell once (module docstring)."""
    dev = x.device
    gt_box = _tensor(gt_box, dev, torch.float32)
    gt_label = _tensor(gt_label, dev, torch.long)
    n, c, h, w = x.shape
    an = len(anchor_mask)
    if c != an * (5 + class_num):
        raise ValueError(f"yolo_loss: {c} channels for {an} anchors of "
                         f"{class_num} classes")
    b = gt_box.shape[1]
    all_anchors = torch.as_tensor(anchors, dtype=torch.float32,
                                  device=dev).reshape(-1, 2)
    mask_idx = torch.as_tensor(anchor_mask, dtype=torch.long, device=dev)
    input_size = downsample_ratio * h
    pred = x.reshape(n, an, 5 + class_num, h, w)
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)

    valid = (gt_box[..., 2] > 0).to(torch.float32)             # [N, B]
    if gt_score is None:
        gt_score = valid
    else:
        gt_score = _tensor(gt_score, dev, torch.float32) * valid

    # best anchor per gt over the FULL anchor set by wh-IoU at the origin
    gwh = gt_box[..., 2:4] * input_size                        # [N, B, 2]
    inter = (torch.minimum(gwh[:, :, None, 0], all_anchors[None, None, :, 0])
             * torch.minimum(gwh[:, :, None, 1],
                             all_anchors[None, None, :, 1]))
    union = (gwh[..., 0:1] * gwh[..., 1:2]
             + all_anchors[None, None, :, 0] * all_anchors[None, None, :, 1]
             - inter)
    an_iou = inter / torch.clamp(union, min=1e-10)
    best = torch.argmax(an_iou, dim=-1)                        # [N, B]
    in_mask = best[..., None] == mask_idx[None, None, :]       # [N, B, an]
    has_mask = in_mask.any(-1)
    mask_pos = torch.argmax(in_mask.to(torch.int8), dim=-1)    # [N, B]
    assigned = valid * has_mask.to(torch.float32)
    gi = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1).long()

    # every (n, b) names a cell; the last box of an image on a cell writes
    # it (module docstring); the max-targets need no such rule
    cell = (mask_pos * h + gj) * w + gi                        # [N, B]
    flat = cell + torch.arange(n, device=dev)[:, None] * (an * h * w)
    win = _last_writer(cell)
    wf = flat[win]

    def set_(values):
        out = torch.zeros(n * an * h * w, dtype=torch.float32, device=dev)
        out[wf] = values[win]
        return out.reshape(n, an, h, w)

    def max_(values):
        out = torch.zeros(n * an * h * w, dtype=torch.float32, device=dev)
        out = out.scatter_reduce(0, flat.reshape(-1), values.reshape(-1),
                                 "amax")
        return out.reshape(n, an, h, w)

    on = assigned > 0
    wgt = assigned * gt_score
    tobj = max_(assigned)
    obj_weight = max_(wgt)
    tx = set_(torch.where(on, gt_box[..., 0] * w - gi, 0.0))
    ty = set_(torch.where(on, gt_box[..., 1] * h - gj, 0.0))
    anchor_wh = all_anchors[mask_idx]                          # [an, 2]
    tw = set_(torch.where(on, torch.log(torch.clamp(gwh[..., 0], min=1e-9)
                                        / anchor_wh[mask_pos][..., 0]), 0.0))
    th = set_(torch.where(on, torch.log(torch.clamp(gwh[..., 1], min=1e-9)
                                        / anchor_wh[mask_pos][..., 1]), 0.0))
    # loss weight 2 - gw*gh (normalized): more weight on small boxes
    box_w = set_(torch.where(on, 2.0 - gt_box[..., 2] * gt_box[..., 3],
                             0.0)) * obj_weight

    smooth = 1.0 / max(class_num, 1) if (use_label_smooth
                                         and class_num > 1) else 0.0
    onehot = torch.nn.functional.one_hot(gt_label, class_num).to(
        torch.float32)
    if smooth:
        onehot = onehot * (1.0 - smooth) + smooth * (1.0 / class_num)
    tcls = torch.zeros((n * an * h * w, class_num), dtype=torch.float32,
                       device=dev)
    tcls[wf] = (onehot * assigned[..., None])[win]
    tcls = tcls.reshape(n, an, h, w, class_num)

    # the predicted boxes, for the ignore mask
    grid_x = torch.arange(w, dtype=torch.float32, device=dev).reshape(
        1, 1, 1, w)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev).reshape(
        1, 1, h, 1)
    px = (torch.sigmoid(pred[:, :, 0]) * alpha + beta + grid_x) / w
    py = (torch.sigmoid(pred[:, :, 1]) * alpha + beta + grid_y) / h
    pw = torch.exp(torch.clamp(pred[:, :, 2], -10, 10)) \
        * anchor_wh[None, :, 0, None, None] / input_size
    ph = torch.exp(torch.clamp(pred[:, :, 3], -10, 10)) \
        * anchor_wh[None, :, 1, None, None] / input_size
    pbox = torch.stack([px, py, pw, ph], -1)                   # [N,an,h,w,4]
    iou = _box_iou_xywh(pbox[:, :, :, :, None, :],
                        gt_box[:, None, None, None, :, :])     # [N,an,h,w,B]
    best_iou = (iou * valid[:, None, None, None, :]).amax(dim=-1)
    ignore = (best_iou > ignore_thresh).to(torch.float32) * (1.0 - tobj)

    loss_xy = box_w * (_bce(pred[:, :, 0], tx) + _bce(pred[:, :, 1], ty))
    loss_wh = box_w * ((pred[:, :, 2] - tw).abs()
                       + (pred[:, :, 3] - th).abs())
    loss_obj = obj_weight * _bce(pred[:, :, 4], tobj) \
        + (1.0 - tobj) * (1.0 - ignore) * _bce(pred[:, :, 4], tobj)
    loss_cls = obj_weight[..., None] * _bce(
        pred[:, :, 5:].permute(0, 1, 3, 4, 2), tcls)
    return (loss_xy.sum((1, 2, 3)) + loss_wh.sum((1, 2, 3))
            + loss_obj.sum((1, 2, 3)) + loss_cls.sum((1, 2, 3, 4)))


# ---------------------------------------------------------------------------
# Deformable convolution (v1/v2)
# ---------------------------------------------------------------------------
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution (reference vision/ops.py:219); ``mask``
    None is v1, else v2 (DCNv2's modulation).

    x: [N, Cin, H, W]; offset: [N, 2*dg*kh*kw, Ho, Wo] (y, x per kernel
    point); mask: [N, dg*kh*kw, Ho, Wo]; weight: [Cout, Cin/groups, kh,
    kw]. The kh*kw bilinear samples of each output pixel are gathered
    from the zero-padded input (a sample outside it reads 0), weighted by
    the mask, then one grouped matmul with the weight, accumulated in
    float32 and cast to ``x``'s dtype. Tensor ops on ``x``'s device,
    differentiable in ``x``, ``offset``, ``mask``, ``weight`` and
    ``bias``."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    ho, wo = offset.shape[2], offset.shape[3]
    dg = deformable_groups
    k = kh * kw
    if offset.shape[1] != 2 * dg * k:
        raise ValueError(f"deform_conv2d: offset has {offset.shape[1]} "
                         f"channels, {2 * dg * k} wanted (2 * "
                         f"deformable_groups * kh * kw)")
    if mask is not None and mask.shape[1] != dg * k:
        raise ValueError(f"deform_conv2d: mask has {mask.shape[1]} "
                         f"channels, {dg * k} wanted")
    dev = x.device
    xp = torch.nn.functional.pad(x, (padding[1], padding[1], padding[0],
                                     padding[0]))
    hp, wp = xp.shape[2], xp.shape[3]

    # the base sampling positions p0 + pk, per output pixel and kernel point
    f32 = dict(dtype=torch.float32, device=dev)
    base_y = (torch.arange(ho, **f32) * stride[0])[:, None] + \
        (torch.arange(kh, **f32) * dilation[0])[None, :]          # [ho, kh]
    base_x = (torch.arange(wo, **f32) * stride[1])[:, None] + \
        (torch.arange(kw, **f32) * dilation[1])[None, :]          # [wo, kw]
    ky = torch.arange(kh, device=dev).repeat_interleave(kw)
    kx = torch.arange(kw, device=dev).repeat(kh)
    off = offset.reshape(n, dg, k, 2, ho, wo)
    sy = base_y[:, ky].T[None, None, :, :, None] + off[:, :, :, 0]
    sx = base_x[:, kx].T[None, None, :, None, :] + off[:, :, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    cg = cin // dg
    flat = xp.reshape(n, dg, cg, hp * wp)

    def gather(iy, ix):
        # [N, dg, k, ho, wo] coordinates -> [N, dg, cg, k, ho, wo] samples,
        # the channels of a deformable group sharing its coordinates
        inb = ((iy >= 0) & (iy <= hp - 1) & (ix >= 0)
               & (ix <= wp - 1)).to(x.dtype)
        idx = (iy.clamp(0, hp - 1) * wp + ix.clamp(0, wp - 1)).long()
        took = flat.gather(-1, idx.reshape(n, dg, 1, k * ho * wo).expand(
            n, dg, cg, k * ho * wo))
        return took.reshape(n, dg, cg, k, ho, wo) * inb[:, :, None]

    val = (gather(y0, x0) * (wy0 * wx0)[:, :, None]
           + gather(y0, x0 + 1) * (wy0 * wx1)[:, :, None]
           + gather(y0 + 1, x0) * (wy1 * wx0)[:, :, None]
           + gather(y0 + 1, x0 + 1) * (wy1 * wx1)[:, :, None])
    if mask is not None:
        val = val * mask.reshape(n, dg, 1, k, ho, wo)
    # grouped contraction over (cin_g, k): [G, cog, cin_g*k] @
    # [N, G, cin_g*k, ho*wo]
    cog = cout // groups
    vg = val.reshape(n, groups, cin_g * k, ho * wo)
    wg = weight.reshape(groups, cog, cin_g * k)
    if x.dtype == torch.float32:
        out = torch.matmul(wg.float(), vg.float())
    else:
        out = torch.matmul(wg.to(x.dtype), vg)
    out = out.reshape(n, cout, ho, wo).to(x.dtype)
    if bias is not None:
        out = out + bias.reshape(1, cout, 1, 1)
    return out


class DeformConv2D(Layer):
    """reference vision/ops.py:309 DeformConv2D (v1 when called without
    a mask, v2 with one)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        fan_in = in_channels * ks[0] * ks[1] // groups
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, ks[0], ks[1]),
            attr=weight_attr, initializer=I.Uniform(-bound, bound))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (out_channels,), attr=bias_attr, is_bias=True,
                initializer=I.Uniform(-bound, bound))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            deformable_groups=self._deformable_groups, groups=self._groups,
            mask=mask)


# ---------------------------------------------------------------------------
# Image IO (host)
# ---------------------------------------------------------------------------
def read_file(filename, name=None):
    """A file's raw bytes as a uint8 CPU tensor (reference
    vision/ops.py:349)."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to a CHW uint8 CPU tensor (reference
    vision/ops.py:356; PIL on the host, imported here)."""
    import io as _io

    from PIL import Image

    img = Image.open(_io.BytesIO(_host(x).tobytes()))
    if mode.lower() == "gray":
        img = img.convert("L")
    elif mode.lower() == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


# ---------------------------------------------------------------------------
# Priors and anchors: shape-only grids, made on the host
# ---------------------------------------------------------------------------
def _expand_aspect_ratios(aspect_ratios, flip):
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _grid_out(boxes, var, device):
    return (torch.as_tensor(np.asarray(boxes, np.float32), device=device),
            torch.as_tensor(np.ascontiguousarray(var, np.float32),
                            device=device))


def prior_box(input, image, min_sizes, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), max_sizes=None, flip=False,
              clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes per feature-map cell (reference vision/ops.py:396).
    Returns (boxes, variances), each (feat_h, feat_w, num_priors, 4),
    boxes normalized to [0, 1] image coordinates, on ``input``'s
    device (the grid is made on the host)."""
    feat_h, feat_w = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = steps[0] or img_w / feat_w
    step_h = steps[1] or img_h / feat_h
    ars = _expand_aspect_ratios(aspect_ratios, flip)
    max_sizes = list(max_sizes or [])
    cx = (np.arange(feat_w) + offset) * step_w
    cy = (np.arange(feat_h) + offset) * step_h
    cx, cy = np.meshgrid(cx, cy)
    halves = []  # (half_w, half_h) per prior, in the reference's order
    for s, mn in enumerate(np.asarray(min_sizes, dtype="f8")):
        if min_max_aspect_ratios_order:
            halves.append((mn / 2.0, mn / 2.0))
            if max_sizes:
                m = np.sqrt(mn * max_sizes[s]) / 2.0
                halves.append((m, m))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                halves.append((mn * np.sqrt(ar) / 2.0,
                               mn / np.sqrt(ar) / 2.0))
        else:
            for ar in ars:
                halves.append((mn * np.sqrt(ar) / 2.0,
                               mn / np.sqrt(ar) / 2.0))
            if max_sizes:
                m = np.sqrt(mn * max_sizes[s]) / 2.0
                halves.append((m, m))
    hw = np.asarray([p[0] for p in halves])
    hh = np.asarray([p[1] for p in halves])
    boxes = np.stack([
        (cx[..., None] - hw) / img_w, (cy[..., None] - hh) / img_h,
        (cx[..., None] + hw) / img_w, (cy[..., None] + hh) / img_h,
    ], axis=-1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, dtype="f4"), boxes.shape)
    return _grid_out(boxes, var, input.device)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    """Density prior boxes (reference vision/ops.py:445): each (density,
    fixed_size) pair tiles density² shifted centres. On ``input``'s
    device (the grid is made on the host)."""
    feat_h, feat_w = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = steps[0] or img_w / feat_w
    step_h = steps[1] or img_h / feat_h
    cx = (np.arange(feat_w) + offset) * step_w
    cy = (np.arange(feat_h) + offset) * step_h
    cx, cy = np.meshgrid(cx, cy)
    all_boxes = []
    for density, fs in zip(densities, fixed_sizes):
        for ratio in fixed_ratios:
            bw = fs * np.sqrt(ratio)
            bh = fs / np.sqrt(ratio)
            shift_w = step_w / density
            shift_h = step_h / density
            for di in range(density):
                for dj in range(density):
                    c_x = cx - step_w / 2.0 + shift_w / 2.0 + dj * shift_w
                    c_y = cy - step_h / 2.0 + shift_h / 2.0 + di * shift_h
                    all_boxes.append(np.stack([
                        (c_x - bw / 2.0) / img_w, (c_y - bh / 2.0) / img_h,
                        (c_x + bw / 2.0) / img_w, (c_y + bh / 2.0) / img_h,
                    ], axis=-1))
    boxes = np.stack(all_boxes, axis=2)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, dtype="f4"), boxes.shape)
    if flatten_to_2d:
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return _grid_out(boxes, var, input.device)


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """RPN anchors in absolute pixel coordinates (reference
    vision/ops.py:484), (feat_h, feat_w, A, 4), on ``input``'s device
    (the grid is made on the host)."""
    feat_h, feat_w = input.shape[2], input.shape[3]
    sw, sh = stride
    cx = (np.arange(feat_w) * sw) + offset * sw
    cy = (np.arange(feat_h) * sh) + offset * sh
    cx, cy = np.meshgrid(cx, cy)
    hws, hhs = [], []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            base_w = np.round(np.sqrt(sw * sh / ar))
            base_h = np.round(base_w * ar)
            hws.append(0.5 * (size / sw * base_w - 1))
            hhs.append(0.5 * (size / sh * base_h - 1))
    hw, hh = np.asarray(hws), np.asarray(hhs)
    anchors = np.stack([cx[..., None] - hw, cy[..., None] - hh,
                        cx[..., None] + hw, cy[..., None] + hh], axis=-1)
    var = np.broadcast_to(np.asarray(variances, dtype="f4"), anchors.shape)
    return _grid_out(anchors, var, input.device)


# ---------------------------------------------------------------------------
# Box coding and IoU (tensor ops)
# ---------------------------------------------------------------------------
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode or decode boxes against priors (reference vision/ops.py:513).
    prior_box (M, 4); prior_box_var: None, an (M, 4) tensor or a list of
    4. Encode: target (N, 4) -> (N, M, 4); decode: target (N, M, 4) ->
    the same shape. Tensor ops on ``target_box``'s device,
    differentiable."""
    dev = _device_of(target_box, prior_box)
    pb = _tensor(prior_box, dev, torch.float32)
    norm = 1.0 if box_normalized else 0.0
    pw = pb[:, 2] - pb[:, 0] + (1.0 - norm)
    ph = pb[:, 3] - pb[:, 1] + (1.0 - norm)
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    var = None
    if prior_box_var is not None:
        var = _tensor(prior_box_var, dev, torch.float32)
    t = _tensor(target_box, dev, torch.float32)
    if code_type == "encode_center_size":
        tw = t[:, 2] - t[:, 0] + (1.0 - norm)
        th = t[:, 3] - t[:, 1] + (1.0 - norm)
        tcx = (t[:, 0] + t[:, 2]) / 2
        tcy = (t[:, 1] + t[:, 3]) / 2
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if var is not None:
            out = out / (var[None, :, :] if var.dim() == 2
                         else var.reshape(1, 1, 4))
        return out
    if code_type != "decode_center_size":
        raise ValueError(f"unknown code_type {code_type!r}")
    # decode: t is (N, M, 4); the priors broadcast along ``axis``
    if var is not None and var.dim() == 2:
        var = var[None, :, :] if axis == 0 else var[:, None, :]
    elif var is not None:
        var = var.reshape(1, 1, 4)
    if axis == 0:
        bpw, bph, bpcx, bpcy = (pw[None, :], ph[None, :],
                                pcx[None, :], pcy[None, :])
    else:
        bpw, bph, bpcx, bpcy = (pw[:, None], ph[:, None],
                                pcx[:, None], pcy[:, None])
    tv = t * var if var is not None else t
    w = torch.exp(tv[..., 2]) * bpw
    h = torch.exp(tv[..., 3]) * bph
    cx = tv[..., 0] * bpw + bpcx
    cy = tv[..., 1] * bph + bpcy
    return torch.stack([cx - w / 2, cy - h / 2,
                        cx + w / 2 - (1.0 - norm),
                        cy + h / 2 - (1.0 - norm)], dim=-1)


def box_clip(input, im_info, name=None):
    """Clip boxes to the image (reference vision/ops.py:569; im_info =
    [h, w, scale]). im_info (N, 3) clips input (N, ..., 4) per image; a
    single [h, w, scale] clips all. Tensor ops on ``input``'s device."""
    dev = _device_of(input)
    b = _tensor(input, dev, torch.float32)
    info = _tensor(im_info, dev, torch.float32)
    if info.dim() > 1:  # per-image bounds broadcast over the box dims
        info = info.reshape((info.shape[0],) + (1,) * (b.dim() - 2) + (3,))
    h = info[..., 0] / info[..., 2] - 1.0
    w = info[..., 1] / info[..., 2] - 1.0
    zero = torch.zeros((), device=dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)
    return torch.stack([clip(b[..., 0], w), clip(b[..., 1], h),
                        clip(b[..., 2], w), clip(b[..., 3], h)], dim=-1)


def _pairwise_iou(x, y, normalized=True):
    eps = 0.0 if normalized else 1.0
    area_x = (x[:, 2] - x[:, 0] + eps) * (x[:, 3] - x[:, 1] + eps)
    area_y = (y[:, 2] - y[:, 0] + eps) * (y[:, 3] - y[:, 1] + eps)
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt + eps, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[:, None] + area_y[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _pairwise_iou_np(x, normalized=True):
    """Self-IoU on the host, float64 (the suppression loops' input)."""
    eps = 0.0 if normalized else 1.0
    area = (x[:, 2] - x[:, 0] + eps) * (x[:, 3] - x[:, 1] + eps)
    lt = np.maximum(x[:, None, :2], x[None, :, :2])
    rb = np.minimum(x[:, None, 2:], x[None, :, 2:])
    wh = np.maximum(rb - lt + eps, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU, (N, 4) x (M, 4) -> (N, M) (reference
    vision/ops.py:611). Tensor ops on ``x``'s device."""
    dev = _device_of(x, y)
    return _pairwise_iou(_tensor(x, dev, torch.float32),
                         _tensor(y, dev, torch.float32), box_normalized)


# ---------------------------------------------------------------------------
# Matching and the NMS family: selection on the host
# ---------------------------------------------------------------------------
def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (reference vision/ops.py:618): take the
    largest entry left, retire its row and column, again. Returns
    (match_indices (M,) int64, match_dist (M,) float32) over the
    columns, on the input's device; the matching runs on the host in
    float64, as the reference's."""
    dev = _device_of(dist_matrix)
    d = _host(dist_matrix, np.float64).copy()
    n, m = d.shape
    match_idx = np.full((m,), -1, dtype=np.int64)
    match_dist = np.zeros((m,), dtype=np.float32)
    live = d.copy()
    for _ in range(min(n, m)):
        i, j = np.unravel_index(np.argmax(live), live.shape)
        if live[i, j] <= 0:
            break
        match_idx[j] = i
        match_dist[j] = d[i, j]
        live[i, :] = -1.0
        live[:, j] = -1.0
    if match_type == "per_prediction":
        thr = dist_threshold if dist_threshold is not None else 0.5
        for j in range(m):
            if match_idx[j] == -1:
                i = int(np.argmax(d[:, j]))
                if d[i, j] >= thr:
                    match_idx[j] = i
                    match_dist[j] = d[i, j]
    return (torch.as_tensor(match_idx, device=dev),
            torch.as_tensor(match_dist, device=dev))


def _nms_np(b, s, iou_threshold, normalized, nms_eta, limit=None):
    """Hard NMS on the host (float64): kept indices, by score, at most
    ``limit``. Each kept box's row of the self-IoU is computed when it is
    kept (the reference forms the whole matrix first: the same values,
    n² of them for the few rows a greedy pass reads)."""
    eps = 0.0 if normalized else 1.0
    area = (b[:, 2] - b[:, 0] + eps) * (b[:, 3] - b[:, 1] + eps)
    order = np.argsort(-s)
    keep = []
    suppressed = np.zeros(b.shape[0], dtype=bool)
    thr = float(iou_threshold)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if limit is not None and len(keep) >= limit:
            break
        lt = np.maximum(b[i, :2], b[:, :2])
        rb = np.minimum(b[i, 2:], b[:, 2:])
        wh = np.maximum(rb - lt + eps, 0.0)
        inter = wh[:, 0] * wh[:, 1]
        union = area[i] + area - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            suppressed |= np.where(union > 0, inter / union, 0.0) > thr
        suppressed[i] = True
        if nms_eta < 1.0 and thr > 0.5:
            thr *= nms_eta
    return np.asarray(keep, dtype=np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, normalized=True, nms_eta=1.0,
        name=None):
    """Hard NMS: the kept indices (int64), by score (reference
    vision/ops.py:649). ``normalized=False`` takes pixel IoU (+1
    extents); ``nms_eta < 1`` shrinks the threshold after each kept box
    (NMSFast). The boxes and scores are copied to the host and selected
    there in float64, as the reference does; the indices come back on
    ``boxes``' device."""
    dev = _device_of(boxes)
    b = _host(boxes, np.float64)
    n = b.shape[0]
    s = (_host(scores, np.float64) if scores is not None
         else np.arange(n, 0, -1, dtype=np.float64))
    if category_idxs is not None:
        # per-category NMS: offset the boxes so categories never overlap
        cat = _host(category_idxs).astype(np.float64)
        b = b + ((b.max() + 1.0) * cat)[:, None]
    return torch.as_tensor(_nms_np(b, s, iou_threshold, normalized, nms_eta,
                                   top_k), device=dev)


def _per_class(bboxes, scores, score_threshold, nms_top_k, background_label,
               select):
    """Per image, per class above the threshold (its ``nms_top_k`` best),
    the rows ``select`` keeps -> list of (label, score, box) rows."""
    outs = []
    for n in range(bboxes.shape[0]):
        dets = []
        for c in range(scores.shape[1]):
            if c == background_label:
                continue
            s = scores[n, c]
            idx = np.nonzero(s > score_threshold)[0]
            if not idx.size:
                continue
            idx = idx[np.argsort(-s[idx])][:nms_top_k]
            for i, sc in select(bboxes[n, idx], s[idx], idx):
                dets.append([c, sc, *bboxes[n, i]])
        outs.append(dets)
    return outs


def _dets_out(outs, keep_top_k, device):
    res = []
    for dets in outs:
        if dets:
            dets = np.asarray(dets, dtype=np.float32)
            dets = dets[np.argsort(-dets[:, 1])][:keep_top_k]
        else:
            dets = np.zeros((0, 6), dtype=np.float32)
        res.append(torch.as_tensor(dets, device=device))
    return res


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """Per-class NMS, then the top ``keep_top_k`` over the classes
    (reference vision/ops.py:685). bboxes (N, M, 4), scores (N, C, M).
    Returns a list, per image, of (label, score, x1, y1, x2, y2) rows
    (float32) on ``bboxes``' device; the selection runs on the host."""
    dev = _device_of(bboxes)
    b, s = _host(bboxes), _host(scores)

    def select(boxes, sc, idx):
        keep = _nms_np(boxes.astype(np.float64), sc.astype(np.float64),
                       nms_threshold, normalized, nms_eta)
        return [(i, s_) for i, s_ in zip(idx[keep], sc[keep])]
    return _dets_out(_per_class(b, s, score_threshold, nms_top_k,
                                background_label, select), keep_top_k, dev)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               name=None):
    """Matrix NMS (reference vision/ops.py:720): each box's score decayed
    by its overlaps with the higher-scored boxes, all at once (no
    sequential loop). Per image, on the host in numpy (the selection is
    data-dependent); rows as :func:`multiclass_nms`, on ``bboxes``'
    device."""
    dev = _device_of(bboxes)
    b, s = _host(bboxes), _host(scores)

    def select(boxes, ss, idx):
        iou = np.triu(_pairwise_iou_np(boxes.astype(np.float64),
                                       normalized), k=1)
        # comp[i]: box i's largest IoU with a higher-scored box; box j's
        # decay is the least over i < j of f(iou_ij) / f(comp_i)
        comp = iou.max(axis=0)
        k = iou.shape[0]
        excl = np.tril(np.ones((k, k), dtype=bool))
        if use_gaussian:
            ratio = np.exp((comp[:, None] ** 2 - iou ** 2) * gaussian_sigma)
        else:
            ratio = (1.0 - iou) / np.maximum(1.0 - comp[:, None], 1e-10)
        decayed = ss * np.where(excl, 1.0, ratio).min(axis=0)
        keep = decayed > post_threshold
        return list(zip(idx[keep], decayed[keep]))
    return _dets_out(_per_class(b, s, score_threshold, nms_top_k,
                                background_label, select), keep_top_k, dev)


# ---------------------------------------------------------------------------
# RoI pooling (tensor ops)
# ---------------------------------------------------------------------------
def _roi_images(boxes_num, n_rois, device):
    counts = torch.as_tensor(_host(boxes_num, np.int64), device=device)
    img = torch.repeat_interleave(torch.arange(counts.shape[0],
                                               device=device), counts)
    if img.shape[0] != n_rois:
        raise ValueError(f"boxes_num sums to {img.shape[0]}, there are "
                         f"{n_rois} boxes")
    return img


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoI Align (reference vision/ops.py:794): ``sampling_ratio`` ×
    ``sampling_ratio`` bilinear samples a bin on a regular grid (2 where
    it is <= 0, as the reference), averaged; (R, C, ph, pw). Tensor ops
    on ``x``'s device, differentiable in ``x``; each sample is gathered
    from ``x`` by (image, y, x) (module docstring)."""
    ph, pw = _pair(output_size)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    dev = x.device
    n, c, H, W = x.shape
    boxes = _tensor(boxes, dev, torch.float32)
    r = boxes.shape[0]
    img = _roi_images(boxes_num, r, dev)
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    rw = boxes[:, 2] * spatial_scale - off - x1
    rh = boxes[:, 3] * spatial_scale - off - y1
    if not aligned:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_h, bin_w = rh / ph, rw / pw
    f32 = dict(dtype=torch.float32, device=dev)
    iy = (torch.arange(sr, **f32) + 0.5) / sr
    ys = y1[:, None, None] + (torch.arange(ph, **f32)[None, :, None]
                              + iy[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (torch.arange(pw, **f32)[None, :, None]
                              + iy[None, None, :]) * bin_w[:, None, None]
    # (R, ph, pw, sr, sr) sample coordinates
    yy = ys[:, :, None, :, None].expand(r, ph, pw, sr, sr)
    xx = xs[:, None, :, None, :].expand(r, ph, pw, sr, sr)
    y0 = torch.clamp(torch.floor(yy), 0, H - 1)
    x0 = torch.clamp(torch.floor(xx), 0, W - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1).long()
    x1i = torch.clamp(x0 + 1, 0, W - 1).long()
    ly = torch.clamp(yy - y0, 0.0, 1.0)[..., None]
    lx = torch.clamp(xx - x0, 0.0, 1.0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    nhwc = x.permute(0, 2, 3, 1)
    ii = img[:, None, None, None, None]
    val = (nhwc[ii, y0i, x0i] * (1 - ly) * (1 - lx)
           + nhwc[ii, y0i, x1i] * (1 - ly) * lx
           + nhwc[ii, y1i, x0i] * ly * (1 - lx)
           + nhwc[ii, y1i, x1i] * ly * lx)                # (R,ph,pw,sr,sr,C)
    return val.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def _bins(start, size, n_bins, limit, device):
    """(R, n_bins, limit) bool: position p lies in bin i's integer span
    [floor(start + i*size/n), ceil(start + (i+1)*size/n)), clipped."""
    step = size / n_bins
    i = torch.arange(n_bins, dtype=torch.float32, device=device)
    lo = torch.clamp(torch.floor(start[:, None] + i[None, :]
                                 * step[:, None]), 0, limit)
    hi = torch.clamp(torch.ceil(start[:, None] + (i[None, :] + 1)
                                * step[:, None]), 0, limit)
    pos = torch.arange(limit, dtype=torch.float32, device=device)
    return (pos[None, None, :] >= lo[..., None]) & \
        (pos[None, None, :] < hi[..., None])


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoI max pooling (reference vision/ops.py:838): exact integer bins, a
    separable masked max (over w, then over h); an empty bin is 0.
    (R, C, ph, pw); tensor ops on ``x``'s device, differentiable through
    the max."""
    ph, pw = _pair(output_size)
    dev = x.device
    H, W = x.shape[2], x.shape[3]
    boxes = _tensor(boxes, dev, torch.float32)
    img = _roi_images(boxes_num, boxes.shape[0], dev)
    x1 = torch.round(boxes[:, 0] * spatial_scale)
    y1 = torch.round(boxes[:, 1] * spatial_scale)
    x2 = torch.round(boxes[:, 2] * spatial_scale)
    y2 = torch.round(boxes[:, 3] * spatial_scale)
    rowm = _bins(y1, torch.clamp(y2 - y1 + 1, min=1.0), ph, H, dev)
    colm = _bins(x1, torch.clamp(x2 - x1 + 1, min=1.0), pw, W, dev)
    feats = x[img]                                     # (R, C, H, W)
    neg = torch.finfo(x.dtype).min
    t = torch.where(colm[:, None, None, :, :], feats[:, :, :, None, :],
                    neg).amax(dim=-1)                  # (R, C, H, pw)
    out = torch.where(rowm[:, None, :, :, None], t[:, :, None, :, :],
                      neg).amax(dim=3)                 # (R, C, ph, pw)
    empty = (~rowm.any(-1))[:, None, :, None] | \
        (~colm.any(-1))[:, None, None, :]
    return torch.where(empty, torch.zeros((), dtype=x.dtype, device=dev),
                       out)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling (reference
    vision/ops.py:893): C = out_c * ph * pw input channels, bin (i, j)
    averages channel group i*pw + j over its span; (R, out_c, ph, pw).
    Tensor ops on ``x``'s device."""
    ph, pw = _pair(output_size)
    dev = x.device
    C, H, W = x.shape[1], x.shape[2], x.shape[3]
    if C % (ph * pw):
        raise ValueError("psroi_pool: channels must be out_c * ph * pw")
    out_c = C // (ph * pw)
    boxes = _tensor(boxes, dev, torch.float32)
    img = _roi_images(boxes_num, boxes.shape[0], dev)
    x1 = torch.round(boxes[:, 0]) * spatial_scale
    y1 = torch.round(boxes[:, 1]) * spatial_scale
    x2 = torch.round(boxes[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(boxes[:, 3] + 1.0) * spatial_scale
    rowm = _bins(y1, torch.clamp(y2 - y1, min=0.1), ph, H, dev).to(x.dtype)
    colm = _bins(x1, torch.clamp(x2 - x1, min=0.1), pw, W, dev).to(x.dtype)
    feats = x[img].reshape(-1, out_c, ph, pw, H, W)
    t = torch.einsum("ropqhw,rqw->ropqh", feats, colm)
    t = torch.einsum("ropqh,rph->ropq", t, rowm)
    cnt = torch.einsum("rph,rqw->rpq", rowm, colm)[:, None]
    return torch.where(cnt > 0, t / torch.clamp(cnt, min=1.0),
                       torch.zeros((), dtype=x.dtype, device=dev))


def polygon_box_transform(input, name=None):
    """EAST geometry-map offsets to absolute quad coordinates (reference
    vision/ops.py:945: even channels 4*w - v, odd 4*h - v). Tensor ops on
    ``input``'s device."""
    n, c, h, w = input.shape
    jj = torch.arange(w, dtype=input.dtype,
                      device=input.device)[None, None, None, :] * 4.0
    ii = torch.arange(h, dtype=input.dtype,
                      device=input.device)[None, None, :, None] * 4.0
    even = (torch.arange(c, device=input.device) % 2 == 0)[None, :, None,
                                                           None]
    return torch.where(even, jj - input, ii - input)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    """RPN proposals (reference vision/ops.py:957): decode the anchors by
    the deltas, clip, drop the small, NMS. The inputs are copied to the
    host and everything runs there in numpy, as the reference's does;
    (rois, scores[, rois_num]) come back on ``scores``' device."""
    dev = _device_of(scores)
    scores = _host(scores)                       # (N, A, H, W)
    deltas = _host(bbox_deltas)                  # (N, A*4, H, W)
    img_size = _host(img_size)                   # (N, 2) [h, w]
    anc = _host(anchors).reshape(-1, 4)
    var = _host(variances).reshape(-1, 4)
    # the reference's FilterBoxes (bbox_util.h:197) floors the size at 1px
    min_size = max(min_size, 1.0)
    rois, roi_scores, rois_num = [], [], []
    for n in range(scores.shape[0]):
        s = scores[n].transpose(1, 2, 0).reshape(-1)
        d = deltas[n].reshape(scores.shape[1], 4, scores.shape[2],
                              scores.shape[3]).transpose(2, 3, 0, 1) \
            .reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anc[order], var[order]
        aw = a[:, 2] - a[:, 0] + 1.0
        ah = a[:, 3] - a[:, 1] + 1.0
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        wd = np.exp(np.minimum(v[:, 2] * d[:, 2], 10.0)) * aw
        hd = np.exp(np.minimum(v[:, 3] * d[:, 3], 10.0)) * ah
        boxes = np.stack([cx - wd / 2, cy - hd / 2,
                          cx + wd / 2 - 1, cy + hd / 2 - 1], axis=1)
        ih, iw = img_size[n, 0], img_size[n, 1]
        boxes = np.stack([
            np.clip(boxes[:, 0], 0, iw - 1), np.clip(boxes[:, 1], 0, ih - 1),
            np.clip(boxes[:, 2], 0, iw - 1), np.clip(boxes[:, 3], 0, ih - 1),
        ], axis=1)
        keep_sz = ((boxes[:, 2] - boxes[:, 0] + 1 >= min_size) &
                   (boxes[:, 3] - boxes[:, 1] + 1 >= min_size))
        boxes, s = boxes[keep_sz], s[keep_sz]
        if boxes.shape[0]:
            keep = _nms_np(boxes.astype(np.float64), s.astype(np.float64),
                           nms_thresh, True, 1.0, post_nms_top_n)
            boxes, s = boxes[keep], s[keep]
        rois.append(np.asarray(boxes, np.float32))
        roi_scores.append(np.asarray(s, np.float32))
        rois_num.append(boxes.shape[0])
    out_rois = torch.as_tensor(np.concatenate(rois, 0) if rois else
                               np.zeros((0, 4), np.float32), device=dev)
    out_scores = torch.as_tensor(np.concatenate(roi_scores, 0) if roi_scores
                                 else np.zeros((0,), np.float32),
                                 device=dev)
    if return_rois_num:
        return out_rois, out_scores, torch.as_tensor(
            np.asarray(rois_num, np.int32), device=dev)
    return out_rois, out_scores
