"""``paddle_tpu_torch.vision.ops`` against the JAX package's
``vision/ops.py``, on the CPU.

Every public op runs in both packages on the same seeded numpy inputs at
small shapes: the dense ones under ``jax.jit`` on the reference's side,
the host-side selection ops (NMS family, matching, proposals) eagerly as
the reference runs them. float32 results within rtol 1e-5 and atol 1e-5
(sums reordered), the kept indices and counts exactly. The gradients of
the differentiable ops (``box_coder``, ``roi_align``, ``roi_pool``,
``psroi_pool``, ``deform_conv2d``, ``yolo_loss``) are those of
``sum(out * r)`` for a seeded ``r``, against ``jax.grad`` of the same,
within rtol 1e-4 and atol 1e-5 (the reference's gather transposes and
the port's scatter-adds sum in other orders). ``yolo_box``'s boxes are
held against the reference's after undoing its layout (ROADMAP "Oracle
caveats": the reference scrambles the rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.vision.ops as R
import paddle_tpu_torch.vision.ops as P

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: beside other test
    processes on the same cores, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rs(seed):
    return np.random.RandomState(seed)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


def _grads(ref_fn, port_fn, arrays, wrt, seed=99):
    """Gradients of ``sum(out * r)`` in both packages w.r.t. the inputs
    at positions ``wrt``: (port's, reference's)."""
    out = jax.eval_shape(ref_fn, *[jnp.asarray(a) for a in arrays])
    r = _rs(seed).randn(*out.shape).astype(np.float32)

    def ref_loss(*a):
        return jnp.sum(ref_fn(*a) * r)
    want = jax.jit(jax.grad(ref_loss, argnums=tuple(wrt)))(
        *[jnp.asarray(a) for a in arrays])
    ts = _t(*arrays)
    for i in wrt:
        ts[i].requires_grad_()
    (port_fn(*ts) * torch.from_numpy(r)).sum().backward()
    return [ts[i].grad for i in wrt], want


# -- YOLOv3 -------------------------------------------------------------------
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("clip", [True, False])
def test_yolo_box(clip):
    n, an, h, w, c = 2, 3, 4, 5, 4
    x = _rs(1).randn(n, an * (5 + c), h, w).astype(np.float32)
    img = np.array([[128, 160], [96, 120]], np.int32)
    anchors = ANCHORS[:2 * an]
    rb, rsc = jax.jit(lambda a, s: R.yolo_box(a, s, anchors, c, 0.3, 32,
                                              clip_bbox=clip))(
        jnp.asarray(x), jnp.asarray(img))
    pb, psc = P.yolo_box(*_t(x, img), anchors, c, 0.3, 32, clip_bbox=clip)
    _close(psc, rsc)
    # the reference's rows are its (N, A, H, W, 4) boxes transposed as
    # (N, A, W, 4, H): undone, they are a row per (anchor, y, x)
    rb = np.asarray(rb).reshape(n, an, w, 4, h).transpose(0, 1, 4, 2, 3)
    _close(pb, rb.reshape(n, an * h * w, 4), dict(rtol=1e-5, atol=1e-4))


def _yolo_inputs():
    rs = _rs(2)
    n, h, w, c, b = 2, 4, 4, 3, 5
    x = rs.randn(n, 3 * (5 + c), h, w).astype(np.float32)
    gt = np.zeros((n, b, 4), np.float32)
    gt[:, :4, :2] = rs.uniform(0.05, 0.95, (n, 4, 2))
    gt[:, :4, 2:] = rs.uniform(0.05, 0.6, (n, 4, 2))
    gt[0, 1] = gt[0, 0] * [1.0, 1.0, 1.02, 0.98]   # the same cell and anchor
    label = rs.randint(0, c, (n, b)).astype(np.int32)
    score = rs.uniform(0.5, 1.0, (n, b)).astype(np.float32)
    return x, gt, label, score, c


def test_yolo_loss_forward_and_backward():
    x, gt, label, score, c = _yolo_inputs()
    kw = dict(anchors=ANCHORS, anchor_mask=[3, 4, 5], class_num=c,
              ignore_thresh=0.5, downsample_ratio=32, use_label_smooth=True)

    def ref(a, g, lb, s):
        return R.yolo_loss(a, g, lb, gt_score=s, **kw)

    def port(a, g, lb, s):
        return P.yolo_loss(a, g, lb, gt_score=s, **kw)
    arrays = (x, gt, label, score)
    want = jax.jit(ref)(*[jnp.asarray(a) for a in arrays])
    _close(port(*_t(*arrays)), want)
    got, want_g = _grads(ref, port, arrays, (0,))
    _close(got, want_g, GTOL)


# -- deformable convolution ---------------------------------------------------
def _deform_inputs(dg=2, groups=2):
    rs = _rs(3)
    x = rs.randn(2, 4, 6, 7).astype(np.float32)
    off = (1.5 * rs.randn(2, 2 * dg * 9, 3, 4)).astype(np.float32)
    mask = rs.rand(2, dg * 9, 3, 4).astype(np.float32)
    w = (0.3 * rs.randn(6, 4 // groups, 3, 3)).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    return x, off, mask, w, b


@pytest.mark.parametrize("v2", [False, True])
def test_deform_conv2d_forward_and_backward(v2):
    kw = dict(stride=2, padding=1, dilation=1, deformable_groups=2,
              groups=2)

    def ref(x, o, m, w, b):
        return R.deform_conv2d(x, o, w, b, mask=m if v2 else None, **kw)

    def port(x, o, m, w, b):
        return P.deform_conv2d(x, o, w, b, mask=m if v2 else None, **kw)
    arrays = _deform_inputs()
    want = jax.jit(ref)(*[jnp.asarray(a) for a in arrays])
    got = port(*_t(*arrays))
    assert got.shape == (2, 6, 3, 4)
    _close(got, want)
    wrt = (0, 1, 2, 3, 4) if v2 else (0, 1, 3, 4)
    got_g, want_g = _grads(ref, port, arrays, wrt)
    _close(got_g, want_g, GTOL)


def test_deform_conv2d_layer_carries_the_reference_weights():
    import paddle_tpu as ref
    x, off, mask, _, _ = _deform_inputs(dg=1, groups=1)
    off, mask = off[:, :18], mask[:, :9]
    ref.seed(0)
    rl = R.DeformConv2D(4, 6, 3, padding=1, stride=2)
    pl = P.DeformConv2D(4, 6, 3, padding=1, stride=2)
    pl.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rl.state_dict().items()})
    _close(pl(*_t(x, off, mask)), jax.jit(rl.__call__)(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask)))
    assert [n for n, _ in pl.named_parameters()] == ["weight", "bias"]


# -- image IO -----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_read_file_and_decode_jpeg(tmp_path, mode):
    from PIL import Image
    img = _rs(4).randint(0, 256, (12, 10, 3)).astype(np.uint8)
    path = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(path, quality=90)
    raw = P.read_file(path)
    assert raw.dtype == torch.uint8 and raw.device.type == "cpu"
    np.testing.assert_array_equal(raw.numpy(), np.asarray(R.read_file(path)))
    got = P.decode_jpeg(raw, mode=mode)
    want = np.asarray(R.decode_jpeg(R.read_file(path), mode=mode))
    np.testing.assert_array_equal(got.numpy(), want)


# -- priors and anchors -------------------------------------------------------
@pytest.mark.parametrize("order,clip,flip", [(False, False, True),
                                             (True, True, False)])
def test_prior_box(order, clip, flip):
    feat, image = np.zeros((1, 8, 5, 6), np.float32), \
        np.zeros((1, 3, 60, 72), np.float32)
    kw = dict(min_sizes=[12.0, 30.0], aspect_ratios=[2.0, 3.0],
              max_sizes=[30.0, 50.0], flip=flip, clip=clip,
              min_max_aspect_ratios_order=order)
    want = R.prior_box(jnp.asarray(feat), jnp.asarray(image), **kw)
    got = P.prior_box(*_t(feat, image), **kw)
    _close(got, want, dict(rtol=1e-6, atol=1e-7))


def test_density_prior_box_and_anchor_generator():
    feat, image = np.zeros((1, 8, 4, 5), np.float32), \
        np.zeros((1, 3, 64, 80), np.float32)
    for flat in (False, True):
        kw = dict(densities=[4, 2], fixed_sizes=[32.0, 64.0],
                  fixed_ratios=[1.0, 2.0], clip=True, flatten_to_2d=flat)
        _close(P.density_prior_box(*_t(feat, image), **kw),
               R.density_prior_box(jnp.asarray(feat), jnp.asarray(image),
                                   **kw), dict(rtol=1e-6, atol=1e-7))
    kw = dict(anchor_sizes=[32.0, 64.0, 128.0], aspect_ratios=[0.5, 1.0, 2.0],
              stride=(16.0, 16.0))
    _close(P.anchor_generator(*_t(feat), **kw),
           R.anchor_generator(jnp.asarray(feat), **kw),
           dict(rtol=1e-6, atol=1e-5))


# -- box coding and IoU -------------------------------------------------------
def _boxes(rs, n, scale=1.0):
    xy = rs.uniform(0, 0.6, (n, 2))
    wh = rs.uniform(0.05, 0.4, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


@pytest.mark.parametrize("var,normalized", [("none", True), ("list", False),
                                            ("tensor", True)])
def test_box_coder_encode_and_decode(var, normalized):
    rs = _rs(5)
    scale = 1.0 if normalized else 100.0
    prior, target = _boxes(rs, 6, scale), _boxes(rs, 4, scale)
    pvar = {"none": None, "list": [0.1, 0.1, 0.2, 0.2],
            "tensor": rs.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    deltas = (0.2 * rs.randn(4, 6, 4)).astype(np.float32)

    def args(mod_t, pv):
        return pv if pv is None or isinstance(pv, list) else mod_t(pv)
    for code, tgt in (("encode_center_size", target),
                      ("decode_center_size", deltas)):
        for axis in ((0,) if code[0] == "e" else (0, 1)):
            p = prior if axis == 0 or code[0] == "e" else prior[:4]
            pv = pvar if not isinstance(pvar, np.ndarray) or axis == 0 \
                else pvar[:4]
            kw = dict(code_type=code, box_normalized=normalized, axis=axis)

            def ref(pb, t):
                return R.box_coder(pb, args(jnp.asarray, pv), t, **kw)

            def port(pb, t):
                return P.box_coder(pb, args(torch.from_numpy, pv), t, **kw)
            want = jax.jit(ref)(jnp.asarray(p), jnp.asarray(tgt))
            _close(port(*_t(p, tgt)), want)
            got_g, want_g = _grads(ref, port, (p, tgt), (0, 1))
            _close(got_g, want_g, GTOL)


def test_box_clip_and_iou_similarity():
    rs = _rs(6)
    boxes = (rs.uniform(-20, 140, (2, 5, 4))).astype(np.float32)
    info = np.array([[100, 120, 1.0], [60, 80, 0.5]], np.float32)
    _close(P.box_clip(*_t(boxes, info)),
           jax.jit(R.box_clip)(jnp.asarray(boxes), jnp.asarray(info)))
    _close(P.box_clip(*_t(boxes[0], info[0])),
           R.box_clip(jnp.asarray(boxes[0]), jnp.asarray(info[0])))
    a, b = _boxes(rs, 5, 50.0), _boxes(rs, 7, 50.0)
    for norm in (True, False):
        _close(P.iou_similarity(*_t(a, b), box_normalized=norm),
               R.iou_similarity(jnp.asarray(a), jnp.asarray(b),
                                box_normalized=norm))


# -- matching and the NMS family (host) ---------------------------------------
@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    d = _rs(7).rand(4, 7).astype(np.float32)
    gi, gd = P.bipartite_match(torch.from_numpy(d), match_type, 0.3)
    wi, wd = R.bipartite_match(d, match_type, 0.3)
    assert gi.dtype == torch.int64
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gd, wd)


def _nms_boxes(n=40, seed=8):
    rs = _rs(seed)
    centres = rs.uniform(10, 90, (6, 2))[rs.randint(0, 6, n)] + \
        rs.randn(n, 2) * 3
    wh = rs.uniform(8, 20, (n, 2))
    boxes = np.concatenate([centres - wh / 2, centres + wh / 2], 1)
    return boxes.astype(np.float32), rs.rand(n).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "scores", "categories", "top_k",
                                  "pixels", "eta"])
def test_nms(case):
    boxes, scores = _nms_boxes()
    cats = _rs(9).randint(0, 3, boxes.shape[0])
    kw = {"plain": {}, "scores": dict(scores=scores),
          "categories": dict(scores=scores, category_idxs=cats),
          "top_k": dict(scores=scores, top_k=5),
          "pixels": dict(scores=scores, normalized=False),
          "eta": dict(scores=scores, nms_eta=0.9)}[case]
    thr = 0.6 if case == "eta" else 0.3
    got = P.nms(torch.from_numpy(boxes), thr,
                **{k: torch.from_numpy(np.asarray(v)) if k != "top_k"
                   and not isinstance(v, bool) and not isinstance(v, float)
                   else v for k, v in kw.items()})
    want = R.nms(boxes, thr, **kw)
    assert got.dtype == torch.int64 and 0 < len(got) < len(boxes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _multiclass_inputs():
    rs = _rs(10)
    boxes = np.stack([_nms_boxes(30, seed=s)[0] / 100.0 for s in (11, 12)])
    scores = rs.rand(2, 4, 30).astype(np.float32)
    return boxes, scores


def test_multiclass_nms():
    boxes, scores = _multiclass_inputs()
    kw = dict(score_threshold=0.3, nms_top_k=12, keep_top_k=20,
              nms_threshold=0.4)
    got = P.multiclass_nms(*_t(boxes, scores), **kw)
    want = R.multiclass_nms(boxes, scores, **kw)
    assert len(got) == 2 and all(len(g) > 0 for g in got)
    _close(got, want, dict(rtol=0, atol=0))


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    boxes, scores = _multiclass_inputs()
    kw = dict(score_threshold=0.2, post_threshold=0.1, nms_top_k=15,
              keep_top_k=25, use_gaussian=gaussian)
    got = P.matrix_nms(*_t(boxes, scores), **kw)
    want = R.matrix_nms(boxes, scores, **kw)
    assert all(len(g) > 0 for g in got)
    _close(got, want, dict(rtol=1e-6, atol=1e-7))


def test_generate_proposals():
    rs = _rs(13)
    n, a, h, w = 2, 3, 4, 5
    scores = rs.rand(n, a, h, w).astype(np.float32)
    deltas = (0.3 * rs.randn(n, 4 * a, h, w)).astype(np.float32)
    img = np.array([[64, 80], [60, 70]], np.float32)
    anchors, var = R.anchor_generator(
        jnp.zeros((1, 1, h, w)), [16.0, 32.0, 48.0], [1.0], stride=(16., 16.))
    anchors, var = np.asarray(anchors), np.asarray(var)
    kw = dict(pre_nms_top_n=40, post_nms_top_n=12, nms_thresh=0.5,
              min_size=2.0, return_rois_num=True)
    got = P.generate_proposals(*_t(scores, deltas, img, anchors, var), **kw)
    want = R.generate_proposals(scores, deltas, img, anchors, var, **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[:2], want[:2], dict(rtol=1e-6, atol=1e-5))
    two = P.generate_proposals(*_t(scores, deltas, img, anchors, var),
                               pre_nms_top_n=40, post_nms_top_n=12)
    assert len(two) == 2 and torch.equal(two[0], got[0])


# -- RoI pooling --------------------------------------------------------------
def _roi_inputs(c=8):
    rs = _rs(14)
    x = rs.randn(2, c, 9, 11).astype(np.float32)
    boxes = _boxes(rs, 5, 10.0) + np.float32(0.3)
    boxes[4] = [8.5, 6.0, 12.0, 12.0]      # partly outside the map
    return x, boxes, np.array([3, 2], np.int32)


@pytest.mark.parametrize("aligned,sr,scale", [(True, 3, 0.8),
                                              (False, -1, 0.5)])
def test_roi_align_forward_and_backward(aligned, sr, scale):
    x, boxes, num = _roi_inputs()
    kw = dict(output_size=(3, 2), spatial_scale=scale, sampling_ratio=sr,
              aligned=aligned)

    def ref(xx, b):
        return R.roi_align(xx, b, num, **kw)

    def port(xx, b):
        return P.roi_align(xx, b, torch.from_numpy(num), **kw)
    want = jax.jit(ref)(jnp.asarray(x), jnp.asarray(boxes))
    _close(port(*_t(x, boxes)), want)
    got_g, want_g = _grads(ref, port, (x, boxes), (0,))
    _close(got_g, want_g, GTOL)


@pytest.mark.parametrize("op", ["roi_pool", "psroi_pool"])
def test_roi_pools_forward_and_backward(op):
    x, boxes, num = _roi_inputs(c=12)
    kw = dict(output_size=(2, 3) if op == "psroi_pool" else 3,
              spatial_scale=0.7)

    def ref(xx, b):
        return getattr(R, op)(xx, b, num, **kw)

    def port(xx, b):
        return getattr(P, op)(xx, b, num, **kw)
    want = jax.jit(ref)(jnp.asarray(x), jnp.asarray(boxes))
    _close(port(*_t(x, boxes)), want)
    got_g, want_g = _grads(ref, port, (x, boxes), (0,))
    _close(got_g, want_g, GTOL)


def test_polygon_box_transform():
    x = _rs(15).randn(2, 8, 3, 4).astype(np.float32)
    _close(P.polygon_box_transform(torch.from_numpy(x)),
           jax.jit(R.polygon_box_transform)(jnp.asarray(x)))


def test_every_public_op_is_ported():
    public = {n for n in dir(R) if not n.startswith("_")
              and callable(getattr(R, n))
              and getattr(getattr(R, n), "__module__", "") == R.__name__}
    assert public == set(P.__all__)
    for n in public:
        assert callable(getattr(P, n)), n
