"""The fused LM-head cross entropy and ``cross_entropy`` of the PyTorch port
against the JAX package, on the CPU.

The same numpy inputs go through the reference's ``fused_lm_ce`` in Pallas
interpret mode (as ``tests/test_fused_ce_pallas.py`` runs it) and through
the port's ``fused_lm_ce``, which on CPU tensors takes the three kernels'
plain versions. TF32 is off. Tolerances:

- float32 loss: rtol 1e-5 (sums in other orders);
- gradients: ``max|port - ref| <= tol * max|ref|`` (the 1/denom factor
  makes them small, so an absolute tolerance would check nothing): tol
  1e-4 in float32, 1e-2 in bfloat16 (one bfloat16 rounding of each
  output; both sides upcast the bfloat16 inputs exactly);
- ``cross_entropy``: float32 rtol 1e-5, atol 1e-6; bfloat16 logits rtol
  1e-3 (both take the logsumexp in float32 on the same upcast values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import loss as ref_loss
from paddle_tpu.ops.pallas import fused_ce as ref_fc
from paddle_tpu.ops.pallas import tuner as ref_tuner

from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            fused_linear_cross_entropy,
                                            softmax_with_cross_entropy)
from paddle_tpu_torch.ops import chunked_ce, fused_ce, tuner

F32_TOL, BF16_TOL = 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _data(n, h, v, seed=0, ignore_frac=0.0, all_ignored=False):
    rs = np.random.RandomState(seed)
    hid = rs.randn(n, h).astype(np.float32)
    w = (rs.randn(h, v) * 0.05).astype(np.float32)
    y = rs.randint(0, v, n).astype(np.int32)
    if ignore_frac:
        y[rs.rand(n) < ignore_frac] = -100
    if all_ignored:
        y[:] = -100
    return hid, w, y


def _ref(hid, w, y, dtype, bt=None, bv=None):
    """(loss, dh, dw) of the reference kernel in interpret mode."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    loss, (dh, dw) = jax.value_and_grad(
        lambda a, b: ref_fc.fused_lm_ce(a, b, jnp.asarray(y), block_tokens=bt,
                                        block_vocab=bv, interpret=True),
        argnums=(0, 1))(jnp.asarray(hid, jd), jnp.asarray(w, jd))
    return (float(loss), np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port(hid, w, y, dtype, transposed=False, label_dtype=torch.int64,
          **kw):
    h = torch.from_numpy(hid).to(dtype).requires_grad_()
    if transposed:
        # the tied head: the (V, H) embedding's .T view
        emb = torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype)
        emb.requires_grad_()
        wt = emb.T
        assert wt.stride() == (1, w.shape[0])
    else:
        emb = wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fused_ce.fused_lm_ce(h, wt, torch.from_numpy(y).to(label_dtype),
                                **kw)
    loss.backward()
    dw = emb.grad.T if transposed else emb.grad
    assert h.grad.dtype == dtype and dw.dtype == dtype
    return loss.item(), h.grad.float().numpy(), dw.float().numpy()


def _close(got, want, tol, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


CASES = [((128, 64, 512), 0.0), ((200, 32, 500), 0.0),
         ((128, 64, 512), 0.3), ((200, 32, 500), 0.3)]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ignore", CASES)
def test_fused_ce_matches_the_reference(shape, ignore, dtype, transposed):
    hid, w, y = _data(*shape, seed=sum(shape), ignore_frac=ignore)
    rl, rdh, rdw = _ref(hid, w, y, dtype)
    pl, pdh, pdw = _port(hid, w, y, dtype, transposed)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _close(pdh, rdh, tol, "dh")
    _close(pdw, rdw, tol, "dw")
    ignored = y == -100
    assert (pdh[ignored] == 0.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_row_ignored_gives_zero_loss_and_grads(dtype):
    hid, w, y = _data(64, 32, 300, all_ignored=True)
    rl, rdh, rdw = _ref(hid, w, y, dtype)
    pl, pdh, pdw = _port(hid, w, y, dtype)
    assert pl == rl == 0.0
    assert not pdh.any() and not pdw.any()
    assert not rdh.any() and not rdw.any()


@pytest.mark.parametrize("bt,bv", [(8, 128), (64, 256), (256, 2048)])
def test_explicit_blocks_change_nothing(bt, bv):
    hid, w, y = _data(200, 32, 500, seed=4, ignore_frac=0.3)
    rl, rdh, rdw = _ref(hid, w, y, torch.float32, bt, bv)
    base = _port(hid, w, y, torch.float32)
    got = _port(hid, w, y, torch.float32, block_tokens=bt, block_vocab=bv)
    assert got[0] == base[0]
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_array_equal(got[2], base[2])
    np.testing.assert_allclose(got[0], rl, rtol=1e-5)
    _close(got[1], rdh, F32_TOL, "dh")
    _close(got[2], rdw, F32_TOL, "dw")


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_label_dtypes_agree(label_dtype):
    hid, w, y = _data(128, 64, 512, seed=5, ignore_frac=0.3)
    rl, rdh, _ = _ref(hid, w, y, torch.float32)
    pl, pdh, _ = _port(hid, w, y, torch.float32, label_dtype=label_dtype)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    _close(pdh, rdh, F32_TOL, "dh")


def test_leading_dims_and_the_port_chunked_ce_agree():
    hid, w, y = _data(192, 48, 700, seed=6, ignore_frac=0.2)
    h3 = torch.from_numpy(hid).reshape(4, 48, 48)
    y3 = torch.from_numpy(y).reshape(4, 48)
    grads = []
    for fn in (fused_ce.fused_lm_ce,
               lambda a, b, c: chunked_ce.chunked_lm_ce(a, b, c, chunk=256)):
        a = h3.clone().requires_grad_()
        b = torch.from_numpy(w).requires_grad_()
        loss = fn(a, b, y3)
        loss.backward()
        grads.append((loss.item(), a.grad.numpy(), b.grad.numpy()))
    (lf, dhf, dwf), (lc, dhc, dwc) = grads
    assert dhf.shape == (4, 48, 48)
    np.testing.assert_allclose(lf, lc, rtol=1e-5)
    _close(dhf, dhc, F32_TOL, "dh")
    _close(dwf, dwc, F32_TOL, "dw")


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    hid, w, y = _data(64, 32, 300, seed=7, ignore_frac=0.3)
    h, wt = torch.from_numpy(hid), torch.from_numpy(w)
    lbl = torch.from_numpy(y)
    n0 = dict(fused_ce.LAUNCHES)
    lse, tgt = fused_ce.ce_fwd(h, wt, lbl)
    logits = h @ wt
    torch.testing.assert_close(lse, torch.logsumexp(logits, 1), rtol=1e-6,
                               atol=1e-5)
    ok = lbl >= 0
    assert (tgt[~ok] == 0).all()
    torch.testing.assert_close(tgt[ok], logits[ok, lbl[ok].long()])
    scale = ok.float() / ok.sum()
    dh = fused_ce.ce_dh(h, wt, lbl, lse, scale)
    dw = fused_ce.ce_dw(h, wt, lbl, lse, scale)
    dl = (torch.softmax(logits, 1) -
          torch.nn.functional.one_hot(lbl.clamp(min=0).long(), 300) *
          ok[:, None]) * scale[:, None]
    torch.testing.assert_close(dh, dl @ wt.T, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dw, h.T @ dl, rtol=1e-5, atol=1e-7)
    assert fused_ce.LAUNCHES == n0           # no kernel ran on the CPU
    assert not fused_ce.fused_ce_supported(h, wt)


def test_dispatch_auto_counts_the_fallback_and_unknown_raises():
    hid, w, y = _data(64, 32, 300, seed=8, ignore_frac=0.3)
    args = [torch.from_numpy(x) for x in (hid, w, y)]
    n0 = tuner.FALLBACKS["fused_ce"]
    auto = fused_linear_cross_entropy(*args, kernel="auto")
    assert tuner.FALLBACKS["fused_ce"] == n0 + 1
    chunked = fused_linear_cross_entropy(*args, kernel="chunked")
    assert auto.item() == chunked.item()
    pallas = fused_linear_cross_entropy(*args, kernel="pallas")
    assert tuner.FALLBACKS["fused_ce"] == n0 + 1
    np.testing.assert_allclose(pallas.item(), chunked.item(), rtol=1e-5)
    with pytest.raises(ValueError, match="kernel must be"):
        fused_linear_cross_entropy(*args, kernel="mosaic")
    with pytest.raises(ValueError, match="weight must be"):
        fused_ce.fused_lm_ce(args[0], args[1].T, args[2])


@pytest.mark.parametrize("dtype,dims", [
    (torch.bfloat16, (768, 50304, 8192)), (torch.float32, (128, 1024, 512)),
    (torch.float32, (64, 512, 128)), (torch.float32, (64, 512, 100)),
    (torch.bfloat16, (2048, 50304, 8192))])
def test_tuning_rows_and_blocks_answer_as_the_reference(dtype, dims):
    h, v, n = dims
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert tuner.ce_dims(h, v, n) == ref_tuner.ce_dims(h, v, n)
    defaults = {"block_tokens": fused_ce.DEFAULT_BLOCK_TOKENS,
                "block_vocab": fused_ce.DEFAULT_BLOCK_VOCAB}
    assert defaults == {"block_tokens": ref_fc.DEFAULT_BLOCK_TOKENS,
                        "block_vocab": ref_fc.DEFAULT_BLOCK_VOCAB}
    got = tuner.resolve("fused_ce", dtype, tuner.ce_dims(h, v, n), defaults)
    want = ref_tuner.resolve("fused_ce", jd, ref_tuner.ce_dims(h, v, n),
                             defaults)
    assert got == want
    assert fused_ce.resolve_blocks(dtype, n, h, v) == \
        ref_fc._clamp_blocks(n, v, got[0]["block_tokens"],
                             got[0]["block_vocab"])


# -- the backward's route, a pure function of (dtype, H) ---------------------

@pytest.mark.parametrize("dtype,h,route", [
    (torch.bfloat16, 768, "tiled"), (torch.bfloat16, 1024, "tiled"),
    (torch.bfloat16, 2048, "staged"), (torch.bfloat16, 32, "staged"),
    (torch.bfloat16, 2816, "staged"), (torch.float32, 768, "staged"),
    (torch.float32, 1024, "staged"), (torch.float32, 2496, "staged")])
def test_backward_route_by_dtype_and_hidden(dtype, h, route):
    assert fused_ce.bwd_route(dtype, h) == route


@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 2880),
                                     (torch.bfloat16, 4096),
                                     (torch.float32, 2560),
                                     (torch.float16, 768)])
def test_backward_route_past_both_limits_raises(dtype, h):
    with pytest.raises(ValueError, match="fused_ce kernel"):
        fused_ce.bwd_route(dtype, h)


def test_max_hidden_is_the_larger_route_limit():
    assert fused_ce.max_hidden(torch.bfloat16) == 2816
    assert fused_ce.max_hidden(torch.float32) == 2496
    assert max(fused_ce.TILED_HIDDEN) <= fused_ce.max_hidden(torch.bfloat16)


def test_the_main_path_call_takes_the_tiled_route():
    """bench.py's fused_b8_pallas_ce: GPT-base (hidden 768) in bf16, the
    head's hidden states against the tied embedding's .T view."""
    import inspect
    from paddle_tpu_torch.text.models import gpt
    sig = inspect.signature(gpt.GPTModel.__init__)
    h = sig.parameters["hidden_size"].default
    assert h == 768
    assert fused_ce.bwd_route(torch.bfloat16, h) == "tiled"
    emb = torch.zeros(50304, h, dtype=torch.bfloat16)
    hid, w = fused_ce._tiled_operands(torch.zeros(16, h, dtype=torch.bfloat16),
                                      emb.T)
    assert w.data_ptr() == emb.data_ptr()       # the tied view, no copy
    assert w.stride() == (1, h)
    # a contiguous (H, V) w is laid out h-contiguous for the tiled kernel
    _, w2 = fused_ce._tiled_operands(hid, emb.T.contiguous())
    assert w2.stride() == (1, h) and torch.equal(w2, emb.T)


# -- cross_entropy / softmax_with_cross_entropy -------------------------------

def _ce_inputs(seed, shape=(6, 7, 11)):
    rs = np.random.RandomState(seed)
    logits = rs.randn(*shape).astype(np.float32) * 3
    labels = rs.randint(0, shape[-1], shape[:-1]).astype(np.int64)
    labels.flat[::4] = -100
    weight = rs.rand(shape[-1]).astype(np.float32) + 0.5
    soft = rs.rand(*shape).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    return logits, labels, weight, soft


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("use_weight", [False, True])
def test_cross_entropy_hard_labels_match_the_reference(reduction, use_weight):
    logits, labels, weight, _ = _ce_inputs(1)
    kw = dict(ignore_index=-100, reduction=reduction)
    want = ref_loss.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        weight=jnp.asarray(weight) if use_weight else None, **kw)
    got = cross_entropy(_t(logits), _t(labels),
                        weight=_t(weight) if use_weight else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["soft", "axis1", "no_softmax",
                                  "label_with_class_dim"])
def test_cross_entropy_variants_match_the_reference(case):
    logits, labels, _, soft = _ce_inputs(2)
    if case == "soft":
        args = (logits, soft)
        kw = dict(soft_label=True)
    elif case == "axis1":
        args = (np.moveaxis(logits, -1, 1), labels)
        kw = dict(axis=1)
    elif case == "no_softmax":
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        args = (probs.astype(np.float32), labels)
        kw = dict(use_softmax=False)
    else:
        args = (logits, labels[..., None])
        kw = {}
    want = ref_loss.cross_entropy(*[jnp.asarray(a) for a in args], **kw)
    got = cross_entropy(*[_t(a) for a in args], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_entropy_bf16_logits_match_the_reference():
    logits, labels, _, _ = _ce_inputs(3, shape=(4, 16, 300))
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = ref_loss.cross_entropy(
        jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(labels))
    got = cross_entropy(lb, _t(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-3)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy_matches_the_reference(return_softmax):
    logits, labels, _, _ = _ce_inputs(4, shape=(5, 9))
    want = ref_loss.softmax_with_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels)[:, None],
        return_softmax=return_softmax)
    got = softmax_with_cross_entropy(_t(logits), _t(labels)[:, None],
                                     return_softmax=return_softmax)
    if not return_softmax:
        want, got = (want,), (got,)
    assert got[0].shape == (5, 1)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
