"""The bf16 roundings of the tensor-core flash kernels, modelled on the CPU,
and the bar they set for the backward on the card.

The mma route rounds three float32 intermediates to bfloat16 that the plain
version keeps in float32: p before P·V in the forward, and p and ds before
the products they feed in dq and dk/dv (``csrc/flash_attention.cu``,
``flash_dq_mma_kernel`` and ``flash_dkv_mma_kernel``). Dropout zeroes the
dropped p before its rounding and applies 1 / (1 - rate) to the float32
sums (out, dv), never rounded into p. Rounded into p, the scale's own bf16
error (1.109 for 1.111) moves out, so delta, and so ds, of rows whose
weight sits on one key: the card's bf16 dropout case of
``test_flash_kernels_match_plain`` failed ``FLASH_TOL`` so, and this model
reads 1.07 times the bar at one dk element of its inputs
(:func:`test_the_model_holds_flash_tol_where_the_scale_was_rounded`).

This file builds the whole autograd path with those roundings and the
kernels' bf16 outputs (:func:`rounded_grads`), holds the model's plain
twin against the port's plain backward, and reads
``||g - plain|| / ||plain||`` of dq, dk and dv against the plain float32
backward on bf16 inputs made from a numpy seed: causal and not, with and
without ``lens`` (one row with no visible key), with and without dropout,
at a few hundred positions and D = 64 and 128.

``chip_smoke.MMA_BWD_BOUND`` (1e-2 for each output) is about three times
the largest reading here (every reading 2.5e-3 to 2.86e-3, most of it the
two independent bf16 roundings of each output; 3.24e-3 while the model
still rounded the dropout scale into p, when the bound was set); the card
holds the kernels to it on every bf16 case. The test asserts that each
reading stays under the bound, and that it is above 1e-3 while the model
without its roundings stays below that: the readings are the roundings'
own.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as fa

BF16 = torch.bfloat16


def _round(x):
    return x.to(BF16).float()


def rounded_grads(q, k, v, do, lens, causal, rate, seed, blocks, rnd=_round,
                  scale_in_p=False):
    """dq, dk, dv (bf16) of the mma route's arithmetic: the forward's kept p
    rounded by ``rnd`` before P·V (out in bf16, lse float32), then the kept
    p and ds rounded by ``rnd`` before dv = (m∘p)^T do, dq = scale ds k and
    dk = scale ds^T q; the dropout scale multiplies out and dv in float32.
    With ``rnd`` the identity it is the plain backward on its own forward,
    up to where the scale is applied. ``scale_in_p`` rounds the scaled p
    instead (the design the kernels left)."""
    b, s, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    sc = fa._scores(q, k, fa._lens(lens, b, s, q.device), scale, causal)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m) * (sc > fa.NEG_INF * 0.5)
    l = p.sum(dim=-1, keepdim=True)
    mask = (fa._full_dropout_mask(b, h, s, s, rate, seed, blocks, q.device)
            if rate > 0.0 else torch.ones_like(p))
    keep, dsc = (mask, 1.0) if scale_in_p else \
        ((mask > 0).float(), 1.0 / (1.0 - rate))
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (dsc * torch.einsum("bhqk,bkhd->bqhd", rnd(p * keep), v.float()) /
           l_safe.squeeze(-1).transpose(1, 2)[..., None]).to(BF16)
    lse = torch.where(l == 0.0, torch.zeros_like(l), m + torch.log(l_safe))
    pb = torch.exp(sc - lse) * (sc > fa.NEG_INF * 0.5)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float()) * mask
    ds = rnd(pb * (dp - fa._delta(out, do)[..., None]))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = dsc * torch.einsum("bhqk,bqhd->bkhd", rnd(pb * keep), do.float())
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


CASES = [(s, d, causal, lens, rate)
         for s, d in ((200, 64), (384, 64), (256, 128))
         for causal in (True, False)
         for lens in (None, "s37", "0_37")
         for rate in (0.0, 0.1) if not (lens == "0_37" and rate)]


def _inputs(s, d, lens, seed, b=2, h=3):
    rs = np.random.RandomState(seed)
    q, k, v, do = [torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
                   .to(BF16) for _ in range(4)]
    ln = {None: None, "s37": [s, 37], "0_37": [0, 37]}[lens]
    return q, k, v, do, (None if ln is None else
                         torch.tensor(ln, dtype=torch.int32))


def _rel(g, r):
    g, r = g.float(), r.float()
    return ((g - r).norm() / r.norm().clamp_min(1e-30)).item()


def readings(case, seed):
    """||model - plain|| / ||plain|| of dq, dk, dv at one case."""
    s, d, causal, lens, rate = case
    q, k, v, do, ln = _inputs(s, d, lens, seed)
    blocks = fa.keying_blocks(BF16, d, s, s)
    plain_out, plain_lse = fa.flash_attention_plain_fwd(
        q, k, v, ln, 7, None, causal, rate, blocks)
    plain = fa.flash_attention_plain_bwd(q, k, v, plain_out, plain_lse, do,
                                         ln, 7, None, causal, rate, blocks)
    got = rounded_grads(q, k, v, do, ln, causal, rate, 7, blocks)
    return {name: _rel(g, r) for name, g, r in zip(("dq", "dk", "dv"), got,
                                                   plain)}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_model_without_rounding_is_the_plain_backward(case):
    s, d, causal, lens, rate = case
    q, k, v, do, ln = _inputs(s, d, lens, seed=1)
    blocks = fa.keying_blocks(BF16, d, s, s)
    out, lse = fa.flash_attention_plain_fwd(q, k, v, ln, 7, None, causal,
                                            rate, blocks)
    plain = fa.flash_attention_plain_bwd(q, k, v, out, lse, do, ln, 7, None,
                                         causal, rate, blocks)
    exact = rounded_grads(q, k, v, do, ln, causal, rate, 7, blocks,
                          rnd=lambda x: x)
    for g, r in zip(exact, plain):
        torch.testing.assert_close(g.float(), r.float(), rtol=1e-2,
                                   atol=1e-2)
        assert _rel(g, r) < 1e-3


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bf16_roundings_of_p_and_ds_stay_under_the_card_bound(case):
    bound = chip_smoke.MMA_BWD_BOUND
    got = readings(case, seed=sum(map(ord, str(case))) % 1000)
    for name, rel in got.items():
        assert 1e-3 < rel <= bound[f"{name}_rel"], (name, rel, bound)


@pytest.mark.parametrize("scale_in_p", [False, True])
def test_the_model_holds_flash_tol_where_the_scale_was_rounded(scale_in_p):
    """The inputs of the card's bf16 dropout case of
    ``test_flash_kernels_match_plain`` (S 1024, D 64, causal, rate 0.1,
    numpy seed 1088, B 2, H 4): the route's roundings hold ``FLASH_TOL``
    (2e-2, 2e-2) at every element (worst 0.30 of the bar); with the
    dropout scale rounded into p one dk element reads 1.07 of it."""
    rs = np.random.RandomState(1024 + 64)
    q, k, v, do = [torch.from_numpy(rs.randn(2, 1024, 4, 64).astype(
        np.float32)).to(BF16) for _ in range(4)]
    blocks = fa.keying_blocks(BF16, 64, 1024, 1024)
    out, lse = fa.flash_attention_plain_fwd(q, k, v, None, 7, None, True,
                                            0.1, blocks)
    plain = fa.flash_attention_plain_bwd(q, k, v, out, lse, do, None, 7,
                                         None, True, 0.1, blocks)
    got = rounded_grads(q, k, v, do, None, True, 0.1, 7, blocks,
                        scale_in_p=scale_in_p)
    worst = max(((g.float() - r.float()).abs() /
                 (2e-2 + 2e-2 * r.float().abs())).max().item()
                for g, r in zip(got, plain))
    if scale_in_p:
        assert worst > 1.0
    else:
        assert worst < 0.5
