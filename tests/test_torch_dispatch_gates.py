"""The port's kernel gates and the flash forward's route, as pure functions
of (device type, dtype, shape), on the CPU.

A gate admits exactly what its kernels take, so that a caller sends the rest
to its plain path and counts a fallback instead of raising:
``flash_gate`` (``scaled_dot_product_attention``) and ``fused_ce_gate``
(``fused_linear_cross_entropy(kernel="auto")``). ``fwd_route`` and
``bwd_route`` pick the flash forward's kernel and the backward's pair: the
tensor-core ones for bfloat16 at D = 64 or 128 with rows on 16-byte
boundaries (q, k, v; and do for the backward), else the scalar ones. No
tolerance: every check is exact.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce, tuner

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
MAIN_QKV = (8, 1024, 12, 64)          # GPT-base attention, the main path
MAIN_CE_H = 768                       # GPT-base hidden, the main path


@pytest.mark.parametrize("device,dtype,shape,min_seq,want", [
    ("cuda", BF16, MAIN_QKV, 512, True),          # the main path's call
    ("cuda", F32, MAIN_QKV, 512, True),
    ("cuda", BF16, (8, 1024, 16, 128), 512, True),  # gpt_1p3b's heads
    ("cuda", F16, MAIN_QKV, 512, False),          # no float16 kernel
    ("cuda", BF16, (4096, 512, 16, 64), 512, False),   # b*h = 65536
    ("cuda", BF16, (4095, 512, 16, 64), 512, True),    # b*h = 65520
    ("cuda", BF16, (1, 512, 65535, 64), 512, True),    # b*h = 65535
    ("cuda", BF16, (8, 1024, 12, 96), 512, False),     # head_dim
    ("cuda", BF16, (8, 256, 12, 64), 512, False),      # too short for sdpa
    ("cuda", BF16, (8, 256, 12, 64), 128, True),
    ("cpu", BF16, MAIN_QKV, 512, False),
    ("cuda", BF16, (8, 1024, 64), 512, False)])        # not (B, S, H, D)
def test_flash_gate(device, dtype, shape, min_seq, want):
    assert fa.flash_gate(device, dtype, shape, min_seq) is want


def test_flash_supported_is_the_gate_on_q():
    q = torch.zeros(2, 128, 4, 64, dtype=BF16)
    assert not fa.flash_supported(q, q)               # a CPU tensor
    assert fa.flash_gate("cuda", q.dtype, tuple(q.shape))


@pytest.mark.parametrize("device,dtype,h,w_dtype,want", [
    ("cuda", BF16, MAIN_CE_H, BF16, True),             # the main path
    ("cuda", BF16, MAIN_CE_H, F16, False),             # mixed dtypes
    ("cuda", F32, MAIN_CE_H, F32, True),
    ("cuda", F16, MAIN_CE_H, BF16, False),             # no float16 kernel
    ("cuda", F16, MAIN_CE_H, F16, False),
    ("cuda", BF16, MAIN_CE_H, F32, False),             # mixed dtypes
    ("cuda", F32, MAIN_CE_H, BF16, False),
    ("cuda", BF16, 2816, BF16, True),                  # max_hidden(bf16)
    ("cuda", BF16, 2817, BF16, False),
    ("cuda", F32, 2496, F32, True),                    # max_hidden(f32)
    ("cuda", F32, 2497, F32, False),
    ("cuda", BF16, 2048, BF16, True),                  # gpt_1p3b's hidden
    ("cpu", BF16, MAIN_CE_H, BF16, False)])
def test_fused_ce_gate(device, dtype, h, w_dtype, want):
    assert fused_ce.fused_ce_gate(device, dtype, h, w_dtype) is want


@pytest.mark.parametrize("dtype,h", [(BF16, MAIN_CE_H), (F32, 2496),
                                     (BF16, 2816), (BF16, 1024)])
def test_the_ce_gate_admits_only_what_bwd_route_takes(dtype, h):
    assert fused_ce.fused_ce_gate("cuda", dtype, h, dtype)
    assert fused_ce.bwd_route(dtype, h) in ("tiled", "staged")
    assert not fused_ce.fused_ce_gate("cuda", dtype, fused_ce.max_hidden(
        dtype) + 1, dtype)
    with pytest.raises(ValueError):
        fused_ce.bwd_route(dtype, fused_ce.max_hidden(dtype) + 1)


def test_fused_ce_supported_reads_the_weight_dtype():
    hid = torch.zeros(4, 32, dtype=BF16)
    assert not fused_ce.fused_ce_supported(hid, torch.zeros(32, 8))
    assert not fused_ce.fused_ce_supported(hid, torch.zeros(32, 8,
                                                            dtype=BF16))


def test_auto_on_a_float16_input_counts_a_fallback_and_runs_chunked():
    rs = np.random.RandomState(0)
    hid = torch.from_numpy(rs.randn(16, 32).astype(np.float32)).to(F16)
    w = torch.from_numpy((rs.randn(32, 50) * 0.1).astype(np.float32)).to(F16)
    lbl = torch.from_numpy(rs.randint(0, 50, 16))
    n0 = tuner.FALLBACKS["fused_ce"]
    auto = F.fused_linear_cross_entropy(hid, w, lbl, kernel="auto")
    assert tuner.FALLBACKS["fused_ce"] == n0 + 1
    chunked = F.fused_linear_cross_entropy(hid, w, lbl, kernel="chunked")
    assert torch.equal(auto, chunked)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF16, 64, True, "mma"),        # the main path: GPT-base heads
    (BF16, 128, True, "mma"),       # gpt_1p3b's heads
    (BF16, 256, True, "scalar"),    # no D = 256 instance of the mma kernel
    (BF16, 64, False, "scalar"),    # rows off 16-byte boundaries
    (BF16, 128, False, "scalar"),
    (F32, 64, True, "scalar"),      # float32 keeps its exact FMAs
    (F32, 128, True, "scalar"),
    (F32, 256, False, "scalar")])
def test_fwd_route(dtype, d, aligned, want):
    assert fa.fwd_route(dtype, d, aligned) == want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF16, 64, True, "mma"),        # the main path: GPT-base heads
    (BF16, 128, True, "mma"),       # gpt_1p3b's heads
    (BF16, 256, True, "scalar"),    # no D = 256 instance of the mma kernels
    (BF16, 64, False, "scalar"),    # rows (do's too) off 16-byte boundaries
    (BF16, 128, False, "scalar"),
    (F32, 64, True, "scalar"),      # float32 keeps its exact FMAs
    (F32, 128, True, "scalar"),
    (F32, 256, False, "scalar"),
    (F16, 64, True, "scalar")])     # no float16 kernel (the gate sends it
def test_bwd_route(dtype, d, aligned, want):    # to the plain path first)
    assert fa.bwd_route(dtype, d, aligned) == want


def test_routes_count_every_kernel_on_each_route():
    assert set(fa.ROUTES) == {"flash_fwd_mma", "flash_fwd_scalar",
                              "flash_dq_mma", "flash_dq_scalar",
                              "flash_dkv_mma", "flash_dkv_scalar"}


@pytest.mark.parametrize("route", [None, "mma", "scalar"])
def test_the_backward_on_cpu_tensors_takes_the_plain_version(route):
    rs = np.random.RandomState(3)
    q, k, v, do = [torch.from_numpy(rs.randn(2, 40, 2, 64).astype(np.float32))
                   .to(BF16) for _ in range(4)]
    blocks = fa.keying_blocks(BF16, 64, 40, 40)
    out, lse = fa.flash_attention_plain_fwd(q, k, v, None, 0, None, True, 0.0,
                                            blocks)
    n0, r0 = dict(fa.LAUNCHES), dict(fa.ROUTES)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, None, 0, None, True,
                                 0.0, blocks, route=route)
    want = fa.flash_attention_plain_bwd(q, k, v, out, lse, do, None, 0, None,
                                        True, 0.0, blocks)
    assert fa.LAUNCHES == n0 and fa.ROUTES == r0
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w)


def test_row_alignment_of_the_qkv_split_and_of_odd_views():
    qkv = torch.zeros(2, 128, 4, 3 * 64, dtype=BF16)
    q, k, v = torch.split(qkv, 64, dim=-1)
    assert fa._rows_aligned(q, k, v)                   # the main path's views
    assert fa.fwd_route(BF16, 64, fa._rows_aligned(q, k, v)) == "mma"
    shifted = qkv[..., 1:65]                           # starts 2 bytes in
    assert not fa._rows_aligned(shifted)
    odd = torch.zeros(2, 128, 4, 68, dtype=BF16)[..., :64]   # h stride 68
    assert not fa._rows_aligned(odd)
    assert fa.fwd_route(BF16, 64, fa._rows_aligned(odd)) == "scalar"


def test_row_alignment_of_the_backward_counts_do():
    qkv = torch.zeros(2, 128, 4, 3 * 64, dtype=BF16)
    q, k, v = torch.split(qkv, 64, dim=-1)
    do = torch.zeros(2, 128, 4, 64, dtype=BF16)
    assert fa.bwd_route(BF16, 64, fa._rows_aligned(q, k, v, do)) == "mma"
    odd_do = torch.zeros(2, 128, 4, 68, dtype=BF16)[..., :64]
    assert fa._rows_aligned(q, k, v) and not fa._rows_aligned(q, k, v,
                                                                odd_do)
    assert fa.bwd_route(BF16, 64, fa._rows_aligned(q, k, v, odd_do)) == \
        "scalar"
    shifted_do = torch.zeros(2 * 128 * 4 * 64 + 1, dtype=BF16)[1:].view(
        2, 128, 4, 64)                                  # starts 2 bytes in
    assert not fa._rows_aligned(q, k, v, shifted_do)
