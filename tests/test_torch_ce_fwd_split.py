"""The tiled fused-CE forward's route, its split rule and a plain model of
its split-and-merge, against the JAX package, on the CPU.

The kernel (``csrc/fused_ce.cu`` ``ce_fwd_tiled_kernel`` and
``ce_fwd_merge_kernel``) runs only on the card; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold it against its plain version
there. Here ``fused_ce_plain_fwd_split`` (per split the max, the sum and
the label's logit over whole 128-column vocab tiles, the splits merged in
increasing order, as the kernel does) goes through the same numpy inputs
as the reference's ``fused_lm_ce`` in Pallas interpret mode (the loss) and
the port's ``fused_ce_plain_fwd`` (lse and tgt), in float32, at rtol 1e-6
and atol 1e-5 (sums in other orders).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ce as ref_fc

from paddle_tpu_torch.ops import fused_ce

RTOL, ATOL = 1e-6, 1e-5
H100_SMS = 132
CSRC = Path(fused_ce.__file__).resolve().parent.parent / "csrc" / "fused_ce.cu"


# -- the route, a pure function of (dtype, H) --------------------------------

@pytest.mark.parametrize("dtype,h,route", [
    (torch.bfloat16, 64, "tiled"), (torch.bfloat16, 768, "tiled"),
    (torch.bfloat16, 1024, "tiled"), (torch.bfloat16, 2048, "tiled"),
    (torch.bfloat16, 32, "staged"), (torch.bfloat16, 800, "staged"),
    (torch.float32, 64, "staged"), (torch.float32, 768, "staged"),
    (torch.float32, 2048, "staged")])
def test_forward_route_by_dtype_and_hidden(dtype, h, route):
    assert fused_ce.fwd_route(dtype, h) == route


@pytest.mark.parametrize("h", [64, 768])
def test_forward_route_refuses_other_dtypes(h):
    with pytest.raises(ValueError, match="fused_ce kernel"):
        fused_ce.fwd_route(torch.float16, h)


def test_the_main_path_and_gpt_1p3b_take_the_tiled_forward():
    """bench.py's fused_b8_pallas_ce (GPT-base, H 768) and gpt_1p3b's
    width (H 2048), both in bf16."""
    for h in (768, 2048):
        assert fused_ce.fwd_route(torch.bfloat16, h) == "tiled"


def test_the_tiles_match_the_kernel_source():
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (FT_\w+|kThreads) = ([^;]+);",
                             src))
    assert int(consts["kThreads"]) // 32 * 16 == fused_ce.FWD_TILE_TOKENS
    assert consts["FT_BT"] == "16 * kWarps"
    assert int(consts["FT_BV"]) == fused_ce.FWD_TILE_VOCAB
    assert int(consts["FT_KC"]) == fused_ce.FWD_CHUNK
    # two blocks an SM, as the split rule assumes
    assert "__launch_bounds__(kThreads, 2)\n    ce_fwd_tiled_kernel" in src
    assert fused_ce.FWD_BLOCKS_PER_SM == 2


# -- the split rule -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 129, 1000, 8192, 65536])
@pytest.mark.parametrize("v", [1, 128, 500, 700, 5003, 50304])
@pytest.mark.parametrize("sms", [1, 132])
def test_no_split_is_empty(n, v, sms):
    s = fused_ce.fwd_splits(n, v, sms)
    tiles = -(-v // fused_ce.FWD_TILE_VOCAB)
    assert 1 <= s <= tiles
    runs = [(k + 1) * tiles // s - k * tiles // s for k in range(s)]
    assert sum(runs) == tiles and min(runs) >= 1
    if s > 1:
        assert min(runs) >= fused_ce.FWD_MIN_SPLIT_TILES


def test_the_main_call_fills_two_blocks_per_sm():
    """N 8192 (64 token tiles), V 50304 on a 132-SM card: the most splits
    that keep the grid within one wave of two blocks an SM."""
    tiles = 8192 // fused_ce.FWD_TILE_TOKENS
    s = fused_ce.fwd_splits(8192, 50304, H100_SMS)
    assert s == 4
    assert tiles * s <= 2 * H100_SMS < tiles * (s + 1)
    assert tiles * s >= 0.9 * 2 * H100_SMS


@pytest.mark.parametrize("n", [1, 100, 300, 8192])
@pytest.mark.parametrize("v", [1, 128, 500, 700])
def test_a_tiny_vocabulary_takes_one_split(n, v):
    assert fused_ce.fwd_splits(n, v, H100_SMS) == 1


def test_many_tokens_take_one_split():
    assert fused_ce.fwd_splits(2 * H100_SMS * 128, 50304, H100_SMS) == 1


# -- the plain model of the split-and-merge ----------------------------------

def _data(n, h, v, seed, ignore=0.0, out_of_range=(), all_ignored=False):
    rs = np.random.RandomState(seed)
    hid = rs.randn(n, h).astype(np.float32)
    w = (rs.randn(h, v) * 0.05).astype(np.float32)
    y = rs.randint(0, v, n).astype(np.int32)
    if ignore:
        y[rs.rand(n) < ignore] = -100
    for i, bad in enumerate(out_of_range):
        y[1 + i::7] = bad
    if all_ignored:
        y[:] = -100
    return hid, w, y


def _padded_vocab(n, h, v):
    """The reference's vocabulary padded to its block (the labels past it
    match no column there)."""
    _, bv = fused_ce.resolve_blocks(torch.float32, n, h, v)
    return -(-v // bv) * bv


def _loss(lse, tgt, y):
    valid = torch.from_numpy(y != -100).float()
    return float((valid * (lse - tgt)).sum() / valid.sum().clamp(min=1.0))


def _ref_loss(hid, w, y):
    return float(ref_fc.fused_lm_ce(jnp.asarray(hid), jnp.asarray(w),
                                    jnp.asarray(y), interpret=True))


SPLIT_CASES = [
    # (n, h, v, splits, ignore, all_ignored)
    ((64, 32, 500), 1, 0.0, False),       # V tail, one split
    ((64, 32, 500), 2, 0.3, False),       # two splits of two tiles
    ((64, 32, 512), 4, 0.3, False),       # one tile a split
    ((40, 64, 700), 3, 0.0, False),       # V tail in the last split
    ((130, 48, 1000), 8, 0.2, False),     # one tile a split, V tail
    ((64, 32, 300), 3, 0.0, True),        # every row ignored
]


@pytest.mark.parametrize("shape,splits,ignore,all_ignored", SPLIT_CASES)
def test_split_model_matches_the_reference(shape, splits, ignore,
                                           all_ignored):
    hid, w, y = _data(*shape, seed=sum(shape) + splits, ignore=ignore,
                      all_ignored=all_ignored)
    args = (torch.from_numpy(hid), torch.from_numpy(w), torch.from_numpy(y))
    lse, tgt = fused_ce.fused_ce_plain_fwd_split(*args, splits)
    want_lse, want_tgt = fused_ce.fused_ce_plain_fwd(*args)
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tgt, want_tgt, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_loss(lse, tgt, y), _ref_loss(hid, w, y),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_model_labels_out_of_range_give_a_zero_target(splits):
    """Labels -5 and past the reference's padded vocabulary: target logit
    0 in both, the row counted in the mean."""
    n, h, v = 96, 32, 500
    far = _padded_vocab(n, h, v) + 7
    hid, w, y = _data(n, h, v, seed=11, ignore=0.2, out_of_range=(-5, far))
    args = (torch.from_numpy(hid), torch.from_numpy(w), torch.from_numpy(y))
    lse, tgt = fused_ce.fused_ce_plain_fwd_split(*args, splits)
    want_lse, want_tgt = fused_ce.fused_ce_plain_fwd(*args)
    bad = torch.from_numpy((y == -5) | (y == far))
    assert bad.sum() > 0 and (tgt[bad] == 0).all()
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tgt, want_tgt, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_loss(lse, tgt, y), _ref_loss(hid, w, y),
                               rtol=RTOL, atol=ATOL)


def test_a_label_in_the_references_vocab_padding_is_where_the_two_differ():
    """A label in [V, padded V) picks one of the reference's padded
    columns, whose logit is its finite NEG_INF, so the reference's loss
    is about 1e30 / rows; the port reads every label outside [0, V) as a
    target logit of 0, as the rest of the port and its kernels do."""
    n, h, v = 16, 32, 500
    assert _padded_vocab(n, h, v) > v + 3
    hid, w, y = _data(n, h, v, seed=3, out_of_range=(v + 3,))
    args = (torch.from_numpy(hid), torch.from_numpy(w), torch.from_numpy(y))
    lse, tgt = fused_ce.fused_ce_plain_fwd_split(*args, 2)
    assert (tgt[torch.from_numpy(y == v + 3)] == 0).all()
    assert _loss(lse, tgt, y) < 100.0
    assert _ref_loss(hid, w, y) > 1e20


def test_split_model_refuses_an_empty_split():
    hid, w, y = _data(8, 32, 300, seed=0)
    args = (torch.from_numpy(hid), torch.from_numpy(w), torch.from_numpy(y))
    with pytest.raises(ValueError, match="splits"):
        fused_ce.fused_ce_plain_fwd_split(*args, 4)      # 3 vocab tiles
    with pytest.raises(ValueError, match="splits"):
        fused_ce.fused_ce_plain_fwd_split(*args, 0)
