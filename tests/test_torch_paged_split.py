"""The paged split route's plan, its route and split rule, against the JAX
package, on the CPU.

The kernels (``csrc/paged_attention.cu`` ``paged_split_kernel`` and
``paged_merge_kernel``) run only on the card; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against the plain version
there. Here ``paged_attention_split_plain`` (each row's pages cut into
``splits`` runs of whole pages, per split the max, sum and unnormalized
acc, the splits merged in the order 0..splits-1, as the kernel pair does)
goes through the same numpy inputs as the reference's ``_run_paged_kernel``
in Pallas interpret mode and the port's ``paged_attention_plain``.
Tolerance: float32 ``rtol=1e-5, atol=1e-6`` (tests/test_torch_paged_attention.py)
on m, on l and on acc / l, the normalized output the epilogue forms. The
raw acc is unnormalized: it grows with l (here up to ~10 at 96 keys), and
so does the rounding of its sum, which reaches 1e-6 absolute between the
reference and either PyTorch version alike. bfloat16 pools hold the same
bar: every version upcasts the same bfloat16 values exactly and does
float32 math.
"""
import functools
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

F32 = dict(rtol=1e-5, atol=1e-6)
H100_SMS = 132
PS, WIDTH, POOL = 16, 6, 24
# empty row, one key, page tail, exact page, one past a page, the table's
# capacity, past capacity (capped)
LENS = [0, 1, 15, 16, 17, WIDTH * PS, WIDTH * PS + 34]
CSRC = (Path(tpa.__file__).resolve().parent.parent / "csrc" /
        "paged_attention.cu")


@functools.lru_cache(maxsize=None)
def _case(tq, bf16):
    """q, pools, tables with sentinel slots (-1 / POOL+7) past each row's
    pages, lens; pools rounded to bf16 when asked (both sides read the
    same values)."""
    rs = np.random.RandomState(100 + tq)
    b, h, d = len(LENS), 2, 32
    q = rs.randn(b, tq, h, d).astype(np.float32)
    kp = rs.randn(POOL, PS, h, d).astype(np.float32)
    vp = rs.randn(POOL, PS, h, d).astype(np.float32)
    if bf16:
        kp = np.asarray(jnp.asarray(kp, jnp.bfloat16), np.float32)
        vp = np.asarray(jnp.asarray(vp, jnp.bfloat16), np.float32)
    tables = np.stack([rs.permutation(POOL)[:WIDTH]
                       for _ in range(b)]).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    for i, n in enumerate(lens):
        used = -(-min(int(n), WIDTH * PS) // PS)
        tables[i, used:] = -1 if i % 2 else POOL + 7
    return q, kp, vp, tables, lens


@functools.lru_cache(maxsize=None)
def _jax_raw(tq, bf16):
    """The JAX kernel's raw (acc, m, l), TPU padding sliced away."""
    q, kp, vp, tables, lens = _case(tq, bf16)
    b, _, h, d = q.shape
    rows = max(jpa.DEFAULT_Q_PAD, jpa.verify_rows(tq))
    qhp = jnp.pad(jnp.transpose(jnp.asarray(q), (0, 2, 1, 3)),
                  ((0, 0), (0, 0), (0, rows - tq), (0, 0)))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    kern = jpa._paged_decode_kernel if tq == 1 else jpa._paged_verify_kernel
    acc, m, l = jpa._run_paged_kernel(
        kern, qhp, jnp.asarray(kp, dt), jnp.asarray(vp, dt),
        jnp.asarray(tables), jnp.asarray(lens), 1.0 / math.sqrt(d),
        interpret=True)
    return (np.asarray(acc)[:, :, :tq], np.asarray(m)[:, :, :tq, 0],
            np.asarray(l)[:, :, :tq, 0])


def _stats(acc, m, l):
    """(acc / l, m, l) as numpy: acc normalized where l > 0."""
    acc, m, l = (np.asarray(t) for t in (acc, m, l))
    return acc / np.where(l == 0, 1, l)[..., None], m, l


def _torch_args(tq, bf16):
    q, kp, vp, tables, lens = _case(tq, bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    return (torch.from_numpy(q), torch.from_numpy(kp).to(dt),
            torch.from_numpy(vp).to(dt), torch.from_numpy(tables),
            torch.from_numpy(lens))


# -- the plan against the reference and the plain version --------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tq", [1, 5, 8, 32])
@pytest.mark.parametrize("splits", [1, 2, 3, WIDTH, WIDTH + 3])
def test_split_plan_matches_jax_kernel_and_plain(splits, tq, bf16):
    args = _torch_args(tq, bf16)
    got = tpa.paged_attention_split_plain(*args, splits)
    want = _jax_raw(tq, bf16)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
    plain = _stats(*tpa.paged_attention_plain(*args))
    for name, g, w, p in zip(("acc / l", "m", "l"), _stats(*got),
                             _stats(*want), plain):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
        np.testing.assert_allclose(g, p, err_msg=name, **F32)
    # the empty row: every split empty, m = NEG_INF, l = 0, acc = 0 (the
    # merge's alpha = exp(0) = 1 multiplies zeros)
    assert (got[1][0] == tpa.NEG_INF).all()
    assert float(got[2][0].abs().max()) == 0.0
    assert float(got[0][0].abs().max()) == 0.0


@pytest.mark.parametrize("splits", [2, 3, WIDTH + 3])
def test_empty_splits_underflow_in_the_merge(splits):
    """Rows with one page leave splits 1.. empty: their alpha must
    underflow to 0, so the result equals the one-split plan's."""
    args = list(_torch_args(1, False))
    args[4] = torch.tensor([1, 15, 16, 9, 3, 16, 2], dtype=torch.int32)
    one = tpa.paged_attention_split_plain(*args, 1)
    many = tpa.paged_attention_split_plain(*args, splits)
    for a, b in zip(one, many):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **F32)
    assert torch.equal(one[1], many[1])          # the max is order-free


def test_split_plan_rejects_no_split():
    with pytest.raises(ValueError):
        tpa.paged_attention_split_plain(*_torch_args(1, False), 0)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    args = _torch_args(5, False)
    launches, routes = dict(tpa.LAUNCHES), dict(tpa.ROUTES)
    for kw in ({}, {"route": "split", "splits": 3}, {"route": "simple"}):
        got = tpa.paged_attention(*args, **kw)
        for g, w in zip(got, tpa.paged_attention_plain(*args)):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        tpa.paged_attention(*args, route="gather")
    assert tpa.LAUNCHES == launches and tpa.ROUTES == routes


# -- the split rule, a pure function of shapes --------------------------------

@pytest.mark.parametrize("b", [1, 2, 8, 64, 256])
@pytest.mark.parametrize("h", [1, 12, 16])
@pytest.mark.parametrize("width,ps", [(1, 16), (4, 8), (64, 16),
                                      (256, 16)])
@pytest.mark.parametrize("sms", [1, 132])
def test_every_split_has_a_page(b, h, width, ps, sms):
    s = tpa.paged_splits(b, h, width, ps, sms)
    assert 1 <= s <= width
    if s > 1:
        assert width * ps // s >= tpa.MIN_SPLIT_KEYS
        # the grid stays within the target blocks an SM
        assert b * h * s <= tpa.SPLIT_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("b,h", [(23, 12), (44, 12), (528, 1), (8, 132)])
def test_one_split_when_the_rows_fill_the_card(b, h):
    """Two splits would pass four blocks an SM."""
    assert 2 * b * h > tpa.SPLIT_BLOCKS_PER_SM * H100_SMS
    assert tpa.paged_splits(b, h, 64, 16, H100_SMS) == 1


def test_the_main_shape_splits():
    """B 8, H 12 (96 row-heads) over 132 SMs: five splits, 480 blocks, the
    most within four blocks an SM (528); B 1 is capped by MIN_SPLIT_KEYS
    (1024 keys / 64)."""
    assert tpa.paged_splits(8, 12, 64, 16, H100_SMS) == 5
    assert 8 * 12 * 5 <= tpa.SPLIT_BLOCKS_PER_SM * H100_SMS < 8 * 12 * 6
    assert tpa.paged_splits(1, 12, 64, 16, H100_SMS) == 16


def test_splits_fall_as_the_batch_grows():
    got = [tpa.paged_splits(b, 12, 64, 16, H100_SMS) for b in range(1, 80)]
    assert all(a >= b for a, b in zip(got, got[1:]))


# -- the route, a pure function of (dtype, head dim, alignment) ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_every_gated_shape_takes_the_split_route_when_aligned(dtype, d):
    assert tpa.paged_route(dtype, d, True) == "split"
    assert tpa.paged_route(dtype, d, False) == "simple"


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.float32, 48),
                                     (torch.bfloat16, 512)])
def test_route_refuses_what_neither_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        tpa.paged_route(dtype, d, True)


def test_the_kernel_source_has_the_split_pair_and_no_atomics():
    src = CSRC.read_text()
    for name in ("paged_split_kernel", "paged_merge_kernel",
                 "paged_attention_kernel", "cp_async16",
                 "paged_attention_split_fwd"):
        assert name in src, name
    # no atomic operation (atomicAdd and kin, PTX atom./red.)
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", src)
