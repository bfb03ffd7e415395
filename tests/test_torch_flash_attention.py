"""Flash attention in the PyTorch port against the JAX package, on the CPU.

The port's plain versions (what its CUDA kernels compute; the wrapper
takes them for CPU tensors) are held against
``paddle_tpu.ops.pallas.flash_attention.flash_attention(..., interpret=True)``
and its ``jax.vjp`` on the same numpy inputs with a fixed cotangent: out,
dq, dk, dv, and lse against the reference's ``_fwd`` (its stat lanes
sliced to one). Tolerances: float32 atol = rtol = 2e-5 (full-row softmax
vs the reference's blockwise online softmax, sums in different orders);
bfloat16 2e-2 (one bfloat16 rounding of outputs and gradients). The
dropout mask is held bit-for-bit against the reference's ``_dropout_mask``.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as ref_attention
from paddle_tpu.ops.pallas import tuner as ref_tuner
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tuner
from torch_threads import two_threads  # noqa: F401

R = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _inputs(s, d, b=2, h=2, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _ref_blocks(dtype, d, s):
    """The reference wrapper's blocks for a call: its tuning-DB resolution,
    then its clamp on the 128-padded length."""
    cfg, _ = ref_tuner.resolve("flash_attention", dtype,
                               ref_tuner.flash_dims(d, s, s),
                               {"block_q": R.DEFAULT_BLOCK_Q,
                                "block_k": R.DEFAULT_BLOCK_K})
    pad = -(-s // R.LANES) * R.LANES

    def clamp(block):
        bb = (min(block, pad) // R.LANES) * R.LANES
        while bb > R.LANES and pad % bb:
            bb -= R.LANES
        return bb

    return clamp(cfg["block_q"]), clamp(cfg["block_k"])


def _ref_lse(q, k, v, causal, kv_lens, rate, seed):
    """The reference wrapper's preamble, then its ``_fwd``: lse (B, H, S)."""
    b, sq, h, d = q.shape
    blocks = _ref_blocks(q.dtype, d, sq)
    pad = -(-sq // R.LANES) * R.LANES

    def bhsd(x):
        x = jnp.pad(x, ((0, 0), (0, pad - sq), (0, 0), (0, 0)))
        return jnp.reshape(jnp.swapaxes(x, 1, 2), (b * h, pad, d))

    lens = (jnp.full((b,), sq, jnp.int32) if kv_lens is None else
            jnp.minimum(jnp.asarray(kv_lens, jnp.int32), sq))
    seed_arr = jnp.asarray([0 if seed is None else seed], jnp.int32)
    _, lse = R._fwd(bhsd(q), bhsd(k), bhsd(v), jnp.repeat(lens, h), seed_arr,
                    1.0 / math.sqrt(d), causal, blocks[0], blocks[1],
                    pad != sq or kv_lens is not None, rate, interpret=True)
    return np.asarray(lse[..., 0]).reshape(b, h, pad)[:, :, :sq]


def _run_both(s, d, causal, kv_lens=None, rate=0.0, seed=None,
              dtype="float32"):
    q, k, v, do = _inputs(s, d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv, jdo = [jnp.asarray(x, jdt) for x in (q, k, v, do)]
    f = lambda q_, k_, v_: R.flash_attention(  # noqa: E731
        q_, k_, v_, causal=causal, kv_lens=kv_lens, dropout_rate=rate,
        dropout_seed=seed, interpret=True)
    out, vjp = jax.vjp(f, jq, jk, jv)
    ref = [out, *vjp(jdo)]
    tq, tk, tv = [torch.tensor(np.asarray(x.astype(jnp.float32)),
                               dtype=tdt).requires_grad_()
                  for x in (jq, jk, jv)]
    n0 = dict(fa.LAUNCHES)
    lens_t = None if kv_lens is None else torch.tensor(kv_lens)
    o = fa.flash_attention(tq, tk, tv, causal=causal, kv_lens=lens_t,
                           dropout_rate=rate, dropout_seed=seed)
    o.backward(torch.tensor(np.asarray(jdo.astype(jnp.float32)), dtype=tdt))
    assert fa.LAUNCHES == n0       # CPU tensors take the plain versions
    got = [o, tq.grad, tk.grad, tv.grad]
    tol = BF16 if dtype == "bfloat16" else F32
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   err_msg=name, **tol)
    if dtype != "bfloat16":
        lens_p = None if kv_lens is None else torch.tensor(kv_lens)
        blocks = fa.keying_blocks(tdt, d, s, s)
        _, lse = fa.flash_attention_plain_fwd(tq.detach(), tk.detach(),
                                              tv.detach(), lens_p,
                                              seed or 0, None, causal, rate,
                                              blocks)
        np.testing.assert_allclose(lse.numpy(),
                                   _ref_lse(jq, jk, jv, causal, kv_lens,
                                            rate, seed), **F32)


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_reference(d, causal, s):
    _run_both(s, d, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_lens_with_an_empty_row(causal):
    _run_both(200, 64, causal, kv_lens=[37, 0])


def test_dropout_keyed_on_the_tuning_db_blocks():
    # S=256 float32 d64: the DB row says 128/128, where the defaults would
    # clamp to 256/256; neither side is given explicit blocks
    assert fa.keying_blocks(torch.float32, 64, 256, 256) == (128, 128)
    _run_both(256, 64, True, rate=0.1, seed=7)


def test_bfloat16():
    _run_both(200, 64, True, kv_lens=[200, 37], dtype="bfloat16")


@pytest.mark.parametrize("rate,seed,blocks", [(0.1, 7, (128, 128)),
                                              (0.5, 123456789, (256, 512)),
                                              (0.0, 0, (128, 256))])
def test_dropout_mask_is_bit_equal_to_the_reference(rate, seed, blocks):
    bq, bk = blocks
    rows = torch.arange(2 * bq)
    cols = torch.arange(2 * bk)
    for bh in (0, 5, 95):
        got = fa.dropout_mask(rate, seed, bh, rows, cols, bq, bk).numpy()
        for iq in range(2):
            for ik in range(2):
                want = np.asarray(R._dropout_mask(
                    (bq, bk), rate, jnp.int32(seed), bh, iq, ik),
                    np.float32)
                blk = got[iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk]
                assert blk.dtype == want.dtype
                assert np.array_equal(blk.view(np.uint32),
                                      want.view(np.uint32)), (bh, iq, ik)


def test_keying_blocks_follow_the_reference_resolution():
    for dtype, tdt in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        for s in (128, 200, 256, 300, 512, 1024, 2048):
            assert fa.keying_blocks(tdt, 64, s, s) == \
                _ref_blocks(dtype, 64, s), (dtype, s)
    # the reference's six flash rows, in the port's shipped seed; no device
    # row is ever written for flash attention (its blocks key the mask)
    seed = tuner.TuningDB.load(tuner.default_db_path()).entries
    assert sum(k.startswith("flash_attention|") for k in seed) == 6
    assert all(k.startswith("flash_attention|any|") for k in seed
               if k.startswith("flash_attention|"))


def test_wrapper_edge_cases():
    q, k, v, _ = [torch.tensor(x) for x in _inputs(128, 64)]
    assert torch.equal(fa.flash_attention(q, k, v, dropout_rate=1.0),
                       torch.zeros_like(q))
    with pytest.raises(ValueError, match="dropout_rate"):
        fa.flash_attention(q, k, v, dropout_rate=-0.1)
    assert not fa.flash_supported(q, k)        # the gate needs the card


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_on_the_cpu_is_the_reference_plain_attention(causal):
    q, k, v, _ = _inputs(64, 32)
    lens = np.asarray([64, 20], np.int32)
    want = ref_attention.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal,
        kv_lens=lens)
    n0 = tuner.FALLBACKS["flash_attention"]
    got = port_attention.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), is_causal=causal,
        kv_lens=torch.tensor(lens))
    assert tuner.FALLBACKS["flash_attention"] == n0 + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
