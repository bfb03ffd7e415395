"""The port's transformer layers (``nn/layers/transformer.py``) and MT
models (``text/models/transformer.py``) against the JAX package's.

Tiny widths (d_model 32, 4 heads, d_ff 64, depth 2, vocabulary 20,
dropout 0), the reference's weights carried over by name, the same numpy
inputs from a seed, float32: rtol 1e-5 and atol 2e-6 for the layers and
the model's logits (LayerNorm and softmax over sums in another order),
gradients through ``jax.grad`` within rtol 1e-4, atol 1e-6.

- ``MultiHeadAttention`` with no mask, an additive 4-D mask, a 3-D mask
  (broadcast over the heads), a boolean mask and ``kdim``/``vdim``;
  incremental decoding through ``gen_cache`` step by step; the encoder and
  decoder layers with ``normalize_before`` both ways, the stacks, the
  decoder's cached decoding (``Cache`` and ``StaticCache``), ``Transformer``
  and ``generate_square_subsequent_mask``.
- ``TransformerModel`` with and without ``weight_sharing``: logits,
  gradients, one flash fallback counted per attention call (every mask is
  dense, as in the reference); ``InferTransformerModel``'s beam search:
  ids equal, scores within 1e-5; ``jit.save``/``jit.load`` of the model.
- The golden (``testdata/mt_golden.json``): the port at the golden's
  depth, on the CPU, against the file with the bars ``chip_smoke.py``
  holds the card to (the step-0 loss and gradient norm rtol 1e-4, later
  losses 1e-3, the beam ids equal and scores 1e-4), for the MT model and
  the PTB LSTM.
- The copy task (``slow``, as the reference marks it): 150 Adam steps,
  then the best beam reproduces more than 90% of the source.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.jit.functionalization import functional_call, state_of

import chip_smoke
import paddle_tpu.text.models  # noqa: F401  (pd.text.models below)
import paddle_tpu_torch.text.models  # noqa: F401

RS = np.random.RandomState(21)
D, NH, FF, V = 32, 4, 64, 20
RTOL, ATOL = 1e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the goldens' 37,000- and 10,000-word heads
    oversubscribe the CPU when every test worker takes all its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _carry(rl, pl):
    pl.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rl.state_dict().items()})
    rl.eval()
    pl.eval()
    return rl, pl


def _pair(build):
    ref.seed(0)
    return _carry(build(ref), build(port))


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _x(*shape):
    return RS.randn(*shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


MASKS = {
    "none": lambda: None,
    "additive_4d": lambda: np.where(RS.rand(2, 1, 5, 5) > 0.3, 0.0,
                                    -1e9).astype(np.float32),
    "batch_3d": lambda: np.where(RS.rand(2, 5, 5) > 0.3, 0.0,
                                 -1e9).astype(np.float32),
    "heads_3d": lambda: np.where(RS.rand(NH, 5, 5) > 0.3, 0.0,
                                 -1e9).astype(np.float32),
    "bool": lambda: RS.rand(2, 1, 5, 5) > 0.3}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_multi_head_attention(mask):
    rm, pm = _pair(lambda pd: pd.nn.MultiHeadAttention(D, NH))
    q = _x(2, 5, D)
    m = MASKS[mask]()
    rmask, pmask = _both(m) if m is not None else (None, None)
    _close(pm(torch.from_numpy(q), attn_mask=pmask),
           rm(jnp.asarray(q), attn_mask=rmask))


def test_cross_attention_with_kdim_vdim():
    rm, pm = _pair(lambda pd: pd.nn.MultiHeadAttention(D, NH, kdim=12,
                                                       vdim=6))
    q, k, v = _x(2, 5, D), _x(2, 7, 12), _x(2, 7, 6)
    _close(pm(*map(torch.from_numpy, (q, k, v))),
           rm(*map(jnp.asarray, (q, k, v))))


def test_incremental_decode_through_the_cache():
    rm, pm = _pair(lambda pd: pd.nn.MultiHeadAttention(D, NH))
    seq = _x(2, 4, D)
    rc = rm.gen_cache(jnp.asarray(seq[:, :1]))
    pc = pm.gen_cache(torch.from_numpy(seq[:, :1]))
    assert pc[0].shape == (2, 0, NH, D // NH)
    for t in range(4):
        rq, pq = _both(seq[:, t:t + 1])
        r_out, rc = rm(rq, rq, rq, None, rc)
        p_out, pc = pm(pq, pq, pq, None, pc)
        _close(p_out, r_out)
        _close(pc, rc)
    static = pm.gen_cache(torch.from_numpy(seq),
                          type=port.nn.MultiHeadAttention.StaticCache)
    _close(static, rm.gen_cache(jnp.asarray(seq),
                                type=ref.nn.MultiHeadAttention.StaticCache))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_and_decoder_stacks(normalize_before):
    def build(pd):
        kw = dict(dropout=0.0, normalize_before=normalize_before)
        enc = pd.nn.TransformerEncoder(pd.nn.TransformerEncoderLayer(
            D, NH, FF, **kw), 2, pd.nn.LayerNorm(D))
        dec = pd.nn.TransformerDecoder(pd.nn.TransformerDecoderLayer(
            D, NH, FF, activation="gelu", **kw), 2)
        return pd.nn.LayerList([enc, dec])
    rm, pm = _pair(build)
    src, tgt = _x(2, 6, D), _x(2, 4, D)
    smask = np.where(RS.rand(2, 1, 1, 6) > 0.2, 0.0, -1e9).astype(
        np.float32)
    tmask = np.array(ref.nn.Transformer.generate_square_subsequent_mask(4))
    _close(port.nn.Transformer.generate_square_subsequent_mask(4), tmask)
    r_mem = jax.jit(rm[0])(jnp.asarray(src), jnp.asarray(smask))
    p_mem = pm[0](torch.from_numpy(src), torch.from_numpy(smask))
    _close(p_mem, r_mem)
    args = [tmask, smask]
    _close(pm[1](torch.from_numpy(tgt), p_mem,
                 *map(torch.from_numpy, args)),
           jax.jit(rm[1])(jnp.asarray(tgt), r_mem, *map(jnp.asarray, args)))
    # cached decoding, one target position at a time
    rc, pc = rm[1].gen_cache(r_mem), pm[1].gen_cache(p_mem)
    r_step = jax.jit(lambda q, c: rm[1](q, r_mem, None, jnp.asarray(smask),
                                        c))
    for t in range(4):
        rq, pq = _both(tgt[:, t:t + 1])
        r_out, rc = r_step(rq, rc)
        p_out, pc = pm[1](pq, p_mem, None, torch.from_numpy(smask), pc)
        _close(p_out, r_out)


def test_transformer():
    rm, pm = _pair(lambda pd: pd.nn.Transformer(
        D, NH, 2, 2, FF, dropout=0.0, normalize_before=True))
    src, tgt = _x(2, 6, D), _x(2, 4, D)
    tmask = np.array(ref.nn.Transformer.generate_square_subsequent_mask(4))
    _close(pm(torch.from_numpy(src), torch.from_numpy(tgt),
              tgt_mask=torch.from_numpy(tmask)),
           rm(jnp.asarray(src), jnp.asarray(tgt), tgt_mask=jnp.asarray(
               tmask)))


def _mt(pd, cls="TransformerModel", **kw):
    return getattr(pd.text.models, cls)(
        V, V, max_length=32, num_encoder_layers=2, num_decoder_layers=2,
        n_head=NH, d_model=D, d_inner_hid=FF, dropout=0.0, bos_id=0,
        eos_id=1, **kw)


def _mt_batch():
    src = RS.randint(2, V, (3, 7)).astype(np.int32)
    src[0, 5:] = 0
    trg = RS.randint(2, V, (3, 5)).astype(np.int32)
    return src, trg, RS.randint(2, V, (3, 5)).astype(np.int32)


@pytest.mark.parametrize("sharing", [False, True])
def test_transformer_model_logits_gradients_and_fallbacks(sharing):
    from paddle_tpu_torch.ops import tuner
    rm, pm = _pair(lambda pd: _mt(pd, weight_sharing=sharing))
    assert (pm.trg_emb is pm.src_emb) == sharing
    src, trg, lbl = _mt_batch()
    fb0 = tuner.FALLBACKS["flash_attention"]
    logits = pm(torch.from_numpy(src), torch.from_numpy(trg))
    assert tuner.FALLBACKS["flash_attention"] - fb0 == 3 * 2
    _close(logits, rm(jnp.asarray(src), jnp.asarray(trg)))
    params, buffers = state_of(rm)
    grads = jax.jit(jax.grad(lambda p: ref.nn.functional.cross_entropy(
        functional_call(rm, p, buffers, jnp.asarray(src),
                        jnp.asarray(trg))[0], jnp.asarray(lbl))))(params)
    port.nn.functional.cross_entropy(logits, torch.from_numpy(lbl)) \
        .backward()
    names = [n for n, _ in pm.named_parameters()]
    assert sorted(names) == sorted(grads)
    for name, p in pm.named_parameters():
        _close(p.grad, grads[name], rtol=1e-4, atol=1e-6)


def test_infer_transformer_model_beam_search():
    rm, pm = _pair(lambda pd: _mt(pd, "InferTransformerModel",
                                  weight_sharing=True, beam_size=3,
                                  max_out_len=6))
    src, _, _ = _mt_batch()
    r_ids, r_scores = rm(jnp.asarray(src))
    with torch.no_grad():
        p_ids, p_scores = pm(torch.from_numpy(src))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))
    _close(p_scores, r_scores, atol=1e-5)
    assert pm.last_margins.shape == (6,)


def test_jit_save_load_mt(tmp_path):
    port.seed(0)
    m = _mt(port)
    m.eval()
    path = str(tmp_path / "mt" / "model")
    port.jit.save(m, path, input_spec=[
        port.jit.InputSpec([1, 7], dtype="int32"),
        port.jit.InputSpec([1, 5], dtype="int32")])
    loaded = port.jit.load(path, device="cpu")
    src = RS.randint(2, V, (1, 7)).astype(np.int32)
    trg = RS.randint(2, V, (1, 5)).astype(np.int32)
    with torch.no_grad():
        want = m(torch.from_numpy(src), torch.from_numpy(trg))
    _close(loaded(src, trg), want, rtol=1e-5, atol=1e-6)


def _golden_mods():
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import engine, mesh
    return optimizer, engine, mesh, nn


def test_mt_golden_on_the_cpu():
    optimizer, engine, mesh, nn = _golden_mods()
    out = chip_smoke.mt_golden(optimizer, engine, mesh, port.text.models, nn,
                               device="cpu")
    assert out["beam"]["ids_equal"]


def test_ptb_golden_on_the_cpu():
    optimizer, engine, mesh, nn = _golden_mods()
    out = chip_smoke.ptb_golden(optimizer, engine, mesh, nn, port,
                                device="cpu")
    assert max(out["loss_rel_err"]) <= 1e-3


@pytest.mark.slow
def test_copy_task_trains_and_beam_decodes():
    from paddle_tpu_torch import framework, optimizer
    out = chip_smoke.mt_copy_task(optimizer, port.text.models, framework,
                                  device="cpu")
    assert out["token_accuracy"] > 0.9
