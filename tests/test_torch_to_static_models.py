"""Whole models through the port's declarative mode, against the JAX
package.

- The reference's dy2static model tier (``tests/test_dy2static_models.py``,
  from the reference framework's dygraph_to_static suite): each model is
  written once in the API both packages share, the reference's weights
  are carried into the port, and two SGD steps through the port's staged
  graph (``jit.to_static``: the ``TracedLayer``'s graph, with autograd
  over its ATen ops) match two steps of the reference's converted model
  (under ``jax.jit``) — losses and a parameter within rtol 5e-4, atol
  5e-5 (the reference's tolerance). The ``slow`` marks are the
  reference's. Its Transformer (``TransformerModel``), seq2seq and PTB
  LSTM cases (``testdata/recipes.py``'s ``seq2seq`` and ``ptb_lm``, built
  by each package) are here too.
- The slice as a whole: GPT at depth 2 and narrow widths, its
  ``to_static`` forward against the reference's, and two training steps
  of a ``static.Program`` (the loss and the parameter gradients of
  ``fused_head_loss(ce_kernel="pallas")``, the fused-CE route's plain
  versions on the CPU, the parameters as graph inputs) with the port's
  AdamW against the reference's trainer: rtol 1e-4, as
  ``tests/test_torch_gpt_sweep.py`` holds the same loss.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu import autograd as ref_autograd

RS = np.random.RandomState(7)


def _carry(rm, pm):
    pm.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rm.state_dict().items()})


def _ref_convert(m):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return ref.jit.to_static(m).layer


def _ce(pd, logits, labels):
    logits = logits.reshape([-1, logits.shape[-1]])
    return pd.mean(pd.nn.functional.cross_entropy(
        logits, pd.cast(labels.reshape([-1]), "int64"), reduction="none"))


def _train_parity(build, loss_of, data, steps=2, lr=0.05, rtol=5e-4,
                  atol=5e-5, opt=None):
    """Losses and the first parameter after ``steps``: the reference's
    converted model (its loss and gradients under one ``jax.jit`` of
    ``functional_call``, its optimizer's ``apply_gradients``) against the
    port's staged graph (``loss.backward()`` through it, the eager
    optimizer)."""
    import jax
    from paddle_tpu.jit.functionalization import functional_call, state_of
    ref.seed(0)
    rm = build(ref)
    pm = build(port)
    _carry(rm, pm)
    rm = _ref_convert(rm)
    ropt = getattr(ref.optimizer, opt or "SGD")(lr)
    import paddle_tpu_torch.optimizer as poptim
    popt = getattr(poptim, opt or "SGD")(lr, parameters=pm.parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tl = port.jit.to_static(pm)
    params, buffers = state_of(rm)
    params = dict(params)

    def rloss(p, *d):
        def model(*a):
            return functional_call(rm, p, buffers, *a)[0]
        return loss_of(ref, model, *d)

    value_and_grad = jax.jit(jax.value_and_grad(rloss))
    rstate = ropt.init_state(params)
    rdata = [jnp.asarray(d) for d in data]
    pdata = [torch.from_numpy(d.copy()) for d in data]
    rl, pl = [], []
    for _ in range(steps):
        loss, grads = value_and_grad(params, *rdata)
        params, rstate = ropt.apply_gradients(params, grads, rstate)
        rl.append(float(loss))
        popt.clear_grad()
        loss = loss_of(port, tl, *pdata)
        loss.backward()
        popt.step()
        pl.append(loss.item())
    np.testing.assert_allclose(pl, rl, rtol=rtol, atol=atol)
    name, p0 = next(iter(pm.named_parameters()))
    np.testing.assert_allclose(p0.detach().numpy(), np.asarray(params[name]),
                               rtol=rtol, atol=atol)
    assert np.isfinite(pl).all()
    return tl


# -- test_resnet.py / test_bert.py (slow in the reference) -------------------
@pytest.mark.slow
def test_resnet18_train_two_steps():
    # batch 8 and lr 1e-4, as tests/torch_resnet_golden.py: at batch 2 the
    # last blocks' batch norm (1 x 1 maps, two values a channel) makes
    # float32 rounding chaotic across frameworks
    x = RS.randn(8, 3, 32, 32).astype("float32")
    y = RS.randint(0, 10, (8,)).astype("int32")
    import importlib

    def build(pd):
        return importlib.import_module(
            pd.__name__ + ".vision.models").resnet18(num_classes=10)

    _train_parity(build,
                  lambda pd, m, a, b: _ce(pd, m(a), b), (x, y), lr=1e-4)


@pytest.mark.slow
def test_bert_pretraining_train_two_steps():
    cfg = dict(tensor_parallel=False, vocab_size=128, hidden_size=32,
               num_layers=2, num_heads=2, max_position_embeddings=16,
               attn_dropout=0.0, hidden_dropout=0.0)
    ids = RS.randint(0, 128, (2, 16)).astype("int32")
    mlm = np.full((2, 16), -100, "int32")
    mlm[:, ::4] = RS.randint(0, 128, (2, 4))
    nsp = RS.randint(0, 2, (2,)).astype("int32")

    import importlib
    built = {}

    def loss_of(pd, m, i, ml, ns):
        mlm_logits, nsp_logits = m(i)
        return built[pd].loss(mlm_logits, nsp_logits, ml, ns)

    def build(pd):
        built[pd] = importlib.import_module(
            pd.__name__ + ".text.models").BertForPretraining(**cfg)
        return built[pd]

    _train_parity(build, loss_of, (ids, mlm, nsp), lr=1e-3, opt="AdamW")


# -- test_transformer.py / test_seq2seq.py / test_ptb_lm.py ----------------------
def _mt_model(pd):
    import importlib
    return importlib.import_module(pd.__name__ + ".text.models") \
        .TransformerModel(src_vocab_size=64, trg_vocab_size=64,
                          max_length=16, num_encoder_layers=2,
                          num_decoder_layers=2, n_head=2, d_model=32,
                          d_inner_hid=64, dropout=0.0)


def _seq2seq(pd):
    from paddle_tpu_torch.testdata import recipes
    return recipes.seq2seq(pd, 64, 32)


def _ptb_lm(pd):
    from paddle_tpu_torch.testdata import recipes
    return recipes.ptb_lm(pd, 64, 32, 2)


SEQ_MODELS = {
    "mt_transformer": (_mt_model, lambda pd, m, s, t, y: _ce(pd, m(s, t), y),
                       (RS.randint(2, 64, (2, 8)).astype("int32"),
                        RS.randint(2, 64, (2, 8)).astype("int32"),
                        RS.randint(2, 64, (2, 8)).astype("int32")), 0.01),
    "seq2seq": (_seq2seq, lambda pd, m, s, t, y: _ce(pd, m(s, t), y),
                (RS.randint(2, 64, (2, 6)).astype("int32"),
                 RS.randint(2, 64, (2, 5)).astype("int32"),
                 RS.randint(2, 64, (2, 5)).astype("int32")), 0.05),
    "ptb_lstm_lm": (_ptb_lm, lambda pd, m, x, y: _ce(pd, m(x), y),
                    (RS.randint(0, 64, (2, 8)).astype("int32"),
                     RS.randint(0, 64, (2, 8)).astype("int32")), 0.05),
}


@pytest.mark.parametrize("name", sorted(SEQ_MODELS))
def test_sequence_model_trains_through_the_staged_graph(name):
    build, loss_of, data, lr = SEQ_MODELS[name]
    _train_parity(build, loss_of, data, lr=lr)


# -- the model zoo scenarios ---------------------------------------------------
def _se_net(pd):
    class SeNet(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = pd.nn.Conv2D(3, 8, 3, padding=1)
            self.fc1 = pd.nn.Linear(8, 4)
            self.fc2 = pd.nn.Linear(4, 8)
            self.head = pd.nn.Linear(8, 5)

        def forward(self, x):
            f = pd.nn.functional.relu(self.conv(x))
            s = pd.mean(f, axis=(2, 3))
            e = pd.sigmoid(self.fc2(pd.nn.functional.relu(self.fc1(s))))
            f = f * e[:, :, None, None]
            return self.head(pd.mean(f, axis=(2, 3)))
    return SeNet()


def _dw_net(pd):
    class DwNet(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.dw = pd.nn.Conv2D(4, 4, 3, padding=1, groups=4)
            self.pw = pd.nn.Conv2D(4, 8, 1)
            self.head = pd.nn.Linear(8, 3)

        def forward(self, x):
            h = pd.nn.functional.relu(self.dw(x))
            h = pd.nn.functional.relu(self.pw(h))
            return self.head(pd.mean(h, axis=(2, 3)))
    return DwNet()


def _skipgram(pd):
    class SkipGram(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.center = pd.nn.Embedding(64, 16)
            self.context = pd.nn.Embedding(64, 16)

        def forward(self, c, o, neg):
            ce = self.center(c)
            pos = pd.sum(ce * self.context(o), -1)
            negs = pd.einsum("bd,bkd->bk", ce, self.context(neg))
            return pos, negs
    return SkipGram()


def _text_cnn(pd):
    class TextCnn(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pd.nn.Embedding(64, 16)
            self.conv = pd.nn.Conv2D(1, 8, (3, 16))
            self.head = pd.nn.Linear(8, 2)

        def forward(self, ids):
            e = self.emb(ids)[:, None]
            h = pd.nn.functional.relu(self.conv(e))[..., 0]
            return self.head(pd.max(h, axis=-1))
    return TextCnn()


def _simnet(pd):
    class SimNet(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pd.nn.Embedding(64, 16)
            self.proj = pd.nn.Linear(16, 16)

        def tower(self, ids):
            v = self.proj(pd.mean(self.emb(ids), axis=1))
            return v / (pd.norm(v, axis=-1, keepdim=True) + 1e-6)

        def forward(self, q, p, n):
            tq = self.tower(q)
            return (pd.sum(tq * self.tower(p), -1),
                    pd.sum(tq * self.tower(n), -1))
    return SimNet()


def _nce_loss(pd, m, c, o, neg):
    pos, negs = m(c, o, neg)
    F = pd.nn.functional
    return pd.mean(F.softplus(-pos)) + pd.mean(F.softplus(negs))


def _hinge(pd, m, q, p, n):
    sp, sn = m(q, p, n)
    return pd.mean(pd.clip(0.5 - sp + sn, min=0.0))


MODELS = {
    "se_block": (_se_net, lambda pd, m, x, y: _ce(pd, m(x), y),
                 (RS.randn(2, 3, 8, 8).astype("float32"),
                  RS.randint(0, 5, (2,)).astype("int32")), 0.05),
    "depthwise_separable": (_dw_net, lambda pd, m, x, y: _ce(pd, m(x), y),
                            (RS.randn(2, 4, 8, 8).astype("float32"),
                             RS.randint(0, 3, (2,)).astype("int32")), 0.05),
    "skipgram": (_skipgram, _nce_loss,
                 (RS.randint(0, 64, (8,)).astype("int32"),
                  RS.randint(0, 64, (8,)).astype("int32"),
                  RS.randint(0, 64, (8, 3)).astype("int32")), 0.1),
    "cnn_classifier": (_text_cnn, lambda pd, m, x, y: _ce(pd, m(x), y),
                       (RS.randint(0, 64, (4, 12)).astype("int32"),
                        RS.randint(0, 2, (4,)).astype("int32")), 0.05),
    "two_tower_hinge": (_simnet, _hinge,
                        (RS.randint(0, 64, (4, 6)).astype("int32"),
                         RS.randint(0, 64, (4, 6)).astype("int32"),
                         RS.randint(0, 64, (4, 6)).astype("int32")), 0.1),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_trains_through_the_staged_graph(name):
    build, loss_of, data, lr = MODELS[name]
    _train_parity(build, loss_of, data, lr=lr)


# -- test_declarative.py / test_cache_program.py / test_save_inference_model --
def _gate(pd):
    class M(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pd.nn.Linear(4, 2)

        def forward(self, x):
            out = pd.nn.functional.relu(self.fc(x))
            if pd.mean(x) > 1e9:       # converted control flow
                out = out * 0.0
            return out
    return M()


def test_enable_to_static_toggle():
    from paddle_tpu_torch.jit import ProgramTranslator
    x = torch.from_numpy(RS.randn(2, 4).astype("float32"))
    port.seed(0)
    m1 = _gate(port)
    out_static = port.jit.to_static(m1)(x)
    try:
        ProgramTranslator().enable(False)
        port.seed(0)
        m2 = _gate(port)
        assert port.jit.to_static(m2) is m2
        np.testing.assert_allclose(out_static.detach().numpy(),
                                   m2(x).detach().numpy(), rtol=1e-5)
    finally:
        ProgramTranslator().enable(True)


def test_traced_layer_tracks_param_updates():
    m = port.nn.Linear(4, 2)
    tl = port.jit.to_static(m)
    x = torch.from_numpy(RS.randn(2, 4).astype("float32"))
    out1 = tl(x).detach().numpy()
    with torch.no_grad():
        m.weight.add_(1.0)
    out2 = tl(x).detach().numpy()
    assert not np.allclose(out1, out2)
    np.testing.assert_allclose(out2, m(x).detach().numpy(), rtol=1e-5)
    # a replaced parameter: refresh_state re-reads it
    m.bias = torch.nn.Parameter(torch.full((2,), 5.0))
    tl.refresh_state()
    np.testing.assert_allclose(tl(x).detach().numpy(),
                               m(x).detach().numpy(), rtol=1e-5)
    assert len(tl._graphs) == 1     # one signature, one trace
    placeholders = [n for n in tl.graph(x).graph.nodes
                    if n.op == "placeholder"]
    assert len(placeholders) == 3   # weight, bias, x: no baked weights


def test_converted_model_saves_and_loads(tmp_path):
    ref.seed(0)
    rm = _gate(ref)
    pm = _gate(port)
    _carry(rm, pm)
    rm.eval()
    pm.eval()
    cm = port.jit.to_static(pm).layer
    path = str(tmp_path / "conv_model")
    port.jit.save(cm, path, input_spec=[port.jit.InputSpec([2, 4])])
    loaded = port.jit.load(path, device="cpu")
    x = RS.randn(2, 4).astype("float32")
    got = loaded(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), cm(torch.from_numpy(
        x)).detach().numpy(), rtol=1e-5)
    want = _ref_convert(rm)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    ep = torch.export.load(path + ".pt2")
    assert any("cond" in str(n.target) for n in ep.graph.nodes)


class _UserScale(torch.autograd.Function):
    """A user's Function, whose forward the trace inlines."""

    @staticmethod
    def forward(ctx, x):
        return x * 3

    @staticmethod
    def backward(ctx, g):
        return g * 3


class _ScaledLinear(port.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = port.nn.Linear(16, 4)

    def forward(self, x):
        return _UserScale.apply(self.fc(x))


def test_lost_gradient_raises_by_name():
    # a user-defined autograd.Function: the staged graph would replay its
    # forward with no way to its backward
    from paddle_tpu_torch.jit import LostGradientError

    port.seed(0)
    m = _ScaledLinear()
    x = torch.from_numpy(RS.randn(2, 8, 16).astype("float32"))
    tl = port.jit.to_static(m)
    with pytest.raises(LostGradientError, match="_UserScale"):
        tl(x)
    with torch.no_grad():
        np.testing.assert_allclose(tl(x).numpy(), m(x).numpy(), rtol=1e-6)


def test_dropout_draws_at_run_time_from_the_port_generator():
    class Drop(port.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = port.nn.Linear(8, 8)
            self.drop = port.nn.Dropout(0.5)

        def forward(self, x):
            return self.drop(self.fc(x))

    m = Drop()
    tl = port.jit.to_static(m)
    x = torch.ones(4, 8)
    with torch.no_grad():
        port.seed(11)
        a = tl(x)
        b = tl(x)
        port.seed(11)
        eager = m(x)
    assert not torch.equal(a, b)          # a fresh mask every call
    assert torch.equal(a, eager)          # from the port's generator


# -- the slice as a whole: GPT --------------------------------------------------
_GPT_CFG = dict(tensor_parallel=False, vocab_size=256, hidden_size=64,
                num_layers=2, num_heads=4, max_position_embeddings=64,
                attn_dropout=0.0, hidden_dropout=0.0)


def _gpt_batch(seed=3, b=2, s=32):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (b, s)).astype(np.int32)
    lbl = rs.randint(0, 256, (b, s)).astype(np.int32)
    lbl[0, :5] = -100
    return ids, lbl


def _gpt_pair():
    from paddle_tpu.text.models import GPTForPretraining as RefGPT
    from paddle_tpu_torch.text.models import GPTForPretraining
    ref.seed(0)
    rm = RefGPT(**_GPT_CFG)
    pm = GPTForPretraining(**_GPT_CFG)
    _carry(rm, pm)
    return rm, pm


def test_gpt_to_static_forward_matches_reference():
    rm, pm = _gpt_pair()
    rm.eval()
    pm.eval()
    ids, _ = _gpt_batch()
    want = ref.jit.to_static(rm)(jnp.asarray(ids))
    tl = port.jit.to_static(pm)
    with torch.no_grad():
        got = tl(torch.from_numpy(ids))
        eager = pm(torch.from_numpy(ids))
    assert torch.equal(got, eager)       # the graph replays the same ops
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_gpt_static_program_trains_as_the_reference():
    from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
    from tools._mesh_setup import data_mesh
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import fused_ce
    from paddle_tpu_torch.optimizer import AdamW

    rm, pm = _gpt_pair()

    class RefLoss(ref.nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, ce_kernel="pallas")

    data_mesh(1)
    rtr = RefTrainer(RefLoss(rm), ref.optimizer.AdamW(
        3e-4, parameters=rm.parameters()), lambda out, _l: out)
    ids, lbl = _gpt_batch()
    want = [float(rtr.train_step((ids, lbl), 0.0)) for _ in range(2)]

    names = [n for n, _ in pm.named_parameters()]
    grad_fn = static.append_backward(
        lambda i, t: pm.fused_head_loss(i, t, ce_kernel="pallas"),
        parameter_list=pm)

    def step(i, t):
        loss, grads = grad_fn(i, t)
        return (loss, *grads)

    prog = static.Program.trace(
        step, static.data("ids", [2, 32], "int32"),
        static.data("lbl", [2, 32], "int32"), parameters=pm,
        fetch_names=["loss"] + [n + "@GRAD" for n in names])
    ops = [str(n.target) for n in prog.graph.graph.nodes]
    for op in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
        assert sum(op in o for o in ops) == 1, op
    exe = static.Executor("cpu")
    opt = AdamW(3e-4, parameters=pm.named_parameters())
    params = dict(pm.named_parameters())
    got = []
    n0 = dict(fused_ce.LAUNCHES)
    for _ in range(2):
        outs = exe.run(prog, feed={"ids": ids, "lbl": lbl},
                       fetch_list=prog.fetch_names, return_numpy=False)
        got.append(outs[0].item())
        for n, g in zip(names, outs[1:]):
            params[n].grad = g
        opt.step()
        opt.clear_grad()
    assert fused_ce.LAUNCHES == n0        # plain versions on the CPU
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(prog._compiled) == 1       # traced once, run twice
