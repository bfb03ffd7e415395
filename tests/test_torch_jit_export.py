"""The port's export (``paddle_tpu_torch.jit``) against the JAX package's.

- ``InputSpec`` and the symbols of dynamic dims: the port's
  ``torch.export.Dim`` names are the reference's symbol names, one shared
  ``batch`` Dim across unnamed specs, per-name Dims for named specs.
- Round trips: save -> load -> call on ``Linear`` and on a small GPT
  (depth 2, hidden 128, two heads of 64, seq 512, so the flash gate
  opens). One artifact serves rows 1 to 5; each answer matches the
  reference's Predictor over the same weights within 1e-5 (float32 on
  both sides; the port's exported attention is the flash op's plain
  version, the reference's XLA attention: sums in other orders).
- The registered flash op is in the exported graph, once a layer, and
  passes ``torch.library.opcheck``.
- A program runs only on the device it was exported on.
- ``read_pdiparams`` reads the reference's ``.pdiparams`` bit for bit;
  the port re-saves that model and serves what the reference serves.
- The Predictor golden (``paddle_tpu_torch/testdata/predictor_golden.
  json``: GPT-base widths, depth 2) holds on the CPU within 1e-4.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as ref_paddle
from paddle_tpu import inference as ref_inference
from paddle_tpu import jit as ref_jit
from paddle_tpu import nn as ref_nn
from paddle_tpu.text.models import GPTForPretraining as RefGPT

from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.text.models import gpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gpt_train_golden as train_golden  # noqa: E402
import torch_predictor_golden as predictor_golden  # noqa: E402
from torch_threads import two_threads  # noqa: E402,F401

TOL = 1e-5          # port vs reference Predictor, float32
GOLDEN_TOL = 1e-4   # port vs the golden file, float32
SMALL_GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                 max_position_embeddings=512, attn_dropout=0.0,
                 hidden_dropout=0.0)
SEQ = 512


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _cpu(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


class PortLast(nn.Layer):
    """The port's served GPT: the trunk, then the tied head on the last
    position (the golden's layer)."""

    def __init__(self, cfg):
        super().__init__()
        self.model = gpt.GPTForPretraining(tensor_parallel=False, **cfg)

    def forward(self, ids):
        h = self.model.gpt(ids)
        return self.model.lm_head(h[:, -1, :])


class RefLast(ref_nn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.model = RefGPT(tensor_parallel=False, **cfg)

    def forward(self, ids):
        h = self.model.gpt(ids)
        return self.model.lm_head(h[:, -1, :])


def _ref_saved_gpt(tmp_path):
    ref = RefLast(SMALL_GPT)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in ref.state_dict().items()]
    ref.set_state_dict(train_golden.weights(names_shapes, 5))
    prefix = str(tmp_path / "ref_gpt")
    ref_jit.save(ref, prefix,
                 input_spec=[ref_jit.InputSpec([None, SEQ], "int32")])
    return ref, prefix


def _ids(rows, seed=0):
    return np.random.RandomState(seed).randint(
        0, SMALL_GPT["vocab_size"], (rows, SEQ)).astype(np.int32)


# -- InputSpec and the symbols of dynamic dims --------------------------------

def test_input_spec_matches_the_reference():
    for shape, dtype in (([None, 32], "float32"), ([-1, 4, 8], "int64"),
                         ([2, 3], "bfloat16")):
        p = jit.InputSpec(shape, dtype)
        r = ref_jit.InputSpec(shape, dtype)
        assert p.shape == r.shape
        assert str(p.dtype).split(".")[-1] == np.dtype(r.dtype).name
        assert p.to_shape_dtype(2).shape == r.to_shape_dtype(2).shape
    assert jit.InputSpec([None, 3]).to_shape_dtype().shape == \
        (jit.EXAMPLE_BATCH, 3)


SPEC_SETS = {
    "unnamed_pair": [([None, 8], None), ([None, 8], None)],
    "unnamed_inner": [([None, None, 4], None)],
    "named": [([None, 8], "a"), ([None, None], "b")],
    "mixed": [([None, 8], None), ([None, 8], "tok"), ([3, 8], None)],
}


@pytest.mark.parametrize("which", sorted(SPEC_SETS))
def test_dims_are_named_as_the_reference_names_its_symbols(which):
    specs = SPEC_SETS[which]
    ref_specs = [ref_jit.InputSpec(s, "float32", name=n) for s, n in specs]
    args = tuple(np.zeros([1 if d is None else d for d in s], np.float32)
                 for s, _ in specs)
    ref_args = ref_jit.poly_arg_specs(ref_specs, args)
    port = jit.poly_arg_specs([jit.InputSpec(s, "float32", name=n)
                               for s, n in specs])
    for ra, pd in zip(ref_args, port):
        want = {j: str(d) for j, d in enumerate(ra.shape)
                if not isinstance(d, int)}
        got = {} if pd is None else {j: d.__name__ for j, d in pd.items()}
        assert got == want
    # one Dim object per symbol name
    by_name = {}
    for pd in port:
        for d in (pd or {}).values():
            assert by_name.setdefault(d.__name__, d) is d


# -- round trips ----------------------------------------------------------------

def test_linear_round_trip_matches_the_reference(tmp_path):
    ref_paddle.seed(3)
    ref = ref_nn.Linear(32, 16)
    ref.eval()
    ref_prefix = str(tmp_path / "ref")
    ref_jit.save(ref, ref_prefix,
                 input_spec=[ref_jit.InputSpec([None, 32], "float32")])
    port = nn.Linear(32, 16)
    port.set_state_dict_from_numpy(jit.read_pdiparams(ref_prefix))
    prefix = str(tmp_path / "port")
    jit.save(port, prefix, input_spec=[jit.InputSpec([None, 32])])
    assert os.path.exists(prefix + ".pt2")
    assert os.path.exists(prefix + ".pdiparams")
    layer = jit.load(prefix)
    assert layer.device == torch.device("cpu")
    ref_pred = ref_inference.create_predictor(ref_inference.Config(ref_prefix))
    pred = inference.create_predictor(_cpu(prefix))
    for rows in range(1, 6):
        x = np.random.RandomState(rows).rand(rows, 32).astype(np.float32)
        want = np.asarray(ref_pred.run([x])[0])
        np.testing.assert_allclose(pred.run([x])[0], want, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(layer(x).numpy(), want, rtol=TOL,
                                   atol=TOL)


def test_read_pdiparams_is_the_reference_state_bit_for_bit(tmp_path):
    ref, prefix = _ref_saved_gpt(tmp_path)
    got = jit.read_pdiparams(prefix)
    got_too = jit.read_pdiparams(prefix + ".pdiparams")
    want = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    assert list(got) == list(want) == list(got_too)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_small_gpt_round_trip_serves_rows_1_to_5(tmp_path):
    ref, ref_prefix = _ref_saved_gpt(tmp_path)
    port = PortLast(SMALL_GPT)
    port.set_state_dict_from_numpy(jit.read_pdiparams(ref_prefix))
    prefix = str(tmp_path / "port_gpt")
    jit.save(port, prefix, input_spec=[jit.InputSpec([None, SEQ], "int32")])
    layer = jit.load(prefix)
    ops = [n for n in layer._exported.graph.nodes
           if n.target == fa.FLASH_FWD_OP.default]
    assert len(ops) == SMALL_GPT["num_layers"]
    ref_pred = ref_inference.create_predictor(ref_inference.Config(ref_prefix))
    pred = inference.create_predictor(_cpu(prefix))
    assert pred.get_input_names() == ["x0"]
    for rows in range(1, 6):
        x = _ids(rows, seed=rows)
        want = np.asarray(ref_pred.run([x])[0])
        got = pred.run([x])[0]
        assert got.shape == (rows, SMALL_GPT["vocab_size"])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        # the eager port model (plain attention on the CPU) agrees too
        with torch.no_grad():
            eager = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, eager, rtol=TOL, atol=TOL)


def test_state_and_functional_call_match_the_reference_names():
    from paddle_tpu.jit import functionalization as ref_fn

    from paddle_tpu_torch.jit import functionalization as fn
    ref = RefLast(SMALL_GPT)
    port = PortLast(SMALL_GPT)
    rp, rb = ref_fn.state_of(ref)
    pp, pb = fn.state_of(port)
    assert list(pp) == list(rp) and list(pb) == list(rb)
    assert all(fn.trainable_mask(port).values())
    # the call runs on the state given, not the layer's own
    zeros = {k: torch.zeros_like(v) for k, v in pp.items()}
    x = torch.from_numpy(_ids(2))
    out, bufs = fn.functional_call(port, zeros, pb, x)
    assert torch.count_nonzero(out) == 0 and list(bufs) == list(pb)
    assert torch.count_nonzero(port(x)) > 0


# -- the registered flash op ------------------------------------------------------

@pytest.mark.parametrize("case", ["causal", "lens_dropout"])
def test_flash_op_passes_opcheck(case):
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(2, 128, 2, 64).astype(np.float32))
               for _ in range(3))
    if case == "causal":
        args = (q, k, v, None, None, 0.125, True, 0.0, 128, 128)
    else:
        args = (q, k, v, torch.tensor([128, 37], dtype=torch.int32),
                torch.tensor(3, dtype=torch.int64), 0.125, False, 0.1,
                128, 128)
    res = torch.library.opcheck(fa.FLASH_FWD_OP, args)
    assert set(res.values()) == {"SUCCESS"}


def test_flash_op_is_the_forward_with_and_without_gradients():
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(2, 256, 2, 64).astype(np.float32))
               for _ in range(3))
    plain, _ = fa.flash_attention_plain_fwd(q, k, v, causal=True)
    with torch.no_grad():
        no_grad = fa.flash_attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_()
    with_grad = fa.flash_attention(qg, k, v, causal=True)
    assert torch.equal(no_grad, plain) and torch.equal(with_grad, plain)
    with_grad.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


def test_export_holds_the_op_on_the_cpu_only_while_exporting():
    q = torch.zeros(1, 512, 2, 64)
    assert not fa.flash_supported(q, q, min_seq=512)
    with fa.exporting():
        assert fa.flash_supported(q, q, min_seq=512)
        assert not fa.flash_supported(q[:, :128], q, min_seq=512)
    assert not fa.flash_supported(q, q, min_seq=512)


# -- devices ----------------------------------------------------------------------

def test_a_program_runs_only_on_its_device(tmp_path):
    net = nn.Linear(8, 4)
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[jit.InputSpec([None, 8])])
    with pytest.raises(ValueError, match="exported on cpu"):
        jit.load(prefix, device="cuda")
    inference.clear_layer_cache()
    try:
        cfg = inference.Config(prefix)
        cfg._device = "meta"   # any device but the artifact's
        with pytest.raises(ValueError, match="exported on cpu"):
            inference.Predictor(cfg)
        if not torch.cuda.is_available():
            # no device asked for means the card; without one, it raises
            with pytest.raises(RuntimeError, match="device='cpu'"):
                inference.create_predictor(inference.Config(prefix))
    finally:
        inference.clear_layer_cache()


def test_to_static_waits_for_dy2static():
    # dy2static is ported: to_static stages, TracedLayer traces
    layer = nn.Linear(2, 2)
    staged = jit.to_static(layer)
    assert isinstance(staged, jit.TracedLayer) and staged.layer is layer
    x = torch.ones(3, 2)
    assert torch.equal(staged(x), layer(x))
    assert torch.equal(jit.TracedLayer(layer)(x), layer(x))
    jit.set_verbosity(3)
    jit.set_code_level(2)
    assert jit._verbosity == 3 and jit._code_level == 2
    jit.ProgramTranslator.get_instance().enable(False)
    assert jit.ProgramTranslator.enable_to_static is False
    jit.ProgramTranslator.get_instance().enable(True)
    assert jit.not_to_static(len) is len


# -- the golden fixture ----------------------------------------------------------

def test_predictor_golden_holds_on_the_cpu(tmp_path):
    gold = predictor_golden.load()
    port = PortLast(gold["config"])
    names_shapes = [(n, tuple(s)) for n, s in gold["names_shapes"]]
    assert [n for n, _ in names_shapes] == list(port.named_state())
    port.set_state_dict_from_numpy(train_golden.weights(
        names_shapes, gold["recipe"]["weights"]["seed"]))
    prefix = str(tmp_path / "golden")
    jit.save(port, prefix,
             input_spec=[jit.InputSpec([None, gold["seq"]], "int32")])
    out = inference.create_predictor(_cpu(prefix)).run(
        [predictor_golden.ids()])[0]
    got = predictor_golden.summarize(out)
    assert got["argmax"] == gold["argmax"]
    np.testing.assert_allclose(got["logsumexp"], gold["logsumexp"],
                               atol=GOLDEN_TOL, rtol=0)
    np.testing.assert_allclose(got["strided"], gold["strided"],
                               atol=GOLDEN_TOL, rtol=0)
    assert min(gold["top2_gap"]) > 10 * GOLDEN_TOL   # argmax is stable


def test_the_program_file_holds_no_weights(tmp_path):
    net = nn.Linear(512, 512)          # 1 MiB of float32 weights
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[jit.InputSpec([None, 512])])
    assert os.path.getsize(prefix + ".pdiparams") > 2 ** 20
    assert os.path.getsize(prefix + ".pt2") < 2 ** 17
    x = np.ones((2, 512), np.float32)
    np.testing.assert_allclose(jit.load(prefix)(x).numpy(),
                               net(torch.from_numpy(x)).detach().numpy(),
                               rtol=TOL, atol=TOL)
