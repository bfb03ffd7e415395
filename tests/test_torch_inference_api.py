"""The port's predictor API (``paddle_tpu_torch.inference``) and weight
quantization (``inference.quant``) against the JAX package's.

Mirrors ``tests/test_inference_api.py`` and the Predictor cases of
``tests/test_inference_extension.py`` case by case: ``Config`` keeps its
state across ``set_model``, handles check their direction, a pool shares
one loaded layer, a stale artifact is reloaded, the ``_n_user_inputs``
fallback. The quantizers are bit-equal to the reference's (int8 and int4,
odd shapes, pass-through leaves, and bfloat16 leaves passing through as
the reference's do). Predictors over the same weights agree with the
reference's within 1e-5 (float32), quantized ones too.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref_paddle
from paddle_tpu import inference as ref_inference
from paddle_tpu import jit as ref_jit
from paddle_tpu import nn as ref_nn
from paddle_tpu.inference import quant as ref_quant

from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.inference import quant

TOL = 1e-5


def _cpu(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


@pytest.fixture()
def saved_pair(tmp_path):
    """The reference's Linear(32, 16) saved by both packages (the port's
    weights read from the reference's file)."""
    ref_paddle.seed(3)
    net = ref_nn.Linear(32, 16)
    net.eval()
    ref_prefix = str(tmp_path / "ref")
    ref_jit.save(net, ref_prefix,
                 input_spec=[ref_jit.InputSpec([None, 32], "float32")])
    port = nn.Linear(32, 16)
    port.set_state_dict_from_numpy(jit.read_pdiparams(ref_prefix))
    prefix = str(tmp_path / "model")
    jit.save(port, prefix, input_spec=[jit.InputSpec([None, 32])])
    inference.clear_layer_cache()
    yield net, ref_prefix, port, prefix
    inference.clear_layer_cache()
    ref_inference.clear_layer_cache()


# -- Config -------------------------------------------------------------------

def test_set_model_preserves_device_profile_and_quant():
    cfg = inference.Config("/a/model")
    cfg.disable_gpu()
    cfg.enable_profile()
    cfg.enable_weight_quantize("int8", block=64)
    cfg.set_model("/b/other")
    assert cfg.prog_file() == "/b/other.pt2"
    assert cfg.params_file() == "/b/other.pdiparams"
    assert cfg._device == "cpu"
    assert cfg._enable_profile is True
    assert cfg._weight_quant == ("int8", 64)
    for suffix in (".pdmodel", ".stablehlo", ".json", ".pt2"):
        cfg.set_model("/c/m" + suffix)
        ref = ref_inference.Config("/c/m" + suffix)
        assert cfg.prog_file() == "/c/m.pt2"
        assert cfg._prefix == ref._prefix or suffix == ".pt2"
        assert cfg._device == "cpu"
    assert cfg.model_dir() == "/c"


def test_enable_weight_quantize_validates_policy():
    cfg = inference.Config("/a/model")
    with pytest.raises(ValueError, match="int8/int4"):
        cfg.enable_weight_quantize("fp8")
    cfg.enable_weight_quantize("int4")
    assert cfg._weight_quant == ("int4", None)


def test_device_choice():
    cfg = inference.Config("/a/model")
    assert cfg.use_gpu() and cfg._device is None
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.device() == torch.device("cpu")
    cfg.enable_use_gpu(100, device_id=1)
    assert cfg._device == "cuda:1" and cfg.use_gpu()
    cfg.enable_use_gpu(100)
    assert cfg._device is None


def test_config_inert_toggles_warn_once(saved_pair):
    _, _, _, prefix = saved_pair
    cfg = inference.Config(prefix + ".pt2")
    cfg.disable_gpu()
    inference.Config._warned_toggles.clear()
    for toggle in (lambda: cfg.switch_ir_optim(True),
                   cfg.enable_memory_optim, cfg.enable_mkldnn,
                   lambda: cfg.set_cpu_math_library_num_threads(4),
                   cfg.enable_tensorrt_engine):
        with pytest.warns(UserWarning, match="no effect in paddle_tpu_torch"):
            toggle()
    with warnings.catch_warnings():  # second call: already warned
        warnings.simplefilter("error")
        cfg.enable_memory_optim()
    assert cfg.prog_file().endswith(".pt2")
    assert inference.create_predictor(cfg).get_input_names() == ["x0"]


# -- handles ----------------------------------------------------------------------

def test_tensor_handle_direction_enforced(saved_pair):
    net, ref_prefix, _, prefix = saved_pair
    pred = inference.create_predictor(_cpu(prefix))
    x = np.random.RandomState(1).rand(2, 32).astype("float32")
    inp = pred.get_input_handle("x0")
    inp.copy_from_cpu(x)
    assert inp.shape() == [2, 32]
    assert inp.name() == "x0"
    with pytest.raises(AssertionError):
        inp.copy_to_cpu()
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0])
    got = out.copy_to_cpu()
    assert got.shape == (2, 16) and out.shape() == [2, 16]
    np.testing.assert_allclose(got, np.asarray(net(x)), rtol=TOL, atol=TOL)
    with pytest.raises(AssertionError):
        out.copy_from_cpu(x)
    pred.clear_intermediate_tensor()
    assert pred._inputs == {} and pred._outputs == {}


def test_predictor_run_positional_matches_the_reference(saved_pair):
    _, ref_prefix, _, prefix = saved_pair
    ref_pred = ref_inference.create_predictor(ref_inference.Config(ref_prefix))
    pred = inference.create_predictor(_cpu(prefix))
    assert pred.get_input_names() == ref_pred.get_input_names()
    x = np.random.RandomState(0).rand(3, 32).astype("float32")
    np.testing.assert_allclose(pred.run([x])[0],
                               np.asarray(ref_pred.run([x])[0]),
                               rtol=TOL, atol=TOL)
    assert pred.get_output_names() == ref_pred.get_output_names()


# -- load cache / pool sharing ----------------------------------------------------

def _counting_load(monkeypatch):
    calls = []
    real_load = jit.load

    def counting_load(p, *a, **kw):
        calls.append(p)
        return real_load(p, *a, **kw)

    monkeypatch.setattr(jit, "load", counting_load)
    return calls


def test_pool_shares_one_loaded_layer(saved_pair, monkeypatch):
    _, _, _, prefix = saved_pair
    calls = _counting_load(monkeypatch)
    pool = inference.PredictorPool(_cpu(prefix), 3)
    assert len(pool) == 3 and len(calls) == 1
    layers = {id(pool.retrieve(i)._layer) for i in range(3)}
    assert len(layers) == 1
    qcfg = _cpu(prefix)
    qcfg.enable_weight_quantize("int8", block=64)
    qpred = inference.create_predictor(qcfg)
    assert len(calls) == 1      # the quantized view derives from the cache
    assert id(qpred._layer) not in layers
    x = np.ones((1, 32), "float32")
    outs = [pool.retrieve(i).run([x])[0] for i in range(3)]
    np.testing.assert_array_equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        inference.PredictorPool(_cpu(prefix), 0)


def test_stale_artifact_is_reloaded(saved_pair, monkeypatch):
    _, _, _, prefix = saved_pair
    calls = _counting_load(monkeypatch)
    inference.create_predictor(_cpu(prefix))
    st = os.stat(prefix + ".pdiparams")
    os.utime(prefix + ".pdiparams",
             ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    inference.create_predictor(_cpu(prefix))
    assert len(calls) == 2


def test_n_user_inputs_fallback_on_foreign_export():
    class _Stub:
        _exported = object()   # no graph signature at all

    p = inference.Predictor.__new__(inference.Predictor)
    p._layer = _Stub()
    assert p._n_user_inputs() == 1


def test_n_user_inputs_counts_the_program_inputs(tmp_path):
    class Two(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3)

        def forward(self, a, b):
            return self.fc(a) + self.fc(b)

    prefix = str(tmp_path / "two")
    jit.save(Two(), prefix, input_spec=[jit.InputSpec([None, 4]),
                                        jit.InputSpec([None, 4])])
    try:
        pred = inference.create_predictor(_cpu(prefix))
        assert pred.get_input_names() == ["x0", "x1"]
        x = np.ones((2, 4), np.float32)
        pred.get_input_handle("x0").copy_from_cpu(x)
        pred.get_input_handle("x1").copy_from_cpu(2 * x)
        assert pred.run()[0].shape == (2, 3)
    finally:
        inference.clear_layer_cache()


def test_type_tags_and_version():
    for tag in ("FLOAT32", "FLOAT16", "BFLOAT16", "INT64", "INT32", "UINT8",
                "INT8", "BOOL"):
        t = getattr(inference.DataType, tag)
        assert t == getattr(ref_inference.DataType, tag)
        assert inference.get_num_bytes_of_data_type(t) == \
            ref_inference.get_num_bytes_of_data_type(t)
    with pytest.raises(ValueError):
        inference.get_num_bytes_of_data_type("float128")
    assert inference.PlaceType.GPU == ref_inference.PlaceType.GPU
    assert inference.PrecisionType.Int8 == ref_inference.PrecisionType.Int8
    assert inference.get_version().startswith("paddle_tpu_torch ")


# -- weight quantization: bit-equal to the reference --------------------------------

SHAPES = [(37, 19), (1000,), (3, 5, 7), (64, 32), (256,)]


def _same_quant(qa, rqa):
    assert qa.policy == rqa.policy and qa.block == rqa.block
    assert qa.shape == rqa.shape and qa.size == rqa.size
    assert qa.nbytes == rqa.nbytes
    np.testing.assert_array_equal(qa.q.numpy(), np.asarray(rqa.q))
    np.testing.assert_array_equal(qa.scale.numpy(), np.asarray(rqa.scale))


@pytest.mark.parametrize("policy", ["int8", "int4"])
@pytest.mark.parametrize("block", [None, 32])
def test_quantize_array_bit_equal_to_the_reference(policy, block):
    rs = np.random.RandomState(0)
    for shape in SHAPES:
        x = (rs.randn(*shape) * 3.0).astype(np.float32)
        qa = quant.quantize_array(torch.from_numpy(x), policy, block)
        rqa = ref_quant.quantize_array(x, policy, block)
        _same_quant(qa, rqa)
        back = quant.dequantize_array(qa)
        assert back.dtype == torch.float32 and tuple(back.shape) == shape
        np.testing.assert_array_equal(back.numpy(),
                                      ref_quant.dequantize_array(rqa))
        levels = 127.0 if policy == "int8" else 7.0
        assert np.abs(back.numpy() - x).max() <= np.abs(x).max() / levels \
            + 1e-6
    with pytest.raises(ValueError):
        quant.quantize_array(torch.zeros(4), "fp8")


@pytest.mark.parametrize("policy", ["int8", "int4"])
def test_quantize_state_bit_equal_with_pass_through(policy):
    rs = np.random.RandomState(1)
    state = {
        "w": rs.randn(64, 32).astype("float32"),
        "w16": rs.randn(40, 9).astype("float16"),
        "b": rs.randn(8).astype("float32"),         # smaller than a block
        "steps": np.arange(100, dtype="int64"),     # not float
    }
    port_state = {k: torch.from_numpy(v) for k, v in state.items()}
    q = quant.quantize_state(port_state, policy, block=32)
    rq = ref_quant.quantize_state(state, policy, block=32)
    assert sorted(q) == sorted(rq)
    for k in state:
        if isinstance(rq[k], ref_quant.QuantizedArray):
            assert isinstance(q[k], quant.QuantizedArray)
            _same_quant(q[k], rq[k])
        else:
            assert not isinstance(q[k], quant.QuantizedArray)
            np.testing.assert_array_equal(q[k].numpy(), rq[k])
    assert quant.state_bytes(q) == ref_quant.state_bytes(rq)
    back, rback = quant.dequantize_state(q), ref_quant.dequantize_state(rq)
    for k in state:
        assert back[k].numpy().dtype == rback[k].dtype
        np.testing.assert_array_equal(back[k].numpy(), rback[k])
    if policy == "int4":
        q8 = quant.quantize_state(port_state, "int8", block=32)
        assert q["w"].q.numel() == q8["w"].q.numel() // 2


def test_bfloat16_leaves_pass_through_as_in_the_reference():
    rs = np.random.RandomState(2)
    w = rs.randn(64, 64).astype(np.float32)
    ref_bf16 = np.asarray(jnp.asarray(w, jnp.bfloat16))
    rq = ref_quant.quantize_state({"w": ref_bf16}, "int8")
    assert not isinstance(rq["w"], ref_quant.QuantizedArray)
    port_bf16 = torch.from_numpy(w).to(torch.bfloat16)
    q = quant.quantize_state({"w": port_bf16}, "int8")
    assert not isinstance(q["w"], quant.QuantizedArray)
    assert torch.equal(q["w"], port_bf16)
    assert quant.state_bytes(q) == ref_quant.state_bytes(rq) == 64 * 64 * 2


def test_bfloat16_model_is_not_compressed(tmp_path):
    net = nn.Linear(64, 64).to(torch.bfloat16)
    prefix = str(tmp_path / "bf16")
    jit.save(net, prefix, input_spec=[jit.InputSpec([None, 64],
                                                    "bfloat16")])
    layer, stats = quant.quantized_layer(jit.load(prefix), "int8")
    assert stats["n_quantized"] == 0 and stats["compression_x"] == 1.0
    x = torch.randn(2, 64).to(torch.bfloat16)
    assert torch.equal(layer(x), net(x).detach())


@pytest.mark.parametrize("policy,block", [("int8", 16), ("int4", None)])
def test_quantized_predictor_matches_the_reference(saved_pair, policy,
                                                   block):
    net, ref_prefix, _, prefix = saved_pair
    cfg = _cpu(prefix)
    cfg.enable_weight_quantize(policy, block)
    rcfg = ref_inference.Config(ref_prefix)
    rcfg.enable_weight_quantize(policy, block)
    x = np.random.RandomState(5).rand(4, 32).astype("float32")
    got = inference.create_predictor(cfg).run([x])[0]
    want = np.asarray(ref_inference.create_predictor(rcfg).run([x])[0])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert not np.allclose(got, np.asarray(net(x)), atol=1e-9)
    _, stats = quant.quantized_layer(inference._load_layer(prefix), policy,
                                     block)
    _, rstats = ref_quant.quantized_layer(ref_inference._load_layer(
        ref_prefix), policy, block)
    assert stats == rstats
    assert stats["compression_x"] > 3.0


def test_compression_gauge(saved_pair):
    from paddle_tpu_torch import telemetry
    _, _, _, prefix = saved_pair
    telemetry.enable()
    try:
        _, stats = quant.quantized_layer(inference._load_layer(prefix),
                                         "int4")
        g = telemetry.get_registry().get("serving_weight_compression_x")
        assert g.value(policy="int4") == pytest.approx(stats["compression_x"])
    finally:
        telemetry.disable()


@pytest.mark.parametrize("policy", ["int8", "int4"])
def test_a_nan_weight_block_is_served_finite_as_in_the_reference(policy):
    """The reference's scale is 1 for a block holding a NaN and the NaN
    casts to an int8 0: the block serves finite, bit for bit the same."""
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 64) * 0.02).astype(np.float32)
    x[1, 3] = np.nan
    with np.errstate(invalid="ignore"):
        rback = ref_quant.dequantize_array(
            ref_quant.quantize_array(x, policy, 64))
    back = quant.dequantize_array(quant.quantize_array(torch.from_numpy(x),
                                                       policy, 64)).numpy()
    assert np.isfinite(rback).all()
    np.testing.assert_array_equal(back, rback)


@pytest.mark.parametrize("policy", ["int8", "int4"])
def test_an_inf_weight_poisons_its_block_as_in_the_reference(policy):
    """An inf block's scale is inf and it dequantizes to NaN (0 * inf) in
    both packages: an inf checkpoint serves non-finite answers."""
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 64) * 0.02).astype(np.float32)
    x[1, 3] = np.inf
    with np.errstate(invalid="ignore"):
        rback = ref_quant.dequantize_array(
            ref_quant.quantize_array(x, policy, 64))
    back = quant.dequantize_array(quant.quantize_array(torch.from_numpy(x),
                                                       policy, 64)).numpy()
    assert np.isnan(rback[1]).all() and np.isnan(back[1]).all()
    np.testing.assert_array_equal(back, rback)   # NaNs in the same places
