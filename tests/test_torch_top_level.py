"""Every public top-level name of the JAX package is in the port, or is
listed here with the Queue 1 item (ROADMAP.md) that owns it.

A name is in the port when ``paddle_tpu_torch`` has it as an attribute or
as a subpackage (``paddle_tpu_torch.<name>`` imports). The list must stay
honest both ways: a listed name the port has gained fails the test, so
the list shrinks as items land. Items 21c, 21d and 21e have landed: what
is left is item 22's ``hub`` and the reference module's own imports.
"""
import importlib.util

import paddle_tpu as ref

import paddle_tpu_torch as port
from paddle_tpu_torch.incubate import checkpoint as port_checkpoint
from paddle_tpu_torch.vision import datasets as port_datasets

SLICE_21C = ("Model", "summary", "flops", "callbacks", "model_summary",
             "hapi", "io", "metric", "reader", "batch", "save", "load",
             "DataParallel", "ParamAttr", "Parameter", "create_parameter")

SLICE_21D_21E = ("onnx", "distribution", "monitor", "device", "sysconfig",
                 "utils", "get_flags", "set_flags", "CPUPlace", "CUDAPlace",
                 "CUDAPinnedPlace", "NPUPlace", "TPUPlace", "XPUPlace",
                 "get_device", "set_device", "is_compiled_with_cuda",
                 "is_compiled_with_npu", "is_compiled_with_rocm",
                 "is_compiled_with_tpu", "is_compiled_with_xpu",
                 "get_cudnn_version", "get_cuda_rng_state",
                 "set_cuda_rng_state", "monkey_patch_math_varbase",
                 "monkey_patch_variable", "VarBase", "dtype", "bool",
                 "numpy")

MISSING = {
    # 22: datasets and hub
    "hub": "22",
    # the reference module's own imports, no API: ``from __future__
    # import annotations``, jax, jax.numpy, numpy, framework.dtype
    "annotations": "none", "jax": "none", "jnp": "none", "np": "none",
    "dtype_mod": "none",
}


def _in_port(name):
    return hasattr(port, name) or importlib.util.find_spec(
        f"paddle_tpu_torch.{name}") is not None


def test_every_reference_name_is_present_or_listed():
    names = sorted(n for n in dir(ref) if not n.startswith("_"))
    absent = [n for n in names if not _in_port(n)]
    unlisted = [n for n in absent if n not in MISSING]
    assert not unlisted, f"missing from the port, no item: {unlisted}"
    gained = [n for n in MISSING if _in_port(n)]
    assert not gained, f"listed as missing, present now: {gained}"
    assert set(MISSING) <= set(names)
    assert set(MISSING.values()) <= {"22", "none"}


def test_slice_21c_names_are_exported():
    for name in SLICE_21C:
        assert hasattr(port, name), name
        assert hasattr(ref, name), name
    assert port.Model is port.hapi.Model
    assert port.summary is port.hapi.model_summary.summary
    assert port.batch(lambda: iter(range(3)), 2)
    p = port.create_parameter([2, 3], "float32")
    assert tuple(p.shape) == (2, 3) and p.requires_grad
    b = port.create_parameter([3], "float32", is_bias=True)
    assert float(b.detach().abs().sum()) == 0.0
    assert port_checkpoint.train_epoch_range and port_datasets.FakeData


def test_slice_21d_21e_names_are_exported():
    import torch
    for name in SLICE_21D_21E:
        assert hasattr(port, name), name
        assert hasattr(ref, name), name
    assert port.get_flags is port.framework.flags.get_flags
    assert port.CUDAPlace is port.device.CUDAPlace
    assert port.VarBase is torch.Tensor and port.dtype is torch.dtype
    assert port.bool is torch.bool
    assert (port.numpy(torch.tensor([1.5], dtype=torch.bfloat16))
            == [1.5]).all()
    assert port.CPUPlace().torch_device == torch.device("cpu")
    assert port.is_compiled_with_cuda() == (torch.version.cuda is not None)
    for name in ("tpu", "xpu", "npu", "rocm"):
        assert getattr(port, f"is_compiled_with_{name}")() is False
    assert port.monkey_patch_math_varbase() is None
    assert port.monkey_patch_variable() is None
    assert port.onnx.export and port.utils.run_check
