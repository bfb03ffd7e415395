"""Every public top-level name of the JAX package is in the port, or is
listed here with the Queue 1 item (ROADMAP.md) that owns it.

A name is in the port when ``paddle_tpu_torch`` has it as an attribute or
as a subpackage (``paddle_tpu_torch.<name>`` imports). The list must stay
honest both ways: a listed name the port has gained fails the test, so
the list shrinks as items land. Item 21c's names, this slice's, are all
present.
"""
import importlib.util

import paddle_tpu as ref

import paddle_tpu_torch as port
from paddle_tpu_torch.incubate import checkpoint as port_checkpoint
from paddle_tpu_torch.vision import datasets as port_datasets

SLICE_21C = ("Model", "summary", "flops", "callbacks", "model_summary",
             "hapi", "io", "metric", "reader", "batch", "save", "load",
             "DataParallel", "ParamAttr", "Parameter", "create_parameter")

MISSING = {
    # 21d: onnx/*
    "onnx": "21d",
    # 21e: the small modules and the reference's device and compat names
    "distribution": "21e", "monitor": "21e", "device": "21e",
    "sysconfig": "21e", "utils": "21e", "get_flags": "21e",
    "set_flags": "21e", "CPUPlace": "21e", "CUDAPlace": "21e",
    "CUDAPinnedPlace": "21e", "NPUPlace": "21e", "TPUPlace": "21e",
    "XPUPlace": "21e", "get_device": "21e", "set_device": "21e",
    "is_compiled_with_cuda": "21e", "is_compiled_with_npu": "21e",
    "is_compiled_with_rocm": "21e", "is_compiled_with_tpu": "21e",
    "is_compiled_with_xpu": "21e", "get_cudnn_version": "21e",
    "get_cuda_rng_state": "21e", "set_cuda_rng_state": "21e",
    "monkey_patch_math_varbase": "21e", "monkey_patch_variable": "21e",
    "VarBase": "21e", "dtype": "21e", "bool": "21e", "numpy": "21e",
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
    assert set(MISSING.values()) <= {"21d", "21e", "22", "none"}


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
