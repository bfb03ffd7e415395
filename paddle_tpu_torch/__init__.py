"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's module paths (``inference/kv_cache.py``,
``inference/serving.py``, ``ops/paged_attention.py`` ...) so a reader finds
each module's counterpart. It imports ``torch`` and never ``jax`` or any
module of ``paddle_tpu``; the JAX package stays the reference that the
tests hold this package against.

Every hot-path kernel is a hand-written CUDA kernel for Hopper (``sm_90a``)
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``) and
bound with ``ctypes``. Each kernel keeps a plain PyTorch version beside it;
a wrapper takes the plain version only for a tensor that lies on the CPU.

Entry points place their state on the card unless the caller passes
``device="cpu"``; without a card they raise.

Ported so far: decode serving on the paged KV cache (``inference``), with
the paged decode/verify attention kernel; GPT training on one device
(``text.models.gpt``, ``nn``, ``optimizer`` with its LR schedulers,
``regularizer``, ``distributed.engine`` with remat and gradient merge,
``framework.random``), with the flash-attention forward, dq and dk/dv
kernels and the fused LM-head cross-entropy forward, dh and dw kernels;
data-parallel training over ``torch.distributed`` (``distributed``: env,
mesh, collectives, the compressed int8/int4 gradient exchange,
``DataParallel``, ``spawn``, the data-parallel ``ParallelTrainer``) and
``amp`` (``auto_cast``, ``decorate``, ``GradScaler``); the tuning DB with
the port's split counts measured on the card (``ops.tuner``), the run's
telemetry artifacts (``telemetry.scope``, ``export``, ``aggregate``,
``calibration``), host and device profiling (``profiler``), checkpoints
(``distributed.checkpoint``, ``framework_io``, the optimizer's and the
trainer's state) and the retry policy (``resilience.retry``); the
resilient training runtime (``resilience``); and the serving tier:
export and load (``jit``: ``torch.export`` programs), the predictor API
with int8/int4 weight quantization (``inference``, ``inference.quant``),
the executor cache and the self-healing serving fleet
(``inference.executor_cache``, ``inference.fleet``); hybrid parallelism
(ZeRO, tensor, pipeline and context parallelism); the mixture of experts
with expert parallelism (``incubate``), the sharded embedding lookup
(``ops.sharded_embedding``) and LocalSGD
(``distributed.meta_parallel.localsgd``); the ResNet family
(``vision``) with the convolutions, pooling, batch norm and activations
of ``nn``; and the program analysis (``analysis``: a step traced on fake
tensors, every kernel one node, with its cost, lint rules, collective
schedules and fingerprints, and ``python -m paddle_tpu_torch.analysis.lint``)
with the planner (``distributed.auto``); BERT/ERNIE pretraining
(``text.models.bert``); and the parameter-server tier
(``distributed.ps``: the native host tables, their TCP service, the
Hogwild/Downpour trainers, the host-table embedding and the hot tier on
the card) with Wide&Deep and DeepFM (``rec``); and the declarative
mode: the tensor API at the top level (``paddle_tpu_torch.add``,
``.reshape``, ``.matmul`` ... from ``tensor``), ``autograd``, dy2static
with ``jit.to_static``/``TracedLayer`` and ``static`` (``Program``,
``Executor``, ``static.nn``, ``static.amp``), whose programs are
``torch.fx`` graphs traced once and executed; and the high-level API
with its data path: ``io`` (datasets, samplers, the multi-process
``DataLoader``), ``reader``/``batch``, ``metric``, ``hapi`` (``Model``
with ``fit``/``evaluate``/``predict``, the callbacks, ``summary`` and
``flops``) and ``incubate.checkpoint`` (the auto-checkpoint).

The tensor API's star import shadows Python's ``abs``, ``max``, ``min``,
``sum``, ``round``, ``all``, ``any``, ``pow`` and ``slice`` in this
module's namespace only, as ``paddle`` does.
"""
__version__ = "0.1.0"

import torch as _torch

from .framework.dtype import (  # noqa: F401,E402
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8)
from .framework.random import get_rng_state_tracker, seed  # noqa: F401,E402

# -- tensor ops at top level (paddle.add, paddle.reshape, ...) ---------------
from .tensor import *  # noqa: F401,F403,E402
from .tensor import (array, creation, inplace, linalg,  # noqa: F401,E402
                     logic, manipulation, math, random, stat)
from . import tensor  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import static  # noqa: F401,E402
from .autograd import grad, no_grad, set_grad_enabled  # noqa: F401,E402
# -- the high-level API and the data path ------------------------------------
from . import io, metric, reader  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from .batch import batch  # noqa: F401,E402
from .framework_io import load, save  # noqa: F401,E402
from .hapi import callbacks, model_summary  # noqa: F401,E402
from .hapi.model import Model  # noqa: F401,E402
from .hapi.model_summary import flops, summary  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402
from .nn import Parameter, ParamAttr  # noqa: F401,E402
# -- onnx and the small modules ----------------------------------------------
from . import onnx  # noqa: F401,E402
from . import device, distribution, monitor, sysconfig, utils  # noqa: F401,E402
from .framework.flags import get_flags, set_flags  # noqa: F401,E402
from .device import (  # noqa: F401,E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, TPUPlace, XPUPlace,
    get_cuda_rng_state, get_cudnn_version, get_device,
    is_compiled_with_cuda, is_compiled_with_npu, is_compiled_with_rocm,
    is_compiled_with_tpu, is_compiled_with_xpu, numpy, set_cuda_rng_state,
    set_device)

__all__ = ["amp", "analysis", "autograd", "distributed", "framework",
           "framework_io", "incubate",
           "inference", "jit", "nn", "ops", "optimizer", "profiler",
           "rec", "regularizer", "resilience", "static", "telemetry",
           "tensor", "text", "vision", "grad", "no_grad",
           "set_grad_enabled", "in_dynamic_mode", "enable_static",
           "disable_static", "in_dygraph_mode", "seed", "io", "metric",
           "reader", "hapi", "batch", "load", "save", "callbacks",
           "model_summary", "Model", "flops", "summary", "DataParallel",
           "Parameter", "ParamAttr", "create_parameter", "onnx", "device",
           "distribution", "monitor", "sysconfig", "utils", "get_flags",
           "set_flags", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "TPUPlace", "XPUPlace", "NPUPlace", "get_device", "set_device",
           "is_compiled_with_cuda", "is_compiled_with_npu",
           "is_compiled_with_rocm", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "get_cudnn_version", "get_cuda_rng_state",
           "set_cuda_rng_state", "monkey_patch_math_varbase",
           "monkey_patch_variable", "VarBase", "dtype", "bool", "numpy"]

_static_mode = False


def in_dynamic_mode() -> bool:
    """True outside a trace and outside the ``enable_static()`` mode (the
    reference's dygraph/static switch, fluid/framework.py:185)."""
    if _static_mode:
        return False
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    return get_proxy_mode() is None


def disable_static(place=None):
    global _static_mode
    _static_mode = False


def enable_static():
    """reference paddle.enable_static. There is no global graph mode:
    ``static.Program.trace`` stages a function; this flips the flag that
    ``in_dynamic_mode`` reads."""
    global _static_mode
    _static_mode = True


def in_dygraph_mode() -> bool:
    return not _static_mode


enable_dygraph = disable_static
disable_dygraph = enable_static
Tensor = _torch.Tensor

# -- source-compat aliases (reference python/paddle/__init__.py) -------------
VarBase = Tensor                      # fluid core.VarBase -> torch.Tensor
dtype = _torch.dtype                  # paddle.dtype
bool = _torch.bool                    # noqa: A001  (dtype alias, as paddle)


def monkey_patch_math_varbase():
    """No-op: torch.Tensor already carries the operator overloads (the
    reference patches VarBase with math dunders at import)."""


def monkey_patch_variable():
    """No-op: see monkey_patch_math_varbase."""


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone parameter (reference framework create_parameter):
    ``default_initializer``, else ``Constant(0)`` for a bias and
    ``XavierNormal`` for a weight."""
    from .framework.dtype import convert_dtype
    from .nn.initializer import Constant, XavierNormal
    init = default_initializer or (Constant(0.0) if is_bias
                                   else XavierNormal())
    return _torch.nn.Parameter(init(tuple(shape), convert_dtype(dtype)))
