"""paddle_tpu_torch.inference — the predictor API and serving.

Port of ``paddle_tpu/inference/__init__.py`` (reference:
paddle/fluid/inference/api/ — AnalysisPredictor, CreatePaddlePredictor;
python surface paddle.inference with Config / create_predictor / handles).
The artifact is ``jit.save``'s ``torch.export`` program (``<prefix>.pt2``)
and its weights (``<prefix>.pdiparams``); the handle API
(get_input_handle / copy_from_cpu / run / copy_to_cpu) is the reference's.

Device: ``Config`` asks for the card unless ``disable_gpu()`` asks for the
CPU. A ``Predictor`` on the card raises when there is none, and raises
when the artifact was exported on another device than the one asked for:
a program is never moved silently.

Submodules, imported lazily: ``serving`` (``InferenceServer``,
``DecodeServer``), ``quant`` (int8/int4 weight quantization),
``executor_cache``, ``fleet`` (``ServingFleet``), ``kv_cache``,
``decode_model`` and ``spec_decode``.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device

_SUFFIXES = (".pt2", ".stablehlo", ".pdmodel", ".json")


class Config:
    """reference: paddle_analysis_config.h AnalysisConfig (python
    paddle.inference.Config). Holds the model path, the device and the
    weight quantization; the CUDA/TRT/MKLDNN toggles are accepted for
    source compatibility and warn once that they do nothing here."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None:
            for suffix in _SUFFIXES:
                if prog_file.endswith(suffix):
                    prog_file = prog_file[:-len(suffix)]
                    break
        self._prefix = prog_file
        self._device = None  # None: the card
        self._enable_profile = False
        self._memory_pool_mb = 0
        self._weight_quant = None  # (policy, block) once enabled

    # -- model ---------------------------------------------------------------
    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        """Point the config at a new model WITHOUT wiping the device /
        profiling / quantization choices already made on it."""
        kept = (self._device, self._enable_profile, self._memory_pool_mb,
                self._weight_quant)
        self.__init__(prog_file, params_file)
        (self._device, self._enable_profile, self._memory_pool_mb,
         self._weight_quant) = kept

    def prog_file(self) -> str:
        return (self._prefix or "") + ".pt2"

    def params_file(self) -> str:
        return (self._prefix or "") + ".pdiparams"

    def model_dir(self) -> str:
        return os.path.dirname(self._prefix or "")

    # -- device --------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        """Serve on card ``device_id``."""
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device = None if device_id == 0 else f"cuda:{device_id}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def device(self) -> torch.device:
        """The device a Predictor of this config runs on (raises when it
        is the card and there is none)."""
        return resolve_device(self._device)

    def enable_profile(self):
        self._enable_profile = True

    # -- weight quantization ---------------------------------------------
    def enable_weight_quantize(self, policy: str = "int8",
                               block: Optional[int] = None):
        """Serve with block-quantized weights (int8/int4 at rest, see
        ``inference.quant``)."""
        if policy not in ("int8", "int4"):
            raise ValueError(f"weight quant policy must be int8/int4, "
                             f"got {policy!r}")
        self._weight_quant = (policy, block)

    # accepted-but-inert reference toggles; each warns once per process
    _warned_toggles: set = set()

    def _inert(self, name: str, owner: str):
        if name not in Config._warned_toggles:
            Config._warned_toggles.add(name)
            import warnings
            warnings.warn(
                f"Config.{name} is accepted for source compatibility but "
                f"has no effect in paddle_tpu_torch: {owner}", stacklevel=3)

    def switch_ir_optim(self, flag: bool = True):
        self._inert("switch_ir_optim",
                    "the exported program runs as torch.export traced it")

    def enable_memory_optim(self):
        self._inert("enable_memory_optim",
                    "PyTorch's caching allocator owns memory reuse")

    def enable_tensorrt_engine(self, *a, **kw):
        self._inert("enable_tensorrt_engine",
                    "there is no TensorRT path; the program runs eagerly")

    def enable_mkldnn(self):
        self._inert("enable_mkldnn",
                    "there is no oneDNN switch; PyTorch picks its CPU "
                    "kernels")

    def set_cpu_math_library_num_threads(self, n: int):
        self._inert("set_cpu_math_library_num_threads",
                    "use torch.set_num_threads")


def _host(o) -> np.ndarray:
    """An output on the host (bfloat16 as float32: numpy has no
    bfloat16)."""
    if isinstance(o, torch.Tensor):
        o = o.detach()
        if o.dtype == torch.bfloat16:
            o = o.float()
        return o.cpu().numpy()
    return np.asarray(o)


class Tensor:
    """Input/output handle (reference: paddle_tensor.h ZeroCopyTensor —
    copy_from_cpu/copy_to_cpu)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self._name = name
        self._owner = owner
        self._is_input = is_input

    def name(self) -> str:
        return self._name

    def copy_from_cpu(self, data):
        assert self._is_input, "cannot write an output handle"
        self._owner._inputs[self._name] = np.ascontiguousarray(data)

    def copy_to_cpu(self):
        assert not self._is_input, "cannot read an input handle"
        return _host(self._owner._outputs[self._name])

    def shape(self):
        store = (self._owner._inputs if self._is_input
                 else self._owner._outputs)
        return list(store[self._name].shape)


# Per-prefix load cache: N predictors over the same artifact share ONE
# loaded layer (program + weights). Keyed on (abspath, quant, the mtime_ns
# and size of both files), so a re-saved model is reloaded, not served
# stale. Weight-quantized views are cached next to the raw layer under the
# quant spec.
#
# Hot-swap: when a new generation overwrites the artifact in place, the
# incumbent's entry must survive until the rollout is decided (a rollback
# that re-stats the files would load the very bytes it rolls back from).
# The fleet pins the incumbent's key (``pin_layer``) and loads through
# ``Predictor(config, layer_key=key)``; pinned entries are immune to
# ``evict_stale_layers``.
_LAYER_CACHE: Dict[tuple, object] = {}
_LAYER_CACHE_PINS: Dict[tuple, int] = {}
_LAYER_CACHE_LOCK = threading.Lock()


def _layer_cache_key(prefix: str, quant=None) -> tuple:
    key = [os.path.abspath(prefix), quant]
    for suffix in (".pt2", ".pdiparams"):
        try:
            st = os.stat(prefix + suffix)
            key.append((st.st_mtime_ns, st.st_size))
        except OSError:
            key.append(None)
    return tuple(key)


def layer_cache_key(prefix: str, quant=None) -> tuple:
    """Public form of the cache key for the artifact currently on disk —
    capture it BEFORE a hot-swap overwrites the files, then pin it."""
    return _layer_cache_key(prefix, quant)


def pin_layer(key: tuple) -> None:
    """Refcount-pin a cache entry so eviction never drops it."""
    with _LAYER_CACHE_LOCK:
        _LAYER_CACHE_PINS[key] = _LAYER_CACHE_PINS.get(key, 0) + 1


def unpin_layer(key: tuple) -> None:
    with _LAYER_CACHE_LOCK:
        n = _LAYER_CACHE_PINS.get(key, 0) - 1
        if n > 0:
            _LAYER_CACHE_PINS[key] = n
        else:
            _LAYER_CACHE_PINS.pop(key, None)


def evict_stale_layers() -> int:
    """Drop cache entries whose artifact files changed since load, except
    pinned ones. Returns the number evicted."""
    evicted = 0
    with _LAYER_CACHE_LOCK:
        for key in list(_LAYER_CACHE):
            if _LAYER_CACHE_PINS.get(key):
                continue
            prefix, quant = key[0], key[1]
            if _layer_cache_key(prefix, quant) != key:
                del _LAYER_CACHE[key]
                evicted += 1
    return evicted


def _load_layer(prefix: str, quant=None, key: Optional[tuple] = None):
    """Load (or fetch cached) the layer for ``prefix``. ``key`` asks for a
    SPECIFIC cached generation: if its entry is gone and the files no
    longer match it, this raises ``KeyError`` rather than serve the wrong
    model."""
    if key is not None:
        with _LAYER_CACHE_LOCK:
            layer = _LAYER_CACHE.get(key)
        if layer is not None:
            return layer
        if _layer_cache_key(prefix, quant) != key:
            raise KeyError(
                f"pinned layer generation {key!r} is not cached and the "
                f"on-disk artifact no longer matches it")
    key = _layer_cache_key(prefix, quant) if key is None else key
    with _LAYER_CACHE_LOCK:
        layer = _LAYER_CACHE.get(key)
    if layer is not None:
        return layer
    if quant is None:
        from .. import jit
        layer = jit.load(prefix)
    else:
        from . import quant as quant_mod
        layer, _ = quant_mod.quantized_layer(
            _load_layer(prefix), policy=quant[0], block=quant[1])
    with _LAYER_CACHE_LOCK:
        return _LAYER_CACHE.setdefault(key, layer)


def clear_layer_cache():
    with _LAYER_CACHE_LOCK:
        _LAYER_CACHE.clear()
        _LAYER_CACHE_PINS.clear()


class Predictor:
    """reference: AnalysisPredictor. Loads the artifact once (shared per
    prefix across a pool); ``run`` executes the program on its device."""

    def __init__(self, config: Config, layer_key: Optional[tuple] = None):
        self._config = config
        device = config.device()
        self._layer = _load_layer(config._prefix, config._weight_quant,
                                  key=layer_key)
        if self._layer.device != device:
            raise ValueError(
                f"{config.prog_file()} was exported on "
                f"{self._layer.device}, the config asks for {device}: a "
                f"program runs on the device it was exported on (save it "
                f"again there)")
        self._layer_key = (layer_key if layer_key is not None
                           else _layer_cache_key(config._prefix,
                                                 config._weight_quant))
        self._input_names = [f"x{i}" for i in range(self._n_user_inputs())]
        self._output_names = ["out0"]
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, object] = {}

    def _n_user_inputs(self) -> int:
        layer = self._layer
        try:
            # jit.save exports (params, buffers, *args): the signature's
            # user inputs are every weight, then the args
            n = len(layer._exported.graph_signature.user_inputs) \
                - len(layer._params) - len(layer._buffers)
            return max(n, 1)
        except Exception:
            # a foreign export: serve one positional input rather than
            # crash
            return 1

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name: str) -> Tensor:
        assert name in self._input_names, name
        return Tensor(name, self, True)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self, False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Execute. Either pass a positional list (returns the outputs as
        host arrays) or pre-fill input handles and read output handles."""
        if inputs is None:
            inputs = [self._inputs[n] for n in self._input_names]
        out = self._layer(*inputs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = {n: o for n, o in zip(self._output_names, outs)}
        return [_host(o) for o in outs]

    def clear_intermediate_tensor(self):
        self._inputs.clear()
        self._outputs.clear()


def create_predictor(config: Config) -> Predictor:
    """reference: CreatePaddlePredictor (analysis_predictor.cc:1197)."""
    return Predictor(config)


__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "clear_layer_cache", "layer_cache_key", "pin_layer",
           "unpin_layer", "evict_stale_layers"]


class DataType:
    """reference paddle_infer_declare.h PaddleDType."""
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT64 = "int64"
    INT32 = "int32"
    UINT8 = "uint8"
    INT8 = "int8"
    BOOL = "bool"


class PlaceType:
    """reference place tags."""
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    TPU = 3


class PrecisionType:
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.FLOAT16: 2,
                DataType.BFLOAT16: 2, DataType.INT64: 8,
                DataType.INT32: 4, DataType.UINT8: 1, DataType.INT8: 1,
                DataType.BOOL: 1}


def get_num_bytes_of_data_type(dtype) -> int:
    """reference inference/api/paddle_inference_api.h."""
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError:
        raise ValueError(f"unknown inference DataType {dtype!r}") from None


def get_version() -> str:
    from .. import __version__
    return f"paddle_tpu_torch {__version__}"


class PredictorPool:
    """reference paddle_infer::services::PredictorPool — N predictors over
    one config, sharing the loaded layer; each keeps its own IO handles."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        self._preds = [create_predictor(config) for _ in range(size)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]

    def __len__(self):
        return len(self._preds)


__all__ += ["DataType", "PlaceType", "PrecisionType", "PredictorPool",
            "get_num_bytes_of_data_type", "get_version"]


def __getattr__(name):
    # lazy submodules: the base handle API stays import-light
    if name in ("serving", "quant", "kv_cache", "decode_model",
                "fleet", "executor_cache", "spec_decode"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
