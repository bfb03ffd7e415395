"""Global runtime flags (port of ``paddle_tpu/framework/flags.py``;
reference platform/flags.cc, with ``paddle.set_flags``/``get_flags``).

One in-process registry, initialised from ``FLAGS_*`` environment
variables as gflags' env fallback is. The flags that set the CUDA
allocator or cuDNN are accepted and kept for the API (PyTorch's caching
allocator and cuDNN's own heuristics decide those here); the debugging
flags are live:

- ``FLAGS_check_nan_inf``: ``ParallelTrainer.train_step`` calls
  :func:`check_numerics` on the loss and the parameters after each step
  (a host read of each, so only for debugging);
- ``FLAGS_benchmark``: the trainer synchronizes the card after each step.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch
import torch.utils._pytree as pytree

__all__ = ["set_flags", "get_flags", "flag", "check_numerics"]

_REGISTRY: Dict[str, Any] = {}


def _define(name: str, default, help_: str = ""):
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _REGISTRY[name] = default


# Debugging / numerics (live)
_define("check_nan_inf", False, "scan the loss and params after each step")
_define("check_replication", False,
        "verify params declared replicated are bit-identical on every "
        "rank after each step")
_define("benchmark", False, "synchronise the card after each step")
_define("check_kernel_launch", False, "alias of benchmark")
# Threading / host
_define("paddle_num_threads", 1, "host threads for data feed")
# Memory flags (kept for the API: PyTorch's caching allocator decides)
_define("fraction_of_gpu_memory_to_use", 0.92, "kept for the API")
_define("initial_gpu_memory_in_mb", 0, "kept for the API")
_define("reallocate_gpu_memory_in_mb", 0, "kept for the API")
_define("memory_fraction_of_eager_deletion", 1.0, "kept for the API")
_define("eager_delete_tensor_gb", 0.0, "kept for the API")
_define("allocator_strategy", "auto_growth", "kept for the API")
_define("use_pinned_memory", True, "host staging buffers")
# cudnn/conv flags (kept for the API)
_define("cudnn_deterministic", False, "kept for the API")
_define("cudnn_exhaustive_search", False, "kept for the API")
_define("conv_workspace_size_limit", 512, "kept for the API")
# Distributed
_define("sync_nccl_allreduce", True, "kept for the API")


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags — accepts both 'FLAGS_x' and bare 'x' keys."""
    for k, v in flags.items():
        name = k[6:] if k.startswith("FLAGS_") else k
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        _REGISTRY[name] = v


def get_flags(flags):
    """paddle.get_flags — returns {'FLAGS_x': value}."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        name = k[6:] if k.startswith("FLAGS_") else k
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        out["FLAGS_" + name] = _REGISTRY[name]
    return out


def flag(name: str):
    return _REGISTRY[name]


def check_numerics(tree, tag: str = ""):
    """Host-side NaN/Inf scan over a tree of tensors or arrays when
    FLAGS_check_nan_inf is on. Raises FloatingPointError naming the first
    bad leaf by its path, spelled as ``jax.tree_util.keystr`` spells it
    (``['g']``, ``[0]``), like the reference's enforce failure."""
    if not _REGISTRY["check_nan_inf"]:
        return
    import numpy as np
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf.detach()).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(
                "FLAGS_check_nan_inf: non-finite value in "
                f"{tag}{pytree.keystr(path)}")
