"""Build and bind machinery for custom C++ ops (see the package docstring).

Port of ``paddle_tpu/utils/cpp_extension/extension_utils.py`` (reference
cpp_extension.py CppExtension/setup, extension_utils.py load with a build
cache keyed on the sources' mtime).
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import sysconfig

__all__ = ["CppExtension", "CUDAExtension", "ExtensionModule", "setup",
           "load"]

_NS = "paddle_tpu_torch_ext"
_LIB = torch.library.Library(_NS, "FRAGMENT")
_defined: set = set()
_define_lock = threading.Lock()


class CppExtension:
    """Declarative build unit for ``setup`` (reference cpp_extension.py
    CppExtension, a setuptools Extension factory)."""

    def __init__(self, sources: Sequence[str], name: Optional[str] = None,
                 extra_compile_args: Optional[List[str]] = None,
                 include_dirs: Optional[List[str]] = None, **kwargs):
        self.name = name
        self.sources = list(sources)
        self.extra_compile_args = list(extra_compile_args or [])
        self.include_dirs = list(include_dirs or [])


def CUDAExtension(*args, **kwargs):
    raise NotImplementedError(
        "CUDAExtension targets nvcc; the port's CUDA kernels are built by "
        "paddle_tpu_torch.ops._build (nvcc for sm_90a, bound with ctypes): "
        "write the device hot path there and host-side C++ as a "
        "CppExtension")


def setup(name: str, ext_modules, **kwargs):
    """Eager build of the extension(s) into the default build directory
    (the wheel packaging of the reference's setup() is out of scope;
    returns the bound module, as ``load`` does)."""
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) \
        else [ext_modules]
    mods = [load(e.name or name, e.sources,
                 extra_cxx_flags=e.extra_compile_args,
                 include_dirs=e.include_dirs) for e in exts]
    return mods[0] if len(mods) == 1 else mods


def _f32p(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_float))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


def _same_size(ts, name):
    """The C ABI passes one element count for every buffer: refuse
    tensors of other sizes before a kernel reads past one."""
    n = ts[0].numel()
    if any(t.numel() != n for t in ts):
        raise ValueError(f"{name}: every input has the first's "
                         f"{n} elements, got {[t.numel() for t in ts]}")
    return ts


def _unique(base: str) -> str:
    with _define_lock:
        name, k = base, 1
        while name in _defined:
            k += 1
            name = f"{base}_{k}"
        _defined.add(name)
        return name


class _CustomOp:
    """One registered op as a ``torch.library`` op of the host kernel."""

    def __init__(self, dll, index: int, name: str, n_inputs: int,
                 has_grad: bool, lib_name: str):
        self._dll = dll
        self._index = index
        self.name = name
        self.n_inputs = n_inputs
        self.has_grad = has_grad
        self.op = self._register(_unique(f"{lib_name}_{name}"))

    # host kernels ----------------------------------------------------------
    def _host_forward(self, *xs):
        ins = _same_size([_host(x) for x in xs], self.name)
        out = torch.empty_like(ins[0])
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(ins))(
            *[_f32p(t) for t in ins])
        self._dll.pd_ext_op_forward(self._index, ptrs, len(ins), _f32p(out),
                                    out.numel())
        return out.to(xs[0].device)

    def _host_backward(self, xs, gout):
        ins = _same_size([_host(x) for x in xs] + [_host(gout)], self.name)
        g = ins.pop()
        gins = [torch.zeros_like(t) for t in ins]
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(ins))(
            *[_f32p(t) for t in ins])
        gptrs = (ctypes.POINTER(ctypes.c_float) * len(gins))(
            *[_f32p(t) for t in gins])
        self._dll.pd_ext_op_backward(self._index, ptrs, len(ins), _f32p(g),
                                     gptrs, g.numel())
        return [t.to(x.device) for t, x in zip(gins, xs)]

    # torch.library ---------------------------------------------------------
    def _register(self, qual: str):
        n = self.n_inputs
        args = ", ".join(f"Tensor x{i}" for i in range(n))
        _LIB.define(f"{qual}({args}) -> Tensor")
        _LIB.impl(qual, lambda *xs: self._host_forward(*xs),
                  "CompositeExplicitAutograd")
        torch.library.register_fake(
            f"{_NS}::{qual}",
            lambda *xs: torch.empty_like(xs[0], dtype=torch.float32),
            lib=_LIB)
        op = getattr(getattr(torch.ops, _NS), qual)
        if not self.has_grad:
            return op
        _LIB.define(f"{qual}_grad({args}, Tensor gout) -> Tensor[]")
        _LIB.impl(f"{qual}_grad",
                  lambda *xs: self._host_backward(xs[:-1], xs[-1]),
                  "CompositeExplicitAutograd")
        torch.library.register_fake(
            f"{_NS}::{qual}_grad",
            lambda *xs: [torch.empty_like(x, dtype=torch.float32)
                         for x in xs[:-1]], lib=_LIB)
        grad_op = getattr(getattr(torch.ops, _NS), f"{qual}_grad")

        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        def backward(ctx, g):
            xs = ctx.saved_tensors
            grads = grad_op(*xs, g)
            return tuple(gi.to(x.dtype) for gi, x in zip(grads, xs))

        torch.library.register_autograd(f"{_NS}::{qual}", backward,
                                        setup_context=setup_context,
                                        lib=_LIB)
        return op

    def __call__(self, *args):
        if len(args) != self.n_inputs:
            raise TypeError(f"{self.name} expects {self.n_inputs} inputs, "
                            f"got {len(args)}")
        args = [a if isinstance(a, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                for a in args]
        return self.op(*args)


class ExtensionModule:
    """Namespace of the ops loaded from one shared library."""

    def __init__(self, dll, lib_path: str, lib_name: str):
        self._dll = dll
        self._lib_path = lib_path
        self._ops: Dict[str, _CustomOp] = {}
        for i in range(dll.pd_ext_num_ops()):
            name = dll.pd_ext_op_name(i).decode()
            op = _CustomOp(dll, i, name, dll.pd_ext_op_n_inputs(i),
                           bool(dll.pd_ext_op_has_grad(i)), lib_name)
            self._ops[name] = op
            setattr(self, name, op)

    def op_names(self) -> List[str]:
        return sorted(self._ops)


@functools.lru_cache(maxsize=None)
def _load_cached(name, sources, cxx_flags, include_dirs, build_directory):
    sources = list(sources)
    build_dir = build_directory or sysconfig.get_lib()
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, f"lib{name}.so")
    stale = (not os.path.exists(lib_path)
             or any(os.path.getmtime(s) > os.path.getmtime(lib_path)
                    for s in sources))
    if stale:
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = (["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-I", sysconfig.get_include()]
               + [f"-I{d}" for d in include_dirs]
               + list(cxx_flags) + ["-o", tmp] + sources)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"custom-op build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    dll = ctypes.CDLL(lib_path)
    c = ctypes
    pp_f32 = c.POINTER(c.POINTER(c.c_float))
    dll.pd_ext_num_ops.restype = c.c_int
    dll.pd_ext_op_name.restype = c.c_char_p
    dll.pd_ext_op_name.argtypes = [c.c_int]
    dll.pd_ext_op_n_inputs.restype = c.c_int
    dll.pd_ext_op_n_inputs.argtypes = [c.c_int]
    dll.pd_ext_op_has_grad.restype = c.c_int
    dll.pd_ext_op_has_grad.argtypes = [c.c_int]
    dll.pd_ext_op_forward.argtypes = [c.c_int, pp_f32, c.c_int,
                                      c.POINTER(c.c_float), c.c_int64]
    dll.pd_ext_op_backward.argtypes = [c.c_int, pp_f32, c.c_int,
                                       c.POINTER(c.c_float), pp_f32,
                                       c.c_int64]
    return ExtensionModule(dll, lib_path, name)


def load(name: str, sources: Sequence[str],
         extra_cxx_flags: Optional[Sequence[str]] = None,
         include_dirs: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None,
         verbose: bool = False) -> ExtensionModule:
    """JIT-build and bind a custom-op source (reference:
    cpp_extension.load). Returns a module-like object with one callable
    op per PD_EXT_REGISTER in the source."""
    return _load_cached(name, tuple(sources),
                        tuple(extra_cxx_flags or ()),
                        tuple(include_dirs or ()), build_directory)
