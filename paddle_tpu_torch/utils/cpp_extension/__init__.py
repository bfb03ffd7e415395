"""Out-of-tree custom C++ ops (port of ``paddle_tpu/utils/cpp_extension``;
reference python/paddle/utils/cpp_extension/: CppExtension,
CUDAExtension, setup, load).

The C++ kernel is a host function behind the C ABI of the repo's
``csrc/paddle_ext.h``. ``load()`` compiles it with g++ into
``paddle_tpu_torch/_build/`` (or ``build_directory``), binds it with
ctypes and registers each op as a ``torch.library`` custom op: the
forward runs on the host (inputs copied to CPU float32, the result copied
back to the first input's device), the reference's ``pure_callback``; a
registered backward becomes the op's autograd, the reference's
``custom_vjp``. Each op is one node under ``make_fx`` and
``jit.to_static``, and keeps its backward there.
"""
from .extension_utils import (CppExtension, CUDAExtension,  # noqa: F401
                              ExtensionModule, load, setup)

__all__ = ["CppExtension", "CUDAExtension", "ExtensionModule", "load",
           "setup"]
