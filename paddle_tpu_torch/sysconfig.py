"""paddle_tpu_torch.sysconfig (port of ``paddle_tpu/sysconfig.py``;
reference python/paddle/sysconfig.py: ``get_include``/``get_lib`` for
building custom C++ ops).

The custom-op ABI is the repo's shared native header ``csrc/paddle_ext.h``
(at the root, beside the package); ``utils.cpp_extension`` builds against
it into the git-ignored ``paddle_tpu_torch/_build/``.
"""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]


def _package() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    """Directory of the C headers for custom-op extensions (the root
    ``csrc/``)."""
    return os.path.join(os.path.dirname(_package()), "csrc")


def get_lib() -> str:
    """Directory the port's native libraries are built into."""
    return os.path.join(_package(), "_build")
