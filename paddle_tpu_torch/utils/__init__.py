"""paddle_tpu_torch.utils (port of ``paddle_tpu/utils``; reference
python/paddle/utils/): the download cache, the ``deprecated`` decorator,
``unique_name``, the install check ``run_check`` and ``cpp_extension``
(host C++ custom ops)."""
from __future__ import annotations

from ..framework.naming import unique_name  # noqa: F401
from . import cpp_extension  # noqa: F401
from .deprecated import deprecated  # noqa: F401
from .download import get_weights_path_from_url  # noqa: F401
from .install_check import run_check  # noqa: F401

__all__ = ["unique_name", "cpp_extension", "deprecated",
           "get_weights_path_from_url", "run_check", "try_import",
           "require_version"]


def try_import(module_name, err_msg=None):
    """Import-or-explain helper (reference utils/lazy_import.py
    try_import)."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(
            err_msg or f"Optional dependency '{module_name}' is required for "
            f"this API but is not installed.")


def require_version(min_version, max_version=None):
    """Check the installed framework version against a range (reference
    utils/op_version.py require_version semantics on paddle.__version__)."""
    from .. import __version__

    def _tup(v):
        return tuple(int(x) for x in str(v).split(".")[:3] if x.isdigit())

    cur = _tup(__version__)
    if _tup(min_version) > cur:
        raise Exception(
            f"installed version {__version__} < required min {min_version}")
    if max_version is not None and _tup(max_version) < cur:
        raise Exception(
            f"installed version {__version__} > allowed max {max_version}")
    return True
