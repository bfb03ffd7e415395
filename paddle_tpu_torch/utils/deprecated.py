"""Deprecation decorator (port of ``paddle_tpu/utils/deprecated.py``;
reference python/paddle/utils/deprecated.py)."""
from __future__ import annotations

import functools
import warnings


def deprecated(update_to: str = "", since: str = "", reason: str = ""):
    def decorator(fn):
        msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f", use {update_to} instead"
        if reason:
            msg += f". Reason: {reason}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator
