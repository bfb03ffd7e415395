"""Unique-name generator (reference: python/paddle/fluid/unique_name.py).

Port of ``paddle_tpu/framework/naming.py``, unchanged: pure Python.
``static.Program.trace`` replays a program's counters through
:class:`guard` so that auto-named parameters keep their names on every
trace."""
from __future__ import annotations

import threading

__all__ = ["unique_name", "reset", "guard"]


class _Namer(threading.local):
    def __init__(self):
        self.counters = {}


_namer = _Namer()


def unique_name(prefix: str = "tmp") -> str:
    idx = _namer.counters.get(prefix, 0)
    _namer.counters[prefix] = idx + 1
    return f"{prefix}_{idx}"


def reset():
    _namer.counters = {}


class guard:
    """Counter save/restore (reference unique_name.guard). The static tier
    replays a Program's trace-time counters on retrace so auto names stay
    stable (fc_0 stays fc_0 instead of minting fc_1).

    ``initial``: counters to install on enter (default: keep current).
    ``commit``: if True, keep the advanced counters on exit (first trace of
    a program must advance the global namer or the NEXT program traced would
    collide on the same names); if False, restore the previous state
    (retraces must not re-advance)."""

    def __init__(self, initial=None, commit=False):
        self._initial = initial
        self._commit = commit

    def __enter__(self):
        self._saved = dict(_namer.counters)
        if self._initial is not None:
            _namer.counters = dict(self._initial)
        return self

    def __exit__(self, *exc):
        if not self._commit:
            _namer.counters = self._saved
        return False
