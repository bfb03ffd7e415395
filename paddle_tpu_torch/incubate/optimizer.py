"""Incubate optimizers (port of ``paddle_tpu/incubate/optimizer.py``;
reference python/paddle/incubate/optimizer/ lookahead.py LookAhead,
modelaverage.py ModelAverage).

Both follow the port's functional optimizer API (``init_state``,
``apply_gradients`` over ``{key: tensor}`` dicts, ``optimizer/
optimizer.py``), so they run inside ``ParallelTrainer`` and under the
eager ``step()`` alike; their counters are 0-d int32 tensors on the
parameters' device, so a step reads no host value.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from ..optimizer.optimizer import Optimizer

__all__ = ["LookAhead", "ModelAverage"]


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device if params else \
        torch.device("cpu")


class LookAhead(Optimizer):
    """k-step lookahead (reference lookahead.py:28): the inner optimizer
    advances "fast" weights every step; every ``k`` steps the "slow"
    weights move ``alpha`` of the way toward the fast ones and the fast
    weights are reset onto them."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if not (isinstance(k, int) and k >= 1):
            raise ValueError(f"k must be a positive integer, got {k}")
        super().__init__(learning_rate=inner_optimizer._lr)
        self._parameter_list = inner_optimizer._parameter_list
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, value):
        self.inner_optimizer.set_lr(value)

    def init_slots(self, value):
        return self.inner_optimizer.init_slots(value)

    def init_state(self, params: Dict[str, torch.Tensor]):
        """The inner optimizer's ``{"step", "slots"}`` (so the trainer's
        checkpoints and ZeRO slices see an optimizer state of the usual
        form) plus the slow weights and the lookahead's own step count.
        The reference nests the inner state under ``"inner"``."""
        return {**self.inner_optimizer.init_state(params),
                "slow": {n: v.detach().to(torch.float32).clone()
                         for n, v in params.items()},
                "la_step": torch.zeros((), dtype=torch.int32,
                                       device=_device_of(params))}

    def apply_gradients(self, params, grads, state, lr=None,
                        lr_scales: Optional[Dict[str, float]] = None,
                        split=None):
        inner = {k: v for k, v in state.items()
                 if k not in ("slow", "la_step")}
        fast, inner_state = self.inner_optimizer.apply_gradients(
            params, grads, inner, lr=lr, lr_scales=lr_scales, split=split)
        step = state["la_step"] + 1
        sync = (step % self.k) == 0
        out, slow = {}, {}
        for n in fast:
            f32 = fast[n].to(torch.float32)
            s = state["slow"][n]
            merged = s + self.alpha * (f32 - s)
            slow[n] = torch.where(sync, merged, s)
            out[n] = torch.where(sync, merged, f32).to(fast[n].dtype)
        return out, {**inner_state, "slow": slow, "la_step": step}


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (reference modelaverage.py:30):
    each step accumulates the post-update parameters; ``apply()`` swaps
    the window average into the model for evaluation, ``restore()`` swaps
    the live weights back.

    The reference's 3-bucket scheme (sum_1/sum_2/sum_3 with
    shift-on-window-full) is kept so old parameters age out once the
    window (clip(num_updates*rate, min, max)) fills.
    """

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000000, name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._backup = None

    def init_state(self, params: Dict[str, torch.Tensor]):
        dev = _device_of(params)

        def zeros():
            return {n: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                    for n, v in params.items()}

        count = {k: torch.zeros((), dtype=torch.int32, device=dev)
                 for k in ("num_1", "num_2", "num_3", "num_updates")}
        return {"sum_1": zeros(), "sum_2": zeros(), "sum_3": zeros(),
                **count}

    def apply_gradients(self, params, grads, state, lr=None, lr_scales=None,
                        split=None):
        """Accumulate ``params`` (gradients are ignored: run this AFTER
        the main optimizer's step, like the reference's separate
        ModelAverage.step())."""
        num_updates = state["num_updates"] + 1
        window = torch.clamp((num_updates.to(torch.float32) * self.rate)
                             .to(torch.int32), self.min_window,
                             self.max_window)
        num_1 = state["num_1"] + 1
        full = num_1 >= window
        new = {
            "num_updates": num_updates,
            "num_3": torch.where(full, state["num_2"], state["num_3"]),
            "num_2": torch.where(full, num_1, state["num_2"]),
            "num_1": torch.where(full, torch.zeros_like(num_1), num_1),
        }
        s1, s2, s3 = {}, {}, {}
        for n, p in params.items():
            acc = state["sum_1"][n] + p.detach().to(torch.float32)
            s3[n] = torch.where(full, state["sum_2"][n], state["sum_3"][n])
            s2[n] = torch.where(full, acc, state["sum_2"][n])
            s1[n] = torch.where(full, torch.zeros_like(acc), acc)
        new.update(sum_1=s1, sum_2=s2, sum_3=s3)
        return dict(params), new

    def average(self, state=None) -> Dict[str, torch.Tensor]:
        """The window average of each key (of the eager state when
        ``state`` is None)."""
        state = self.state if state is None else state
        total = (state["num_1"] + state["num_2"] + state["num_3"]) \
            .to(torch.float32).clamp_min(1.0)
        return {n: (state["sum_1"][n] + state["sum_2"][n]
                    + state["sum_3"][n]) / total
                for n in state["sum_1"]}

    # -- eager apply/restore (reference modelaverage.py apply:222) --------
    def _live(self):
        if self._parameter_list is None:
            raise ValueError("ModelAverage created without parameters")
        return OrderedDict((k, p.detach())
                           for k, p in self._parameter_list.items())

    @torch.no_grad()
    def step(self, split=None):
        """Accumulate the CURRENT parameter values into the window."""
        params = self._live()
        if self.state is None:
            self.state = self.init_state(params)
        _, self.state = self.apply_gradients(
            params, {k: None for k in params}, self.state)

    @contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        live = self._live()
        if self.state is None:
            self.state = self.init_state(live)
        avg = self.average()
        self._backup = {k: v.clone() for k, v in live.items()}
        with torch.no_grad():
            for k, p in self._parameter_list.items():
                p.copy_(avg[k].to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is not None:
            for k, p in self._parameter_list.items():
                p.copy_(self._backup[k])
            self._backup = None
