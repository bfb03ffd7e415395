"""AMP: ``auto_cast``, ``decorate`` and ``GradScaler``.

Port of ``paddle_tpu/amp/__init__.py``. The default low-precision dtype is
bfloat16; the dynamic loss scale is kept for float16 and for parity.

- O1 (``auto_cast``): white-listed ops compute in the amp dtype. The cast
  is made by the op itself through :func:`cast_if_amp`; ``nn.functional.
  linear`` makes it, as the reference's does. Black-listed ops stay as
  they are.
- O2 (``decorate``): the floating parameters of every layer but
  ``LayerNorm`` are cast to the amp dtype in place.
- ``GradScaler`` keeps the reference's imperative API (``scale``;
  ``unscale_`` on a grads dict, or on an optimizer, whose parameters'
  ``.grad`` it unscales in place with one host read of the fused
  all-finite flag, once a step: the ``_already_unscaled`` latch, reset by
  ``update``; ``step(optimizer)`` and ``minimize(optimizer, loss)``, which
  skip the optimizer's step on a non-finite gradient; ``update``;
  ``state_dict``) and its functional state, which ``ParallelTrainer(scaler=)`` carries on the
  device: ``init_scale_state``, ``scale_loss``, ``update_scale_state``
  (the incr/decr policy as ``torch.where``, off the trainer's finite flag)
  and ``unscale_and_update``.

The state is thread-local, as the reference's.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "amp_dtype",
           "should_cast", "cast_if_amp", "auto_cast", "amp_guard",
           "decorate", "GradScaler", "AmpScaler"]

# the reference's lists (imperative/amp_auto_cast.cc): the matmul family
# in low precision; numerically sensitive ops stay as they are
WHITE_LIST = {"matmul", "conv1d", "conv2d", "conv3d", "linear", "einsum",
              "attention", "bmm", "mm"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "exp", "log", "mean", "sum", "cumsum"}


def _dtype_of(name) -> torch.dtype:
    return torch.float16 if name in ("float16", "fp16") else torch.bfloat16


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = set(WHITE_LIST)
        self.black = set(BLACK_LIST)


_state = _AmpState()


def amp_state():
    return _state


def amp_dtype() -> torch.dtype:
    return _state.dtype


def should_cast(op_name: str) -> bool:
    return (_state.enabled and op_name in _state.white
            and op_name not in _state.black)


def cast_if_amp(op_name, *xs):
    """``xs`` with every floating tensor cast to the amp dtype when
    ``op_name`` is white-listed under an active ``auto_cast``."""
    if not should_cast(op_name):
        return xs
    dt = _state.dtype
    return tuple(x.to(dt) if isinstance(x, torch.Tensor)
                 and x.is_floating_point() and x.dtype != dt else x
                 for x in xs)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)
    _state.enabled = enable
    _state.dtype = _dtype_of(dtype)
    _state.level = level
    if custom_white_list:
        _state.white = set(WHITE_LIST) | set(custom_white_list)
    if custom_black_list:
        _state.black = set(BLACK_LIST) | set(custom_black_list)
        _state.white = _state.white - _state.black
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.white, _state.black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the floating parameters of every layer but the norms to the
    amp dtype, in place."""
    from ..nn.layers.norm import LayerNorm
    dt = _dtype_of(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, LayerNorm):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (reference: amp/grad_scaler.py)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @staticmethod
    def _unscale_dict(grads, inv):
        """Every grad times ``inv`` (in the grad's dtype) and whether any
        result is non-finite (a 0-d bool tensor)."""
        from ..resilience.guard import all_finite
        inv = torch.as_tensor(inv, dtype=torch.float32)
        unscaled = {k: None if g is None else g * inv.to(g.device, g.dtype)
                    for k, g in grads.items()}
        return unscaled, ~all_finite(unscaled.values())

    def unscale_(self, grads_or_optimizer):
        """A grads dict: (unscaled grads, found_inf as a 0-d bool tensor).
        An optimizer: every parameter's ``.grad`` unscaled in place, and
        whether any is non-finite (a bool, one host read); a second call
        before ``update`` unscales nothing and returns the same answer."""
        if isinstance(grads_or_optimizer, dict):
            return self._unscale_dict(grads_or_optimizer, 1.0 / self._scale)
        if self._already_unscaled:
            return self._found_inf
        from ..resilience.guard import all_finite
        grads = [p.grad for p in
                 (grads_or_optimizer._parameter_list or {}).values()
                 if p.grad is not None]
        inv = 1.0 / self._scale
        for g in grads:
            g.mul_(inv)
        self._found_inf = not bool(all_finite(grads))
        self._already_unscaled = True
        return self._found_inf

    def update(self, found_inf=None):
        # the latch resets on every update, a fixed scale's too (the
        # reference resets it only under dynamic scaling, which leaves a
        # fixed scale's later gradients scaled)
        self._already_unscaled = False
        if not (self._enable and self._dynamic):
            return
        found = self._found_inf if found_inf is None else bool(found_inf)
        if found:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def step(self, optimizer):
        """Unscale the optimizer's gradients, step it unless one is
        non-finite, then update the scale."""
        if not self.unscale_(optimizer):
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        """``step(optimizer)``; the backward of ``scaled_loss`` is the
        caller's."""
        self.step(optimizer)

    # -- functional state (carried by the trainer on its device) ----------

    def init_scale_state(self, device=None):
        """{"scale": float32, "good": int32, "bad": int32} 0-d tensors."""
        return {"scale": torch.tensor(self._scale, dtype=torch.float32,
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device)}

    def scale_loss(self, loss, scale_state):
        return loss * scale_state["scale"].to(loss.dtype)

    def update_scale_state(self, scale_state, found_inf):
        """The incr/decr policy over the state, ``found_inf`` a 0-d bool
        tensor; no host sync."""
        if not (self._enable and self._dynamic):
            return scale_state
        scale = scale_state["scale"]
        zero = torch.zeros_like(scale_state["bad"])
        bad = torch.where(found_inf, scale_state["bad"] + 1, zero)
        good = torch.where(found_inf, zero, scale_state["good"] + 1)
        decr = bad >= self._decr_every
        incr = good >= self._incr_every
        new_scale = torch.where(
            decr, torch.clamp_min(scale * self._decr_ratio, 1.0),
            torch.where(incr, scale * self._incr_ratio, scale))
        return {"scale": new_scale,
                "good": torch.where(incr, zero, good),
                "bad": torch.where(decr, zero, bad)}

    def unscale_and_update(self, grads, scale_state):
        """(grads, state) -> (unscaled, found_inf, new_state)."""
        unscaled, found = self._unscale_dict(
            grads, 1.0 / scale_state["scale"])
        return unscaled, found, self.update_scale_state(scale_state, found)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_every": self._incr_every,
                "decr_every": self._decr_every, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
