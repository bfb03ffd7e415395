"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``.

Port of ``paddle_tpu/optimizer/optimizer.py``'s functional core. An
optimizer is two functions over ``{name: tensor}`` dicts that the trainer
calls: ``init_state(params)`` and ``apply_gradients(params, grads, state,
lr) -> (new_params, new_state)``. The math is the reference's:

- grads and params are upcast to float32; the update runs in float32 and
  the result is cast back to each parameter's dtype (a bfloat16 model
  keeps bfloat16 weights and no master copy);
- Adam's moments are stored in ``slot_dtype`` (float32 by default) and
  updated in float32; ``slot_dtype`` is a torch dtype or the name of one
  (``"bfloat16"``, ``"float32"``, ``"float16"``, or a numpy or jnp dtype of
  that name), mapped at construction (:func:`slot_dtype_of`);
- AdamW's decoupled decay is ``p - lr * wd * p32`` on the PRE-step float32
  parameter, on every parameter or, given ``apply_decay_param_fun``, on
  those whose name it accepts (GPT and BERT recipes keep biases and
  LayerNorm out);
- ``Momentum`` keeps a float32 ``velocity`` slot (``v = mu * v + g``, with
  the Nesterov variant); ``SGD`` keeps none;
- the step count is a 0-d int32 tensor on the parameters' device, so bias
  correction reads no host value.

``state_dict()``/``set_state_dict()`` carry the optimizer state (``step``
and ``slots``, which ``ParallelTrainer`` keeps on its optimizer as
``optimizer.state``) and an ``LRScheduler``'s state, as the reference's.

``torch.optim.AdamW`` is not used: on bfloat16 parameters its math runs in
bfloat16. The learning rate is a float or an ``LRScheduler``
(``optimizer/lr.py``), whose value ``get_lr`` reads; ``set_lr`` raises under
a scheduler. ``weight_decay`` is a float or an ``L1Decay``/``L2Decay``
(``regularizer.py``), read as the reference reads them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .clip import clip_grads
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "slot_dtype_of"]

# the slot dtypes a name may give (the reference reads it with jnp.dtype)
_SLOT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def slot_dtype_of(value) -> torch.dtype:
    """``slot_dtype`` as a torch dtype: None is float32; a torch dtype is
    itself; a name (a string, or a numpy dtype or scalar type by its name)
    maps through :data:`_SLOT_DTYPES`. Anything else raises ValueError."""
    if value is None:
        return torch.float32
    if isinstance(value, torch.dtype):
        return value
    name = value if isinstance(value, str) else \
        getattr(value, "name", None) or getattr(value, "__name__", None)
    if name not in _SLOT_DTYPES:
        raise ValueError(f"slot_dtype {value!r}: expected a torch dtype or "
                         f"one of {sorted(_SLOT_DTYPES)}")
    return _SLOT_DTYPES[name]


class Optimizer:
    _decoupled_wd = False   # True for AdamW-style decoupled decay

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        # parameters: accepted as the reference takes it; the trainer hands
        # apply_gradients the parameters by name (no eager step() here)
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        # {"step", "slots"} of the trainer this optimizer drives
        self.state = None

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def _wd_coeff(self):
        wd = self.regularization
        if wd is None:
            return 0.0, False
        if isinstance(wd, (int, float)):
            return float(wd), self._decoupled_wd
        coeff = getattr(wd, "coeff", None)
        if coeff is None:
            coeff = getattr(wd, "_regularization_coeff", 0.0)
        return float(coeff), self._decoupled_wd

    def init_slots(self, value: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _decays(self, name) -> bool:
        """Whether decoupled decay applies to parameter ``name``."""
        return True

    def update(self, p, g, slots, lr, step):
        """Per-parameter float32 update -> (new_p, new_slots)."""
        raise NotImplementedError

    def init_state(self, params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device if params else "cpu"
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": {k: self.init_slots(v) for k, v in params.items()}}

    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]], state,
                        lr: Optional[float] = None):
        """(params, grads, state) -> (new_params, new_state); reads and
        writes no tensor in place."""
        lr = self.get_lr() if lr is None else float(lr)
        grads = clip_grads(grads, self._grad_clip)
        wd, decoupled = self._wd_coeff()
        step = state["step"] + 1
        new_params, new_slots = {}, {}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = p
                new_slots[k] = state["slots"][k]
                continue
            g = g.float()
            p32 = p.float()
            if wd and not decoupled:
                reg = self.regularization
                if callable(reg) and getattr(reg, "kind", "l2") != "l2":
                    g = g + reg(p32, g)      # L1Decay: coeff * sign(p)
                else:
                    g = g + wd * p32
            np_, ns = self.update(p32, g, state["slots"][k], lr, step)
            if wd and decoupled and self._decays(k):
                np_ = np_ - lr * wd * p32
            new_params[k] = np_.to(p.dtype)
            new_slots[k] = ns
        return new_params, {"step": step, "slots": new_slots}

    def state_dict(self) -> dict:
        """``{"state": {"step", "slots"}}`` (new dicts over the same
        tensors) when the optimizer holds a state, and ``{"LR_Scheduler":
        ...}`` under a scheduler."""
        out = {}
        if self.state is not None:
            out["state"] = _tree_copy(self.state)
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state_dict: dict):
        if "state" in state_dict:
            self.state = _tree_copy(state_dict["state"])
        if "LR_Scheduler" in state_dict and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree


class SGD(Optimizer):
    def update(self, p, g, slots, lr, step):
        return p - lr * g, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def init_slots(self, value):
        return {"velocity": torch.zeros(value.shape, dtype=torch.float32,
                                        device=value.device)}

    def update(self, p, g, slots, lr, step):
        v = self._momentum * slots["velocity"] + g
        if self._use_nesterov:
            p = p - lr * (g + self._momentum * v)
        else:
            p = p - lr * v
        return p, {"velocity": v}


class Adam(Optimizer):
    """slot_dtype: storage dtype of the m/v moments (math is float32)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 slot_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._slot_dtype = slot_dtype_of(slot_dtype)

    def init_slots(self, value):
        return {"m": torch.zeros(value.shape, dtype=self._slot_dtype,
                                 device=value.device),
                "v": torch.zeros(value.shape, dtype=self._slot_dtype,
                                 device=value.device)}

    def update(self, p, g, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["m"].float() + (1 - b1) * g
        v = b2 * slots["v"].float() + (1 - b2) * g.square()
        t = step.float()
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        p = p - lr * mhat / (vhat.sqrt() + self._epsilon)
        return p, {"m": m.to(self._slot_dtype), "v": v.to(self._slot_dtype)}


class AdamW(Adam):
    """Decoupled weight decay: on every parameter, or on those whose name
    ``apply_decay_param_fun(name)`` accepts."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, slot_dtype=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         slot_dtype, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name) -> bool:
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(name))
