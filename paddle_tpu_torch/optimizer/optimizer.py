"""Optimizers: ``Optimizer`` and its eleven: ``SGD``, ``Momentum``,
``DGCMomentum``, ``Adagrad``, ``Adadelta``, ``Adam``, ``AdamW``, ``Adamax``,
``RMSProp``, ``Lamb`` and ``Lars`` (alias ``LarsMomentum``).

Port of ``paddle_tpu/optimizer/optimizer.py``. An optimizer is two
functions over ``{key: tensor}`` dicts that the trainer calls:
``init_state(params)`` and ``apply_gradients(params, grads, state, lr,
lr_scales) -> (new_params, new_state)``; ``lr_scales`` multiplies the
learning rate of the keys it names. The eager API is a thin wrapper over
the same path, as in the reference:

- ``parameters`` is a list of ``nn.Parameter``, or of ``(name, param)``
  pairs as ``named_parameters()`` gives them. A parameter's key is its
  name where one is given, else its position in the list; ``Lamb``'s
  ``exclude_from_weight_decay_fn`` and ``Lars``'s
  ``exclude_from_weight_decay`` match on the key.
- ``step()`` reads each ``p.grad`` and writes each parameter in place
  under ``no_grad``. A frozen parameter (``requires_grad`` False) or one
  without a gradient keeps its value and its slots. The per-parameter
  learning-rate scale is ``p.optimize_attr["learning_rate"]`` where the
  attribute is set. The state is made on the parameters' device at the
  first step; a parameter on another device raises.
- ``minimize(loss)`` is ``step()``; ``clear_grad()`` (``clear_gradients``)
  sets every ``p.grad`` to None.

The math is the reference's:

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
  the Nesterov variant); ``SGD`` keeps none; the other seven keep float32
  slots;
- ``DGCMomentum`` sends the top of the accumulated residual by magnitude:
  the threshold is the value at the sparsity's quantile, which
  ``torch.kthvalue`` gives without a sort (one host read of ``k`` a
  tensor); its rampup schedule is read with integer floor division on the
  step, on the device;
- ``Lamb`` and ``Lars`` scale each tensor's step by a trust ratio of
  norms (the per-key hook ``_update_with_key``);
- a key that ``apply_gradients(split=)`` names is this rank's slice of a
  parameter split over a process group (a ZeRO ``sharding`` slice, a
  tensor-parallel ``model`` slice, a pipeline stage's members): the
  hook gets that group, and ``Lamb``'s and ``Lars``'s norms sum their
  squares over it and ``DGCMomentum`` takes its threshold over the
  residual gathered from it, so each takes what the reference takes of
  the whole parameter;
- the step count is a 0-d int32 tensor on the parameters' device, so bias
  correction reads no host value.

``state_dict()``/``set_state_dict()`` carry the optimizer state (``step``
and ``slots``: ``ParallelTrainer`` keeps its own on the optimizer as
``optimizer.state``, and ``step()`` keeps the eager state there too) and an
``LRScheduler``'s state, as the reference's.

``torch.optim.AdamW`` is not used: on bfloat16 parameters its math runs in
bfloat16. The learning rate is a float or an ``LRScheduler``
(``optimizer/lr.py``), whose value ``get_lr`` reads; ``set_lr`` raises under
a scheduler. ``weight_decay`` is a float or an ``L1Decay``/``L2Decay``
(``regularizer.py``), read as the reference reads them.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from .clip import clip_grads
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "DGCMomentum", "Adagrad",
           "Adadelta", "Adam", "AdamW", "Adamax", "RMSProp", "Lamb", "Lars",
           "LarsMomentum", "slot_dtype_of"]

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


def _keyed(parameters) -> "OrderedDict[object, torch.nn.Parameter]":
    """``{key: parameter}``: the name of a ``(name, param)`` pair, else the
    position in the list."""
    out = OrderedDict()
    for i, item in enumerate(parameters):
        key, p = item if isinstance(item, tuple) else (i, item)
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"parameters[{i}]: expected a tensor or a "
                            f"(name, tensor) pair, got {type(item)}")
        if key in out:
            raise ValueError(f"parameter key {key!r} given twice")
        out[key] = p
    return out


class Optimizer:
    _decoupled_wd = False   # True for AdamW-style decoupled decay

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._parameter_list = (_keyed(parameters) if parameters is not None
                                else None)
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        # {"step", "slots"}: the trainer's, or the eager step()'s
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

    def _update_with_key(self, key, p, g, slots, lr, step, group=None):
        """Per-key hook (Lamb and Lars exclude keys from their decay);
        ``group``: the process group ``p`` is a slice over, or None."""
        return self.update(p, g, slots, lr, step)

    def init_state(self, params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device if params else "cpu"
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": {k: self.init_slots(v) for k, v in params.items()}}

    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]], state,
                        lr: Optional[float] = None,
                        lr_scales: Optional[Dict[str, float]] = None,
                        split=None):
        """(params, grads, state) -> (new_params, new_state); reads and
        writes no tensor in place. ``lr_scales[key]`` multiplies that key's
        learning rate. ``split``: ``{key: group}`` or None, the keys
        whose parameters and gradients are slices of whole ones split over
        ``group``; the clip's norms and the norm and top-k optimizers' take
        the whole parameter over it."""
        lr = self.get_lr() if lr is None else float(lr)
        grads = clip_grads(grads, self._grad_clip, split)
        groups = split or {}
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
            p_lr = lr * (lr_scales.get(k, 1.0) if lr_scales else 1.0)
            np_, ns = self._update_with_key(k, p32, g, state["slots"][k],
                                            p_lr, step, groups.get(k))
            if wd and decoupled and self._decays(k):
                np_ = np_ - p_lr * wd * p32
            new_params[k] = np_.to(p.dtype)
            new_slots[k] = ns
        return new_params, {"step": step, "slots": new_slots}

    # -- the eager API ---------------------------------------------------------

    @torch.no_grad()
    def step(self, split=None):
        """One update of every parameter from its ``.grad``, in place
        (``split`` as in :meth:`apply_gradients`)."""
        plist = self._parameter_list
        if plist is None:
            raise ValueError("optimizer created without parameters")
        params = OrderedDict((k, p.detach()) for k, p in plist.items())
        if self.state is None:
            self.state = self.init_state(params)
        dev = self.state["step"].device
        for k, p in plist.items():
            if p.device != dev:
                raise RuntimeError(
                    f"parameter {k!r} is on {p.device}, the optimizer state "
                    f"on {dev}")
        grads = OrderedDict((k, p.grad if p.requires_grad else None)
                            for k, p in plist.items())
        lr_scales = {k: float(getattr(p, "optimize_attr", {}).get(
            "learning_rate", 1.0)) for k, p in plist.items()}
        new_params, self.state = self.apply_gradients(
            params, grads, self.state, lr_scales=lr_scales, split=split)
        for k, p in plist.items():
            if grads[k] is not None:
                p.copy_(new_params[k])

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``step()`` (the backward is the caller's, as in the reference's
        dygraph mode)."""
        self.step()
        return None, None

    def clear_grad(self):
        for p in (self._parameter_list or {}).values():
            p.grad = None

    clear_gradients = clear_grad

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


def _zeros(value):
    return torch.zeros(value.shape, dtype=torch.float32, device=value.device)


class DGCMomentum(Optimizer):
    """Deep Gradient Compression momentum: momentum correction and top-k
    sparsification with local accumulation; unsent mass stays in the
    residual ``v`` until its coordinates enter the top k. The sparsity
    follows the rampup schedule from ``rampup_begin_step``. As in the
    reference, the selection applies to the already-averaged gradient.
    A split parameter's threshold is taken over the whole residual,
    gathered from its group."""

    def __init__(self, learning_rate, momentum=0.9, parameters=None,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = tuple(sparsity)

    def init_slots(self, value):
        return {"u": _zeros(value), "v": _zeros(value)}

    def _sparsity_at(self, step):
        """The schedule's entry at ``step`` (a 0-d int32 tensor), 0 up to
        ``rampup_begin_step``; integer floor division as the reference."""
        n = len(self._sparsity)
        idx = torch.clamp((step - self._rampup_begin) * n
                          // self._rampup_step, 0, n - 1)
        sched = torch.tensor(self._sparsity, dtype=torch.float32).to(
            step.device)
        return torch.where(step <= self._rampup_begin,
                           torch.zeros_like(sched[0]), sched[idx.long()])

    def update(self, p, g, slots, lr, step):
        return self._update_with_key(None, p, g, slots, lr, step)

    def _update_with_key(self, key, p, g, slots, lr, step, group=None):
        u = self._momentum * slots["u"] + g        # momentum correction
        v = slots["v"] + u                          # local accumulation
        sp = self._sparsity_at(step)
        mag = _whole(v.abs().reshape(-1), group)
        n = mag.numel()
        if n > 1:
            # the threshold is sort(|v|)[k], the (k + 1)-th smallest
            k = torch.clamp((sp * n).to(torch.int32), 0, n - 1)
            thr = torch.kthvalue(mag, int(k) + 1).values
            mask = (v.abs() >= thr) | (sp <= 0.0)
        else:
            mask = torch.ones_like(v, dtype=torch.bool)
        sent = torch.where(mask, v, 0.0)
        v_rem = torch.where(mask, 0.0, v)
        upd = sent
        if self._use_nesterov:
            upd = sent + self._momentum * torch.where(mask, u, 0.0)
        return p - lr * upd, {"u": u, "v": v_rem}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, value):
        return {"moment": torch.full(value.shape, self._init_acc,
                                     dtype=torch.float32,
                                     device=value.device)}

    def update(self, p, g, slots, lr, step):
        m = slots["moment"] + g.square()
        return p - lr * g / (m.sqrt() + self._epsilon), {"moment": m}


class Adadelta(Optimizer):
    """The running averages of squared gradients and squared updates."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def init_slots(self, value):
        return {"avg_squared_grad": _zeros(value),
                "avg_squared_update": _zeros(value)}

    def update(self, p, g, slots, lr, step):
        rho, eps = self._rho, self._epsilon
        asg = rho * slots["avg_squared_grad"] + (1 - rho) * g.square()
        upd = g * (slots["avg_squared_update"] + eps).sqrt() / \
            (asg + eps).sqrt()
        asu = rho * slots["avg_squared_update"] + (1 - rho) * upd.square()
        return p - lr * upd, {"avg_squared_grad": asg,
                              "avg_squared_update": asu}


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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_slots(self, value):
        return {"m": _zeros(value), "u": _zeros(value)}

    def update(self, p, g, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["m"] + (1 - b1) * g
        u = torch.maximum(b2 * slots["u"], g.abs())
        t = step.float()
        p = p - (lr / (1 - torch.pow(b1, t))) * m / (u + self._epsilon)
        return p, {"m": m, "u": u}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_slots(self, value):
        s = {"mean_square": _zeros(value), "momentum": _zeros(value)}
        if self._centered:
            s["mean_grad"] = _zeros(value)
        return s

    def update(self, p, g, slots, lr, step):
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g.square()
        out = {"mean_square": ms}
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g
            denom = (ms - mg.square() + self._epsilon).sqrt()
            out["mean_grad"] = mg
        else:
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * slots["momentum"] + lr * g / denom
        out["momentum"] = mom
        return p - mom, out


def _norm(x, group=None):
    """The L2 norm of ``x``, or of the whole tensor ``x`` is a slice of
    over ``group``."""
    sq = x.square().sum()
    if group is not None:
        import torch.distributed as dist
        sq = sq.reshape(1).clone()
        dist.all_reduce(sq, group=group)
        sq = sq[0]
    return sq.sqrt()


def _whole(flat, group=None):
    """The 1-d ``flat`` gathered from every rank of ``group`` (equal
    sizes), or itself."""
    if group is None:
        return flat
    import torch.distributed as dist
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat.contiguous(), group=group)
    return torch.cat(parts)


class Lamb(Optimizer):
    """Layer-wise adaptive moments: Adam's step plus decay, scaled by the
    trust ratio ||p|| / ||r||; keys ``exclude_from_weight_decay_fn``
    accepts take no decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_slots(self, value):
        return {"m": _zeros(value), "v": _zeros(value)}

    def _update_with_key(self, key, p, g, slots, lr, step, group=None):
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(key):
            wd = 0.0
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["m"] + (1 - b1) * g
        v = b2 * slots["v"] + (1 - b2) * g.square()
        t = step.float()
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        r = mhat / (vhat.sqrt() + self._epsilon) + wd * p
        p_norm, r_norm = _norm(p, group), _norm(r, group)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            1.0)
        return p - lr * trust * r, {"m": m, "v": v}


class Lars(Momentum):
    """LARS momentum: a local learning rate from the ratio of the weight's
    and the gradient's norms; keys holding one of
    ``exclude_from_weight_decay``'s strings take no decay."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._exclude_list = list(exclude_from_weight_decay or [])
        self._eps = epsilon

    def _update_with_key(self, key, p, g, slots, lr, step, group=None):
        wd = self._lars_wd
        if any(sub in str(key) for sub in self._exclude_list):
            wd = 0.0
        p_norm, g_norm = _norm(p, group), _norm(g, group)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * p_norm /
            (g_norm + wd * p_norm + self._eps), lr)
        v = self._momentum * slots["velocity"] + local_lr * (g + wd * p)
        return p - v, {"velocity": v}


LarsMomentum = Lars
