"""paddle_tpu_torch.static.amp — static-graph mixed precision.

Port of ``paddle_tpu/static/amp.py`` (reference:
python/paddle/static/amp/__init__.py re-exporting
fluid/contrib/mixed_precision: decorate:37, fp16_lists.py
AutoMixedPrecisionLists, fp16_utils.py cast_model_to_fp16:322 /
cast_parameters_to_fp16:484, bf16/), on the port's ``amp``.

The reference rewrites the ProgramDesc op-by-op (white/black lists decide
per-op dtype, loss scaling wraps the optimizer). Here a Program is a
traced graph, so the same two levers apply at trace time:
`fp16_guard`/`auto_cast` scopes the policy-list casting during
Program.trace, and `decorate` wraps the optimizer with dynamic loss
scaling (the reference's OptimizerWithMixedPrecision). bfloat16 is the
default half type, as in the reference; the fp16 names are kept and map
to it (the loss-scaling machinery is honored when asked for)."""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.utils._pytree as pytree

from ..amp import amp_state, auto_cast
from ..amp import GradScaler as _GradScaler

__all__ = ["decorate", "CustomOpLists", "AutoMixedPrecisionLists",
           "fp16_guard", "cast_model_to_fp16", "cast_parameters_to_fp16",
           "bf16"]


def _tree_where(keep, new, old):
    return pytree.tree_map(
        lambda n, o: torch.where(keep.to(n.device), o, n)
        if isinstance(n, torch.Tensor) else n, new, old)


class AutoMixedPrecisionLists:
    """White/black op lists (reference fp16_lists.py). The lists feed
    auto_cast's policy; black_varnames is accepted for source compat
    (per-var blacking has no analogue on a traced graph — documented)."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(custom_white_list or ())
        self.black_list = set(custom_black_list or ())
        self.black_varnames = set(custom_black_varnames or ())


CustomOpLists = AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    """reference decorator.py:37 — loss-scaled optimizer wrapper. The
    scaler only engages when dynamic loss scaling is requested (bf16
    training doesn't need it; fp16 source compat does)."""

    def __init__(self, optimizer, amp_lists=None,
                 init_loss_scaling=2.0 ** 15,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8,
                 use_dynamic_loss_scaling=True, use_pure_fp16=False):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._use_pure = use_pure_fp16
        self._scaler = (_GradScaler(
            init_loss_scaling=init_loss_scaling,
            incr_every_n_steps=incr_every_n_steps,
            decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
            incr_ratio=incr_ratio, decr_ratio=decr_ratio)
            if use_dynamic_loss_scaling else None)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_fp16_test=False):
        """reference: cast params for pure-fp16 runs (here: bf16)."""
        return None

    def backward(self, loss, **kw):
        """Scale the loss before gradient computation (reference
        decorator.py backward: loss * loss_scaling). Compute grads from
        the RETURNED value; step()/minimize() unscale them."""
        if self._scaler is not None:
            return self._scaler.scale(loss)
        return loss

    def step(self):
        """Unscale Parameter.grad, skip the update on non-finite grads,
        and advance the dynamic scale (reference decorator.py
        apply_gradients: check_finite_and_unscale + update_loss_scaling)."""
        if self._scaler is None:
            return self._optimizer.step()
        return self._scaler.step(self._optimizer)

    def minimize(self, loss=None, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self.step()

    def init_state(self, params):
        """Inner optimizer state + a "loss_scale" sub-tree so the dynamic
        scale moves inside a staged step (reference decorator.py:446 puts
        update_loss_scaling into the graph; here the state is threaded
        through the step instead of mutated on the host)."""
        state = self._optimizer.init_state(params)
        if self._scaler is not None and isinstance(state, dict):
            state = dict(state)
            state["loss_scale"] = self._scaler.init_scale_state()
        return state

    def scale_loss(self, loss, state=None):
        """Scale a loss by the live scale. With a state pytree from
        init_state this is a tensor op (trace-safe); without, the host
        float."""
        if self._scaler is None:
            return loss
        if isinstance(state, dict) and "loss_scale" in state:
            return self._scaler.scale_loss(loss, state["loss_scale"])
        return self._scaler.scale(loss)

    def apply_gradients(self, params, grads, state, lr=None,
                        lr_scales=None):
        """Functional path (staged steps): unscale + finite-gate here.

        When ``state`` came from this wrapper's init_state it carries a
        "loss_scale" tree: the unscale uses the carried scale and the
        incr/decr counters advance as tensor ops, so persistent overflow
        backs the scale off inside a staged step. States without the key
        fall back to the host float (the scale never moves — callers
        owning their state should use init_state)."""
        if self._scaler is None:
            return self._optimizer.apply_gradients(params, grads, state,
                                                   lr=lr,
                                                   lr_scales=lr_scales)
        carried = isinstance(state, dict) and "loss_scale" in state
        if carried:
            inner_state = {k: v for k, v in state.items()
                           if k != "loss_scale"}
            grads, found_inf, new_ls = self._scaler.unscale_and_update(
                dict(grads), state["loss_scale"])
        else:
            inner_state = state
            grads, found_inf = self._scaler.unscale_(dict(grads))
        new_p, new_s = self._optimizer.apply_gradients(
            params, grads, inner_state, lr=lr, lr_scales=lr_scales)
        # non-finite step: keep old params AND optimizer state (inf grads
        # would otherwise poison the moments) — a select, no host read
        keep = torch.as_tensor(found_inf)
        new_p = _tree_where(keep, new_p, dict(params))
        new_s = _tree_where(keep, new_s, inner_state)
        if carried:
            new_s = dict(new_s)
            new_s["loss_scale"] = new_ls  # advances even on skipped steps
        return new_p, new_s

    def get_loss_scaling(self, state=None):
        if self._scaler is None:
            return 1.0
        if isinstance(state, dict) and "loss_scale" in state:
            return float(state["loss_scale"]["scale"])
        return float(self._scaler._scale)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_pure_fp16=False,
             use_fp16_guard=None, use_bf16=True):
    """reference mixed_precision/decorator.py decorate."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists,
        init_loss_scaling=init_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        use_pure_fp16=use_pure_fp16)


def fp16_guard():
    """reference fp16_utils.py fp16_guard: ops created inside run under
    the half-precision policy. Here: an auto_cast scope at trace time
    (bfloat16)."""
    return auto_cast(True, level="O1")


def cast_model_to_fp16(model, amp_lists=None, use_fp16_guard=True):
    """reference fp16_utils.py:322 — cast a whole model half. For a
    Layer, Layer.bfloat16() is the pure-half path (O2)."""
    if hasattr(model, "bfloat16"):
        return model.bfloat16()
    raise TypeError(
        "cast_model_to_fp16 expects a Layer here (static Programs are "
        "traced graphs — wrap the trace in fp16_guard() instead)")


def cast_parameters_to_fp16(place=None, program=None, scope=None,
                            to_fp16_var_names=None, model=None):
    """reference fp16_utils.py:484 — parameter cast for pure-half runs."""
    if model is not None and hasattr(model, "bfloat16"):
        return model.bfloat16()
    return None


# bf16 sub-namespace (reference static/amp/bf16): bfloat16 IS the amp
# dtype, so these alias the primary machinery.
bf16 = SimpleNamespace(
    auto_cast=auto_cast,
    amp_state=amp_state,
    AutoMixedPrecisionListsBF16=AutoMixedPrecisionLists,
    decorate_bf16=decorate,
)
