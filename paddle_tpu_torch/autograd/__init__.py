"""Autograd surface.

Port of ``paddle_tpu/autograd/__init__.py``. The reference replaces the
taping engine with ``jax.grad`` over a pure function; PyTorch has the
tape, so this module is a thin layer over ``torch.autograd``:

- ``backward(layer, loss_closure)`` — the imperative bridge: computes
  d loss / d params of ``loss = loss_closure()`` for the layer's trainable
  parameters and accumulates them into ``p.grad`` (the reference's
  gradient accumulator), so ``optimizer.step()`` works like the
  reference's dygraph loop.
- ``grad`` — ``paddle.grad``: ``grad(outputs, inputs)`` on tensors (the
  tape), on a callable of the inputs (the reference's functional form),
  or ``grad(func=f, argnums=0)`` (``torch.func.grad``).
- ``no_grad`` / ``set_grad_enabled`` — torch's.
- ``PyLayer`` — custom forward/backward pairs (reference:
  python/paddle/autograd/py_layer.py:192) on ``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

__all__ = ["backward", "grad", "no_grad", "set_grad_enabled", "PyLayer",
           "PyLayerContext"]


def backward(layer, forward_closure, retain_graph=False):
    """Accumulate d loss / d params of ``loss = forward_closure()`` into
    ``p.grad`` of every trainable parameter of ``layer``; returns the
    loss."""
    trainable = [p for p in layer.parameters() if p.requires_grad]
    loss = forward_closure()
    grads = torch.autograd.grad(loss, trainable, retain_graph=retain_graph,
                                allow_unused=True)
    for p, g in zip(trainable, grads):
        if g is None:
            continue
        p.grad = g if p.grad is None else p.grad + g
    return loss


def _scalarize(out):
    if isinstance(out, (list, tuple)):
        return sum(o.sum() for o in out)
    return out.sum() if out.ndim > 0 else out


def grad(outputs=None, inputs=None, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, func=None, argnums=0):
    """Gradients, in three forms:

    - ``grad(outputs, inputs)`` with tensors: ``torch.autograd.grad``
      (Paddle's own form), a list of gradients;
    - ``grad(outputs=f, inputs=xs)`` with ``f`` a callable of ``xs`` (the
      reference's form): the gradient of ``sum(f(*xs))`` for each input;
    - ``grad(func=f, argnums=0)``: ``torch.func.grad(f, argnums)``.
    """
    if func is not None:
        return torch.func.grad(func, argnums=argnums)
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if callable(outputs):
        xs = [x.detach().requires_grad_(True) for x in xs]
        with torch.enable_grad():
            out = _scalarize(outputs(*xs))
        return list(torch.autograd.grad(out, xs, create_graph=create_graph,
                                        allow_unused=allow_unused))
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    gouts = None
    if grad_outputs is not None:
        gouts = list(grad_outputs) if isinstance(
            grad_outputs, (list, tuple)) else [grad_outputs]
    return list(torch.autograd.grad(outs, xs, grad_outputs=gouts,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=allow_unused))


no_grad = torch.no_grad


def set_grad_enabled(mode: bool):
    """Context manager (and function) switching gradient recording."""
    return torch.set_grad_enabled(mode)


class PyLayerContext:
    """What ``forward`` hands to ``backward`` (reference py_layer.py)."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved


class PyLayer:
    """Custom op with user forward/backward (reference:
    python/paddle/autograd/py_layer.py:192), on ``torch.autograd.Function``.

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3
        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return 3 * x ** 2 * dy

    y = Cube.apply(x)
    """

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            user = cls

            class _Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, kwargs, *args):
                    pctx = PyLayerContext()
                    out = user.forward(pctx, *args, **kwargs)
                    ctx.save_for_backward(*pctx._saved)
                    ctx.pyctx = pctx
                    return out

                @staticmethod
                def backward(ctx, *grads):
                    pctx = ctx.pyctx
                    pctx._saved = ctx.saved_tensors
                    gs = user.backward(pctx, *grads)
                    gs = gs if isinstance(gs, tuple) else (gs,)
                    return (None,) + gs

            _Fn.__name__ = _Fn.__qualname__ = f"PyLayer[{cls.__name__}]"
            fn = _Fn
            cls._torch_function = fn
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        return cls._function().apply(kwargs, *args)

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError
