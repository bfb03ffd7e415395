"""The port's ``autograd`` (``backward``, ``grad``, ``no_grad``,
``set_grad_enabled``, ``PyLayer``/``PyLayerContext``) against the JAX
package's, on the same numpy inputs and carried weights; float32 within
1e-6 (rtol and atol)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu import autograd as ref_ag
from paddle_tpu_torch import autograd as port_ag

TOL = dict(rtol=1e-6, atol=1e-6)
RS = np.random.RandomState(0)
X = RS.randn(3, 4).astype("float32")
Y = RS.randn(4).astype("float32")


def test_public_names_match():
    names = {n for n in dir(ref_ag) if not n.startswith("_")
             and callable(getattr(ref_ag, n))
             and getattr(getattr(ref_ag, n), "__module__", "").startswith(
                 "paddle_tpu.autograd")}
    assert names == {"backward", "grad", "no_grad", "set_grad_enabled",
                     "PyLayer", "PyLayerContext"}
    for n in names:
        assert hasattr(port_ag, n), n
    assert port.grad is port_ag.grad and port.no_grad is port_ag.no_grad
    assert port.set_grad_enabled is port_ag.set_grad_enabled


def _mlp(pd):
    return pd.nn.Sequential(pd.nn.Linear(4, 8), pd.nn.Tanh(),
                            pd.nn.Linear(8, 2))


def test_backward_accumulates_like_reference():
    ref.seed(0)
    rm = _mlp(ref)
    pm = _mlp(port)
    pm.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rm.state_dict().items()})
    xr, xp = jnp.asarray(X), torch.from_numpy(X)
    for _ in range(2):   # twice: the grads accumulate
        ref_ag.backward(rm, lambda: jnp.sum(rm(xr) ** 2))
        loss = port_ag.backward(pm, lambda: torch.sum(pm(xp) ** 2))
    assert float(loss) == pytest.approx(float(jnp.sum(rm(xr) ** 2)),
                                        rel=1e-6)
    rgrads = {n: np.asarray(p.grad) for n, p in rm.named_parameters()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), rgrads[n], **TOL)


def test_grad_forms_match_reference():
    f_ref = lambda a, b: jnp.sum(jnp.tanh(a @ b) ** 2)  # noqa: E731
    f_port = lambda a, b: torch.sum(torch.tanh(a @ b) ** 2)  # noqa: E731
    want = ref.grad(outputs=f_ref, inputs=[jnp.asarray(X), jnp.asarray(Y)])
    got = port.grad(outputs=f_port, inputs=[torch.from_numpy(X),
                                            torch.from_numpy(Y)])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the functional form: torch.func.grad / jax.grad
    gw = ref.grad(func=f_ref, argnums=1)(jnp.asarray(X), jnp.asarray(Y))
    gp = port.grad(func=f_port, argnums=1)(torch.from_numpy(X),
                                           torch.from_numpy(Y))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gw), **TOL)
    # Paddle's own form, on the tape: outputs and inputs are tensors
    xt = torch.from_numpy(X).requires_grad_(True)
    yt = torch.from_numpy(Y).requires_grad_(True)
    (gx, gy) = port.grad(f_port(xt, yt), [xt, yt])
    np.testing.assert_allclose(gx.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(want[1]), **TOL)
    # a list output is summed, as the reference's scalarization does
    wl = ref.grad(outputs=lambda a: [a * 2, a ** 2],
                  inputs=[jnp.asarray(Y)])
    gl = port.grad(outputs=lambda a: [a * 2, a ** 2],
                   inputs=[torch.from_numpy(Y)])
    np.testing.assert_allclose(gl[0].numpy(), np.asarray(wl[0]), **TOL)


def test_no_grad_and_set_grad_enabled():
    x = torch.ones(2, requires_grad=True)
    with port.no_grad():
        assert not (x * 2).requires_grad
    with port.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    with port.set_grad_enabled(True):
        assert (x * 2).requires_grad

    @port.no_grad()
    def f(a):
        return a * 3

    assert not f(x).requires_grad
    # the reference's are no-op contexts: values agree either way
    with ref.no_grad(), ref_ag.set_grad_enabled(False):
        r = jnp.asarray(Y) * 3
    np.testing.assert_allclose((torch.from_numpy(Y) * 3).numpy(),
                               np.asarray(r))


def _cube(base, ctx_cls_check):
    class Cube(base):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            ctx_cls_check(ctx)
            ctx.save_for_backward(x)
            return x ** 3 * scale

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return 3 * x ** 2 * dy * 10.0   # a custom (scaled) backward

    return Cube


def test_pylayer_matches_reference():
    def check_ref(ctx):
        assert isinstance(ctx, ref_ag.PyLayerContext)

    def check_port(ctx):
        assert isinstance(ctx, port_ag.PyLayerContext)

    RCube = _cube(ref_ag.PyLayer, check_ref)
    PCube = _cube(port_ag.PyLayer, check_port)
    val_r = jnp.sum(RCube.apply(jnp.asarray(Y), scale=2.0))
    yt = torch.from_numpy(Y).requires_grad_(True)
    val_p = torch.sum(PCube.apply(yt, scale=2.0))
    (g_p,) = torch.autograd.grad(val_p, [yt])
    np.testing.assert_allclose(val_p.item(), float(val_r), rtol=1e-6)
    # the custom backward (times 10) is the one used. The reference's
    # gradient cannot be taken: its custom_vjp keeps the PyLayerContext
    # as a residual, which is not a JAX type (jax.grad raises TypeError)
    np.testing.assert_allclose(g_p.numpy(), 30 * Y ** 2, rtol=1e-5)
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jax.grad(lambda a: jnp.sum(RCube.apply(a)))(jnp.asarray(Y))
    with pytest.raises(NotImplementedError):
        port_ag.PyLayer.forward(None)
