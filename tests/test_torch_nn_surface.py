"""The port's ``nn`` surface against the JAX package's: the Paddle
``Layer`` methods (``state_dict``, ``set_state_dict``/``load_dict``, the
forward hooks, ``clear_gradients``, ``full_name``), the initializers and
``ParamAttr``, and the public names of ``nn``, ``nn.functional`` and
``text.models``.

Values carried from the reference are compared exactly or at rtol 1e-5
(float32). Random initializers draw from each package's own generator,
so they are held by their law, not by seed: shapes, dtypes, the mean and
standard deviation of 200,000 draws within 2% of the law's (ten standard
errors and more), bounds exact. ``Bilinear`` and ``Assign`` are
deterministic and equal the reference's exactly.
"""
import ast
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names(path):
    names = set()
    for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return sorted(names)


@pytest.mark.parametrize("path,module", [
    ("paddle_tpu/nn/__init__.py", "paddle_tpu_torch.nn"),
    ("paddle_tpu/nn/functional/__init__.py", "paddle_tpu_torch.nn.functional"),
    ("paddle_tpu/text/models/__init__.py", "paddle_tpu_torch.text.models")])
def test_every_public_name_exists(path, module):
    mod = importlib.import_module(module)
    assert [n for n in _names(path) if not hasattr(mod, n)] == []


def _net(pd):
    class Net(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pd.nn.Linear(4, 3)
            self.bn = pd.nn.BatchNorm1D(3)
            self.out = pd.nn.Linear(3, 2, bias_attr=False)

        def forward(self, x):
            return self.out(self.bn(self.fc(x)))
    return Net()


def _pair():
    ref.seed(0)
    rm, pm = _net(ref), _net(port)
    pm.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rm.state_dict().items()})
    return rm, pm


def test_state_dict_paddle_form_matches_the_reference():
    rm, pm = _pair()
    for kw in ({}, {"structured_name_prefix": "net"},
               {"include_sublayers": False}):
        want = rm.state_dict(**kw)
        got = pm.state_dict(**kw) if kw else pm.state_dict(True)
        assert list(got) == list(want), kw
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            assert not got[k].requires_grad


def test_state_dict_torch_form_is_unchanged():
    _, pm = _pair()
    for kw in ({}, {"keep_vars": True}, {"prefix": "m."}):
        got = pm.state_dict(**kw)
        want = torch.nn.Module.state_dict(pm, **kw)
        assert list(got) == list(want)
        assert all(got[k] is want[k] or torch.equal(got[k], want[k])
                   for k in want)
    kept = pm.state_dict(keep_vars=True)
    assert kept["fc.weight"] is pm.fc.weight


def test_set_state_dict_returns_missing_and_unexpected():
    rm, pm = _pair()
    state = {k: np.asarray(v) * 2 for k, v in rm.state_dict().items()}
    state.pop("fc.bias")
    state["extra"] = np.zeros(3, np.float32)
    want = rm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    got = pm.set_state_dict(state)
    assert [list(g) for g in got] == [list(w) for w in want]
    assert got == (["fc.bias"], ["extra"])
    np.testing.assert_array_equal(pm.fc.weight.detach().numpy(),
                                  state["fc.weight"])
    assert pm.load_dict == pm.set_state_dict
    with pytest.raises(ValueError, match="shape mismatch"):
        pm.set_state_dict({"fc.weight": np.zeros((3, 4), np.float32)})


def test_forward_hooks_order_returns_and_removal():
    rm, pm = _pair()
    rm.eval()
    pm.eval()
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    results = []
    for pd, m, a in ((ref, rm, jnp.asarray(x)), (port, pm,
                                                   torch.from_numpy(x))):
        calls = []
        h1 = m.register_forward_pre_hook(
            lambda layer, inp: (calls.append("pre1"), (inp[0] * 2,))[1])
        h2 = m.register_forward_pre_hook(
            lambda layer, inp: calls.append("pre2"))
        h3 = m.register_forward_post_hook(
            lambda layer, inp, out: (calls.append("post"), out + 1)[1])
        out = np.asarray(m(a).detach() if pd is port else m(a))
        for h in (h1, h2, h3):
            h.remove()
        plain = np.asarray(m(a).detach() if pd is port else m(a))
        results.append((calls, out, plain))
    (rc, ro, rp), (pc, po, pp) = results
    assert pc == rc == ["pre1", "pre2", "post"]
    np.testing.assert_allclose(po, ro, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp, rp, rtol=1e-5, atol=1e-6)


def test_clear_gradients_and_full_name():
    _, pm = _pair()
    pm.eval()
    pm(torch.ones(2, 4)).sum().backward()
    assert all(p.grad is not None for p in pm.parameters())
    pm.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())
    a, b = port.nn.Linear(2, 2), port.nn.Linear(2, 2)
    assert a.full_name().startswith("linear_")
    assert a.full_name() != b.full_name() and a.full_name() == a.full_name()


SHAPE = (400, 500)


def _draw(init):
    port.seed(1)
    return init(SHAPE, torch.float32).double().numpy()


@pytest.mark.parametrize("name,kw,mean,std", [
    ("Normal", dict(mean=0.5, std=2.0), 0.5, 2.0),
    ("TruncatedNormal", dict(mean=0.0, std=2.0), 0.0, 2.0 * 0.8796256),
    ("XavierNormal", {}, 0.0, (2.0 / (400 + 500)) ** 0.5),
    ("XavierUniform", {}, 0.0, (6.0 / 900) ** 0.5 / 3 ** 0.5),
    ("KaimingNormal", {}, 0.0, (2.0 / 400) ** 0.5),
    ("KaimingUniform", {}, 0.0, (6.0 / 400) ** 0.5 / 3 ** 0.5),
    ("Uniform", dict(low=-1.0, high=3.0), 1.0, 4.0 / 12 ** 0.5)])
def test_random_initializers_follow_their_law(name, kw, mean, std):
    got = _draw(getattr(port.nn.initializer, name)(**kw))
    want = np.asarray(getattr(ref.nn.initializer, name)(**kw)(
        SHAPE, jnp.float32), np.float64)
    assert got.shape == want.shape == SHAPE
    for x in (got, want):
        assert abs(x.mean() - mean) <= 0.02 * std
        assert abs(x.std() - std) <= 0.02 * std
    if name == "TruncatedNormal":
        assert np.abs(got).max() <= 2.0 * 2.0 + 1e-6


def test_deterministic_initializers_equal_the_reference():
    shape = (2, 3, 4, 5)
    for cls, args in (("Bilinear", ()),
                      ("Assign", (np.arange(120.0).reshape(shape),)),
                      ("Constant", (0.25,))):
        got = getattr(port.nn.initializer, cls)(*args)(shape, torch.float32)
        want = getattr(ref.nn.initializer, cls)(*args)(shape, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_attr_and_the_global_initializer():
    from paddle_tpu_torch.nn.initializer import (Constant, ParamAttr,
                                                 set_global_initializer)
    lin = port.nn.Linear(3, 2, weight_attr=ParamAttr(
        initializer=Constant(0.5), learning_rate=0.1, trainable=False))
    assert torch.equal(lin.weight, torch.full((3, 2), 0.5))
    assert not lin.weight.requires_grad
    assert lin.weight.optimize_attr == {"learning_rate": 0.1}
    set_global_initializer(Constant(2.0), Constant(-1.0))
    try:
        g = port.nn.Linear(3, 2)
        own = port.nn.Linear(3, 2, weight_attr=Constant(7.0))
        conv = port.nn.Conv2D(1, 1, 3, bias_attr=ParamAttr(
            initializer=Constant(3.0)))
    finally:
        set_global_initializer(None)
    assert torch.equal(g.weight, torch.full((3, 2), 2.0))
    assert torch.equal(g.bias, torch.full((2,), -1.0))
    assert torch.equal(own.weight, torch.full((3, 2), 7.0))
    assert torch.equal(conv.bias, torch.full((1,), 3.0))
    assert not torch.equal(port.nn.Linear(3, 2).weight,
                           torch.full((3, 2), 2.0))
    with pytest.raises(TypeError):
        set_global_initializer("xavier")
