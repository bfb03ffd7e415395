"""The port's optimizers against the JAX package's on the CPU: Adam and
AdamW with the moments stored in a dtype named by a string, as bench.py's
GPT-1.3B configuration asks for (``AdamW(..., slot_dtype="bfloat16")``);
AdamW's ``apply_decay_param_fun``; ``SGD`` and ``Momentum`` (the
reference's data-parallel harness trains with the latter); each of the
eleven classes through ``apply_gradients`` with ``lr_scales`` and through
the eager ``step()`` (named parameters, a scaled learning rate, a frozen
parameter), ``DGCMomentum`` across its rampup and ``RMSProp(centered=
True)`` among them; the eager API around them (``minimize``,
``clear_grad``, the state dict, a parameter on another device); and the
committed golden file the card checks the port against
(``tests/torch_optimizer_golden.py``).

Both sides take the same numpy parameters and gradients for three
``apply_gradients`` steps. The slots are stored in the named dtype and the
math runs in float32 on both sides, so parameters and slots agree to
rtol 1e-5 (float32 rounding of the same operations; the bfloat16 slots
round the same float32 values).
"""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as ref_opt
from paddle_tpu.nn.layer import Parameter as RefParameter

import torch_optimizer_golden as golden
from paddle_tpu_torch import optimizer as port_opt

RTOL = 1e-5
SHAPES = {"w": (16, 8), "b": (8,)}


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _as_float32(x):
    return np.asarray(x).astype(np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("name,slot_dtype,torch_dtype", [
    ("AdamW", "bfloat16", torch.bfloat16),
    ("Adam", "float32", torch.float32),
    ("AdamW", "float16", torch.float16),
    ("Adam", "bfloat16", torch.bfloat16)])
def test_named_slot_dtype_matches_the_reference(name, slot_dtype,
                                                torch_dtype):
    kw = dict(weight_decay=0.01) if name == "AdamW" else {}
    ref = getattr(ref_opt, name)(1e-2, slot_dtype=slot_dtype, **kw)
    port = getattr(port_opt, name)(1e-2, slot_dtype=slot_dtype, **kw)
    params = _arrays(0)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    r_state = ref.init_state(r_params)
    p_state = port.init_state(p_params)
    for step in range(3):
        grads = _arrays(step + 1)
        r_params, r_state = ref.apply_gradients(
            r_params, {k: jnp.asarray(v) for k, v in grads.items()}, r_state)
        p_params, p_state = port.apply_gradients(
            p_params, {k: torch.from_numpy(v) for k, v in grads.items()},
            p_state)
    assert int(p_state["step"]) == int(r_state["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(p_params[k].numpy(),
                                   np.asarray(r_params[k]), rtol=RTOL,
                                   atol=1e-7)
        for slot in ("m", "v"):
            got, want = p_state["slots"][k][slot], r_state["slots"][k][slot]
            assert got.dtype == torch_dtype
            assert np.dtype(want.dtype).name == slot_dtype
            np.testing.assert_allclose(_as_float32(got), _as_float32(want),
                                       rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("value,want", [
    (None, torch.float32), ("bfloat16", torch.bfloat16),
    ("float32", torch.float32), ("float16", torch.float16),
    (np.dtype("float32"), torch.float32),
    (np.float16, torch.float16), (ml_dtypes.bfloat16, torch.bfloat16),
    (jnp.bfloat16, torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
def test_slot_dtype_names_map_as_jnp_dtype_reads_them(value, want):
    assert port_opt.optimizer.slot_dtype_of(value) == want
    if value is not None and not isinstance(value, torch.dtype):
        assert jnp.dtype(value).name == str(want).split(".")[-1]


@pytest.mark.parametrize("bad", ["bf16", "fp32", "half", "float64", "int8",
                                 3])
def test_unknown_slot_dtype_raises_at_construction(bad):
    with pytest.raises(ValueError, match="slot_dtype"):
        port_opt.AdamW(1e-3, slot_dtype=bad)
    with pytest.raises(ValueError, match="slot_dtype"):
        port_opt.Adam(1e-3, slot_dtype=bad)


def _run_both(ref, port, steps=3):
    params = _arrays(0)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    r_state = ref.init_state(r_params)
    p_state = port.init_state(p_params)
    for step in range(steps):
        grads = _arrays(step + 1)
        r_params, r_state = ref.apply_gradients(
            r_params, {k: jnp.asarray(v) for k, v in grads.items()}, r_state)
        p_params, p_state = port.apply_gradients(
            p_params, {k: torch.from_numpy(v) for k, v in grads.items()},
            p_state)
    return r_params, r_state, p_params, p_state


@pytest.mark.parametrize("decays", ["w", "b", None])
def test_adamw_decay_filter_matches_the_reference(decays):
    """``apply_decay_param_fun``: only the names it accepts decay; the
    rest step as plain Adam (rtol 1e-5, as above)."""
    fn = (lambda name: name == decays) if decays else None
    kw = dict(weight_decay=0.1, apply_decay_param_fun=fn)
    ref, port = ref_opt.AdamW(1e-2, **kw), port_opt.AdamW(1e-2, **kw)
    r_params, r_state, p_params, p_state = _run_both(ref, port)
    for k in SHAPES:
        np.testing.assert_allclose(p_params[k].numpy(),
                                   np.asarray(r_params[k]), rtol=RTOL,
                                   atol=1e-7)
    if decays:
        # the filtered-out tensor moved as plain Adam would move it
        other = "b" if decays == "w" else "w"
        a_ref, a_port = ref_opt.Adam(1e-2), port_opt.Adam(1e-2)
        _, _, p_plain, _ = _run_both(a_ref, a_port)
        np.testing.assert_allclose(p_params[other].numpy(),
                                   p_plain[other].numpy(), rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("SGD", {}), ("SGD", dict(weight_decay=0.01)),
    ("Momentum", dict(momentum=0.9)),
    ("Momentum", dict(momentum=0.8, use_nesterov=True)),
    ("Momentum", dict(momentum=0.9, weight_decay=0.05))])
def test_sgd_and_momentum_match_the_reference(name, kw):
    ref = getattr(ref_opt, name)(0.05, **kw)
    port = getattr(port_opt, name)(0.05, **kw)
    r_params, r_state, p_params, p_state = _run_both(ref, port, steps=4)
    assert int(p_state["step"]) == int(r_state["step"]) == 4
    for k in SHAPES:
        np.testing.assert_allclose(p_params[k].numpy(),
                                   np.asarray(r_params[k]), rtol=RTOL,
                                   atol=1e-7)
        for slot, want in r_state["slots"][k].items():
            got = p_state["slots"][k][slot]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=1e-7)


# -- the eleven classes, functional and eager ---------------------------------------

CASE_IDS = [f"{name}-{i}" for i, (name, _) in enumerate(golden.CASES)]


def _close(got, want):
    np.testing.assert_allclose(_as_float32(got), _as_float32(want),
                               rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", golden.CASES, ids=CASE_IDS)
def test_apply_gradients_with_lr_scales_matches_the_reference(case):
    """Three steps, ``"w"`` at half the learning rate: parameters and
    every slot at rtol 1e-5."""
    name, kwargs = case
    ref, port = golden.make(ref_opt, name, kwargs), \
        golden.make(port_opt, name, kwargs)
    params = golden.arrays(golden.PARAM_SEED)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    r_state, p_state = ref.init_state(r_params), port.init_state(p_params)
    for i in range(golden.STEPS):
        grads = golden.arrays(golden.GRAD_SEED + i)
        r_params, r_state = ref.apply_gradients(
            r_params, {k: jnp.asarray(v) for k, v in grads.items()},
            r_state, lr_scales=golden.LR_SCALES)
        p_params, p_state = port.apply_gradients(
            p_params, {k: torch.from_numpy(v) for k, v in grads.items()},
            p_state, lr_scales=golden.LR_SCALES)
    assert int(p_state["step"]) == int(r_state["step"]) == golden.STEPS
    for k in golden.SHAPES:
        _close(p_params[k], r_params[k])
        assert set(p_state["slots"][k]) == set(r_state["slots"][k])
        for slot, want in r_state["slots"][k].items():
            assert p_state["slots"][k][slot].dtype == torch.float32
            _close(p_state["slots"][k][slot], want)


def _eager_pair(name, kwargs, frozen=()):
    """The reference's and the port's optimizer over the same named
    parameters, ``"w"`` at half the learning rate, ``frozen`` keys not
    trained."""
    params = golden.arrays(golden.PARAM_SEED)
    r_list, p_list = [], []
    for k, v in params.items():
        rp = RefParameter(jnp.asarray(v), name=k, trainable=k not in frozen)
        pp = torch.nn.Parameter(torch.from_numpy(v.copy()),
                                requires_grad=k not in frozen)
        if k in golden.LR_SCALES:
            rp.optimize_attr["learning_rate"] = golden.LR_SCALES[k]
            pp.optimize_attr = {"learning_rate": golden.LR_SCALES[k]}
        r_list.append(rp)
        p_list.append((k, pp))
    ref = golden.make(ref_opt, name, dict(kwargs, parameters=r_list))
    port = golden.make(port_opt, name, dict(kwargs, parameters=p_list))
    return ref, r_list, port, dict(p_list)


def _eager_steps(ref, r_list, port, p_params, steps=golden.STEPS):
    for i in range(steps):
        grads = golden.arrays(golden.GRAD_SEED + i)
        for rp in r_list:
            rp.grad = jnp.asarray(grads[rp.name])
        for k, pp in p_params.items():
            pp.grad = torch.from_numpy(grads[k].copy())
        ref.step()
        port.step()
        ref.clear_grad()
        port.clear_grad()
        assert all(pp.grad is None for pp in p_params.values())


@pytest.mark.parametrize("case", golden.CASES, ids=CASE_IDS)
def test_eager_step_matches_the_reference(case):
    """``step()`` over named ``nn.Parameter``s against the reference's
    ``step()`` over its Parameters: parameters and slots at rtol 1e-5,
    each written in place; and the committed golden file's values."""
    name, kwargs = case
    ref, r_list, port, p_params = _eager_pair(name, kwargs)
    ids = {k: id(p) for k, p in p_params.items()}
    _eager_steps(ref, r_list, port, p_params)
    assert {k: id(p) for k, p in p_params.items()} == ids
    for rp in r_list:
        _close(p_params[rp.name].detach(), rp.value)
        for slot, want in ref._eager_state["slots"][rp.name].items():
            _close(port.state["slots"][rp.name][slot], want)
    with open(golden.OUT) as f:
        gold = json.load(f)
    row = next(c for c in gold["cases"]
               if c["name"] == name and c["kwargs"] == kwargs)
    for k, shape in golden.SHAPES.items():
        _close(p_params[k].detach(), golden.decode(row["params"][k], shape))


@pytest.mark.parametrize("name", ["AdamW", "Lamb", "RMSProp",
                                  "DGCMomentum"])
def test_frozen_parameter_keeps_value_and_slots(name):
    kwargs = dict(next(kw for n, kw in golden.CASES if n == name))
    ref, r_list, port, p_params = _eager_pair(name, kwargs,
                                              frozen=("b_norm",))
    start = p_params["b_norm"].detach().clone()
    _eager_steps(ref, r_list, port, p_params)
    assert torch.equal(p_params["b_norm"].detach(), start)
    for slot, v in port.state["slots"]["b_norm"].items():
        assert not v.any(), slot     # never stepped: still zeros
    for rp in r_list:
        _close(p_params[rp.name].detach(), rp.value)


def test_dgc_sparsity_follows_the_rampup_schedule():
    kw = dict(learning_rate=0.05, rampup_begin_step=2, rampup_step=5,
              sparsity=(0.25, 0.5, 0.75, 0.9, 0.99))
    ref, port = ref_opt.DGCMomentum(**kw), port_opt.DGCMomentum(**kw)
    got = [float(port._sparsity_at(torch.tensor(s, dtype=torch.int32)))
           for s in range(12)]
    want = [float(ref._sparsity_at(jnp.asarray(s, jnp.int32)))
            for s in range(12)]
    assert got == want
    # 0 up to step 2, then the entry (step - 2) * 5 // 5, clipped to the last
    assert got[:3] == [0.0] * 3 and got[3] == 0.5
    assert got[-1] == float(np.float32(0.99))


def test_parameter_keys_positions_and_names():
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    assert list(port_opt.SGD(0.1, parameters=[a, b])._parameter_list) == \
        [0, 1]
    named = torch.nn.Linear(3, 2).named_parameters()
    assert list(port_opt.SGD(0.1, parameters=named)._parameter_list) == \
        ["weight", "bias"]
    with pytest.raises(ValueError, match="twice"):
        port_opt.SGD(0.1, parameters=[("w", a), ("w", b)])
    with pytest.raises(ValueError, match="without parameters"):
        port_opt.SGD(0.1).step()


def test_minimize_state_dict_and_device_check():
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    opt = port_opt.Adam(0.01, parameters=lin.parameters())
    x = torch.randn(5, 4)
    lin(x).square().mean().backward()
    assert opt.minimize(None) == (None, None)
    assert int(opt.state["step"]) == 1
    saved = opt.state_dict()
    again = port_opt.Adam(0.01, parameters=lin.parameters())
    again.set_state_dict(saved)
    assert torch.equal(again.state["slots"][0]["m"],
                       opt.state["slots"][0]["m"])
    opt.clear_gradients()
    assert lin.weight.grad is None
    # the state lives where the first parameter does: a parameter on
    # another device raises, and nothing is moved
    elsewhere = torch.nn.Parameter(torch.zeros(3, device="meta"))
    mixed = port_opt.Adam(0.01, parameters=[lin.weight, elsewhere])
    with pytest.raises(RuntimeError, match="optimizer state"):
        mixed.step()
    assert elsewhere.device.type == "meta"


def test_committed_golden_file_matches_a_fresh_reference_run():
    with open(golden.OUT) as f:
        committed = json.load(f)
    fresh = golden.golden()
    assert committed["recipe"] == json.loads(json.dumps(fresh["recipe"]))
    assert [(c["name"], c["kwargs"]) for c in committed["cases"]] == \
        [(c["name"], c["kwargs"]) for c in fresh["cases"]]
    for old, new in zip(committed["cases"], fresh["cases"]):
        for k, shape in golden.SHAPES.items():
            np.testing.assert_allclose(
                golden.decode(old["params"][k], shape),
                golden.decode(new["params"][k], shape), rtol=1e-6,
                atol=0, err_msg=old["name"])
