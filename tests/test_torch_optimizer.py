"""The port's optimizers against the JAX package's on the CPU: Adam and
AdamW with the moments stored in a dtype named by a string, as bench.py's
GPT-1.3B configuration asks for (``AdamW(..., slot_dtype="bfloat16")``);
AdamW's ``apply_decay_param_fun``; ``SGD`` and ``Momentum`` (the
reference's data-parallel harness trains with the latter).

Both sides take the same numpy parameters and gradients for three
``apply_gradients`` steps. The slots are stored in the named dtype and the
math runs in float32 on both sides, so parameters and slots agree to
rtol 1e-5 (float32 rounding of the same operations; the bfloat16 slots
round the same float32 values).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as ref_opt

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
