"""Tensor parallelism of the port, and Lamb, Lars and DGCMomentum on split
leaves, over gloo ranks on the CPU, against the JAX package's trainer on a
mesh of the same shape.

The port ``spawn``s a world of 2 and one of 4 (``torch_hybrid_worker.py``,
each once, every case inside it); the reference runs in this process on as
many of the 8 virtual devices, from the same numpy weights and batches
(each reference run once per module).

- GPT (``GPTForPretraining(tensor_parallel=True)``, the reference's sep
  test widths: vocab 128, H 32, 2 layers, 2 heads, S 64, dropout 0) under
  ``TensorParallel`` with ``GPTForPretraining.loss`` (the mean of
  ``ParallelCrossEntropy``) at ``{"model": 2}`` (AdamW, AdamW with a
  global-norm clip, Lamb, Lars), ``{"data": 2, "model": 2}`` (AdamW,
  Lamb) and ``{"sharding": 2, "model": 2}`` at ZeRO stage 2 (AdamW).
- The ZeRO tests' MLP under Lamb, Lars and DGCMomentum at
  ``{"sharding": 2}`` stages 1 and 3 and ``{"data": 2, "sharding": 2}``
  stage 2 (Queue 3 item 9: the norms and the top-k of a ZeRO slice are
  the whole parameter's).

Tolerances, each derived where it is asserted:

- GPT, port against reference, float32: the two run the same sums in
  other orders (PyTorch's CPU GEMM against XLA's dot, the model-axis sums
  in gloo's order against XLA's psum), so a loss agrees to rtol 1e-5 (a
  few float32 ulps of a sum of 64 x 4 per-token losses near 4.9, plus
  the parameters' drift below) and each parameter element to
  ``GPT_ATOL`` = lr / 50 = 2e-5: AdamW divides each gradient element by
  its own running scale, so an element whose gradient cancels to a small
  sum carries its relative rounding error into a step of up to lr; the
  bar passes one such element a few percent off and fails a wrong step
  (a step is lr). The key bias of ``qkv_proj`` has no true gradient
  (softmax cancels it), so Adam turns its rounding noise into +-lr steps:
  its q and v parts are compared, as ``test_torch_zero.py`` does.
- Lamb and Lars scale a whole parameter's step by a ratio of norms taken
  over its slices; the ratio agrees to float32 rounding of two sums of
  squares, so the bar is the same fraction of their steps (lr / 50).
  Under tensor parallelism their weights are ramped (``_ramp``): with the
  reference's init the halves of a leaf have nearly the ratio of the
  whole, and a ratio taken over one slice alone would pass. There each
  leaf's update (final minus initial) is held in relative L2 within
  ``RAMP_UPDATE_RTOL`` = 1e-2: a trust ratio taken over one slice of a
  ramped leaf is off by its slice's norm ratio, tens of percent on every
  element; the rounding of a gradient that cancels to a few ulps moves a
  lone element's step by up to a tenth of lr (Lamb's epsilon is 1e-6,
  against a gradient of that size), under a percent of a leaf's update
  norm in L2.
- The MLP (16-64-64-4, lr 1e-2, Lars at ``LARS_LR``, 5 steps) under Lamb,
  Lars and DGC, port
  against reference: ``MLP_ATOL`` = lr / 5000 = 2e-6, the ZeRO tests'
  float32 bar (a five-thousandth of one step), losses rtol 1e-6. DGC's
  threshold selects by magnitude; the runs here sit far from a tie (the
  port's stage 0 and its ZeRO stages select the same elements: their
  parameters are equal within the same bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.text.models import GPTForPretraining as RefGPT

import torch_hybrid_worker as worker
import torch_zero_worker as zero_worker
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=300)

GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
               max_position_embeddings=64, attn_dropout=0.0,
               hidden_dropout=0.0)
GPT_LR = 1e-3
GPT_ATOL = GPT_LR / 50
MLP_LR = 1e-2
MLP_ATOL = MLP_LR / 5000
RAMP_UPDATE_RTOL = 1e-2
# Lars scales lr by lars_coeff (1e-3) times ||p|| / ||g||: at the MLP's
# 1e-2 its steps are ~1e-5 and a wrong norm hides under MLP_ATOL; at 1.0
# a step is ~1e-3, as large as the other optimizers'
LARS_LR = 1.0
STEPS = 3


def _gpt(**kw):
    c = dict(model="gpt", tp=True, opt="adamw", lr=GPT_LR, steps=STEPS,
             weights="gpt", batch="gpt")
    c.update(kw)
    return c


def _mlp(**kw):
    c = dict(model="mlp", lr=MLP_LR, steps=5, weights="mlp", batch="mlp")
    c.update(kw)
    return c


CASES = {
    2: {"tp-adamw": _gpt(degrees={"model": 2}),
        "tp-adamw-clip": _gpt(degrees={"model": 2}, clip=0.05),
        "tp-lamb": _gpt(degrees={"model": 2}, opt="lamb",
                        weights="gpt-ramp"),
        "tp-lars": _gpt(degrees={"model": 2}, opt="lars", lr=0.1,
                        weights="gpt-ramp"),
        "zero1-lamb": _mlp(degrees={"sharding": 2}, stage=1, opt="lamb"),
        "zero3-lamb": _mlp(degrees={"sharding": 2}, stage=3, opt="lamb"),
        "zero1-lars": _mlp(degrees={"sharding": 2}, stage=1, opt="lars",
                           lr=LARS_LR),
        "zero3-lars": _mlp(degrees={"sharding": 2}, stage=3, opt="lars",
                           lr=LARS_LR),
        "zero0-dgc": _mlp(degrees={"sharding": 2}, stage=0, opt="dgc"),
        "zero1-dgc": _mlp(degrees={"sharding": 2}, stage=1, opt="dgc"),
        "zero3-dgc": _mlp(degrees={"sharding": 2}, stage=3, opt="dgc")},
    4: {"dp-tp-adamw": _gpt(degrees={"data": 2, "model": 2}),
        "dp-tp-lamb": _gpt(degrees={"data": 2, "model": 2}, opt="lamb",
                           weights="gpt-ramp"),
        "zero2-tp-adamw": _gpt(degrees={"sharding": 2, "model": 2},
                               stage=2),
        "zero2-lamb": _mlp(degrees={"data": 2, "sharding": 2}, stage=2,
                           opt="lamb"),
        "zero2-lars": _mlp(degrees={"data": 2, "sharding": 2}, stage=2,
                           opt="lars", lr=LARS_LR),
        "zero2-dgc": _mlp(degrees={"data": 2, "sharding": 2}, stage=2,
                          opt="dgc")},
}


def _ref_gpt(tp=True):
    paddle.seed(0)
    return RefGPT(tensor_parallel=tp, **GPT_CFG)


def _ref_mlp():
    paddle.seed(0)
    return rnn.Sequential(rnn.Linear(16, 64), rnn.ReLU(),
                          rnn.Linear(64, 64), rnn.ReLU(), rnn.Linear(64, 4))


def _batches():
    rs = np.random.RandomState(0)
    gpt = (rs.randint(0, 128, (4, 64)).astype(np.int32),
           rs.randint(0, 128, (4, 64)).astype(np.int32))
    rm = np.random.RandomState(0)
    mlp = (rm.randn(8, 16).astype("float32"),
           rm.randint(0, 4, (8,)).astype("int64"))
    return {"gpt": gpt, "mlp": mlp}


def _ramp(state):
    """Every matrix scaled by a ramp over each of its dims (x1 to x3), so
    that the halves of a split leaf have different norms: a trust ratio
    taken over a slice alone differs from the whole leaf's."""
    out = {}
    for k, v in state.items():
        for d in range(v.ndim if v.ndim >= 2 else 0):
            shape = [1] * v.ndim
            shape[d] = v.shape[d]
            v = v * (1.0 + 2.0 * np.arange(v.shape[d]) / v.shape[d]
                     ).reshape(shape).astype(v.dtype)
        out[k] = v
    return out


def _weights():
    gpt = {k: np.asarray(v) for k, v in _ref_gpt().state_dict().items()}
    return {"gpt": gpt, "gpt-ramp": _ramp(gpt),
            "mlp": {k: np.asarray(v) for k, v in
                    _ref_mlp().state_dict().items()}}


def _ref_opt(case, params):
    clip = (ropt.ClipGradByGlobalNorm(case["clip"]) if case.get("clip")
            else None)
    name, lr = case["opt"], case["lr"]
    if name == "adamw":
        return ropt.AdamW(lr, weight_decay=0.01,
                          apply_decay_param_fun=zero_worker.no_decay,
                          grad_clip=clip, parameters=params)
    if name == "lamb":
        return ropt.Lamb(lr, lamb_weight_decay=0.01, grad_clip=clip,
                         parameters=params)
    if name == "lars":
        return ropt.Lars(lr, momentum=0.9, lars_coeff=0.001,
                         lars_weight_decay=0.0005, grad_clip=clip,
                         parameters=params)
    return ropt.DGCMomentum(lr, momentum=0.9, sparsity=(0.75,),
                            grad_clip=clip, parameters=params)


_REF = {}


def _ref_run(name, case):
    """(losses, {name: array}) of the reference trainer on the case."""
    if name in _REF:
        return _REF[name]
    batch = _batches()[case["batch"]]
    if case["model"] == "gpt":
        m = _ref_gpt(case["tp"])
        if case["weights"] != "gpt":
            m.set_state_dict({k: jnp.asarray(v) for k, v in
                              _weights()[case["weights"]].items()})
        loss_fn = lambda lg, lb: m.loss(lg, lb)  # noqa: E731
    else:
        m = _ref_mlp()
        loss_fn = lambda o, y: rnn.functional.cross_entropy(o, y)  # noqa
    tr = RefTrainer(m, _ref_opt(case, m.parameters()), loss_fn,
                    mesh=ref_build_mesh(case["degrees"]),
                    zero_stage=case.get("stage", 0))
    losses = [float(tr.train_step(*batch)) for _ in range(case["steps"])]
    params = {k: np.asarray(v) for k, v in tr.state["params"].items()}
    _REF[name] = (losses, params)
    return _REF[name]


_RUNS = {}


def _world(n, tmp_path_factory):
    if n not in _RUNS:
        plan = {"train": CASES[n], "gpt_cfg": dict(GPT_CFG),
                "weights": _weights(), "batches": _batches()}
        _RUNS[n] = worker.spawn_plan(plan, n, tmp_path_factory, f"tp{n}")
    return _RUNS[n]


def _qv(key, a):
    """The q and v parts of qkv_proj's bias (its key part has no true
    gradient: module docstring)."""
    if key.endswith("qkv_proj.bias"):
        hd = GPT_CFG["hidden_size"] // GPT_CFG["num_heads"]
        return a.reshape(-1, 3, hd)[:, [0, 2]]
    return a


@pytest.mark.parametrize("n,name", [(n, c) for n in CASES for c in CASES[n]])
def test_trainer_matches_the_reference(n, name, tmp_path_factory):
    ranks = _world(n, tmp_path_factory)
    case = CASES[n][name]
    losses, params = _ref_run(name, case)
    gpt = case["model"] == "gpt"
    atol = GPT_ATOL * case["lr"] / GPT_LR if gpt else MLP_ATOL
    rtol = 1e-5 if gpt else 1e-6
    for r in ranks:
        got = r["train"][name]
        assert got["skipped"] == 0
        np.testing.assert_allclose(got["losses"], losses, rtol=rtol)
    assert ranks[0]["train"][name]["losses"][-1] < losses[0]
    assert set(ranks[0]["train"][name]["params"]) == set(params)
    init = _weights()[case["weights"]]
    for k, want in params.items():
        got = worker.assemble(ranks, name, k)
        if case["weights"] == "gpt-ramp":
            # each leaf's update in relative L2 (module docstring)
            d_got, d_want = (_qv(k, a - init[k]) for a in (got, want))
            err = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert err <= RAMP_UPDATE_RTOL, (name, k, err)
            continue
        np.testing.assert_allclose(_qv(k, got), _qv(k, want), rtol=0,
                                   atol=atol, err_msg=f"{name} {k}")


def test_tp_leaves_hold_their_slices(tmp_path_factory):
    """At ``{"model": 2}`` a column weight holds half the columns, a row
    weight half the rows, the embedding half the vocab; the LayerNorm is
    whole and equal on both ranks (``assemble`` checks the copies)."""
    ranks = _world(2, tmp_path_factory)
    got = ranks[0]["train"]["tp-adamw"]["params"]
    a, sp = got["gpt.h.0.attn.qkv_proj.weight"]
    assert a.shape == (32, 48) and sp == (("model", 1),)
    a, sp = got["gpt.h.0.mlp.fc_out.weight"]
    assert a.shape == (64, 32) and sp == (("model", 0),)
    a, sp = got["gpt.embeddings.word_embeddings.weight"]
    assert a.shape == (64, 32) and sp == (("model", 0),)
    a, sp = got["gpt.h.0.ln_1.weight"]
    assert a.shape == (32,) and sp == ()
    worker.assemble(ranks, "tp-adamw", "gpt.h.0.ln_1.weight")


@pytest.mark.parametrize("stage", ["zero1-dgc", "zero3-dgc"])
def test_dgc_zero_slices_select_the_whole_parameters_top_k(
        stage, tmp_path_factory):
    """DGCMomentum on ZeRO slices gathers the residual for its threshold:
    the update equals the port's unsplit stage 0 bit for bit (every rank
    selects the same elements as one process over the whole tensor)."""
    ranks = _world(2, tmp_path_factory)
    for k in ranks[0]["train"]["zero0-dgc"]["params"]:
        np.testing.assert_array_equal(worker.assemble(ranks, stage, k),
                                      worker.assemble(ranks, "zero0-dgc", k))
