"""Data parallelism of the port over gloo ranks on the CPU, against the JAX
package on a data mesh of the same size.

The port ``spawn``s 2 and then 4 ranks (each world once, every case inside
that one spawn: ``torch_dp_worker.py``); the reference runs in this
process on that many virtual devices (``shard_map`` over ``build_mesh(
{"data": n})``, the ``spmd`` helper of ``test_collective_compressed.py``),
from the same numpy inputs and the same initial weights.

Tolerances, each derived where it is asserted:

- ``compressed_tree_mean``: int8/int4 means are bit-identical at 2 and 4
  ranks (integer sums; the same float32 operations around them);
  residuals agree within half an ulp of ``q * scale`` (XLA contracts
  ``x - q*scale`` into one fused multiply-add). fp32 and bf16 means are
  bit-identical at 2 ranks (a + b has one rounding in either order); at 4
  the two all-reduces may add in other orders, each addition rounding by
  at most u * sum|x| (u = 2**-24, bf16 2**-9): within 2 (n-1) u sum|x| / n.
- The reference's MLP harness, 5 steps: losses rtol 1e-4 and parameters
  atol 2e-4. The two frameworks' float32 forward and backward differ in
  the last bits (sums in other orders); under int8/int4 such a bit can move
  one element across a rounding boundary of the quantizer, one quantum
  (amax / 127 or / 7 of a 64-block) of one gradient, which momentum
  carries into later steps. Residuals atol 5e-3 (one int4 quantum of the
  largest gradients here). bf16 at 4 ranks: the exchanged gradients differ
  by the bfloat16 sum-order bound above (2**-9 relative an addition, a
  few bfloat16 ulps of each gradient), so losses rtol 5e-3 and parameters
  within 2**-5 of each tensor's largest total update after 5 steps.
- GPT, depth 2, AdamW, int8/int4 over 2 ranks, 3 steps: losses rtol 1e-4;
  parameters: all but 1 in 1000 elements within 1e-4, every element within
  2 * lr * steps (an element the quantizer rounds the other way changes
  Adam's normalized step, at most lr, by at most 2 * lr). The key bias of
  the QKV projection, whose true gradient is 0, is compared in its q and
  v parts only, as in test_torch_gpt_train.py.
- fp32 over 2 ranks against one process on the whole batch: losses rtol
  1e-6, parameters atol 1e-6 (the mean of two half-batch gradients
  against one whole-batch gradient: float32 sums in other orders).
- fp32 buckets against the monolithic exchange: bitwise at 2 ranks; at 4
  within 1e-6 (gloo's all-reduce cuts a buffer by its size, so a bucket
  and the whole flat add in other orders).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed import compressed as ref
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.distributed.mesh import set_axis_links as ref_set_axis_links
from paddle_tpu.text.models import GPTForPretraining as RefGPT
from paddle_tpu.text.models import gpt_tiny

import torch_dp_worker as worker
from paddle_tpu_torch.distributed.spawn import spawn
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=420)

WORLDS = (2, 4)
MLP_STEPS = 5
GPT_STEPS = 3
GPT_CFG = dict(tensor_parallel=False, attn_dropout=0.0, hidden_dropout=0.0,
               **gpt_tiny())
GPT_CHUNK = 384


def _tree_cases(n):
    """name -> case; each leaf (and residual) holds one row per rank."""
    rs = np.random.RandomState(100 + n)

    def tree():
        return {"w": (rs.randn(n, 31, 9) * 3).astype(np.float32),
                "a": rs.randn(n, 77).astype(np.float32),
                "zero": np.zeros((n, 130), np.float32),
                "v": rs.randn(n, 300).astype(np.float32)}

    def res(t):
        return {k: (rs.randn(*v.shape) * 0.01).astype(np.float32)
                for k, v in t.items()}

    cases = {}
    policies = ("fp32", "bf16", "int8", "int4")
    for pol in policies:
        t = tree()
        cases[f"{pol}-plain"] = dict(tree=t, res=None, policy=pol, axis="data",
                                     block=None, bucket_bytes=4 << 20)
        if n == 2 or pol in ("int8", "int4"):
            t = tree()
            cases[f"{pol}-res-buckets"] = dict(
                tree=t, res=res(t), policy=pol, axis="data", block=32,
                bucket_bytes=1024)
    t = tree()
    cases["per-axis"] = dict(tree=t, res=res(t), policy={"data": "int8"},
                             axis=("data", "sharding"), block=None,
                             bucket_bytes=2048)
    return cases


def _ref_tree_mean(case, n):
    mesh = ref_build_mesh({"data": n})
    t = {k: jnp.asarray(v) for k, v in case["tree"].items()}
    r = (None if case["res"] is None else
         {k: jnp.asarray(v) for k, v in case["res"].items()})
    spec = jax.tree_util.tree_map(lambda v: P("data"), t)

    def f(tt, rr):
        local = {k: v[0] for k, v in tt.items()}
        lres = None if rr is None else {k: v[0] for k, v in rr.items()}
        mean, new = ref.compressed_tree_mean(
            local, case["axis"], policy=case["policy"], block=case["block"],
            bucket_bytes=case["bucket_bytes"], residuals=lres)
        return ({k: v[None] for k, v in mean.items()},
                None if new is None else {k: v[None] for k, v in new.items()})

    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(spec, None if r is None else spec),
        out_specs=(spec, None if r is None else spec), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(t, r))


# ---------------------------------------------------------------------------
# the reference's MLP harness (test_collective_compressed.py:329-352)
# ---------------------------------------------------------------------------

def _mlp_batch():
    rng = np.random.RandomState(3)
    X = rng.randn(64, 16).astype(np.float32)
    W = rng.randn(16, 4).astype(np.float32)
    return X, X @ W


class _RefMLP(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = rnn.Linear(16, 32)
        self.l2 = rnn.Linear(32, 4)

    def forward(self, x):
        return self.l2(rnn.functional.relu(self.l1(x)))


def _mlp_weights():
    paddle.seed(7)
    model = _RefMLP()
    return model, {k: np.asarray(v) for k, v in model.state_dict().items()}


def _mlp_cases(n):
    cases = {}
    for pol in ("fp32", "bf16", "int8", "int4"):
        cases[f"{pol}-b1"] = dict(policy=pol, buckets=1, k=1)
        cases[f"{pol}-b4-k2"] = dict(policy=pol, buckets=4, k=2)
    cases["fp32-b4"] = dict(policy="fp32", buckets=4, k=1)   # port only
    if n == 2:
        # DCN gating: the data axis declared "dcn" quantizes, "ici" stays
        # fp32 (mesh.set_axis_links on both sides)
        for link in ("dcn", "ici"):
            cases[f"int8-dcn-only-{link}"] = dict(
                policy="int8", buckets=1, k=1, dcn_only=True,
                links={"data": link})
    for c in cases.values():
        c["steps"] = MLP_STEPS
    return cases


def _ref_mlp(case, n):
    model, _ = _mlp_weights()
    mesh = ref_build_mesh({"data": n})
    if case.get("links"):
        ref_set_axis_links(case["links"], mesh=mesh)
    opt = paddle.optimizer.Momentum(worker.MLP_LR,
                                    momentum=worker.MLP_MOMENTUM,
                                    parameters=model.parameters())
    tr = RefTrainer(model, opt, lambda out, y: jnp.mean((out - y) ** 2),
                    mesh=mesh, grad_sync=case["policy"],
                    grad_sync_block=worker.MLP_BLOCK,
                    grad_sync_buckets=case["buckets"],
                    grad_sync_dcn_only=case.get("dcn_only"),
                    accumulate_steps=case["k"])
    X, Y = _mlp_batch()
    losses = [float(tr.train_step(X, Y)) for _ in range(case["steps"])]
    return {"losses": losses,
            "params": {k: np.asarray(v) for k, v in
                       tr.state["params"].items()},
            "comm_err": {k: np.asarray(v) for k, v in
                         tr.state["comm_err"].items()},
            "buckets": tr.grad_sync_bucket_keys}


# ---------------------------------------------------------------------------
# GPT, depth 2
# ---------------------------------------------------------------------------

def _gpt_batch():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 1024, (4, 64)).astype(np.int32)
    lbl = rs.randint(0, 1024, (4, 64)).astype(np.int32)
    return ids, lbl


def _ref_gpt_model():
    paddle.seed(0)
    return RefGPT(**GPT_CFG)


class _RefLoss(rnn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch):
        ids, lbl = batch
        return self.inner.fused_head_loss(ids, lbl, chunk=GPT_CHUNK,
                                          ce_kernel="chunked")


def _ref_gpt(case, n):
    model = _ref_gpt_model()
    mesh = ref_build_mesh({"data": n})
    opt = paddle.optimizer.AdamW(GPT_LR, weight_decay=0.01,
                                 apply_decay_param_fun=worker.no_decay,
                                 parameters=model.parameters())
    tr = RefTrainer(_RefLoss(model), opt, lambda out, _l: out, mesh=mesh,
                    grad_sync=case["policy"],
                    grad_sync_buckets=case["buckets"])
    batch = _gpt_batch()
    losses = [float(tr.train_step(batch, 0.0)) for _ in range(case["steps"])]
    return {"losses": losses,
            "params": {k: np.asarray(v) for k, v in
                       tr.state["params"].items()}}


GPT_CASES = {"int8-b1": dict(policy="int8", buckets=1, steps=GPT_STEPS),
             "int4-b4": dict(policy="int4", buckets=4, steps=GPT_STEPS)}


# ---------------------------------------------------------------------------
# one spawn per world size
# ---------------------------------------------------------------------------

_RUNS = {}


def _run(n, tmp_path_factory):
    if n in _RUNS:
        return _RUNS[n]
    d = tmp_path_factory.mktemp(f"dp{n}")
    _, weights = _mlp_weights()
    plan = {"tree": _tree_cases(n), "mlp": _mlp_cases(n),
            "mlp_weights": weights, "mlp_batch": _mlp_batch(),
            "mlp_steps": MLP_STEPS}
    if n == 2:
        plan.update(gpt=GPT_CASES, gpt_cfg=GPT_CFG, gpt_chunk=GPT_CHUNK,
                    gpt_batch=_gpt_batch(),
                    gpt_weights={k: np.asarray(v) for k, v in
                                 _ref_gpt_model().state_dict().items()})
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(worker.main, args=(str(d / "plan.pkl"), str(d)), nprocs=n,
          timeout=300)
    ranks = []
    for r in range(n):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    _RUNS[n] = (plan, ranks)
    return _RUNS[n]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


def _sum_order_close(got, want, rows, policy, n):
    """Two means of ``n`` rows added in other orders: each of the n - 1
    additions rounds by at most u * sum|x| (u = 2**-24 in float32, 2**-9
    in bfloat16), so the two differ by at most 2 (n - 1) u sum|x| / n."""
    u = 2.0 ** -24 if policy == "fp32" else 2.0 ** -9
    bound = 2 * (n - 1) * u * np.abs(rows).sum(axis=0) / n
    assert np.all(np.abs(np.asarray(got) - want) <= bound), policy


def test_tree_mean_matches_the_reference(world):
    n, (plan, ranks) = world
    for name, case in plan["tree"].items():
        want, want_res = _ref_tree_mean(case, n)
        pol = case["policy"]
        quantized = isinstance(pol, dict) or pol in ("int8", "int4")
        for r, out in enumerate(ranks):
            mean, res = out["tree"][name]
            for k in case["tree"]:
                got, w = mean[k], want[k][r]
                if quantized or n == 2:
                    np.testing.assert_array_equal(got, w, err_msg=(name, k))
                else:
                    _sum_order_close(got, w, case["tree"][k], pol, n)
            if case["res"] is None:
                assert res is None
                continue
            for k in case["tree"]:
                x = case["tree"][k][r] + case["res"][k][r]
                w = want_res[k][r]
                if not quantized:
                    np.testing.assert_array_equal(res[k], w)
                    continue
                bound = 2.0 ** -24 * (np.abs(x) + np.abs(w))
                assert np.all(np.abs(res[k] - w) <= bound), (name, k)
        # every rank holds the same mean
        for out in ranks[1:]:
            for k in case["tree"]:
                np.testing.assert_array_equal(out["tree"][name][0][k],
                                              ranks[0]["tree"][name][0][k])


def test_mlp_trainer_matches_the_reference(world):
    n, (plan, ranks) = world
    for name, case in plan["mlp"].items():
        if name == "fp32-b4":
            continue
        want = _ref_mlp(case, n)
        for r, out in enumerate(ranks):
            got = out["mlp"][name]
            assert got["buckets"] == want["buckets"], name
            assert got["skipped"] == 0
            bf16_order = case["policy"] == "bf16" and n > 2
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=5e-3 if bf16_order else 1e-4,
                                       err_msg=name)
            for k, w in want["params"].items():
                # bf16 over 4 ranks: 2**-5 of the largest total update
                atol = (2.0 ** -5 * np.abs(w - plan["mlp_weights"][k]).max()
                        if bf16_order else 2e-4)
                np.testing.assert_allclose(got["params"][k], w, atol=atol,
                                           err_msg=(name, k))
            assert set(got["comm_err"]) == set(want["comm_err"])
            for k, w in want["comm_err"].items():
                assert w.shape[0] == n
                np.testing.assert_allclose(got["comm_err"][k], w[r],
                                           atol=5e-3, err_msg=(name, k))
        moved = any(np.abs(v).max() > 0
                    for v in ranks[0]["mlp"][name]["comm_err"].values())
        # the residuals move wherever the exchange quantizes; under DCN
        # gating an "ici" data axis stays fp32
        assert moved == (case["policy"] in ("int8", "int4")
                         and case.get("links", {}).get("data") != "ici")
        # replicas stay equal
        for out in ranks[1:]:
            for k, v in out["mlp"][name]["params"].items():
                np.testing.assert_array_equal(
                    v, ranks[0]["mlp"][name]["params"][k])


def test_collectives_over_ranks(world):
    """collective.py, DataParallel.sync_gradients/no_sync,
    fused_allreduce_gradients and sync_params_buffers over the gloo ranks,
    against their definitions on the ranks' inputs (exact: small integers
    in float32)."""
    n, (plan, ranks) = world
    xs = [np.arange(6, dtype=np.float32) + 10 * r for r in range(n)]
    for r, out in enumerate(ranks):
        c = out["collectives"]
        np.testing.assert_array_equal(c["sum"], sum(xs))
        np.testing.assert_array_equal(c["avg"], sum(xs) / n)
        np.testing.assert_array_equal(c["max"], xs[-1])
        np.testing.assert_array_equal(c["min"], xs[0])
        np.testing.assert_array_equal(c["prod"], np.prod(
            [x + 1 for x in xs], axis=0))
        np.testing.assert_array_equal(c["reduce"], sum(xs))
        np.testing.assert_array_equal(c["broadcast"], xs[-1])
        full = sum(np.arange(2 * n, dtype=np.float32) * (q + 1)
                   for q in range(n))
        np.testing.assert_array_equal(c["reduce_scatter"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(c["all_gather"], np.stack(xs))
        assert len(c["all_gather_list"]) == n
        np.testing.assert_array_equal(c["scatter"], np.full(3, float(r)))
        for j, t in enumerate(c["alltoall"]):
            np.testing.assert_array_equal(t, np.full(2, float(10 * j + r)))
        want_recv = np.arange(4) if r == 1 else np.full(4, -1.0)
        np.testing.assert_array_equal(c["recv"], want_recv)
        mean = sum(range(n)) / n
        for key in ("dp_sync", "fused"):
            np.testing.assert_array_equal(c[key]["w"], np.full(5, mean))
            np.testing.assert_array_equal(c[key]["b"], np.full(3, mean))
        np.testing.assert_array_equal(c["dp_no_sync"], np.full(5, float(r)))
        assert c["synced"] == [1.0] * 4


def test_fp32_data_parallel_matches_one_process(world):
    n, (plan, ranks) = world
    dp, one = ranks[0]["mlp"]["fp32-b1"], ranks[0]["single"]
    np.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-6)
    for k, v in one["params"].items():
        np.testing.assert_allclose(dp["params"][k], v, atol=1e-6)


def test_fp32_buckets_match_the_monolithic_exchange(world):
    n, (plan, ranks) = world
    mono, buck = ranks[0]["mlp"]["fp32-b1"], ranks[0]["mlp"]["fp32-b4"]
    assert len(buck["buckets"]) == 4 and len(mono["buckets"]) == 1
    for k, v in mono["params"].items():
        if n == 2:
            np.testing.assert_array_equal(buck["params"][k], v)
        else:
            np.testing.assert_allclose(buck["params"][k], v, atol=1e-6)


GPT_LR = 3e-4


def _adam_close(got, want, *what):
    """All but 1 in 1000 elements within 1e-4; every element within
    2 * lr * steps: a gradient element that the quantizer rounds the other
    way (one quantum; a last-bit difference of the two frameworks' float32
    backward puts it on the other side) changes Adam's normalized step of
    that element by at most 2 * lr."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= 2 * GPT_LR * GPT_STEPS, what
    assert np.mean(diff > 1e-4) <= 1e-3, what


def test_gpt_int8_int4_match_the_reference(tmp_path_factory):
    n = 2
    plan, ranks = _run(n, tmp_path_factory)
    heads = GPT_CFG["num_heads"]
    hd = GPT_CFG["hidden_size"] // heads
    for name, case in GPT_CASES.items():
        want = _ref_gpt(case, n)
        for out in ranks:
            got = out["gpt"][name]
            assert got["skipped"] == 0
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-4, err_msg=name)
            assert got["losses"][-1] < got["losses"][0]
            for k, w in want["params"].items():
                g = got["params"][k]
                if k.endswith("attn.qkv_proj.bias"):
                    g = g.reshape(heads, 3, hd)[:, [0, 2]]
                    w = w.reshape(heads, 3, hd)[:, [0, 2]]
                _adam_close(g, w, name, k)
            tel = got["telemetry"]
            series = tel["grad_sync_bytes_total"]["series"]
            assert sum(series.values()) > 0
            assert all(f"policy={case['policy']}" in s for s in series)
            assert tel["grad_sync_compression_x"]["series"]


def test_quantized_loss_band(tmp_path_factory):
    """The band chip_smoke.py's train_dp holds the quantized runs to, from
    the same comparison here: a bf16 GPT (depth 2, narrow) on a data mesh
    of one rank, 2 warm-up + 10 steps of AdamW on one fixed batch, int8 and
    int4 with the decay filter against fp32 without it (as fused_b8 runs).
    The band is at least ten times the largest relative loss gap read."""
    import torch
    import chip_smoke
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTForPretraining
    rs = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rs.randint(0, 1024, (8, 128))
                                   .astype(np.int32)) for _ in range(2))
    losses = {}
    for pol in ("fp32", "int8", "int4"):
        framework.seed(0)
        model = GPTForPretraining(**GPT_CFG)
        model.bfloat16()
        opt = (AdamW(GPT_LR) if pol == "fp32" else
               AdamW(GPT_LR, apply_decay_param_fun=chip_smoke.no_decay))
        tr = ParallelTrainer(worker.gpt_loss_layer(model, 8192), opt,
                             lambda out, _l: out, mesh=Mesh({"data": 1}),
                             grad_sync=pol, device="cpu")
        losses[pol] = np.array([float(tr.train_step(batch, 0.0))
                                for _ in range(12)])[2:]
        assert np.all(np.diff(losses[pol]) < 0)
    for pol in ("int8", "int4"):
        gap = np.max(np.abs(losses[pol] - losses["fp32"]) / losses["fp32"])
        print(f"loss band reading {pol}: {gap}")
        assert 0 < gap and 10 * gap <= chip_smoke.DP_LOSS_BAND[pol], \
            (pol, gap)
