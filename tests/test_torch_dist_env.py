"""The port's distributed scaffolding in one process on the CPU: ``env``,
``mesh`` (axes, link types), ``collective`` in a world of one rank (the
identity), ``spawn``'s failure path, ``fleet.utils``, ``DataParallel`` as
the trainer reads it, ``partition_reverse_buckets`` and the weight-carry
of a reference trainer's whole state (``set_trainer_state_from_numpy``),
each against the JAX package where it has the same function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu import nn as rnn
from paddle_tpu.distributed import engine as ref_engine
from paddle_tpu.distributed import mesh as ref_mesh

import torch_dp_worker as worker
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import env, mesh
from paddle_tpu_torch.distributed.engine import (ParallelTrainer,
                                                 partition_reverse_buckets)
from paddle_tpu_torch.distributed.fleet import utils as fleet_utils
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.nn.layer import set_trainer_state_from_numpy
from paddle_tpu_torch.optimizer import Momentum


@pytest.fixture(autouse=True)
def _no_current_mesh():
    mesh.set_mesh(None)
    yield
    mesh.set_mesh(None)


def test_env_reads_torchrun_and_paddle_names(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                 "PADDLE_RANK_IN_NODE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert env.get_rank() == 0 and env.get_world_size() == 1
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    assert env.get_rank() == 3 and env.get_world_size() == 8
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "6")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    pe = env.ParallelEnv()
    assert (pe.rank, pe.world_size, pe.nranks, pe.local_rank, pe.dev_id) == \
        (5, 6, 6, 1, 1)
    assert pe.current_endpoint == "10.0.0.1:1234"
    assert pe.trainer_endpoints == ["10.0.0.1:1234"]
    assert env.get_local_world_size() == 2
    assert env.backend_for("cpu") == "gloo"
    assert env.backend_for("cuda:0") == "nccl"


def test_init_parallel_env_never_falls_back_to_gloo():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_parallel_env()
    with pytest.raises(RuntimeError, match="NCCL"):
        env.init_parallel_env(device="cpu", backend="nccl")


def test_build_mesh_axes_and_errors():
    m = mesh.build_mesh({"data": 1})
    assert mesh.get_mesh() is m and mesh.require_mesh() is m
    assert m.shape == {"data": 1, "pipe": 1, "sharding": 1, "sep": 1,
                       "model": 1}
    assert tuple(m.axis_names) == ref_mesh.AXES_ORDER
    assert m.group_of("data") is None and m.rank_in("data") == 0
    assert m.backend() is None and mesh.axis_size("data") == 1
    for ax in ("pipe", "sharding", "sep", "model"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mesh.build_mesh({"data": 1, ax: 2})
    with pytest.raises(ValueError, match="process group"):
        mesh.build_mesh({"data": 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.build_mesh({"tensor": 2})


def test_axis_links_like_the_reference():
    one = mesh.build_mesh({"data": 1})
    r_one = ref_mesh.build_mesh({"data": 1})
    assert mesh.axis_links(one) == ref_mesh.axis_links(r_one)
    assert mesh.explicit_axis_links(one) is None
    # four data ranks on two hosts: stepping along data crosses a host
    two_hosts = mesh.Mesh({"data": 4}, hosts=[0, 0, 1, 1])
    assert mesh.infer_axis_links(two_hosts)["data"] == "dcn"
    assert mesh.axis_link("model", two_hosts) == "ici"
    assert mesh.infer_axis_links(mesh.Mesh({"data": 4}))["data"] == "ici"
    set_to = mesh.set_axis_links({"data": "ici"}, mesh=two_hosts)
    assert set_to == {"data": "ici"}
    assert mesh.axis_links(two_hosts)["data"] == "ici"
    assert mesh.explicit_axis_links(two_hosts) == {"data": "ici"}
    for bad in ({"data": "nvlink"}, {"tensor": "ici"}):
        with pytest.raises(ValueError):
            mesh.set_axis_links(bad, mesh=one)
        with pytest.raises(ValueError):
            ref_mesh.set_axis_links(bad, mesh=r_one)


def test_collectives_are_the_identity_in_a_world_of_one():
    x = torch.arange(4.0)
    assert C.all_reduce(x, op=C.ReduceOp.AVG) is x
    assert C.broadcast(x, src=0) is x and C.reduce(x) is x
    assert C.reduce_scatter(x) is x and C.send(x) is x and C.recv(x) is x
    parts = []
    np.testing.assert_array_equal(C.all_gather(parts, x).numpy(),
                                  x[None].numpy())
    assert parts == [x]
    y = x + 1
    assert all(a is b for a, b in zip(C.alltoall([x, y]), [x, y]))
    np.testing.assert_array_equal(C.scatter(x, [x + 5, x + 6]).numpy(),
                                  (x + 5).numpy())
    C.barrier()
    g = C.new_group([0])
    assert g.nranks == 1 and g.rank == 0 and C.get_group(g.id) is g


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="exit code"):
        spawn(worker.exit_with, args=(3,), nprocs=1, timeout=120)


def test_recompute_and_checkpoint_policy():
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8, requires_grad=True)

    def fn(v):
        return torch.tanh(lin(v)) * 2

    out = fleet_utils.recompute(fn, x)
    g_re = torch.autograd.grad(out.sum(), [x, lin.weight])
    g = torch.autograd.grad(fn(x).sum(), [x, lin.weight])
    for a, b in zip(g_re, g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fleet_utils.checkpoint_policy(None) is None
    assert fleet_utils.checkpoint_policy("full") is None
    with pytest.raises(NotImplementedError):
        fleet_utils.checkpoint_policy("dots_saveable")
    with pytest.raises(ValueError):
        fleet_utils.checkpoint_policy("bogus")
    grads = {"w": torch.ones(3)}
    assert fleet_utils.fused_allreduce_gradients(grads) is grads


def test_dataparallel_settings_reach_the_trainer():
    model = worker.mlp_model()
    dp = DataParallel(model, grad_sync="int8", grad_sync_block=64,
                      comm_buffer_size=1)
    with pytest.raises(ValueError):
        DataParallel(model, grad_sync="fp8")
    x = torch.randn(2, 16)
    torch.testing.assert_close(dp(x), model(x))
    assert [n for n, _ in dp.named_parameters()] == \
        [n for n, _ in model.named_parameters()]
    tr = ParallelTrainer(dp, Momentum(0.1), worker.mlp_loss, device="cpu")
    assert (tr.grad_sync, tr.grad_sync_block, tr.grad_sync_bucket_bytes) == \
        ("int8", 64, 1 << 20)
    tr16 = ParallelTrainer(worker.mlp_model(), Momentum(0.1),
                           worker.mlp_loss, fp16_allreduce=True,
                           device="cpu")
    assert tr16.grad_sync == "bf16" and tr16.fp16_allreduce


@pytest.mark.parametrize("items,k", [
    ([("a", 4), ("b", 4), ("c", 4), ("d", 4)], 2),
    ([("a", 100), ("b", 1), ("c", 1), ("d", 1), ("e", 50)], 3),
    ([("a", 1)], 4), ([(f"p{i}", i + 1) for i in range(10)], 4),
    ([("x", 8), ("y", 8)], 5)])
def test_partition_reverse_buckets_matches(items, k):
    assert partition_reverse_buckets(items, k) == \
        ref_engine.partition_reverse_buckets(items, k)


class _RefMLP(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = rnn.Linear(16, 32)
        self.l2 = rnn.Linear(32, 4)

    def forward(self, x):
        return self.l2(rnn.functional.relu(self.l1(x)))


def test_trainer_state_carries_from_the_reference():
    """Two reference steps (int8, a loss scaler, Momentum), the whole state
    loaded into a fresh port trainer, then one more step on each: losses
    rtol 1e-5, parameters atol 1e-5 (float32 sums in other orders)."""
    paddle.seed(7)
    model = _RefMLP()
    ref_mesh.build_mesh({"data": 1})
    scaler_kw = dict(init_loss_scaling=256.0, incr_every_n_steps=1)
    ref = ref_engine.ParallelTrainer(
        model, paddle.optimizer.Momentum(0.05, momentum=0.9,
                                         parameters=model.parameters()),
        lambda out, y: jnp.mean((out - y) ** 2), grad_sync="int8",
        grad_sync_block=64, scaler=ref_amp.GradScaler(**scaler_kw))
    rs = np.random.RandomState(3)
    X = rs.randn(32, 16).astype(np.float32)
    Y = X @ rs.randn(16, 4).astype(np.float32)
    for _ in range(2):
        ref.train_step(X, Y)
    port = ParallelTrainer(worker.mlp_model(), Momentum(0.05, momentum=0.9),
                           worker.mlp_loss, grad_sync="int8",
                           grad_sync_block=64,
                           scaler=amp.GradScaler(**scaler_kw), device="cpu")
    set_trainer_state_from_numpy(port, jax.tree_util.tree_map(np.asarray,
                                                              ref.state))
    assert int(port.opt_state["step"]) == 2
    assert port.loss_scale() == float(ref.state["guard"]["amp"]["scale"])
    np.testing.assert_array_equal(
        port.comm_err["l1.weight"].numpy(),
        np.asarray(ref.state["comm_err"]["l1.weight"])[0])
    lr_, lp = float(ref.train_step(X, Y)), float(port.train_step(X, Y))
    np.testing.assert_allclose(lp, lr_, rtol=1e-5)
    for k, v in ref.state["params"].items():
        np.testing.assert_allclose(port.get_param(k).numpy(), np.asarray(v),
                                   atol=1e-5)
    bad = jax.tree_util.tree_map(np.asarray, ref.state)
    bad["comm_err"].pop("l1.bias")
    with pytest.raises(ValueError, match="comm_err"):
        set_trainer_state_from_numpy(port, bad)


@pytest.mark.parametrize("unused", [False, True])
def test_buckets_are_issued_inside_the_backward(monkeypatch, unused):
    """int8 with four buckets on a data mesh of one rank: every bucket
    whose gradients all exist is issued from the tensor hooks before
    ``torch.autograd.grad`` returns, bucket 0 (the last layer) while the
    first layer's gradients do not exist yet; a bucket holding a parameter
    the loss does not use, and every later bucket, is issued after the
    backward (``finish``), in index order."""
    from paddle_tpu_torch.distributed import engine
    issued, in_backward = [], [True]
    real_issue, real_finish = engine._BucketHooks._issue, \
        engine._BucketHooks.finish

    def issue(self, b):
        issued.append((b, in_backward[0], sorted(self.grads)))
        return real_issue(self, b)

    def finish(self, grads):
        in_backward[0] = False
        return real_finish(self, grads)

    monkeypatch.setattr(engine._BucketHooks, "_issue", issue)
    monkeypatch.setattr(engine._BucketHooks, "finish", finish)
    model = worker.mlp_model()
    if unused:      # registered between the two layers the loss uses
        l2 = model.l2
        del model.l2
        model.l1x = torch.nn.Linear(8, 8, bias=False)
        model.l2 = l2
    tr = ParallelTrainer(model, Momentum(0.1), worker.mlp_loss,
                         mesh=mesh.build_mesh({"data": 1}), grad_sync="int8",
                         grad_sync_block=64, grad_sync_buckets=4,
                         device="cpu")
    keys = tr.grad_sync_bucket_keys
    assert len(keys) == 4 and keys[0][0].startswith("l2")
    rs = np.random.RandomState(0)
    X = rs.randn(8, 16).astype(np.float32)
    tr.train_step(X, X[:, :4])
    assert [b for b, _, _ in issued] == list(range(len(keys)))
    idle = [b for b, k in enumerate(keys)
            if any(n.startswith("l1x.") for n in k)]
    assert idle == ([1] if unused else [])
    for b, inside, seen in issued:
        assert inside == (not idle or b < idle[0]), (b, keys)
    assert issued[0][1] and "l1.weight" not in issued[0][2]
