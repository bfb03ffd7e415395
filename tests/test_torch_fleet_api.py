"""The fleet API, the hybrid optimizer and the grouped ZeRO API of the
port, against the JAX package's.

In this process (a world of one rank): ``DistributedStrategy`` and
``HybridConfig`` field by field, ``fleet.init``'s degrees,
``distributed_model``'s dispatch (``TensorParallel``, ``PipelineParallel``
of a ``PipelineLayer``), ``ShardingParallel``'s
stage-3 specs, ``HybridParallelOptimizer`` (a trainer drives its inner
optimizer: bit-equal to the bare one), ``group_sharded_parallel``'s levels
and errors and ``save_group_sharded_model`` (the reference's
``tests/test_elastic_autockpt.py:96-135``), the save paths and the
parameter-server raises. On a gloo world of 4 (the spawn
``test_torch_mesh_topology.py`` shares): the default ``data`` degree, a
data x sharding strategy through ``distributed_model``,
``distributed_optimizer``, ``group_sharded_parallel`` and
``build_trainer``, the consolidated save, the hybrid optimizer's mean and
eager step, and the grad scaler's any-reduce.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.meta_parallel import \
    ShardingParallel as RefShardingParallel

from paddle_tpu_torch import amp, framework_io, jit, nn, optimizer
from paddle_tpu_torch.distributed import fleet, mesh, sharding
from paddle_tpu_torch.distributed.checkpoint import load_checkpoint
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.distributed.meta_parallel import (
    HybridParallelGradScaler, HybridParallelOptimizer, PipelineParallel,
    ShardingParallel, TensorParallel)
from paddle_tpu_torch.distributed.parallel import DataParallel
from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
from test_torch_mesh_topology import run_world


class _M(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)
        self.big = nn.Linear(64, 32)

    def forward(self, x):
        return self.fc(x)


def test_strategy_fields_equal_the_reference():
    got, want = fleet.DistributedStrategy().to_dict(), \
        ref_fleet.DistributedStrategy().to_dict()
    assert got == want
    import dataclasses
    assert [f.name for f in dataclasses.fields(fleet.HybridConfig)] == \
        [f.name for f in dataclasses.fields(ref_fleet.HybridConfig)]


def test_init_degrees_and_worker_info():
    s = fleet.DistributedStrategy()
    f = fleet.Fleet().init(strategy=s)
    assert mesh.get_mesh().shape == {a: 1 for a in mesh.AXES_ORDER}
    hcg = f.get_hybrid_communicate_group()
    assert (hcg.get_data_parallel_world_size(),
            hcg.get_sharding_parallel_world_size()) == (1, 1)
    assert f.is_first_worker() and f.worker_index() == 0
    assert f.worker_num() == 1 and f.is_worker()
    assert f.worker_endpoints(to_string=True) == \
        ",".join(f.worker_endpoints())
    f.barrier_worker()
    s.hybrid_configs = {"dp_degree": 1, "sharding_degree": 2}
    with pytest.raises(ValueError, match="process group"):
        fleet.Fleet().init(strategy=s)


def _fleet_with(dims):
    f = fleet.Fleet()
    topo = mesh.CommunicateTopology(("data", "pipe", "sharding", "model"),
                                    dims)
    f._hcg = mesh.HybridCommunicateGroup(topo, 0)
    f._strategy = fleet.DistributedStrategy()
    return f


def test_distributed_model_dispatch():
    m = _M()
    assert isinstance(_fleet_with((1, 1, 1, 1)).distributed_model(m),
                      DataParallel)
    sp = _fleet_with((1, 1, 2, 1)).distributed_model(m)
    assert isinstance(sp, ShardingParallel) and sp.stage == 1
    tp = _fleet_with((1, 1, 1, 2)).distributed_model(m)
    assert isinstance(tp, TensorParallel) and tp._layers is m
    assert [k for k, _ in tp.named_parameters()] == \
        [k for k, _ in m.named_parameters()]
    # the pipeline wraps a PipelineLayer only, as the reference's
    with pytest.raises(TypeError, match="PipelineLayer"):
        _fleet_with((1, 2, 1, 1)).distributed_model(m)
    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                            PipelineLayer)
    pl = PipelineLayer([LayerDesc(nn.Linear, 4, 4),
                        LayerDesc(nn.Linear, 4, 4)], num_stages=2)
    pp = _fleet_with((1, 2, 1, 1)).distributed_model(pl)
    assert isinstance(pp, PipelineParallel) and pp.num_stages == 2
    assert pp.schedule == "gpipe" and pp.accumulate_steps == 1


def test_sharding_parallel_stage3_specs_equal_the_reference():
    s = fleet.DistributedStrategy()
    s.sharding_configs = {"stage": 3, "grad_sync": "int4",
                          "grad_sync_block": 32}
    hcg = mesh.HybridCommunicateGroup(
        mesh.CommunicateTopology(("data", "pipe", "sharding", "model"),
                                 (1, 1, 2, 1)), 0)
    sp = ShardingParallel(_M(), hcg, s)
    paddle.seed(0)
    rm = paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                              paddle.nn.Linear(64, 32))
    RefShardingParallel(rm, hcg, s)
    got = {n: p.pspec for n, p in sp.named_parameters()}
    want = [tuple(p.pspec) for p in rm.parameters()]
    assert list(got.values()) == want
    assert got["big.weight"] == ("sharding", None)   # 64 x 32: the 64
    assert (sp.stage, sp.grad_sync, sp.grad_sync_block) == (3, "int4", 32)
    # the trainer honours the specs at zero_stage=0 (one rank: n = 1)
    tr = ParallelTrainer(sp, optimizer.AdamW(1e-3), lambda o, y: o.sum(),
                         mesh=mesh.Mesh({"data": 1}), device="cpu")
    assert tr.zero3_dims == {} and tr.grad_sync == "int4"


def test_hybrid_optimizer_is_the_inner_optimizer_in_a_trainer():
    clip = ClipGradByGlobalNorm(0.5)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype("float32")
    y = rng.randn(8, 4).astype("float32")
    losses, params = [], []
    init = {k: v.clone() for k, v in _M().state_dict().items()}
    for wrap in (False, True):
        m = _M()
        m.load_state_dict(init)
        inner = optimizer.AdamW(1e-2, grad_clip=clip)
        opt = HybridParallelOptimizer(inner) if wrap else inner
        if wrap:
            assert opt._inner_opt is inner and inner._grad_clip is clip
            assert opt.get_lr() == inner.get_lr()
        tr = ParallelTrainer(m, opt, lambda o, t: ((o - t) ** 2).mean(),
                             mesh=mesh.Mesh({"data": 1}), device="cpu")
        losses.append([float(tr.train_step(x, y)) for _ in range(3)])
        params.append({k: v.clone() for k, v in m.state_dict().items()})
        assert opt.state is inner.state          # the state lives inside
    assert losses[0] == losses[1]
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k])


def test_hybrid_optimizer_eager_step_and_scaler():
    p = torch.nn.Parameter(torch.ones(3))
    opt = HybridParallelOptimizer(optimizer.SGD(0.5, parameters=[p]))
    p.grad = torch.full((3,), 2.0)
    assert opt.sync_gradients({"a": p.grad})["a"] is p.grad   # one rank
    opt.step()
    assert torch.equal(p.detach(), torch.zeros(3))
    opt.clear_grad()
    assert p.grad is None
    sc = HybridParallelGradScaler(amp.GradScaler(init_loss_scaling=4.0))
    out, found = sc.unscale_({"w": torch.tensor([8.0, float("nan")])})
    assert bool(found) and float(out["w"][0]) == 2.0
    assert sc.get_loss_scaling() == 4.0


def test_group_sharded_parallel_api():
    m, opt = _M(), optimizer.AdamW(1e-3)
    m2, opt2, scaler = sharding.group_sharded_parallel(m, opt, "os_g")
    assert sharding.get_group_sharded_stage(m2) == 2
    assert sharding.get_group_sharded_stage(opt2) == 2 and scaler is None
    with pytest.raises(ValueError):
        sharding.group_sharded_parallel(m, opt, "bogus")
    with pytest.raises(NotImplementedError):
        sharding.group_sharded_parallel(m, opt, "os", offload=True)
    for level, stage in (("os", 1), ("p_g_os", 3)):
        sharding.group_sharded_parallel(m, opt, level)
        tr = sharding.build_trainer(m, opt, lambda o, y: o.sum(),
                                    mesh=mesh.Mesh({"data": 1}),
                                    device="cpu")
        assert tr.zero_stage == stage


def test_save_group_sharded_model(tmp_path):
    m, opt = _M(), optimizer.AdamW(1e-3)
    tr = ParallelTrainer(m, opt, lambda o, y: o.sum(),
                         mesh=mesh.Mesh({"data": 1}), zero_stage=3,
                         device="cpu")
    tr.train_step(np.ones((2, 4), np.float32), 0.0)
    out = str(tmp_path / "gss")
    sharding.save_group_sharded_model(m, out, opt)
    assert os.path.exists(out)
    got = load_checkpoint(out)
    for k, v in m.state_dict().items():
        assert torch.equal(got["model"][k], v)
    assert torch.equal(got["opt"]["state.step"], opt.state["step"])


def test_zero_bytes_per_rank_follows_the_split():
    """``zero_bytes_per_rank`` against the counts by hand: ``big.weight``
    (64 x 32, fp32, 8 KiB) splits over 2 ranks, the rest (under 1024
    elements) stays whole; AdamW keeps two float32 slots a parameter."""
    m, opt = _M(), optimizer.AdamW(1e-3)
    whole = sum(p.numel() * 4 for n, p in m.named_parameters()
                if n != "big.weight")
    big = 64 * 32 * 4
    for stage, (pp, gg, ss) in {0: (1, 1, 1), 1: (1, 1, 2), 2: (1, 2, 2),
                                3: (2, 2, 2)}.items():
        got = sharding.zero_bytes_per_rank(m, opt, stage, 2)
        assert got == {"params": whole + big // pp,
                       "grads": whole + big // gg,
                       "slots": 2 * (whole + big // ss)}, stage
    assert sharding.zero_bytes_per_rank(m, opt, 3, 1) == \
        sharding.zero_bytes_per_rank(m, opt, 0, 1)


def test_saves_and_the_raising_paths(tmp_path, monkeypatch):
    m = _M()
    f = fleet.Fleet()
    d = f.save_persistables(dirname=str(tmp_path / "p"), model=m)
    sd = framework_io.load(os.path.join(d, "model.pdparams"))
    ref_sd = paddle.load(os.path.join(d, "model.pdparams"))
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy())
        np.testing.assert_array_equal(np.asarray(ref_sd[k]), v.numpy())
    assert f.save(str(tmp_path / "q"), model=m) == str(tmp_path / "q")
    path = f.save_inference_model(
        dirname=str(tmp_path / "inf"), model=m,
        input_spec=[jit.InputSpec([None, 4], "float32")])
    loaded = jit.load(path, device="cpu")
    x = torch.ones(2, 4)
    assert torch.equal(loaded(x), m(x))
    with pytest.raises(ValueError):
        f.save_inference_model(dirname=str(tmp_path / "x"), model=m)
    with pytest.raises(NotImplementedError, match="item 21"):
        f.save_persistables(dirname=str(tmp_path / "s"))
    # the parameter-server lifecycle, as the reference's: no endpoints to
    # connect to raises; stopping what never started does nothing; serving
    # needs a server first
    monkeypatch.delenv("PADDLE_PSERVER_ENDPOINTS", raising=False)
    with pytest.raises(RuntimeError, match="PADDLE_PSERVER_ENDPOINTS"):
        f.init_worker()
    assert f.stop_worker() is None and f.stop_server() is None
    with pytest.raises(RuntimeError, match="init_server"):
        f.run_server()
    with pytest.raises(ValueError, match="dim"):
        f.init_server()
    assert callable(fleet.save) and callable(fleet.distributed_model)


@pytest.mark.multihost(timeout=300)
def test_fleet_on_a_world_of_4(tmp_path_factory):
    plan, ranks = run_world(tmp_path_factory)
    for r, out in enumerate(ranks):
        f = out["fleet"]
        assert f["default_shape"]["data"] == 4
        assert f["hcg"] == (r // 2, r % 2, 2, 2)
        assert f["wrapper"] == "ShardingParallel"
        assert (f["stage"], f["grad_sync"]) == (3, "int8")
        assert f["losses"] == ranks[0]["fleet"]["losses"]
        assert f["losses"][1] < f["losses"][0]
        # the mean over this rank's data group {r % 2, r % 2 + 2}
        np.testing.assert_array_equal(f["synced"], np.full(3, r % 2 + 1.0))
        np.testing.assert_array_equal(f["eager"], np.full(3, -(r % 2 + 1.0)))
        assert f["eager_cleared"] and f["found_inf"]
    saved = ranks[0]["fleet"]["saved_model"]
    for k, v in ranks[0]["fleet"]["full_params"].items():
        np.testing.assert_array_equal(saved[k], v)
    assert any(k.startswith("state.slots") for k in
               ranks[0]["fleet"]["saved_opt_keys"])
