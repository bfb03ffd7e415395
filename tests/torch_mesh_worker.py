"""One rank of ``test_torch_mesh_topology.py``: a gloo world of 4.

Builds ``{"data": 2, "sharding": 2}`` and ``{"pipe": 2, "model": 2}``
meshes and reports, for every set of live axes, the ranks of this rank's
group, its index there and an ``all_reduce`` over it; then the fleet API
on this world (default ``data`` degree, a data x sharding strategy,
``distributed_model``/``distributed_optimizer``, a ZeRO-2 trainer, the
hybrid optimizer's and grad scaler's reductions, the consolidated save).
Pickles what it got to ``<out>/rank<r>.pkl``.
"""
from __future__ import annotations

import itertools
import os
import pickle

import torch

from torch_dp_worker import _np
from torch_zero_worker import mlp_loss, mlp_model


def groups(mesh):
    import torch.distributed as dist
    live = mesh.live(mesh.axis_names)
    out = {}
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            g = mesh.group_of(axes)
            t = torch.tensor([float(mesh.rank)])
            dist.all_reduce(t, group=g)
            out[axes] = {"ranks": dist.get_process_group_ranks(g),
                         "rank_in": mesh.rank_in(axes),
                         "dist_rank": dist.get_rank(g),
                         "sum": float(t)}
    return out


def fleet_cases(plan, rank):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet, sharding
    from paddle_tpu_torch.distributed.checkpoint import load_checkpoint
    from paddle_tpu_torch.distributed.mesh import get_mesh
    from paddle_tpu_torch.distributed.meta_parallel import (
        HybridParallelGradScaler, ShardingParallel)
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.optimizer import AdamW
    out = {}
    fleet.init(is_collective=True)
    out["default_shape"] = dict(get_mesh().shape)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    s.sharding = True
    s.sharding_configs = {"stage": 2, "grad_sync": "int8",
                          "grad_sync_block": 64}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    out["hcg"] = (hcg.get_data_parallel_rank(),
                  hcg.get_sharding_parallel_rank(),
                  hcg.get_data_parallel_world_size(),
                  hcg.get_sharding_parallel_world_size())
    model = mlp_model()
    model.set_state_dict_from_numpy(plan["weights"])
    dm = fleet.distributed_model(model)
    out["wrapper"] = type(dm).__name__
    assert isinstance(dm, ShardingParallel) and not isinstance(
        dm, DataParallel)
    opt = fleet.distributed_optimizer(AdamW(1e-2))
    dm, opt, _ = sharding.group_sharded_parallel(dm, opt, "p_g_os")
    tr = sharding.build_trainer(dm, opt, mlp_loss, device="cpu")
    out["stage"] = tr.zero_stage
    out["grad_sync"] = tr.grad_sync
    X, Y = plan["batch"]
    out["losses"] = [float(tr.train_step(X, Y)) for _ in range(2)]
    sharding.save_group_sharded_model(dm, plan["gss_dir"], opt)
    tr.sync_to_model()
    out["full_params"] = {n: _np(p).copy() for n, p in tr.params.items()}
    torch.distributed.barrier()
    if rank == 0:
        saved = load_checkpoint(plan["gss_dir"])
        out["saved_model"] = {k: _np(v) for k, v in saved["model"].items()}
        out["saved_opt_keys"] = sorted(saved["opt"])
    # the hybrid optimizer's mean over data, and the eager step
    g = {"w": torch.full((3,), float(rank)), "none": None}
    out["synced"] = _np(opt.sync_gradients(g)["w"])
    p = torch.nn.Parameter(torch.zeros(3))
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.distributed.meta_parallel import \
        HybridParallelOptimizer
    eager = HybridParallelOptimizer(SGD(1.0, parameters=[p]))
    p.grad = torch.full((3,), float(rank))
    eager.step()
    out["eager"] = _np(p.detach()).copy()
    eager.clear_grad()
    out["eager_cleared"] = p.grad is None
    # any rank's non-finite gradient skips the step everywhere
    sc = HybridParallelGradScaler(amp.GradScaler(init_loss_scaling=1.0))
    bad = {"w": torch.tensor([float("inf") if rank == 3 else 1.0])}
    _, found = sc.unscale_(bad)
    out["found_inf"] = bool(found)
    return out


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = {"rank": rank}
    for name, degrees in plan["meshes"].items():
        m = mesh_mod.build_mesh(degrees)
        out[name] = {"coord": dict(m.coord), "groups": groups(m),
                     "links": mesh_mod.axis_links(m)}
    out["fleet"] = fleet_cases(plan, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
