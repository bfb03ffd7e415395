"""One rank of the port's data-parallel tests (``test_torch_data_parallel.py``).

``spawn``ed once per world size with gloo on the CPU; imports torch and
``paddle_tpu_torch`` only. Reads the plan the test wrote (numpy inputs and
the reference's initial weights), runs every case on this rank and
pickles what it got to ``<out_dir>/rank<r>.pkl``:

- ``tree``: ``compressed_tree_mean`` of this rank's tree (means and new
  residuals);
- ``mlp``: the reference's MLP harness (Momentum, ``grad_sync_block=64``)
  through ``ParallelTrainer`` on a data mesh of every rank: per-step
  losses, final parameters and this rank's residuals;
- ``gpt``: a depth-2 narrow GPT with AdamW (biases and norms kept out of
  the decay) under int8/int4;
- ``single``: rank 0 only, the fp32 MLP in one process on the whole
  batch (a mesh of one rank), the yardstick of data parallelism.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

MLP_LR, MLP_MOMENTUM, MLP_BLOCK = 0.05, 0.9, 64


def no_decay(name: str) -> bool:
    """AdamW's decay filter: biases and norms take no decay."""
    return not (name.endswith("bias") or ".ln" in name or "norm" in name)


def _np(t):
    if t is None:
        return None
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return None if tree is None else _np(tree)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def mlp_model():
    from paddle_tpu_torch import nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(16, 32)
            self.l2 = nn.Linear(32, 4)

        def forward(self, x):
            return self.l2(torch.relu(self.l1(x)))

    return MLP()


def mlp_loss(out, y):
    return torch.mean((out - y) ** 2)


def run_mlp(case, weights, X, Y, mesh):
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import set_axis_links
    from paddle_tpu_torch.optimizer import Momentum
    model = mlp_model()
    model.set_state_dict_from_numpy(weights)
    if case.get("links"):
        set_axis_links(case["links"], mesh=mesh)
    tr = ParallelTrainer(model, Momentum(MLP_LR, momentum=MLP_MOMENTUM),
                         mlp_loss, mesh=mesh, grad_sync=case["policy"],
                         grad_sync_block=MLP_BLOCK,
                         grad_sync_buckets=case["buckets"],
                         grad_sync_dcn_only=case.get("dcn_only"),
                         accumulate_steps=case["k"], device="cpu")
    if case.get("links"):
        set_axis_links({}, mesh=mesh)
    losses = [float(tr.train_step(X, Y)) for _ in range(case["steps"])]
    return {"losses": losses,
            "params": {n: _np(p) for n, p in tr.params.items()},
            "comm_err": {n: _np(v) for n, v in tr.comm_err.items()},
            "buckets": tr.grad_sync_bucket_keys,
            "skipped": tr.skipped_steps()}


def gpt_loss_layer(model, chunk):
    from paddle_tpu_torch import nn

    class FusedLoss(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, chunk=chunk,
                                              ce_kernel="chunked")

    return FusedLoss(model)


def run_gpt(case, plan, mesh):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTForPretraining
    model = GPTForPretraining(**plan["gpt_cfg"])
    model.set_state_dict_from_numpy(plan["gpt_weights"])
    tr = ParallelTrainer(
        gpt_loss_layer(model, plan["gpt_chunk"]),
        AdamW(3e-4, weight_decay=0.01, apply_decay_param_fun=no_decay),
        lambda out, _l: out, mesh=mesh, grad_sync=case["policy"],
        grad_sync_buckets=case["buckets"], device="cpu")
    batch = tuple(torch.from_numpy(a) for a in plan["gpt_batch"])
    telemetry.enable()
    telemetry.get_registry().reset()
    losses = [float(tr.train_step(batch, 0.0))
              for _ in range(case["steps"])]
    reg = telemetry.get_registry().to_dict()
    telemetry.enable(False)
    return {"losses": losses,
            "params": {n: _np(p) for n, p in tr.params.items()},
            "comm_err": {n: _np(v) for n, v in tr.comm_err.items()},
            "telemetry": {k: reg.get(k) for k in (
                "grad_sync_bytes_total", "grad_sync_compression_x")},
            "skipped": tr.skipped_steps()}


def run_collectives(rank, n):
    """Every collective of ``collective.py`` and the eager wrappers over
    the data ranks, on rank-dependent inputs -> what this rank got."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients
    from paddle_tpu_torch.distributed.parallel import (DataParallel,
                                                       sync_params_buffers)
    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    out = {"sum": C.all_reduce(x.clone()).numpy(),
           "avg": C.all_reduce(x.clone(), op=C.ReduceOp.AVG).numpy(),
           "max": C.all_reduce(x.clone(), op=C.ReduceOp.MAX).numpy(),
           "min": C.all_reduce(x.clone(), op=C.ReduceOp.MIN).numpy(),
           "prod": C.all_reduce(x.clone() + 1, op=C.ReduceOp.PROD).numpy(),
           "reduce": C.reduce(x.clone(), dst=0).numpy(),
           "broadcast": C.broadcast(x.clone(), src=n - 1).numpy(),
           "reduce_scatter": C.reduce_scatter(
               torch.arange(2 * n, dtype=torch.float32) * (rank + 1)).numpy()}
    parts = []
    out["all_gather"] = C.all_gather(parts, x).numpy()
    out["all_gather_list"] = [p.numpy() for p in parts]
    out["scatter"] = C.scatter(torch.empty(3), [
        torch.full((3,), float(i + 100 * rank)) for i in range(n)],
        src=0).numpy()
    out["alltoall"] = [t.numpy() for t in C.alltoall(
        [torch.full((2,), float(10 * rank + j)) for j in range(n)])]
    buf = torch.full((4,), -1.0)
    if rank == 0:
        C.send(torch.arange(4, dtype=torch.float32), dst=1)
    elif rank == 1:
        C.recv(buf, src=0)
    out["recv"] = buf.numpy()
    C.barrier()
    grads = {"w": torch.full((5,), float(rank)), "b": torch.ones(3) * rank}
    dp = DataParallel(mlp_model(), grad_sync="fp32")
    out["dp_sync"] = {k: v.numpy() for k, v in dp.sync_gradients(
        grads).items()}
    with dp.no_sync():
        out["dp_no_sync"] = dp.sync_gradients(grads)["w"].numpy()
    out["fused"] = {k: v.numpy() for k, v in
                    fused_allreduce_gradients(grads).items()}
    model = mlp_model()
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float(rank))
    sync_params_buffers(model, src_rank=1)
    out["synced"] = [float(p.mean()) for p in model.parameters()]
    return out


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import compressed, env, mesh
    env.init_parallel_env(device="cpu")
    rank, n = env.get_rank(), env.get_world_size()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    m = mesh.build_mesh({"data": n})
    assert mesh.axis_links(m)["data"] == "ici"
    out = {"rank": rank, "n": n, "tree": {}, "mlp": {}, "gpt": {},
           "collectives": run_collectives(rank, n)}
    for name, case in plan["tree"].items():
        tree = _tree_t({k: v[rank] for k, v in case["tree"].items()})
        res = (_tree_t({k: v[rank] for k, v in case["res"].items()})
               if case["res"] is not None else None)
        mean, new_res = compressed.compressed_tree_mean(
            tree, case["axis"], policy=case["policy"], block=case["block"],
            bucket_bytes=case["bucket_bytes"], residuals=res, mesh=m)
        out["tree"][name] = (_tree_np(mean), _tree_np(new_res))
    X, Y = plan["mlp_batch"]
    for name, case in plan["mlp"].items():
        out["mlp"][name] = run_mlp(case, plan["mlp_weights"], X, Y, m)
    for name, case in plan.get("gpt", {}).items():
        out["gpt"][name] = run_gpt(case, plan, m)
    if rank == 0:
        one = mesh.Mesh({"data": 1})
        out["single"] = run_mlp(dict(policy="fp32", buckets=1, k=1,
                                     steps=plan["mlp_steps"]),
                                plan["mlp_weights"], X, Y, one)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def exit_with(code: int):
    """A rank that fails (``spawn``'s error path)."""
    raise SystemExit(code)
