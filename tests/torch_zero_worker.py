"""One rank of the port's ZeRO tests (``test_torch_zero.py``).

``spawn``ed once per world with gloo on the CPU; imports torch and
``paddle_tpu_torch`` only. Reads the plan the test wrote, builds the mesh
the plan names (``{"sharding": 2}`` or ``{"data": 2, "sharding": 2}``),
runs every case and pickles what this rank got to ``<out>/rank<r>.pkl``:

- ``rs``: ``psum_scatter`` / ``compressed_psum_scatter`` of this rank's
  input over ``sharding`` (the sum's chunk and the new residual);
- ``mlp``: the reference's ZeRO MLP (``TestZeroStage3``/``TestZeroStage2``)
  through ``ParallelTrainer(zero_stage=...)``: per-step losses, the whole
  parameters (``sync_to_model``), this rank's residual rows and slot
  slices, the ZeRO dims, the storage sizes, the integrity verdicts and
  the gradients the optimizer got at step 1 (this rank's slices);
- ``rows``: this rank's own gradient at the initial weights on its slice
  of the batch (what the step-1 exchange averages);
- ``gpt``: a narrow GPT at stage 3 under int8.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from torch_dp_worker import _np, gpt_loss_layer, no_decay

MLP_LR = 1e-2


def mlp_model():
    """The reference's ``nn.Sequential(Linear(16, 64), ReLU, Linear(64,
    64), ReLU, Linear(64, 4))``, under its parameter names."""
    from paddle_tpu_torch import nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            for i, (a, b) in zip((0, 2, 4), ((16, 64), (64, 64), (64, 4))):
                self.add_module(str(i), nn.Linear(a, b))

        def forward(self, x):
            m = self._modules
            return m["4"](torch.relu(m["2"](torch.relu(m["0"](x)))))

    return MLP()


def mlp_loss(out, y):
    return torch.nn.functional.cross_entropy(out, y)


def _recording(cls):
    """``cls`` keeping the gradients of its first ``apply_gradients``."""
    class Recording(cls):
        first = None

        def apply_gradients(self, params, grads, state, lr=None,
                            lr_scales=None, split=None):
            if self.first is None:
                self.first = {k: _np(g) for k, g in grads.items()
                              if g is not None}
            return super().apply_gradients(params, grads, state, lr,
                                           lr_scales, split)
    return Recording


def _clip(spec):
    from paddle_tpu_torch.optimizer import (ClipGradByGlobalNorm,
                                            ClipGradByNorm)
    if spec is None:
        return None
    kind, norm = spec
    return (ClipGradByGlobalNorm if kind == "global" else
            ClipGradByNorm)(norm)


def local_rows(plan, mesh):
    """This rank's gradient at the initial weights on its slice of the
    batch (data-major over ``("data", "sharding")``)."""
    from paddle_tpu_torch.distributed.engine import _shard
    model = mlp_model()
    model.set_state_dict_from_numpy(plan["mlp_weights"])
    axes = ("data", "sharding")
    X, Y = (torch.from_numpy(a) for a in plan["mlp_batch"])
    n, r = mesh.axes_size(axes), mesh.rank_in(axes)
    mlp_loss(model(_shard(X, n, r)), _shard(Y, n, r)).backward()
    return {k: _np(p.grad) for k, p in model.named_parameters()}


def _state_np(tr):
    """The trainer's logical parameters (gathered) and this rank's pieces."""
    tr.sync_to_model()
    params = {n: _np(p) for n, p in tr.params.items()}
    slots = {k: {s: _np(v) for s, v in d.items()}
             for k, d in tr.opt_state["slots"].items()}
    return params, slots


def run_mlp(case, plan, mesh):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import set_axis_links
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import integrity
    model = mlp_model()
    model.set_state_dict_from_numpy(plan["mlp_weights"])
    if case.get("links"):
        set_axis_links(case["links"], mesh=mesh)
    scaler = (amp.GradScaler(init_loss_scaling=case["scale"])
              if case.get("scale") else None)
    opt = _recording(AdamW)(MLP_LR, grad_clip=_clip(case.get("clip")))
    tr = ParallelTrainer(model, opt, mlp_loss, mesh=mesh,
                         zero_stage=case["stage"],
                         accumulate_steps=case["k"],
                         grad_sync=case["policy"],
                         grad_sync_block=case.get("block"),
                         grad_sync_buckets=case.get("buckets", 1),
                         grad_sync_dcn_only=case.get("dcn_only"),
                         integrity_check_every=case.get("check", 0),
                         scaler=scaler, device="cpu")
    if case.get("links"):
        set_axis_links({}, mesh=mesh)
    full = {n: int(np.prod(tr._full_shape(n))) for n in tr.params}
    storage = {n: tr.state["params"][n].numel() for n in tr.params}
    resident = {n: p.numel() for n, p in tr.params.items()}
    X, Y = plan["mlp_batch"]
    losses, divergence = [], []
    flip = None
    for i in range(case["steps"]):
        if case.get("flip_at") == i:
            flip = integrity.inject_param_flip(tr, seed=3, step=i,
                                               leaf=case["flip_leaf"])
        losses.append(float(tr.train_step(X, Y)))
        divergence.append(tr.consume_divergence())
    params, slots = _state_np(tr)
    return {"losses": losses, "params": params, "slots": slots,
            "comm_err": {n: _np(v) for n, v in tr.comm_err.items()},
            "zero2_dims": dict(tr.zero2_dims),
            "zero3_dims": dict(tr.zero3_dims),
            "slot_dims": {k: dict(v) for k, v in tr.slot_dims.items()},
            "update_dims": dict(tr._update_dims),
            "first_grads": opt.first,
            "full": full, "storage": storage, "resident": resident,
            "divergence": divergence,
            "flip": flip, "skipped": tr.skipped_steps(),
            "buckets": tr.grad_sync_bucket_keys,
            "loss_scale": tr.loss_scale(),
            "entries": list(tr._integrity_entries)}


def run_gpt(case, plan, mesh):
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import GPTForPretraining
    model = GPTForPretraining(**plan["gpt_cfg"])
    model.set_state_dict_from_numpy(plan["gpt_weights"])
    tr = ParallelTrainer(
        gpt_loss_layer(model, plan["gpt_chunk"]),
        AdamW(plan["gpt_lr"], weight_decay=0.01,
              apply_decay_param_fun=no_decay),
        lambda out, _l: out, mesh=mesh, zero_stage=case["stage"],
        grad_sync=case["policy"], device="cpu")
    batch = tuple(torch.from_numpy(a) for a in plan["gpt_batch"])
    losses = [float(tr.train_step(batch, 0.0))
              for _ in range(case["steps"])]
    params, _ = _state_np(tr)
    return {"losses": losses, "params": params,
            "comm_err": {n: _np(v) for n, v in tr.comm_err.items()},
            "zero3_dims": dict(tr.zero3_dims),
            "skipped": tr.skipped_steps()}


def run_rs(case, rank, mesh):
    from paddle_tpu_torch.distributed.compressed import (
        compressed_psum_scatter, psum_scatter)
    x = torch.from_numpy(case["x"][rank])
    if case["policy"] == "lossless":
        return _np(psum_scatter(x, "sharding", case["dim"], mesh=mesh)), None
    res = torch.from_numpy(case["res"][rank])
    out, new = compressed_psum_scatter(
        x, "sharding", case["dim"], policy=case["policy"],
        block=case["block"], residual=res, mesh=mesh)
    return _np(out), _np(new)


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    mesh = mesh_mod.build_mesh(plan["degrees"])
    out = {"rank": rank, "coord": dict(mesh.coord), "rs": {}, "mlp": {},
           "gpt": {}, "rows": local_rows(plan, mesh)}
    for name, case in plan["rs"].items():
        out["rs"][name] = run_rs(case, rank, mesh)
    for name, case in plan["mlp"].items():
        out["mlp"][name] = run_mlp(case, plan, mesh)
    for name, case in plan.get("gpt", {}).items():
        out["gpt"][name] = run_gpt(case, plan, mesh)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
