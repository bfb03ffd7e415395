"""One rank of the port's BERT tensor-parallel test (``test_torch_bert.py``).

``spawn``ed over a gloo world on the CPU; imports torch and
``paddle_tpu_torch`` only. Reads the plan the test wrote (the config, the
reference's weights, the batch, the steps), trains
``BertForPretraining(tensor_parallel=True)`` on ``{"model": n}`` with
AdamW through ``ParallelTrainer`` and pickles, under ``train/bert``, the
losses and each parameter's piece with this rank's coordinates and its
own split (``torch_hybrid_worker.assemble`` puts them together) to
``<out>/rank<r>.pkl``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.text.models import BertForPretraining
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    mesh = mesh_mod.build_mesh({"model": env.get_world_size()})
    model = BertForPretraining(tensor_parallel=True, **plan["cfg"])
    model.set_state_dict_from_numpy(plan["weights"], mesh)
    tr = ParallelTrainer(model, topt.AdamW(plan["lr"]),
                         lambda o, lb: model.loss(*o, *lb), mesh=mesh,
                         device="cpu")
    ids, mlm, nsp = (torch.from_numpy(a) for a in plan["batch"])
    losses = [float(tr.train_step(ids, (mlm, nsp)))
              for _ in range(plan["steps"])]
    params = {k: (p.detach().numpy().copy(), tuple(tr.own_splits[k]))
              for k, p in tr.params.items()}
    out = {"rank": rank, "train": {"bert": {
        "coord": dict(mesh.coord), "losses": losses, "params": params,
        "skipped": tr.skipped_steps()}}}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()
