"""One rank of ``test_torch_hapi_dp.py``: ``hapi.Model.train_batch`` under
a data mesh of every rank.

``spawn``ed with gloo on the CPU; imports torch and ``paddle_tpu_torch``
only. Reads the plan the test wrote (the MLP's weights, the global batch,
the step count), builds ``{"data": world size}``, feeds the whole global
batch to ``train_batch`` each step (the Model takes this rank's rows) and
pickles to ``<out_dir>/rank<r>.pkl`` the per-step losses, the accuracy
``update`` results and ``accumulate``, ``eval_batch``'s result after the
steps and the final weights.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def mlp(nn):
    return nn.Sequential(nn.Flatten(), nn.Linear(16, 32), nn.ReLU(),
                         nn.Linear(32, 4))


def run_steps(port, weights, x, y, steps, lr):
    """(losses, accuracy per step, accumulated accuracy, eval result,
    final weights) of ``steps`` ``train_batch`` calls on (x, y)."""
    net = mlp(port.nn)
    net.set_state_dict_from_numpy(weights)
    model = port.Model(net, device="cpu")
    metric = port.metric.Accuracy()
    model.prepare(port.optimizer.SGD(lr), port.nn.CrossEntropyLoss(),
                  metric)
    losses, accs = [], []
    for _ in range(steps):
        loss, acc = model.train_batch([x], [y])
        losses.append(loss)
        accs.append(acc)
    accumulated = metric.accumulate()
    ev = model.eval_batch([x], [y])
    final = {k: v.detach().numpy().copy() for k, v in
             net.state_dict(include_sublayers=True).items()}
    return losses, accs, accumulated, ev, final


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    import paddle_tpu_torch as port
    from paddle_tpu_torch.distributed import env, mesh
    env.init_parallel_env(device="cpu")
    rank, n = env.get_rank(), env.get_world_size()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    mesh.build_mesh({"data": n})
    out = dict(zip(("losses", "accs", "accumulated", "eval", "final"),
                   run_steps(port, plan["weights"], plan["x"], plan["y"],
                             plan["steps"], plan["lr"])))
    out["rank"], out["n"] = rank, n
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return np.asarray(out["losses"])
