"""One rank of the port's tests of a world's checkpoint
(``test_torch_sharded_checkpoint.py``).

``spawn``ed with gloo on the CPU; imports torch and ``paddle_tpu_torch``
only. Two scenarios, each a world spawned once:

- ``zero4``: four ranks, ``{"data": 2, "sharding": 2}``, the ZeRO MLP at
  stage 3 under int8. A ``CheckpointManager`` on one shared directory
  saves step 3 (the world's format, from the state alone); the run goes
  on two steps; a fresh trainer restores step 3 on the same layout and
  takes the same two steps. A save into a directory two ranks share and
  two others do not raises on every rank. Then ``reshard_trainer``
  carries a restored trainer onto ``{"sharding": 4}``, onto
  ``{"data": 4}`` and onto one process (ranks 1-3 leave).
- ``dp2``: two ranks, ``{"data": 2}``, int8 data parallelism:
  ``trainer.save_checkpoint``/``load_checkpoint`` of the world, a deep
  manager, a torn step and the asynchronous commit; then the ZeRO MLP at
  stage 3 on ``{"sharding": 2}`` through a ``CheckpointManager`` on one
  shared directory (the world's format), resumed, and on a directory of
  each rank's own, which raises (only a world's directory places ZeRO
  slices).

Each rank pickles what it got to ``<out>/<scenario>.rank<r>.pkl``.
"""
from __future__ import annotations

import os
import pickle

import torch

from torch_dp_worker import _np
from torch_zero_worker import MLP_LR, mlp_loss, mlp_model


def trainer(mesh, weights, stage, policy, block=64, check=0):
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.optimizer import AdamW
    model = mlp_model()
    model.set_state_dict_from_numpy(weights)
    return ParallelTrainer(model, AdamW(MLP_LR), mlp_loss, mesh=mesh,
                           zero_stage=stage, grad_sync=policy,
                           grad_sync_block=block,
                           integrity_check_every=check, device="cpu")


def pieces(tr):
    """This rank's stored leaves and where each sits in its logical array."""
    st = tr.state
    flat = {}
    for part in ("params", "opt", "comm_err"):
        _flat(st[part], part, flat)
    return {"leaves": flat, "layout": {k: tuple(v) for k, v in
                                       st.layout.items()}}


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}.{k}", out)
    else:
        out[prefix] = _np(tree).copy()     # the live tensor changes later


def _steps(tr, batches):
    return [float(tr.train_step(x, y)) for x, y in batches]


def _final(tr):
    tr.sync_to_model()
    return {n: _np(p).copy() for n, p in tr.params.items()}


def zero4(plan, out_dir, rank):
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         load_checkpoint,
                                                         save_checkpoint)
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience.elastic import (gather_comm_err,
                                                     reshard_trainer)
    root = plan["dir"]
    mesh = build_mesh({"data": 2, "sharding": 2})
    w, b = plan["weights"], plan["batches"]

    def make():
        return trainer(mesh, w, 3, "int8")

    out = {}
    tr = make()
    out["first"] = _steps(tr, b[:3])
    mgr = CheckpointManager(os.path.join(root, "ckpt"))
    assert mgr.save(3, {"trainer": tr.state})
    try:
        save_checkpoint(os.path.join(root, f"mixed{rank // 2}"),
                        {"trainer": tr.state})
        out["mixed_raised"] = False
    except ValueError:
        out["mixed_raised"] = True
    out["saved"] = pieces(tr)
    out["cont"] = _steps(tr, b[3:])
    out["cont_params"] = _final(tr)
    if rank == 0:
        out["logical"] = {k: {p: _np(t) for p, t in v.items()}
                          for k, v in load_checkpoint(
                              os.path.join(root, "ckpt", "3")).items()}
        out["files"] = sorted(os.listdir(os.path.join(root, "ckpt", "3")))

    def restored():
        t = make()
        got = mgr.restore(template={"trainer": t.state})
        t.state = got["trainer"]
        return t

    tr2 = restored()
    out["resumed"] = _steps(tr2, b[3:])
    out["resumed_params"] = _final(tr2)
    for name, degrees in (("sharding4", {"sharding": 4}),
                          ("data4", {"data": 4})):
        t = restored()
        out[name + "_rows"] = gather_comm_err(t)
        reshard_trainer(t, lambda d=degrees: build_mesh(d),
                        os.path.join(root, "reshard-" + name))
        out[name] = pieces(t)
        out[name + "_coord"] = dict(t.mesh.coord)
        out[name + "_step"] = _steps(t, b[3:4])

    t = restored()
    out["one_rows"] = gather_comm_err(t)

    def leave():
        if rank != 0:
            return None
        dist.destroy_process_group()
        return build_mesh({"data": 1})

    if reshard_trainer(t, leave, os.path.join(root, "reshard-one")) is None:
        dist.destroy_process_group()
    else:
        out["one"] = pieces(t)
        out["one_step"] = _steps(t, b[3:4])
    return out


def dp2(plan, out_dir, rank):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience import faults
    root = plan["dir"]
    mesh = build_mesh({"data": 2})
    w, b = plan["weights"], plan["batches"]

    def make():
        return trainer(mesh, w, 0, "int8")

    out = {}
    tr = make()
    _steps(tr, b[:2])
    path = os.path.join(root, "world")
    tr.save_checkpoint(path)
    out["cont"] = _steps(tr, b[2:])
    out["cont_params"] = _final(tr)
    out["cont_rows"] = {k: _np(v).copy() for k, v in tr.comm_err.items()}
    tr2 = make()
    tr2.load_checkpoint(path)
    out["resumed"] = _steps(tr2, b[2:])
    out["resumed_params"] = _final(tr2)
    out["resumed_rows"] = {k: _np(v) for k, v in tr2.comm_err.items()}
    # a deep manager, then a torn step and the fallback past it
    tr = make()
    deep = CheckpointManager(os.path.join(root, "deep"), deep_every=1)
    for s in (1, 2):
        _steps(tr, b[s - 1:s])
        deep.save(s, {"trainer": tr.state})
    out["deep_verify"] = deep.verify(2, deep=True)
    out["step2"] = pieces(tr)
    _steps(tr, b[2:3])
    with faults.inject("ckpt_torn", at_step=3) as f:
        try:
            deep.save(3, {"trainer": tr.state})
            out["torn_raised"] = False
        except faults.SimulatedCrash:
            out["torn_raised"] = True
        out["torn_fired"] = f.fired
    again = CheckpointManager(os.path.join(root, "deep"))
    t = make()
    got = again.restore(template={"trainer": t.state})
    t.state = got["trainer"]
    out["fallback_step"] = again.last_restored_step
    out["fallbacks"] = again.restore_fallbacks_total
    out["restored2"] = pieces(t)
    # the asynchronous commit
    tr = make()
    am = CheckpointManager(os.path.join(root, "async"), async_commit=True)
    for s in (1, 2, 3):
        _steps(tr, b[s - 1:s])
        am.save(s, {"trainer": tr.state})
    out["async_live"] = pieces(tr)
    am.flush(timeout=60)
    out["async_steps"] = am.all_steps()
    t = make()
    got = am.restore(template={"trainer": t.state})
    t.state = got["trainer"]
    out["async_restored"] = pieces(t)
    out["async_accounted"] = am.accounted()
    am.close()
    out.update(zero2(plan, rank))
    return out


def zero2(plan, rank):
    """The ZeRO MLP at stage 3 on ``{"sharding": 2}``: a manager on one
    shared directory, resumed; one on a directory of each rank's own."""
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         is_sharded_dir)
    from paddle_tpu_torch.distributed.mesh import build_mesh
    mesh = build_mesh({"sharding": 2})
    w, b = plan["weights"], plan["batches"]
    tr = trainer(mesh, w, 3, "int8")
    _steps(tr, b[:2])
    root = os.path.join(plan["dir"], "zero2")
    mgr = CheckpointManager(root)
    assert mgr.save(2, {"trainer": tr.state})
    saved = pieces(tr)
    try:
        CheckpointManager(os.path.join(plan["dir"], f"zero2-own{rank}")
                          ).save(2, {"trainer": tr.state})
        own_raised = False
    except ValueError:
        own_raised = True
    cont = _steps(tr, b[2:])
    t = trainer(mesh, w, 3, "int8")
    t.state = mgr.restore(template={"trainer": t.state})["trainer"]
    return {"zero2": {"world_format": is_sharded_dir(os.path.join(root, "2")),
                      "saved": saved, "restored": pieces(t), "cont": cont,
                      "resumed": _steps(t, b[2:]), "own_raised": own_raised}}


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = {"zero4": zero4, "dp2": dp2}[plan["scenario"]](plan, out_dir,
                                                         rank)
    with open(os.path.join(out_dir, f"{plan['scenario']}.rank{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()
