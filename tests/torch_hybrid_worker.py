"""One rank of the port's tensor, pipeline and context parallelism tests
(``test_torch_mp_layers.py``, ``test_torch_tensor_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_ring_attention.py``).

``spawn``ed once per world and file, gloo on the CPU; imports torch and
``paddle_tpu_torch`` only. Reads the plan the test wrote, runs each case
on the mesh the case names (every rank builds every mesh, in plan order)
and pickles what this rank got to ``<out>/rank<r>.pkl``, under the case's
kind and name:

- ``mp``: the Megatron layers at ``{"model": n}``: this rank's output, the
  input's gradient and its weights' gradients (pieces), and the same row
  layer on a plain all-reduce whose backward is another all-reduce (as
  ``torch.distributed.nn``'s);
- ``train``: a trainer (GPT, GPT's pipeline descs or the ZeRO tests' MLP)
  for a few steps: per-step losses, each parameter's piece with this
  rank's coordinates and its own split, the skipped steps, the pipeline's
  in-flight maximum, the integrity verdicts, and (``resume``) the losses
  and parameters of a fresh trainer restored from a checkpoint saved
  midway;
- ``ring``: ring attention of this rank's chunk of q/k/v, its output and
  the gradients of q/k/v, and the one-device block steps of the whole
  sequence.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from torch_dp_worker import _np, no_decay


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the Megatron layers ------------------------------------------------------

def run_mp(case, mesh):
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.mesh import local_piece
    kind = case["layer"]
    if kind == "column":
        layer = ColumnParallelLinear(*case["dims"],
                                     gather_output=case["gather"])
    elif kind == "row":
        layer = RowParallelLinear(*case["dims"],
                                  input_is_parallel=case["parallel_in"])
    elif kind == "embedding":
        layer = VocabParallelEmbedding(*case["dims"])
    else:
        layer = ParallelCrossEntropy()
    if case.get("weights"):
        layer.set_state_dict_from_numpy(case["weights"], mesh)
    x = _t(case["x"])
    if case.get("x_spec"):
        x = local_piece(x, case["x_spec"], mesh)
    if x.is_floating_point():
        x.requires_grad_(True)
    if kind == "ce":
        logits = local_piece(x.detach(), (None, "model"), mesh)
        logits.requires_grad_(True)
        out = layer(logits, _t(case["label"]))
        wrt = [logits]
    else:
        out = layer(x)
        wrt = ([x] if x.requires_grad else []) + list(layer.parameters())
    r = _t(case["r"])
    if case.get("out_spec"):
        r = local_piece(r, case["out_spec"], mesh)
    grads = torch.autograd.grad((out * r).sum(), wrt)
    got = {"out": _np(out), "grads": [_np(g) for g in grads]}
    if kind == "row" and layer.input_is_parallel:
        got["naive"] = _naive_row(layer, x.detach(), r, mesh)
    return got


class _AllReduce(torch.autograd.Function):
    """A plain all-reduce as autograd sees one: its transpose is another
    all-reduce (``torch.distributed.nn.functional.all_reduce``'s
    backward)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _naive_row(layer, x, r, mesh):
    """The row layer (its input split) on a plain all-reduce, whose
    backward all-reduces again: the gradient of the input and of the
    weight."""
    x = x.clone().requires_grad_(True)
    y = _AllReduce.apply(torch.matmul(x, layer.weight),
                         mesh.group_of("model"))
    if layer.bias is not None:
        y = y + layer.bias
    gx, gw = torch.autograd.grad((y * r).sum(), [x, layer.weight])
    return [_np(gx), _np(gw)]


# -- trainers -------------------------------------------------------------------

def _optimizer(case):
    from paddle_tpu_torch import optimizer as O
    clip = (O.ClipGradByGlobalNorm(case["clip"]) if case.get("clip")
            else None)
    name, lr = case["opt"], case["lr"]
    if name == "adamw":
        return O.AdamW(lr, weight_decay=0.01, apply_decay_param_fun=no_decay,
                       grad_clip=clip)
    if name == "sgd":
        return O.SGD(lr, grad_clip=clip)
    if name == "lamb":
        return O.Lamb(lr, lamb_weight_decay=0.01, grad_clip=clip)
    if name == "lars":
        return O.Lars(lr, momentum=0.9, lars_coeff=0.001,
                      lars_weight_decay=0.0005, grad_clip=clip)
    if name == "dgc":
        return O.DGCMomentum(lr, momentum=0.9, sparsity=(0.75,),
                             grad_clip=clip)
    raise ValueError(name)


class _Strategy:
    def __init__(self, m, schedule):
        self.pipeline_configs = {"accumulate_steps": m, "schedule": schedule}


def _pp_loss(logits, labels):
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    return ParallelCrossEntropy()(logits, labels).mean()


def _mlp_loss(out, y):
    return torch.nn.functional.cross_entropy(out, y)


def build_trainer(case, plan, mesh_mod):
    """(trainer, pipeline or None) of a training case, on a fresh mesh,
    from the plan's numpy weights."""
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import (CommunicateTopology,
                                                   HybridCommunicateGroup)
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineLayer, PipelineParallel, TensorParallel)
    from paddle_tpu_torch.text.models import (GPTForPretraining,
                                              gpt_pipeline_descs)
    mesh = mesh_mod.build_mesh(case["degrees"])
    dims = [case["degrees"].get(a, 1) for a in ("data", "pipe", "sharding",
                                                "model")]
    topo = CommunicateTopology(("data", "pipe", "sharding", "model"), dims)
    hcg = HybridCommunicateGroup(topo, topo.get_rank(
        **{a: mesh.coord[a] for a in ("data", "pipe", "sharding", "model")}))
    weights = plan["weights"][case["weights"]]
    pp = None
    if case["model"] == "gpt":
        model = GPTForPretraining(tensor_parallel=case["tp"],
                                  **plan["gpt_cfg"])
        model.set_state_dict_from_numpy(weights, mesh)
        net = TensorParallel(model, hcg) if case["tp"] else model
        loss_fn = model.loss
    elif case["model"] == "pipe":
        descs = gpt_pipeline_descs(tensor_parallel=case["tp"],
                                   tie_embeddings=case["tie"],
                                   **plan["pp_cfg"])
        pl = PipelineLayer(descs, num_stages=case["stages"],
                           seg_method="layer:GPTBlock")
        pl.set_state_dict_from_numpy(weights, mesh)
        pp = PipelineParallel(pl, hcg, _Strategy(case["m"],
                                                 case["schedule"]))
        net, loss_fn = pp, _pp_loss
    else:
        from torch_zero_worker import mlp_model
        net = mlp_model()
        net.set_state_dict_from_numpy(weights)
        loss_fn = _mlp_loss
    tr = ParallelTrainer(net, _optimizer(case), loss_fn, mesh=mesh,
                         micro_batches=case.get("m", 1),
                         zero_stage=case.get("stage", 0),
                         integrity_check_every=case.get("check", 0),
                         device="cpu")
    return tr, pp


def _pieces(tr):
    """Each parameter's stored values on this rank, with the ZeRO-3
    slices gathered, and its own split."""
    tr.sync_to_model()
    # copies: the trainer updates its parameters in place
    return {k: (_np(p).copy(), tuple(tr.own_splits[k]))
            for k, p in tr.params.items()}


def _steps(tr, plan, case, n):
    batch = plan["batches"][case["batch"]]
    return [float(tr.train_step(*batch)) for _ in range(n)]


def run_train(case, plan, mesh_mod, out_dir, name):
    tr, pp = build_trainer(case, plan, mesh_mod)
    mesh = tr.mesh
    got = {"coord": dict(mesh.coord)}
    batch = plan["batches"][case["batch"]]
    losses, divergence = [], []
    for i in range(case["steps"]):
        # a NaN gradient planted on one pipeline stage only
        nan = (case.get("nan_at") == i
               and mesh.coord["pipe"] == case.get("nan_stage", 0))
        losses.append(float(tr.train_step(
            *batch, grad_taint=float("nan") if nan else None)))
        divergence.append(tr.consume_divergence())
    got.update(losses=losses, params=_pieces(tr), skipped=tr.skipped_steps(),
               divergence=divergence,
               entries=[e for e, _ in tr._integrity_entries],
               in_flight=None if pp is None else pp.max_in_flight)
    if case.get("resume"):
        path = os.path.join(out_dir, f"ckpt-{name}")
        tr.save_checkpoint(path)
        after = _steps(tr, plan, case, case["resume"])
        fresh, _ = build_trainer(case, plan, mesh_mod)
        fresh.load_checkpoint(path)
        again = _steps(fresh, plan, case, case["resume"])
        got.update(after=after, again=again, after_params=_pieces(tr),
                   again_params=_pieces(fresh))
        if case.get("reshard"):
            other = dict(case, degrees=case["reshard"], tp=False)
            moved, _ = build_trainer(other, plan, mesh_mod)
            moved.load_checkpoint(path)
            got.update(resharded=_pieces(moved),
                       resharded_coord=dict(moved.mesh.coord))
    return got


# -- ring attention -----------------------------------------------------------

def run_ring(case, mesh_mod):
    from paddle_tpu_torch.ops.ring_attention import (ring_attention_local,
                                                     ring_flash_attention)
    mesh = mesh_mod.build_mesh(case["degrees"])
    n, i = mesh.shape["sep"], mesh.coord["sep"]
    q, k, v, do = (_t(case[x]) for x in ("q", "k", "v", "do"))
    loc = [t.chunk(n, dim=1)[i].clone().requires_grad_(True)
           for t in (q, k, v)]
    out = ring_flash_attention(*loc, causal=case["causal"])
    grads = torch.autograd.grad(out, loc,
                                grad_outputs=do.chunk(n, dim=1)[i])
    full_out, _, full_grads = ring_attention_local(q, k, v, n,
                                                   causal=case["causal"],
                                                   do=do)
    return {"out": _np(out), "grads": [_np(g) for g in grads],
            "local_out": _np(full_out.chunk(n, dim=1)[i]),
            "local_grads": [_np(g.chunk(n, dim=1)[i]) for g in full_grads]}


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = {"rank": rank, "mp": {}, "train": {}, "ring": {}}
    for name, case in plan.get("mp", {}).items():
        mesh = mesh_mod.build_mesh({"model": case["n"]})
        out["mp"][name] = run_mp(case, mesh)
    for name, case in plan.get("train", {}).items():
        out["train"][name] = run_train(case, plan, mesh_mod, out_dir, name)
    for name, case in plan.get("ring", {}).items():
        out["ring"][name] = run_ring(case, mesh_mod)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


# -- the test side ----------------------------------------------------------------

def spawn_plan(plan, n, tmp_path_factory, tag, timeout=300):
    """Write ``plan``, spawn ``n`` ranks of :func:`main` over it, and read
    back every rank's pickle (in rank order)."""
    from paddle_tpu_torch.distributed.spawn import spawn
    d = tmp_path_factory.mktemp(tag)
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(main, args=(str(d / "plan.pkl"), str(d)), nprocs=n,
          timeout=timeout)
    ranks = []
    for r in range(n):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def assemble(ranks, case, key, field="params", coord="coord"):
    """Parameter ``key`` of training case ``case`` put together from every
    rank's piece (its own split over pipe/model, at its coordinates); the
    ranks that hold equal copies must agree bit for bit."""
    pieces = [(r["train"][case][coord], r["train"][case][field][key])
              for r in ranks]
    _, (a0, splits) = pieces[0]
    shape = list(a0.shape)
    for ax, d in splits:
        shape[d] *= max(c[ax] for c, _ in pieces) + 1
    out = np.full(shape, np.nan, dtype=a0.dtype)
    for coord, (a, sp) in pieces:
        idx = [slice(None)] * len(shape)
        for ax, d in sp:
            n = a.shape[d]
            idx[d] = slice(coord[ax] * n, (coord[ax] + 1) * n)
        prev = out[tuple(idx)]
        if not np.isnan(prev).all():
            np.testing.assert_array_equal(prev, a, err_msg=f"{case} {key}: "
                                          "copies of one piece differ")
        out[tuple(idx)] = a
    return out
