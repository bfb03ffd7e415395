"""Rank body of ``test_torch_to_static_grad.py``'s gloo world: the ring
(``ring_flash_attention`` over ``sep``) and the sharded lookup
(``alltoall_lookup`` over ``data``) each staged by ``jit.to_static`` and
differentiated through the staged graph, beside the same calls run
eagerly. Each rank pickles its outputs, gradients and the staged graph's
op names to ``<out_dir>/rank<r>.pkl``."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

B, S, H, D = 1, 64, 2, 32
ROWS, DIM, IDS, CAP = 16, 4, 8, 2


def ring_data():
    rs = np.random.RandomState(5)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def lookup_data(n):
    rs = np.random.RandomState(6)
    rows = rs.randn(ROWS, DIM).astype(np.float32)
    ids = rs.randint(0, ROWS, n * IDS)
    ids[::5] = 3            # a crowded row overflows CAP
    ids[1::7] = -1          # padding
    return rows, ids, rs.randn(n * IDS, DIM).astype(np.float32)


def ring_loss(q, k, v, do):
    from paddle_tpu_torch.ops.ring_attention import ring_flash_attention
    return (ring_flash_attention(q, k, v, causal=True) * do).sum()


def lookup_loss(rows, ids, coef):
    from paddle_tpu_torch.ops.sharded_embedding import alltoall_lookup
    return (alltoall_lookup(rows, ids, "data", CAP, ROWS // 2)
            * coef).sum()


def _ops(fn, *args):
    return [str(n.target) for n in fn.graph(*args).graph.nodes
            if "paddle_tpu_torch" in str(n.target)]


def _both(fn, args, wrt):
    """(eager loss, grads), (staged loss, grads), the staged op names."""
    import paddle_tpu_torch as port
    out = []
    staged = port.jit.to_static(fn)
    for call in (fn, staged):
        loss = call(*args)
        out.append((loss.item(), [g.numpy() for g in
                                  torch.autograd.grad(loss, wrt)]))
    return out[0], out[1], _ops(staged, *args)


def main(out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank, n = env.get_rank(), env.get_world_size()
    res = {}
    mesh_mod.build_mesh({"sep": n})
    q, k, v, do = (torch.from_numpy(a).chunk(n, dim=1)[rank].contiguous()
                   for a in ring_data())
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    res["ring"] = _both(ring_loss, (q, k, v, do), (q, k, v))
    mesh_mod.build_mesh({"data": n})
    rows, ids, coef = lookup_data(n)
    rps = ROWS // n
    local = torch.from_numpy(rows[rank * rps:(rank + 1) * rps]) \
        .requires_grad_()
    mine = slice(rank * IDS, (rank + 1) * IDS)
    res["lookup"] = _both(lookup_loss, (local, torch.from_numpy(ids[mine]),
                                        torch.from_numpy(coef[mine])),
                          (local,))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def world(n, tmp_path_factory, timeout=300):
    from paddle_tpu_torch.distributed.spawn import spawn
    d = tmp_path_factory.mktemp(f"staged{n}")
    spawn(main, args=(str(d),), nprocs=n, timeout=timeout)
    ranks = []
    for r in range(n):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks
