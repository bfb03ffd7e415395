"""Rank body of ``test_torch_to_static_grad.py``'s gloo world: the ring
(``ring_flash_attention`` over ``sep``) and the sharded lookup
(``alltoall_lookup`` over ``data``) each staged by ``jit.to_static`` and
differentiated through the staged graph, beside the same calls run
eagerly; then an ``MoELayer`` and a Megatron stack
(``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``) at ``{"model": n}``, each trained ``TRAIN_STEPS``
SGD steps staged (``loss.backward()`` through the graph) and eagerly
from the same seed. Each rank pickles its outputs, gradients, losses,
parameters and the staged graphs' op names to
``<out_dir>/rank<r>.pkl``."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

B, S, H, D = 1, 64, 2, 32
ROWS, DIM, IDS, CAP = 16, 4, 8, 2
TRAIN_STEPS, TRAIN_LR = 2, 0.1
VOCAB, WIDTH, HIDDEN = 32, 16, 32


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


def moe_data():
    rs = np.random.RandomState(8)
    return (rs.randn(2, 8, WIDTH).astype(np.float32),
            rs.randn(2, 8, WIDTH).astype(np.float32))


def megatron_data():
    rs = np.random.RandomState(9)
    return (rs.randint(0, VOCAB, (2, 8)).astype(np.int64),
            rs.randn(2, 8, WIDTH).astype(np.float32))


def moe_layer(pd):
    """``MoELayer(16, 32, 4)`` of package ``pd`` from seed 0."""
    from importlib import import_module
    pd.seed(0)
    return import_module(pd.__name__ + ".incubate").MoELayer(WIDTH, HIDDEN,
                                                             4)


def megatron_stack(pd):
    """Embedding (split over the vocab), a column linear without the
    gather, GELU, a row linear on the parallel input: Megatron's MLP."""
    from importlib import import_module
    mp = import_module(pd.__name__ + ".distributed.meta_parallel."
                       "parallel_layers.mp_layers")

    class Stack(pd.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = mp.VocabParallelEmbedding(VOCAB, WIDTH)
            self.col = mp.ColumnParallelLinear(WIDTH, HIDDEN,
                                               gather_output=False)
            self.row = mp.RowParallelLinear(HIDDEN, WIDTH,
                                            input_is_parallel=True)

        def forward(self, ids):
            return self.row(pd.nn.functional.gelu(self.col(self.emb(ids))))

    pd.seed(0)
    return Stack()


def train_both(build, x, coef, steps=TRAIN_STEPS, lr=TRAIN_LR):
    """``steps`` SGD steps of ``sum(layer(x) * coef)`` on two layers from
    the same seed, one eager and one staged -> (eager losses, params),
    (staged losses, params), the staged graph's op names."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch.optimizer import SGD
    out = []
    for staged in (False, True):
        layer = build(port)
        call = port.jit.to_static(layer) if staged else layer
        opt = SGD(lr, parameters=layer.parameters())
        losses = []
        for _ in range(steps):
            opt.clear_grad()
            loss = (call(x) * coef).sum()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        out.append((losses, [p.detach().numpy().copy()
                             for p in layer.parameters()]))
    ops = [str(n.target) for n in call.graph(x).graph.nodes
           if "paddle_tpu_torch" in str(n.target)]
    return out[0], out[1], ops


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
    mesh_mod.build_mesh({"model": n})
    x, coef = (torch.from_numpy(a) for a in moe_data())
    res["moe"] = train_both(moe_layer, x, coef)
    ids, coef = (torch.from_numpy(a) for a in megatron_data())
    res["megatron"] = train_both(megatron_stack, ids, coef)
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
