"""One parameter-server process of the port's PS tests
(``test_torch_ps_service.py``).

    python tests/torch_ps_worker.py <rendezvous dir> <dim>[,<dim>...]

Imports torch and ``paddle_tpu_torch`` only. Serves one Adagrad table
(seed 0, init range 0.01: ``DistributedEmbedding``'s defaults) per dim
through the fleet API: the first on its entry of
``PADDLE_PSERVER_ENDPOINTS`` (index ``PADDLE_PSERVER_ID``, with
``TRAINING_ROLE=PSERVER``), the others on free ports. Writes the
endpoints, one line a dim, to ``<dir>/ep.<id>``, serves through
``run_server`` until ``<dir>/stop`` appears, then ``stop_server``s every
one and writes ``<dir>/exit.<id>``.
"""
from __future__ import annotations

import os
import sys
import threading
import time


def main(rdv: str, dims):
    from paddle_tpu_torch.distributed import fleet
    sid = int(os.environ["PADDLE_PSERVER_ID"])
    served = []
    for i, dim in enumerate(dims):
        f = fleet.Fleet()
        assert f.is_server()
        srv = f.init_server(dim=dim, optimizer="adagrad",
                            port=None if i == 0 else 0, seed=0,
                            init_range=0.01)
        served.append((f, srv))
    tmp = os.path.join(rdv, f".ep.{sid}")
    with open(tmp, "w") as fh:
        fh.write("\n".join(srv.endpoint for _, srv in served))
    os.replace(tmp, os.path.join(rdv, f"ep.{sid}"))
    threads = [threading.Thread(target=f.run_server) for f, _ in served]
    for t in threads:
        t.start()
    deadline = time.time() + 240
    while not os.path.exists(os.path.join(rdv, "stop")):
        if time.time() > deadline:
            break
        time.sleep(0.02)
    for f, _ in served:
        f.stop_server()
    for t in threads:
        t.join(timeout=30)
    open(os.path.join(rdv, f"exit.{sid}"), "w").close()




# -- the hot tier (test_torch_heter_embedding.py) ------------------------------

def pooled_model(emb):
    """A linear head over the first id's row: one logit a row."""
    from paddle_tpu_torch import nn

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = emb
            self.head = nn.Linear(emb.dim, 1)

        def forward(self, ids):
            return self.head(self.emb(ids))[..., 0, 0]
    return M()


def mse(o, y):
    return (o - y).square().mean()


def heter_path(ids_seq, y_seq, dim, lr, optimizer, capacity, weights,
               shard_axis=None, overlapped=False):
    """(losses, the HeterEmbedding) of the port's trainer over the hot tier
    (``prepare`` before each step, or ``prepare_async`` one batch ahead),
    from ``weights`` (the head's)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.ps import HeterEmbedding
    emb = HeterEmbedding(dim, capacity=capacity, optimizer=optimizer,
                         init_range=0.0, shard_axis=shard_axis)
    m = pooled_model(emb)
    m.head.set_state_dict_from_numpy(weights)
    opt = (topt.SGD(lr) if optimizer == "sgd"
           else topt.Adagrad(lr, epsilon=1e-8))
    tr = ParallelTrainer(m, opt, mse, device="cpu")
    losses = []
    fut = emb.prepare_async(ids_seq[0]) if overlapped else None
    for i, (ids, y) in enumerate(zip(ids_seq, y_seq)):
        slots = fut.result() if overlapped else emb.prepare(ids)
        losses.append(tr.train_step(torch.from_numpy(slots),
                                    torch.from_numpy(y)))
        if overlapped and i + 1 < len(ids_seq):
            fut = emb.prepare_async(ids_seq[i + 1])
    return [float(x) for x in losses], emb


# -- the sharded hot tier over a gloo world ------------------------------------

def heter_rank(plan_path: str, out_dir: str):
    """One rank of the sharded hot tier: ``heter_path`` of the plan at
    ``{"model": n}`` with ``shard_axis="model"``; pickles the losses, the
    tier's stats and the table's rows to ``<out>/rank<r>.pkl``."""
    import pickle

    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    mesh_mod.build_mesh({"model": env.get_world_size()})
    losses, emb = heter_path(*plan["args"], shard_axis="model")
    emb.flush_all()
    out = {"losses": losses, "stats": dict(emb.stats),
           "rows": emb.table.export_rows(np.arange(plan["vocab"]), False),
           "hot_shape": tuple(emb.hot.shape)}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], [int(d) for d in sys.argv[2].split(",")])
