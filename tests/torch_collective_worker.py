"""One rank of ``test_torch_small_modules.py``'s collective case: a gloo
world on the CPU, ``spawn``ed by the test, importing torch and
``paddle_tpu_torch`` only.

Reads the plan the test wrote and pickles to ``<out>/rank<r>.pkl``:
``all_gather_concat`` of this rank's rows, the ranks of each group
``split_group`` made of the default group, and ``collective.split``'s
output for each of its cases (an embedding over the vocab and a linear
split by rows and by columns) on the mesh ``{"model": world}``, the
weights given whole through ``Assign``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import collective, env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.nn.initializer import Assign
    env.init_parallel_env(device="cpu")
    rank, world = env.get_rank(), env.get_world_size()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = {"rank": rank}
    x = torch.from_numpy(plan["rows"][rank])
    out["concat"] = collective.all_gather_concat(x, axis=0).numpy()
    out["concat_axis1"] = collective.all_gather_concat(x, axis=1).numpy()
    groups = collective.split_group(collective.get_group(0),
                                    plan["split_sizes"])
    out["groups"] = [g.ranks for g in groups]
    mesh_mod.build_mesh({"model": world})
    out["split"] = {}
    for name, case in plan["split"].items():
        torch.manual_seed(0)
        y = collective.split(
            torch.from_numpy(case["x"]), case["size"], case["operation"],
            axis=case["axis"], num_partitions=world,
            gather_out=case.get("gather_out", True),
            weight_attr=Assign(case["weight"]),
            bias_attr=False if case.get("no_bias") else None)
        out["split"][name] = y.detach().numpy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


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


def rows(seed, n, shape=(2, 3)):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]
