"""One rank of the port's schedule tests (``test_torch_schedule.py``).

``spawn``ed once a world (2 or 4 gloo ranks on the CPU); imports torch and
``paddle_tpu_torch`` only. Each rank traces its own programs on fake
tensors and pickles what it saw to ``<out>/rank<r>.pkl``:

- ``trainer``: the resilience tests' int8 MLP at ``{"data": n}`` with the
  integrity check: the schedule fingerprints of the plain and the check
  step, twice; ``count_fingerprint_collectives`` of each against the
  recorded ``all_reduce`` calls of one real check step (the existing
  recorder of ``torch_resilience_worker.py``); the trainer's state before
  and after the traces; the report of ``compile(analyze=True)`` with two
  buckets (overlap model, the exchange rule);
- ``divergence``: a step that issues one more ``all_reduce`` on rank 0:
  ``collective-order-divergence`` over the gathered per-rank schedules;
- ``planted``: counts of ``oversized-allgather``,
  ``compressed-collective-link-mismatch``, ``collective-unbound-axis``
  and ``program-family-schedule-drift`` on planted graphs;
- ``families``: LocalSGD's sync/no-sync family and the decode executors'
  family through ``verify_family``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from torch_resilience_worker import _Recorder, mlp_batches, mlp_trainer


def _state(tr):
    from paddle_tpu_torch.distributed._staging import state_leaves
    leaves, _ = state_leaves(tr.model, tr, tr._STATE_ATTRS)
    return [t.detach().clone().numpy() for t in leaves] + [tr._steps_run]


def trainer_case(mesh, rank):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.analysis import schedule
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.resilience import integrity
    rec = _Recorder()
    tr = mlp_trainer(mesh, check_every=2)
    (x, y), = mlp_batches(1)
    tr.train_step(x, y)                  # step 1: plain
    before = _state(tr)
    fps, counts = {}, {}
    for name, check in (("step", False), ("step-check", True)):
        g1 = tr.staged_graph(x, y, do_check=check)
        g2 = tr.staged_graph(x, y, do_check=check)
        fps[name] = (schedule.program_fingerprint(g1, mesh),
                     schedule.program_fingerprint(g2, mesh))
        counts[name] = integrity.count_fingerprint_collectives(g1)
    after = _state(tr)
    since = len(rec.calls)
    tr.train_step(x, y)                  # step 2: a check step
    recorded = rec.fingerprint(since)
    fam = schedule.verify_family(tr.program_family(x, y))
    # two buckets: the exchange issued inside the backward
    trb = ParallelTrainer(tr.model, optimizer.Momentum(0.05, momentum=0.9),
                          tr.loss_fn, mesh=mesh, grad_sync="int8",
                          grad_sync_block=8, grad_sync_buckets=2,
                          device="cpu")
    _, rep = trb.compile(x, y, analyze=True)
    return {"fps": fps, "counts": counts, "recorded": recorded,
            "same_state": all(np.array_equal(a, b) for a, b in
                              zip(before[:-1], after[:-1]))
            and before[-1] == after[-1],
            "family_ok": fam["ok"],
            "overlap": rep.cost.overlap, "use_buckets": trb._use_buckets,
            "findings": sorted(f.rule for f in rep.findings)}


def divergence_case(mesh, rank):
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import schedule
    group = mesh.group_of("data")

    def step(t):
        dist.all_reduce(t, group=group)
        if rank == 0:
            dist.all_reduce(t, group=group)
        return t * 2
    g = analysis.trace_program(step, torch.ones(8))
    peers = schedule.peer_schedules(g, mesh)
    rep = analysis.analyze_graph(g, mesh=mesh, peer_schedules=peers,
                                 rank=rank)
    def agree(t):
        dist.all_reduce(t, group=group)
        return t * 2
    same = analysis.trace_program(agree, torch.ones(8))
    peers2 = schedule.peer_schedules(same, mesh)
    rep2 = analysis.analyze_graph(same, mesh=mesh, peer_schedules=peers2,
                                  rank=rank)
    rule = "collective-order-divergence"
    return {"diverged": len(rep.by_rule(rule)),
            "agreed": len(rep2.by_rule(rule))}


def planted_case(mesh, rank, n):
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import schedule
    from paddle_tpu_torch.distributed.mesh import set_axis_links
    group = mesh.group_of("data")
    out = {}

    def gather(t):
        o = torch.empty((n,) + tuple(t.shape), dtype=t.dtype)
        dist.all_gather_into_tensor(o, t, group=group)
        return o
    cfg = analysis.AnalysisConfig(allgather_warn_bytes=1 << 20)
    g = analysis.trace_program(gather, torch.ones(512, 512))   # 1 MiB each
    out["oversized-allgather"] = len(analysis.analyze_graph(
        g, mesh=mesh, config=cfg).by_rule("oversized-allgather"))

    def int8_sum(t):
        dist.all_reduce(t, group=group)
        return t
    set_axis_links({"data": "ici"}, mesh=mesh)
    g = analysis.trace_program(int8_sum, torch.ones(64, dtype=torch.int8))
    out["compressed-collective-link-mismatch"] = len(analysis.analyze_graph(
        g, mesh=mesh).by_rule("compressed-collective-link-mismatch"))
    stray = dist.new_group(list(range(n)))      # every rank calls it

    def unbound(t):
        dist.all_reduce(t, group=stray)
        return t
    g = analysis.trace_program(unbound, torch.ones(8))
    out["collective-unbound-axis"] = len(analysis.analyze_graph(
        g, mesh=mesh).by_rule("collective-unbound-axis"))
    fam = schedule.ProgramFamily(
        name=f"drift-{rank}", selector="a host flag that may differ",
        rank_invariant=False, mesh=mesh,
        members={"a": lambda: analysis.trace_program(int8_sum,
                                                     torch.ones(8)),
                 "b": lambda: analysis.trace_program(lambda t: t * 2,
                                                     torch.ones(8))})
    res = schedule.verify_family(fam)
    out["program-family-schedule-drift"] = sum(
        1 for m in res["members"].values() for f in m["findings"]
        if f["rule"] == "program-family-schedule-drift")
    out["drift_ok"] = res["ok"]
    return out


def families_case(mesh, rank):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.analysis import schedule
    from paddle_tpu_torch.distributed.meta_parallel import LocalSGDTrainer
    from paddle_tpu_torch.inference import decode_model
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    torch.manual_seed(0)
    tr = LocalSGDTrainer(nn.Linear(8, 4), optimizer.SGD(0.1),
                         lambda o, y: ((o - y) ** 2).mean(), mesh=mesh,
                         k_steps=2, param_sync="int8", device="cpu")
    x = torch.zeros(8, 8)
    lsgd = schedule.verify_family(tr.program_family(x, x[:, :4]))
    params = decode_model.init_decode_model(vocab=64, num_heads=2,
                                            head_dim=32, max_len=128)
    cache = PagedKVCache(num_pages=16, page_size=16, num_heads=2,
                         head_dim=32, device="cpu")
    step = decode_model.make_step_fn(params, cache, device="cpu")
    dec = schedule.verify_family(decode_model.executor_family(
        step, decode_model.executor_args(cache, rows=2, tokens=4)))
    n_coll = {m: v["num_collectives"] for m, v in lsgd["members"].items()}
    return {"localsgd_ok": lsgd["ok"], "localsgd_fps": lsgd["fingerprints"],
            "localsgd_collectives": n_coll, "decode_ok": dec["ok"],
            "decode_members": sorted(dec["members"])}


def main(out_dir: str, n: int):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    mesh = mesh_mod.build_mesh({"data": n})
    out = {"rank": rank, "trainer": trainer_case(mesh, rank),
           "divergence": divergence_case(mesh, rank),
           "planted": planted_case(mesh, rank, n),
           "families": families_case(mesh, rank)}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
