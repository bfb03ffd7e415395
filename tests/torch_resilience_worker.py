"""Ranks and children of the port's multi-process resilience tests
(``test_torch_resilience_multiproc.py``). Imports torch and
``paddle_tpu_torch`` only.

- :func:`flip_world` (``spawn``ed, a gloo world of 2): the reference's
  MLP with ``integrity_check_every=2``; a ``param_flip`` on rank 1 after
  step 2 is caught at step 4's check; then a planned scale-down to one
  rank through ``reshard_trainer``.
- :func:`sdc_world` (a gloo world of 4): the SDC scenario of
  ``tools/chaos_smoke.py`` through ``run_resilient``, then the same run
  without the fault, for the end state.
- ``python torch_resilience_worker.py crash <dir> <mode>``: a child that
  trains with asynchronous saves and dies by a real SIGKILL in a commit
  window (``staged`` or ``mid_commit``).

Each rank pickles what it saw to ``<out>/<name>.rank<r>.pkl``; every
``torch.distributed`` group has a 60 s timeout, so a rank whose peer died
fails instead of waiting.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


class _Recorder:
    """Counts the fingerprint compare's collectives: ``all_reduce`` of an
    int64 tensor with MIN or MAX (the combined digest's SUM apart)."""

    def __init__(self):
        self.calls = []
        inner = dist.all_reduce

        def all_reduce(tensor, op=dist.ReduceOp.SUM, *a, **kw):
            self.calls.append((str(op), tensor.dtype))
            return inner(tensor, op, *a, **kw)

        dist.all_reduce = all_reduce

    def fingerprint(self, since=0):
        return sum(1 for op, dt in self.calls[since:]
                   if dt == torch.int64 and ("MIN" in op or "MAX" in op))

    def combined(self, since=0):
        return sum(1 for op, dt in self.calls[since:]
                   if dt == torch.int64 and "SUM" in op)


def _init(n):
    dist.init_process_group("gloo", init_method="env://", world_size=n,
                            rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    return dist.get_rank()


def _dump(out, name, rank, obj):
    with open(os.path.join(out, f"{name}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def mlp_batches(n=4, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 8).astype(np.float32),
             rng.randn(batch, 4).astype(np.float32)) for _ in range(n)]


def mlp_trainer(mesh, check_every):
    from paddle_tpu_torch import framework, nn, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    framework.seed(7)

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 16)
            self.l2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.l2(torch.relu(self.l1(x)))

    return ParallelTrainer(MLP(), optimizer.Momentum(0.05, momentum=0.9),
                           lambda out, y: torch.mean((out - y) ** 2),
                           mesh=mesh, grad_sync="int8", grad_sync_block=8,
                           integrity_check_every=check_every, device="cpu")


def flip_world(out):
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience import integrity
    from paddle_tpu_torch.resilience.elastic import reshard_trainer
    rank = _init(2)
    rec = _Recorder()
    tr = mlp_trainer(build_mesh({"data": 2}), check_every=2)
    batches = mlp_batches()
    seen = {"fp_collectives": [], "combined": [], "divergence": []}

    def step(i):
        n0 = len(rec.calls)
        tr.train_step(*batches[i % len(batches)])
        seen["fp_collectives"].append(rec.fingerprint(n0))
        seen["combined"].append(rec.combined(n0))
        seen["divergence"].append(tr.consume_divergence())

    step(0)
    step(1)
    seen["flip"] = integrity.inject_param_flip(tr, seed=11, step=2)
    step(2)
    step(3)
    seen["quarantine"] = integrity.quarantine_outliers(
        tr, leaves=seen["divergence"][3])
    seen["coords"] = integrity.replica_coords(tr.mesh, ("data",))
    # a planned scale-down to rank 0. Every rank's rows, for the record,
    # then reshard_trainer's own gather (a collective of both ranks), then
    # the group goes away
    from paddle_tpu_torch.resilience.elastic import gather_comm_err
    seen["gathered"] = gather_comm_err(tr)
    if rank == 1:
        gather_comm_err(tr)
        dist.destroy_process_group()
        _dump(out, "flip", rank, seen)
        return
    from paddle_tpu_torch import telemetry
    telemetry.enable(True)

    def new_mesh():
        dist.destroy_process_group()
        return build_mesh({"data": 1})

    reshard_trainer(tr, new_mesh, os.path.join(out, "reshard0"))
    seen["remapped"] = {k: v.numpy().copy() for k, v in tr.comm_err.items()}
    seen["dropped_norm"] = telemetry.get_registry().to_dict().get(
        "elastic_residual_dropped_norm_total", {}).get("series", {})
    seen["degree_after"] = tr.mesh.shape["data"]
    seen["loss_after"] = float(tr.train_step(*batches[0]))
    _dump(out, "flip", rank, seen)


class _LoggedTrainer:
    """Per-step fingerprint collective counts of a trainer."""

    def __init__(self, tr, rec):
        self.rows = []
        inner = tr.train_step

        def step(*a, **kw):
            n0 = len(rec.calls)
            loss = inner(*a, **kw)
            self.rows.append((tr._steps_run, rec.fingerprint(n0)))
            return loss

        tr.train_step = step


def gpt_trainer(mesh, check_every):
    from paddle_tpu_torch import framework, nn, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.text.models import GPTForPretraining
    framework.seed(0)
    model = GPTForPretraining(
        tensor_parallel=False, vocab_size=128, hidden_size=32, num_layers=1,
        num_heads=2, max_position_embeddings=16, attn_dropout=0.0,
        hidden_dropout=0.0)
    return ParallelTrainer(
        model, optimizer.AdamW(1e-3),
        lambda logits, lbl: nn.functional.cross_entropy(logits, lbl),
        mesh=mesh, grad_sync="int8", grad_sync_block=64,
        integrity_check_every=check_every, device="cpu")


def gpt_batches(n=4, batch=4, seq=16, vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (batch, seq)).astype(np.int64),
             rng.randint(0, vocab, (batch, seq)).astype(np.int64))
            for _ in range(n)]


def sdc_world(out, steps):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience import faults, integrity, run_resilient
    from paddle_tpu_torch.telemetry import flight
    rank = _init(4)
    rec = _Recorder()
    telemetry.enable(True)
    flight.configure(os.path.join(out, f"flight{rank}"))
    mesh = build_mesh({"data": 4})
    seen = {}
    for run in ("sdc", "clean"):
        tr = gpt_trainer(mesh, check_every=2)
        log = _LoggedTrainer(tr, rec)
        mgr = CheckpointManager(os.path.join(out, f"{run}{rank}"),
                                max_to_keep=steps + 2)
        with faults.inject("param_flip", at_step=5 if run == "sdc" else -1,
                           seed=11) as f:
            res = run_resilient(tr, gpt_batches(), steps, manager=mgr,
                                save_every=1, handle_signals=False)
        mgr.close()
        fps = integrity.fingerprint_tree(
            {"params": dict(tr.model.named_parameters()),
             "opt": tr.opt_state})
        seen[run] = {"result": res.__dict__, "fired": f.fired,
                     "steps": log.rows,
                     "fingerprints": {k: int(v) for k, v in fps.items()}}
    seen["divergence_total"] = telemetry.get_registry().to_dict().get(
        "replica_divergence_total", {}).get("series", {})
    seen["flight_divergence"] = len(flight.find_dumps(
        os.path.join(out, f"flight{rank}"), reason="divergence"))
    dist.destroy_process_group()
    _dump(out, "sdc", rank, seen)


def crash_child(ckpt_dir, mode, steps=3):
    """Train ``steps`` steps with asynchronous saves, flush, then stage one
    more snapshot and die by SIGKILL in the ``mode`` window. Never
    returns."""
    import signal
    import time

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.resilience import run_resilient
    tr = mlp_trainer(build_mesh({"data": 1}), check_every=0)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=steps + 2,
                            async_commit=True, deep_every=2)
    run_resilient(tr, mlp_batches(), steps, manager=mgr, save_every=1)
    mgr.flush()
    crash_step = int(mgr.latest_valid_step()) + 1
    state = {"trainer": tr.state,
             "meta": {"step": torch.tensor(crash_step)}}
    if mode == "staged":
        mgr.pause_commits()
        mgr.save(crash_step, state)
        os.kill(os.getpid(), signal.SIGKILL)
    os.environ["PADDLE_TPU_TORCH_TEST_COMMIT_CRASH"] = str(crash_step)
    mgr.save(crash_step, state)
    for _ in range(600):    # the committer kills this process
        time.sleep(0.1)
    os._exit(97)


if __name__ == "__main__":
    if sys.argv[1] == "crash":
        crash_child(sys.argv[2], sys.argv[3])
