"""One rank of ``test_torch_telemetry_export.py``'s gather test.

``spawn``ed with gloo on the CPU; imports torch and ``paddle_tpu_torch``
only. Fills a registry with this rank's series (:func:`fill`), gathers
every rank's with ``telemetry.aggregate.gather_registries`` and pickles
what this rank got to ``<out_dir>/rank<r>.pkl`` (None off rank 0).
"""
from __future__ import annotations

import os
import pickle


def fill(registry, rank: int):
    """The series rank ``rank`` records (the test rebuilds them)."""
    registry.counter("steps_total", "steps run").inc(3 + rank)
    registry.counter("retries_total", "retries").inc(rank, site="ckpt")
    registry.gauge("tokens_per_sec", "tokens/s").set(1000.0 * (rank + 1))
    h = registry.histogram("step_time_seconds", "step wall time",
                           buckets=(0.1, 1.0))
    for v in (0.05, 0.5 * (rank + 1)):
        h.observe(v)
    return registry


def main(out_dir: str):
    import torch
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.telemetry import Registry, aggregate
    torch.set_num_threads(1)
    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    merged = aggregate.gather_registries(fill(Registry(), rank))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(merged, f)
    torch.distributed.destroy_process_group()
