"""``spawn(func, args, nprocs)``: one process per rank on this host.

Port of ``paddle_tpu/distributed/spawn.py`` over ``torch.multiprocessing``
(the "spawn" start method). Each child gets the environment that
``torchrun`` would give it, with the reference's names beside:
``RANK``/``PADDLE_TRAINER_ID``, ``WORLD_SIZE``/``PADDLE_TRAINERS_NUM``,
``LOCAL_RANK``/``PADDLE_RANK_IN_NODE``, ``LOCAL_WORLD_SIZE``, and
``MASTER_ADDR``/``MASTER_PORT`` (a free port of this host), then calls
``func(*args)``; ``env.init_parallel_env()`` inside ``func`` starts the
process group from them. ``func`` must be importable (a module-level
function). The elastic supervisor (``launch.py``) waits in ROADMAP.md.
"""
from __future__ import annotations

import os
import socket

import torch.multiprocessing as mp

__all__ = ["spawn", "free_port"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(func, rank, nprocs, args, env):
    os.environ.update(env)
    for names, value in ((("RANK", "PADDLE_TRAINER_ID"), rank),
                         (("WORLD_SIZE", "PADDLE_TRAINERS_NUM"), nprocs),
                         (("LOCAL_RANK", "PADDLE_RANK_IN_NODE"), rank),
                         (("LOCAL_WORLD_SIZE",), nprocs)):
        for name in names:
            os.environ[name] = str(value)
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, timeout=None,
          **options):
    """Start ``nprocs`` ranks of ``func(*args)``; with ``join`` wait for
    them (up to ``timeout`` seconds each; a rank still running then is
    killed) and raise RuntimeError when one fails. Returns the
    processes."""
    ctx = mp.get_context("spawn")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker, args=(func, rank, nprocs, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned ranks failed (rank, exit code): "
                               f"{bad}")
    return procs
