"""Process and environment discovery over ``torch.distributed``.

Port of ``paddle_tpu/distributed/env.py``. The port runs one process per
card, the PyTorch idiom, where the reference has one controller for all
chips. A process learns its place from the environment that ``torchrun``
or :func:`~paddle_tpu_torch.distributed.spawn.spawn` sets:

- ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` and
  ``MASTER_ADDR`` / ``MASTER_PORT``;
- the reference's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
  ``PADDLE_RANK_IN_NODE`` as aliases.

Once a process group exists its rank and size win over the environment.
With neither there is one rank.

``init_parallel_env`` starts the process group. Its backend follows the
device: NCCL for the card, gloo for the CPU. An NCCL request without a
card raises; the port never falls back from NCCL to gloo on its own.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "get_local_rank",
           "get_local_world_size", "ParallelEnv", "init_parallel_env",
           "backend_for"]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if _initialized():
        return dist.get_rank()
    v = _env_int("RANK", "PADDLE_TRAINER_ID")
    return 0 if v is None else v


def get_world_size() -> int:
    if _initialized():
        return dist.get_world_size()
    v = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM")
    return 1 if v is None else v


def get_local_rank() -> int:
    v = _env_int("LOCAL_RANK", "PADDLE_RANK_IN_NODE")
    return get_rank() if v is None else v


def get_local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` when set, else every rank
    (one host)."""
    v = _env_int("LOCAL_WORLD_SIZE")
    return get_world_size() if v is None else v


class ParallelEnv:
    """The reference's ``ParallelEnv`` (fluid/dygraph/parallel.py)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return get_world_size()

    @property
    def current_endpoint(self):
        if "PADDLE_CURRENT_ENDPOINT" in os.environ:
            return os.environ["PADDLE_CURRENT_ENDPOINT"]
        return (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                f"{os.environ.get('MASTER_PORT', '6170')}")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def backend_for(device: Union[str, torch.device]) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_parallel_env(device: Optional[Union[str, torch.device]] = None,
                      init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None,
                      backend: Optional[str] = None) -> ParallelEnv:
    """Start the default process group (once) and return a
    :class:`ParallelEnv`.

    ``device=None`` means the card: this rank's card is ``LOCAL_RANK``'s
    and the backend NCCL; without a card that raises. ``device="cpu"``
    takes gloo. ``init_method`` defaults to ``env://`` when
    ``MASTER_ADDR`` is set, else to ``tcp://127.0.0.1:<MASTER_PORT or
    29500>``; ``world_size`` and ``rank`` default to the environment's.
    A process group that already exists is kept as it is, and its backend
    must be the one asked for.
    """
    from .._device import resolve_device
    if device is None and backend == "gloo":
        device = "cpu"
    if device is None and torch.cuda.is_available():
        device = f"cuda:{get_local_rank()}"
    dev = resolve_device(device)
    want = backend or backend_for(dev)
    if want == "nccl" and dev.type != "cuda":
        raise RuntimeError("init_parallel_env: NCCL needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if _initialized():
        have = dist.get_backend()
        if want not in have:
            raise RuntimeError(f"init_parallel_env: a {have} process group "
                               f"exists; {want} was asked for")
        return ParallelEnv()
    world = get_world_size() if world_size is None else int(world_size)
    me = get_rank() if rank is None else int(rank)
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            os.environ.setdefault("MASTER_PORT", "29500")
            init_method = "env://"
        else:
            init_method = (f"tcp://127.0.0.1:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
    dist.init_process_group(want, init_method=init_method, world_size=world,
                            rank=me)
    return ParallelEnv()
