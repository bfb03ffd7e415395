"""paddle_tpu_torch.distributed.fleet — ``utils`` (recompute and the fused
gradient all-reduce), ``fs`` (``LocalFS``, ``HDFSClient``) and ``elastic``
(``ElasticManager``, the file-backed membership)."""
from . import fs, utils  # noqa: F401
from .elastic import ElasticManager, ElasticStatus  # noqa: F401
from .fs import HDFSClient, LocalFS  # noqa: F401

__all__ = ["utils", "fs", "ElasticManager", "ElasticStatus", "LocalFS",
           "HDFSClient"]
