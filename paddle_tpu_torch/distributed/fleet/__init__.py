"""The fleet API (reference ``fleet/base/fleet_base.py:72`` ``Fleet``,
``:139`` ``init``, ``:836`` ``distributed_model``; ``DistributedStrategy``
of ``fleet/base/distributed_strategy.py:105``).

Port of ``paddle_tpu/distributed/fleet/__init__.py``. ``init`` builds the
hybrid mesh (``data``/``pipe``/``sharding``/``sep``/``model``) from
``strategy.hybrid_configs`` over the default process group (``data`` is
the world size when every degree is 1) and the reference's topology
objects; ``distributed_model`` wraps the network by the live degrees
(``PipelineParallel``, ``TensorParallel``, ``ShardingParallel``, else
``DataParallel``);
``distributed_optimizer`` wraps the optimizer in
``HybridParallelOptimizer``. ``save``/``save_inference_model`` export
through ``jit.save`` and ``save_persistables(model=)`` pickles the
model's state through ``framework_io.save``.

The parameter-server lifecycle (``init_server``, ``run_server``,
``stop_server``, ``init_worker``, ``stop_worker``) drives ``distributed.ps``
from ``TRAINING_ROLE``, ``PADDLE_PSERVER_ENDPOINTS`` and
``PADDLE_PSERVER_ID``; ``save_persistables`` without a model (the static
scope) raises, naming item 21. ``utils``, ``fs`` and ``elastic`` are the
modules they were.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .. import env as _env
from ..mesh import (CommunicateTopology, HybridCommunicateGroup,
                    build_mesh)
from . import fs, utils  # noqa: F401
from .elastic import ElasticManager, ElasticStatus  # noqa: F401
from .fs import HDFSClient, LocalFS  # noqa: F401

__all__ = ["utils", "fs", "ElasticManager", "ElasticStatus", "LocalFS",
           "HDFSClient", "HybridConfig", "DistributedStrategy", "Fleet",
           "fleet", "init", "is_first_worker", "worker_index", "worker_num",
           "is_worker", "worker_endpoints", "server_num", "is_server",
           "barrier_worker", "init_server", "run_server", "stop_server",
           "init_worker", "stop_worker", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group", "save",
           "save_inference_model", "save_persistables"]


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


class DistributedStrategy:
    """reference: ``fleet/base/distributed_strategy.py:105``: a plain
    config, serializable through ``to_dict``."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_fp16": False, "use_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.find_unused_parameters = False
        # reference meta_optimizers/fp16_allreduce_optimizer.py: gradients
        # cross the wire as bf16
        self.fp16_allreduce = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1

    def to_dict(self):
        return dict(self.__dict__)


def _pserver_endpoints():
    return [e for e in os.environ.get("PADDLE_PSERVER_ENDPOINTS",
                                      "").split(",") if e.strip()]


def _waits(what: str, item: str):
    raise NotImplementedError(
        f"fleet.{what} is not ported yet; it waits in ROADMAP.md (Queue 1, "
        f"{item})")


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._topology: Optional[CommunicateTopology] = None
        self._user_defined_strategy = None

    # -- init --------------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Build the mesh of ``strategy.hybrid_configs`` over the default
        process group (every rank calls it) and the topology; with every
        degree 1, ``data`` is the world size."""
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        degrees = {
            "data": hc.get("dp_degree", 1),
            "pipe": hc.get("pp_degree", 1),
            "sharding": hc.get("sharding_degree", 1),
            "sep": hc.get("sep_degree", 1),
            "model": hc.get("mp_degree", 1),
        }
        total = 1
        for d in degrees.values():
            total *= int(d)
        world = _env.get_world_size()
        if total == 1 and world > 1:
            degrees["data"] = world   # default: data parallel over all
        mesh = build_mesh(degrees)
        names = ("data", "pipe", "sharding", "model")
        self._topology = CommunicateTopology(names,
                                             [degrees[a] for a in names])
        # the rank in the four-axis topology: this rank's mesh coordinates
        # without "sep"
        self._hcg = HybridCommunicateGroup(
            self._topology,
            global_rank=self._topology.get_rank(
                **{a: mesh.coord[a] for a in names}))
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    # -- info --------------------------------------------------------------
    def is_first_worker(self):
        return _env.get_rank() == 0

    def worker_index(self):
        return _env.get_rank()

    def worker_num(self):
        return _env.get_world_size()

    def is_worker(self):
        return True

    def worker_endpoints(self, to_string=False):
        eps = _env.ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return len(_pserver_endpoints())

    def is_server(self):
        return os.environ.get("TRAINING_ROLE", "").upper() == "PSERVER"

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    # -- the parameter-server lifecycle (reference fleet_base.py:533-632) --
    # the tier it drives is distributed/ps: native sparse tables behind the
    # csrc/ps TCP service, key-hash-routed clients
    def init_server(self, dim: int = None, optimizer: str = "adagrad",
                    port: int = None, **table_kwargs):
        """Start this rank's PS shard (reference ``init_server``). The
        listening port is this server's entry of
        ``PADDLE_PSERVER_ENDPOINTS`` (its index ``PADDLE_PSERVER_ID``, else
        ``PADDLE_TRAINER_ID``) unless given; none there: a free port.
        Returns the ``PsServer`` (its ``.table`` saves and loads)."""
        import threading
        from ..ps.service import PsServer
        if dim is None:
            raise ValueError("init_server needs the embedding dim "
                             "(the PS table schema)")
        if port is None:
            eps = _pserver_endpoints()
            idx = int(os.environ.get(
                "PADDLE_PSERVER_ID", os.environ.get("PADDLE_TRAINER_ID",
                                                    "0")))
            port = int(eps[idx].rsplit(":", 1)[1]) if idx < len(eps) else 0
        self._ps_server = PsServer(dim, optimizer, port=port, **table_kwargs)
        self._ps_stop = threading.Event()
        return self._ps_server

    def run_server(self):
        """Serve until :meth:`stop_server` (reference ``run_server``): the
        service's threads run in the background; this parks the caller,
        then stops the server."""
        if getattr(self, "_ps_server", None) is None:
            raise RuntimeError("call fleet.init_server(...) first")
        self._ps_stop.wait()
        self._ps_server.stop()

    def stop_server(self):
        """Release :meth:`run_server` (a no-op before ``init_server``)."""
        if getattr(self, "_ps_stop", None) is not None:
            self._ps_stop.set()

    def init_worker(self, async_mode: bool = False):
        """Connect this trainer to every PS shard of
        ``PADDLE_PSERVER_ENDPOINTS`` (reference ``init_worker``); returns the
        key-hash-routed ``DistributedSparseTable`` (``async_mode``: geo-style
        buffered pushes). Raises without endpoints."""
        from ..ps.service import DistributedSparseTable
        eps = _pserver_endpoints()
        if not eps:
            raise RuntimeError("PADDLE_PSERVER_ENDPOINTS is empty: no "
                               "parameter servers to connect to")
        self._ps_client = DistributedSparseTable(eps, async_mode=async_mode)
        return self._ps_client

    def stop_worker(self):
        """Flush and close the client (a no-op before ``init_worker``)."""
        if getattr(self, "_ps_client", None) is not None:
            self._ps_client.flush()
            self._ps_client.close()
            self._ps_client = None

    # -- model/optimizer wrapping -----------------------------------------
    def distributed_model(self, model):
        """reference: ``fleet_base.py:836``: dispatch on the degrees."""
        from ..meta_parallel import (PipelineParallel, ShardingParallel,
                                     TensorParallel)
        from ..parallel import DataParallel
        hcg = self._hcg
        if hcg is None:
            self.init()
            hcg = self._hcg
        if hcg.get_pipe_parallel_world_size() > 1:
            return PipelineParallel(model, hcg, self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, self._strategy)
        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        from ..meta_parallel.hybrid_optimizer import HybridParallelOptimizer
        if strategy is not None:
            self._user_defined_strategy = strategy
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       self._strategy or DistributedStrategy())

    # -- saving --------------------------------------------------------------
    def save(self, dirname, feed=(), fetch=(), model=None, input_spec=None,
             **configs):
        """reference ``fleet_base.py:654``: the persistables when no
        feed/fetch are given, else an inference artifact: ``jit.save`` of
        ``model`` traced at ``input_spec`` to ``<dirname>/model``."""
        if not feed and not fetch and input_spec is None:
            return self.save_persistables(dirname=dirname, model=model)
        if model is None:
            raise ValueError("fleet.save(inference) needs model= (a Layer) "
                             "and input_spec=[InputSpec...]")
        from ... import jit as _jit
        path = os.path.join(dirname, "model")
        _jit.save(model, path, input_spec=list(input_spec or ()))
        return path

    def save_inference_model(self, executor=None, dirname=None,
                             feeded_var_names=None, target_vars=None,
                             main_program=None, export_for_deployment=True,
                             model=None, input_spec=None):
        """reference ``fleet_base.py:697`` (a deprecated alias of save)."""
        if model is not None and not input_spec:
            raise ValueError(
                "fleet.save_inference_model needs input_spec=[InputSpec...] "
                "to trace the model (an empty spec would export a 0-input "
                "graph)")
        return self.save(dirname, feed=feeded_var_names or ("x",),
                         fetch=target_vars or ("out",), model=model,
                         input_spec=input_spec)

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None, model=None):
        """The model's state to ``<dirname>/model.pdparams`` (the
        reference's pickle); without a model (the static scope) it
        raises, naming item 21."""
        if dirname is None:
            raise ValueError("save_persistables needs dirname")
        if model is None:
            _waits("save_persistables of the static scope",
                   "item 21: static")
        from ... import framework_io
        os.makedirs(dirname, exist_ok=True)
        framework_io.save(model.state_dict(),
                          os.path.join(dirname, "model.pdparams"))
        return dirname


fleet = Fleet()

# the module-level API of `from paddle.distributed import fleet`
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
worker_endpoints = fleet.worker_endpoints
server_num = fleet.server_num
is_server = fleet.is_server
barrier_worker = fleet.barrier_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_server = fleet.stop_server
init_worker = fleet.init_worker
stop_worker = fleet.stop_worker
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
save = fleet.save
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
