"""paddle_tpu_torch.distributed.ps — the sparse parameter-server tier.

Port of ``paddle_tpu/distributed/ps``. The native C++ core
(``csrc/ps/``: the sharded hash-table store with host optimizers, the
MultiSlot parser, the TCP service, the graph table) is built with g++ on
first use into ``paddle_tpu_torch/_build/`` (``native.py``). Above it:
the tables (``table``), the RPC servers and clients (``service``), the
Hogwild/Downpour trainer runtime (``trainer``), the in-memory dataset
(``datafeed``), the host-table embedding (``embedding``) and the hot tier
on the card (``heter``).
"""
from .datafeed import InMemoryDataset, QueueDataset  # noqa: F401
from .embedding import DistributedEmbedding, make_lookup  # noqa: F401
from .heter import HeterEmbedding  # noqa: F401
from .service import (DistributedGraphTable, DistributedSparseTable,  # noqa: F401
                      PsServer)
from .table import (DenseTable, GraphTable, SparseTable,  # noqa: F401
                    shard_keys)
from .trainer import (Communicator, DownpourWorker,  # noqa: F401
                      HogwildWorker, MultiTrainer, TrainerDesc,
                      TrainerFactory)
