"""paddle_tpu_torch.io (port of ``paddle_tpu/io``; reference
python/paddle/io/__init__.py): datasets, samplers and the DataLoader."""
from .dataloader import (DataLoader, WorkerInfo,  # noqa: F401
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, IterableDataset, Subset,
                      TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn",
           "get_worker_info", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "Dataset", "IterableDataset", "Subset",
           "TensorDataset", "random_split", "BatchSampler",
           "DistributedBatchSampler", "RandomSampler", "Sampler",
           "SequenceSampler", "WeightedRandomSampler"]
