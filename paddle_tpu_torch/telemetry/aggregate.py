"""Per-host telemetry aggregation: rank-0 merge of Registry snapshots.

Port of ``paddle_tpu/telemetry/aggregate.py``.

Each host's ``Registry.to_dict()`` snapshot is merged into one dict with
a ``process_index`` label prepended to every series key, so per-host
series stay distinct after the merge — straggler skew (one slow host's
``step_time_seconds``) remains visible instead of being averaged away.

Two transports:

- ``gather_registries()`` — ``torch.distributed.all_gather_object`` of
  each rank's snapshot over the default group (where the reference
  allgathers over ``jax.experimental.multihost_utils``), merged on rank 0
  (other ranks get None). A single process merges locally.
- ``gather_via_coordinator(coordinator, hosts_fn)`` — the file-KV path:
  every participant contributes through ``coordinator.allgather`` (any
  object with that method, such as ``resilience.elastic.FileCoordinator``)
  and every participant receives the merge; the rank-0
  host (first in sorted order) is the conventional exporter.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

__all__ = ["with_process_index", "merge_process_dicts",
           "gather_registries", "gather_via_coordinator"]


def _tag_key(series_key: str, index: int) -> str:
    tag = f"process_index={index}"
    return f"{tag},{series_key}" if series_key else tag


def with_process_index(snapshot: dict, index: int) -> dict:
    """Relabel one ``Registry.to_dict()`` snapshot with its process."""
    out = {}
    for name, m in snapshot.items():
        out[name] = {"type": m.get("type"), "help": m.get("help"),
                     "series": {_tag_key(k, index): v
                                for k, v in m.get("series", {}).items()}}
    return out


def merge_process_dicts(snapshots: Dict[int, dict]) -> dict:
    """Merge ``{process_index: Registry.to_dict()}`` into one snapshot.
    Series never collide (each carries its process_index label); on a
    metric-kind mismatch across hosts the first host's type/help win."""
    merged: dict = {}
    for index in sorted(snapshots):
        tagged = with_process_index(snapshots[index], index)
        for name, m in tagged.items():
            if name not in merged:
                merged[name] = {"type": m["type"], "help": m["help"],
                                "series": {}}
            merged[name]["series"].update(m["series"])
    return merged


def gather_registries(registry=None) -> Optional[dict]:
    """Gather every process's registry snapshot and merge on rank 0
    (returns None elsewhere). Over ``torch.distributed``'s default group
    with ``all_gather_object``; a single process (no group, or a group of
    one) merges locally and opens no group. Over NCCL the current CUDA
    device must be this rank's before the call."""
    import torch.distributed as dist
    from . import get_registry
    reg = registry if registry is not None else get_registry()
    snapshot = reg.to_dict()
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return merge_process_dicts({0: snapshot})
    gathered: List[Optional[dict]] = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, snapshot)
    if dist.get_rank() != 0:
        return None
    return merge_process_dicts(dict(enumerate(gathered)))


def gather_via_coordinator(coordinator, hosts_fn: Callable[[], List[str]],
                           registry=None, timeout: float = 60.0) -> dict:
    """File-KV transport for the same merge: every participating host
    contributes its snapshot and receives the full merge; process indices
    are the ranks of the sorted participating host names."""
    from . import get_registry
    reg = registry if registry is not None else get_registry()
    gathered = coordinator.allgather("telemetry_agg", reg.to_dict(),
                                     hosts_fn, timeout=timeout)
    hosts = sorted(gathered)
    return merge_process_dicts({hosts.index(h): gathered[h] for h in hosts})
