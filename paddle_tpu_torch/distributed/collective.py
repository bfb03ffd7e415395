"""Collective communication over ``torch.distributed``.

Port of ``paddle_tpu/distributed/collective.py``. The reference maps a
group onto a named mesh axis and lowers each call to an XLA collective
inside a traced region; outside one (a world of one) every call is the
identity. The port runs one process per rank, so the calls are
``torch.distributed``'s, eager, over a process group:

- ``group=None`` is the default group; a :class:`Group` from
  :func:`new_group` wraps a subgroup;
- without a process group, or in a world of one rank, every call is the
  identity, the reference's single-card rule;
- tensors are reduced in place, as Paddle's API does, and also returned;
  every call completes before it returns (``sync_op`` is accepted for the
  API and not read).

``send``/``recv`` are point to point, Paddle's own meaning; the reference
turns them into ring shifts because SPMD code has no point-to-point.
``ReduceOp.AVG`` is a SUM followed by a division (gloo has no AVG).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "split_group",
           "all_reduce", "all_gather", "all_gather_concat", "reduce_scatter",
           "broadcast", "reduce", "scatter", "alltoall", "send", "recv",
           "barrier", "split", "wait"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
             ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A process group and its ranks (in the default group's numbering)."""

    def __init__(self, pg=None, ranks: Optional[List[int]] = None,
                 gid: int = 0):
        self.pg = pg
        self.ranks = ranks
        self.id = gid

    @property
    def nranks(self) -> int:
        if not dist.is_initialized():
            return 1
        return dist.get_world_size(self.pg)

    world_size = nranks

    @property
    def rank(self) -> int:
        if not dist.is_initialized():
            return 0
        return dist.get_rank(self.pg)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if self.ranks else rank

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


_groups = {0: Group(gid=0)}


def get_group(gid: int = 0) -> Group:
    return _groups[gid]


def new_group(ranks=None, backend=None) -> Group:
    """A subgroup of ``ranks`` (every rank when None); every rank of the
    default group must call it, as ``torch.distributed.new_group``."""
    gid = max(_groups) + 1
    pg = dist.new_group(ranks=list(ranks) if ranks else None,
                        backend=backend) if dist.is_initialized() else None
    _groups[gid] = Group(pg, list(ranks) if ranks else None, gid)
    return _groups[gid]


def split_group(origin_group, split_sizes):
    """Consecutive subgroups of ``origin_group``'s ranks, of the given
    sizes (every rank of the default group calls it, as ``new_group``)."""
    origin_group = origin_group or _groups[0]
    ranks = origin_group.ranks or list(range(origin_group.nranks))
    out, start = [], 0
    for size in split_sizes:
        out.append(new_group(ranks[start:start + size]))
        start += size
    return out


def _pg(group):
    """(process group, live): live is False for a world of one rank or no
    process group, where the calls are the identity."""
    pg = group.pg if isinstance(group, Group) else group
    if not dist.is_initialized():
        return pg, False
    return pg, dist.get_world_size(pg) > 1


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op=True):
    pg, live = _pg(group)
    if not live:
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OP[op], group=pg)
    if op == ReduceOp.AVG:
        tensor.div_(dist.get_world_size(pg))
    return tensor


def all_gather(tensor_list, tensor: torch.Tensor, group=None, sync_op=True,
               axis=0):
    """The gathered tensor, stacked along ``axis``; also appends each
    rank's tensor to ``tensor_list`` when a list is passed."""
    pg, live = _pg(group)
    if not live:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor)
                 for _ in range(dist.get_world_size(pg))]
        dist.all_gather(parts, tensor.contiguous(), group=pg)
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
    return torch.stack(parts, dim=axis)


def all_gather_concat(tensor: torch.Tensor, group=None, axis=0):
    """Every rank's tensor concatenated along ``axis`` (a tiled
    all-gather); the input itself outside a group of more than one rank,
    as the reference's outside a traced axis."""
    pg, live = _pg(group)
    if not live:
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, tensor.contiguous(), group=pg)
    return torch.cat(parts, dim=axis)


def reduce_scatter(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
                   axis=0):
    """This rank's slice, along ``axis``, of the reduction over ranks."""
    pg, live = _pg(group)
    if not live:
        return tensor
    n, me = dist.get_world_size(pg), dist.get_rank(pg)
    full = all_reduce(tensor.clone(), op=op, group=group)
    return torch.chunk(full, n, dim=axis)[me].contiguous()


def broadcast(tensor: torch.Tensor, src=0, group=None, sync_op=True):
    pg, live = _pg(group)
    if not live:
        return tensor
    dist.broadcast(tensor, src=src, group=pg)
    return tensor


def reduce(tensor: torch.Tensor, dst=0, op=ReduceOp.SUM, group=None,
           sync_op=True):
    """Every rank gets the reduction, as in the reference (dst included)."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor: torch.Tensor, tensor_list=None, src=0, group=None,
            sync_op=True):
    """This rank's entry of ``src``'s ``tensor_list`` (or of ``tensor``'s
    leading dim when no list is given), as a new tensor."""
    pg, live = _pg(group)
    if tensor_list is not None:
        stacked = torch.stack(list(tensor_list), 0)
    else:
        stacked = tensor
    if not live:
        return stacked[0] if tensor_list is not None else tensor
    me = dist.get_rank(pg)
    out = torch.empty_like(stacked[me])
    parts = list(stacked.unbind(0)) if me == src else None
    dist.scatter(out, parts, src=src, group=pg)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank r's i-th input lands as rank i's r-th output."""
    pg, live = _pg(group)
    ins = list(in_tensor_list)
    if not live:
        outs = ins
    else:
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, [t.contiguous() for t in ins], group=pg)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
    return outs


def send(tensor: torch.Tensor, dst=0, group=None, sync_op=True):
    pg, live = _pg(group)
    if live:
        dist.send(tensor.contiguous(), dst=dst, group=pg)
    return tensor


def recv(tensor: torch.Tensor, src=0, group=None, sync_op=True):
    pg, live = _pg(group)
    if live:
        dist.recv(tensor, src=src, group=pg)
    return tensor


def barrier(group=None):
    pg, live = _pg(group)
    if live:
        dist.barrier(group=pg)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Model-parallel op builder (reference collective.py:1283 split):
    build the weight-split layer for ``operation`` over the current
    mesh's ``model`` axis, on x's device, and apply it to x: "embedding"
    (``VocabParallelEmbedding``, the vocab split), "linear" with axis 0
    (``RowParallelLinear``, in_features split) or axis 1
    (``ColumnParallelLinear``, out_features split). ``num_partitions``
    must be 1 or the axis's degree. Call it once at build time, as the
    reference's static-graph usage: the layer's parameters are made
    here."""
    from .mesh import get_mesh
    from .meta_parallel.parallel_layers import mp_layers
    mesh = get_mesh()
    model_deg = mesh.shape.get("model", 1) if mesh is not None else 1
    if num_partitions not in (1, model_deg):
        raise ValueError(
            f"num_partitions={num_partitions} does not match the mesh "
            f"'model' degree {model_deg}")
    if operation == "embedding":
        if axis != 0:
            raise ValueError("parallel embedding only splits axis 0 (vocab)")
        layer = mp_layers.VocabParallelEmbedding(
            size[0], size[1], weight_attr=weight_attr, name=name)
    elif operation == "linear":
        if axis == 0:
            layer = mp_layers.RowParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False,
                input_is_parallel=False, name=name)
        elif axis == 1:
            layer = mp_layers.ColumnParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                has_bias=bias_attr is not False,
                gather_output=gather_out, name=name)
        else:
            raise ValueError(
                "linear split axis must be 0 (row) or 1 (column)")
    else:
        raise ValueError(f"unsupported operation {operation!r} "
                         "(expected 'linear' or 'embedding')")
    return layer.to(x.device)(x)


def wait(tensor, group=None, use_calc_stream=True):
    """Kept for the API: torch.distributed orders its own streams."""
    return tensor
