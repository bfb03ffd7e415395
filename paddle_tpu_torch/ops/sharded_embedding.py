"""Sharded embedding lookup with an id exchange over ``all_to_all``.

Port of ``paddle_tpu/ops/sharded_embedding.py``. The table is row-sharded
over a mesh axis: rank r holds rows ``[r·rows_per_shard, (r+1)·
rows_per_shard)``. A lookup of this rank's global ids

1. buckets the ids by owner (a stable sort by owner, each id's position
   in its owner's group), ``bucket_cap`` a destination, padding ids
   (-1) in no bucket;
2. sends the id buckets to their owners (``all_to_all_single``), which
   gather their rows (a -1 slot reads a zero row) and send the rows back
   along the same lanes (a second ``all_to_all_single``); the rows land
   at the ids' own positions;
3. resolves the ids that overflowed their bucket as the reference does:
   every rank's overflow ids are all-gathered, each owner contributes its
   rows, and a reduce-scatter gives each rank the rows of its own ids
   (on gloo, which has no reduce-scatter, an all-reduce and this rank's
   chunk). The step always runs, as in the reference, so the result
   never depends on the cap, only the traffic does.

The backward is the transposed route (the autograd of the library op
``paddle_tpu_torch::alltoall_lookup``, which a staged graph keeps): the
cotangents of the bucketed ids go back over ``all_to_all`` and the owner
scatter-adds them into its rows; the overflow cotangents are all-gathered
and each owner scatter-adds the entries it owns. Padding ids get no
gradient. The forward is the dense gather bit for bit (each row is moved,
or summed with zeros only).

Every rank calls it with the same ``bucket_cap`` and ``rows_per_shard``
and its own ids; ``axis`` names the current mesh's axis the table is
sharded over (``"data"`` in the reference's tests).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..distributed.compressed import _Axis, _psum_scatter0
from ..distributed.mesh import Mesh, require_mesh

__all__ = ["alltoall_lookup"]


def _all_gather0(x, ax: _Axis):
    """(n, *x.shape): every rank's ``x``, stacked in rank order."""
    if ax.n == 1:
        return x.unsqueeze(0)
    return ax.all_gather_start(x.reshape(-1))().reshape((ax.n,) +
                                                        tuple(x.shape))


def _all_to_all0(x, ax: _Axis):
    """Row j of ``x`` goes to rank j; row j of the result came from it."""
    return x if ax.n == 1 else ax.all_to_all(x)


# the exchange groups an op call names by handle (an op takes no Python
# object): one _Axis per (mesh, axis), kept for the process's life
_AXES: Dict[int, _Axis] = {}
_AXIS_IDS: Dict[tuple, int] = {}


def _axis_handle(mesh: Mesh, axis) -> int:
    key = (id(mesh), axis)
    h = _AXIS_IDS.get(key)
    if h is None:
        h = _AXIS_IDS[key] = len(_AXES)
        _AXES[h] = _Axis(mesh, axis)
        _AXES[h].mesh = mesh   # keeps id(mesh) from being reused
    return h


def _lookup_fwd(local_rows, ids, axis, cap, rps):
    """-> (rows, and the bookkeeping the backward routes by: home, ovf,
    o_mine, o_idx, local_idx, hit)."""
    ax = _AXES[axis]
    n, rank = ax.n, ax.rank
    n_ids, dim = ids.shape[0], local_rows.shape[-1]
    n_local = local_rows.shape[0]
    dev = ids.device
    valid = ids >= 0
    owner = torch.clamp(torch.where(valid, ids, 0) // rps, 0, n - 1)
    owner = torch.where(valid, owner, n)
    order = torch.argsort(owner, stable=True)
    owner_s, ids_s = owner[order], ids[order]
    start = torch.searchsorted(owner_s,
                               torch.arange(n + 1, device=dev))
    pos = torch.arange(n_ids, device=dev) - start[owner_s.clamp(0, n)]
    in_bucket = (pos < cap) & (owner_s < n)
    dst_r, dst_c = owner_s[in_bucket], pos[in_bucket]
    send_ids = torch.full((n, cap), -1, dtype=ids.dtype, device=dev)
    send_ids[dst_r, dst_c] = ids_s[in_bucket]
    home = torch.full((n, cap), n_ids, dtype=torch.long, device=dev)
    home[dst_r, dst_c] = order[in_bucket]

    recv_ids = _all_to_all0(send_ids, ax)
    lo = rank * rps
    local_idx = torch.clamp(recv_ids - lo, 0, n_local - 1).long()
    hit = recv_ids >= 0
    rows = torch.where(hit[..., None], local_rows[local_idx],
                       torch.zeros((), dtype=local_rows.dtype,
                                   device=dev))
    back = _all_to_all0(rows.contiguous(), ax)
    out = torch.zeros((n_ids + 1, dim), dtype=local_rows.dtype,
                      device=dev)
    out[home.reshape(-1)] = back.reshape(-1, dim)
    out = out[:n_ids]

    ovf = torch.zeros(n_ids, dtype=torch.bool, device=dev)
    ovf[order[~in_bucket]] = True
    ovf &= valid
    all_ovf = _all_gather0(torch.where(ovf, ids, -1), ax)     # (n, N)
    o_mine = (all_ovf >= lo) & (all_ovf < lo + rps)
    o_idx = torch.clamp(torch.where(o_mine, all_ovf, 0) - lo, 0,
                        n_local - 1).long()
    contrib = torch.where(o_mine[..., None], local_rows[o_idx],
                          torch.zeros((), dtype=local_rows.dtype,
                                      device=dev))            # (n, N, D)
    o_rows = (contrib[0] if ax.n == 1
              else _psum_scatter0(contrib.reshape(n * n_ids, dim), ax))
    out = torch.where(ovf[:, None], o_rows, out)

    return out, home, ovf, o_mine, o_idx, local_idx, hit


def _lookup_setup_context(ctx, inputs, output):
    local_rows, ids, axis, cap, rps = inputs
    ctx.axis, ctx.n_local = axis, local_rows.shape[0]
    ctx.save_for_backward(*output[1:])


def _lookup_backward(ctx, g, *_bookkeeping):
    home, ovf, o_mine, o_idx, local_idx, hit = ctx.saved_tensors
    ax = _AXES[ctx.axis]
    n_ids, dim = g.shape
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gpad = torch.cat([g, g.new_zeros((1, dim))], 0)
    send_g = gpad[home.clamp(0, n_ids)]                          # (n, cap, D)
    recv_g = _all_to_all0(send_g.contiguous(), ax)
    d_local = g.new_zeros((ctx.n_local, dim))
    d_local.index_add_(0, local_idx.reshape(-1),
                       torch.where(hit[..., None], recv_g,
                                   zero).reshape(-1, dim))
    all_g = _all_gather0(torch.where(ovf[:, None], g, zero), ax)
    d_local.index_add_(0, o_idx.reshape(-1),
                       torch.where(o_mine[..., None], all_g,
                                   zero).reshape(-1, dim))
    return d_local, None, None, None, None


# a library op with its autograd: a staged graph holds the lookup as one
# node (its collectives run when the node runs) and keeps its backward
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("alltoall_lookup(Tensor local_rows, Tensor ids, int axis, "
            "int cap, int rps) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
            "Tensor, Tensor)")
_LIB.impl("alltoall_lookup", _lookup_fwd, "CompositeExplicitAutograd")


@torch.library.register_fake("paddle_tpu_torch::alltoall_lookup", lib=_LIB)
def _(local_rows, ids, axis, cap, rps):
    n, n_ids = _AXES[axis].n, ids.shape[0]

    def like(shape, dtype):
        return ids.new_empty(shape, dtype=dtype)
    return (local_rows.new_empty((n_ids, local_rows.shape[-1])),
            like((n, cap), torch.long), like((n_ids,), torch.bool),
            like((n, n_ids), torch.bool), like((n, n_ids), torch.long),
            like((n, cap), torch.long), like((n, cap), torch.bool))


torch.library.register_autograd("paddle_tpu_torch::alltoall_lookup",
                                _lookup_backward,
                                setup_context=_lookup_setup_context,
                                lib=_LIB)

#: ``torch.ops.paddle_tpu_torch.alltoall_lookup``
LOOKUP_OP = torch.ops.paddle_tpu_torch.alltoall_lookup


def alltoall_lookup(local_rows: torch.Tensor, ids: torch.Tensor, axis: str,
                    bucket_cap: int, rows_per_shard: int,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Rows ``table[ids]`` of a table row-sharded over ``axis``.

    local_rows: (rows_per_shard, dim), this rank's slice of the table.
    ids: (N,) this rank's global row ids (-1: padding, a zero row); every
    rank passes its own ids, the same N. Returns (N, dim). ``mesh``: the
    current one when None."""
    h = _axis_handle(mesh if mesh is not None else require_mesh(), axis)
    return LOOKUP_OP(local_rows, ids, h, int(bucket_cap),
                     int(rows_per_shard))[0]
