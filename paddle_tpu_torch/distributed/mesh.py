"""The device mesh of the port: named axes over ``torch.distributed``.

Port of ``paddle_tpu/distributed/mesh.py:55-260``. The reference builds one
``jax.sharding.Mesh`` whose named axes (``data``, ``pipe``, ``sharding``,
``sep``, ``model``) are the hybrid-parallel axes. The port runs one
process per card, so a :class:`Mesh` here is a thin object over process
groups that covers the world: each axis has a size, and an axis larger
than 1 has the process group its collectives run over.

Only ``data`` may be larger than 1 so far: the other axes (tensor, pipeline,
ZeRO sharding and context parallelism) wait in ROADMAP.md (Queue 1, items
14 and 15), and :func:`build_mesh` raises ``NotImplementedError`` for them.

A mesh of one rank needs no process group. A larger one needs the default
group started (``env.init_parallel_env``), or a group passed to
:func:`build_mesh`, whose size is the mesh's.

Axis link types keep the reference's names: ``"ici"`` for ranks on one
host (NVLink on an H100 box) and ``"dcn"`` for an axis that crosses hosts
(the network between them). ``infer_axis_links`` places rank ``r`` on host
``r // LOCAL_WORLD_SIZE`` (``torchrun`` and ``spawn`` set it; without it
every rank shares one host). ``set_axis_links`` overrides the inference,
as in the reference; the compressed exchange reads the map under
``grad_sync_dcn_only``. The reference's link bandwidths and latencies
(``link_bandwidth``/``link_latency``) price ``grad_sync_overlap_efficiency``
and wait with it (ROADMAP.md, Queue 1, item 16).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

from .env import get_local_world_size

__all__ = ["AXES_ORDER", "LINK_TYPES", "Mesh", "build_mesh", "set_mesh",
           "get_mesh", "require_mesh", "axis_size", "set_axis_links",
           "explicit_axis_links", "infer_axis_links", "axis_links",
           "axis_link"]

AXES_ORDER = ("data", "pipe", "sharding", "sep", "model")

LINK_TYPES = ("ici", "dcn")


class Mesh:
    """Axis sizes over the world's ranks, in :data:`AXES_ORDER`, and the
    process group of the one axis that may be larger than 1 (``data``).
    ``hosts`` is the host index of each data rank."""

    axis_names = AXES_ORDER

    def __init__(self, shape: Dict[str, int], group=None,
                 hosts: Optional[Sequence[int]] = None):
        self.shape = {ax: int(shape.get(ax, 1)) for ax in AXES_ORDER}
        self.group = group
        n = self.shape["data"]
        self.hosts = tuple(hosts) if hosts is not None else (0,) * n

    def axes_size(self, axes: Union[str, Sequence[str]]) -> int:
        out = 1
        for ax in _axis_tuple(axes):
            out *= self.shape[ax]
        return out

    def group_of(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` (None when they span one rank)."""
        if self.axes_size(axes) <= 1:
            return None
        return self.group if self.group is not None else dist.group.WORLD

    def rank_in(self, axes: Union[str, Sequence[str]]) -> int:
        group = self.group_of(axes)
        return 0 if group is None else dist.get_rank(group)

    def backend(self) -> Optional[str]:
        """The data group's backend ("nccl", "gloo"), or None without one."""
        group = self.group_of("data")
        return None if group is None else dist.get_backend(group)

    def _key(self) -> tuple:
        return (id(self.group), tuple(self.shape.values()), self.hosts)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _axis_tuple(axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


class _MeshState(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.links: Dict[tuple, Dict[str, str]] = {}


_state = _MeshState()


def build_mesh(degrees: Dict[str, int], group=None,
               axis_links: Optional[Dict[str, str]] = None) -> Mesh:
    """Create (and set current) a mesh from per-axis degrees.

    Only ``data`` may exceed 1 (the other axes raise
    ``NotImplementedError``). ``group`` is the data axis's process group;
    None takes the default group when ``data`` > 1, whose size must be
    ``data``. ``axis_links`` pins link types as :func:`set_axis_links`.
    """
    for ax, d in degrees.items():
        if ax not in AXES_ORDER:
            raise ValueError(f"unknown mesh axis {ax!r}; axes are "
                             f"{AXES_ORDER}")
        if ax != "data" and int(d) > 1:
            raise NotImplementedError(
                f"build_mesh: axis {ax!r} of size {d} is not ported yet; "
                f"tensor, pipeline, ZeRO and context parallelism wait in "
                f"ROADMAP.md (Queue 1, items 14 and 15)")
    n = int(degrees.get("data", 1))
    hosts = None
    if n > 1:
        if not dist.is_initialized():
            raise ValueError(f"build_mesh: data={n} needs a process group; "
                             f"call init_parallel_env first")
        have = dist.get_world_size(group)
        if have != n:
            raise ValueError(f"build_mesh: data={n} but the process group "
                             f"has {have} ranks")
        per_host = max(1, min(get_local_world_size(), n))
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else range(n))
        hosts = [r // per_host for r in ranks]
    mesh = Mesh({"data": n}, group=group, hosts=hosts)
    _state.mesh = mesh
    if axis_links is not None:
        set_axis_links(axis_links, mesh=mesh)
    return mesh


def set_mesh(mesh: Mesh) -> Mesh:
    _state.mesh = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _state.mesh


def require_mesh() -> Mesh:
    """The current mesh; without one, a data mesh over the default
    process group's ranks (one rank when there is none)."""
    if _state.mesh is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        return build_mesh({"data": n})
    return _state.mesh


def axis_size(axis: str) -> int:
    mesh = get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


# ---------------------------------------------------------------------------
# mesh-axis -> link-type map
# ---------------------------------------------------------------------------

def set_axis_links(links: Dict[str, str], mesh: Optional[Mesh] = None
                   ) -> Dict[str, str]:
    """Declare each axis's link type for ``mesh`` (the current mesh when
    None); unlisted axes read as "ici". Overrides inference."""
    mesh = mesh if mesh is not None else require_mesh()
    links = {str(k): str(v) for k, v in links.items()}
    for ax, link in links.items():
        if link not in LINK_TYPES:
            raise ValueError(f"link type for axis {ax!r} must be one of "
                             f"{LINK_TYPES}, got {link!r}")
        if ax not in mesh.axis_names:
            raise ValueError(f"axis {ax!r} not in mesh axes "
                             f"{tuple(mesh.axis_names)}")
    _state.links[mesh._key()] = links
    return links


def explicit_axis_links(mesh: Optional[Mesh] = None
                        ) -> Optional[Dict[str, str]]:
    """The map set by :func:`set_axis_links` for ``mesh``, or None."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return None
    links = _state.links.get(mesh._key())
    return dict(links) if links is not None else None


def infer_axis_links(mesh: Optional[Mesh] = None) -> Dict[str, str]:
    """An axis is "dcn" iff stepping along it crosses a host; size-1 axes
    are "ici" (they move no data)."""
    mesh = mesh if mesh is not None else require_mesh()
    links = {ax: "ici" for ax in mesh.axis_names}
    if len(set(mesh.hosts)) > 1:
        links["data"] = "dcn"
    return links


def axis_links(mesh: Optional[Mesh] = None) -> Dict[str, str]:
    """The explicit map when set, else the inferred one."""
    mesh = mesh if mesh is not None else require_mesh()
    explicit = explicit_axis_links(mesh)
    if explicit is not None:
        out = {ax: "ici" for ax in mesh.axis_names}
        out.update(explicit)
        return out
    return infer_axis_links(mesh)


def axis_link(axis: str, mesh: Optional[Mesh] = None) -> str:
    """Link type of one axis ("ici" when the axis is unknown)."""
    return axis_links(mesh).get(axis, "ici")

