"""The device mesh of the port: named axes over ``torch.distributed``.

Port of ``paddle_tpu/distributed/mesh.py``. The reference builds one
``jax.sharding.Mesh`` whose named axes (``data``, ``pipe``, ``sharding``,
``sep``, ``model``) are the hybrid-parallel axes. The port runs one
process per card, so a :class:`Mesh` here is a thin object over process
groups that covers the world:

- rank ``r`` of the mesh's group sits at coordinate
  ``np.unravel_index(r, shape)`` over :data:`AXES_ORDER`, as the reference
  reshapes its device array: ``model`` varies fastest, ``data`` slowest;
- every set of live axes (axes larger than 1) has the process group its
  collectives run over (``group_of``): the ranks that differ only on
  those axes, the comm lists of :meth:`CommunicateTopology.get_comm_list`
  for one axis. So ``model`` (the Megatron layers), ``pipe`` (the
  pipeline's tied-weight sums; its point-to-point hops go to
  :meth:`Mesh.neighbor`), ``sep`` (ring attention), the trainer's
  ``("data", "sharding", "sep")`` gradient mean and ``("pipe",
  "model")`` (the norm of a stacked tensor-parallel slice) all have one,
  and the whole mesh is its own group. A rank's index in a group of
  several axes (``rank_in``) is its coordinate over them, data-major,
  which is the index the reference's collectives give a tuple of axes.

:func:`build_mesh` creates these groups at once, in one order on every
rank (``torch.distributed.new_group`` is a collective of the default
group: every rank of it calls ``build_mesh``, or the world deadlocks). A
mesh of one rank needs no process group. A larger one needs the default
group started (``env.init_parallel_env``), or a group passed to
:func:`build_mesh`, whose size is the mesh's.

Axis link types keep the reference's names: ``"ici"`` for ranks on one
host (NVLink on an H100 box) and ``"dcn"`` for an axis that crosses hosts
(the network between them). ``infer_axis_links`` places rank ``r`` on host
``r // LOCAL_WORLD_SIZE`` (``torchrun`` and ``spawn`` set it; without it
every rank shares one host); an axis is ``"dcn"`` when stepping along it
ever crosses a host. ``set_axis_links`` overrides the inference, as in the
reference; the compressed exchange reads the map under
``grad_sync_dcn_only``. :func:`link_bandwidth` and :func:`link_latency`
price a link class for the cost model (``analysis/cost.py``: the overlap
model behind the trainer's ``grad_sync_overlap_efficiency`` gauge and the
planner, ``distributed/auto.py``): an environment override first
(``PADDLE_TPU_TORCH_{ICI,DCN}_BPS``, ``PADDLE_TPU_TORCH_{ICI,DCN}_LAT_S``),
then the calibration DB's fitted constants for this device kind
(``telemetry/calibration.py``, fitted by ``calibration.fit_link`` from
``tests/torch_analysis_cards.py``'s NCCL sweep), then the shipped
:data:`LINK_BANDWIDTHS`, which are an H100 SXM box's data-sheet figures.

:class:`CommunicateTopology` and :class:`HybridCommunicateGroup` are the
reference's coordinate math over the hybrid axes (the fleet API's view of
the mesh), in pure numpy.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from .env import get_local_world_size

__all__ = ["AXES_ORDER", "OWN_AXES", "LINK_TYPES", "Mesh", "build_mesh",
           "set_mesh", "own_splits", "local_piece", "split_of",
           "get_mesh", "require_mesh", "axis_size", "set_axis_links",
           "explicit_axis_links", "infer_axis_links", "axis_links",
           "axis_link", "LINK_BANDWIDTHS", "link_bandwidth", "link_latency",
           "known_groups", "group_handle", "handle_group",
           "CommunicateTopology", "HybridCommunicateGroup"]

AXES_ORDER = ("data", "pipe", "sharding", "sep", "model")
# the axes a parameter's own split may name, by its ``pspec`` (ZeRO's
# ``sharding`` slices are the trainer's)
OWN_AXES = ("pipe", "model")

LINK_TYPES = ("ici", "dcn")


def _axis_tuple(axes) -> Tuple[str, ...]:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


class Mesh:
    """Axis sizes over the world's ranks, in :data:`AXES_ORDER`, and the
    process groups of its live axes (the module docstring).

    ``group`` is the whole mesh's group (None: the default group);
    ``groups`` maps an axes tuple (in :data:`AXES_ORDER` order) to the
    group this rank belongs to along those axes (:func:`build_mesh` fills
    it). ``hosts`` is the host index of each rank of the mesh, in rank
    order. ``rank`` is this process's rank in the mesh (read from the
    group when None)."""

    axis_names = AXES_ORDER

    def __init__(self, shape: Dict[str, int], group=None,
                 hosts: Optional[Sequence[int]] = None,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 rank: Optional[int] = None):
        self.shape = {ax: int(shape.get(ax, 1)) for ax in AXES_ORDER}
        self.group = group
        self.size = int(np.prod(list(self.shape.values())))
        self._groups = dict(groups or {})
        if rank is None:
            rank = (dist.get_rank(group) if self.size > 1
                    and dist.is_initialized() else 0)
        self.rank = int(rank)
        dims = tuple(self.shape[ax] for ax in AXES_ORDER)
        self.coord = {ax: int(c) for ax, c in
                      zip(AXES_ORDER, np.unravel_index(self.rank, dims))}
        self.hosts = (tuple(int(h) for h in hosts) if hosts is not None
                      else (0,) * self.size)

    def live(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        """``axes`` larger than 1, in :data:`AXES_ORDER` order."""
        want = set(_axis_tuple(axes))
        return tuple(ax for ax in AXES_ORDER
                     if ax in want and self.shape[ax] > 1)

    def axes_size(self, axes: Union[str, Sequence[str]]) -> int:
        out = 1
        for ax in _axis_tuple(axes):
            out *= self.shape[ax]
        return out

    def group_of(self, axes: Union[str, Sequence[str]]):
        """The process group of ``axes`` (None when they span one rank)."""
        key = self.live(axes)
        if not key:
            return None
        if key in self._groups:
            return self._groups[key]
        if key == self.live(AXES_ORDER):
            return self.group if self.group is not None else dist.group.WORLD
        raise ValueError(f"mesh {self.shape} has no process group for axes "
                         f"{key}; build it with build_mesh")

    def neighbor(self, axis: str, offset: int) -> int:
        """The default-group rank of the process ``offset`` steps along
        ``axis`` (cyclic), the other coordinates kept: the peer of a
        point-to-point hop."""
        coord = dict(self.coord)
        coord[axis] = (coord[axis] + offset) % self.shape[axis]
        dims = tuple(self.shape[ax] for ax in AXES_ORDER)
        r = int(np.ravel_multi_index(tuple(coord[ax] for ax in AXES_ORDER),
                                     dims))
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def rank_in(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index along ``axes``: its coordinates over them,
        data-major (the index of its group's collectives)."""
        idx = 0
        for ax in self.live(axes):
            idx = idx * self.shape[ax] + self.coord[ax]
        return idx

    def backend(self) -> Optional[str]:
        """The mesh group's backend ("nccl", "gloo"), or None without one."""
        group = self.group_of(AXES_ORDER)
        return None if group is None else dist.get_backend(group)

    def _key(self) -> tuple:
        return (id(self.group), tuple(self.shape.values()), self.hosts)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _comm_lists(shape: Dict[str, int], axes: Tuple[str, ...]
                ) -> List[List[int]]:
    """Mesh ranks that differ only on ``axes``, one list for every value
    of the other axes, in ascending order (the lists of
    :meth:`CommunicateTopology.get_comm_list`, for a set of axes)."""
    dims = tuple(shape[ax] for ax in AXES_ORDER)
    ranks = np.arange(int(np.prod(dims))).reshape(dims)
    keep = [i for i, ax in enumerate(AXES_ORDER) if ax in axes]
    other = [i for i in range(len(AXES_ORDER)) if i not in keep]
    moved = np.transpose(ranks, other + keep)
    n = int(np.prod([dims[i] for i in keep]))
    return [sorted(int(r) for r in row) for row in moved.reshape(-1, n)]


# every process group a mesh built: id -> (its mesh's shape, its axes)
_GROUPS: Dict[int, Tuple[Dict[str, int], Tuple[str, ...]]] = {}


def known_groups() -> Dict[int, Tuple[Dict[str, int], Tuple[str, ...]]]:
    """The process groups :func:`build_mesh` made (the analysis rules'
    membership check): ``id(group) -> (mesh shape, axes)``."""
    return dict(_GROUPS)


# the process groups a library op names by handle (an op takes no
# Python object), kept for the process's life
_OP_GROUPS: List = []


def group_handle(group) -> int:
    """The integer a library op takes for ``group``
    (:func:`handle_group` gives it back)."""
    for h, g in enumerate(_OP_GROUPS):
        if g is group:
            return h
    _OP_GROUPS.append(group)
    return len(_OP_GROUPS) - 1


def handle_group(handle: int):
    """The process group of :func:`group_handle`'s ``handle``."""
    return _OP_GROUPS[handle]


class _MeshState(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.links: Dict[tuple, Dict[str, str]] = {}


_state = _MeshState()


def build_mesh(degrees: Dict[str, int], group=None,
               axis_links: Optional[Dict[str, str]] = None) -> Mesh:
    """Create (and set current) a mesh from per-axis degrees.

    ``group`` is the mesh's process group; None takes the default group
    when the mesh has more than one rank, whose size must be the product
    of the degrees. Every set of live axes but the whole mesh gets its
    groups (the module docstring), in one order on every rank: every rank
    of the default group must call this.
    ``axis_links`` pins link types as :func:`set_axis_links`."""
    for ax in degrees:
        if ax not in AXES_ORDER:
            raise ValueError(f"unknown mesh axis {ax!r}; axes are "
                             f"{AXES_ORDER}")
    shape = {ax: int(degrees.get(ax, 1)) for ax in AXES_ORDER}
    for ax, d in shape.items():
        if d < 1:
            raise ValueError(f"mesh axis {ax!r} has degree {d}")
    n = int(np.prod(list(shape.values())))
    hosts, groups, rank = None, {}, 0
    if n > 1:
        if not dist.is_initialized():
            raise ValueError(f"build_mesh: {n} ranks ({degrees}) need a "
                             f"process group; call init_parallel_env first")
        have = dist.get_world_size(group)
        if have != n:
            raise ValueError(f"build_mesh: degrees {degrees} need {n} ranks "
                             f"but the process group has {have}")
        rank = dist.get_rank(group)
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(n)))
        per_host = max(1, min(get_local_world_size(), n))
        hosts = [r // per_host for r in ranks]
        backend = dist.get_backend(group)
        live = tuple(ax for ax in AXES_ORDER if shape[ax] > 1)
        sets = [axes for k in range(1, len(live))
                for axes in itertools.combinations(live, k)]
        for axes in sets:
            for members in _comm_lists(shape, axes):
                pg = dist.new_group(ranks=[ranks[m] for m in members],
                                    backend=backend)
                if rank in members:
                    groups[axes] = pg
                    _GROUPS[id(pg)] = (dict(shape), axes)
        if group is not None:
            _GROUPS[id(group)] = (dict(shape), live)
    mesh = Mesh(shape, group=group, hosts=hosts, groups=groups, rank=rank)
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
# a parameter's own split: its ``pspec`` over OWN_AXES


def own_splits(pspec, mesh: Optional[Mesh] = None) -> tuple:
    """``((axis, dim), ...)``: the dims a parameter's ``pspec`` splits over
    ``pipe`` or ``model`` (with ``mesh``, only its axes larger than 1)."""
    out = tuple((a, d) for d, ax in enumerate(tuple(pspec or ()))
                for a in _axis_tuple(ax) if a in OWN_AXES)
    return out if mesh is None else tuple(
        (a, d) for a, d in out if mesh.shape[a] > 1)


def local_piece(value, pspec, mesh: Optional[Mesh] = None):
    """This rank's piece of a whole array: along each dim whose ``pspec``
    entry names a ``pipe`` or ``model`` axis of ``mesh`` (the current one
    when None) larger than 1, chunk ``coord[axis]`` of ``shape[axis]``."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return value
    for a, d in own_splits(pspec, mesh):
        value = value.chunk(mesh.shape[a], dim=d)[mesh.coord[a]]
    return value


def split_of(params: dict, mesh: Optional[Mesh] = None,
             sharded=()) -> dict:
    """``{key: group}`` for the parameters of ``params`` that are slices
    on ``mesh`` (the current one when None): split over ``model`` or
    ``pipe`` by their ``pspec``, or, for the keys of ``sharded``, over
    ``sharding`` too (a ZeRO trainer's slices). The group is the one
    their norms and top-k sum over."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None:
        return {}
    out = {}
    for k, p in params.items():
        axes = tuple(a for a, _ in own_splits(getattr(p, "pspec", None),
                                              mesh))
        if k in sharded:
            axes += ("sharding",)
        if mesh.live(axes):
            out[k] = mesh.group_of(axes)
    return out


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
    """An axis is "dcn" iff stepping along it ever crosses a host; size-1
    axes are "ici" (they move no data)."""
    mesh = mesh if mesh is not None else require_mesh()
    dims = tuple(mesh.shape[ax] for ax in AXES_ORDER)
    ids = np.asarray(mesh.hosts).reshape(dims)
    links = {}
    for i, ax in enumerate(AXES_ORDER):
        if dims[i] <= 1:
            links[ax] = "ici"
            continue
        lo = np.take(ids, range(dims[i] - 1), axis=i)
        hi = np.take(ids, range(1, dims[i]), axis=i)
        links[ax] = "dcn" if bool((lo != hi).any()) else "ici"
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


# ---------------------------------------------------------------------------
# link bandwidth constants (the overlap model's wire-time denominators)
# ---------------------------------------------------------------------------

# Bytes/s a rank moves in one direction on each link class, NVIDIA's data
# sheet for an H100 SXM5 box (not a measurement): "ici", NVLink 4, 900 GB/s
# a GPU both directions together, so 450 GB/s one way; "dcn", one 400 Gb/s
# NDR InfiniBand port a GPU (50 GB/s). The calibration DB's fitted
# constants (measured on four cards) win over these; the environment wins
# over both. They rank schedules and size overlap windows; they are not a
# profiler.
LINK_BANDWIDTHS: Dict[str, float] = {"ici": 4.5e11, "dcn": 5.0e10}

_LINK_BW_ENV = {"ici": "PADDLE_TPU_TORCH_ICI_BPS",
                "dcn": "PADDLE_TPU_TORCH_DCN_BPS"}
_LINK_LAT_ENV = {"ici": "PADDLE_TPU_TORCH_ICI_LAT_S",
                 "dcn": "PADDLE_TPU_TORCH_DCN_LAT_S"}


def _calibration():
    try:
        from ..telemetry import calibration
        return calibration
    except Exception:  # pragma: no cover - pricing must never crash
        return None


def link_bandwidth(link: str) -> float:
    """Bytes/s of one link class: the environment, then the calibration
    DB, then :data:`LINK_BANDWIDTHS` (reference ``mesh.py:220``)."""
    import os
    env = os.environ.get(_LINK_BW_ENV.get(link, ""), "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    cal = _calibration()
    if cal is not None:
        fitted = cal.link_bandwidth_override(link)
        if fitted is not None:
            return fitted
    return LINK_BANDWIDTHS.get(link, LINK_BANDWIDTHS["ici"])


def link_latency(link: str) -> float:
    """Fixed seconds a collective of one link class: the environment,
    then the calibration DB, else 0.0 (the pure-bandwidth model;
    reference ``mesh.py:244``)."""
    import os
    env = os.environ.get(_LINK_LAT_ENV.get(link, ""), "")
    if env:
        try:
            return max(0.0, float(env))
        except ValueError:
            pass
    cal = _calibration()
    if cal is not None:
        fitted = cal.link_latency_override(link)
        if fitted is not None:
            return fitted
    return 0.0


# ---------------------------------------------------------------------------
# the reference's topology objects
# ---------------------------------------------------------------------------

class CommunicateTopology:
    """Coordinate math over the hybrid axes (reference
    ``fleet/base/topology.py:36``): rank ``r`` is
    ``np.unravel_index(r, dims)``."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        shape = tuple(dims)
        self._world = int(np.prod(shape))
        self._coords = {}
        for rank in range(self._world):
            self._coords[rank] = tuple(
                int(x) for x in np.unravel_index(rank, shape))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = tuple(kwargs[n] for n in self._parallel_names)
        return int(np.ravel_multi_index(coords, tuple(self._dims)))

    def get_coord(self, rank):
        return self._coords[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in self._coords.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """All subgroups along ``axis_name`` (a list of rank lists)."""
        axis = self._parallel_names.index(axis_name)
        groups = {}
        for r, c in self._coords.items():
            key = tuple(v for i, v in enumerate(c) if i != axis)
            groups.setdefault(key, []).append(r)
        return [sorted(v) for _, v in sorted(groups.items())]


class HybridCommunicateGroup:
    """One rank's view of the topology (reference
    ``fleet/base/topology.py:117``): degrees, coordinates and the pipeline
    neighbours."""

    def __init__(self, topology: CommunicateTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._mp_degree = topology.get_dim("model")
        coord = topology.get_coord(global_rank)
        names = topology.get_hybrid_group_names()
        self._coord = dict(zip(names, coord))

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_next_rank(self):
        coords = dict(self._coord)
        coords["pipe"] = (coords["pipe"] + 1) % self._pp_degree
        return self._topo.get_rank(**coords)

    def get_p2p_prev_rank(self):
        coords = dict(self._coord)
        coords["pipe"] = (coords["pipe"] - 1) % self._pp_degree
        return self._topo.get_rank(**coords)
