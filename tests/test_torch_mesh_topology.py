"""The port's mesh of five axes and the reference's topology objects.

- ``CommunicateTopology``/``HybridCommunicateGroup`` against the JAX
  package's for every rank of four topologies (pure coordinate math:
  equal).
- ``shard_spec_for`` against the reference's on every GPT-base leaf shape
  at n = 2, 4 and 8, the square 768 x 768 weights included (numpy's
  argsort order decides those, on both sides: equal).
- ``build_mesh`` on a gloo world of 4 (``torch_mesh_worker.py``, spawned
  once): every group of every set of live axes holds the reference's comm
  list, this rank's index in it is its data-major coordinate, and an
  ``all_reduce`` over it sums its members; and the fleet API on that
  world (its assertions in ``test_torch_fleet_api.py``'s terms, here
  because they share the spawn).
- the groups ``build_mesh`` asks ``torch.distributed`` for on a mesh of 8
  with three live axes, recorded in this process: each axis's comm
  lists, then those of each pair of axes (``("data", "sharding")`` first),
  in ``itertools.combinations`` order, and not the whole mesh's.
"""
import itertools
import pickle
import types

import numpy as np
import pytest

from paddle_tpu.distributed import mesh as ref_mesh
from paddle_tpu.distributed.meta_parallel import sharding_parallel as ref_sp

import torch_mesh_worker as worker
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.distributed.meta_parallel import sharding_parallel as sp
from paddle_tpu_torch.distributed.spawn import spawn

NAMES = ("data", "pipe", "sharding", "model")
TOPOLOGIES = [(2, 1, 2, 1), (1, 2, 1, 2), (2, 2, 2, 1), (1, 1, 4, 2)]


@pytest.mark.parametrize("dims", TOPOLOGIES, ids=str)
def test_topology_equals_the_reference(dims):
    t, rt = mesh.CommunicateTopology(NAMES, dims), \
        ref_mesh.CommunicateTopology(NAMES, dims)
    assert t.world_size() == rt.world_size()
    for ax in NAMES:
        assert t.get_dim(ax) == rt.get_dim(ax)
        assert t.get_comm_list(ax) == rt.get_comm_list(ax)
        for i in range(t.get_dim(ax)):
            assert t.get_axis_list(ax, i) == rt.get_axis_list(ax, i)
    for r in range(t.world_size()):
        assert t.get_coord(r) == rt.get_coord(r)
        assert t.get_rank(**dict(zip(NAMES, t.get_coord(r)))) == r
        h, rh = mesh.HybridCommunicateGroup(t, r), \
            ref_mesh.HybridCommunicateGroup(rt, r)
        for fn in ("get_data_parallel_world_size", "get_data_parallel_rank",
                   "get_model_parallel_world_size",
                   "get_model_parallel_rank", "get_pipe_parallel_world_size",
                   "get_stage_id", "get_sharding_parallel_world_size",
                   "get_sharding_parallel_rank", "is_first_stage",
                   "is_last_stage", "get_p2p_next_rank",
                   "get_p2p_prev_rank"):
            assert getattr(h, fn)() == getattr(rh, fn)(), (dims, r, fn)


def _gpt_base_shapes():
    from paddle_tpu_torch.text.models import GPTForPretraining
    m = GPTForPretraining(tensor_parallel=False, vocab_size=50304,
                          hidden_size=768, num_layers=1, num_heads=12,
                          max_position_embeddings=1024)
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


@pytest.mark.parametrize("n", (2, 4, 8))
def test_shard_spec_for_equals_the_reference(n):
    shapes = _gpt_base_shapes()
    assert (768, 768) in shapes.values()
    for name, shape in shapes.items():
        leaf = types.SimpleNamespace(shape=shape, size=int(np.prod(shape)))
        want = tuple(ref_sp.shard_spec_for(leaf, n_shards=n))
        assert sp.shard_spec_for(shape, n_shards=n) == want, (name, n)
    # the square weight splits where numpy's argsort puts it first
    assert sp.shard_spec_for((768, 768), n_shards=2) == tuple(
        ref_sp.shard_spec_for(np.zeros((768, 768)), n_shards=2))
    assert sp.shard_spec_for((4, 4), n_shards=2) == ()      # under 1024
    assert sp.shard_spec_for((1023, 3), n_shards=2) == ()   # none divides


MESHES = {"dxs": {"data": 2, "sharding": 2}, "pxm": {"pipe": 2, "model": 2}}
_RUN = {}


def run_world(tmp_path_factory):
    """The world of 4, spawned once for this file and the fleet file."""
    if "ranks" in _RUN:
        return _RUN["plan"], _RUN["ranks"]
    d = tmp_path_factory.mktemp("mesh4")
    rng = np.random.RandomState(0)
    from test_torch_sharded_checkpoint import _weights
    plan = {"meshes": MESHES, "weights": _weights(),
            "batch": (rng.randn(8, 16).astype("float32"),
                      rng.randint(0, 4, (8,)).astype("int64")),
            "gss_dir": str(d / "gss")}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(worker.main, args=(str(d / "plan.pkl"), str(d)), nprocs=4,
          timeout=300)
    ranks = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    _RUN.update(plan=plan, ranks=ranks)
    return plan, ranks


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_mesh_groups_on_a_world_of_4(tmp_path_factory, name):
    plan, ranks = run_world(tmp_path_factory)
    degrees = MESHES[name]
    dims = [degrees.get(a, 1) for a in mesh.AXES_ORDER]
    topo = ref_mesh.CommunicateTopology(mesh.AXES_ORDER, dims)
    live = [a for a in mesh.AXES_ORDER if degrees.get(a, 1) > 1]
    for r, out in enumerate(ranks):
        got = out[name]
        assert [got["coord"][a] for a in mesh.AXES_ORDER] == \
            list(np.unravel_index(r, dims))
        assert got["links"] == {a: "ici" for a in mesh.AXES_ORDER}
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                g = got["groups"][axes]
                if k == 1:
                    want = next(c for c in topo.get_comm_list(axes[0])
                                if r in c)
                else:
                    want = list(range(4))
                assert g["ranks"] == want, (name, axes)
                assert g["rank_in"] == g["dist_rank"] == want.index(r)
                assert g["sum"] == float(sum(want))


def test_build_mesh_creates_the_axis_groups_and_data_by_sharding(
        monkeypatch):
    made = []

    class _Group:
        pass

    def new_group(ranks, backend=None):
        made.append(list(ranks))
        return _Group()

    d = mesh.dist
    for name, fn in (("is_initialized", lambda: True),
                     ("get_world_size", lambda group=None: 8),
                     ("get_rank", lambda group=None: 5),
                     ("get_backend", lambda group=None: "gloo"),
                     ("new_group", new_group)):
        monkeypatch.setattr(d, name, fn)
    degrees = {"data": 2, "sharding": 2, "model": 2}
    m = mesh.build_mesh(degrees)
    dims = [degrees.get(a, 1) for a in mesh.AXES_ORDER]
    topo = ref_mesh.CommunicateTopology(mesh.AXES_ORDER, dims)
    want = [c for ax in ("data", "sharding", "model")
            for c in topo.get_comm_list(ax)]
    # a pair of axes: the ranks that share the third axis's coordinate
    # (data, sharding, model: strides 4, 2, 1)
    want += [[0, 1, 2, 3, 4, 5, 6, 7][o::2] for o in (0, 1)]      # d, s
    want += [[o, o + 1, o + 4, o + 5] for o in (0, 2)]            # d, m
    want += [[o, o + 1, o + 2, o + 3] for o in (0, 4)]            # s, m
    assert made == want
    assert m.rank_in(("data", "sharding")) == 2 and \
        m.group_of(("data", "sharding")) is not None
    assert m.rank_in(("sharding", "model")) == 1 and \
        m.group_of(("sharding", "model")) is not None
    # the whole mesh is the default group, made by no new_group
    assert m.group_of(("data", "sharding", "model")) is d.group.WORLD
    mesh.set_mesh(None)
