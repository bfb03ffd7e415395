"""The one checkpoint directory of a world of ranks: ZeRO slices, residual
rows and replicated leaves written by their owners, restored on the same
layout bit for bit and resharded onto others from the logical arrays.

Two gloo worlds, each spawned once (``torch_ckpt_worker.py``): four ranks
at ``{"data": 2, "sharding": 2}`` (ZeRO-3, int8) and two at ``{"data": 2}``
(int8 data parallelism, the run whose checkpoint raised before), then at
``{"sharding": 2}`` (ZeRO-3). The format follows the state: every rank of
a mesh over 2+ ranks saving into one directory writes the world's; each
into its own, its own state in the one-rank format, unless it holds ZeRO
slices, which raises. Every
comparison is bit for bit: a restore copies the saved bytes, and a resumed
step runs the same operations on the same values in the same order. The
residual rows a reshard leaves are the reference's ``remap_comm_err`` of
the old rows (the JAX package's, on a trainer of the new mesh).
"""
import pickle

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.resilience.elastic import remap_comm_err as ref_remap

import torch_ckpt_worker as worker
from paddle_tpu_torch.distributed.spawn import spawn

pytestmark = pytest.mark.multihost(timeout=420)


def _weights():
    paddle.seed(0)
    net = rnn.Sequential(rnn.Linear(16, 64), rnn.ReLU(), rnn.Linear(64, 64),
                         rnn.ReLU(), rnn.Linear(64, 4))
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


def _batches(n=5):
    rng = np.random.RandomState(1)
    return [(rng.randn(8, 16).astype("float32"),
             rng.randint(0, 4, (8,)).astype("int64")) for _ in range(n)]


_RUNS = {}


def _run(scenario, n, tmp_path_factory):
    if scenario in _RUNS:
        return _RUNS[scenario]
    d = tmp_path_factory.mktemp(scenario)
    plan = {"scenario": scenario, "dir": str(d), "weights": _weights(),
            "batches": _batches()}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(worker.main, args=(str(d / "plan.pkl"), str(d)), nprocs=n,
          timeout=300)
    ranks = []
    for r in range(n):
        with open(d / f"{scenario}.rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    _RUNS[scenario] = ranks
    return ranks


def _chunk(full, piece):
    shape, dim, index, count, row = piece[:5]
    if row:
        return full[index]
    return np.split(full, count, axis=dim)[index]


def _same_pieces(a, b):
    assert a["layout"] == b["layout"]
    assert set(a["leaves"]) == set(b["leaves"])
    for k, v in a["leaves"].items():
        np.testing.assert_array_equal(v, b["leaves"][k], err_msg=k)


def _held_to_logical(got, logical, skip=("comm_err",)):
    """Every leaf a rank holds is its chunk of the saved logical array."""
    for k, v in got["leaves"].items():
        if k.split(".", 1)[0] in skip:
            continue
        full = logical[k]
        want = _chunk(full, got["layout"][k]) if k in got["layout"] else full
        np.testing.assert_array_equal(v, want, err_msg=k)


def test_zero3_world_saves_one_directory_and_resumes(tmp_path_factory):
    ranks = _run("zero4", 4, tmp_path_factory)
    assert ranks[0]["files"] == [
        "LAYOUT.json", "MANIFEST.json"] + [
        f"shards-{r:05d}-of-00004.pt" for r in range(4)]
    logical = ranks[0]["logical"]["trainer"]
    for out in ranks:
        assert out["mixed_raised"]
        assert out["resumed"] == out["cont"]
        for k, v in out["cont_params"].items():
            np.testing.assert_array_equal(out["resumed_params"][k], v)
        # what each rank held at the save is its chunk of the logical array
        _held_to_logical(out["saved"], logical, skip=())
        assert out["saved"]["layout"]["params.2.weight"][1:5] == (
            1, out["saved"]["layout"]["params.2.weight"][2], 2, False)
    # the residual rows are (4, *shape), one a rank, data-major
    rows = logical["comm_err.4.bias"]
    assert rows.shape == (4, 4)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(rows[r],
                                      out["saved"]["leaves"]["comm_err.4.bias"])


def _ref_trainer(degrees):
    net = rnn.Sequential(rnn.Linear(16, 64), rnn.ReLU(), rnn.Linear(64, 64),
                         rnn.ReLU(), rnn.Linear(64, 4))
    opt = paddle.optimizer.AdamW(1e-2, parameters=net.parameters())
    return RefTrainer(net, opt,
                      lambda o, y: rnn.functional.cross_entropy(o, y),
                      mesh=ref_build_mesh(degrees), zero_stage=3,
                      grad_sync="int8", grad_sync_block=64)


@pytest.mark.parametrize("target,degrees", [
    ("sharding4", {"sharding": 4}), ("data4", {"data": 4}),
    ("one", {"data": 1})])
def test_reshard_takes_slices_from_the_logical_arrays(tmp_path_factory,
                                                      target, degrees):
    ranks = _run("zero4", 4, tmp_path_factory)
    logical = ranks[0]["logical"]["trainer"]
    holders = ranks if target != "one" else ranks[:1]
    old_rows = ranks[0][target + "_rows"]
    for out in ranks[1:]:
        for k, v in out[target + "_rows"].items():
            np.testing.assert_array_equal(v, old_rows[k])
    want_rows = {k: np.asarray(v) for k, v in
                 ref_remap(old_rows, _ref_trainer(degrees)).items()}
    for out in holders:
        got = out[target]
        _held_to_logical(got, logical)
        rows = {k.split(".", 1)[1]: v for k, v in got["leaves"].items()
                if k.startswith("comm_err.")}
        assert set(rows) == set(want_rows)
        for k, v in rows.items():
            r = got["layout"]["comm_err." + k][2]
            np.testing.assert_array_equal(v, want_rows[k][r], err_msg=k)
        assert np.isfinite(out[target + "_step"]).all()
    if target == "sharding4":
        assert all(ranks[r][target]["layout"]["params.2.weight"][2] == r
                   for r in range(4))
    if target in ("data4", "one"):
        assert not any(k.startswith("params.") for k in
                       ranks[0][target]["layout"])


def test_data_parallel_world_saves_and_restores(tmp_path_factory):
    ranks = _run("dp2", 2, tmp_path_factory)
    for out in ranks:
        assert out["resumed"] == out["cont"]
        for k, v in out["cont_params"].items():
            np.testing.assert_array_equal(out["resumed_params"][k], v)
        for k, v in out["cont_rows"].items():
            np.testing.assert_array_equal(out["resumed_rows"][k], v)


def test_deep_tier_and_torn_step_fallback_at_two_ranks(tmp_path_factory):
    ranks = _run("dp2", 2, tmp_path_factory)
    for out in ranks:
        assert out["deep_verify"] is True
        assert out["torn_raised"] and out["torn_fired"] == 1
        assert out["fallback_step"] == 2 and out["fallbacks"] == 1
        _same_pieces(out["restored2"], out["step2"])


def test_async_commit_at_two_ranks(tmp_path_factory):
    ranks = _run("dp2", 2, tmp_path_factory)
    for out in ranks:
        assert out["async_steps"] == [1, 2, 3]
        assert out["async_accounted"]
        _same_pieces(out["async_restored"], out["async_live"])


def test_zero_world_through_a_manager_takes_the_format_from_the_state(
        tmp_path_factory):
    """A 2-rank ZeRO-3 state given to ``CheckpointManager(dir)`` with no
    other argument: one shared directory is the world's format and resumes
    bit for bit; a directory each raises on every rank, since only a
    world's directory places ZeRO slices."""
    ranks = _run("dp2", 2, tmp_path_factory)
    for out in ranks:
        got = out["zero2"]
        assert got["world_format"] and got["own_raised"]
        assert got["saved"]["layout"]["params.2.weight"][3] == 2
        _same_pieces(got["restored"], got["saved"])
        assert got["resumed"] == got["cont"]
    # the two ranks held different slices, each restored its own
    assert not np.array_equal(
        ranks[0]["zero2"]["saved"]["leaves"]["params.2.weight"],
        ranks[1]["zero2"]["saved"]["leaves"]["params.2.weight"])


def test_world_format_at_one_rank_round_trips(tmp_path):
    """At one rank the trainer's state is no world (the format follows the
    state): the one-rank format, deep-verified, restored bit for bit, and
    read without a template as its flat leaves."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, is_sharded_dir, load_checkpoint)
    from paddle_tpu_torch.distributed.mesh import Mesh
    w, b = _weights(), _batches(3)
    tr = worker.trainer(Mesh({"data": 1}), w, 3, "int8")
    worker._steps(tr, b[:2])
    mgr = CheckpointManager(str(tmp_path / "m"), deep_every=1)
    mgr.save(2, {"trainer": tr.state})
    assert not is_sharded_dir(str(tmp_path / "m" / "2"))
    assert mgr.verify(2, deep=True) is True
    t = worker.trainer(Mesh({"data": 1}), w, 3, "int8")
    t.state = mgr.restore(template={"trainer": t.state})["trainer"]
    _same_pieces(worker.pieces(t), worker.pieces(tr))
    flat = load_checkpoint(str(tmp_path / "m" / "2"))["trainer"]
    for k, v in tr.state["params"].items():
        assert torch.equal(flat["params." + k], v)


def test_world_read_assembles_only_the_template_pieces(tmp_path):
    """A world's directory read onto a template: each leaf comes from the
    stored pieces that overlap the template's piece, along another dim
    than the stored split too, and a part no piece covers raises."""
    import json
    import os

    import torch
    from paddle_tpu_torch.distributed import checkpoint as ck
    path = tmp_path / "w"
    path.mkdir()
    full = torch.arange(48.0).reshape(6, 8)
    leaves = {"s/w": {"shape": [6, 8], "dtype": "float32"},
              "s/b": {"shape": [], "dtype": "float32"}}
    with open(path / ck.LAYOUT_NAME, "w") as f:
        json.dump({"format": "sharded", "version": 1, "world": 2,
                   "keys": ["s"], "leaves": leaves}, f)
    for r in range(2):    # saved split along dim 0 in two
        pieces = {"s/w": full[3 * r:3 * r + 3].clone()}
        index = {"s/w": [0, 3 * r, 3 * r + 3]}
        if r == 0:
            pieces["s/b"], index["s/b"] = torch.tensor(7.0), [-1, 0, 0]
        torch.save({"pieces": pieces, "index": index},
                   os.path.join(path, ck._shard_file(r, 2)))
    for idx in range(4):  # read split along dim 1 in four
        tmpl = ck.ShardedState(s={"w": torch.zeros(6, 2),
                                  "b": torch.zeros(())})
        tmpl.layout = {"s.w": ck.Piece((6, 8), 1, idx, 4, False, True)}
        got = ck.load_checkpoint(str(path), template=tmpl)
        assert torch.equal(got["s"]["w"], full[:, 2 * idx:2 * idx + 2])
        assert float(got["s"]["b"]) == 7.0
    flat = ck.load_checkpoint(str(path))
    assert torch.equal(flat["s"]["w"], full)
    os.remove(path / ck._shard_file(1, 2))
    with open(path / ck.LAYOUT_NAME) as f:
        layout = json.load(f)
    layout["world"] = 1
    with open(path / ck.LAYOUT_NAME, "w") as f:
        json.dump(layout, f)
    os.rename(path / ck._shard_file(0, 2), path / ck._shard_file(0, 1))
    with pytest.raises(ValueError, match="no piece covers"):
        ck.load_checkpoint(str(path))
