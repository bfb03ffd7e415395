"""Pipeline parallelism of the port (``PipelineLayer`` of
``gpt_pipeline_descs`` under ``PipelineParallel``, GPipe and 1F1B) over
gloo ranks on the CPU, against the JAX package's trainer on a mesh of the
same shape.

The port ``spawn``s a world of 2 (``{"pipe": 2}``) and one of 4
(``{"pipe": 4}``, ``{"pipe": 2, "model": 2}``), each once
(``torch_hybrid_worker.py``); the reference runs in this process from the
same numpy weights and batches (the reference's pipeline test config:
vocab 64, H 32, 4 layers, 2 heads, S 16, a batch of 16, M = 4
micro-batches, SGD at lr 0.05, segments ``layer:GPTBlock``), each run once
per module. The behaviours held are the reference's
(``tests/test_pipeline_parallel.py``): the trajectory, the tied weight
equal on every pipe rank, the head's gradient reaching the embedding, the
1F1B in-flight bound, GPipe == 1F1B. At ``{"pipe": 2, "model": 2}`` also:
a world checkpoint saved midway resumes bit for bit and restores onto
``{"pipe": 2, "data": 2}``; a NaN gradient planted on one stage skips the
step on all four ranks; the replica check compares no slice with another;
a global-norm clip takes the whole model's norm (``tp2-clip``).

Tolerances, derived where asserted:

- port against reference, float32: other summation orders (PyTorch's
  GEMM against XLA's dot; the micro-batch sums in order against the
  reference's scan; the model-axis sums) give a loss within rtol 1e-5 (a
  few ulps of a mean over 16 x 16 tokens near 4.2, with the weights'
  drift below) and each parameter element within ``ATOL`` = 1e-6: an SGD
  step is ``lr * g``, and a gradient element differs by a few float32
  ulps of the largest terms of its sum (|g| < 1 here), so 3 steps move an
  element by at most a few times ``0.05 * 2**-23 * 16``, under 1e-6.
- GPipe against 1F1B, and a resumed run against the one that went on:
  the same operations in the same order (backwards in micro-batch order,
  gradients added in that order), so bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import optimizer as ropt
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import CommunicateTopology as RefTopo
from paddle_tpu.distributed.mesh import HybridCommunicateGroup as RefHcg
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.distributed.meta_parallel import \
    ParallelCrossEntropy as RefPCE
from paddle_tpu.distributed.meta_parallel import \
    PipelineLayer as RefPipelineLayer
from paddle_tpu.distributed.meta_parallel import \
    PipelineParallel as RefPipelineParallel
from paddle_tpu.text.models import gpt_pipeline_descs as ref_descs

import torch_hybrid_worker as worker
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.distributed.mesh import Mesh
from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                        PipelineLayer,
                                                        PipelineParallel,
                                                        SegmentLayers)
from paddle_tpu_torch.optimizer import SGD
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=300)

PP_CFG = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=2,
              max_position_embeddings=32, dropout=0.0)
LR, M, STEPS = 0.05, 4, 3
ATOL = 1e-6
# a global-norm clip well under the gradients' norm (~1 here), so every
# step is clipped: its norm sums the TP slices over model and the stage
# members over pipe
CLIP = 0.1


def _pp(degrees, tie=True, tp=False, schedule="gpipe", **kw):
    c = dict(model="pipe", degrees=degrees, tie=tie, tp=tp,
             schedule=schedule, m=M, stages=degrees["pipe"], opt="sgd",
             lr=LR, steps=STEPS, weights=_wkey(tie, tp, degrees["pipe"]),
             batch="pp")
    c.update(kw)
    return c


def _wkey(tie, tp, stages):
    return f"{'tied' if tie else 'untied'}-{'tp' if tp else 'dense'}-{stages}"


TP2 = {"pipe": 2, "model": 2}
CASES = {
    2: {"tied-gpipe": _pp({"pipe": 2}),
        "tied-1f1b": _pp({"pipe": 2}, schedule="1f1b"),
        "untied-gpipe": _pp({"pipe": 2}, tie=False),
        "untied-1f1b": _pp({"pipe": 2}, tie=False, schedule="1f1b")},
    4: {"pipe4-gpipe": _pp({"pipe": 4}),
        "pipe4-1f1b": _pp({"pipe": 4}, schedule="1f1b"),
        "tp2-gpipe": _pp(TP2, tp=True),
        "tp2-1f1b": _pp(TP2, tp=True, schedule="1f1b"),
        "tp2-resume": _pp(TP2, tp=True, steps=2, resume=2,
                          reshard={"pipe": 2, "data": 2}),
        "tp2-nan": _pp(TP2, tp=True, schedule="1f1b", nan_at=1,
                       nan_stage=1, check=1),
        "tp2-clip": _pp(TP2, tp=True, clip=CLIP)},
}


def _batches():
    rng = np.random.RandomState(0)
    return {"pp": (rng.randint(0, 64, (16, 16)).astype("int32"),
                   rng.randint(0, 64, (16, 16)).astype("int32"))}


def _ref_layer(tie, tp, stages):
    paddle.seed(7)
    return RefPipelineLayer(ref_descs(tensor_parallel=tp,
                                      tie_embeddings=tie, **PP_CFG),
                            num_stages=stages, seg_method="layer:GPTBlock")


def _weights():
    out = {}
    for cases in CASES.values():
        for c in cases.values():
            key = _wkey(c["tie"], c["tp"], c["stages"])
            if key not in out:
                pl = _ref_layer(c["tie"], c["tp"], c["stages"])
                out[key] = {k: np.asarray(v)
                            for k, v in pl.state_dict().items()}
    return out


class _Strat:
    def __init__(self, m, schedule):
        self.pipeline_configs = {"accumulate_steps": m, "schedule": schedule}


def _ref_loss(logits, labels):
    return RefPCE()(logits, labels).mean()


_REF = {}


def _ref_run(case):
    key = (case["weights"], tuple(sorted(case["degrees"].items())),
           case["schedule"], case["steps"] + case.get("resume", 0),
           case.get("clip"))
    if key in _REF:
        return _REF[key]
    ref_build_mesh(case["degrees"])
    pl = _ref_layer(case["tie"], case["tp"], case["stages"])
    dims = [case["degrees"].get(a, 1) for a in ("data", "pipe", "sharding",
                                                "model")]
    topo = RefTopo(("data", "pipe", "sharding", "model"), dims)
    pp = RefPipelineParallel(pl, RefHcg(topo, 0),
                             _Strat(case["m"], case["schedule"]))
    clip = (ropt.ClipGradByGlobalNorm(case["clip"]) if case.get("clip")
            else None)
    tr = RefTrainer(pp, ropt.SGD(case["lr"], parameters=pp.parameters(),
                                 grad_clip=clip),
                    _ref_loss, micro_batches=case["m"])
    batch = _batches()["pp"]
    losses, params = [], []
    for _ in range(case["steps"] + case.get("resume", 0)):
        losses.append(float(tr.train_step(*batch)))
        # copies: the next step donates (and reuses) these buffers
        params.append({k: np.array(v, copy=True) for k, v in
                       tr.state["params"].items()})
    _REF[key] = (losses, params)
    return _REF[key]


_RUNS = {}


def _world(n, tmp_path_factory):
    if n not in _RUNS:
        plan = {"train": CASES[n], "pp_cfg": dict(PP_CFG),
                "weights": _weights(), "batches": _batches()}
        _RUNS[n] = worker.spawn_plan(plan, n, tmp_path_factory, f"pp{n}")
    return _RUNS[n]


@pytest.mark.parametrize("n,name", [(n, c) for n in CASES for c in CASES[n]
                                    if "nan" not in c])
def test_pipeline_matches_the_reference(n, name, tmp_path_factory):
    ranks = _world(n, tmp_path_factory)
    case = CASES[n][name]
    losses, params = _ref_run(case)
    for r in ranks:
        got = r["train"][name]
        assert got["skipped"] == 0
        np.testing.assert_allclose(got["losses"], losses[:case["steps"]],
                                   rtol=1e-5)
    assert set(ranks[0]["train"][name]["params"]) == set(params[0])
    for k, want in params[case["steps"] - 1].items():
        # assemble also holds every copy of a replicated leaf (the tied
        # weight on each pipe rank) equal bit for bit
        got = worker.assemble(ranks, name, k)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("n,tag", [(2, "tied"), (2, "untied"),
                                   (4, "pipe4"), (4, "tp2")])
def test_gpipe_equals_1f1b_and_1f1b_bounds_in_flight(n, tag,
                                                     tmp_path_factory):
    ranks = _world(n, tmp_path_factory)
    g, f = f"{tag}-gpipe", f"{tag}-1f1b"
    stages = CASES[n][g]["stages"]
    for r in ranks:
        a, b = r["train"][g], r["train"][f]
        assert a["losses"] == b["losses"]
        for k, (v, _) in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][k][0], err_msg=k)
        s = r["train"][f]["coord"]["pipe"]
        assert a["in_flight"] == M
        assert b["in_flight"] == min(stages - s, M) <= stages


def test_tied_embedding_gets_the_heads_gradient(tmp_path_factory):
    """Every vocab row of the tied weight moves (the head's softmax
    gradient reaches all of them; a lookup alone touches the batch's
    ids), on the first stage and on the last alike."""
    ranks = _world(2, tmp_path_factory)
    key = "mod0.word_embeddings.weight"
    w0 = _weights()[_wkey(True, False, 2)][key]
    w1 = worker.assemble(ranks, "tied-gpipe", key)
    assert np.any(np.abs(w1 - w0) > 0, axis=1).all()
    assert np.unique(_batches()["pp"][0]).size < w0.shape[0]


def test_tp_pipe_checkpoint_resumes_bit_for_bit_and_reshards(
        tmp_path_factory):
    ranks = _world(4, tmp_path_factory)
    name = "tp2-resume"
    for r in ranks:
        got = r["train"][name]
        assert got["again"] == got["after"]
        for k, (v, _) in got["after_params"].items():
            np.testing.assert_array_equal(got["again_params"][k][0], v,
                                          err_msg=k)
    # the {"pipe": 2, "data": 2} trainer holds the saved logical arrays
    for k in ranks[0]["train"][name]["params"]:
        np.testing.assert_array_equal(
            worker.assemble(ranks, name, k, field="resharded",
                            coord="resharded_coord"),
            worker.assemble(ranks, name, k), err_msg=k)


def test_nan_on_one_stage_skips_on_every_rank_and_no_slice_diverges(
        tmp_path_factory):
    ranks = _world(4, tmp_path_factory)
    name = "tp2-nan"
    for r in ranks:
        got = r["train"][name]
        assert got["skipped"] == 1
        assert np.isfinite(got["losses"]).all()
        # slices differ across model and pipe by design: nothing to report
        assert got["divergence"] == [[]] * STEPS
    # the skipped step left every rank's state as it was: step 3 starts
    # where step 2 (the skipped one) began, so losses 2 and 3 are equal
    losses = ranks[0]["train"][name]["losses"]
    assert losses[1] != losses[0] and losses[2] == losses[1]
    for k in ranks[0]["train"][name]["params"]:
        worker.assemble(ranks, name, k)


def test_segments_and_the_sep_plan_raise_as_the_reference():
    descs = [LayerDesc(tnn.Linear, 4, 4) for _ in range(4)]
    assert SegmentLayers(descs, 2).do_segment() == [0, 2, 4]
    pl = PipelineLayer(descs, num_stages=2)
    assert [n for n, _ in pl.named_parameters()] == \
        ["stack0.weight", "stack0.bias"]
    assert pl.uniform_split() is not None
    # no stackable run: no decomposition, and a sep axis refuses it
    odd = PipelineLayer([LayerDesc(tnn.Linear, 4, 4),
                         LayerDesc(tnn.Linear, 4, 8)], num_stages=2)
    assert odd.uniform_split() is None

    class _Hcg:
        def get_pipe_parallel_world_size(self):
            return 2
    pp = PipelineParallel(odd, _Hcg())
    with pytest.raises(NotImplementedError, match="uniform_split"):
        ParallelTrainer(pp, SGD(0.1), lambda o, y: o.sum(), device="cpu",
                        mesh=Mesh({"pipe": 2, "sep": 2}))
