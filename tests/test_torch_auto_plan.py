"""The port's planner (``paddle_tpu_torch/distributed/auto.py``) against the
JAX package's (``paddle_tpu/distributed/auto.py``), on the CPU.

The analytic arithmetic is the reference's, copied: over a grid of model
sizes (1e8 to 1e11 parameters), device counts (1 to 64), memories (16e9
and 80e9 bytes) and every grad-sync policy, ``plan`` and the analytic tier
of ``plan_search`` give the same plans bit for bit (``to_dict()``: degrees,
remat, policy, buckets, micro-batches, every ``MemoryEstimate`` and
``TimeBreakdown`` field, the ranking and the rationale lines), with the
link constants set the same way for both (each package's environment
overrides) and the peak FLOP/s passed to both. The staged tier runs on the
CPU with a small builder: its scores come from the traced step's overlap
model, and its memory from the traced step's peak.
"""
import itertools

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import auto as ref_auto
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh

from paddle_tpu_torch.distributed import auto
from paddle_tpu_torch.distributed import mesh as mesh_mod

LINKS = {"ICI_BPS": "4.5e11", "DCN_BPS": "5e10", "ICI_LAT_S": "1e-5",
         "DCN_LAT_S": "3e-5"}
PEAK = 9.89e14


@pytest.fixture(autouse=True)
def _links(monkeypatch):
    for k, v in LINKS.items():
        monkeypatch.setenv(f"PADDLE_TPU_{k}", v)
        monkeypatch.setenv(f"PADDLE_TPU_TORCH_{k}", v)
    ref_build_mesh({"data": 1})
    mesh_mod.build_mesh({"data": 1})


def _both(fn_ref, fn_port):
    out = []
    for fn in (fn_ref, fn_port):
        try:
            out.append(fn())
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


GRID = list(itertools.product((1e8, 1e9, 1e10, 1e11), (1, 2, 4, 8, 64),
                              (16e9, 80e9)))


@pytest.mark.parametrize("n_params,n_devices,hbm", GRID)
def test_plan_equals_the_reference(n_params, n_devices, hbm):
    kw = dict(layers=24, hidden=2048, seq_len=2048, hbm_bytes=hbm)
    ref, port = _both(
        lambda: ref_auto.plan(n_params, n_devices, **kw).to_dict(),
        lambda: auto.plan(n_params, n_devices, **kw).to_dict())
    assert port == ref


@pytest.mark.parametrize("n_params,n_devices,hbm", GRID)
def test_plan_search_analytic_tier_equals_the_reference(n_params, n_devices,
                                                        hbm):
    kw = dict(layers=24, hidden=2048, seq_len=2048, hbm_bytes=hbm,
              peak_flops=PEAK, top_k=12, policies=auto.GRAD_SYNC_POLICIES)
    ref, port = _both(
        lambda: [p.to_dict() for p in ref_auto.plan_search(
            n_params, n_devices, **kw)],
        lambda: [p.to_dict() for p in auto.plan_search(
            n_params, n_devices, **kw)])
    assert port == ref


def test_score_plan_and_resharding_cost():
    p = auto.plan(1e9, 8, hbm_bytes=80e9)
    r = ref_auto.plan(1e9, 8, hbm_bytes=80e9)
    kw = dict(layers=24, hidden=2048, seq_len=2048, global_batch=64,
              peak_flops=PEAK)
    assert auto.score_plan(p, 1e9, **kw).predicted.to_dict() == \
        ref_auto.score_plan(r, 1e9, **kw).predicted.to_dict()
    from paddle_tpu_torch.analysis import trace_program
    g = trace_program(lambda t: t * 2, torch.ones(4, 4))
    rc = auto.resharding_cost(g, mesh_mod.get_mesh(), [(("data",), ())])
    assert rc == {"n_sites": 0, "time_s": 0, "wire_bytes": 0,
                  "dcn_bytes": 0, "sites": []}


def test_hbm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is its memory")
    with pytest.raises(ValueError, match="hbm_bytes"):
        auto.plan(1e8, 1)
    with pytest.raises(ValueError, match="hbm_bytes"):
        auto.plan_search(1e8, 1)


def test_staged_tier_on_the_cpu():
    """The top analytic plans of a small model, staged by a builder that
    makes the trainer each plan asks for (one rank): the staged score is
    the traced step's makespan at the given peak."""
    from paddle_tpu_torch import framework, nn, optimizer
    from paddle_tpu_torch.analysis import cost
    from paddle_tpu_torch.distributed.engine import ParallelTrainer

    def builder(plan):
        framework.seed(0)
        model = nn.Sequential(nn.Linear(64, 256), nn.ReLU(),
                              nn.Linear(256, 64))
        tr = ParallelTrainer(
            model, optimizer.AdamW(1e-3),
            lambda o, y: ((o - y) ** 2).mean(),
            mesh=mesh_mod.build_mesh({"data": 1}), device="cpu",
            **{k: v for k, v in plan.apply().items()
               if k in ("remat", "accumulate_steps")})
        x = torch.randn(8, 64)
        return tr, x, torch.zeros(8, 64)

    plans = auto.plan_search(33e3, 1, layers=2, hidden=64, seq_len=1,
                             batch_per_device=8, hbm_bytes=1e9,
                             peak_flops=1e12, top_k=4, stage_top_k=3,
                             builder=builder)
    staged = [p for p in plans if p.predicted.tier == "staged"]
    assert len(staged) == 3
    tr, x, y = builder(staged[0])
    graph = tr.staged_graph(x, y)
    want = cost.replay_overlap(cost.overlap_plan(graph, tr.mesh),
                               peak_flops=1e12)["makespan"]
    assert any(np.isclose(p.predicted.total, want, rtol=1e-12)
               for p in staged)
    assert all(p.per_device.source == "peak-live-bytes/chip"
               for p in staged)
    assert [p.predicted.total for p in staged] == \
        sorted(p.predicted.total for p in staged)
