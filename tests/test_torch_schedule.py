"""Collective schedules of the port's traced steps on gloo worlds of 2 and
4 (``torch_analysis_worker.py``), and the hosts' bootstrap cross-check.

Every rank traces its own programs (``staged_graph``, ``step_graph``,
``executor_family``) on fake tensors; the checks are exact (counts,
fingerprints, verdicts): a schedule is integers and names.

- ``count_fingerprint_collectives`` of the check step's graph equals the
  count of the ``all_reduce`` calls (int64, MIN/MAX) that the existing
  recorder sees in one real check step; the plain step's is 0.
- The schedule fingerprints agree across the ranks, stay the same over
  two traces, and differ between the plain and the check step.
- A step that issues one more ``all_reduce`` on rank 0 fires
  ``collective-order-divergence`` on every rank; the agreeing step on
  none.
- The planted collective programs fire their rule once each.
- LocalSGD's and the decode executors' families verify; the trainer's
  state is bit for bit the same after its traces.

The hostsim's ``--desync-schedule`` host (its fingerprint computed from
the traced check step) raises ``ScheduleMismatch`` through
``crossrank_verify``: ``test_torch_resilience_multiproc.py::
test_hostsim_schedule_mismatch_exits_11``.
"""
import pickle

import pytest

import torch_analysis_worker as worker
from paddle_tpu_torch.distributed.spawn import spawn

pytestmark = pytest.mark.multihost(timeout=300)

_RUNS = {}


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    n = request.param
    if n not in _RUNS:
        d = tmp_path_factory.mktemp(f"schedule{n}")
        spawn(worker.main, args=(str(d), n), nprocs=n, timeout=240)
        ranks = []
        for r in range(n):
            with open(d / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        _RUNS[n] = ranks
    return n, _RUNS[n]


def test_fingerprint_collectives_counted_as_recorded(world):
    n, ranks = world
    for r in ranks:
        t = r["trainer"]
        assert t["recorded"] == 2
        assert t["counts"] == {"step": 0, "step-check": t["recorded"]}


def test_fingerprints_agree_across_ranks_and_differ_by_step(world):
    n, ranks = world
    fps = [r["trainer"]["fps"] for r in ranks]
    for f in fps:
        for name in ("step", "step-check"):
            assert f[name][0] == f[name][1]      # stable over two traces
        assert f["step"][0] != f["step-check"][0]
    assert len({f["step"][0] for f in fps}) == 1
    assert len({f["step-check"][0] for f in fps}) == 1


def test_traces_leave_the_trainer_and_its_family_verifies(world):
    n, ranks = world
    for r in ranks:
        assert r["trainer"]["same_state"]
        assert r["trainer"]["family_ok"]


def test_bucketed_exchange_overlaps_in_the_model(world):
    n, ranks = world
    for r in ranks:
        t = r["trainer"]
        assert t["use_buckets"]
        ov = t["overlap"]
        assert ov["n_collectives"] > 0 and ov["collective_time"] > 0
        assert 0.0 <= ov["overlap_efficiency"] <= 1.0
        assert "exchange-not-overlapped" not in t["findings"]
        assert not any(f in ("collective-unbound-axis",
                             "collective-axis-not-in-mesh")
                       for f in t["findings"])


def test_rank_divergence_fires_on_every_rank(world):
    n, ranks = world
    for r in ranks:
        assert r["divergence"] == {"diverged": 1, "agreed": 0}


@pytest.mark.parametrize("rule", [
    "oversized-allgather", "compressed-collective-link-mismatch",
    "collective-unbound-axis", "program-family-schedule-drift"])
def test_planted_collective_programs_fire_once(world, rule):
    n, ranks = world
    for r in ranks:
        assert r["planted"][rule] == 1
        assert not r["planted"]["drift_ok"]


def test_localsgd_and_decode_families_verify(world):
    n, ranks = world
    for r in ranks:
        f = r["families"]
        assert f["localsgd_ok"] and f["decode_ok"]
        assert f["decode_members"] == ["decode", "mixed", "verify"]
        assert f["localsgd_collectives"]["no-sync"] < \
            f["localsgd_collectives"]["sync"]
    assert len({r["families"]["localsgd_fps"]["sync"] for r in ranks}) == 1
