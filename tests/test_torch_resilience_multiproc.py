"""The port's resilience runtime across processes, on the CPU: gloo worlds
of ``spawn``ed ranks (``torch_resilience_worker.py``) and the port's
``SimCluster`` of subprocess hosts, each test under its own
``multihost`` timeout.

- A world of 2: a flipped bit on rank 1 is caught at the next check step,
  the diverged leaf is named, off-cadence steps issue no fingerprint
  collective, a check step exactly one MIN and one MAX (and one SUM for
  the per-rank residual digests); the quarantine vote's verdict and the
  flip's choice equal the reference's on a mesh of 2. Then a planned
  scale-down to rank 0: its remapped residual rows and the dropped norm
  equal the reference's ``remap_comm_err`` on the gathered rows (bit for
  bit, no tolerance: the same float32 rows, the same float64 sum).
- A world of 4: the SDC scenario of ``tools/chaos_smoke.py`` (a
  ``param_flip`` at step 5, a check every 2 steps): one divergence, one
  replica quarantined, every rank restored to step 4, the run completes,
  0 fingerprint collectives on off-cadence steps, and every rank ends bit
  for bit where a run without the fault ends.
- ``SimCluster``: divergent restore without faults, ``host_loss``,
  ``host_hang`` (exit 10) and the crash windows of an asynchronous save,
  with the outcome fields of the reference's chaos tests. A port host
  trains at data degree 1 (``resilience/hostsim.py``), so
  ``data_degree_final`` is 1 and ``residual_dropped_norm`` 0 after a host
  loss, where the reference's read 2 -> 1 and a positive norm.
"""
import json
import os
import pickle
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.telemetry as ref_tel
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.resilience import elastic as ref_elastic
from paddle_tpu.resilience import integrity as ref_integrity

import torch_resilience_worker as worker
from paddle_tpu_torch.distributed.checkpoint import (PENDING_PREFIX,
                                                     CheckpointManager)
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.resilience import hostsim
from paddle_tpu_torch.telemetry import flight
from torch_threads import two_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(out, name, n):
    res = {}
    for r in range(n):
        with open(os.path.join(out, f"{name}.rank{r}.pkl"), "rb") as f:
            res[r] = pickle.load(f)
    return res


def _ref_mlp(data):
    paddle.seed(7)

    class MLP(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = rnn.Linear(8, 16)
            self.l2 = rnn.Linear(16, 4)

        def forward(self, x):
            return self.l2(rnn.functional.relu(self.l1(x)))

    model = MLP()
    opt = paddle.optimizer.Momentum(0.05, momentum=0.9,
                                    parameters=model.parameters())
    return RefTrainer(model, opt, lambda out, y: jnp.mean((out - y) ** 2),
                      mesh=ref_build_mesh({"data": data}), grad_sync="int8",
                      grad_sync_block=8)


@pytest.mark.multihost(timeout=150)
def test_world_of_2_flip_detected_then_scale_down(tmp_path):
    out = str(tmp_path)
    spawn(worker.flip_world, (out,), nprocs=2, timeout=120)
    seen = _load(out, "flip", 2)
    want_flip = ref_integrity.inject_param_flip(_ref_mlp(2), seed=11, step=2)
    for r in (0, 1):
        s = seen[r]
        assert s["flip"] == want_flip and want_flip["replica"] == 1
        # steps 1..4: checks at 2 and 4 only
        assert s["fp_collectives"] == [0, 2, 0, 2]
        assert s["combined"] == [0, 1, 0, 1]
        assert s["divergence"][:3] == [[], [], []]
        assert s["divergence"][3] == [f"params['{want_flip['leaf']}']"]
        assert s["quarantine"]["outlier_replicas"] == [1]
        assert s["quarantine"]["quarantined"] == 1
        assert s["quarantine"]["action"] == "rollback"
        assert s["coords"] == {0: 0, 1: 1}
    # the reference's vote on the same two chains
    assert ref_integrity.vote_outliers({0: 1, 1: 2}, 2) == ([1], False)
    # the scale-down: rank 0's rows and the dropped norm, against the
    # reference on the gathered rows
    gathered = seen[0]["gathered"]
    assert all(np.array_equal(gathered[k], seen[1]["gathered"][k])
               for k in gathered)
    assert all(v.shape[0] == 2 and np.abs(v[1]).sum() > 0
               for v in gathered.values())
    old_reg, old_on = ref_tel.get_registry(), ref_tel.enabled()
    reg = ref_tel.Registry()
    ref_tel._set_registry(reg)
    ref_tel.enable(True)
    try:
        want = ref_elastic.remap_comm_err(dict(gathered), _ref_mlp(1))
    finally:
        ref_tel._set_registry(old_reg)
        ref_tel.enable(old_on)
    for k, v in want.items():
        assert np.array_equal(seen[0]["remapped"][k], np.asarray(v)[0])
    ref_norm = reg.to_dict()["elastic_residual_dropped_norm_total"]["series"]
    assert seen[0]["dropped_norm"] == ref_norm and sum(ref_norm.values()) > 0
    assert seen[0]["degree_after"] == 1
    assert np.isfinite(seen[0]["loss_after"])


@pytest.mark.multihost(timeout=200)
def test_world_of_4_sdc_scenario(tmp_path):
    out = str(tmp_path)
    steps = 8
    spawn(worker.sdc_world, (out, steps), nprocs=4, timeout=180)
    seen = _load(out, "sdc", 4)
    fps = {r: seen[r]["sdc"]["fingerprints"] for r in range(4)}
    for r in range(4):
        sdc, clean = seen[r]["sdc"], seen[r]["clean"]
        res = sdc["result"]
        assert sdc["fired"] == 1
        assert (res["exit_code"], res["steps_done"]) == (0, steps)
        assert res["divergences"] == 1 and res["hosts_quarantined"] == 1
        assert res["rollback_steps"] == [4]
        # off-cadence steps: no fingerprint collective; check steps: two
        for run in (sdc, clean):
            for steps_run, n in run["steps"]:
                assert n == (2 if steps_run % 2 == 0 else 0), run["steps"]
        assert clean["result"]["divergences"] == 0
        # every rank ends where the run without the fault ends
        assert fps[r] == fps[0] == clean["fingerprints"]
        assert sum(seen[r]["divergence_total"].values()) == 1
        assert seen[r]["flight_divergence"] == 1


# ---------------------------------------------------------------------------
# SimCluster
# ---------------------------------------------------------------------------

def _survivors(out):
    return [r for r in out["results"].values() if r]


@pytest.mark.multihost(timeout=180)
def test_hostsim_divergent_restore_no_faults(tmp_path):
    # no host dies here: a loose staleness bound keeps a loaded machine
    # from reading a slow heartbeat as a loss
    cluster = hostsim.SimCluster(str(tmp_path), n_hosts=3, np_spec="2:3",
                                 steps=8, hb_timeout=3.0, step_delay=0.05,
                                 device="cpu")
    cluster.seed_divergent({0: 5, 1: 3, 2: 3})
    out = cluster.run(timeout=150)
    assert out["hosts_lost"] == 0
    for h, res in out["results"].items():
        assert res is not None, (h, out["stderr"][h])
        assert res["exit_code"] == 0, (h, res)
        assert res["barrier_steps"][0] == 3
        assert res["steps_done"] == 8
        assert res["remeshes"] == 0
        assert res["disagreements"] == 1


@pytest.mark.multihost(timeout=200)
def test_hostsim_host_loss(tmp_path):
    cluster = hostsim.SimCluster(str(tmp_path), n_hosts=3, np_spec="2:3",
                                 steps=24, hb_timeout=1.0, step_delay=0.15,
                                 device="cpu")
    cluster.seed_divergent({0: 10, 1: 8, 2: 8})
    out = cluster.run(faults={1: [("host_loss", 12)]}, timeout=170)
    survivors = _survivors(out)
    assert out["hosts_lost"] == 1, out["stderr"]
    assert out["exit_codes"]["host1"] == hostsim.HOST_LOSS_EXIT
    assert len(survivors) == 2
    for r in survivors:
        assert r["exit_code"] == 0, r
        assert r["barrier_steps"][0] == 8      # min-reduced over 10, 8, 8
        assert r["remeshes"] >= 1
        assert r["disagreements"] >= 1
        assert r["steps_done"] == 24
        # a port host trains at degree 1 (module docstring)
        assert r["data_degree_final"] == 1
        assert r["residual_dropped_norm"] == 0.0


@pytest.mark.multihost(timeout=200)
def test_hostsim_host_hang(tmp_path):
    # a hang is seen later than a crash: the watchdog's deadline (2 s),
    # then the heartbeat's staleness (1 s); the survivors' pace puts that
    # well inside their run
    cluster = hostsim.SimCluster(str(tmp_path), n_hosts=3, np_spec="2:3",
                                 steps=30, hb_timeout=1.0, step_delay=0.25,
                                 hang_timeout=2.0, device="cpu")
    out = cluster.run(faults={1: [("host_hang", 6)]}, timeout=170)
    survivors = _survivors(out)
    assert out["hosts_hung"] == 1, out["stderr"]
    assert out["exit_codes"]["host1"] == hostsim.HOST_HANG_EXIT
    assert len(survivors) == 2
    for r in survivors:
        assert r["exit_code"] == 0, r
        assert r["remeshes"] >= 1 and r["steps_done"] == 30
    dumps = flight.find_dumps(os.path.join(str(tmp_path), "flight"),
                              reason="hang_watchdog")
    hosts = []
    for p in dumps:
        with open(p) as f:
            hosts.append(json.load(f)["process_index"])
    assert hosts == [1]
    merged = flight.merge_dumps(flight.find_dumps(
        os.path.join(str(tmp_path), "flight")))
    assert merged["spans"]


@pytest.mark.multihost(timeout=200)
def test_hostsim_schedule_mismatch_exits_11(tmp_path):
    cluster = hostsim.SimCluster(str(tmp_path), n_hosts=2, np_spec="2",
                                 steps=4, hb_timeout=1.0, step_delay=0.0,
                                 device="cpu")
    out = cluster.run(timeout=170, desync_hosts={1})
    for h in ("host0", "host1"):
        assert out["exit_codes"][h] == hostsim.SCHEDULE_MISMATCH_EXIT, out
        diff = out["results"][h]["schedule_diff"]
        # each host's fingerprint of its traced step: host1 hashes the
        # integrity-check step, host0 the plain one
        assert set(diff) == {"train-step"}
        fps = diff["train-step"]
        assert set(fps) == {"host0", "host1"}
        assert fps["host0"] != fps["host1"]
        assert all(len(v) == 64 for v in fps.values())


@pytest.mark.multihost(timeout=200)
def test_crash_during_async_save(tmp_path):
    """A child trains with asynchronous saves (steps 0..2 committed) and
    dies by a real SIGKILL (a) with a snapshot staged and its commit not
    started, (b) after the payload write and before the manifest. A fresh
    manager lands on step 2 with no fallback counted, (a) leaves no
    marker and no step 3, (b) its marker, and replaying step 3 clears the
    debris. Then a dirty verdict that lands while a snapshot is in flight
    keeps that snapshot off the disk."""
    import torch
    for mode in ("staged", "mid_commit"):
        d = str(tmp_path / mode)
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_resilience_worker.py"),
             "crash", d, mode], capture_output=True, text=True, timeout=150,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(HERE)))
        assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
        marker = os.path.exists(os.path.join(d, PENDING_PREFIX + "3"))
        m = CheckpointManager(d, max_to_keep=5)
        assert m.latest_valid_step() == 2
        restored = m.restore()
        assert m.last_restored_step == 2 and m.restore_fallbacks_total == 0
        if mode == "staged":
            assert not marker and 3 not in m.all_steps()
        else:
            assert marker and os.path.isdir(os.path.join(d, "3"))
        m.close()
        m2 = CheckpointManager(d, max_to_keep=5, async_commit=True)
        m2.save(3, restored)
        m2.flush()
        assert m2.latest_valid_step() == 3
        assert not os.path.exists(os.path.join(d, PENDING_PREFIX + "3"))
        m2.close()
    dirty = {"v": False}
    m = CheckpointManager(str(tmp_path / "dirty"), max_to_keep=8,
                          async_commit=True, dirty_probe=lambda: dirty["v"])
    clean = {"w": torch.arange(8.0)}
    m.save(1, clean)
    m.flush()
    m.pause_commits()
    m.save(2, {"w": clean["w"] + 1e3})
    dirty["v"] = True
    m.resume_commits()
    m.flush()
    assert m.suppressed_dirty_total == 1 and m.latest_valid_step() == 1
    assert 2 not in m.all_steps()
    dirty["v"] = False
    m.save(3, clean)
    m.flush()
    assert m.latest_valid_step() == 3 and m.accounted()
    m.close()
