"""The port's elastic runtime, membership manager, launcher and filesystem
clients, on the CPU.

- ``ElasticManager`` (file-backed membership) and ``FileCoordinator``
  (allgather and barrier over a directory), as the reference's tests drive
  them (``tests/test_elastic_runtime.py``, ``tests/test_elastic_autockpt.py``).
- ``coordinated_restore`` over hosts (threads) with divergent newest
  steps; ``restore_divergence``; a divergence past retention raises.
- ``remap_comm_err`` bit for bit against the reference's on the same
  replica-major host arrays: scale up, scale down, a changed shape, a
  vanished and a missing key; every new rank's row and the dropped norm
  (``elastic_residual_dropped_norm_total``, the same float: both sum in
  float64 in the same key order). No tolerance.
- ``ElasticRuntime`` re-entry in ``run_resilient`` with ``host_join``,
  the remesh budget, a plain manager's exit 75, ``HostLost``; the supplied
  schedule fingerprints' cross-check.
- ``python -m paddle_tpu_torch.distributed.launch``: the environment, a
  gloo world started from it, fail fast, the relaunch, SIGTERM forwarded.
- ``LocalFS`` and ``HDFSClient`` over a fake ``hadoop`` script (a Python
  file standing in for ``hadoop fs`` over a local directory, failing its
  first calls to exercise the retry).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.telemetry as ref_tel
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.resilience import elastic as ref_elastic

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
from paddle_tpu_torch.distributed.fleet.fs import (ExecuteError,
                                                   FSFileExistsError,
                                                   FSFileNotExistsError,
                                                   HDFSClient, LocalFS)
from paddle_tpu_torch.resilience import faults, hostsim, run_resilient
from paddle_tpu_torch.resilience.elastic import (CoordinatorTimeout,
                                                 ElasticRuntime,
                                                 FileCoordinator,
                                                 ScheduleMismatch,
                                                 coordinated_restore,
                                                 crossrank_verify,
                                                 data_parallel_remesh_fn,
                                                 remap_comm_err)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.reset()


@pytest.fixture()
def fresh_registry():
    old_reg, old_on = telemetry.get_registry(), telemetry.enabled()
    reg = telemetry.Registry()
    telemetry._set_registry(reg)
    telemetry.enable(True)
    yield reg
    telemetry._set_registry(old_reg)
    telemetry.enable(old_on)


def _counter_total(reg, name):
    return sum(reg.to_dict().get(name, {}).get("series", {}).values())


def _loader(n=4, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 8).astype(np.float32),
             rng.randn(batch, 4).astype(np.float32)) for _ in range(n)]


def _threads(fn, args_list):
    ts = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)


# ---------------------------------------------------------------------------
# ElasticManager
# ---------------------------------------------------------------------------

def test_parse_np():
    assert ElasticManager._parse_np("4") == (4, 4)
    assert ElasticManager._parse_np("2:3") == (2, 3)
    assert ElasticManager._parse_np("0") == (0, 0)


def test_disabled_without_server():
    em = ElasticManager(elastic_server=None, np=2)
    assert not em.enable
    assert em.watch(proc_alive=lambda: True) == ElasticStatus.HOLD
    assert em.watch(proc_alive=lambda: False) == ElasticStatus.COMPLETED


def test_environment_contract(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_SERVER", str(tmp_path / "kv"))
    monkeypatch.setenv("PADDLE_ELASTIC_JOB_ID", "envjob")
    monkeypatch.setenv("PADDLE_ELASTIC_NP", "2:3")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "5")
    monkeypatch.delenv("POD_IP", raising=False)
    em = ElasticManager()
    try:
        assert em.enable and (em.np_min, em.np_max) == (2, 3)
        assert em.host == "rank-5" and em.job_id == "envjob"
        em.register()
        assert em.hosts() == ["rank-5"]
    finally:
        em.close()


def test_membership_lifecycle_and_transitions(tmp_path):
    kv = str(tmp_path / "kv")
    a = ElasticManager(elastic_server=kv, job_id="j1", np=2, host="hostA")
    b = ElasticManager(elastic_server=kv, job_id="j1", np=2, host="hostB")
    try:
        a.register()
        assert a.watch() == ElasticStatus.RESTART       # 1 < np_min
        b.register()
        assert a.hosts() == ["hostA", "hostB"]
        assert a.wait(interval=0.01, max_wait=2)
        assert a.watch() == ElasticStatus.HOLD
        b.deregister()
        assert a.watch() == ElasticStatus.RESTART
        a.deregister()
        assert a.watch() == ElasticStatus.EXIT
    finally:
        a.close()
        b.close()


def test_np_range(tmp_path):
    kv = str(tmp_path / "kv")
    ms = [ElasticManager(elastic_server=kv, job_id="j2", np="1:2",
                         host=f"h{i}") for i in range(3)]
    try:
        for m in ms:
            m.register()
        assert ms[0].watch() == ElasticStatus.RESTART   # 3 > max
        ms[2].deregister()
        assert ms[0].watch() == ElasticStatus.HOLD
    finally:
        for m in ms:
            m.close()


def test_stale_member_reaped_in_watch(tmp_path):
    em = ElasticManager(elastic_server=str(tmp_path), job_id="j", np="1:3",
                        host="a", timeout=5.0)
    try:
        em.register()
        stale = em._member_file("b")
        with open(stale, "w") as f:
            f.write("0")
        old = time.time() - 60
        os.utime(stale, (old, old))
        assert em.hosts() == ["a"]
        assert os.path.exists(stale)
        assert em.watch() == ElasticStatus.HOLD
        assert not os.path.exists(stale)
    finally:
        em.close()


def test_close_restores_signal_handlers_and_deregisters(tmp_path):
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    em = ElasticManager(elastic_server=str(tmp_path), job_id="j", np=1,
                        host="a")
    em.register()
    assert signal.getsignal(signal.SIGTERM) == em.signal_handler
    member = em._member_file()
    assert os.path.exists(member)
    em.close()
    assert signal.getsignal(signal.SIGTERM) == prev_term
    assert signal.getsignal(signal.SIGINT) == prev_int
    assert not os.path.exists(member)


# ---------------------------------------------------------------------------
# FileCoordinator and the restore barrier
# ---------------------------------------------------------------------------

def test_allgather_three_participants_and_generations(tmp_path):
    hosts = ["a", "b", "c"]
    out = {}

    def run(h, i):
        coord = FileCoordinator(str(tmp_path), job_id="j", host=h, poll=0.01)
        out[h] = [coord.allgather("vals", i + 10 * r, lambda: hosts,
                                  timeout=20.0) for r in range(2)]

    _threads(run, [(h, i) for i, h in enumerate(hosts)])
    for h in hosts:
        assert out[h] == [{"a": 0, "b": 1, "c": 2},
                          {"a": 10, "b": 11, "c": 12}]


def test_coordinator_timeout_and_shrink(tmp_path):
    coord = FileCoordinator(str(tmp_path), job_id="j", host="a", poll=0.01)
    with pytest.raises(CoordinatorTimeout):
        coord.barrier("never", lambda: ["a", "ghost"], timeout=0.3)
    live = ["a", "ghost"]

    def shrink():
        time.sleep(0.2)
        live.remove("ghost")

    t = threading.Thread(target=shrink)
    t.start()
    got = coord.allgather("shrink", 7, lambda: list(live), timeout=20.0)
    t.join()
    assert got == {"a": 7}


def test_abandoned_round_is_skipped(tmp_path):
    coord = FileCoordinator(str(tmp_path), job_id="j", host="a", poll=0.01,
                            stale_after=0.5)
    dead = os.path.join(coord.root, "r", "0")
    os.makedirs(dead)
    with open(os.path.join(dead, "ghost.json"), "w") as f:
        json.dump({"v": 99}, f)
    old = time.time() - 60
    os.utime(os.path.join(dead, "ghost.json"), (old, old))
    assert coord.allgather("r", 1, lambda: ["a"], timeout=5.0) == {"a": 1}
    assert os.path.exists(os.path.join(coord.root, "r", "1", "a.json"))


def _tiny_state(v=0.0):
    import torch
    return {"w": torch.full((4,), float(v))}


def _seed_manager(path, upto, keep=None):
    mgr = CheckpointManager(str(path), max_to_keep=keep or upto + 1)
    for s in range(upto + 1):
        mgr.save(s, _tiny_state(s))
    return mgr


def test_min_reduce_across_divergent_hosts(tmp_path, fresh_registry):
    upto = {"a": 2, "b": 1, "c": 1}
    mgrs = {h: _seed_manager(tmp_path / h, s) for h, s in upto.items()}
    hosts = sorted(upto)
    out = {}

    def run(h):
        coord = FileCoordinator(str(tmp_path / "coord"), job_id="j", host=h,
                                poll=0.01)
        out[h] = coordinated_restore(mgrs[h], _tiny_state(), coord,
                                     lambda: hosts, timeout=30.0)

    _threads(run, [(h,) for h in hosts])
    for h in hosts:
        restored, common = out[h]
        assert common == 1 and restored["w"].tolist() == [1.0] * 4
    assert _counter_total(fresh_registry,
                          "elastic_restore_barrier_total") == 3
    assert _counter_total(fresh_registry,
                          "elastic_step_disagreements_total") == 3
    for m in mgrs.values():
        m.close()


def test_fresh_start_when_any_host_is_empty(tmp_path):
    mgrs = {"a": _seed_manager(tmp_path / "a", 2),
            "b": CheckpointManager(str(tmp_path / "b"))}
    out = {}

    def run(h):
        coord = FileCoordinator(str(tmp_path / "coord"), job_id="j", host=h,
                                poll=0.01)
        out[h] = coordinated_restore(mgrs[h], _tiny_state(), coord,
                                     lambda: ["a", "b"], timeout=30.0)

    _threads(run, [("a",), ("b",)])
    assert out == {"a": (None, -1), "b": (None, -1)}
    for m in mgrs.values():
        m.close()


def test_restore_divergence_and_an_async_commit_in_flight(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"), max_to_keep=4,
                            async_commit=True, commit_delay=0.2)
    for s in range(3):
        if s:
            mgr.flush()
        mgr.save(s, _tiny_state(s))
    coord = FileCoordinator(str(tmp_path / "coord"), job_id="j", host="a",
                            poll=0.01)
    with faults.inject("restore_divergence"):
        # the barrier flushes the commit of step 2 before reporting, then
        # the fault reports one step older
        restored, common = coordinated_restore(
            mgr, _tiny_state(), coord, lambda: ["a"], timeout=10.0)
    assert mgr.latest_valid_step() == 2
    assert common == 1 and restored["w"].tolist() == [1.0] * 4
    mgr.close()


def test_divergence_beyond_retention_raises(tmp_path):
    mgrs = {"a": _seed_manager(tmp_path / "a", 4, keep=2),
            "b": _seed_manager(tmp_path / "b", 1)}
    errs = {}

    def run(h):
        coord = FileCoordinator(str(tmp_path / "coord"), job_id="j", host=h,
                                poll=0.01)
        try:
            coordinated_restore(mgrs[h], _tiny_state(), coord,
                                lambda: ["a", "b"], timeout=2.0)
        except (RuntimeError, OSError) as e:
            errs[h] = e

    _threads(run, [("a",), ("b",)])
    assert "a" in errs and "retention" in str(errs["a"])
    for m in mgrs.values():
        m.close()


def test_schedule_fingerprints_cross_check(tmp_path, fresh_registry):
    out = {}

    def run(h, fp):
        coord = FileCoordinator(str(tmp_path), job_id="j", host=h, poll=0.01)
        try:
            out[h] = crossrank_verify(coord, {"train-step": fp},
                                      lambda: ["a", "b"], timeout=20.0)
        except ScheduleMismatch as e:
            out[h] = e

    _threads(run, [("a", "x"), ("b", "x")])
    assert out["a"] == out["b"] == {"a": {"train-step": "x"},
                                    "b": {"train-step": "x"}}
    _threads(run, [("a", "plain"), ("b", "check")])
    assert isinstance(out["a"], ScheduleMismatch)
    assert out["a"].diff == {"train-step": {"a": "plain", "b": "check"}}
    assert _counter_total(fresh_registry,
                          "collective_schedule_mismatch_total") == 2


# ---------------------------------------------------------------------------
# remap_comm_err against the reference
# ---------------------------------------------------------------------------

def _ref_trainer(data):
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


def _old_rows(r_old, case):
    rs = np.random.RandomState(10 * r_old + len(case))
    shapes = {"l1.weight": (8, 16), "l1.bias": (16,), "l2.weight": (16, 4),
              "l2.bias": (4,)}
    old = {k: rs.randn(r_old, *s).astype(np.float32)
           for k, s in shapes.items()}
    if case == "changed_shape":
        old["l2.weight"] = rs.randn(r_old, 4, 16).astype(np.float32)
    if case == "vanished_and_missing":
        old["gone.weight"] = rs.randn(r_old, 3).astype(np.float32)
        del old["l1.bias"]
    return old


@pytest.mark.parametrize("r_old, r_new, case", [
    (2, 4, "plain"), (4, 2, "plain"), (2, 1, "plain"), (3, 3, "plain"),
    (4, 2, "changed_shape"), (2, 2, "vanished_and_missing")])
def test_remap_comm_err_equals_the_reference(r_old, r_new, case):
    import torch
    old = _old_rows(r_old, case)
    old_ref, old_port = ref_tel.get_registry(), telemetry.get_registry()
    on_ref, on_port = ref_tel.enabled(), telemetry.enabled()
    regs = (ref_tel.Registry(), telemetry.Registry())
    ref_tel._set_registry(regs[0])
    telemetry._set_registry(regs[1])
    ref_tel.enable(True)
    telemetry.enable(True)
    try:
        ref_tr = _ref_trainer(r_new)
        want = {k: np.asarray(v) for k, v in
                ref_elastic.remap_comm_err(dict(old), ref_tr).items()}
        names = list(ref_tr.comm_err_specs)
        got = {}
        for rank in range(r_new):
            # a rank of a world of r_new: its own rows, its place
            stand_in = types.SimpleNamespace(
                n_data=r_new, data_rank=rank,
                comm_err={k: torch.zeros(want[k].shape[1:]) for k in names})
            got[rank] = {k: v.numpy().copy() for k, v in
                         remap_comm_err(dict(old), stand_in).items()}
        for k in names:
            assert np.array_equal(np.stack([got[r][k] for r in
                                            range(r_new)]), want[k])
        ref_norm = regs[0].to_dict().get(
            "elastic_residual_dropped_norm_total", {}).get("series", {})
        port_norm = regs[1].to_dict().get(
            "elastic_residual_dropped_norm_total", {}).get("series", {})
        # each rank counts the same norm, as the reference's one process
        assert port_norm == {k: v * r_new for k, v in ref_norm.items()}
        if r_old > r_new or case != "plain":
            assert ref_norm
    finally:
        ref_tel._set_registry(old_ref)
        telemetry._set_registry(old_port)
        ref_tel.enable(on_ref)
        telemetry.enable(on_port)


# ---------------------------------------------------------------------------
# ElasticRuntime in run_resilient
# ---------------------------------------------------------------------------

class _CountingLoader:
    def __init__(self, batches):
        self.batches = batches
        self.fetched = []

    def __iter__(self):
        for i, b in enumerate(self.batches):
            self.fetched.append(i)
            yield b


def _runtime(tmp_path, max_remeshes=2):
    em = ElasticManager(elastic_server=str(tmp_path / "kv"), job_id="j",
                        np="1:4", host="h0", timeout=10.0)
    em.register()
    runtime = ElasticRuntime(
        em, remesh_fn=data_parallel_remesh_fn(
            str(tmp_path / "rs"), degrees_fn=lambda hosts: {"data": 1}),
        max_remeshes=max_remeshes, poll=0.01, stabilize_polls=2)
    return em, runtime


def test_host_join_remeshes_in_place_and_completes(tmp_path):
    em, runtime = _runtime(tmp_path)
    tr = hostsim._tiny_trainer(device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    loader = _CountingLoader(_loader(n=4))
    try:
        with faults.inject("host_join", at_step=2):
            res = run_resilient(tr, loader, 6, manager=mgr, save_every=1,
                                elastic=runtime)
        assert (res.exit_code, res.status, res.steps_done) == \
            (0, "completed", 6)
        assert res.remeshes == 1 and tr.mesh.shape["data"] == 1
        # the entry barrier (a fresh start) and the re-entry at the drain
        assert res.barrier_steps == [-1, 1]
        # the cursor resumed from the checkpoint, not rewound
        assert loader.fetched == [0, 1, 0, 1, 2, 3, 0, 1]
        assert any(float(v.abs().sum()) > 0 for v in tr.comm_err.values())
    finally:
        em.close()
        mgr.close()


def test_remesh_budget_spent_exits_75(tmp_path):
    em, runtime = _runtime(tmp_path, max_remeshes=0)
    tr = hostsim._tiny_trainer(device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    try:
        with faults.inject("host_join", at_step=1):
            res = run_resilient(tr, _loader(), 5, manager=mgr, save_every=1,
                                elastic=runtime)
        assert (res.exit_code, res.status, res.remeshes) == \
            (75, "restart", 0)
        assert mgr.latest_valid_step() == 0
    finally:
        em.close()
        mgr.close()


def test_plain_manager_restart_exits_75_and_host_loss_unwinds():
    class FakeElastic:
        def watch(self):
            return ElasticStatus.RESTART

    tr = hostsim._tiny_trainer(device="cpu")
    res = run_resilient(tr, _loader(), 4, elastic=FakeElastic())
    assert (res.exit_code, res.status, res.remeshes, res.barrier_steps) == \
        (75, "restart", 0, [])
    with faults.inject("host_loss", at_step=1):
        with pytest.raises(faults.HostLost):
            run_resilient(tr, _loader(), 4)


def test_elastic_true_builds_the_manager_from_the_environment(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_SERVER", str(tmp_path / "kv"))
    monkeypatch.setenv("PADDLE_ELASTIC_NP", "2")
    monkeypatch.setenv("POD_IP", "me")
    tr = hostsim._tiny_trainer(device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    prev = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    member = ElasticManager()
    member.register()
    try:
        # one live member of an np=2 job: the first watch says RESTART
        res = run_resilient(tr, _loader(), 4, manager=mgr, elastic=True)
    finally:
        member.close()
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])
        mgr.close()
    assert (res.exit_code, res.status) == (75, "restart")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _launch_cmd(args):
    return [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"] \
        + args


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_launch_sets_the_environment_and_starts_a_gloo_world(tmp_path):
    script = _write(tmp_path, "worker.py", """
        import os
        import torch
        import torch.distributed as dist
        from paddle_tpu_torch.distributed import env
        rank = int(os.environ["RANK"])
        assert os.environ["PADDLE_TRAINER_ID"] == str(rank)
        assert os.environ["WORLD_SIZE"] == os.environ["PADDLE_TRAINERS_NUM"]
        assert os.environ["LOCAL_RANK"] == str(rank)
        eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
        assert os.environ["PADDLE_CURRENT_ENDPOINT"] == eps[rank]
        env.init_parallel_env(device="cpu")
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        assert t.item() == 3.0 and env.get_world_size() == 2
        dist.destroy_process_group()
        print(f"rank {rank} ok")
    """)
    r = subprocess.run(_launch_cmd(["--nproc_per_node", "2", "--log_dir",
                                    str(tmp_path / "logs"), script]),
                       capture_output=True, text=True, env=_env(),
                       cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0",
                                                     "workerlog.1"]
    assert "rank 1 ok" in (tmp_path / "logs" / "workerlog.1").read_text()


def test_launch_fails_fast_and_relaunches(tmp_path):
    bad = _write(tmp_path, "bad.py", """
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(30)
    """)
    r = subprocess.run(_launch_cmd(["--nproc_per_node", "2", bad]),
                       capture_output=True, text=True, env=_env(),
                       cwd=str(tmp_path), timeout=60)
    assert r.returncode == 3 and "rank 1 exited with 3" in r.stderr
    flaky = _write(tmp_path, "flaky.py", """
        import os, sys
        flag = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "restarted.flag")
        if os.environ["RANK"] == "0" and not os.path.exists(flag):
            open(flag, "w").close()
            sys.exit(7)
    """)
    r = subprocess.run(_launch_cmd(["--nproc_per_node", "2",
                                    "--max_restarts", "2", flaky]),
                       capture_output=True, text=True, env=_env(),
                       cwd=str(tmp_path), timeout=60)
    assert r.returncode == 0, r.stderr
    assert "elastic restart 1/2" in r.stderr


def test_launch_forwards_sigterm(tmp_path):
    script = _write(tmp_path, "drain.py", f"""
        import os, signal, sys, time
        d = {str(tmp_path)!r}
        rank = os.environ["RANK"]

        def drain(signum, frame):
            open(os.path.join(d, "term." + rank), "w").close()
            sys.exit(143)

        signal.signal(signal.SIGTERM, drain)
        open(os.path.join(d, "ready." + rank), "w").close()
        time.sleep(60)
    """)
    p = subprocess.Popen(_launch_cmd(["--nproc_per_node", "2", script]),
                         env=_env(), cwd=str(tmp_path),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                (tmp_path / f"ready.{r}").exists() for r in "01"):
            time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        p.wait(30)
    finally:
        if p.poll() is None:
            p.kill()
    assert all((tmp_path / f"term.{r}").exists() for r in "01")


# ---------------------------------------------------------------------------
# filesystem clients
# ---------------------------------------------------------------------------

def test_localfs_roundtrip(tmp_path):
    fs = LocalFS()
    d = str(tmp_path / "d")
    fs.mkdirs(d)
    assert fs.is_dir(d) and fs.is_exist(d)
    f = os.path.join(d, "a.txt")
    fs.touch(f)
    assert fs.is_file(f)
    with pytest.raises(FSFileExistsError):
        fs.touch(f, exist_ok=False)
    assert fs.ls_dir(d) == ([], ["a.txt"])
    f2 = os.path.join(d, "b.txt")
    fs.mv(f, f2)
    assert fs.is_file(f2) and not fs.is_exist(f)
    with pytest.raises(FSFileNotExistsError):
        fs.mv(f, f2)
    src = str(tmp_path / "src.bin")
    with open(src, "wb") as fh:
        fh.write(b"payload")
    fs.upload(src, os.path.join(d, "up.bin"))
    assert open(os.path.join(d, "up.bin"), "rb").read() == b"payload"
    fs.delete(d)
    assert not fs.is_exist(d)
    assert fs.ls_dir(str(tmp_path / "missing")) == ([], [])


_FAKE_HADOOP = '''#!{python}
"""A stand-in for `hadoop fs` over the local directory {root!r}; the
first {fail} calls fail as a namenode hiccup would."""
import os, shutil, sys
root = {root!r}
count = os.path.join(root, ".calls")
n = int(open(count).read()) if os.path.exists(count) else 0
open(count, "w").write(str(n + 1))
if n < {fail}:
    sys.stderr.write("ls: Call From host failed on connection exception\\n")
    sys.exit(2)
args = sys.argv[1:]
assert args[0] == "fs"
args = args[1:]
while args[0] == "-D":                  # -D key=value configs
    args = args[2:]
op, rest = args[0], [a for a in args[1:] if not a.startswith("-")]
flags = [a for a in args[1:] if a.startswith("-")]
p = lambda x: os.path.join(root, x.lstrip("/"))
if op == "-mkdir":
    os.makedirs(p(rest[0]), exist_ok=True)
elif op == "-test":
    f = flags[0]
    ok = {{"-e": os.path.exists, "-f": os.path.isfile,
          "-d": os.path.isdir}}[f](p(rest[0]))
    sys.stderr.write("WARN util.NativeCodeLoader: Unable to load native\\n")
    sys.exit(0 if ok else 1)
elif op == "-ls":
    for name in sorted(os.listdir(p(rest[0]))):
        full = os.path.join(p(rest[0]), name)
        kind = "d" if os.path.isdir(full) else "-"
        print(kind + "rw-r--r--   1 u g 0 2024-01-01 00:00 /" + name)
elif op == "-touchz":
    open(p(rest[0]), "a").close()
elif op == "-put":
    shutil.copy(rest[0], p(rest[1]))
elif op == "-get":
    shutil.copy(p(rest[0]), rest[1])
elif op == "-rm":
    t = p(rest[0])
    shutil.rmtree(t) if os.path.isdir(t) else (
        os.remove(t) if os.path.exists(t) else None)
elif op == "-mv":
    os.rename(p(rest[0]), p(rest[1]))
else:
    sys.exit(255)
'''


def _fake_hadoop(tmp_path, fail):
    home = tmp_path / "hadoop_home"
    (home / "bin").mkdir(parents=True)
    root = tmp_path / "hdfs"
    root.mkdir()
    script = home / "bin" / "hadoop"
    script.write_text(_FAKE_HADOOP.format(python=sys.executable,
                                          root=str(root), fail=fail))
    script.chmod(0o755)
    return str(home), root


def test_hdfs_client_over_a_fake_hadoop(tmp_path):
    home, root = _fake_hadoop(tmp_path, fail=2)
    c = HDFSClient(hadoop_home=home, configs={"fs.default.name": "x"},
                   time_out=10_000, sleep_inter=10)
    c.mkdirs("/ckpt")                       # two failures, then success
    assert int((root / ".calls").read_text()) == 3
    assert c.is_dir("/ckpt") and not c.is_exist("/nope")
    src = tmp_path / "w.bin"
    src.write_bytes(b"weights")
    c.upload(str(src), "/ckpt/w.bin")
    c.touch("/ckpt/mark")
    with pytest.raises(FSFileExistsError):
        c.touch("/ckpt/mark", exist_ok=False)
    assert c.ls_dir("/ckpt") == ([], ["mark", "w.bin"])
    c.mv("/ckpt/w.bin", "/ckpt/v.bin")
    dst = tmp_path / "back.bin"
    c.download("/ckpt/v.bin", str(dst))
    assert dst.read_bytes() == b"weights"
    c.delete("/ckpt")
    assert not c.is_exist("/ckpt")


def test_hdfs_client_gives_up_after_its_time_out(tmp_path):
    home, _ = _fake_hadoop(tmp_path, fail=1000)
    c = HDFSClient(hadoop_home=home, time_out=200, sleep_inter=50)
    t0 = time.time()
    with pytest.raises(ExecuteError, match="connection"):
        c.mkdirs("/x")
    assert time.time() - t0 < 5
    with pytest.raises(ExecuteError):
        HDFSClient(hadoop_home=str(tmp_path / "none")).mkdirs("/x")
