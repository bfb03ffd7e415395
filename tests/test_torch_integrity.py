"""The port's ``paddle_tpu_torch/resilience/integrity.py`` against the
JAX package's on the same values, on the CPU.

- Content digests: float32, bfloat16, integer and bool arrays, 0-d and
  strided ones, given as tensors and as numpy arrays; the tree's dotted
  keys and ``compare_digests``.
- Fingerprints: ``fingerprint_array`` bit for bit against the
  reference's for float32, bfloat16, float16, int32, int64, int8, bool,
  float64 and uint8, at sizes 0, 1, 1023, 1024, 1025 and odd multi-chunk
  sizes, with NaN payloads, infinities and -0.0 (the reference runs with
  64-bit types on for int64 and float64, which it would otherwise narrow
  to 32 bits); ``fingerprint_tree``'s keystr keys; the engine's check-step
  fingerprints of its own state against the reference's function on the
  same values. Tolerance: none, every value is an integer modulo 2**32.
- ``vote_outliers`` and ``inject_param_flip``'s choice (leaf, replica,
  element, bit) equal the reference's for the same chains, seed and step
  (the trainers at data degree 1 on both sides, the reference's MLP).
- ``HangWatchdog``; ``replay_step``'s four verdicts; the fault kinds.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.resilience import integrity as ref

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.nn.layer import set_trainer_state_from_numpy
from paddle_tpu_torch.resilience import faults, hostsim, integrity
from paddle_tpu_torch.resilience import run_resilient


def _cases():
    rs = np.random.RandomState(0)
    return {
        "float32": rs.randn(16, 8).astype(np.float32),
        "bfloat16": rs.randn(5, 3).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        "int32": rs.randint(-9, 9, (7,)).astype(np.int32),
        "int64": np.arange(12, dtype=np.int64).reshape(3, 4),
        "bool": rs.rand(6) > 0.5,
        "0-d float32": np.array(3.25, np.float32),
        "0-d int64": np.int64(7),
        "empty": np.zeros((0, 4), np.float32),
    }


def _tensor(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(_cases()))
def test_digest_equals_the_reference(name):
    a = _cases()[name]
    want = ref.array_digest(a)
    if np.asarray(a).dtype != np.int64:   # jax keeps int64 as int32
        assert ref.array_digest(jnp.asarray(a)) == want
    assert integrity.array_digest(_tensor(a)) == want
    assert integrity.array_digest(a) == want


def test_strided_tensor_hashes_its_row_major_values():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    t = torch.from_numpy(a.copy()).t()           # a transposed view
    assert integrity.array_digest(t) == ref.array_digest(jnp.asarray(a.T))


def test_tree_digests_dotted_keys_and_compare():
    tree = {"params": {"w": torch.arange(6.0), "b": {"c": torch.ones(3)}},
            "step": torch.tensor(3, dtype=torch.int32)}
    d1 = integrity.tree_digests(tree)
    assert set(d1) == {"params.w", "params.b.c", "step"}
    assert d1["params.w"] == ref.array_digest(jnp.arange(6.0,
                                                         dtype=jnp.float32))
    tree["params"]["w"] = tree["params"]["w"] + 1
    d2 = integrity.tree_digests(tree)
    assert integrity.compare_digests(d1, d2) == ["params.w"]
    assert integrity.compare_digests(d1, d1) == []
    assert integrity.compare_digests({"x": "a"}, {}) == []


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

FP_DTYPES = ("float32", "bfloat16", "float16", "int32", "int64", "int8",
             "bool", "float64", "uint8")
FP_SIZES = (0, 1, 1023, 1024, 1025, 3077)


def _fp_array(dtype, n, seed=0):
    rs = np.random.RandomState(seed + n)
    a = rs.randn(n) * 300
    if dtype == "bool":
        return a > 0
    if dtype == "bfloat16":
        a = a.astype(np.float32).astype(ml_dtypes.bfloat16)
    else:
        a = a.astype(dtype)
    if dtype.startswith("float") or dtype == "bfloat16":
        specials = [np.nan, -0.0, np.inf, -np.inf]
        a[:min(n, 4)] = specials[:min(n, 4)]
    return a


def _fp_tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        # the same bits, NaN payloads included (no conversion)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ref_fp(a):
    with jax.enable_x64(True):
        return int(ref.fingerprint_array(jnp.asarray(a)))


@pytest.mark.parametrize("n", FP_SIZES)
@pytest.mark.parametrize("dtype", FP_DTYPES)
def test_fingerprint_equals_the_reference(dtype, n):
    a = _fp_array(dtype, n)
    t = _fp_tensor(a)
    got = integrity.fingerprint_array(t)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == _ref_fp(a)


def test_fingerprint_sees_nan_payloads_and_signed_zero():
    base = np.zeros(2048, np.float32)
    quiet = base.copy()
    quiet[5] = np.nan
    payload = quiet.copy()
    payload.view(np.uint32)[5] |= 1          # another NaN payload
    negzero = base.copy()
    negzero[7] = -0.0
    fps = set()
    for a in (base, quiet, payload, negzero):
        want = _ref_fp(a)
        assert int(integrity.fingerprint_array(torch.from_numpy(a))) == want
        fps.add(want)
    assert len(fps) == 4


def test_fingerprint_of_a_strided_view_and_numpy_input():
    a = np.arange(40 * 33, dtype=np.float32).reshape(40, 33)
    t = torch.from_numpy(a.copy()).t()
    assert int(integrity.fingerprint_array(t)) == _ref_fp(a.T)
    assert int(integrity.fingerprint_array(a)) == _ref_fp(a)
    for chunk in (7, 64):
        with jax.enable_x64(True):
            want = int(ref.fingerprint_array(jnp.asarray(a), chunk=chunk))
        assert int(integrity.fingerprint_array(a, chunk=chunk)) == want


def test_fingerprint_tree_keys_are_the_references_keystr():
    rs = np.random.RandomState(1)
    tree = {"params": {"l2.weight": rs.randn(3, 4).astype(np.float32),
                       "l1.bias": rs.randn(5).astype(np.float32)},
            "opt": {"step": np.int32(3),
                    "slots": {"l1.bias": {"velocity":
                                          rs.randn(5).astype(np.float32)}}}}
    want = {k: int(v) for k, v in ref.fingerprint_tree(tree).items()}
    got = integrity.fingerprint_tree(
        {"params": {k: torch.from_numpy(v) for k, v in
                    tree["params"].items()},
         "opt": {"step": torch.tensor(3, dtype=torch.int32),
                 "slots": {"l1.bias": {"velocity": torch.from_numpy(
                     tree["opt"]["slots"]["l1.bias"]["velocity"])}}}})
    assert {k: int(v) for k, v in got.items()} == want


def test_count_fingerprint_collectives_waits_for_item_16():
    """Item 16 (the program analysis) is in: the count walks a traced
    graph; a graph without the tagged collectives counts 0 (the gloo
    worlds of tests/test_torch_schedule.py count a check step's 2)."""
    from paddle_tpu_torch.analysis import trace_program
    g = trace_program(lambda t: integrity.fingerprint_array(t * 2),
                      torch.ones(64))
    assert integrity.count_fingerprint_collectives(g) == 0


# ---------------------------------------------------------------------------
# the engine's check step, the quarantine vote, the param flip
# ---------------------------------------------------------------------------

@pytest.fixture()
def fresh_registry():
    old_reg, old_on = telemetry.get_registry(), telemetry.enabled()
    reg = telemetry.Registry()
    telemetry._set_registry(reg)
    telemetry.enable(True)
    yield reg
    telemetry._set_registry(old_reg)
    telemetry.enable(old_on)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.reset()
    yield
    faults.reset()
    integrity.hang_event.clear()


def _series_total(reg, name):
    return sum(reg.to_dict().get(name, {}).get("series", {}).values())


def _ref_mlp_trainer(check_every=0, seed=7):
    """The reference's hostsim MLP at data degree 1."""
    paddle.seed(seed)

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
                      mesh=ref_build_mesh({"data": 1}), grad_sync="int8",
                      grad_sync_block=8, integrity_check_every=check_every)


def _port_mlp_trainer(check_every=0, seed=7):
    tr = hostsim._tiny_trainer(seed=seed, device="cpu")
    tr.integrity_check_every = check_every
    return tr


def _loader(n=8, batch=8, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 8).astype(np.float32),
             rng.randn(batch, 4).astype(np.float32)) for _ in range(n)]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def test_check_step_fingerprints_equal_the_references_function(
        fresh_registry):
    tr = _port_mlp_trainer(check_every=2)
    x, y = _loader()[0]
    tr.train_step(x, y)
    assert tr.last_fingerprints is None            # off-cadence: nothing
    tr.train_step(x, y)
    names = [n for n, _ in tr._integrity_entries]
    assert names[0] == "params['l1.bias']"
    assert names[-1].startswith("comm_err[")
    state = {"params": dict(tr.model.named_parameters()),
             "opt": tr.opt_state, "comm_err": tr.comm_err}
    with jax.enable_x64(True):
        want = []
        for part in ("params", "opt", "comm_err"):
            for k, v in ref.fingerprint_tree(_np_tree(state[part])).items():
                want.append((part + k, int(v)))
    assert list(zip(names, tr.last_fingerprints.tolist())) == want
    assert tr.consume_divergence() == [] and tr.last_divergence == []
    assert _series_total(fresh_registry, "integrity_check_steps_total") == 1


def test_entries_follow_the_references_order():
    ref_tr = _ref_mlp_trainer(check_every=1)
    port = _port_mlp_trainer(check_every=1)
    assert [n for n, _ in port._integrity_entries] == \
        [n for n, _ in ref_tr._integrity_entries]


@pytest.mark.parametrize("chains, n_rep", [
    ({0: 5, 1: 5, 2: 9, 3: 5}, 4), ({0: 1, 1: 2}, 2), ({0: 1, 1: 2}, 4),
    ({0: 7, 1: 7, 2: 8, 3: 8}, 4), ({1: 3, 2: 3, 3: 4}, 4),
    ({0: 1, 1: 1}, 4), ({0: 1, 1: 1, 2: 1}, 4), ({}, 2)])
def test_vote_outliers_equals_the_reference(chains, n_rep):
    assert integrity.vote_outliers(chains, n_rep) == \
        ref.vote_outliers(chains, n_rep)


@pytest.mark.parametrize("seed, step", [(0, None), (11, 5), (3, 0),
                                        (7, 12), (123, 4)])
def test_param_flip_choice_equals_the_reference(seed, step):
    ref_tr = _ref_mlp_trainer()
    port = _port_mlp_trainer()
    set_trainer_state_from_numpy(port, jax.tree_util.tree_map(
        np.asarray, ref_tr.state))
    want = ref.inject_param_flip(ref_tr, seed=seed, step=step)
    got = integrity.inject_param_flip(port, seed=seed, step=step)
    assert got == want
    # the same bit of the same element flipped on both sides
    name = got["leaf"]
    assert np.array_equal(
        np.asarray(ref_tr.state["params"][name]).view(np.uint32),
        port.params[name].detach().numpy().view(np.uint32))


def test_quarantine_at_one_replica_abstains():
    port = _port_mlp_trainer(check_every=1)
    q = integrity.quarantine_outliers(port, leaves=["x"])
    assert q == {"outlier_replicas": [], "outlier_hosts": [],
                 "quarantined": 0, "action": "rollback", "abstained": False,
                 "leaves": ["x"]}


def test_gather_digest_chains_merges_coordinator_views(tmp_path):
    import threading

    from paddle_tpu_torch.resilience.elastic import FileCoordinator

    class _Elastic:
        def __init__(self, host):
            self.coordinator = FileCoordinator(str(tmp_path), host=host)

        def _coord_hosts(self):
            return ["a", "b"]

    out = {}

    def run(host, local):
        out[host] = integrity._gather_digest_chains(local, _Elastic(host))

    ts = [threading.Thread(target=run, args=("a", {0: 11, 1: 11})),
          threading.Thread(target=run, args=("b", {2: 11, 3: 99}))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert out["a"] == out["b"] == {0: 11, 1: 11, 2: 11, 3: 99}
    assert integrity._gather_digest_chains({0: 1}, object()) == {0: 1}


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------

def test_watchdog_fires_on_deadline_and_stops_heartbeats(fresh_registry):
    beats = []
    wd = integrity.HangWatchdog(0.15, heartbeat_fn=lambda: beats.append(1),
                                poll=0.02).start()
    try:
        wd.arm(step=0)
        integrity.simulate_hang(max_seconds=5.0)
        assert integrity.hang_event.is_set() and wd.fired == 1
        n = len(beats)
        time.sleep(0.2)
        assert len(beats) == n > 0
    finally:
        wd.stop()
    assert _series_total(fresh_registry, "hang_watchdog_fired_total") == 1


def test_watchdog_disarm_prevents_firing():
    wd = integrity.HangWatchdog(0.1, poll=0.02).start()
    try:
        with wd.guarding(step=0):
            pass
        time.sleep(0.3)
        assert wd.fired == 0 and not integrity.hang_event.is_set()
    finally:
        wd.stop()


def test_runner_host_hang_in_process(fresh_registry, tmp_path):
    """host_hang wedges one step; without hang_exit the watchdog's firing
    releases it, the run completes and the flight dump exists."""
    from paddle_tpu_torch.telemetry import flight
    flight.reset()
    flight.configure(str(tmp_path / "flight"))
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"))
    try:
        with faults.inject("host_hang", at_step=2) as f:
            res = run_resilient(_port_mlp_trainer(), _loader(), steps=4,
                                manager=mgr, save_every=2,
                                handle_signals=False, hang_timeout=0.3)
    finally:
        mgr.close()
        flight.reset()
    assert f.fired == 1 and res.exit_code == 0 and res.steps_done == 4
    assert res.hangs == 1
    assert _series_total(fresh_registry, "hang_watchdog_fired_total") == 1
    assert flight.find_dumps(str(tmp_path / "flight"),
                             reason="hang_watchdog")


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _replay_run(root, deep):
    loader = _loader(n=3)              # a short epoch: cursor rollover
    mgr = ck.CheckpointManager(root, max_to_keep=8, deep_digests=deep)
    res = run_resilient(_port_mlp_trainer(), loader, steps=4, manager=mgr,
                        save_every=1, handle_signals=False)
    mgr.close()
    assert res.exit_code == 0
    return loader


def test_replay_ok_then_sdc_on_a_tampered_record(tmp_path):
    root = str(tmp_path / "ckpt")
    loader = _replay_run(root, deep=True)
    rep = integrity.replay_step(root, 3, _port_mlp_trainer, loader)
    assert rep["verdict"] == "ok", rep
    assert rep["restored_from"] == 2 and rep["mismatched_keys"] == []
    mpath = os.path.join(root, "3", ck.MANIFEST_NAME)
    with open(mpath) as f:
        man = json.load(f)
    key = sorted(k for k in man["arrays"] if "params" in k)[0]
    man["arrays"][key] = "crc32:deadbeef:1"
    with open(mpath, "w") as f:
        json.dump(man, f)
    rep2 = integrity.replay_step(root, 3, _port_mlp_trainer, loader)
    assert rep2["verdict"] == "sdc", rep2
    assert rep2["mismatched_keys"] == [key]
    assert rep2["replay_mismatch_keys"] == []


def test_replay_of_a_nondeterministic_step(tmp_path):
    root = str(tmp_path / "ckpt")
    loader = _replay_run(root, deep=True)
    draws = iter(range(1, 100))

    def noisy():
        # each replay's loss has another scale: the replays disagree
        tr = _port_mlp_trainer()
        k = float(next(draws))
        inner = tr.loss_fn
        tr.loss_fn = lambda out, y: inner(out, y) * k
        return tr

    rep = integrity.replay_step(root, 3, noisy, loader)
    assert rep["verdict"] == "nondeterminism", rep
    assert any("params" in k for k in rep["replay_mismatch_keys"])


def test_replay_without_digests_reports_no_reference(tmp_path):
    root = str(tmp_path / "ckpt")
    loader = _replay_run(root, deep=False)
    rep = integrity.replay_step(root, 2, _port_mlp_trainer, loader)
    assert rep["verdict"] == "no_reference"


# ---------------------------------------------------------------------------
# fault kinds
# ---------------------------------------------------------------------------

def test_fault_kinds_are_the_references():
    from paddle_tpu.resilience import faults as ref_faults
    assert faults.KINDS == ref_faults.KINDS
    with faults.inject("param_flip", at_step=5, seed=42) as f:
        assert faults.active("param_flip") and not faults.active("sigterm")
        assert faults.fire_spec("param_flip", step=4) is None
        assert faults.fire_spec("param_flip", step=5) is f
        assert not faults.active("param_flip")
    assert issubclass(faults.HostLost, RuntimeError)
    assert not issubclass(faults.HostLost, OSError)


@pytest.mark.parametrize("bad", [None, "nan", "inf"])
def test_all_finite_value_equals_the_reference(bad):
    from paddle_tpu.resilience.guard import all_finite_value as ref_value

    from paddle_tpu_torch.resilience.guard import all_finite_value
    rs = np.random.RandomState(2)
    tree = {"a": rs.randn(4, 3).astype(np.float32),
            "b": {"c": rs.randn(5).astype(np.float32),
                  "n": np.arange(3, dtype=np.int32)}}
    if bad:
        tree["b"]["c"][2] = np.float32(bad)
    want = bool(ref_value(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = all_finite_value(jax.tree_util.tree_map(torch.from_numpy, tree))
    assert got is want and want == (bad is None)
