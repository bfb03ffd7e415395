"""The port's serving tier against the JAX package's: SLO actions, the
executor cache, layer pinning, ``ServingFleet``, ``from_config`` and the
calibrated admission.

Mirrors ``tests/test_serving_fleet.py``, ``tests/test_inference_serving.py``
(``test_predictor_e2e_shape_polymorphic``) and
``tests/test_calibration.py`` (the serving EWMA seed). The SLO and fleet
scenarios run on both packages (``impl``: ``"port"`` or ``"ref"``) with
plain-numpy executors and the reference's assertions, so each count
(alerts, clears, scale events, canary verdicts, rollbacks, member files,
drains) is held to the same number on both. The executor cache's manifest
is the reference's byte for byte, both ways. The Predictor paths compare
answers with the reference's Predictor within 1e-5 (float32).
"""
import json
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu as ref_paddle
from paddle_tpu import inference as ref_inference
from paddle_tpu import jit as ref_jit
from paddle_tpu import nn as ref_nn
from paddle_tpu.inference import executor_cache as ref_ec
from paddle_tpu.inference import fleet as ref_fleet
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.telemetry import calibration as ref_cal
from paddle_tpu.telemetry import flight as ref_flight
from paddle_tpu.telemetry import metrics as ref_metrics
from paddle_tpu.telemetry import slo as ref_slo

from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.inference import executor_cache as ec
from paddle_tpu_torch.inference import fleet as fleet_mod
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.telemetry import calibration as cal
from paddle_tpu_torch.telemetry import flight
from paddle_tpu_torch.telemetry import metrics
from paddle_tpu_torch.telemetry import slo

TOL = 1e-5

IMPLS = {
    "port": types.SimpleNamespace(fleet=fleet_mod, serving=serving, slo=slo,
                                  flight=flight,
                                  Registry=metrics.Registry),
    "ref": types.SimpleNamespace(fleet=ref_fleet, serving=ref_serving,
                                 slo=ref_slo, flight=ref_flight,
                                 Registry=ref_metrics.Registry),
}
both = pytest.mark.parametrize("impl", ["port", "ref"])


def _breach(reg, shed=10, total=20):
    reg.counter("serving_requests_total").inc(total)
    reg.counter("serving_requests_shed_total").inc(shed)


# -- SLO action registry ---------------------------------------------------------

def _rule(m):
    return m.slo.SloRule("shed_burn",
                         numerator="serving_requests_shed_total",
                         denominator="serving_requests_total",
                         threshold=0.3, window_s=5.0, min_denominator=10.0)


@both
def test_registered_actions_replace_default_dump(impl, monkeypatch):
    m = IMPLS[impl]
    dumps = []
    monkeypatch.setattr(m.flight, "dump", lambda *a, **kw: dumps.append(a))
    reg = m.Registry()
    rule = _rule(m)
    hits = []
    assert rule.on_alert(lambda r, burn: hits.append((r.name, burn))) \
        is not None
    mon = m.slo.SloMonitor([rule], registry=reg)
    mon.poll(now=0.0)
    _breach(reg)
    mon.poll(now=1.0)
    assert hits == [("shed_burn", pytest.approx(0.5))]
    assert dumps == [] and rule.alerts == 1


@both
def test_default_alert_can_be_kept_alongside(impl, monkeypatch):
    m = IMPLS[impl]
    dumps = []
    monkeypatch.setattr(m.flight, "dump", lambda *a, **kw: dumps.append(a))
    reg = m.Registry()
    rule = _rule(m)
    hits = []
    rule.on_alert(lambda r, b: hits.append(b))
    rule.on_alert(m.slo.default_alert)
    mon = m.slo.SloMonitor([rule], registry=reg)
    mon.poll(now=0.0)
    _breach(reg)
    mon.poll(now=1.0)
    assert len(hits) == 1 and len(dumps) == 1
    assert m.slo._default_alert is m.slo.default_alert


@both
def test_latch_unlatch_drives_alert_and_clear_once(impl):
    m = IMPLS[impl]
    reg = m.Registry()
    rule = _rule(m)
    alerts, clears = [], []
    rule.on_alert(lambda r, b: alerts.append(b))
    rule.on_clear(lambda r, b: clears.append(b))
    mon = m.slo.SloMonitor([rule], registry=reg)
    mon.poll(now=0.0)
    _breach(reg)
    mon.poll(now=1.0)
    assert len(alerts) == 1 and rule.latched
    _breach(reg)
    mon.poll(now=2.0)
    assert len(alerts) == 1 and clears == []
    reg.counter("serving_requests_total").inc(300)
    mon.poll(now=6.5)
    assert not rule.latched
    assert len(clears) == 1 and rule.clears == 1
    mon.poll(now=6.6)
    assert len(clears) == 1
    _breach(reg, shed=15, total=20)
    mon.poll(now=7.5)
    assert len(alerts) == 2 and rule.alerts == 2


@both
def test_raising_action_never_breaks_the_poll(impl):
    m = IMPLS[impl]
    reg = m.Registry()
    rule = _rule(m)
    hits = []

    def bad_action(r, b):
        raise RuntimeError("action exploded")

    rule.on_alert(bad_action)
    rule.on_alert(lambda r, b: hits.append(b))
    rule.on_clear(bad_action)
    mon = m.slo.SloMonitor([rule], registry=reg)
    mon.poll(now=0.0)
    _breach(reg)
    mon.poll(now=1.0)
    _breach(reg)
    mon.poll(now=2.0)
    reg.counter("serving_requests_total").inc(300)
    mon.poll(now=6.5)       # unlatch: the raising clear action runs
    assert len(hits) == 1 and rule.clears == 1


# -- executor cache ------------------------------------------------------------------

def test_roundtrip(tmp_path):
    path = str(tmp_path / "cache.json")
    c = ec.ExecutorCache(path=path)
    sig = (((32,), "<f4"),)
    assert c.record("k", sig, 4) is True
    assert c.record("k", sig, 4) is False
    c.save()
    c2 = ec.ExecutorCache.load(path)
    assert c2.shapes("k") == [(sig, 4)] and len(c2) == 1


def test_manifest_is_the_reference_format_both_ways(tmp_path):
    sigs = [((((32,), "<f4"),), 4), ((((8, 3), "<i8"), ((2,), "<f4")), 1)]
    for key in ("a|quant=None", "b|quant=('int8', None)"):
        for writer, reader in ((ref_ec, ec), (ec, ref_ec)):
            path = str(tmp_path / f"{writer.__name__}.json")
            c = writer.ExecutorCache(path=path)
            for sig, bucket in sigs:
                c.record(key, sig, bucket)
            c.save()
            assert reader.ExecutorCache.load(path).shapes(key) == sigs
    with open(tmp_path / f"{ref_ec.__name__}.json") as f:
        ref_bytes = f.read()
    with open(tmp_path / f"{ec.__name__}.json") as f:
        assert f.read() == ref_bytes
    assert ec.artifact_key("/m/p", ("int8", None)) == \
        ref_ec.artifact_key("/m/p", ("int8", None))


def test_default_path_and_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_TORCH_EXECUTOR_CACHE", raising=False)
    assert ec.default_cache_path().endswith(
        os.path.join(".cache", "paddle_tpu_torch", "executor_cache.json"))
    monkeypatch.setenv("PADDLE_TPU_TORCH_EXECUTOR_CACHE",
                       str(tmp_path / "x.json"))
    assert ec.default_cache_path() == str(tmp_path / "x.json")


def test_corrupt_file_degrades_to_empty(tmp_path):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        c = ec.ExecutorCache.load(path)
    assert len(c) == 0
    with open(path, "w") as f:
        json.dump({"version": 1, "entries":
                   {"k": [["(((32,), '<f4'),)", 2], ["garbage(", 4]]}}, f)
    assert ec.ExecutorCache.load(path).shapes("k") == [((((32,), "<f4"),),
                                                        2)]


def test_attach_records_and_prime_closes_recompiles(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = ec.ExecutorCache(path=path)
    calls = []

    def fn(arrays):
        calls.append(np.asarray(arrays[0]).shape)
        return [np.asarray(arrays[0]) * 2.0]

    s1 = serving.InferenceServer([fn], config=serving.ServingConfig(
        max_batch=4))
    ec.attach(s1, "art", cache)
    with s1:
        s1.submit([np.ones((1, 8), np.float32)],
                  deadline_s=5.0).result(timeout=10)
    assert s1.stats()["recompiles"] == 1
    assert cache.shapes("art") and os.path.exists(path)
    s2 = serving.InferenceServer([fn], config=serving.ServingConfig(
        max_batch=4))
    n_calls = len(calls)
    assert ec.prime(s2, "art", cache) == len(cache.shapes("art"))
    assert len(calls) > n_calls
    with s2:
        s2.submit([np.ones((1, 8), np.float32)],
                  deadline_s=5.0).result(timeout=10)
    assert s2.stats()["recompiles"] == 0
    assert s2.warm_start(cache.shapes("art")) == 0   # already seeded


def test_prime_skips_broken_entries(tmp_path):
    cache = ec.ExecutorCache(path=str(tmp_path / "c.json"))
    cache.record("art", (((8,), "<f4"),), 1)
    cache.record("art", (((8,), "not-a-dtype"),), 1)
    server = serving.InferenceServer([lambda a: [np.asarray(a[0])]],
                                     config=serving.ServingConfig(
                                         max_batch=4))
    with pytest.warns(UserWarning, match="prime skipped"):
        assert ec.prime(server, "art", cache) == 1


# -- layer-cache generation pinning ------------------------------------------------------

@pytest.fixture()
def saved_model(tmp_path):
    net = nn.Linear(8, 4)
    prefix = str(tmp_path / "model")
    jit.save(net, prefix, input_spec=[jit.InputSpec([None, 8])])
    inference.clear_layer_cache()
    yield prefix
    inference.clear_layer_cache()


def _cpu(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


def _overwrite_params(prefix, factor=100.0):
    import pickle
    with open(prefix + ".pdiparams", "rb") as f:
        blob = pickle.load(f)
    blob["params"] = {k: np.asarray(v) * factor
                      for k, v in blob["params"].items()}
    with open(prefix + ".pdiparams", "wb") as f:
        pickle.dump(blob, f)


def test_pinned_layer_survives_artifact_overwrite(saved_model):
    prefix = saved_model
    key = inference.layer_cache_key(prefix)
    pred = inference.Predictor(_cpu(prefix), layer_key=key)
    x = np.ones((1, 8), np.float32)
    before = pred.run([x])[0]
    inference.pin_layer(key)
    _overwrite_params(prefix)
    assert inference.evict_stale_layers() == 0
    pred2 = inference.Predictor(_cpu(prefix), layer_key=key)
    np.testing.assert_array_equal(pred2.run([x])[0], before)
    inference.unpin_layer(key)
    assert inference.evict_stale_layers() == 1
    after = inference.Predictor(_cpu(prefix)).run([x])[0]
    assert not np.allclose(after, before)


def test_pinned_key_with_lost_entry_fails_loudly(saved_model):
    prefix = saved_model
    key = inference.layer_cache_key(prefix)
    _overwrite_params(prefix)
    with pytest.raises(KeyError, match="pinned layer generation"):
        inference._load_layer(prefix, key=key)


def test_pin_refcounting(saved_model):
    prefix = saved_model
    key = inference.layer_cache_key(prefix)
    inference.Predictor(_cpu(prefix), layer_key=key)
    inference.pin_layer(key)
    inference.pin_layer(key)
    _overwrite_params(prefix)
    inference.unpin_layer(key)
    assert inference.evict_stale_layers() == 0
    inference.unpin_layer(key)
    assert inference.evict_stale_layers() == 1


# -- ServingFleet, both packages ----------------------------------------------------

def _np_gen(m, gen_id, scale=2.0, delay=0.0):
    def fn(arrays):
        if delay:
            time.sleep(delay)
        return [np.asarray(arrays[0]) * scale]

    def make_server():
        return m.serving.InferenceServer(
            [fn], config=m.serving.ServingConfig(max_batch=4))

    return m.fleet.ModelGeneration(gen_id, make_server)


def _pumped(fleet, stop, interval=0.005):
    def pump():
        while not stop.is_set():
            try:
                fleet.submit([np.ones((1, 4), np.float32)], deadline_s=5.0)
            except RuntimeError:
                pass
            time.sleep(interval)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    return th


@both
def test_bootstrap_membership_and_shutdown(impl, tmp_path):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=2, max_members=4)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg,
                                 membership_root=str(tmp_path), fleet_id="t")
    fleet.start()
    assert fleet.stats()["members"] == 2
    assert len(fleet.live_members()) == 2
    mdir = os.path.join(str(tmp_path), "members", "t")
    assert len([f for f in os.listdir(mdir) if f.endswith(".json")]) == 2
    out = fleet.submit([np.ones((1, 4), np.float32)],
                       deadline_s=5.0).result(timeout=10)
    np.testing.assert_allclose(np.asarray(out[0]), 2.0)
    fleet.shutdown(drain=True)
    assert fleet.accounted()
    assert [f for f in os.listdir(mdir) if f.endswith(".json")] == []
    fleet.submit([np.ones((1, 4), np.float32)], deadline_s=5.0)
    assert fleet.stats()["shed_causes"].get("draining", 0) >= 1
    assert fleet.accounted()


@both
def test_stale_member_files_reaped(impl, tmp_path):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=1, member_stale_after_s=0.05)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg,
                                 membership_root=str(tmp_path), fleet_id="t")
    fleet.start()
    mdir = os.path.join(str(tmp_path), "members", "t")
    dead = os.path.join(mdir, "dead-host-m9.json")
    with open(dead, "w") as f:
        json.dump({"host": "dead-host", "member": "m9", "t": 0}, f)
    old = time.time() - 60
    os.utime(dead, (old, old))
    assert fleet.reap_stale_members() == 1
    assert not os.path.exists(dead)
    fleet.shutdown(drain=True)


@both
def test_autoscale_up_on_load_and_down_when_idle(impl):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=1, max_members=2, cooldown_s=0.0,
                              scale_up_wait_s=0.01, scale_up_queue_depth=2,
                              scale_down_idle_s=5.0)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0, delay=0.05), config=cfg)
    fleet.start()
    reqs = [fleet.submit([np.ones((1, 4), np.float32)], deadline_s=30.0)
            for _ in range(12)]
    fleet.poll_once()
    st = fleet.stats()
    assert st["members"] == 2 and st["scale_ups"] == 1
    for r in reqs:
        r.result(timeout=30)
    t = time.monotonic() + 100.0
    fleet.poll_once(now=t)
    fleet.poll_once(now=t + 6.0)
    st = fleet.stats()
    assert st["members"] == 1 and st["scale_downs"] == 1
    fleet.shutdown(drain=True)
    assert fleet.accounted()


@both
def test_slo_action_scales_up(impl):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=1, max_members=2,
                              scale_up_wait_s=1e9,
                              scale_up_queue_depth=10 ** 9)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg)
    fleet.start()
    reg = m.Registry()
    rule = _rule(m)
    rule.on_alert(fleet.scale_up_action())
    mon = m.slo.SloMonitor([rule], registry=reg)
    mon.poll(now=0.0)
    _breach(reg)
    mon.poll(now=1.0)
    st = fleet.stats()
    assert st["members"] == 2 and st["scale_ups"] == 1
    _breach(reg, shed=15, total=20)
    reg.counter("serving_requests_total").inc(300)
    mon.poll(now=6.5)
    _breach(reg, shed=15, total=20)
    mon.poll(now=7.5)
    assert fleet.stats()["members"] == 2
    fleet.shutdown(drain=True)


@both
def test_hot_swap_bad_canary_rolls_back(impl):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=2, max_members=4,
                              canary_shadow_fraction=1.0,
                              canary_min_shadow=3, canary_timeout_s=10.0)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg)
    fleet.start()
    stop = threading.Event()
    th = _pumped(fleet, stop)
    try:
        assert fleet.hot_swap(_np_gen(m, 1, scale=np.nan)) is False
    finally:
        stop.set()
        th.join(timeout=5)
    st = fleet.stats()
    assert st["rolled_back"] == 1 and st["promoted"] == 0
    assert st["generation"] == 0
    assert fleet.last_canary_checks["sanity"] is False
    out = fleet.submit([np.ones((1, 4), np.float32)],
                       deadline_s=5.0).result(timeout=10)
    assert np.isfinite(np.asarray(out[0])).all()
    fleet.shutdown(drain=True)
    assert fleet.accounted()


@both
def test_hot_swap_good_canary_promotes_all_members(impl):
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=3, max_members=4,
                              canary_shadow_fraction=1.0,
                              canary_min_shadow=3, canary_timeout_s=10.0)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg)
    fleet.start()
    stop = threading.Event()
    th = _pumped(fleet, stop)
    try:
        assert fleet.hot_swap(_np_gen(m, 1, scale=3.0)) is True
    finally:
        stop.set()
        th.join(timeout=5)
    st = fleet.stats()
    assert st["promoted"] == 1 and st["generation"] == 1
    assert st["members"] == 3 and set(st["member_generations"]) == {1}
    out = fleet.submit([np.ones((1, 4), np.float32)],
                       deadline_s=5.0).result(timeout=10)
    np.testing.assert_allclose(np.asarray(out[0]), 3.0)
    fleet.shutdown(drain=True)
    assert fleet.accounted()


@both
def test_hot_swap_poller_publishes_and_remembers_rejections(impl):
    m = IMPLS[impl]
    published = []

    def publish(step):
        published.append(step)
        return _np_gen(m, step, scale=np.nan)

    cfg = m.fleet.FleetConfig(min_members=1, canary_shadow_fraction=1.0,
                              canary_min_shadow=2, canary_timeout_s=10.0)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0), config=cfg,
                                 watch_fn=lambda: 1, publish_fn=publish)
    fleet.start()
    stop = threading.Event()
    th = _pumped(fleet, stop)
    try:
        fleet.poll_once()
        assert published == [1]
        assert fleet.stats()["rolled_back"] == 1
        fleet.poll_once()
        assert published == [1]
    finally:
        stop.set()
        th.join(timeout=5)
    fleet.shutdown(drain=True)


@both
def test_hot_swap_poller_publish_failure_counts_as_rollback(impl):
    m = IMPLS[impl]

    def publish(step):
        raise OSError("artifact unreadable")

    fleet = m.fleet.ServingFleet(
        _np_gen(m, 0), config=m.fleet.FleetConfig(min_members=1),
        watch_fn=lambda: 5, publish_fn=publish)
    fleet.start()
    fleet.poll_once()
    st = fleet.stats()
    assert st["rolled_back"] == 1 and st["generation"] == 0
    fleet.poll_once()
    assert fleet.stats()["rolled_back"] == 1
    fleet.shutdown(drain=True)


@both
def test_sigterm_drains_every_member_exactly_once(impl):
    m = IMPLS[impl]
    chained = []
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: chained.append(signum))
    fleet = m.fleet.ServingFleet(
        _np_gen(m, 0), config=m.fleet.FleetConfig(min_members=2))
    try:
        fleet.start()
        drains = {}
        with fleet._lock:
            members = list(fleet._members)
        for mem in members:
            real = mem.server.shutdown

            def counting(drain=True, timeout=30.0, _real=real,
                         _name=mem.name):
                drains[_name] = drains.get(_name, 0) + 1
                return _real(drain=drain, timeout=timeout)

            mem.server.shutdown = counting
        reqs = [fleet.submit([np.ones((1, 4), np.float32)], deadline_s=10.0)
                for _ in range(6)]
        fleet.install_sigterm_drain()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10.0
        while not fleet._stopped and time.monotonic() < deadline:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.1)
        fleet.shutdown(drain=True)
        assert drains == {mem.name: 1 for mem in members}
        assert fleet._shutdowns == 1
        assert all(r.done() for r in reqs)
        assert fleet.accounted()
        assert len(chained) >= 2
    finally:
        signal.signal(signal.SIGTERM, prev)


@both
def test_context_manager_and_double_shutdown(impl):
    m = IMPLS[impl]
    with m.fleet.ServingFleet(
            _np_gen(m, 0),
            config=m.fleet.FleetConfig(min_members=1)) as fleet:
        fleet.submit([np.ones((1, 4), np.float32)],
                     deadline_s=5.0).result(timeout=10)
    fleet.shutdown(drain=True)
    assert fleet._shutdowns == 1 and fleet.accounted()


# -- the Predictor path ---------------------------------------------------------------

@pytest.fixture()
def saved_pair(tmp_path):
    ref_paddle.seed(11)
    net = ref_nn.Linear(6, 3)
    net.eval()
    ref_prefix = str(tmp_path / "ref")
    ref_jit.save(net, ref_prefix,
                 input_spec=[ref_jit.InputSpec([None, 6], "float32")])
    port = nn.Linear(6, 3)
    port.set_state_dict_from_numpy(jit.read_pdiparams(ref_prefix))
    prefix = str(tmp_path / "model")
    jit.save(port, prefix, input_spec=[jit.InputSpec([None, 6])])
    inference.clear_layer_cache()
    yield ref_prefix, prefix, port
    inference.clear_layer_cache()
    ref_inference.clear_layer_cache()


def _rows(n, seed=0):
    return np.random.RandomState(seed).rand(n, 6).astype(np.float32)


def test_from_config_over_a_shape_polymorphic_artifact(saved_pair, tmp_path):
    ref_prefix, prefix, _ = saved_pair
    cfg = _cpu(prefix)
    ref_direct = ref_inference.create_predictor(
        ref_inference.Config(ref_prefix))
    cache = ec.ExecutorCache(path=str(tmp_path / "ec.json"))
    key = ec.artifact_key(prefix)
    scfg = serving.ServingConfig(max_batch=4, call_timeout_s=30.0)
    with serving.InferenceServer.from_config(cfg, replicas=2,
                                             serving=scfg) as srv:
        ec.attach(srv, key, cache)
        for n in (1, 2, 4):
            srv.submit([_rows(n)]).result(timeout=30)
        warm = srv.stats()["recompiles"]
        xs = [_rows(1 + i % 4, seed=i) for i in range(10)]
        reqs = [srv.submit([x]) for x in xs]
        for x, r in zip(xs, reqs):
            np.testing.assert_allclose(r.result(timeout=30)[0],
                                       np.asarray(ref_direct.run([x])[0]),
                                       rtol=TOL, atol=TOL)
        assert srv.stats()["recompiles"] == warm
        assert srv.accounted()
    assert len(cache.shapes(key)) == warm
    # a second server primed from the manifest serves with no recompile
    srv2 = serving.InferenceServer.from_config(cfg, replicas=2,
                                               serving=scfg)
    assert ec.prime(srv2, key, cache) == warm
    with srv2:
        for n in (1, 2, 3, 4):
            srv2.submit([_rows(n, seed=n)]).result(timeout=30)
        assert srv2.stats()["recompiles"] == 0 and srv2.accounted()


def test_predictor_fleet_promotes_a_good_step_and_rolls_back_a_nan(
        saved_pair):
    """``predictor_generation`` (int8) with the artifact overwritten in
    place by each published step: a good step is promoted, a step whose
    weights overflowed to inf is served NaN (an inf block's scale is inf,
    as in the reference's quantizer), rolled back, and the incumbent keeps
    serving from its pinned layer. A NaN weight would not do: the
    quantizer, as the reference's, serves a NaN block finite."""
    _, prefix, port = saved_pair
    quant = ("int8", 16)
    scfg = serving.ServingConfig(max_batch=4, call_timeout_s=30.0)
    gen0 = fleet_mod.predictor_generation(0, prefix, quant=quant,
                                          serving=scfg, device="cpu")

    def publish(step):
        import torch
        with torch.no_grad():
            port.weight.mul_(-1.0 if step == 1 else float("inf"))
        jit.save(port, prefix, input_spec=[jit.InputSpec([None, 6])])
        return fleet_mod.predictor_generation(step, prefix, quant=quant,
                                              serving=scfg, device="cpu")

    steps = iter([1, 1, 2, 2])
    fcfg = fleet_mod.FleetConfig(min_members=2, max_members=3,
                                 canary_shadow_fraction=1.0,
                                 canary_min_shadow=3, canary_timeout_s=20.0,
                                 canary_latency_slack_s=1.0)
    fleet = fleet_mod.ServingFleet(gen0, config=fcfg,
                                   watch_fn=lambda: next(steps),
                                   publish_fn=publish)
    fleet.start()
    x = _rows(1)
    before = fleet.submit([x], deadline_s=10.0).result(timeout=30)[0]
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            fleet.submit([x], deadline_s=10.0)
            time.sleep(0.005)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        fleet.poll_once()
        st = fleet.stats()
        assert st["promoted"] == 1 and st["generation"] == 1
        promoted = fleet.submit([x], deadline_s=10.0).result(timeout=30)[0]
        assert not np.allclose(promoted, before)
        fleet.poll_once()       # step 1 again: nothing to do
        fleet.poll_once()       # step 2 serves NaN: rolled back
        st = fleet.stats()
        assert st["rolled_back"] == 1 and st["generation"] == 1
        assert fleet.last_canary_checks["sanity"] is False
        fleet.poll_once()       # remembered, not retried
        assert fleet.stats()["rolled_back"] == 1
        again = fleet.submit([x], deadline_s=10.0).result(timeout=30)[0]
        np.testing.assert_array_equal(again, promoted)
    finally:
        stop.set()
        th.join(timeout=5)
        fleet.shutdown(drain=True)
    assert fleet.accounted()


# -- the calibrated admission -------------------------------------------------------

@pytest.fixture()
def isolated_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_CALIBRATION_DB",
                       str(tmp_path / "port_calib.json"))
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_DB",
                       str(tmp_path / "ref_calib.json"))
    for mod in (cal, ref_cal):
        mod.clear_cache()
        mod.reset()
    yield
    for mod in (cal, ref_cal):
        mod.clear_cache()
        mod.reset()


@both
def test_serving_ewma_seeded_from_calibration(impl, isolated_calibration):
    m = IMPLS[impl]
    calib = cal if impl == "port" else ref_cal

    def fn(arrs):
        return arrs

    cold = m.serving.InferenceServer([fn],
                                     config=m.serving.ServingConfig())
    assert cold._ewma_rows_per_s is None
    assert cold.stats()["modeled_wait_source"] == "default"
    assert cold.modeled_wait(4) == 0.0
    calib.fit(serving_samples=[{"rows": 50, "seconds": 0.5}])
    seeded = m.serving.InferenceServer([fn],
                                       config=m.serving.ServingConfig())
    assert seeded._ewma_rows_per_s == pytest.approx(100.0)
    assert seeded._ewma_batch_s == pytest.approx(0.5)
    assert seeded.stats()["modeled_wait_source"] == "calibrated"
    assert seeded.modeled_wait(4) > 0.0


@both
def test_serving_source_flips_to_ewma_after_real_batch(impl,
                                                       isolated_calibration):
    m = IMPLS[impl]
    calib = cal if impl == "port" else ref_cal
    calib.fit(serving_samples=[{"rows": 50, "seconds": 0.5}])

    def fn(arrs):
        return [np.asarray(a) * 2 for a in arrs]

    with m.serving.InferenceServer([fn],
                                   config=m.serving.ServingConfig()) as srv:
        assert srv.stats()["modeled_wait_source"] == "calibrated"
        req = srv.submit([np.ones((2, 3), np.float32)])
        assert req.result(timeout=10.0)
        assert srv.stats()["modeled_wait_source"] == "ewma"
        assert req.t_predicted_wait is not None
        assert calib.pair("serving_queue_wait") is not None


def test_calibrated_wait_matches_the_reference(isolated_calibration):
    """The same fit gives the same seeded rates and the same modeled wait
    for the same queue."""
    samples = [{"rows": r, "seconds": s}
               for r, s in ((8, 0.02), (16, 0.05), (4, 0.011))]
    cal.fit(serving_samples=samples)
    ref_cal.fit(serving_samples=samples)
    assert cal.serving_rates() == pytest.approx(ref_cal.serving_rates(),
                                                rel=1e-12)
    port = serving.InferenceServer([lambda a: a])
    ref = ref_serving.InferenceServer([lambda a: a])
    for rows in (1, 4, 32):
        assert port.modeled_wait(rows) == pytest.approx(
            ref.modeled_wait(rows), rel=1e-12)


@both
def test_idle_after_every_member_served_scales_down_in_the_port(impl):
    """The one deliberate difference (``inference/fleet.py``): once every
    member has served a batch slower than 1 ms, the reference's fleet never
    reads as idle; the port's scales down when nothing is queued or in
    flight."""
    m = IMPLS[impl]
    cfg = m.fleet.FleetConfig(min_members=1, max_members=2, cooldown_s=0.0,
                              scale_up_wait_s=0.01, scale_up_queue_depth=2,
                              scale_down_idle_s=5.0)
    fleet = m.fleet.ServingFleet(_np_gen(m, 0, delay=0.02), config=cfg)
    fleet.start()
    reqs = [fleet.submit([np.ones((1, 4), np.float32)], deadline_s=30.0)
            for _ in range(12)]
    fleet.poll_once()
    assert fleet.stats()["members"] == 2
    for r in reqs:
        r.result(timeout=30)
    # the first member now models a wait; the new one, cold, takes these
    reqs = [fleet.submit([np.ones((1, 4), np.float32)], deadline_s=30.0)
            for _ in range(8)]
    for r in reqs:
        r.result(timeout=30)
    with fleet._lock:
        members = list(fleet._members)
    assert all(mem.server.stats()["batches"] > 0 for mem in members)
    t = time.monotonic() + 100.0
    fleet.poll_once(now=t)
    fleet.poll_once(now=t + 6.0)
    st = fleet.stats()
    assert st["members"] == (1 if impl == "port" else 2)
    assert st["scale_downs"] == (1 if impl == "port" else 0)
    fleet.shutdown(drain=True)
    assert fleet.accounted()


class _SlowArray:
    """An executor output whose trip to the host takes a while."""

    def __init__(self, a):
        self.a = a

    def __array__(self, dtype=None, copy=None):
        time.sleep(1.5)         # past shutdown's 0.5 s join of a worker
        return np.asarray(self.a)


@both
def test_drain_returns_once_every_answer_is_delivered(impl):
    """A deliberate difference in ``serving.py``: the port's drain waits
    until every accepted request is terminal; the reference's returns when
    the queue and the in-flight set are empty, which they are while a
    result is still on its way to its request."""
    m = IMPLS[impl]
    srv = m.serving.InferenceServer(
        [lambda arrays: [_SlowArray(arrays[0])]],
        config=m.serving.ServingConfig(max_batch=4))
    srv.start()
    req = srv.submit([np.ones((1, 4), np.float32)], deadline_s=10.0)
    time.sleep(0.2)             # the batch ran; its answer is on its way
    srv.shutdown(drain=True, timeout=10.0)
    if impl == "port":
        assert req.done() and req.state == "completed"
    else:
        assert not req.done()
    np.testing.assert_array_equal(req.result(timeout=10)[0], 1.0)
    assert srv.accounted()


@both
def test_drain_waits_for_a_batch_on_its_way_to_a_replica(impl):
    """The same difference: a batch that left the queue and is not yet in
    flight (here held by the shape observer) is lost by the reference's
    drain, never terminal, and served by the port's."""
    m = IMPLS[impl]
    srv = m.serving.InferenceServer(
        [lambda arrays: [np.asarray(arrays[0]) * 2.0]],
        config=m.serving.ServingConfig(max_batch=4))
    srv.shape_observer = lambda sig, bucket: time.sleep(1.0)
    srv.start()
    req = srv.submit([np.ones((1, 4), np.float32)], deadline_s=10.0)
    time.sleep(0.2)             # the batch left the queue
    srv.shutdown(drain=True, timeout=10.0)
    time.sleep(1.5)             # past the observer
    if impl == "port":
        assert req.state == "completed" and srv.accounted()
        np.testing.assert_array_equal(req.result(timeout=1)[0], 2.0)
    else:
        assert not req.done() and not srv.accounted()
