"""The port's calibration (``paddle_tpu_torch/telemetry/calibration.py``)
against the JAX package's, on the CPU.

The same ``record`` sequence gives the same drift ratios, latches,
re-arms, breach counts, summaries and flight dumps; ``fit_link`` and
``fit`` give the same constants on the same samples within 1e-12
relative; the DB's precedence (overlay over seed, exact device kind over
``"any"``, a corrupt file read as empty), ``serving_rates`` and
``peak_flops_per_sec``'s precedence (environment, then the fitted rate,
then a nominal 1e12) hold.
"""
import json
import math
import os
import random
import warnings

import pytest

from paddle_tpu import telemetry as ref_tel
from paddle_tpu.telemetry import calibration as ref_cal
from paddle_tpu.telemetry import flight as ref_flight

from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.ops import tuner
from paddle_tpu_torch.telemetry import calibration as cal
from paddle_tpu_torch.telemetry import flight

H100 = "nvidia-h100-80gb-hbm3"
REL = 1e-12


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_CALIBRATION_DB",
                       str(tmp_path / "port_calib.json"))
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_DB",
                       str(tmp_path / "ref_calib.json"))
    monkeypatch.delenv("PADDLE_TPU_TORCH_PEAK_FLOPS", raising=False)
    for mod in (cal, ref_cal):
        mod.clear_cache()
        mod.reset()
    yield
    for mod in (cal, ref_cal):
        mod.clear_cache()
        mod.reset()


def _sequence():
    """Pairs that cross the bound, recover to half of it, cross again,
    and hold invalid values, over two keys."""
    rs = random.Random(3)
    seq = []
    for i in range(40):
        key = "step_time" if i % 3 else "tuner:paged_split"
        ratio = [1.0, 1.2, 6.0, 9.0, 0.1, 1.5, 3.0, 1.9][i % 8]
        pred = 1e-3 * (1 + rs.random())
        seq.append((key, pred, pred * ratio, i))
    seq += [("step_time", 0.0, 1.0, 40), ("step_time", 1.0, -2.0, 41),
            ("step_time", "x", 1.0, 42), ("other", 2.0, 2.0, None)]
    return seq


def test_record_sequence_equals_the_reference(tmp_path):
    flight.configure(str(tmp_path / "port"))
    ref_flight.configure(str(tmp_path / "ref"))
    try:
        with tel.scope(None, profile=False) as sc, \
                ref_tel.scope(None, profile=False) as rsc:
            for key, p, m, step in _sequence():
                got = cal.record(key, p, m, step=step)
                want = ref_cal.record(key, p, m, step=step)
                assert got == want, (key, p, m)
                assert cal.drift(key) == ref_cal.drift(key)
                assert cal.pair(key) == ref_cal.pair(key)
            assert cal.summary() == ref_cal.summary()
            for name in ("calibration_drift_ratio",
                         "calibration_samples_total",
                         "calibration_drift_breaches_total"):
                assert sc.registry.get(name).series() == \
                    rsc.registry.get(name).series(), name
    finally:
        flight.configure(None)
        ref_flight.configure(None)
    summary = cal.summary()
    assert summary["step_time"]["breaches"] >= 2       # re-armed once
    assert summary["tuner:paged_split"]["breaches"] >= 1
    port_dumps = sorted(os.listdir(tmp_path / "port"))
    ref_dumps = sorted(os.listdir(tmp_path / "ref"))
    assert port_dumps == ref_dumps and len(port_dumps) == sum(
        s["breaches"] for s in summary.values())
    assert all(d.startswith("flight_calibration_drift_") for d in port_dumps)
    with open(tmp_path / "port" / port_dumps[0]) as f:
        dump = json.load(f)
    with open(tmp_path / "ref" / ref_dumps[0]) as f:
        ref_dump = json.load(f)
    assert dump["extra"] == ref_dump["extra"]
    assert dump["reason"] == "calibration_drift"


def test_registry_knobs_equal_the_reference():
    for bound, n in ((math.log(2.0), 1), (math.log(8.0), 3)):
        a = cal.CalibrationRegistry(drift_log_bound=bound, min_samples=n)
        b = ref_cal.CalibrationRegistry(drift_log_bound=bound, min_samples=n)
        for key, p, m, step in _sequence():
            assert a.record(key, p, m) == b.record(key, p, m)
        assert a.summary() == b.summary()
        a.reset()
        assert a.summary() == {} and a.drift("step_time") is None


def _link_samples(seed):
    rs = random.Random(seed)
    bw, lat = 2.0e10 * (1 + rs.random()), 5e-6 * (1 + rs.random())
    return [(b, lat + b / bw + rs.gauss(0, 1e-7))
            for b in (1e5, 1e6, 4e6, 1.6e7, 6.4e7)]


@pytest.mark.parametrize("samples", [
    _link_samples(0), _link_samples(1),
    [(1e6, 1e-4)],                                   # one sample
    [(1e6, 1e-4), (1e6, 2e-4)],                      # no byte spread
    [(1e6, 3e-4), (2e6, 2e-4), (3e6, 1e-4)],         # negative slope
    [(1e6, 1e-6), (2e6, 1e-3)],                      # negative latency
    [(0.0, 1.0), (1e6, -1.0)],                       # nothing usable
])
def test_fit_link_equals_the_reference(samples):
    got, want = cal.fit_link(samples), ref_cal.fit_link(samples)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=REL, abs=1e-300)


def test_fit_equals_the_reference_and_persists(tmp_path):
    coll = ([{"link": "ici", "wire_bytes": b, "seconds": t}
             for b, t in _link_samples(2)] +
            [{"link": "dcn", "wire_bytes": b, "seconds": t}
             for b, t in _link_samples(3)])
    comp = [{"flops": 1.9e15 * (1 + 0.01 * i), "seconds": 0.14 + 0.003 * i}
            for i in range(5)] + [{"flops": 1.0, "seconds": 0.0}]
    serv = [{"rows": 8 * (i + 1), "seconds": 0.01 * (i + 2)}
            for i in range(4)]
    kw = dict(collective_samples=coll, compute_samples=comp,
              serving_samples=serv, device=H100)
    got = cal.fit(**kw)
    want = ref_cal.fit(**kw)
    assert got["device"] == want["device"] == H100
    assert got["path"] == os.environ["PADDLE_TPU_TORCH_CALIBRATION_DB"]

    def close(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                close(a[k], b[k])
        elif isinstance(a, float):
            assert a == pytest.approx(b, rel=REL)
        else:
            assert a == b
    close(got["entry"], want["entry"])
    # a second fit of compute samples only keeps the links it measured
    again = cal.fit(compute_samples=comp[:3], device=H100)
    assert again["entry"]["links"] == got["entry"]["links"]
    assert again["entry"]["fitted"]["n_compute"] == 3
    db = cal.CalibrationDB.load(got["path"])
    assert db.lookup(H100) == again["entry"]
    # save=False fits without writing
    dry = cal.fit(compute_samples=comp, device="other", save=False)
    assert dry["path"] is None and cal.CalibrationDB.load(
        got["path"]).lookup("other") is None


def test_db_precedence_serving_rates_and_peak(tmp_path, monkeypatch):
    assert cal.device_kind() == tuner.device_kind()
    assert cal.constants() == {} and cal.serving_rates() is None
    assert tel.peak_flops_per_sec() == 1e12
    seed = tmp_path / "seed.json"
    cal.CalibrationDB({"any": {"peak_flops_per_sec": 2e14,
                               "serving": {"rows_per_s": 50.0}},
                       "cpu": {"links": {"ici": {"bandwidth_bps": 1e9,
                                                 "latency_s": 1e-5}}}},
                      path=str(seed)).save()
    monkeypatch.setattr(cal, "default_db_path", lambda: str(seed))
    cal.clear_cache()
    # the exact kind ("cpu" here) wins over "any", whole entry
    assert cal.constants() == {"links": {"ici": {"bandwidth_bps": 1e9,
                                                 "latency_s": 1e-5}}}
    assert cal.constants("any")["peak_flops_per_sec"] == 2e14
    assert cal.link_bandwidth_override("ici") == 1e9
    assert cal.link_latency_override("ici") == 1e-5
    assert cal.link_bandwidth_override("dcn") is None
    assert cal.peak_flops_override() is None
    monkeypatch.setattr(tuner, "device_kind", lambda: H100)
    cal.clear_cache()
    assert cal.peak_flops_override() == 2e14
    assert cal.serving_rates() == (50.0, 0.0)
    assert tel.peak_flops_per_sec() == 2e14
    # the overlay wins per device over the seed
    cal.fit(compute_samples=[{"flops": 9e14, "seconds": 1.0}], device=H100)
    assert tel.peak_flops_per_sec() == 9e14
    assert cal.serving_rates() is None          # the H100 entry has none
    monkeypatch.setenv("PADDLE_TPU_TORCH_PEAK_FLOPS", "989e12")
    assert tel.peak_flops_per_sec() == 989e12
    # a corrupt overlay reads as empty, with one warning
    with open(os.environ["PADDLE_TPU_TORCH_CALIBRATION_DB"], "w") as f:
        f.write("{broken")
    cal.clear_cache()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        # the seed has no H100 entry: its "any" entry answers
        assert cal.peak_flops_override() == 2e14
    assert len(seen) == 1
    monkeypatch.delenv("PADDLE_TPU_TORCH_PEAK_FLOPS")


def test_shipped_seed_is_empty_as_the_reference():
    with open(cal.default_db_path()) as f:
        port = json.load(f)
    with open(ref_cal.default_db_path()) as f:
        ref = json.load(f)
    assert port == ref == {"entries": {}, "version": 1}
