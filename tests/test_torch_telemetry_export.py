"""The port's telemetry exporters, run scope and per-process merge against
the JAX package's, on the CPU.

The same series go into a registry of each package: ``prometheus_text``
must be byte-equal; the JSONL sink writes the same lines; the merged
chrome trace of the same scripted host ranges, metric marks and kept
traces has the same events once timestamps, process and thread ids and
trace ids are set aside; ``scope(run_dir)`` writes the reference's files
(``traces_kept.json`` too, when a trace was kept) and restores every
global it touched; ``with_process_index`` and ``merge_process_dicts``
equal the reference's. ``gather_registries`` runs on gloo worlds of 2 and
4 spawned ranks (``torch_telemetry_worker.py``) and must give rank 0 the
reference's merge of the ranks' snapshots.
"""
import json
import os
import pickle

import pytest

from paddle_tpu import profiler as ref_profiler
from paddle_tpu import telemetry as ref_tel
from paddle_tpu.telemetry import aggregate as ref_agg
from paddle_tpu.telemetry import export as ref_export
from paddle_tpu.telemetry import tracing as ref_tracing

import torch_telemetry_worker as worker
from paddle_tpu_torch import profiler
from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.telemetry import aggregate, export, flight, tracing


def _fill(reg):
    """Every kind of series the exposition renders, escapes included."""
    c = reg.counter("requests_total", 'requests "by" outcome\nand path\\x')
    c.inc(outcome="completed")
    c.inc(2.5, outcome='sh"ed\\n')
    c.inc(3)
    g = reg.gauge("tokens_per_sec", "")
    g.set(12345.678)
    g.set(1e17, shard="big")
    g.set(-0.5, shard="neg")
    h = reg.histogram("step_time_seconds", "step wall time",
                      buckets=(0.001, 0.5, 2.0, float("inf")))
    for v in (0.0005, 0.25, 1.0, 3.0, 1e9):
        h.observe(v)
    h.observe(0.1, route="tiled")
    reg.histogram("never_observed", "declared only")
    reg.counter("a_first_alphabetically").inc(7)
    return reg


def test_prometheus_text_is_byte_equal_to_the_reference():
    got = export.prometheus_text(_fill(tel.Registry()))
    want = ref_export.prometheus_text(_fill(ref_tel.Registry()))
    assert got == want
    assert 'le="+Inf"' in got and got.endswith("\n")
    assert export.prometheus_text(tel.Registry()) == \
        ref_export.prometheus_text(ref_tel.Registry()) == ""
    # the package-level accessor renders the active registry
    reg = _fill(tel.Registry())
    prev = tel.get_registry()
    tel._set_registry(reg)
    try:
        assert tel.prometheus_text() == got
    finally:
        tel._set_registry(prev)


def test_jsonl_sink_writes_the_reference_lines(tmp_path):
    events = [{"event": "a", "ts": 1.5, "n": 3},
              {"event": "b", "obj": object.__name__, "nested": {"x": [1]}},
              {"event": "c", "path": tmp_path}]
    for name, cls in (("port", export.JsonlSink),
                      ("ref", ref_export.JsonlSink)):
        sink = cls(str(tmp_path / f"{name}.jsonl"))
        for e in events:
            sink.emit(e)
        sink.close()
        sink.emit({"event": "after close"})   # dropped, no error
    port = (tmp_path / "port.jsonl").read_text()
    assert port == (tmp_path / "ref.jsonl").read_text()
    assert [json.loads(line)["event"] for line in port.splitlines()] == \
        ["a", "b", "c"]


def _script(prof, telemetry_mod, tracing_mod, reg):
    """Nested host ranges on two threads, metric marks and one kept
    trace, the same for either package."""
    import threading
    tracing_mod.enable(policy=tracing_mod.KeepPolicy(keep_all=True))
    try:
        prof.start_profiler("CPU")
        reg.marks_enabled = True
        with prof.RecordEvent("train_step"):
            with prof.record_event("forward"):
                reg.counter("steps_total").inc()
            with prof.RecordEvent("backward"):
                reg.gauge("tokens_per_sec").set(5.0, route="tiled")

        def other():
            with prof.RecordEvent("loader"):
                reg.histogram("fetch_seconds").observe(0.01)
        th = threading.Thread(target=other, name="loader-0")
        th.start()
        th.join(10)
        tr = tracing_mod.start_trace("request", rid=7)
        sp = tr.span("prefill", tokens=32)
        sp.end()
        tr.close("completed")
        return tr
    finally:
        reg.marks_enabled = False


def _canon(trace):
    out = []
    for e in trace["traceEvents"]:
        e = {k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")}
        if "trace_id" in e.get("args", {}):
            e["args"] = {k: v for k, v in e["args"].items()
                         if k != "trace_id"}
        out.append(json.dumps(e, sort_keys=True))
    return sorted(out)


def test_chrome_trace_events_equal_the_reference_modulo_time(tmp_path):
    traces = {}
    for name, prof, tmod, trmod, exp in (
            ("port", profiler, tel, tracing, export),
            ("ref", ref_profiler, ref_tel, ref_tracing, ref_export)):
        reg = tmod.Registry()
        try:
            _script(prof, tmod, trmod, reg)
            path = str(tmp_path / f"{name}.json")
            trace = exp.chrome_trace(path, reg)
            with open(path) as f:
                assert json.load(f) == trace
            traces[name] = trace
        finally:
            prof.stop_profiler(profile_path="", verbose=False)
            trmod.disable()
            trmod.reset()
    assert _canon(traces["port"]) == _canon(traces["ref"])
    evs = traces["port"]["traceEvents"]
    assert all(e["ts"] >= 0 for e in evs)
    names = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert names["forward"]["args"]["parent"] == "train_step"
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} >= \
        {"loader-0"}


def _trace_once():
    tr = tracing.start_trace("train_step", step=0)
    tr.span("forward").end()
    tr.close("completed")


def test_scope_writes_the_four_files_and_restores_globals(tmp_path):
    prev_reg, prev_on = tel.get_registry(), tel.enabled()
    prev_flight = flight.get_recorder().out_dir
    run = tmp_path / "run"
    tracing.enable(policy=tracing.KeepPolicy(keep_all=True))
    try:
        with tel.scope(str(run)) as sc:
            assert tel.enabled() and tel.get_registry() is sc.registry
            assert profiler.is_profiler_enabled()
            assert flight.get_recorder().out_dir == str(run)
            with profiler.RecordEvent("train_step"):
                tel.counter("steps_total", "steps").inc()
            _trace_once()
            tel.emit("custom", value=3)
    finally:
        tracing.disable()
        tracing.reset()
    assert sorted(os.listdir(run)) == ["events.jsonl", "metrics.prom",
                                       "trace.json", "traces_kept.json"]
    assert tel.get_registry() is prev_reg and tel.enabled() == prev_on
    assert not profiler.is_profiler_enabled()
    assert flight.get_recorder().out_dir == prev_flight
    events = [json.loads(line)
              for line in (run / "events.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["scope_start", "custom",
                                            "summary"]
    assert events[-1]["metrics"]["steps_total"]["series"] == {"": 1.0}
    assert "steps_total 1" in (run / "metrics.prom").read_text()
    trace = json.loads((run / "trace.json").read_text())
    assert [e["name"] for e in trace["traceEvents"]
            if e["ph"] == "X" and e["cat"] == "host"] == ["train_step"]
    kept = json.loads((run / "traces_kept.json").read_text())
    assert [t["name"] for t in kept["traces"]] == ["train_step"]
    tel.emit("outside")          # no sink outside a scope: a no-op
    # the reference's scope writes the same files for the same script
    ref_run = tmp_path / "ref_run"
    ref_tracing.enable(policy=ref_tracing.KeepPolicy(keep_all=True))
    try:
        with ref_tel.scope(str(ref_run)):
            with ref_profiler.RecordEvent("train_step"):
                ref_tel.counter("steps_total", "steps").inc()
            tr = ref_tracing.start_trace("train_step", step=0)
            tr.span("forward").end()
            tr.close("completed")
    finally:
        ref_tracing.disable()
        ref_tracing.reset()
    assert sorted(os.listdir(ref_run)) == sorted(os.listdir(run))
    assert (ref_run / "metrics.prom").read_text() == \
        (run / "metrics.prom").read_text()


def test_scope_without_a_run_dir_or_a_kept_trace(tmp_path):
    with tel.scope(None, profile=False) as sc:
        tel.gauge("g").set(2.0)
        assert sc.jsonl_path is None and not profiler.is_profiler_enabled()
    assert sc.registry.get("g").value() == 2.0
    run = tmp_path / "quiet"
    with tel.scope(str(run)):
        pass
    assert sorted(os.listdir(run)) == ["events.jsonl", "metrics.prom",
                                       "trace.json"]


def _snapshots(n):
    return {r: worker.fill(tel.Registry(), r).to_dict() for r in range(n)}


def test_merges_equal_the_reference():
    snaps = _snapshots(3)
    for r, snap in snaps.items():
        assert aggregate.with_process_index(snap, r) == \
            ref_agg.with_process_index(snap, r)
    assert aggregate.merge_process_dicts(snaps) == \
        ref_agg.merge_process_dicts(snaps)
    merged = aggregate.merge_process_dicts(snaps)
    assert merged["steps_total"]["series"] == {
        "process_index=0": 3.0, "process_index=1": 4.0,
        "process_index=2": 5.0}
    # a single process merges locally, tagged process 0, and opens no group
    import torch.distributed as dist
    assert not dist.is_initialized()
    reg = worker.fill(tel.Registry(), 0)
    assert aggregate.gather_registries(reg) == \
        ref_agg.merge_process_dicts({0: reg.to_dict()})
    assert not dist.is_initialized()


def test_gather_via_coordinator_merges_by_sorted_host():
    snaps = _snapshots(2)

    class Coordinator:
        def allgather(self, name, value, hosts_fn, timeout=60.0):
            assert name == "telemetry_agg" and hosts_fn() == ["b", "a"]
            return {"b": snaps[1], "a": value}

    got = aggregate.gather_via_coordinator(
        Coordinator(), lambda: ["b", "a"],
        registry=worker.fill(tel.Registry(), 0))
    assert got == ref_agg.merge_process_dicts(snaps)


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
def test_gather_registries_over_gloo(tmp_path, n):
    spawn(worker.main, args=(str(tmp_path),), nprocs=n, timeout=240)
    got = []
    for r in range(n):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    assert got[0] == ref_agg.merge_process_dicts(_snapshots(n))
    assert all(g is None for g in got[1:])
