"""The port's profiler (``paddle_tpu_torch/profiler``) against the JAX
package's, on the CPU.

The same scripted host ranges (nested, on two threads, ended out of
order, straddling a restart) give the same events (names, parent paths,
threads), the same per-path call counts in the summary aggregation and
the same chrome-trace events once timestamps and ids are set aside. The
trainer's ``train_step`` opens one range a step while the profiler is on
and none while it is off. Device tracing needs the card: ``"GPU"``
raises without one, ``"All"`` records host ranges only.
"""
import json
import threading

import pytest
import torch

from paddle_tpu import profiler as ref_prof

from paddle_tpu_torch import profiler as prof


@pytest.fixture(autouse=True)
def _stopped():
    yield
    for p in (prof, ref_prof):
        p.stop_profiler(profile_path="", verbose=False)
        p.reset_profiler()


def _script(p):
    """Ranges in every shape the recorder handles; returns the events."""
    early = p.RecordEvent("before_start").begin()   # profiler off: nothing
    p.start_profiler("CPU")
    early.end()
    for i in range(3):
        with p.RecordEvent("train_step"):
            with p.record_event("forward"):
                with p.RecordEvent("attention"):
                    pass
            with p.RecordEvent("backward"):
                pass
    a = p.RecordEvent("outer").begin()
    b = p.RecordEvent("inner").begin()
    a.end()                      # out of LIFO order: removed by identity
    b.end()

    def worker():
        with p.RecordEvent("loader"):
            with p.RecordEvent("decode"):
                pass
    th = threading.Thread(target=worker, name="loader-0")
    th.start()
    th.join(10)
    straddle = p.RecordEvent("straddle").begin()
    events = p.get_events()
    p.stop_profiler(profile_path="", verbose=False)
    p.start_profiler("CPU")
    straddle.end()               # begun in the last session: dropped
    with p.RecordEvent("after_restart"):
        pass
    return events, p.get_events()


def _canon(events):
    main = threading.main_thread().ident
    return [(e["name"], e["parent"], e["tid"] == main) for e in events]


def test_events_and_aggregation_equal_the_reference():
    got, got2 = _script(prof)
    prof.stop_profiler(profile_path="", verbose=False)
    want, want2 = _script(ref_prof)
    ref_prof.stop_profiler(profile_path="", verbose=False)
    assert _canon(got) == _canon(want)
    assert _canon(got2) == _canon(want2) == [("after_restart", "", True)]
    parents = {(e["name"], e["parent"]) for e in got}
    assert ("attention", "train_step/forward") in parents
    assert ("inner", "") in parents and ("decode", "loader") in parents
    assert all(e["name"] not in ("before_start", "straddle") for e in got)


def test_summary_aggregation_equals_the_reference(capsys):
    calls = {}
    for name, p in (("port", prof), ("ref", ref_prof)):
        _script(p)
        p.stop_profiler(profile_path="", verbose=False)
        p.start_profiler("CPU")
        for _ in range(2):
            with p.RecordEvent("step"):
                with p.RecordEvent("fwd"):
                    pass
        agg = p._aggregate()
        calls[name] = {k: v[0] for k, v in agg.items()}
        for c, tot, mx, mn in agg.values():
            assert mn <= tot / c <= mx
        p.stop_profiler(sorted_key="calls", profile_path="", verbose=True)
    assert calls["port"] == calls["ref"] == {"step": 2, "step/fwd": 2}
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert len(out) == 2 * half == 6
    # the same table: header and rows, by name, calls sorted
    strip = [[ln.split()[0], ln.split()[1]] for ln in out]
    assert strip[:half] == strip[half:]


def test_chrome_export_equals_the_reference(tmp_path):
    traces = {}
    for name, p in (("port", prof), ("ref", ref_prof)):
        _script(p)
        path = tmp_path / f"{name}.json"
        p.export_chrome_tracing(str(path))
        traces[name] = json.loads(path.read_text())["traceEvents"]
        assert all(e["ts"] >= 0 for e in traces[name])
        p.stop_profiler(profile_path="", verbose=False)
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                       "tid")}
              for e in traces[n]] for n in ("port", "ref")]
    assert strip[0] == strip[1]
    events, start = prof.snapshot_events()
    assert start > 0 and isinstance(events, list)


def test_stop_writes_the_host_trace_and_the_context_manager(tmp_path):
    path = tmp_path / "profile.json"
    with prof.profiler("CPU", profile_path=str(path)):
        with prof.RecordEvent("work"):
            pass
    assert not prof.is_profiler_enabled()
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names == ["work"]
    assert threading.main_thread().ident in prof.thread_names()
    with pytest.raises(ValueError, match="state"):
        prof.start_profiler("NPU")


def test_device_tracing_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prof.start_profiler("GPU")
    assert not prof.is_profiler_enabled()
    prof.start_profiler("All")          # host ranges only
    with prof.RecordEvent("host"):
        pass
    prof.stop_profiler(profile_path="", verbose=False)
    assert prof.device_profile() is None
    assert [e["name"] for e in prof.get_events()] == ["host"]


def test_train_step_opens_one_range_a_step_while_on():
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.nn.layers.common import Linear
    from paddle_tpu_torch.optimizer import AdamW
    torch.manual_seed(0)
    tr = ParallelTrainer(Linear(4, 4), AdamW(1e-3),
                         lambda out, y: ((out - y) ** 2).mean(),
                         device="cpu")
    x, y = torch.randn(2, 4), torch.randn(2, 4)
    tr.train_step(x, y)
    prof.start_profiler("CPU")
    for _ in range(3):
        tr.train_step(x, y)
    events = prof.get_events()
    prof.stop_profiler(profile_path="", verbose=False)
    assert [(e["name"], e["parent"]) for e in events] == \
        [("train_step", "")] * 3
    tr.train_step(x, y)
    assert prof.get_events() == events
