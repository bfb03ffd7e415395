"""``run_resilient`` of the port against the JAX package's, on the CPU.

Both sides train the reference's hostsim MLP (``resilience/hostsim.py``:
8 -> 16 -> 4, Momentum 0.05/0.9, the int8 exchange in 8-element blocks)
at data degree 1, the port's weights carried from the reference's trainer
(``set_trainer_state_from_numpy``), on the same numpy batches and under
the same faults, each side with a synchronous ``CheckpointManager`` in
its own directory. Every case must give the same ``RunResult`` fields
(exit code, status, steps done, last step, restarts, skipped steps,
restore fallbacks and the rest) and the same counters, and the losses of
every step taken (replays included) must agree; the one case that
differs says where and why.

Loss tolerance, rtol 1e-5: the two frameworks run the same float32 MLP
with sums in other orders (XLA against ATen), a few float32 roundings
(2**-24 relative each) per output; the int8 quantizer rounds each
gradient element to one of 255 levels of its block's scale, so a last-bit
difference changes a quantized value only when an element sits within
that difference of a rounding boundary, which none of these few steps
hits (the residuals carry the difference forward unamplified). Ten steps
of Momentum grow the relative gap of the loss to a few times 1e-7 (read:
at most 1.7e-7); 1e-5 leaves more than fifty times that.

The dropout case trains a small GPT (dropout 0.1 on attention and hidden)
on the port alone: a run drained by SIGTERM and resumed on a fresh model
equals the uninterrupted one bit for bit, and the same resume without
restoring the generator states does not, so the saved philox/CPU
generator state is what keeps it exact.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.telemetry as ref_tel
from paddle_tpu.distributed.checkpoint import \
    CheckpointManager as RefCheckpointManager
from paddle_tpu.distributed.fleet.elastic import \
    ElasticStatus as RefElasticStatus
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import hostsim as ref_hostsim
from paddle_tpu.resilience import run_resilient as ref_run

from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.fleet.elastic import ElasticStatus
from paddle_tpu_torch.nn.layer import set_trainer_state_from_numpy
from paddle_tpu_torch.resilience import faults, hostsim, run_resilient
from paddle_tpu_torch.resilience import runner
from torch_threads import two_threads  # noqa: F401

LOSS_RTOL = 1e-5
RESULT_FIELDS = ("exit_code", "status", "steps_done", "last_step",
                 "restarts", "skipped_steps", "restore_fallbacks",
                 "remeshes", "barrier_steps", "divergences",
                 "hosts_quarantined", "rollback_steps", "hangs")
COUNTERS = ("resilience_faults_injected_total", "resilience_restarts_total",
            "resilience_resumes_total", "resilience_steps_skipped",
            "ckpt_restore_fallbacks_total", "retries_total",
            "retry_exhausted_total")


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


@contextlib.contextmanager
def _registries():
    """Fresh telemetry registries on both sides, enabled."""
    old = (tel.get_registry(), tel.enabled(), ref_tel.get_registry(),
           ref_tel.enabled())
    regs = (tel.Registry(), ref_tel.Registry())
    tel._set_registry(regs[0])
    ref_tel._set_registry(regs[1])
    tel.enable(True)
    ref_tel.enable(True)
    try:
        yield regs
    finally:
        tel._set_registry(old[0])
        tel.enable(old[1])
        ref_tel._set_registry(old[2])
        ref_tel.enable(old[3])


def _counters(reg):
    d = reg.to_dict()
    return {k: d[k]["series"] for k in COUNTERS if k in d}


class _Logged:
    """Records the loss of every train_step the runner takes."""

    def __init__(self, trainer):
        self.losses = []
        inner = trainer.train_step

        def step(*a, **kw):
            loss = inner(*a, **kw)
            self.losses.append(float(np.asarray(loss)))
            return loss

        trainer.train_step = step


def _pair():
    ref_tr = ref_hostsim._tiny_trainer(seed=7, data_degree=1)
    port = hostsim._tiny_trainer(seed=7, device="cpu")
    set_trainer_state_from_numpy(port, jax.tree_util.tree_map(
        np.asarray, ref_tr.state))
    return ref_tr, port


def _batches():
    return ref_hostsim._tiny_batches()


def _both(tmp_path, runs, faults_spec=(), **kw):
    """Run ``runs`` run_resilient calls on each side under the same armed
    faults -> ({side: [RunResult or exception type]}, losses, counters)."""
    out = {}
    with _registries() as (reg, ref_reg):
        for side, run, inj, mgr_cls in (
                ("ref", ref_run, ref_faults.inject, RefCheckpointManager),
                ("port", run_resilient, faults.inject, CheckpointManager)):
            ref_tr, port = _pair()
            tr = ref_tr if side == "ref" else port
            log = _Logged(tr)
            mgr = mgr_cls(str(tmp_path / side), max_to_keep=3,
                          use_async=False)
            results = []
            with contextlib.ExitStack() as stack:
                for kind, at, times in faults_spec:
                    stack.enter_context(inj(kind, at_step=at, times=times))
                for _ in range(runs):
                    try:
                        results.append(run(tr, _batches(), manager=mgr,
                                           **kw))
                    except Exception as e:       # noqa: BLE001
                        results.append(type(e).__name__)
            mgr.close()
            out[side] = (results, log.losses)
        counters = {"ref": _counters(ref_reg), "port": _counters(reg)}
    return out, counters


def _assert_parity(out, counters, skip=()):
    """Same results (``skip``: fields and counters left out, each case
    says why), same losses, same counters."""
    (ref_res, ref_losses), (res, losses) = out["ref"], out["port"]
    assert len(res) == len(ref_res)
    fields = [f for f in RESULT_FIELDS if f not in skip]
    for a, b in zip(res, ref_res):
        if isinstance(b, str):
            assert a == b
            continue
        assert {f: getattr(a, f) for f in fields} == \
            {f: getattr(b, f) for f in fields}
        if b.loss is None:
            assert a.loss is None
        else:
            np.testing.assert_allclose(a.loss, float(b.loss),
                                       rtol=LOSS_RTOL)
    assert len(losses) == len(ref_losses)
    if "losses" not in skip:
        np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert {k: v for k, v in counters["port"].items() if k not in skip} \
        == {k: v for k, v in counters["ref"].items() if k not in skip}


def test_no_fault(tmp_path):
    out, counters = _both(tmp_path, 1, steps=6)
    _assert_parity(out, counters)
    assert out["port"][0][0].exit_code == 0


def test_torn_commit_nan_grad_sigterm_then_resume(tmp_path):
    """The reference's chaos run: ckpt_torn at 3, nan_grad at 5, sigterm
    at 7, then a second call resumes to the end.

    One difference, of the reference's storage: its torn step 3 (no
    manifest, the largest file of the orbax directory truncated) still
    reads back for this small MLP, so it resumes from step 3 and counts no
    fallback; the port's truncated ``.pt`` file fails to load, so it falls
    back to step 2 (one fallback, ``reason=restore``, as the reference's
    chaos run counts at GPT size) and replays step 3, bit for bit. Beside
    that replayed step, every loss, result field and counter agrees."""
    out, counters = _both(
        tmp_path, 2, [("ckpt_torn", 3, 1), ("nan_grad", 5, 1),
                      ("sigterm", 7, 1)], steps=10)
    (ref_res, ref_losses), (res, losses) = out["ref"], out["port"]
    assert losses[4] == losses[3]          # step 3 replayed, bit for bit
    del losses[4]
    _assert_parity({"ref": (ref_res, ref_losses), "port": (res, losses)},
                   counters, skip=("restore_fallbacks",
                                   "ckpt_restore_fallbacks_total"))
    first, second = res
    assert (first.exit_code, first.status) == (143, "sigterm")
    assert (second.exit_code, second.status) == (0, "completed")
    assert (second.steps_done, first.restarts, second.skipped_steps,
            second.restore_fallbacks) == (10, 1, 1, 1)
    assert [r.restore_fallbacks for r in ref_res] == [0, 0]
    assert counters["port"]["ckpt_restore_fallbacks_total"] == \
        {"reason=restore": 1}


def test_data_fetch_under_retry(tmp_path):
    out, counters = _both(tmp_path, 1, [("data_fetch", 1, 1)], steps=4)
    _assert_parity(out, counters)
    assert counters["port"]["retries_total"] == {"site=dataloader_fetch": 1}


def test_max_restarts_exceeded(tmp_path):
    """Every save tears: the third restart past ``max_restarts=2`` raises
    on both sides, after the same number of steps. The losses part ways
    for the storage reason of the chaos case: the reference reads its torn
    step 0 back and goes on to steps 1 and 2, the port finds nothing that
    restores and retrains step 0 on its live state, as the reference does
    when nothing restores (so it also counts no resume)."""
    out, counters = _both(tmp_path, 1, [("ckpt_torn", None, 100)],
                          steps=5, max_restarts=2)
    _assert_parity(out, counters, skip=("losses",
                                        "ckpt_restore_fallbacks_total",
                                        "resilience_resumes_total"))
    assert out["port"][0] == ["SimulatedCrash"]
    assert len(out["port"][1]) == 3
    assert counters["port"]["resilience_restarts_total"] == {"": 3}


def test_restart_verdict_exits_75(tmp_path):
    class FakeElastic:
        def __init__(self, status):
            self.calls, self.status = 0, status

        def watch(self, proc_alive=lambda: True):
            self.calls += 1
            return self.status.RESTART if self.calls > 2 \
                else self.status.HOLD

    with _registries():
        res = {}
        for side, run, mgr_cls, st in (
                ("ref", ref_run, RefCheckpointManager, RefElasticStatus),
                ("port", run_resilient, CheckpointManager, ElasticStatus)):
            ref_tr, port = _pair()
            mgr = mgr_cls(str(tmp_path / side), use_async=False)
            res[side] = run(ref_tr if side == "ref" else port, _batches(),
                            steps=10, manager=mgr, elastic=FakeElastic(st))
            res[side + "_latest"] = mgr.latest_valid_step()
            mgr.close()
    assert {f: getattr(res["port"], f) for f in RESULT_FIELDS} == \
        {f: getattr(res["ref"], f) for f in RESULT_FIELDS}
    assert (res["port"].exit_code, res["port"].status,
            res["port"].steps_done) == (75, "restart", 2)
    assert res["port_latest"] == res["ref_latest"] == 1


def test_rng_and_cursor_ride_the_checkpoint(tmp_path):
    tr = hostsim._tiny_trainer(device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    run_resilient(tr, _batches(), steps=3, manager=mgr)
    torch.manual_seed(0)
    want = runner._rng_state()
    restored = mgr.restore(template={"trainer": tr.state,
                                     "meta": runner._meta(0, 0, 0)})
    meta = restored["meta"]
    assert (int(meta["step"]), int(meta["epoch"]), int(meta["batch"])) \
        == (2, 0, 3)
    assert torch.equal(meta["rng"]["cpu"], want["cpu"])
    mgr.close()


# ---------------------------------------------------------------------------
# dropout: the generator state keeps the resume bit for bit
# ---------------------------------------------------------------------------

def _gpt_trainer():
    from paddle_tpu_torch import framework, nn, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.text.models import GPTForPretraining
    framework.seed(3)
    model = GPTForPretraining(
        tensor_parallel=False, vocab_size=96, hidden_size=32, num_layers=2,
        num_heads=2, max_position_embeddings=16, attn_dropout=0.1,
        hidden_dropout=0.1)
    return ParallelTrainer(
        model, optimizer.AdamW(1e-3),
        lambda logits, lbl: nn.functional.cross_entropy(logits, lbl),
        device="cpu")


def _gpt_batches():
    rs = np.random.RandomState(5)
    return [(rs.randint(0, 96, (4, 16)).astype(np.int64),
             rs.randint(0, 96, (4, 16)).astype(np.int64)) for _ in range(3)]


def _gpt_run(root, fault_at=None, restore_rng=True):
    mgr = CheckpointManager(root, max_to_keep=3)
    tr = _gpt_trainer()
    log = _Logged(tr)
    with contextlib.ExitStack() as stack:
        if fault_at is not None:
            stack.enter_context(faults.inject("sigterm", at_step=fault_at))
        first = run_resilient(tr, _gpt_batches(), steps=8, manager=mgr)
    results = [first]
    if first.exit_code:
        tr = _gpt_trainer()                 # a fresh process's model
        log = _Logged(tr)
        set_rng = runner._set_rng_state
        if not restore_rng:
            runner._set_rng_state = lambda *a, **k: None
        try:
            results.append(run_resilient(tr, _gpt_batches(), steps=8,
                                         manager=mgr))
        finally:
            runner._set_rng_state = set_rng
    mgr.close()
    params = {k: v.detach().clone() for k, v in tr.params.items()}
    slots = {k: {s: t.clone() for s, t in v.items()}
             for k, v in tr.opt_state["slots"].items()}
    return results, log.losses, params, slots


def test_dropout_resume_is_bit_exact(tmp_path):
    (a,), losses_a, params_a, slots_a = _gpt_run(str(tmp_path / "a"))
    (b1, b2), losses_b, params_b, slots_b = _gpt_run(str(tmp_path / "b"),
                                                     fault_at=4)
    assert a.exit_code == 0 and (b1.exit_code, b2.exit_code) == (143, 0)
    assert b2.steps_done == 8
    assert losses_b == losses_a[4:]
    assert all(torch.equal(params_b[k], params_a[k]) for k in params_a)
    assert all(torch.equal(slots_b[k][s], slots_a[k][s])
               for k in slots_a for s in slots_a[k])
    # without the generator states the resumed masks differ
    (_, _), losses_c, params_c, _ = _gpt_run(str(tmp_path / "c"),
                                             fault_at=4, restore_rng=False)
    assert losses_c != losses_a[4:]
    assert not all(torch.equal(params_c[k], params_a[k]) for k in params_a)


# ---------------------------------------------------------------------------
# the card's run A / run B at a small size, with the asynchronous pipeline
# ---------------------------------------------------------------------------

def _ab_run(root, faulted):
    """chip_smoke.py's ``resilient`` runs on a small GPT: 10 steps, an
    integrity check every 2, ``CheckpointManager(async_commit=True,
    deep_every=2)`` saving every 2 steps, ``nan_grad`` at 4; run B adds
    ``ckpt_torn`` at 2 and ``sigterm`` at 7, then a fresh trainer and
    manager resume."""
    batches = _gpt_batches()
    kinds = [("nan_grad", 4)] + ([("ckpt_torn", 2), ("sigterm", 7)]
                                 if faulted else [])
    results, losses = [], []
    with contextlib.ExitStack() as stack:
        for kind, at in kinds:
            stack.enter_context(faults.inject(kind, at_step=at))
        for attempt in range(2):
            tr = _gpt_trainer()
            tr.integrity_check_every = 2
            log = _Logged(tr)
            mgr = CheckpointManager(root, max_to_keep=3, async_commit=True,
                                    deep_every=2)
            results.append(run_resilient(tr, batches, steps=10, manager=mgr,
                                         save_every=2))
            fallbacks = mgr.restore_fallbacks_total
            mgr.close()
            losses.append(log.losses)
            if results[-1].exit_code == 0:
                break
    return results, losses, tr, fallbacks


def test_async_drain_restart_resume_equals_the_uninterrupted_run(tmp_path):
    (a,), (losses_a,), tr_a, _ = _ab_run(str(tmp_path / "a"), False)
    (b1, b2), (first, second), tr_b, fallbacks = _ab_run(
        str(tmp_path / "b"), True)
    assert (a.exit_code, a.skipped_steps, a.steps_done) == (0, 1, 10)
    # the torn save surfaces at once: steps 0-2, then 1-6 after the restart
    assert (b1.exit_code, b1.restarts, b1.skipped_steps) == (143, 1, 1)
    assert first[:3] == losses_a[:3] and first[3:] == losses_a[1:7]
    # the drain kept the deep step 6, so the resume starts at 7
    assert (b2.exit_code, b2.steps_done, b2.skipped_steps) == (0, 10, 1)
    assert second == losses_a[7:]
    # an aborted asynchronous commit is debris, not a fallback
    assert (b1.restore_fallbacks, b2.restore_fallbacks, fallbacks) == \
        (0, 0, 0)
    assert all(torch.equal(p, tr_a.params[k]) for k, p in tr_b.params.items())
    assert all(torch.equal(t, tr_a.opt_state["slots"][k][s])
               for k, v in tr_b.opt_state["slots"].items()
               for s, t in v.items())
