"""Checkpoints of the port (``paddle_tpu_torch/distributed/checkpoint.py``,
``framework_io.py``, the optimizer's and the trainer's state) against the
JAX package's, on the CPU.

- The manifest's three values under a planted truncation, a flipped byte,
  a missing and an unreadable manifest: the same as the reference's
  ``verify_manifest`` on the same directory, at both levels.
- The same scripted saves and corruptions give the same steps, retention,
  ``latest_valid_step``, restored values and fallback counts as the
  reference's ``CheckpointManager`` (orbax, synchronous).
- Past the retry byte budget (injected ``ckpt_io`` faults) a save stages
  to local disk, as the reference's does, and ``restore`` reads it when no
  primary step restores; a torn commit (``ckpt_torn``) raises
  ``SimulatedCrash`` and leaves the previous step restorable.
- ``TrainEpochRange`` resumes as in the reference's
  ``tests/test_checkpoint.py::test_train_epoch_range_resume``.
- ``framework_io`` reads a float32 file the reference wrote, and the
  reference reads the port's; bfloat16 round-trips through its tagged
  uint16 form.
- The optimizer's ``state_dict`` round-trips (slots, step, scheduler).
- A GPT trainer loaded with the reference's state runs, saves, and a fresh
  trainer restored from the step continues bit for bit like the run that
  never stopped; its losses stay within ``test_torch_gpt_train.py``'s
  tolerance (rtol 1e-4) of the reference trainer on the same path.
- The options and calls of the asynchronous pipeline and the deep tier
  work (their full tests: ``tests/test_torch_async_checkpoint.py``).
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import framework_io as ref_io
from paddle_tpu.distributed import checkpoint as ref_ck
from paddle_tpu.resilience import faults as ref_faults
from tools._mesh_setup import data_mesh

import test_torch_gpt_train as gpt_case
from paddle_tpu_torch import framework_io as io
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.nn.layer import set_trainer_state_from_numpy
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.optimizer import AdamW, lr as tlr
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.text.models import GPTForPretraining
from torch_threads import two_threads  # noqa: F401


def _state(step, n=6):
    w = np.arange(n * 4, dtype=np.float32).reshape(n, 4) * (step + 1)
    return w, np.full((n,), float(step), np.float32)


def _port_state(step):
    w, m = _state(step)
    return {"params": {"w": torch.from_numpy(w)},
            "opt": {"m": torch.from_numpy(m),
                    "step": torch.tensor(step, dtype=torch.int32)}}


def _ref_state(step):
    w, m = _state(step)
    return {"params": {"w": jnp.asarray(w)},
            "opt": {"m": jnp.asarray(m),
                    "step": jnp.asarray(step, jnp.int32)}}


def _tolist(tree):
    if isinstance(tree, dict):
        return {k: _tolist(v) for k, v in tree.items()}
    return np.asarray(tree).tolist()


def _flip_byte(step_dir):
    """Flip one byte in the middle of the largest data file (bit rot: the
    size holds)."""
    files = [os.path.join(root, n) for root, _d, names in os.walk(step_dir)
             for n in names if n != ck.MANIFEST_NAME]
    p = max(files, key=os.path.getsize)
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


# -- the manifest -------------------------------------------------------------------

def test_manifest_three_values_equal_the_reference(tmp_path):
    m = ck.CheckpointManager(str(tmp_path / "m"), max_to_keep=5)
    for s in range(5):
        m.save(s, _port_state(s))
    d = [str(tmp_path / "m" / str(s)) for s in range(5)]

    def both(path, level):
        got = ck.verify_manifest(path, level=level)
        assert got == ref_ck.verify_manifest(path, level=level)
        return got

    assert [both(p, lv) for p in d for lv in ("size", "full")] == [True] * 10
    _flip_byte(d[1])                        # bit rot: size holds, CRC not
    assert (both(d[1], "size"), both(d[1], "full")) == (True, False)
    ck._corrupt_one_file(d[2])              # truncation: both levels
    assert (both(d[2], "size"), both(d[2], "full")) == (False, False)
    os.remove(os.path.join(d[3], ck.MANIFEST_NAME))   # legacy: no manifest
    assert (both(d[3], "size"), both(d[3], "full")) == (None, None)
    with open(os.path.join(d[4], ck.MANIFEST_NAME), "w") as f:
        f.write("{torn")
    assert (both(d[4], "size"), both(d[4], "full")) == (False, False)
    assert m.verify(0) is True and m.verify(1) is False
    # the reference's manifest of the same directory is the port's
    ref_ck.write_manifest(d[0])
    want = ck.verify_manifest(d[0])
    assert want is True


# -- the manager against the reference's --------------------------------------------

SCRIPT = [("save", 0), ("save", 1), ("save", 2), ("truncate", 2),
          ("save", 3), ("flip", 3), ("restore", None), ("save", 4),
          ("truncate", 4), ("truncate", 3), ("restore", None), ("save", 5),
          ("save", 6), ("save", 2), ("restore", 5)]


def _run_script(mgr, state_fn, corrupt, root):
    seen = []
    for op, step in SCRIPT:
        out = None
        if op == "save":
            out = mgr.save(step, state_fn(step))
            mgr.wait_until_finished()
        elif op == "truncate":
            corrupt(os.path.join(root, str(step)))
        elif op == "flip":
            _flip_byte(os.path.join(root, str(step)))
        else:
            out = (_tolist(mgr.restore(step, template=state_fn(0))),
                   mgr.last_restored_step)
        seen.append((op, step, out, sorted(mgr.all_steps()),
                     mgr.latest_step(), mgr.latest_valid_step(),
                     mgr.restore_fallbacks_total))
    return seen


def test_retention_and_fallbacks_equal_the_reference(tmp_path):
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    port = ck.CheckpointManager(port_root, max_to_keep=2)
    ref = ref_ck.CheckpointManager(ref_root, max_to_keep=2, use_async=False)
    try:
        got = _run_script(port, _port_state, ck._corrupt_one_file, port_root)
        want = _run_script(ref, _ref_state, ref_ck._corrupt_one_file,
                           ref_root)
    finally:
        ref.close()
    assert got == want
    # torn steps go as debris, and the last valid step (1) is kept while
    # every newer one is torn; the restores fall back to it
    assert [row[3] for row in got[7:11]] == [[1, 4]] * 4
    assert [row[2][1] for row in got if row[0] == "restore"] == [1, 1, 5]
    assert got[-1][3] == [5, 6] and got[-1][6] == 2


def test_restore_falls_back_past_a_torn_newest_step(tmp_path):
    with telemetry.scope(None, profile=False) as sc:
        m = ck.CheckpointManager(str(tmp_path / "m"), max_to_keep=3)
        for s in (1, 2, 3):
            m.save(s, _port_state(s))
        ck._corrupt_one_file(str(tmp_path / "m" / "3"))
        out = m.restore(template=_port_state(0))
        assert m.last_restored_step == 2 and m.restore_fallbacks_total == 1
        assert torch.equal(out["params"]["w"], _port_state(2)["params"]["w"])
        reg = sc.registry
        assert reg.get("ckpt_restore_fallbacks_total").value(
            reason="manifest") == 1
        assert reg.get("checkpoint_save_seconds").count() == 3
        assert reg.get("checkpoint_restore_seconds").count() == 1
        nbytes = 6 * 4 * 4 + 6 * 4 + 4
        assert reg.get("checkpoint_bytes_total").value(op="save") == \
            3 * nbytes
        assert reg.get("checkpoint_bytes_total").value(op="restore") == \
            nbytes
        assert reg.get("ckpt_step_stall_ms").count() == 3
    with pytest.raises(OSError, match="verification"):
        m.restore(3)


def test_staging_past_the_byte_budget_as_the_reference(tmp_path):
    out = {}
    for name, mod, fmod, state_fn in (
            ("port", ck, faults, _port_state),
            ("ref", ref_ck, ref_faults, _ref_state)):
        root, stage = str(tmp_path / name), str(tmp_path / f"{name}_stage")
        kw = {} if name == "port" else {"use_async": False}
        m = mod.CheckpointManager(root, max_to_keep=2, staging_dir=stage,
                                  **kw)
        m.save(0, state_fn(0))
        # one transient failure: retried, no staging
        with fmod.inject("ckpt_io", times=1) as spec:
            assert m.save(1, state_fn(1))
        assert spec.fired == 1
        # persistent failure: 3 attempts move 3x the state, then stage
        with fmod.inject("ckpt_io", times=10) as spec, \
                warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            assert m.save(2, state_fn(2))
        fired = spec.fired
        staged_warn = [w for w in seen if "staged to local disk" in
                       str(w.message)]
        for s in m.all_steps():
            mod._corrupt_one_file(os.path.join(root, str(s)))
        restored = m.restore(template=state_fn(0))
        out[name] = (fired, len(staged_warn), sorted(m.all_steps()),
                     m.staged_steps(), m.last_restored_step,
                     m.restore_fallbacks_total, _tolist(restored))
        if name == "ref":
            m.close()
    assert out["port"] == out["ref"]
    assert out["port"][:6] == (3, 1, [0, 1], [2], 2, 2)


def test_torn_commit_raises_and_keeps_the_previous_step(tmp_path):
    m = ck.CheckpointManager(str(tmp_path / "m"))
    m.save(1, _port_state(1))
    with faults.inject("ckpt_torn", at_step=2):
        with pytest.raises(faults.SimulatedCrash):
            m.save(2, _port_state(2))
    assert ck.verify_manifest(str(tmp_path / "m" / "2")) is None
    out = m.restore(template=_port_state(0))
    assert m.last_restored_step == 1 and m.restore_fallbacks_total == 1
    assert int(out["opt"]["step"]) == 1
    # a restart replays the step: the torn attempt is replaced
    assert m.save(2, _port_state(2))
    assert m.latest_valid_step() == 2


def test_one_shot_save_and_load(tmp_path):
    path = str(tmp_path / "one")
    state = {"params": {"w": torch.randn(3, 2).bfloat16(),
                        "b": torch.zeros(2)},
             "count": 7, "arr": np.arange(3, dtype=np.int64)}
    assert ck.save_checkpoint(path, state) == path
    flat = ck.load_checkpoint(path)
    assert set(flat) == {"params", "count", "arr"}
    assert int(flat["count"]) == 7 and flat["arr"].tolist() == [0, 1, 2]
    assert set(flat["params"]) == {"w", "b"}
    tmpl = {"params": {"w": torch.empty(3, 2, dtype=torch.bfloat16),
                       "b": torch.empty(2)},
            "count": torch.tensor(0), "arr": torch.zeros(3, dtype=torch.int64)}
    back = ck.load_checkpoint(path, template=tmpl)
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert back["params"]["w"].dtype == torch.bfloat16
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(path, state, overwrite=False)
    bad = dict(tmpl, params={"w": torch.empty(3, 2)})
    with pytest.raises(ValueError, match="missing|extra"):
        ck.load_checkpoint(path, template=bad)
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(path, template=dict(
            tmpl, arr=torch.zeros(4, dtype=torch.int64)))
    with pytest.raises(TypeError):
        ck.save_checkpoint(str(tmp_path / "x"), [torch.zeros(1)])


# -- epochs ---------------------------------------------------------------------------

def test_train_epoch_range_resume_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "jtest")
    seqs = {}
    for name, mod, mk in (("port", ck, lambda e: torch.tensor(e)),
                          ("ref", ref_ck, lambda e: jnp.asarray(e))):
        d = str(tmp_path / name)
        r1 = mod.TrainEpochRange(5, "run", checkpoint_dir=d)
        seen = []
        for e in r1.get():
            seen.append(e)
            r1.save({"epoch": mk(e)})
            if e == 2:
                break                   # preemption
        r2 = mod.TrainEpochRange(5, "run", checkpoint_dir=d)
        seqs[name] = (seen, int(r2.restored_state["epoch"]), list(r2.get()))
    assert seqs["port"] == seqs["ref"] == ([0, 1, 2], 2, [3, 4])


def test_train_epoch_range_generator_autosaves(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "jgen")
    d = str(tmp_path / "auto")
    state = {"w": torch.tensor(0.0)}
    for e in ck.train_epoch_range(3, "g", get_state=lambda: state,
                                  checkpoint_dir=d):
        state = {"w": torch.tensor(float(e))}
    r = ck.TrainEpochRange(3, "g", checkpoint_dir=d)
    assert float(r.restored_state["w"]) == 2.0


# -- framework_io -------------------------------------------------------------------

def test_framework_io_reads_the_reference_and_back(tmp_path):
    rs = np.random.RandomState(0)
    tree = {"w": jnp.asarray(rs.randn(4, 3).astype(np.float32)),
            "nested": {"b": np.arange(5, dtype=np.int32), "lr": 0.5},
            "list": [jnp.ones((2,), jnp.float32), "tag", (1, 2)]}
    ref_path = str(tmp_path / "ref.pdparams")
    ref_io.save(tree, ref_path)
    got = io.load(ref_path)
    want = ref_io.load(ref_path)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["w"], want["w"])
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["nested"]["b"], want["nested"]["b"])
    assert got["nested"]["lr"] == 0.5 and got["list"][1:] == ["tag", (1, 2)]
    # the port's float32 file reads in the reference
    port_path = str(tmp_path / "port.pdparams")
    io.save({"w": torch.from_numpy(np.array(tree["w"])),
             "n": [torch.arange(3), 1.5]}, port_path)
    back = ref_io.load(port_path)
    np.testing.assert_array_equal(back["w"], np.asarray(tree["w"]))
    assert back["n"][0].tolist() == [0, 1, 2] and back["n"][1] == 1.5


def test_framework_io_bfloat16_round_trips(tmp_path):
    torch.manual_seed(0)
    x = torch.randn(5, 7).bfloat16()
    x[0, 0] = float("inf")
    x[0, 1] = float("nan")
    path = str(tmp_path / "bf16.pdparams")
    io.save({"x": x, "view": x[:, 2], "f": x.float()}, path)
    got = io.load(path)
    assert got["x"].dtype == torch.bfloat16 and got["x"].shape == (5, 7)
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["view"].view(torch.int16),
                       x[:, 2].contiguous().view(torch.int16))
    assert got["f"].dtype == np.float32
    # a bf16 state loads into a port layer
    lin = Linear(7, 5).bfloat16()
    lin.set_state_dict_from_numpy({"weight": got["x"].T.contiguous(),
                                   "bias": got["view"]})
    assert torch.equal(lin.weight.view(torch.int16),
                       x.T.contiguous().view(torch.int16))


# -- optimizer and trainer state -------------------------------------------------------

def test_optimizer_state_dict_round_trips():
    sched = tlr.CosineAnnealingDecay(3e-3, 10)
    torch.manual_seed(0)
    tr = ParallelTrainer(Linear(4, 3), AdamW(sched), lambda o, y:
                         ((o - y) ** 2).mean(), device="cpu")
    x, y = torch.randn(6, 4), torch.randn(6, 3)
    for _ in range(3):
        tr.train_step(x, y)
        sched.step()
    sd = tr.optimizer.state_dict()
    assert set(sd) == {"state", "LR_Scheduler"}
    assert set(sd["state"]) == {"step", "slots"}
    assert int(sd["state"]["step"]) == 3
    sched2 = tlr.CosineAnnealingDecay(3e-3, 10)
    opt2 = AdamW(sched2)
    opt2.set_state_dict(sd)
    assert sched2.last_epoch == sched.last_epoch == 3
    assert opt2.get_lr() == tr.optimizer.get_lr()
    for n, slots in sd["state"]["slots"].items():
        for k, v in slots.items():
            assert torch.equal(opt2.state["slots"][n][k], v)
            assert v.dtype == torch.float32
    # the reference's keys, for an optimizer with a state and a scheduler
    ref_opt = paddle.optimizer.AdamW(paddle.optimizer.lr.CosineAnnealingDecay(
        3e-3, 10), parameters=[])
    assert set(ref_opt.state_dict()) == {"LR_Scheduler"}
    assert set(AdamW(1e-3).state_dict()) == set()


def test_trainer_state_round_trips_dtypes_in_place(tmp_path):
    torch.manual_seed(0)
    model = Linear(8, 8).bfloat16()
    tr = ParallelTrainer(model, AdamW(1e-2), lambda o, y:
                         ((o.float() - y) ** 2).mean(), device="cpu")
    x, y = torch.randn(4, 8).bfloat16(), torch.randn(4, 8)
    for _ in range(2):
        tr.train_step(x, y)
    st = tr.state
    assert set(st) == {"params", "buffers", "opt", "comm_err", "guard"}
    assert st["params"]["weight"] is model.weight
    tr.save_checkpoint(str(tmp_path / "tr"))
    torch.manual_seed(1)
    model2 = Linear(8, 8).bfloat16()
    tr2 = ParallelTrainer(model2, AdamW(1e-2), lambda o, y:
                          ((o.float() - y) ** 2).mean(), device="cpu")
    w_id = id(model2.weight)
    tr2.load_checkpoint(str(tmp_path / "tr"))
    assert id(model2.weight) == w_id and model2.weight.dtype == torch.bfloat16
    assert torch.equal(model2.weight, model.weight)
    assert tr2.get_opt_slot("weight", "m").dtype == torch.float32
    assert int(tr2.opt_state["step"]) == 2
    assert torch.equal(tr.train_step(x, y), tr2.train_step(x, y))
    bad = tr2.state
    bad["params"] = dict(bad["params"], weight=model2.weight.float())
    with pytest.raises(ValueError, match="does not match"):
        tr2.state = bad


def test_gpt_trainer_resumes_bit_for_bit_from_the_reference_state(tmp_path):
    """The reference trains two steps; its state loads into the port; the
    port runs one step, saves, and runs three more (run A). A fresh port
    trainer restores the saved step and runs three (run B): B equals A's
    last three bit for bit, losses and parameters. Every port loss stays
    within rtol 1e-4 of the reference trainer's on the same steps."""
    ref, port = gpt_case._pair()
    ref_tr, port_tr = gpt_case._trainers(ref, port)
    batch = gpt_case._batch()
    tb = tuple(torch.from_numpy(a) for a in batch)
    ref_losses = [float(ref_tr.train_step(batch, 0.0)) for _ in range(2)]
    set_trainer_state_from_numpy(
        port_tr, jax.tree_util.tree_map(np.asarray, ref_tr.state))
    ref_losses += [float(ref_tr.train_step(batch, 0.0)) for _ in range(4)]
    mgr = ck.CheckpointManager(str(tmp_path / "gpt"), max_to_keep=2)
    run_a = [port_tr.train_step(tb, 0.0)]
    assert mgr.save(3, port_tr.state)
    run_a += [port_tr.train_step(tb, 0.0) for _ in range(3)]
    np.testing.assert_allclose([float(x) for x in run_a], ref_losses[2:],
                               rtol=1e-4)

    torch.manual_seed(123)
    data_mesh(1)
    fresh = GPTForPretraining(**gpt_case.CFG)
    tr_b = ParallelTrainer(gpt_case._port_loss_layer(fresh), AdamW(3e-4),
                           lambda out, _l: out, device="cpu")
    tr_b.state = mgr.restore(template=tr_b.state)
    assert mgr.last_restored_step == 3
    run_b = [tr_b.train_step(tb, 0.0) for _ in range(3)]
    for a, b in zip(run_a[1:], run_b):
        assert torch.equal(a, b)
    for name, p in port_tr.params.items():
        assert torch.equal(p, tr_b.params[name]), name
    assert int(tr_b.opt_state["step"]) == int(port_tr.opt_state["step"]) == 6


# -- the options the manager once refused -----------------------------------------

@pytest.mark.parametrize("kw", [dict(async_commit=True),
                                dict(deep_every=2), dict(deep_digests=True),
                                dict(dirty_probe=lambda: False)])
def test_async_and_deep_raise_naming_item_25(tmp_path, kw):
    """Each of these options builds a working manager (they raised before
    the asynchronous pipeline and the deep tier were ported): two saves
    commit, restore reads the newest, and the deep options record digests
    on the first save."""
    m = ck.CheckpointManager(str(tmp_path / "m"), **kw)
    try:
        for s in (1, 2):
            assert m.save(s, _port_state(s))
            m.wait_until_finished()
        out = m.restore(template=_port_state(0))
        assert m.last_restored_step == 2
        assert torch.equal(out["params"]["w"], _port_state(2)["params"]["w"])
        assert bool(m._manifest_arrays(1)) == ("deep_every" in kw or
                                               "deep_digests" in kw)
        assert m.async_commit == ("async_commit" in kw)
    finally:
        m.close()


def test_deep_calls_and_async_save_raise_naming_item_25(tmp_path):
    """The calls that raised before the deep tier and the asynchronous
    save were ported now work: a deep save, deep and prefer-deep
    restores, a deep verify, and an asynchronous one-shot save."""
    m = ck.CheckpointManager(str(tmp_path / "m"))
    m.save(0, _port_state(0))
    assert m.save(1, _port_state(1), deep=True)
    assert not m._manifest_arrays(0) and m._manifest_arrays(1)
    assert m.verify(0, deep=True) is True and m.verify(1, deep=True) is True
    m.restore(deep=True)
    assert m.last_restored_step == 1
    m.restore(prefer_deep=True)
    assert m.last_restored_step == 1 and m.restore_fallbacks_total == 0
    handle = ck.save_checkpoint(str(tmp_path / "a"), _port_state(0),
                                use_async=True)
    assert handle.wait_until_finished(timeout=20.0) == str(tmp_path / "a")
    out = ck.load_checkpoint(str(tmp_path / "a"), template=_port_state(0))
    assert torch.equal(out["params"]["w"], _port_state(0)["params"]["w"])
