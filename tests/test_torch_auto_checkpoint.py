"""The port's auto-checkpoint (``incubate.checkpoint.auto_checkpoint``)
against the JAX package's, on the CPU.

A run of ``train_epoch_range(5)`` over a small state (a weight vector
and a step counter, registered with ``add_state``) is interrupted inside
epoch 2; a fresh range over the same directory restores the state saved
after epoch 1 and resumes at epoch 2. The epochs visited, the restored
epoch and the final state equal an uninterrupted run's and the
reference's. ``AutoCheckpointChecker`` reads the reference's environment
variables, and without a directory nothing is saved.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.checkpoint import auto_checkpoint as rac

from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as pac
from torch_threads import two_threads  # noqa: F401

EPOCHS, STOP_AT = 5, 2


class _Interrupted(Exception):
    pass


def _run(ac, new, to_np, ckpt_dir, stop_at=None):
    """Epochs visited and the final state of one (possibly interrupted)
    run; each epoch adds epoch + 1 to the weights and counts a step."""
    state = {"w": new(np.arange(4, dtype=np.float32)),
             "steps": new(np.zeros((), np.int32))}

    def get():
        return dict(state)

    def put(restored):
        state.update(restored)

    r = ac.train_epoch_range(EPOCHS, save_checkpoint_inter=0,
                             checkpoint_dir=ckpt_dir)
    r.add_state(get, put)
    seen = []
    try:
        for epoch in r:
            seen.append(epoch)
            state["w"] = state["w"] + (epoch + 1)
            state["steps"] = state["steps"] + 1
            if epoch == stop_at:
                raise _Interrupted()
    except _Interrupted:
        pass
    return seen, r.restored_from, {k: to_np(v) for k, v in state.items()}


PACKAGES = {
    "ref": (rac, jnp.asarray, np.asarray),
    "port": (pac, torch.from_numpy, lambda t: t.numpy()),
}


def test_interrupted_range_resumes_at_the_next_epoch(tmp_path):
    ac, new, to_np = PACKAGES["port"]
    whole = _run(ac, new, to_np, str(tmp_path / "whole"))
    assert whole[0] == list(range(EPOCHS)) and whole[1] is None
    first = _run(ac, new, to_np, str(tmp_path / "cut"), stop_at=STOP_AT)
    assert first[0] == list(range(STOP_AT + 1))
    second = _run(ac, new, to_np, str(tmp_path / "cut"))
    assert second[0] == list(range(STOP_AT, EPOCHS))
    assert second[1] == STOP_AT - 1
    for k, v in whole[2].items():
        np.testing.assert_array_equal(second[2][k], v)
    assert int(second[2]["steps"]) == EPOCHS


def test_port_matches_the_reference(tmp_path):
    """The interrupted and the resumed run of each package: the same
    epochs, the same restored epoch, the same states."""
    runs = {}
    for pkg, (ac, new, to_np) in PACKAGES.items():
        d = str(tmp_path / pkg)
        runs[pkg] = (_run(ac, new, to_np, d, stop_at=STOP_AT),
                     _run(ac, new, to_np, d))
    for (a, b) in zip(runs["port"], runs["ref"]):
        assert a[0] == b[0] and a[1] == b[1]
        for k in a[2]:
            np.testing.assert_array_equal(a[2][k], b[2][k])


def test_checker_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setattr(pac, "_CHECKER", None)
    monkeypatch.delenv("PADDLE_JOB_ID", raising=False)
    monkeypatch.delenv("PADDLE_EDL_HDFS_HOME", raising=False)
    monkeypatch.delenv("PADDLE_AUTO_CHECKPOINT_DIR", raising=False)
    assert not pac.AutoCheckpointChecker().valid
    # no directory: the range runs and saves nothing
    seen, restored, _ = _run(pac, torch.from_numpy, lambda t: t.numpy(),
                             None)
    assert seen == list(range(EPOCHS)) and restored is None
    monkeypatch.setenv("PADDLE_JOB_ID", "job7")
    monkeypatch.setenv("PADDLE_EDL_HDFS_HOME", str(tmp_path))
    monkeypatch.setenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "0")
    c = pac.AutoCheckpointChecker()
    assert c.valid and c.checkpoint_dir() == str(tmp_path / "job7")
    assert c.save_checkpoint_inter == 0
    # the checker is read once a process, as the reference's is
    monkeypatch.setattr(pac, "_CHECKER", None)
    r = pac.train_epoch_range(3, name="run")
    assert r._dir == str(tmp_path / "job7" / "run")
