"""The port's asynchronous checkpoint pipeline and deep tier
(``paddle_tpu_torch/distributed/checkpoint.py``), on the CPU: the cases of
the JAX package's ``tests/test_async_checkpoint.py`` (``TestAsyncPipeline``,
``TestDirtyInflight`` and ``TestTiers`` without the resilient runner's
cases, ``TestAbortedCommitDebris``, ``TestStallAttribution`` without the
hapi callback) and ``tests/test_integrity.py``'s ``TestDeepVerify`` without
replay, run on the port's manager; where the reference's manager runs the
same script (orbax, synchronous), both give the same steps and fallback
counts.

Beyond the reference's cases: the double buffer under a held commit (one
superseded, two committed, the snapshot buffers reused), a committer's
other errors surfacing as a warning, ``save_checkpoint(use_async=True)``
and the trainer's, and the tamper-and-fallback script ``chip_smoke.py``'s
``async_checkpoint`` phase runs at GPT-base size.

Every test runs under a 60 s limit (``SIGALRM``), so a hang of the
committer fails one test and cannot cut the suite; every wait on the
committer takes a timeout.
"""
import json
import os
import signal
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as ref_ck
from paddle_tpu.resilience import integrity as ref_integrity

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed.checkpoint import (PENDING_PREFIX,
                                                     CheckpointManager)
from paddle_tpu_torch.resilience import faults, integrity

LIMIT_S = 60
WAIT_S = 20.0


class _Overtime(Exception):
    pass


@pytest.fixture(autouse=True)
def _per_test_limit():
    """Fail a test that runs past ``LIMIT_S`` (tests run on the main
    thread, where the alarm's handler runs)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _raise(signum, frame):
        raise _Overtime(f"test ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture()
def managers():
    """Managers made through ``make``, each closed at the end (its
    committer stopped, joined with a timeout)."""
    made = []

    def make(*args, **kwargs):
        m = CheckpointManager(*args, **kwargs)
        made.append(m)
        return m

    yield make
    for m in made:
        m.resume_commits()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                m.close()
            except faults.SimulatedCrash:
                pass
        assert m._commit_thread is None or not m._commit_thread.is_alive()


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(32, 8).astype(np.float32),
            "b": rng.randn(8).astype(np.float32),
            "step": np.int64(seed)}   # a numpy scalar leaf


def _digests(state):
    return integrity.tree_digests(
        {k: ck._leaf_tensor(v) for k, v in state.items()})


def _flush(m):
    assert m.flush(timeout=WAIT_S)


def _largest_payload(step_dir):
    files = [os.path.join(r, n) for r, _d, names in os.walk(step_dir)
             for n in names if not n.startswith("MANIFEST")]
    return max(files, key=os.path.getsize)


def _tamper_reattested(step_dir, crc=ck._crc_file):
    """Flip one payload byte, then re-attest the file's CRC: the file
    layer passes, only the content digests can catch it."""
    p = _largest_payload(step_dir)
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x01]))
    mpath = os.path.join(step_dir, ck.MANIFEST_NAME)
    with open(mpath) as f:
        man = json.load(f)
    man["files"][os.path.relpath(p, step_dir)] = {
        "size": os.path.getsize(p), "crc32": crc(p)}
    with open(mpath, "w") as f:
        json.dump(man, f)


# -- the asynchronous pipeline --------------------------------------------------

class TestAsyncPipeline:
    def test_roundtrip_bitwise_identical_to_sync(self, tmp_path, managers):
        states = [_state(i) for i in range(3)]
        ms = managers(str(tmp_path / "sync"), max_to_keep=5)
        ma = managers(str(tmp_path / "async"), async_commit=True,
                      max_to_keep=5)
        for i, st in enumerate(states):
            ms.save(i, st)
            ma.save(i, st)
            _flush(ma)   # each commits, none superseded
        for i, st in enumerate(states):
            ref = _digests(st)
            assert not integrity.compare_digests(
                ref, integrity.tree_digests(ms.restore(i)))
            assert not integrity.compare_digests(
                ref, integrity.tree_digests(ma.restore(i)))
        assert ma.committed_total == 3 and ma.accounted()

    def test_save_returns_before_commit(self, tmp_path, managers):
        m = managers(str(tmp_path), async_commit=True, commit_delay=0.3)
        t0 = time.perf_counter()
        m.save(1, _state())
        assert time.perf_counter() - t0 < 0.25   # the snapshot, no IO
        assert m.inflight() >= 1
        _flush(m)
        assert m.inflight() == 0
        assert m.latest_valid_step() == 1

    def test_double_buffer_supersedes_staged_snapshot(self, tmp_path,
                                                      managers):
        m = managers(str(tmp_path), async_commit=True, max_to_keep=8)
        m.pause_commits()
        for s in (1, 2, 3, 4):
            m.save(s, _state(s))
        m.resume_commits()
        _flush(m)
        # only the newest staged snapshot commits
        assert m.committed_total == 1
        assert m.superseded_total == 3
        assert m.snapshots_total == 4 and m.accounted()
        assert m.latest_valid_step() == 4
        assert m.all_steps() == [4]

    def test_held_commit_two_more_saves_supersede_one(self, tmp_path,
                                                      managers):
        """``commit_delay`` holds the first commit while two more saves
        arrive: the second is staged, the third supersedes it, and the
        pipeline reuses two snapshot buffers throughout."""
        m = managers(str(tmp_path), async_commit=True, max_to_keep=8,
                     commit_delay=0.5)
        m.save(1, _state(1))
        deadline = time.monotonic() + WAIT_S
        while m._committing is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert m._committing == 1
        m.save(2, _state(2))
        m.save(3, _state(3))
        assert m.superseded_total == 1 and m.inflight() == 2
        assert len(m._buffers) == 2
        _flush(m)
        assert m.committed_total == 2 and m.accounted()
        assert m.all_steps() == [1, 3]
        kept = [id(b) for b in m._buffers]
        for s in (4, 5, 6):
            m.save(s, _state(s))
            _flush(m)
        assert len(m._buffers) <= 2 and \
            all(id(b) in kept for b in m._buffers)
        out = m.restore(6)
        assert not integrity.compare_digests(
            _digests(_state(6)), integrity.tree_digests(out))

    def test_restore_flushes_inflight_commit(self, tmp_path, managers):
        m = managers(str(tmp_path), async_commit=True, commit_delay=0.15)
        st = _state(5)
        m.save(5, st)
        out = m.restore()   # sees the committed step, does not race it
        assert m.last_restored_step == 5
        assert not integrity.compare_digests(_digests(st),
                                             integrity.tree_digests(out))

    def test_wait_until_finished_drains_pipeline(self, tmp_path, managers):
        m = managers(str(tmp_path), async_commit=True, commit_delay=0.05)
        m.save(1, _state())
        m.wait_until_finished()
        assert m.inflight() == 0 and m.latest_valid_step() == 1

    def test_committer_simulated_crash_surfaces_at_flush(self, tmp_path,
                                                         managers):
        m = managers(str(tmp_path), async_commit=True, max_to_keep=5)
        m.save(1, _state(1))
        _flush(m)
        with faults.inject("ckpt_torn", at_step=2):
            m.save(2, _state(2))
            with pytest.raises(faults.SimulatedCrash):
                m.flush(timeout=WAIT_S)
        # the aborted step is debris (a marker, no manifest): the previous
        # valid step stands, and restoring past it costs no fallback
        assert m.failed_total == 1
        assert m.latest_valid_step() == 1
        m.restore()
        assert m.last_restored_step == 1
        assert m.restore_fallbacks_total == 0

    def test_other_commit_errors_warn_at_flush(self, tmp_path, managers):
        def probe():
            raise OSError("probe failed")

        m = managers(str(tmp_path), async_commit=True, dirty_probe=probe)
        m.save(1, _state(1))
        with pytest.warns(RuntimeWarning, match="probe failed"):
            _flush(m)
        assert m.failed_total == 1 and m.accounted()
        assert m.all_steps() == []

    def test_aborted_commit_debris_reclaimed_on_replay(self, tmp_path,
                                                       managers):
        root = str(tmp_path)
        m = managers(root, async_commit=True, max_to_keep=5)
        m.save(1, _state(1))
        _flush(m)
        with faults.inject("ckpt_torn", at_step=2):
            m.save(2, _state(2))
            with pytest.raises(faults.SimulatedCrash):
                m.flush(timeout=WAIT_S)
        assert os.path.exists(os.path.join(root, PENDING_PREFIX + "2"))
        # the restart replays step 2: the commit clears the marker
        m.save(2, _state(2))
        _flush(m)
        assert m.latest_valid_step() == 2
        assert not os.path.exists(os.path.join(root, PENDING_PREFIX + "2"))
        assert m.accounted()

    def test_one_shot_async_save_keeps_one_write_in_flight(self, tmp_path):
        st = {"params": {"w": torch.randn(64, 8).bfloat16()},
              "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
        first = ck.save_checkpoint(str(tmp_path / "a"), st, use_async=True)
        assert isinstance(first, ck.AsyncSave)
        second = ck.save_checkpoint(str(tmp_path / "b"), st, use_async=True)
        # the second save waited for the first
        assert first.wait_until_finished(timeout=0) == str(tmp_path / "a")
        assert second.wait_until_finished(timeout=WAIT_S) == \
            str(tmp_path / "b")
        for name in ("a", "b"):
            out = ck.load_checkpoint(str(tmp_path / name), template=st)
            assert torch.equal(out["params"]["w"], st["params"]["w"])
            assert out["params"]["w"].dtype == torch.bfloat16
        with faults.inject("ckpt_io", times=10), \
                warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            staged = ck.save_checkpoint(
                str(tmp_path / "c"), st, use_async=True,
                staging_dir=str(tmp_path / "stage_c"))
            assert staged.wait_until_finished(timeout=WAIT_S) == \
                str(tmp_path / "stage_c")

    def test_trainer_saves_asynchronously(self, tmp_path):
        from paddle_tpu_torch.distributed.engine import ParallelTrainer
        from paddle_tpu_torch.distributed.mesh import build_mesh
        from paddle_tpu_torch.nn.layers.common import Linear
        from paddle_tpu_torch.optimizer import Momentum
        torch.manual_seed(0)
        tr = ParallelTrainer(Linear(8, 4), Momentum(0.05, momentum=0.9),
                             lambda out, y: ((out - y) ** 2).mean(),
                             mesh=build_mesh({"data": 1}), device="cpu")
        x, y = torch.randn(16, 8), torch.randn(16, 4)
        tr.train_step(x, y)
        handle = tr.save_checkpoint(str(tmp_path / "t"), use_async=True)
        handle.wait_until_finished(timeout=WAIT_S)
        want = {k: v.clone() for k, v in tr.params.items()}
        tr.train_step(x, y)
        tr.load_checkpoint(str(tmp_path / "t"))
        for k, v in tr.params.items():
            assert torch.equal(v, want[k])


# -- the dirty probe against an in-flight snapshot --------------------------------

class TestDirtyInflight:
    def test_verdict_between_snapshot_and_commit_suppresses(self, tmp_path,
                                                            managers):
        dirty = {"v": False}
        m = managers(str(tmp_path), async_commit=True,
                     dirty_probe=lambda: dirty["v"])
        m.save(1, _state(1))
        _flush(m)
        m.pause_commits()
        m.save(2, _state(2))   # a tainted snapshot staged, not committed
        dirty["v"] = True       # the verdict lands now
        m.resume_commits()
        _flush(m)
        assert m.suppressed_dirty_total == 1
        assert m.latest_valid_step() == 1
        assert 2 not in m.all_steps()

    def test_later_clean_check_reenables_saves(self, tmp_path, managers):
        dirty = {"v": False}
        m = managers(str(tmp_path), async_commit=True,
                     dirty_probe=lambda: dirty["v"])
        m.save(1, _state(1))
        _flush(m)
        dirty["v"] = True
        m.save(2, _state(2))
        _flush(m)
        assert m.suppressed_dirty_total == 1
        dirty["v"] = False
        m.save(3, _state(3))
        _flush(m)
        assert m.latest_valid_step() == 3
        assert m.committed_total == 2 and m.accounted()

    def test_drain_flush_suppresses_dirty_and_commits_clean(self, tmp_path,
                                                            managers):
        dirty = {"v": False}
        m = managers(str(tmp_path), async_commit=True,
                     dirty_probe=lambda: dirty["v"])
        m.pause_commits()
        m.save(1, _state(1))
        m.resume_commits()
        _flush(m)
        assert m.latest_valid_step() == 1
        m.pause_commits()
        m.save(2, _state(2))
        dirty["v"] = True
        m.resume_commits()
        _flush(m)
        assert m.suppressed_dirty_total == 1
        assert m.latest_valid_step() == 1 and m.accounted()

    def test_flush_while_paused_warns_and_resumes(self, tmp_path, managers):
        m = managers(str(tmp_path), async_commit=True)
        m.pause_commits()
        m.save(1, _state(1))
        with pytest.warns(RuntimeWarning, match="paused"):
            _flush(m)
        assert m.latest_valid_step() == 1


# -- the tiers --------------------------------------------------------------------

class TestTiers:
    def test_deep_every_cadence(self, tmp_path, managers):
        m = managers(str(tmp_path), max_to_keep=8, deep_every=2)
        for s in (1, 2, 3, 4):
            m.save(s, _state(s))
        # saves #0 and #2 are deep, #1 and #3 cheap
        assert m._manifest_arrays(1) and m._manifest_arrays(3)
        assert not m._manifest_arrays(2) and not m._manifest_arrays(4)

    def test_explicit_tier_flag_wins(self, tmp_path, managers):
        m = managers(str(tmp_path), max_to_keep=8, deep_every=2)
        m.save(1, _state(1), deep=False)   # deep by the cadence
        m.save(2, _state(2), deep=True)    # cheap by the cadence
        assert not m._manifest_arrays(1)
        assert m._manifest_arrays(2)

    def test_async_tiers_digest_from_host_snapshot(self, tmp_path,
                                                   managers):
        m = managers(str(tmp_path), async_commit=True, max_to_keep=8,
                     deep_every=2)
        for s in (1, 2):
            m.save(s, _state(s))
            _flush(m)
        assert m._manifest_arrays(1) and not m._manifest_arrays(2)
        assert m._manifest_arrays(1) == _digests(_state(1))
        assert m.verify(1, deep=True) is True

    def test_prefer_deep_picks_newest_deep_anchor(self, tmp_path, managers):
        m = managers(str(tmp_path), max_to_keep=8, deep_every=2)
        for s in (1, 2, 3, 4):
            m.save(s, _state(s))
        out = m.restore(prefer_deep=True)
        assert m.last_restored_step == 3   # 4 is cheap
        assert not integrity.compare_digests(_digests(_state(3)),
                                             integrity.tree_digests(out))
        assert m.restore_fallbacks_total == 0

    def test_prefer_deep_falls_back_through_cheap_tiers(self, tmp_path,
                                                        managers):
        root = str(tmp_path)
        with telemetry.scope(None, profile=False) as sc:
            m = managers(root, max_to_keep=8, deep_every=2)
            for s in (1, 2, 3, 4):
                m.save(s, _state(s))
            _tamper_reattested(os.path.join(root, "1"))
            _tamper_reattested(os.path.join(root, "3"))
            out = m.restore(prefer_deep=True)
            # both deep steps fall (reason deep), the newest cheap one wins
            assert m.last_restored_step == 4
            assert not integrity.compare_digests(
                _digests(_state(4)), integrity.tree_digests(out))
            assert m.restore_fallbacks_total == 2
            assert sc.registry.get("ckpt_restore_fallbacks_total").value(
                reason="deep") == 2

    def test_tamper_then_fallback_as_the_reference(self, tmp_path,
                                                   managers):
        """The card's ``async_checkpoint`` script, on the port's manager
        (asynchronous) and the reference's (synchronous): deep_every=2,
        saves after steps 3 and 6 (3 deep, 6 cheap). A byte of 6 inverted
        and re-attested: shallow verify passes, deep verify passes too (6
        has no digests) and fails on a deep step treated so. Another byte
        under that manifest: ``restore(prefer_deep=True)`` takes 3 without
        a fallback (a cheap step is no candidate of the deep pass), and a
        plain ``restore()`` takes 3 with one."""
        got = {}
        for name in ("port", "ref"):
            root = str(tmp_path / name)
            if name == "port":
                m = managers(root, max_to_keep=3, async_commit=True,
                             deep_every=2)
                mod = ck
            else:
                m = ref_ck.CheckpointManager(root, max_to_keep=3,
                                             use_async=False, deep_every=2)
                mod = ref_ck
            for s in (3, 6):
                m.save(s, _state(s))
            m.wait_until_finished()
            sdir = os.path.join(root, "6")
            _tamper_reattested(sdir, crc=mod._crc_file)
            row = [m.verify(6), m.verify(6, deep=True),
                   bool(m._manifest_arrays(3)), bool(m._manifest_arrays(6))]
            p = _largest_payload(sdir)
            with open(p, "r+b") as f:
                f.seek(os.path.getsize(p) // 3)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 0xFF]))
            row.append(m.verify(6))
            m.restore(prefer_deep=True)
            row += [m.last_restored_step, m.restore_fallbacks_total]
            m.restore()
            row += [m.last_restored_step, m.restore_fallbacks_total]
            if name == "ref":
                m.close()
            got[name] = row
        assert got["port"] == got["ref"] == [
            True, True, True, False, False, 3, 0, 3, 1]
        # the deep tier catches the same tamper on a deep step
        m = managers(str(tmp_path / "deep"), deep_digests=True)
        m.save(3, _state(3))
        _tamper_reattested(os.path.join(str(tmp_path / "deep"), "3"))
        assert m.verify(3) is True and m.verify(3, deep=True) is False


# -- aborted commits -----------------------------------------------------------------

class TestAbortedCommitDebris:
    @staticmethod
    def _make_uncommitted(root, m, step):
        """The disk after a commit killed between its payload and its
        manifest: the step directory, no manifest, a live marker."""
        m.save(step, _state(step))
        os.remove(os.path.join(root, str(step), ck.MANIFEST_NAME))
        ck._write_pending_marker(root, step)

    def test_uncommitted_step_invisible_no_fallback(self, tmp_path,
                                                    managers):
        root = str(tmp_path)
        m = managers(root, max_to_keep=8)
        for s in (1, 2):
            m.save(s, _state(s))
        self._make_uncommitted(root, m, 3)
        assert m.latest_valid_step() == 2
        m.restore()
        assert m.last_restored_step == 2
        assert m.restore_fallbacks_total == 0
        with pytest.raises(OSError, match="never committed"):
            m.restore(3)

    def test_legacy_manifestless_step_still_restorable(self, tmp_path,
                                                       managers):
        """No marker and no manifest: a step from before manifests, not
        debris; it stays restorable."""
        root = str(tmp_path)
        m = managers(root, max_to_keep=8)
        m.save(1, _state(1))
        os.remove(os.path.join(root, "1", ck.MANIFEST_NAME))
        assert m.latest_valid_step() == 1
        m.restore()
        assert m.last_restored_step == 1

    def test_gc_reclaims_debris_and_stale_markers(self, tmp_path, managers):
        root = str(tmp_path)
        m = managers(root, max_to_keep=2)
        for s in (1, 2):
            m.save(s, _state(s))
        self._make_uncommitted(root, m, 3)
        ck._write_pending_marker(root, 9)   # no byte of 9 ever landed
        for s in (4, 5):
            m.save(s, _state(s))
        assert 3 not in m.all_steps()
        assert not os.path.exists(os.path.join(root, PENDING_PREFIX + "3"))
        assert not os.path.exists(os.path.join(root, PENDING_PREFIX + "9"))
        assert m.latest_valid_step() == 5

    def test_same_script_as_the_reference(self, tmp_path, managers):
        """Saves, an aborted commit of 3 and a marker without a step,
        two more saves: the same steps, valid step and restores as the
        reference's manager."""
        got = {}
        for name in ("port", "ref"):
            root = str(tmp_path / name)
            if name == "port":
                m, mod = managers(root, max_to_keep=2), ck
            else:
                m = ref_ck.CheckpointManager(root, max_to_keep=2,
                                             use_async=False)
                mod = ref_ck
            for s in (1, 2, 3):
                m.save(s, _state(s))
            os.remove(os.path.join(root, "3", mod.MANIFEST_NAME))
            mod._write_pending_marker(root, 3)
            row = [m.latest_valid_step()]
            m.restore()
            row += [m.last_restored_step, m.restore_fallbacks_total]
            mod._write_pending_marker(root, 9)
            m.save(4, _state(4))
            row += [sorted(m.all_steps()), m.latest_valid_step(),
                    sorted(n for n in os.listdir(root)
                           if n.startswith(PENDING_PREFIX))]
            if name == "ref":
                m.close()
            got[name] = row
        assert got["port"] == got["ref"]


# -- stall attribution ---------------------------------------------------------------

class TestStallAttribution:
    def test_sync_save_feeds_stall_ledger(self, tmp_path, managers):
        m = managers(str(tmp_path))
        before = ck.stall_seconds()
        t0 = time.perf_counter()
        m.save(1, _state())
        wall = time.perf_counter() - t0
        delta = ck.stall_seconds() - before
        assert 0 < delta <= wall * 1.5

    def test_async_save_stall_is_snapshot_only(self, tmp_path, managers):
        m = managers(str(tmp_path), async_commit=True, commit_delay=0.2)
        before = ck.stall_seconds()
        m.save(1, _state())
        delta = ck.stall_seconds() - before
        assert delta < 0.1   # the 0.2 s commit never reaches the ledger
        _flush(m)
        assert ck.stall_seconds() - before - delta < 0.01

    def test_attributing_stall_feeds_the_ledger(self):
        before = ck.stall_seconds()
        with ck.attributing_stall():
            time.sleep(0.05)
        assert ck.stall_seconds() - before >= 0.04

    def test_stall_histogram_series_recorded(self, tmp_path, managers):
        with telemetry.scope(None, profile=False) as sc:
            ms = managers(str(tmp_path / "s"))
            ms.save(1, _state())
            assert sc.registry.get("ckpt_step_stall_ms").count() >= 1
            ma = managers(str(tmp_path / "a"), async_commit=True)
            ma.save(1, _state())
            _flush(ma)
            reg = sc.registry.to_dict()
            assert "ckpt_snapshot_ms" in reg and "ckpt_commit_ms" in reg
            assert reg["ckpt_inflight"]["series"][""] == 0   # drained

    def test_suppressed_counter_reasons(self, tmp_path, managers):
        with telemetry.scope(None, profile=False) as sc:
            dirty = {"v": False}
            m = managers(str(tmp_path), async_commit=True,
                         dirty_probe=lambda: dirty["v"])
            m.pause_commits()
            m.save(1, _state(1))
            m.save(2, _state(2))   # supersedes 1
            dirty["v"] = True
            m.resume_commits()
            _flush(m)              # 2 suppressed as dirty
            series = sc.registry.to_dict()["ckpt_suppressed_total"]["series"]
            assert any("superseded" in k for k in series)
            assert any("dirty" in k for k in series)

    def test_save_trace_closes_on_the_committer_thread(self, tmp_path,
                                                      managers):
        from paddle_tpu_torch.telemetry import tracing
        was = tracing.enabled()
        tracing.reset(tracing.KeepPolicy(keep_all=True))
        tracing.enable(True)
        try:
            m = managers(str(tmp_path), async_commit=True)
            m.save(1, _state(1))
            _flush(m)
            kept = [t for t in tracing.snapshot_kept()
                    if t["name"] == "ckpt_save"]
        finally:
            tracing.enable(was)
            tracing.reset()
        assert len(kept) == 1 and kept[0]["outcome"] == "committed"
        spans = {s["name"]: s for s in kept[0]["spans"]}
        # the trace opens on the step's thread and closes on the committer
        assert spans["ckpt_save"]["attrs"]["end_thread"] == "ckpt-committer"
        assert spans["commit"]["thread"] == "ckpt-committer"
        assert spans["snapshot"]["thread"] == \
            threading.current_thread().name


# -- the deep tier (tests/test_integrity.py's TestDeepVerify) -------------------------

class TestDeepVerify:
    @staticmethod
    def _saved(tmp_path, managers, steps=(1, 2, 3)):
        m = managers(str(tmp_path / "ckpt"), max_to_keep=8,
                     deep_digests=True)
        rng = np.random.RandomState(0)
        state = {"w": rng.randn(64, 8).astype(np.float32),
                 "b": rng.randn(8).astype(np.float32)}
        for s in steps:
            assert m.save(s, state)
        return m, state

    def test_manifest_records_array_digests_and_sizes(self, tmp_path,
                                                      managers):
        m, state = self._saved(tmp_path, managers)
        with open(os.path.join(m._step_dir(2), ck.MANIFEST_NAME)) as f:
            man = json.load(f)
        assert man["files"] and all(
            "size" in v and "crc32" in v for v in man["files"].values())
        assert set(man["arrays"]) == {"w", "b"}
        assert man["arrays"]["w"] == integrity.array_digest(state["w"]) \
            == ref_integrity.array_digest(jnp.asarray(state["w"]))

    def test_shallow_passes_deep_catches_reattested_tamper(self, tmp_path,
                                                           managers):
        m, _ = self._saved(tmp_path, managers)
        assert m.verify(2) is True
        assert m.verify(2, deep=True) is True
        _tamper_reattested(m._step_dir(2))
        assert m.verify(2) is True              # the file layer is fooled
        assert m.verify(2, deep=True) is False  # the digests are not

    def test_restore_falls_back_past_deep_corrupt_with_reason(
            self, tmp_path, managers):
        with telemetry.scope(None, profile=False) as sc:
            m, _ = self._saved(tmp_path, managers)
            _tamper_reattested(m._step_dir(3))
            assert m.restore(deep=True) is not None
            assert m.last_restored_step == 2
            assert sc.registry.get("ckpt_restore_fallbacks_total").value(
                reason="deep") == 1

    def test_explicit_step_deep_restore_raises_on_mismatch(self, tmp_path,
                                                           managers):
        m, _ = self._saved(tmp_path, managers)
        mpath = os.path.join(m._step_dir(2), ck.MANIFEST_NAME)
        with open(mpath) as f:
            man = json.load(f)
        man["arrays"]["w"] = "crc32:00000000:0"
        with open(mpath, "w") as f:
            json.dump(man, f)
        with pytest.raises(OSError, match="deep verification"):
            m.restore(step=2, deep=True)
        m.restore(step=2)   # the shallow path still restores

    def test_latest_valid_step_size_prereject(self, tmp_path, managers):
        m, _ = self._saved(tmp_path, managers)
        assert m.latest_valid_step() == 3
        p = _largest_payload(m._step_dir(3))
        with open(p, "r+b") as f:
            f.truncate(max(1, os.path.getsize(p) // 2))
        m._vcache.clear()
        assert ck.verify_manifest(m._step_dir(3), level="size") is False
        assert m.latest_valid_step() == 2

    def test_deep_digests_off_by_default(self, tmp_path, managers):
        m = managers(str(tmp_path / "ckpt"))
        m.save(1, {"w": np.ones(4, dtype=np.float32)})
        with open(os.path.join(m._step_dir(1), ck.MANIFEST_NAME)) as f:
            assert "arrays" not in json.load(f)
        # without digests, a deep verify gives the shallow verdict
        assert m.verify(1, deep=True) is True
