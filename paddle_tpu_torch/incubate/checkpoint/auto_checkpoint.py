"""Auto-checkpoint for a transparent resume after preemption (port of
``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``; reference
incubate/checkpoint/auto_checkpoint.py: TrainEpochRange:265 snapshots the
program state keyed by job id each epoch, the train_epoch_range:598
generator skips the epochs a restarted job already finished).

The state is whatever tree of tensors the caller registers (a trainer's
state, a model's ``state_dict``, ...), saved by ``distributed.checkpoint``'s
``CheckpointManager``; the job id and directory come from
``PADDLE_JOB_ID`` and ``PADDLE_EDL_HDFS_HOME`` /
``PADDLE_AUTO_CHECKPOINT_DIR``, as the reference's AutoCheckpointChecker
reads them.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional

_CHECKER = None


class AutoCheckpointChecker:
    """reference auto_checkpoint.py:71 — env-driven config gate."""

    def __init__(self):
        self.job_id = os.environ.get("PADDLE_JOB_ID", "")
        self.hdfs_home = os.environ.get("PADDLE_EDL_HDFS_HOME",
                                        os.environ.get(
                                            "PADDLE_AUTO_CHECKPOINT_DIR", ""))
        self.save_checkpoint_inter = int(
            os.environ.get("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900"))

    @property
    def valid(self) -> bool:
        return bool(self.job_id) and bool(self.hdfs_home)

    def checkpoint_dir(self) -> str:
        return os.path.join(self.hdfs_home, self.job_id)


def _checker() -> AutoCheckpointChecker:
    global _CHECKER
    if _CHECKER is None:
        _CHECKER = AutoCheckpointChecker()
    return _CHECKER


class TrainEpochRange:
    """reference auto_checkpoint.py:265. Iterates epochs; on entry restores
    the newest snapshot and resumes after its epoch; saves every
    ``save_checkpoint_inter`` seconds (and on the final epoch), through
    ``distributed.checkpoint.CheckpointManager``.

    The caller registers its state with ``add_state(get_fn, set_fn)``:
    ``get_fn`` returns the tree to snapshot, ``set_fn`` takes the restored
    one (its tensors on the devices of ``get_fn``'s).
    """

    def __init__(self, max_epoch_num: int, name: str,
                 checkpoint_inter: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None):
        import time
        self.name = name
        self.max_epoch_num = max_epoch_num
        c = _checker()
        self._dir = checkpoint_dir or (
            os.path.join(c.checkpoint_dir(), name) if c.valid else None)
        self._inter = (checkpoint_inter if checkpoint_inter is not None
                       else c.save_checkpoint_inter)
        self._get: Optional[Callable[[], Any]] = None
        self._set: Optional[Callable[[Any], None]] = None
        self._mgr = None
        self._last_save = time.time()
        self.restored_from: Optional[int] = None
        if self._dir:
            from ...distributed.checkpoint import CheckpointManager
            self._mgr = CheckpointManager(self._dir, max_to_keep=2)

    def add_state(self, get_fn: Callable[[], Any],
                  set_fn: Callable[[Any], None]):
        self._get, self._set = get_fn, set_fn
        return self

    def _restore(self) -> int:
        if self._mgr is None or self._set is None:
            return 0
        step = self._mgr.latest_step()
        if step is None:
            return 0
        template = self._get() if self._get else None
        self._set(self._mgr.restore(step, template=template))
        self.restored_from = step
        return step + 1

    def _save(self, epoch: int, force: bool = False):
        import time
        if self._mgr is None or self._get is None:
            return
        now = time.time()
        if force or (now - self._last_save) >= self._inter:
            self._mgr.save(epoch, self._get())
            self._mgr.wait_until_finished()
            self._last_save = now

    def get(self):
        """Generator over remaining epochs (reference :398 get)."""
        start = self._restore()
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            self._save(epoch, force=(epoch == self.max_epoch_num - 1))

    def __iter__(self):
        return self.get()


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter=None,
                      name: str = "auto_checkpoint",
                      checkpoint_dir: Optional[str] = None) -> TrainEpochRange:
    """reference auto_checkpoint.py:598."""
    return TrainEpochRange(max_epoch_num, name,
                           checkpoint_inter=save_checkpoint_inter,
                           checkpoint_dir=checkpoint_dir)
