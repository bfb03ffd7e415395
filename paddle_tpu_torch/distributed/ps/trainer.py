"""The parameter server's trainer and device-worker runtime.

Port of ``paddle_tpu/distributed/ps/trainer.py`` (reference
framework/trainer.h:57,102,137 MultiTrainer, device_worker.h:150
HogwildWorker, :244 DownpourWorker, service/communicator.h:197 the async
Communicator, trainer_factory.cc and trainer_desc.proto). The workers feed
batches, pull sparse rows (and a dense block) from a table, call the
user's ``step_fn(emb, dense, batch) -> (loss, emb_grad, dense_grad)`` and
push the gradients back: Hogwild straight into the shared table from
every thread, Downpour through the ``Communicator``'s bounded queue,
drained by one background thread (merging duplicate keys).
``step_fn`` takes and returns numpy (or anything ``np.asarray`` reads):
the workers never trace, so one compiled step serves every thread.

    desc = TrainerDesc(worker="downpour", thread_num=4, batch_size=256)
    trainer = TrainerFactory().create(desc)
    stats = trainer.train(dataset, step_fn, sparse_table, dense_table=...)
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "TrainerDesc", "Communicator", "DeviceWorker", "HogwildWorker",
    "DownpourWorker", "MultiTrainer", "TrainerFactory",
]


@dataclass
class TrainerDesc:
    """Python analogue of trainer_desc.proto: which worker, how many
    threads, and the communicator knobs (Downpour only)."""
    worker: str = "hogwild"          # "hogwild" | "downpour"
    thread_num: int = 2
    batch_size: int = 128
    lr: float = 0.05
    # Downpour/communicator knobs (reference communicator.h: send_queue_size,
    # max_merge_var_num — bounded staleness between compute and apply).
    send_queue_size: int = 8
    merge_grads: bool = True


class Communicator:
    """Async grad channel (reference service/communicator.h:197): workers
    enqueue (keys, grads) pairs; one background thread drains the queue and
    applies pushes to the table. The bounded queue gives bounded staleness;
    ``flush`` barriers like the reference's Communicator::Barrier."""

    def __init__(self, table, lr: float, send_queue_size: int = 8,
                 merge_grads: bool = True, dense_table=None):
        self._table = table
        self._dense = dense_table
        self._lr = float(lr)
        self._merge = bool(merge_grads)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, send_queue_size))
        self._stop = threading.Event()
        self._pushed = 0
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain,
                                        name="ps-push-drain", daemon=True)
        self._thread.start()

    def _check_err(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def send(self, keys: np.ndarray, grads: np.ndarray,
             dense_grad: Optional[np.ndarray] = None):
        self._check_err()
        self._q.put((np.asarray(keys), np.asarray(grads), dense_grad))

    def _apply(self, keys, grads, dense_grad):
        if self._merge and keys.size:
            # Merge duplicate keys before pushing (reference
            # merge_sparse_grad / MergeVars): one row per unique key.
            uniq, inv = np.unique(keys, return_inverse=True)
            merged = np.zeros((uniq.size, grads.shape[1]), dtype=np.float32)
            np.add.at(merged, inv, np.asarray(grads, dtype=np.float32))
            keys, grads = uniq, merged
        if keys.size:
            self._table.push(keys, grads, self._lr)
        if dense_grad is not None and self._dense is not None:
            self._dense.push(dense_grad, self._lr)
        self._pushed += 1

    def _drain(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            # A failed push (e.g. RPC ConnectionError) must not kill the
            # drain thread: park the error for the next send()/flush() and
            # keep draining so the bounded queue can't wedge the workers.
            try:
                self._apply(*item)
            except BaseException as e:
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def flush(self):
        self._q.join()
        # RPC-routed tables buffer their own async pushes too.
        if hasattr(self._table, "flush"):
            self._table.flush()
        self._check_err()

    def stop(self):
        try:
            self.flush()
        finally:
            self._stop.set()
            self._thread.join(timeout=5.0)

    @property
    def pushes_applied(self) -> int:
        return self._pushed


class DeviceWorker:
    """One training thread (reference device_worker.h). Subclasses define
    how gradients reach the parameter server."""

    def __init__(self, worker_id: int, desc: TrainerDesc):
        self.worker_id = worker_id
        self.desc = desc
        self.losses: List[float] = []
        self.batches_done = 0

    def bind(self, batches: Sequence[Any], step_fn: Callable,
             sparse_table, dense_table=None,
             communicator: Optional[Communicator] = None,
             key_slot: str = "ids", extract=None, eval_only: bool = False):
        self._batches = batches
        self._step_fn = step_fn
        self._sparse = sparse_table
        self._dense = dense_table
        self._comm = communicator
        self._key_slot = key_slot
        self._extract = extract or (lambda b: np.asarray(b[self._key_slot]))
        # eval_only: read-only pass — never push (even zero grads advance
        # Adam's step/moment decay server-side) and never materialize rows
        # for ids unseen in training.
        self._eval_only = bool(eval_only)
        return self

    # -- the loop body shared by both workers -----------------------------
    def _one_batch(self, batch) -> float:
        ids = np.asarray(self._extract(batch), dtype=np.int64)
        flat = ids.reshape(-1)
        # InMemoryDataset pads ragged sparse slots with -1: padding rows read
        # as zeros and their grads are dropped, never touching the table.
        valid = flat >= 0
        vkeys = flat[valid]
        dim = getattr(self._sparse, "dim", None)
        if vkeys.size:
            vemb = np.asarray(
                self._sparse.pull(vkeys,
                                  create_missing=not self._eval_only),
                dtype=np.float32)
            dim = vemb.shape[-1]
        else:
            vemb = np.zeros((0, int(dim)), dtype=np.float32)
        emb = np.zeros((flat.size, int(dim)), dtype=np.float32)
        emb[valid] = vemb
        emb = emb.reshape(ids.shape + (int(dim),))
        dense = self._dense.pull() if self._dense is not None else None
        loss, emb_grad, dense_grad = self._step_fn(emb, dense, batch)
        if not self._eval_only:
            emb_grad = np.asarray(emb_grad, dtype=np.float32) \
                         .reshape(flat.shape[0], -1)
            self._dispatch(vkeys, emb_grad[valid],
                           None if dense_grad is None
                           else np.asarray(dense_grad, dtype=np.float32))
        self.batches_done += 1
        return float(loss)

    def _dispatch(self, keys, grads, dense_grad):  # pragma: no cover
        raise NotImplementedError

    def run(self):
        for batch in self._batches:
            self.losses.append(self._one_batch(batch))


class HogwildWorker(DeviceWorker):
    """Lock-free: push straight into the shared table from every thread
    (reference hogwild_worker.cc — safe because the native table shards
    its key space behind per-shard locks)."""

    def _dispatch(self, keys, grads, dense_grad):
        if keys.size:
            self._sparse.push(keys, grads, self.desc.lr)
        if dense_grad is not None and self._dense is not None:
            self._dense.push(dense_grad, self.desc.lr)


class DownpourWorker(DeviceWorker):
    """Async: grads go to the Communicator queue; a background thread
    applies them (reference downpour_worker.cc + communicator.h)."""

    def _dispatch(self, keys, grads, dense_grad):
        self._comm.send(keys, grads, dense_grad)


_WORKERS = {"hogwild": HogwildWorker, "downpour": DownpourWorker}


class MultiTrainer:
    """Thread-per-worker trainer (reference trainer.h MultiTrainer /
    DistMultiTrainer): partitions the dataset's batches round-robin over
    `thread_num` workers, runs them concurrently, joins, and (for Downpour)
    flushes the communicator so training is fully applied on return."""

    def __init__(self, desc: TrainerDesc):
        self.desc = desc
        self.workers: List[DeviceWorker] = []
        self.communicator: Optional[Communicator] = None

    def train(self, dataset, step_fn: Callable, sparse_table,
              dense_table=None, key_slot: str = "ids",
              extract=None, eval_only: bool = False) -> Dict[str, Any]:
        """`dataset` is anything with `.batches(batch_size)` (InMemoryDataset)
        or an iterable of batches."""
        if hasattr(dataset, "batches"):
            batches = list(dataset.batches(self.desc.batch_size))
        else:
            batches = list(dataset)
        n = max(1, self.desc.thread_num)
        parts = [batches[i::n] for i in range(n)]

        cls = _WORKERS[self.desc.worker]
        if cls is DownpourWorker and not eval_only:
            self.communicator = Communicator(
                sparse_table, self.desc.lr,
                send_queue_size=self.desc.send_queue_size,
                merge_grads=self.desc.merge_grads, dense_table=dense_table)

        self.workers = [
            cls(i, self.desc).bind(parts[i], step_fn, sparse_table,
                                   dense_table=dense_table,
                                   communicator=self.communicator,
                                   key_slot=key_slot, extract=extract,
                                   eval_only=eval_only)
            for i in range(n)]

        errs: List[BaseException] = []

        def _run(w):
            try:
                w.run()
            except BaseException as e:  # surface worker crashes to caller
                errs.append(e)

        threads = [threading.Thread(target=_run, args=(w,),
                                    name=f"ps-worker-{i}", daemon=True)
                   for i, w in enumerate(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.communicator is not None:
            self.communicator.stop()
        if errs:
            raise errs[0]

        losses = [l for w in self.workers for l in w.losses]
        return {
            "loss_mean": float(np.mean(losses)) if losses else float("nan"),
            "losses": losses,
            "batches": sum(w.batches_done for w in self.workers),
            "threads": n,
        }


class TrainerFactory:
    """String-keyed creation (reference trainer_factory.cc)."""

    def create(self, desc: TrainerDesc) -> MultiTrainer:
        if desc.worker not in _WORKERS:
            raise ValueError(
                f"unknown device worker {desc.worker!r}; "
                f"registered: {sorted(_WORKERS)}")
        return MultiTrainer(desc)
