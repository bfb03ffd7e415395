"""DataLoader (port of ``paddle_tpu/io/dataloader.py``; reference
fluid/reader.py:146 DataLoader, fluid/dataloader/dataloader_iter.py:97
single-process, :248 multi-process).

A batch leaves the loader as CPU tensors (``default_collate_fn`` stacks
samples into them); the copy to the card is the caller's (``hapi.Model``
makes it). No worker touches the card.

- ``num_workers=0`` reads in the loading process. Each batch's fetch goes
  through ``resilience.retry.call_with_retry`` (site ``dataloader_fetch``),
  so a transient source failure, or an injected ``data_fetch`` fault, is
  retried rather than surfaced.
- ``num_workers>0`` forks worker processes, as the reference does: they
  take ``(sequence number, indices)`` from one queue and send collated
  batches back; the loader hands them on in sampler order whatever
  order they finish in, with at most ``num_workers * prefetch_factor``
  batches in flight. A worker's exception comes back as ``RuntimeError``
  carrying the worker's traceback; a worker that dies without one (killed)
  raises too, where the reference would wait forever. Each worker has a
  pipe of its own back to the loader: a batch crosses as a small pickled
  header and then its arrays' raw bytes, written from the worker's array
  and read into the new tensor's memory (not pickled through a
  ``multiprocessing.Queue``, seven times slower for a 77 MB batch; not in
  shared memory, so ``/dev/shm``'s size does not matter). At 7 workers
  on an 8-core H100 host the pipes carried 885–922 images/s of 128 x
  224² float32 batches where ``torch.utils.data.DataLoader``'s shared
  memory carried 614–617 (``tests/torch_loader_bench.py --against``).
  Fork, not spawn: a dataset and a ``collate_fn`` need not be picklable,
  and a worker costs no fresh import of torch, each epoch. It is safe
  while the worker stays on the host and off torch's thread pools, which
  it does: it runs the dataset and ``collate_fn`` in Python and numpy,
  with one torch thread (a pool forked from a busy parent is the hazard).
  torch's own ``DataLoader`` forks on Linux for the same reasons. A worker also runs
  its BLAS on one thread: numpy's OpenBLAS sizes its pool for the whole
  machine, so W workers would spin W pools of every core's threads, and a
  transform that calls BLAS (``vision.transforms``' resize is a
  ``tensordot``) ran slower in 7 workers than in the loading process alone
  (an H100 host of 8 cores, chip_smoke.py's ``hapi`` phase).
- Workers are not reseeded, as in the reference (``WorkerInfo.seed`` is
  None): each starts from the state of numpy's global generator (and
  torch's) that the loading process had when it forked, so a transform
  that draws from numpy draws the same numbers in every worker (ROADMAP.md,
  Oracle caveats). Python's ``random`` reseeds itself in every forked
  child, in the reference's workers as in these, so a transform that
  draws from it (``vision.transforms``) differs from worker to worker and
  from run to run. A ``worker_init_fn`` can seed each worker by its id.
- An ``IterableDataset`` is read in the loading process, whatever
  ``num_workers`` says, as in the reference.
- ``use_buffer_reader`` (the default) puts a prefetch thread of depth
  ``prefetch_factor`` in front, the host side of the reference's
  buffered_reader.cc double buffering; with telemetry on, every batch's
  wait is observed in ``dataloader_fetch_seconds`` and counted in
  ``dataloader_batches_total``.
"""
from __future__ import annotations

import ctypes
import fcntl
import itertools
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import pickle
import queue as queue_mod
import struct
import threading
import time
import traceback

import numpy as np
import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "WorkerInfo",
           "get_worker_info"]

def default_collate_fn(batch):
    """Samples -> one batch of CPU tensors, field by field: tensors and
    arrays stacked, ints as int64, floats as float32; tuples, lists and
    dicts keep their structure. A field torch has no dtype for (strings)
    stays a numpy array."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch, 0)
    if isinstance(sample, np.ndarray):
        arr = np.stack(batch, axis=0)
    elif isinstance(sample, (bool, np.bool_)):
        arr = np.asarray(batch)
    elif isinstance(sample, (int, np.integer)):
        arr = np.asarray(batch, dtype=np.int64)
    elif isinstance(sample, (float, np.floating)):
        arr = np.asarray(batch, dtype=np.float32)
    else:
        arr = np.asarray(batch)
    return torch.from_numpy(arr) if arr.dtype.kind in "biufc" else arr


class WorkerInfo:
    """What a dataset sees inside a worker (reference
    fluid/dataloader/worker.py WorkerInfo): ``id``, ``num_workers``,
    ``dataset`` and ``seed`` (None: workers are not reseeded)."""

    def __init__(self, id, num_workers, dataset, seed=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """The ``WorkerInfo`` inside a worker process, else None."""
    return _worker_info


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


# -- the worker -> loader message: a pickled header, then raw array bytes --
# A batch of images is tens of MB. Pickled through a multiprocessing.Queue
# a 128 x 3 x 224 x 224 float32 batch took 0.37 s to cross on an 8-core
# x86 host (~210 MB/s), and the loading process became the bottleneck.
# Written with os.write straight from the array and read with os.readv
# straight into the new tensor's memory (0.055 s on the same host),
# nothing is pickled or allocated on the way.

_HEAD = struct.Struct("<Q")
_F_SETPIPE_SZ = 1031     # fcntl: a pipe's buffer, fewer wake-ups a batch
_PIPE_BYTES = 1 << 20    # the most an unprivileged process may ask for


class _Raw:
    """An array leaf sent after the header: its shape and numpy dtype, and
    the torch dtype when it was a tensor (a bfloat16 one crosses as its
    int16 bits)."""
    __slots__ = ("shape", "dtype", "torch_dtype")

    def __init__(self, shape, dtype, torch_dtype):
        self.shape, self.dtype, self.torch_dtype = shape, dtype, torch_dtype


def _split(tree, arrays):
    """``tree`` with each tensor and numeric array replaced by a ``_Raw``,
    whose contiguous bytes are appended to ``arrays`` in tree order."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous()
            arr = (t.view(torch.int16) if t.dtype == torch.bfloat16
                   else t).numpy()
            arrays.append(arr)
            return _Raw(arr.shape, arr.dtype.str, t.dtype)
        if isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
            arr = np.ascontiguousarray(x)
            arrays.append(arr)
            return _Raw(arr.shape, arr.dtype.str, None)
        return x
    return _map_tree(leaf, tree)


def _bytes_of(arr: np.ndarray) -> memoryview:
    return memoryview(arr.reshape(-1).view(np.uint8))


def _write_all(fd: int, buf):
    mv = memoryview(buf)
    while len(mv):
        mv = mv[os.write(fd, mv):]


def _read_into(fd: int, mv: memoryview):
    while len(mv):
        n = os.readv(fd, [mv])
        if n == 0:
            raise EOFError("the worker's pipe closed mid-message")
        mv = mv[n:]


def _send(fd: int, seq: int, data, err):
    arrays = []
    skeleton = _split(data, arrays) if err is None else None
    head = pickle.dumps((seq, skeleton, err), pickle.HIGHEST_PROTOCOL)
    _write_all(fd, _HEAD.pack(len(head)) + head)
    for arr in arrays:
        _write_all(fd, _bytes_of(arr))


def _recv(fd: int):
    """(seq, batch, error text) of the next message on ``fd``; EOFError
    when the worker is gone."""
    size = bytearray(_HEAD.size)
    _read_into(fd, memoryview(size))
    head = bytearray(_HEAD.unpack(size)[0])
    _read_into(fd, memoryview(head))
    seq, skeleton, err = pickle.loads(head)

    def leaf(x):
        if not isinstance(x, _Raw):
            return x
        arr = np.empty(x.shape, np.dtype(x.dtype))
        _read_into(fd, _bytes_of(arr))
        if x.torch_dtype is None:
            return arr
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if x.torch_dtype == torch.bfloat16 \
            else t
    return seq, (None if skeleton is None else _map_tree(leaf, skeleton)), \
        err


_OPENBLAS_SET = ("openblas_set_num_threads", "openblas_set_num_threads64_",
                 "scipy_openblas_set_num_threads64_",
                 "scipy_openblas_set_num_threads")


def _openblas_libs():
    """The OpenBLAS libraries this process has loaded (numpy's own)."""
    try:
        with open("/proc/self/maps") as f:
            return sorted({line.split()[-1] for line in f
                           if "openblas" in line.lower()
                           and ".so" in line})
    except OSError:
        return []


def _set_openblas_threads(n: int) -> int:
    """Every loaded OpenBLAS to ``n`` threads -> how many were set."""
    done = 0
    for path in _openblas_libs():
        lib = ctypes.CDLL(path)
        for name in _OPENBLAS_SET:
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = [ctypes.c_int], None
                fn(n)
                done += 1
                break
    return done


def _worker_loop(dataset, index_queue, data_fd, collate_fn, worker_id,
                 worker_init_fn, num_workers, other_fds):
    global _worker_info
    for fd in other_fds:     # so that each pipe ends when its worker does
        os.close(fd)
    torch.set_num_threads(1)
    _set_openblas_threads(1)
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            samples = [dataset[i] for i in indices]
            batch, err = collate_fn(samples), None
        except Exception:   # the loader re-raises it with this traceback
            batch, err = None, traceback.format_exc()
        _send(data_fd, seq, batch, err)


class _MultiProcessIter:
    def __init__(self, loader):
        self.loader = loader
        self.batches = list(iter(loader.batch_sampler))
        ctx = mp.get_context("fork")
        self.index_queue = ctx.Queue()
        self.workers, self.fds = [], {}
        self.closed = False
        pipes = [os.pipe() for _ in range(loader.num_workers)]
        for r, w in pipes:
            try:
                fcntl.fcntl(w, _F_SETPIPE_SZ, _PIPE_BYTES)
            except OSError:     # a smaller buffer only costs wake-ups
                pass
        every = [fd for pair in pipes for fd in pair]
        for wid, (r, w) in enumerate(pipes):
            p = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self.index_queue, w, loader.collate_fn,
                      wid, loader.worker_init_fn, loader.num_workers,
                      [fd for fd in every if fd != w]),
                daemon=True)
            p.start()
            self.workers.append(p)
            self.fds[r] = p
        for _, w in pipes:
            os.close(w)
        # at most num_workers * prefetch_factor batches in flight
        self.window = max(loader.num_workers * loader.prefetch_factor, 1)
        self.dispatched = 0
        for _ in range(min(self.window, len(self.batches))):
            self._dispatch_next()
        self.reorder = {}
        self.next_seq = 0

    def _dispatch_next(self):
        if self.dispatched < len(self.batches):
            self.index_queue.put((self.dispatched,
                                  self.batches[self.dispatched]))
            self.dispatched += 1

    def __iter__(self):
        return self

    def _get(self):
        """The next message from whichever worker has one."""
        if not self.closed:
            # a worker that dies, or is stopped by _shutdown, closes its
            # pipe: the wait wakes on its end of file
            fd = mp_connection.wait(list(self.fds))[0]
        if self.closed:
            raise RuntimeError("DataLoader closed")
        try:
            return _recv(fd)
        except EOFError:
            pid = self.fds[fd].pid
            self._shutdown()
            raise RuntimeError(f"DataLoader worker {pid} exited "
                               f"unexpectedly") from None

    def __next__(self):
        if self.next_seq >= len(self.batches):
            self._shutdown(graceful=True)
            raise StopIteration
        while self.next_seq not in self.reorder:
            seq, data, err = self._get()
            if err is not None:
                self._shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self.reorder[seq] = data
        data = self.reorder.pop(self.next_seq)
        self.next_seq += 1
        self._dispatch_next()
        return self.loader._to_output(data)

    def _shutdown(self, graceful=False):
        if graceful:
            for _ in self.workers:
                self.index_queue.put(None)
        else:     # what is still queued is dropped, not waited for at exit
            self.index_queue.cancel_join_thread()
        for w in self.workers:
            if w.is_alive():
                if graceful:
                    w.join(timeout=1.0)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1.0)
        self.workers = []
        self.closed = True
        fds, self.fds = self.fds, {}
        for fd in fds:
            os.close(fd)

    def __del__(self):
        if getattr(self, "workers", None):
            self._shutdown()


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self._is_iterable_ds = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif not self._is_iterable_ds:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def _to_output(self, data):
        return data

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self._to_output(self.collate_fn(batch))

    def _iter_single(self):
        from ..resilience import faults
        from ..resilience.retry import call_with_retry
        step = 0
        for indices in self.batch_sampler:

            def _fetch():
                # transient source failures (a remote filesystem's hiccup,
                # an injected data_fetch fault) are retried here, not
                # surfaced to the training loop
                faults.maybe_raise("data_fetch", step=step,
                                   site="dataloader_fetch",
                                   msg="injected data_fetch in dataloader")
                return [self.dataset[i] for i in indices]

            samples = call_with_retry(_fetch, site="dataloader_fetch",
                                      tries=3, base_delay=0.01)
            step += 1
            yield self._to_output(self.collate_fn(samples))

    def __iter__(self):
        if self._is_iterable_ds:
            base = self._iter_iterable()
        elif self.num_workers > 0:
            base = _MultiProcessIter(self)
        else:
            base = self._iter_single()
        if self.use_buffer_reader:
            it = _PrefetchIter(base, depth=self.prefetch_factor)
        else:
            it = iter(base)
        from .. import telemetry
        if telemetry.enabled():
            return _TimedIter(it)
        return it

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("length of IterableDataset loader is unknown")


class _TimedIter:
    """Telemetry: the wall time the consumer waited for each batch. With
    the prefetch in front, waits near zero mean the pipeline keeps up;
    waits near the step time are input starvation (read
    ``dataloader_fetch_seconds`` beside ``step_time_seconds``)."""

    def __init__(self, it):
        self._it = iter(it)

    def __iter__(self):
        return self

    def close(self):
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def __next__(self):
        from .. import telemetry
        t0 = time.perf_counter()
        item = next(self._it)
        telemetry.histogram(
            "dataloader_fetch_seconds",
            "wall time blocked fetching one batch").observe(
                time.perf_counter() - t0)
        telemetry.counter(
            "dataloader_batches_total", "batches served").inc()
        return item


class _PrefetchIter:
    """A background thread that keeps up to ``depth`` batches ready.
    ``close()`` (or the loader's consumer letting go of it) stops the
    thread and the workers of a multi-process source before the source
    runs out: a loop that breaks early (``fit(num_iters=...)``) leaves no
    worker behind."""

    def __init__(self, source, depth=2):
        self.q = queue_mod.Queue(maxsize=depth)
        self.done = object()
        self.exc = None
        self.source = source
        self.stopped = threading.Event()

        def run():
            try:
                for item in source:
                    if not self._put(item):
                        break
            except BaseException as e:  # noqa: BLE001 - re-raised by next()
                self.exc = e
            finally:
                self._put(self.done)

        self.thread = threading.Thread(target=run, name="data-prefetch",
                                       daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; False once closed."""
        while not self.stopped.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self.done:
            if self.exc is not None:
                raise self.exc
            raise StopIteration
        return item

    def close(self, timeout=10.0):
        self.stopped.set()
        shutdown = getattr(self.source, "_shutdown", None)
        if shutdown is not None:     # a waiting prefetch thread wakes up
            shutdown()
        self.thread.join(timeout)
