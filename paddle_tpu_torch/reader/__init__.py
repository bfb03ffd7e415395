"""Legacy reader decorators (port of ``paddle_tpu/reader``; reference
python/paddle/reader/decorator.py): the generator-combinator data pipeline
of pre-DataLoader code.

A "reader" is a zero-argument callable returning an iterator of samples.
The combinators are host-side pure Python, the reference's own, kept here
as a copy so that the port imports nothing of the JAX package; the modern
path is ``io.DataLoader``, which takes any of them as an iterable.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    """Materialize once, replay from memory thereafter (reference :52)."""
    all_data = []
    filled = [False]

    def _reader():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        return iter(all_data)

    return _reader


def map_readers(func, *readers):
    """Yield func(*one_sample_from_each) (reference :92)."""

    def _reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return _reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill a buf_size window, emit shuffled
    (reference :134)."""

    def _reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return _reader


def chain(*readers):
    """Concatenate readers end to end (reference :183)."""

    def _reader():
        return itertools.chain(*[r() for r in readers])

    return _reader


def compose(*readers, **kwargs):
    """Zip readers into combined samples; scalars splice flat
    (reference :248). check_alignment=True (default) raises if readers
    run out at different lengths."""
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError(f"unexpected kwargs {sorted(kwargs)}")

    def _flatten(x):
        return x if isinstance(x, tuple) else (x,)

    def _reader():
        its = [iter(r()) for r in readers]
        while True:
            outs, stops = [], 0
            for it in its:
                try:
                    outs.append(next(it))
                except StopIteration:
                    stops += 1
                    outs.append(None)
            if stops == len(its):
                return
            if stops:
                if check_alignment:
                    raise RuntimeError(
                        "compose: readers have different lengths")
                return
            yield sum((_flatten(o) for o in outs), ())

    return _reader


def buffered(reader, size):
    """Read-ahead of ``size`` samples on a daemon thread (reference :308
    — the double-buffer decouple of producer and consumer)."""
    end = object()

    def _reader():
        q: "queue.Queue" = queue.Queue(maxsize=size)
        err = []

        def fill():
            try:
                for e in reader():
                    q.put(e)
            except BaseException as e:  # surface producer errors
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=fill, name="reader-buffered",
                             daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                if err:
                    raise err[0]
                return
            yield e

    return _reader


def firstn(reader, n):
    """First n samples (reference :367)."""

    def _reader():
        return itertools.islice(reader(), n)

    return _reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with ``process_num`` worker THREADS
    (reference :412 uses threads too) and a bounded buffer; order=True
    preserves input order."""
    end = object()

    def _ordered_reader():
        # simple exact implementation: read, map in a pool, keep order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=process_num) as pool:
            for out in pool.map(mapper, reader()):
                yield out

    if order:
        return _ordered_reader

    def _reader():
        in_q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        out_q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        errs: list = []

        def feed():
            try:
                for e in reader():
                    in_q.put(e)
            except BaseException as e:
                errs.append(e)
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    e = in_q.get()
                    if e is end:
                        return
                    out_q.put(mapper(e))
            except BaseException as e:
                errs.append(e)
            finally:
                out_q.put(end)

        threading.Thread(target=feed, name="reader-xmap-feed",
                         daemon=True).start()
        for i in range(process_num):
            threading.Thread(target=work, name=f"reader-xmap-{i}",
                             daemon=True).start()
        done = 0
        while done < process_num:
            e = out_q.get()
            if e is end:
                done += 1
                continue
            yield e
        if errs:
            raise errs[0]

    return _reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run each reader and interleave results (reference :505 uses
    worker processes; host readers here are thread-parallel — the device
    never blocks on them thanks to buffered()'s read-ahead)."""
    if len(readers) < 1:
        raise ValueError("multiprocess_reader needs at least one reader")
    end = object()

    def _reader():
        q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        errs: list = []

        def run(r):
            try:
                for e in r():
                    q.put(e)
            except BaseException as e:   # propagate, don't truncate
                errs.append(e)
            finally:
                q.put(end)

        for i, r in enumerate(readers):
            threading.Thread(target=run, args=(r,), name=f"reader-mp-{i}",
                             daemon=True).start()
        done = 0
        while done < len(readers):
            e = q.get()
            if e is end:
                done += 1
                continue
            yield e
        if errs:
            raise errs[0]

    return _reader
