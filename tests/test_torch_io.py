"""The port's data path (``io``, ``reader``, ``batch``) against the JAX
package's, on the CPU.

- The samplers' index lists (``RandomSampler`` with and without
  replacement, ``WeightedRandomSampler``, ``BatchSampler``,
  ``DistributedBatchSampler`` rank by rank and epoch by epoch) and
  ``random_split``'s subsets equal the reference's under one
  ``np.random.seed``.
- ``DataLoader`` batches at ``num_workers`` 0 and 2 equal each other and
  the reference's (``FakeData``, shuffled and not); a batch leaves as CPU
  tensors, a bfloat16 one crossing from a worker intact.
- A map-style dataset sees ``get_worker_info()`` inside each worker and
  None in the loading process; an ``IterableDataset`` that shards itself by
  worker is read whole in the loading process, as in the reference.
- A worker's exception surfaces as ``RuntimeError`` carrying the worker's
  traceback, and a worker killed without one raises too; neither hangs
  and no worker is left behind. A loop that stops early leaves none
  either.
- At most ``num_workers * prefetch_factor`` batches are in flight.
- A worker runs one torch and one BLAS thread and starts from the
  loading process's numpy state (workers are not reseeded), as in the
  reference; the loader leaves that state untouched.
- An injected ``data_fetch`` fault is retried (one retry counted, no batch
  lost); with telemetry on, ``dataloader_fetch_seconds`` and
  ``dataloader_batches_total`` count every batch.
- The reference's ``tests/test_reader.py`` cases, run on both packages.
"""
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import io as rio
from paddle_tpu import reader as rreader
from paddle_tpu.vision.datasets import FakeData as RFakeData

import paddle_tpu_torch as port
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.telemetry.metrics import Registry
from paddle_tpu_torch.vision.datasets import FakeData as PFakeData
from torch_threads import two_threads  # noqa: F401

PACKAGES = {"ref": (ref, rio, rreader), "port": (port, pio, preader)}


def _indices(make, seed=3):
    np.random.seed(seed)
    return [list(make()) for _ in range(2)]


@pytest.mark.parametrize("case", [
    "random", "random_replacement", "random_num_samples", "weighted",
    "weighted_no_replacement", "batch_shuffled", "batch_drop_last",
    "sequence"])
def test_sampler_index_lists_equal_the_reference(case):
    data = list(range(23))

    def make(io):
        return {
            "random": lambda: io.RandomSampler(data),
            "random_replacement": lambda: io.RandomSampler(
                data, replacement=True, num_samples=30),
            "random_num_samples": lambda: io.RandomSampler(
                data, num_samples=7),
            "weighted": lambda: io.WeightedRandomSampler(
                np.arange(1, 11), 15),
            "weighted_no_replacement": lambda: io.WeightedRandomSampler(
                np.arange(1, 11), 6, replacement=False),
            "batch_shuffled": lambda: io.BatchSampler(
                data, shuffle=True, batch_size=5),
            "batch_drop_last": lambda: io.BatchSampler(
                data, shuffle=True, batch_size=5, drop_last=True),
            "sequence": lambda: io.SequenceSampler(data),
        }[case]()

    rs, ps = make(rio), make(pio)
    assert _indices(lambda: iter(rs)) == _indices(lambda: iter(ps))
    assert len(rs) == len(ps)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_rank_by_rank(shuffle, drop_last):
    data = list(range(21))
    for rank in range(4):
        r = rio.DistributedBatchSampler(data, 4, num_replicas=4, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        p = pio.DistributedBatchSampler(data, 4, num_replicas=4, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in (0, 1, 5):
            r.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(r) == list(p)
            assert list(r) == list(p)    # the epoch advanced in both
        assert len(r) == len(p)


def test_random_split_and_datasets():
    np.random.seed(11)
    ra = [s.indices for s in rio.random_split(list(range(17)), [5, 12])]
    np.random.seed(11)
    pa = [s.indices for s in pio.random_split(list(range(17)), [5, 12])]
    assert ra == pa
    g = torch.Generator().manual_seed(0)
    parts = pio.random_split(list(range(10)), [3, 7], generator=g)
    assert sorted(parts[0].indices + parts[1].indices) == list(range(10))
    with pytest.raises(ValueError):
        pio.random_split(list(range(10)), [3, 3])

    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    rt, pt = rio.TensorDataset([x, y]), pio.TensorDataset([x, y])
    pt2 = pio.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    for i in range(6):
        for a, b, c in zip(rt[i], pt[i], pt2[i]):
            np.testing.assert_array_equal(a, b.numpy())
            np.testing.assert_array_equal(a, c.numpy())
    for io, cast in ((rio, np.asarray), (pio, lambda t: t.numpy())):
        cat = io.ConcatDataset([io.TensorDataset([x[:2]]),
                                io.TensorDataset([x[2:]])])
        assert len(cat) == 6
        np.testing.assert_array_equal(cast(cat[-1][0]), x[5])
        np.testing.assert_array_equal(cast(cat[3][0]), x[3])
        comp = io.ComposeDataset([io.TensorDataset([x]),
                                  io.TensorDataset([y, y])])
        assert len(comp[2]) == 3
        sub = io.Subset(io.TensorDataset([y]), [4, 1])
        assert [int(cast(sub[i][0])) for i in range(2)] == [4, 1]
        # a comprehension: list() would ask __len__, which raises
        assert [v for v in io.ChainDataset([range(2), range(3)])] == \
            [0, 1, 0, 1, 2]


def _batches(loader):
    return [[np.asarray(t) for t in b] for b in loader]


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_equal_across_workers_and_the_reference(shuffle):
    rds, pds = RFakeData(size=40), PFakeData(size=40)
    np.random.seed(2)
    want = _batches(rio.DataLoader(rds, batch_size=8, shuffle=shuffle))
    got = {}
    for w in (0, 2):
        np.random.seed(2)
        loader = pio.DataLoader(pds, batch_size=8, shuffle=shuffle,
                                num_workers=w)
        batches = list(loader)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for b in batches for t in b)
        assert batches[0][0].dtype == torch.float32
        assert batches[0][1].dtype == torch.int64
        got[w] = _batches(batches)
    for w, batches in got.items():
        assert len(batches) == len(want) == 5
        for a, b in zip(batches, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


class _Rows(pio.Dataset):
    """Row ``i`` of a bfloat16 table, its index and the worker's id."""

    def __init__(self, n=12):
        self.table = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)\
            .to(torch.bfloat16)

    def __len__(self):
        return self.table.shape[0]

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return {"row": self.table[i], "idx": i,
                "worker": -1 if info is None else info.id}


def test_collate_and_worker_info():
    ds = _Rows()
    single = list(pio.DataLoader(ds, batch_size=5))
    multi = list(pio.DataLoader(ds, batch_size=5, num_workers=2))
    assert [len(b["idx"]) for b in multi] == [5, 5, 2]
    for a, b in zip(single, multi):
        assert b["row"].dtype == torch.bfloat16
        assert torch.equal(a["row"], b["row"])
        assert torch.equal(a["idx"], b["idx"])
        assert a["idx"].dtype == torch.int64
    assert {int(w) for b in single for w in b["worker"]} == {-1}
    assert {int(w) for b in multi for w in b["worker"]} <= {0, 1}
    assert pio.get_worker_info() is None
    out = pio.default_collate_fn([(1.5, np.int32(2), "a"),
                                  (2.5, np.int32(3), "b")])
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int64
    assert list(out[2]) == ["a", "b"]


def _make_sharded(io):
    class Sharded(io.IterableDataset):
        """0..9, split among the workers when read in one."""

        def __iter__(self):
            info = io.get_worker_info()
            if info is None:
                return iter(range(10))
            return iter(range(info.id, 10, info.num_workers))
    return Sharded()


def test_iterable_dataset_is_read_whole_in_the_loading_process():
    want = _batches(rio.DataLoader(_make_sharded(rio), batch_size=4))
    for w in (0, 2):
        got = _batches(pio.DataLoader(_make_sharded(pio), batch_size=4,
                                      num_workers=w))
        assert [b[0].tolist() if b[0].ndim else b for b in got] == \
            [np.asarray(b).tolist() for b in want]
    assert len(list(pio.DataLoader(_make_sharded(pio), batch_size=4,
                                   drop_last=True))) == 2
    with pytest.raises(TypeError):
        len(pio.DataLoader(_make_sharded(pio), batch_size=4))


class _Faulty(pio.Dataset):
    def __init__(self, bad, how):
        self.bad, self.how = bad, how

    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i == self.bad:
            if self.how == "raise":
                raise ValueError(f"bad sample {i}")
            os._exit(3)
        return np.float32([i])


def _no_children(timeout=10.0):
    for p in mp.active_children():
        p.join(timeout)
    return not mp.active_children()


@pytest.mark.parametrize("buffered", [True, False])
def test_worker_error_surfaces_with_its_traceback(buffered):
    loader = pio.DataLoader(_Faulty(13, "raise"), batch_size=4,
                            num_workers=2, use_buffer_reader=buffered)
    with pytest.raises(RuntimeError) as err:
        list(loader)
    msg = str(err.value)
    assert "DataLoader worker failed" in msg
    assert "Traceback" in msg and "ValueError: bad sample 13" in msg
    assert _no_children()


def test_killed_worker_raises_and_an_early_stop_leaves_no_worker():
    loader = pio.DataLoader(_Faulty(9, "exit"), batch_size=4,
                            num_workers=2)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(loader)
    assert _no_children()
    it = iter(pio.DataLoader(_Faulty(-1, "raise"), batch_size=2,
                             num_workers=3))
    assert next(it)[0].tolist() == [0.0]
    it.close()
    assert not it.thread.is_alive()
    assert _no_children()


class _Threads(pio.Dataset):
    """Sample i: (torch's threads, numpy's BLAS threads) where it is read."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        from threadpoolctl import threadpool_info
        blas = [p["num_threads"] for p in threadpool_info()
                if p["user_api"] == "blas"]
        return torch.get_num_threads(), max(blas)


def test_workers_run_one_torch_and_one_blas_thread():
    pytest.importorskip("threadpoolctl")
    got = list(pio.DataLoader(_Threads(), batch_size=2, num_workers=2))
    assert all(b[0].tolist() == [1, 1] and b[1].tolist() == [1, 1]
               for b in got)


def _make_draws(io):
    class Draws(io.Dataset):
        """Sample i: the worker's id and the next draw of numpy's global
        generator where it is read."""

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.float64([io.get_worker_info().id, np.random.rand()])
    return Draws()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_workers_start_from_the_loading_process_random_state(pkg):
    io = PACKAGES[pkg][1]
    np.random.seed(1)
    want = list(np.random.rand(4))
    np.random.seed(1)
    torch_state = torch.get_rng_state()
    by_worker = {}
    for b in io.DataLoader(_make_draws(io), batch_size=1, num_workers=2):
        wid, draw = np.asarray(b[0]).tolist()
        by_worker.setdefault(wid, []).append(draw)
    # numpy's generator is not reseeded in a worker: each makes the
    # loading process's first draws, whichever batches it took (Python's
    # random reseeds itself in every forked child)
    assert sum(map(len, by_worker.values())) == 4
    for draws in by_worker.values():
        assert draws == want[:len(draws)]
    assert np.random.rand() == want[0]
    assert torch.equal(torch.get_rng_state(), torch_state)


class _Started(pio.Dataset):
    """32 samples; counts in ``started`` the batches of two a worker has
    begun."""

    def __init__(self):
        self.started = mp.get_context("fork").Value("i", 0)

    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i % 2 == 0:
            with self.started.get_lock():
                self.started.value += 1
        return np.float32([i])


def test_at_most_workers_times_prefetch_batches_in_flight():
    ds = _Started()
    it = iter(pio.DataLoader(ds, batch_size=2, num_workers=2,
                             prefetch_factor=3, use_buffer_reader=False))
    window, seen = 6, []
    for k in range(16):
        seen.append(next(it)[0].tolist())
        # the workers run ahead until the window is full, and no further
        bound = min(16, k + 1 + window)
        deadline = time.monotonic() + 10.0
        while ds.started.value < bound and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.02)
        assert ds.started.value == bound
    assert seen == [[float(2 * k)] for k in range(16)]
    with pytest.raises(StopIteration):
        next(it)
    assert _no_children()


def test_data_fetch_fault_is_retried_and_telemetry_counts_batches():
    class DS:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.float32([i])

    prev = telemetry.get_registry()
    reg = Registry()
    telemetry._set_registry(reg)
    telemetry.enable()
    try:
        dl = pio.DataLoader(DS(), batch_size=2, shuffle=False)
        with faults.inject("data_fetch", at_step=1) as f:
            batches = [b.numpy() for b in dl]
        assert f.fired == 1
        assert [b.ravel().tolist() for b in batches] == \
            [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
        assert reg.get("retries_total").value(site="dataloader_fetch") == 1
        assert reg.get("dataloader_fetch_seconds").count() == 4
        assert reg.get("dataloader_batches_total").value() == 4
    finally:
        telemetry.disable()
        telemetry._set_registry(prev)
    reg2 = Registry()
    telemetry._set_registry(reg2)
    try:
        list(pio.DataLoader(DS(), batch_size=2))
    finally:
        telemetry._set_registry(prev)
    assert reg2.get("dataloader_fetch_seconds") is None


# -- the reference's tests/test_reader.py, on both packages -----------------

def _r(n=10):
    def rd():
        return iter(range(n))
    return rd


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_reader_cache_replays(pkg):
    reader = pkg[2]
    calls = []

    def rd():
        calls.append(1)
        return iter([1, 2, 3])
    c = reader.cache(rd)
    assert list(c()) == [1, 2, 3]
    assert list(c()) == [1, 2, 3]
    assert len(calls) == 1


def test_reader_map_shuffle_chain_firstn(pkg):
    reader = pkg[2]
    assert list(reader.map_readers(lambda a, b: a + b, _r(3), _r(3))()) == \
        [0, 2, 4]
    assert sorted(reader.shuffle(_r(20), buf_size=7)()) == list(range(20))
    assert list(reader.chain(_r(2), _r(3))()) == [0, 1, 0, 1, 2]
    assert list(reader.firstn(_r(100), 4)()) == [0, 1, 2, 3]


def test_reader_compose_flattens_and_checks_alignment(pkg):
    reader = pkg[2]
    pairs = lambda: iter([(1, 2), (3, 4)])  # noqa: E731
    assert list(reader.compose(_r(2), pairs)()) == [(0, 1, 2), (1, 3, 4)]
    with pytest.raises(RuntimeError, match="lengths"):
        list(reader.compose(_r(2), _r(5))())
    assert list(reader.compose(_r(2), _r(5),
                               check_alignment=False)()) == [(0, 0), (1, 1)]


def test_reader_buffered_preserves_order_and_raises(pkg):
    reader = pkg[2]
    assert list(reader.buffered(_r(50), 8)()) == list(range(50))

    def bad():
        yield 1
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        list(reader.buffered(bad, 4)())


def test_reader_xmap_ordered_unordered_and_errors(pkg):
    reader = pkg[2]
    sq = lambda x: x * x  # noqa: E731
    assert list(reader.xmap_readers(sq, _r(10), 4, 8, order=True)()) == \
        [i * i for i in range(10)]
    assert sorted(reader.xmap_readers(sq, _r(10), 4, 8)()) == \
        sorted(i * i for i in range(10))
    with pytest.raises(ZeroDivisionError):
        list(reader.xmap_readers(lambda x: 1 // x,
                                 lambda: iter([1, 0, 2]), 2, 4)())

    def broken_reader():
        yield 1
        raise RuntimeError("src boom")
    with pytest.raises(RuntimeError, match="src boom"):
        list(reader.xmap_readers(lambda x: x, broken_reader, 2, 4)())


def test_reader_multiprocess_interleaves_and_propagates(pkg):
    reader = pkg[2]
    out = list(reader.multiprocess_reader([_r(5), _r(5)])())
    assert sorted(out) == sorted(list(range(5)) * 2)
    with pytest.raises(ValueError):
        reader.multiprocess_reader([])

    def broken():
        yield 1
        raise RuntimeError("dead reader")
    with pytest.raises(RuntimeError, match="dead reader"):
        list(reader.multiprocess_reader([_r(3), broken])())


def test_reader_top_level_namespace_and_batch(pkg):
    top, _, reader = pkg
    assert top.reader.buffered is reader.buffered
    assert list(top.batch(_r(7), 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(top.batch(_r(7), 3, drop_last=True)()) == \
        [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError):
        top.batch(_r(7), 0)
