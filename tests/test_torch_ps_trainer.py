"""The port's PS trainer runtime and dataset (``distributed/ps/trainer.py``,
``datafeed.py``) against the JAX package's, on the CPU.

Both packages drive the same C++ tables and parser with the same numpy
step function (a logistic regression over mean-pooled rows, its
gradient written out in numpy), so where the order of the pulls and
pushes is fixed (one Hogwild thread; one Downpour thread fed a batch a
call, each call flushing its Communicator) the tables come out bit for
bit equal; with several Hogwild threads the order is not
fixed, and the test holds what must hold whatever the order (every batch
run once, padding never reaching the table). The datasets parse the same
files into the same batches, bit for bit, also after a global shuffle,
in one process and across two ranks exchanging through a directory.
"""
import threading

import numpy as np
import pytest

from paddle_tpu.distributed import ps as ref_ps

from paddle_tpu_torch.distributed import ps

DIM = 8
VOCAB = 200
_TRUE = np.random.RandomState(0).randn(VOCAB).astype(np.float32)


def _batches(n, bsz, seq=6, pad_frac=0.3, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, VOCAB, (bsz, seq)).astype(np.int64)
        labels = (_TRUE[ids].mean(axis=1) > 0).astype(np.float32)
        mask = rs.rand(bsz, seq) < pad_frac
        mask[:, 0] = False
        out.append({"ids": np.where(mask, -1, ids), "label": labels})
    return out


def _step(emb, w, batch):
    """loss, d/demb, d/dw of a logistic regression on mean-pooled rows."""
    y = np.asarray(batch["label"], np.float32).reshape(-1)
    feat = emb.mean(axis=1)
    logit = feat @ w
    loss = np.mean(np.maximum(logit, 0) - logit * y +
                   np.log1p(np.exp(-np.abs(logit))))
    dlogit = (1.0 / (1.0 + np.exp(-logit)) - y) / y.size
    gw = feat.T @ dlogit
    ge = np.repeat((dlogit[:, None] * w[None, :])[:, None, :],
                   emb.shape[1], axis=1) / emb.shape[1]
    return float(loss), ge.astype(np.float32), gw.astype(np.float32)


def _train(mod, worker, threads, epochs=2):
    table = mod.SparseTable(DIM, "adagrad", seed=3, init_range=0.01)
    dense = mod.DenseTable(DIM, "sgd", init=np.zeros(DIM, np.float32))
    trainer = mod.TrainerFactory().create(mod.TrainerDesc(
        worker=worker, thread_num=threads, batch_size=32, lr=0.5))
    batches = _batches(8, 32)
    if worker == "downpour" and threads == 1:
        # the Communicator applies pushes behind the worker (bounded
        # staleness): one batch a call, whose end flushes it, fixes the
        # order of pulls and pushes
        stats = []
        for _ in range(epochs):
            runs = [trainer.train([b], _step, table, dense_table=dense)
                    for b in batches]
            stats.append({"losses": [r["losses"][0] for r in runs],
                          "loss_mean": float(np.mean(
                              [r["loss_mean"] for r in runs]))})
        return table, dense, trainer, stats
    stats = [trainer.train(batches, _step, table, dense_table=dense)
             for _ in range(epochs)]
    return table, dense, trainer, stats


@pytest.mark.parametrize("worker", ["hogwild", "downpour"])
def test_one_thread_trains_bit_for_bit(worker):
    got, want = (_train(m, worker, 1) for m in (ps, ref_ps))
    keys = np.arange(VOCAB)
    np.testing.assert_array_equal(got[0].export_rows(keys, False),
                                  want[0].export_rows(keys, False))
    np.testing.assert_array_equal(got[1].pull(), want[1].pull())
    assert [s["losses"] for s in got[3]] == [s["losses"] for s in want[3]]
    assert got[3][-1]["loss_mean"] < got[3][0]["loss_mean"]
    if worker == "downpour":
        assert got[2].communicator.pushes_applied == 1


def test_hogwild_threads_run_every_batch_and_skip_padding():
    table, _, trainer, stats = _train(ps, "hogwild", 3)
    assert stats[-1]["batches"] == 8 and stats[-1]["threads"] == 3
    assert sorted(w.batches_done for w in trainer.workers) == [2, 3, 3]
    seen = np.unique(np.concatenate([b["ids"].ravel()
                                     for b in _batches(8, 32)]))
    assert len(table) == (seen >= 0).sum()


def test_communicator_merges_and_flushes_as_the_reference():
    for merge in (True, False):
        tabs = []
        for mod in (ps, ref_ps):
            t = mod.SparseTable(4, "adagrad", init_range=0.0)
            comm = mod.Communicator(t, lr=1.0, merge_grads=merge,
                                    send_queue_size=64)
            for i in range(5):
                comm.send(np.array([7, 7, 9], np.int64),
                          np.full((3, 4), i + 1.0, np.float32))
            comm.flush()
            assert comm.pushes_applied == 5
            comm.stop()
            tabs.append(t)
        np.testing.assert_array_equal(tabs[0].export_rows([7, 9]),
                                      tabs[1].export_rows([7, 9]))
    with pytest.raises(ValueError, match="hogwild"):
        ps.TrainerFactory().create(ps.TrainerDesc(worker="nope"))

    def bad(emb, dense, batch):
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        ps.MultiTrainer(ps.TrainerDesc(thread_num=2)).train(
            _batches(2, 8), bad, ps.SparseTable(DIM, "sgd"))


def _write(tmp_path, name, n, seed):
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        ids = rs.randint(0, VOCAB, rs.randint(1, 5))
        lines.append(f"{ids.size} " + " ".join(map(str, ids)) +
                     f"  2 {rs.rand():.4f} {rs.rand():.4f}  1 {i % 2}")
    lines.insert(3, "garbage")                 # skipped by the parser
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _dataset(mod, files):
    ds = mod.InMemoryDataset(["ids", "dense", "label"],
                             dense_slots=["dense", "label"])
    ds.load_into_memory(files, nthreads=4)
    return ds


def _same_batches(a, b, size):
    ba, bb = list(a.batches(size, drop_last=False)), \
        list(b.batches(size, drop_last=False))
    assert len(ba) == len(bb) > 0
    for x, y in zip(ba, bb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_datasets_parse_shuffle_and_feed_a_trainer(tmp_path):
    files = [_write(tmp_path, f"part-{i}", 40, i) for i in range(2)]
    port, ref = _dataset(ps, files), _dataset(ref_ps, files)
    assert len(port) == len(ref) == 80
    _same_batches(port, ref, 16)
    port.global_shuffle(seed=5)
    ref.global_shuffle(seed=5)
    _same_batches(port, ref, 16)
    assert ps.QueueDataset is ps.InMemoryDataset
    # the trainer reads the dataset's batches (exe.train_from_dataset)
    table = ps.SparseTable(DIM, "adagrad", seed=3)
    dense = ps.DenseTable(DIM, "sgd", init=np.zeros(DIM, np.float32))
    stats = ps.TrainerFactory().create(ps.TrainerDesc(
        worker="downpour", thread_num=2, batch_size=16, lr=0.5)).train(
        port, _step, table, dense_table=dense)
    assert stats["batches"] == 5 and len(table) > 0


def test_global_shuffle_across_two_ranks(tmp_path):
    files = [_write(tmp_path, f"part-{r}", 15, 7 + r) for r in range(2)]
    out = {}

    def rank(mod, r, d):
        ds = _dataset(mod, [files[r]])
        ds.global_shuffle(seed=1, rank=r, nprocs=2, exchange_dir=str(d),
                          timeout=60)
        out[(mod.__name__, r)] = ds

    for mod, d in ((ps, tmp_path / "ex_port"), (ref_ps, tmp_path / "ex_ref")):
        ts = [threading.Thread(target=rank, args=(mod, r, d))
              for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
    for r in range(2):
        _same_batches(out[(ps.__name__, r)], out[(ref_ps.__name__, r)], 8)
    assert sum(len(out[(ps.__name__, r)]) for r in range(2)) == 30
    with pytest.raises(ValueError, match="fresh seed"):
        _dataset(ps, files[:1]).global_shuffle(
            seed=1, rank=0, nprocs=2, exchange_dir=str(tmp_path / "ex_port"))
