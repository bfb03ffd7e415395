"""The port's hot tier on the device (``distributed/ps/heter.py``) against the
JAX package's ``HeterEmbedding``, on the CPU.

Both packages train the same model (a linear head over the hot tier's
rows, weights from the reference) through their ``ParallelTrainer`` on
the same batches, SGD or Adagrad, with and without evictions: the tier's
host map makes the same decisions (hits, misses, evictions equal), and
the losses (rtol 1e-5), the hot rows and their accumulators, and the
table's rows and slot columns after ``flush_all`` agree within
``ATOL`` = 1e-6: float32 rounding of another GEMM order moves a row by a
few ulps of lr-sized steps (lr 0.1, rows of order 0.1-1).

Port-side checks, bit for bit where the arithmetic is the same:
- the overlapped loop (``prepare_async`` one batch ahead) against the
  serial ``prepare`` loop: equal losses, rows and slots;
- the sharded tier (``shard_axis="model"``, a gloo world of 2,
  ``torch_ps_worker.heter_rank``) against the replicated one: the same
  losses, stats and table rows (a row sums with zeros over ``model``);
- the lookup's forward and gradient against a dense ``nn.Embedding`` of
  the same rows;
- Wide&Deep's hot tier against its host-table path (``sparse=True``):
  the same math where no id repeats within a batch (a repeat is one
  merged update on the device and one update per occurrence on the
  host), losses rtol 1e-4.
"""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.distributed.ps import HeterEmbedding as RefHeter

from paddle_tpu_torch import nn, optimizer as topt
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.distributed.ps import HeterEmbedding, SparseTable

import torch_ps_worker as worker

ATOL = 1e-6
DIM = 8


def _batches(n_steps, batch, width, vocab, seed=0, distinct=True):
    rs = np.random.RandomState(seed)
    ids_seq, y_seq = [], []
    for _ in range(n_steps):
        if distinct:
            ids = rs.choice(vocab, size=(batch * width,), replace=False)
        else:
            ids = rs.randint(0, vocab, size=(batch * width,))
        ids = ids.reshape(batch, width).astype(np.int64)
        ids[rs.rand(batch, width) < 0.15] = -1         # padding
        ids[:, 0] = np.abs(ids[:, 0])
        ids_seq.append(ids)
        y_seq.append(rs.randn(batch).astype(np.float32))
    return ids_seq, y_seq


def _ref_path(ids_seq, y_seq, lr, optimizer, capacity):
    ref_build_mesh({"data": 1})
    paddle.seed(0)
    emb = RefHeter(DIM, capacity=capacity, optimizer=optimizer,
                   init_range=0.0)

    class M(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = emb
            self.head = rnn.Linear(DIM, 1)

        def forward(self, ids):
            return self.head(self.emb(ids))[..., 0, 0]
    m = M()
    opt = (paddle.optimizer.SGD(lr, parameters=m.parameters())
           if optimizer == "sgd" else paddle.optimizer.Adagrad(
               lr, epsilon=1e-8, parameters=m.parameters()))
    tr = RefTrainer(m, opt, lambda o, y: jnp.mean(jnp.square(o - y)))
    losses = [float(tr.train_step(emb.prepare(i), y))
              for i, y in zip(ids_seq, y_seq)]
    weights = {k[len("head."):]: np.asarray(v)
               for k, v in m.state_dict().items() if k.startswith("head.")}
    return losses, emb, tr, weights


def _head_weights():
    ref_build_mesh({"data": 1})
    paddle.seed(0)
    head = rnn.Linear(DIM, 1)
    return {k: np.asarray(v) for k, v in head.state_dict().items()}


def _port(ids_seq, y_seq, lr, optimizer, capacity, **kw):
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    return worker.heter_path(ids_seq, y_seq, DIM, lr, optimizer, capacity,
                             _head_weights(), **kw)


def _slots(emb):
    tr = emb._trainer
    return {sn: tr.get_opt_slot(emb._pname, sn).numpy().copy()
            for sn in tr.opt_slot_names(emb._pname)}


CASES = {"sgd": (6, 4, 3, 40, 64, "sgd", 0),
         "sgd-evict": (8, 4, 3, 60, 16, "sgd", 3),
         "adagrad": (6, 4, 3, 40, 64, "adagrad", 1),
         "adagrad-evict": (10, 4, 3, 40, 16, "adagrad", 5)}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_against_the_reference(case):
    n, b, w, vocab, cap, opt, seed = CASES[case]
    ids_seq, y_seq = _batches(n, b, w, vocab, seed=seed)
    rl, remb, rtr, rw = _ref_path(ids_seq, y_seq, 0.1, opt, cap)
    pl, pemb = _port(ids_seq, y_seq, 0.1, opt, cap)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for k in ("lookups", "hits", "misses", "evicts"):
        assert pemb.stats[k] == remb.stats[k], k
    assert (pemb.stats["evicts"] > 0) == case.endswith("evict")
    np.testing.assert_array_equal(pemb._slot2key, remb._slot2key)
    name = pemb._pname
    np.testing.assert_allclose(pemb._trainer.get_param(name).numpy(),
                               np.asarray(rtr.get_param(name)), atol=ATOL)
    for sn, v in _slots(pemb).items():      # adagrad: the accumulators
        np.testing.assert_allclose(
            v, np.asarray(rtr.get_opt_slot(name, sn)), atol=ATOL)
    for e in (pemb, remb):
        e.flush_all()
    keys = np.arange(vocab)
    np.testing.assert_allclose(pemb.table.export_rows(keys, False),
                               remb.table.export_rows(keys, False),
                               atol=ATOL)


def test_overlapped_loop_equals_the_serial_one_bit_for_bit():
    ids_seq, y_seq = _batches(10, 4, 3, vocab=40, seed=5)
    sl, semb = _port(ids_seq, y_seq, 0.1, "adagrad", 16)
    ol, oemb = _port(ids_seq, y_seq, 0.1, "adagrad", 16, overlapped=True)
    assert ol == sl and oemb.stats["evicts"] == semb.stats["evicts"] > 0
    assert torch.equal(oemb._trainer.get_param(oemb._pname),
                       semb._trainer.get_param(semb._pname))
    for sn, v in _slots(oemb).items():
        np.testing.assert_array_equal(v, _slots(semb)[sn])
    for e in (oemb, semb):
        e.flush_all()
    keys = np.arange(40)
    np.testing.assert_array_equal(oemb.table.export_rows(keys, False),
                                  semb.table.export_rows(keys, False))
    # the trainer's live-state accessors the tier binds through
    tr = semb._trainer
    assert tr.param_name_of(semb.hot) == semb._pname == "emb.hot"
    assert tr.param_name_of(torch.nn.Parameter(torch.zeros(1))) is None
    assert tr.opt_slot_names(semb._pname) == ["moment"]
    slot = tr.get_opt_slot(semb._pname, "moment")
    tr.set_opt_slot(semb._pname, "moment", np.zeros(tuple(slot.shape)))
    assert tr.get_opt_slot(semb._pname, "moment") is slot
    assert float(slot.abs().sum()) == 0.0


def test_padding_save_load_and_no_trainer():
    emb = HeterEmbedding(4, capacity=8, optimizer="sgd", init_range=0.05)
    slots = emb.prepare(np.asarray([[1, -1], [2, 1]], np.int64))
    assert slots[0, 1] == -1 and slots[0, 0] == slots[1, 1]
    out = emb(torch.from_numpy(slots))
    assert float(out[0, 1].detach().abs().sum()) == 0.0
    np.testing.assert_array_equal(out[1, 0].detach().numpy(),
                                  emb.table.pull(np.asarray([2]))[0])
    # without a trainer the values move and the table keeps its slots
    with torch.no_grad():
        emb.hot.add_(1.0)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        emb.save(d + "/t")
        emb2 = HeterEmbedding(4, capacity=8, optimizer="sgd")
        emb2.load(d + "/t")
    s2 = emb2.prepare(np.asarray([[1, -1], [2, 1]], np.int64))
    np.testing.assert_array_equal(emb2(torch.from_numpy(s2)).detach(),
                                  out.detach() + torch.from_numpy(
                                      (slots >= 0)[..., None] * 1.0).float())
    with pytest.raises(RuntimeError, match="cannot hold"):
        emb2.prepare(np.arange(9))
    with pytest.raises(TypeError, match="export_rows"):
        HeterEmbedding(4, 8, table=object())


def test_lookup_forward_and_grads_against_dense():
    rs = np.random.RandomState(0)
    emb = HeterEmbedding(DIM, capacity=32, optimizer="sgd", pooling="mean")
    with torch.no_grad():
        emb.hot.copy_(torch.from_numpy(rs.randn(32, DIM).astype(np.float32)))
    dense = nn.Embedding(32, DIM)
    dense.set_state_dict_from_numpy({"weight": emb.hot.detach().numpy()})
    slots = torch.from_numpy(rs.randint(-1, 32, (6, 5)))
    coef = torch.arange(1.0, 1.0 + DIM)
    out = emb(slots)
    mask = (slots >= 0).float()[..., None]
    want = (dense(slots.clamp(min=0)) * mask).sum(1) / \
        mask.sum(1).clamp(min=1.0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    g1, = torch.autograd.grad((out * coef).sum(), [emb.hot])
    g2, = torch.autograd.grad((want * coef).sum(), [dense.weight])
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)


@pytest.mark.multihost(timeout=240)
def test_sharded_over_model_2_equals_replicated(tmp_path):
    from paddle_tpu_torch.distributed.spawn import spawn
    ids_seq, y_seq = _batches(8, 4, 3, vocab=40, seed=5)
    args = (ids_seq, y_seq, DIM, 0.1, "adagrad", 16, _head_weights())
    with open(tmp_path / "plan.pkl", "wb") as f:
        pickle.dump({"args": args, "vocab": 40}, f)
    spawn(worker.heter_rank, args=(str(tmp_path / "plan.pkl"),
                                   str(tmp_path)), nprocs=2, timeout=200)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    rl, remb = _port(*args[:2], 0.1, "adagrad", 16)
    remb.flush_all()
    rows = remb.table.export_rows(np.arange(40), False)
    for got in ranks:
        assert got["hot_shape"] == (8, DIM)
        assert got["losses"] == rl
        assert {k: got["stats"][k] for k in ("lookups", "hits", "evicts")} \
            == {k: remb.stats[k] for k in ("lookups", "hits", "evicts")}
        np.testing.assert_array_equal(got["rows"], rows)
    assert remb.stats["evicts"] > 0
    with pytest.raises(ValueError, match="divisible"):
        HeterEmbedding(DIM, capacity=15)._check_shard_capacity(2)


def test_wide_deep_hot_tier_against_the_host_table_path():
    from paddle_tpu_torch import framework, rec
    fields = [50] * 4
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(5):
        ids = np.stack([rs.choice(50, 8, replace=False) for _ in fields], 1)
        batches.append((ids.astype(np.int64),
                        rs.randn(8, 5).astype(np.float32),
                        rs.randint(0, 2, 8).astype(np.float32)))

    def bce(logit, y):
        return (logit.clamp(min=0) - logit * y
                + torch.log1p(torch.exp(-logit.abs()))).mean()

    def run(mode):
        mesh_mod.set_mesh(None)
        mesh_mod.build_mesh({"data": 1})
        framework.seed(0)
        m = rec.WideDeep(fields, dense_dim=5, embedding_dim=4,
                         hidden_sizes=(16,), sparse=mode, heter_capacity=64)
        if mode is True:        # the host tables start from zero rows, as
            for t in (m.embedding, m.linear_emb):   # the hot tier's promote
                t.table = SparseTable(t.dim, "adagrad", init_range=0.0)
                t._lookup = __import__(
                    "paddle_tpu_torch.distributed.ps.embedding",
                    fromlist=["make_lookup"]).make_lookup(t.table)
        else:
            m.ctr_table.table = SparseTable(5, "adagrad", init_range=0.0)
        tr = ParallelTrainer(m, topt.Adagrad(0.05, epsilon=1e-8), bce,
                             device="cpu")
        losses = []
        for ids, dense, y in batches:
            if mode == "heter":
                ids = m.prepare_batch(ids)
            losses.append(float(tr.train_step(
                (torch.from_numpy(ids), torch.from_numpy(dense)),
                torch.from_numpy(y))))
        return losses, m

    host, _ = run(True)
    het, m = run("heter")
    np.testing.assert_allclose(het, host, rtol=1e-4)
    assert m.ctr_table.stats["evicts"] > 0 and het[-1] < het[0]
