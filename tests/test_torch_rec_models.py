"""The port's Wide&Deep and DeepFM (``paddle_tpu_torch/rec``) and the
host-table embedding (``distributed/ps/embedding.py``) against the JAX
package's, on the CPU.

The same numpy weights (``set_state_dict_from_numpy``) and batches go
through both packages' models and ``ParallelTrainer``s, in the three
storage modes: dense ``nn.Embedding``, ``sparse=True`` (the host table,
seed 0 on both sides, so the same rows) and ``sparse="heter"`` (the hot
tier on the device over the host table). Tolerances, each where it is
asserted:

- a forward: float32 sums of at most a few hundred products in another
  order (PyTorch's CPU GEMM against XLA's dot): rtol 1e-5, atol 1e-6.
- three trainer steps: the losses rtol 1e-5; the parameters, the table's
  rows and the hot tier's rows and accumulators within ``STEP_ATOL`` =
  2e-6 (the fp32 trainer's bar of ``test_torch_zero.py``): Adam and
  Adagrad divide each gradient element by its own running scale, so a
  rounding difference in a gradient becomes at most a small fraction of
  one step of lr 1e-3 (the sparse tables' lr 0.05 applies to gradients
  that agree to float32 rounding and moves rows by ~lr a step, so a row
  agrees to a few ulps of its size).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu import rec as ref_rec

from paddle_tpu_torch import framework, jit, optimizer as topt, rec
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.distributed.ps import DistributedEmbedding, SparseTable

FIELDS = [50, 30, 20]
DENSE = 4
STEP_ATOL = 2e-6
LR = 1e-3


def _ctr_data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    ids = np.stack([rs.randint(0, d, n) for d in FIELDS], axis=1) \
        .astype(np.int64)
    ids[::7, 1] = -1                                   # missing fields
    dense = rs.randn(n, DENSE).astype(np.float32)
    label = ((ids[:, 0] % 2 == 0) ^ (dense[:, 0] > 0.5)).astype(np.float32)
    return ids, dense, label


def _bce(logit, y):
    return (logit.clamp(min=0) - logit * y
            + torch.log1p(torch.exp(-logit.abs()))).mean()


def _ref_bce(logit, y):
    return jnp.mean(jnp.maximum(logit, 0) - logit * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logit))))


def _pair(name, sparse, **kw):
    """(reference model, port model) with the reference's weights."""
    ref_build_mesh({"data": 1})
    paddle.seed(0)
    ref = getattr(ref_rec, name)(FIELDS, dense_dim=DENSE, embedding_dim=8,
                                 hidden_sizes=(16, 8), sparse=sparse, **kw)
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    port = getattr(rec, name)(FIELDS, dense_dim=DENSE, embedding_dim=8,
                              hidden_sizes=(16, 8), sparse=sparse, **kw)
    port.set_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in ref.state_dict().items()})
    return ref, port


def _opts(ref, sparse):
    if sparse == "heter":   # the table's optimizer, so slots migrate
        return (paddle.optimizer.Adagrad(0.05, epsilon=1e-8,
                                         parameters=ref.parameters()),
                topt.Adagrad(0.05, epsilon=1e-8))
    return (paddle.optimizer.Adam(LR, parameters=ref.parameters()),
            topt.Adam(LR))


def _tables(m):
    if m.sparse == "heter":
        return {"ctr": m.ctr_table.table}
    if m.sparse:
        return {"emb": m.embedding.table, "lin": m.linear_emb.table}
    return {}


@pytest.mark.parametrize("sparse", [False, True, "heter"],
                         ids=["dense", "ps", "heter"])
@pytest.mark.parametrize("name", ["WideDeep", "DeepFM"])
def test_three_trainer_steps_against_the_reference(name, sparse):
    kw = dict(heter_capacity=80) if sparse == "heter" else {}
    ref, port = _pair(name, sparse, **kw)
    ropt, popt = _opts(ref, sparse)
    rt = RefTrainer(ref, ropt, _ref_bce)
    pt = ParallelTrainer(port, popt, _bce, device="cpu")
    rl, pl = [], []
    for step in range(3):
        ids, dense, y = _ctr_data(seed=step)
        if sparse == "heter":
            ids = ref.prepare_batch(ids), port.prepare_batch(ids)
        else:
            ids = (ids, ids)
        rl.append(float(rt.train_step((ids[0], dense), y)))
        pl.append(float(pt.train_step((torch.from_numpy(ids[1]),
                                       torch.from_numpy(dense)),
                                      torch.from_numpy(y))))
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for k, v in rt.state["params"].items():
        np.testing.assert_allclose(pt.get_param(k).numpy(), np.asarray(v),
                                   rtol=0, atol=STEP_ATOL, err_msg=k)
    if sparse == "heter":
        for m, t in ((ref, rt), (port, pt)):
            m.ctr_table.flush_all()
        assert port.ctr_table.stats == {**port.ctr_table.stats, **{
            k: ref.ctr_table.stats[k] for k in ("lookups", "hits",
                                                "misses", "evicts")}}
        assert port.ctr_table.stats["evicts"] > 0
    keys = np.arange(sum(FIELDS))
    for k, t in _tables(port).items():
        want = _tables(ref)[k]
        assert len(t) == len(want)
        np.testing.assert_allclose(t.export_rows(keys, False),
                                   want.export_rows(keys, False),
                                   rtol=0, atol=STEP_ATOL, err_msg=k)


def test_forward_in_each_mode_and_deepfm_second_order():
    ids, dense, _ = _ctr_data(8, seed=3)
    for name in ("WideDeep", "DeepFM"):
        for sparse in (False, True):
            ref, port = _pair(name, sparse)
            want = np.asarray(ref(ids, dense))
            got = port((torch.from_numpy(ids), torch.from_numpy(dense)))
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-5, atol=1e-6)
    # FM's pairwise term 0.5[(sum v)^2 - sum v^2] == sum_{i<j} <v_i, v_j>
    framework.seed(1)
    m = rec.DeepFM([4, 4], dense_dim=1, embedding_dim=3, hidden_sizes=(4,))
    v = m._lookup(m.embedding, m._fold_ids(np.asarray([[1, 2]])))[0]
    v = v.detach().double()
    manual = float(v[0] @ v[1])
    fm = 0.5 * (v.sum(0).square() - v.square().sum(0)).sum()
    assert float(fm) == pytest.approx(manual, rel=1e-12)


def test_missing_ids_contribute_zero():
    framework.seed(2)
    m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8)
    dense = torch.zeros(2, DENSE)
    ids_a = torch.tensor([[3, 5, 7], [3, 5, 7]])
    ids_b = ids_a.clone()
    ids_b[1, 2] = -1
    out_a, out_b = m(ids_a, dense), m(ids_b, dense)
    assert out_a[0] == out_b[0]
    assert out_a[1] != out_b[1]
    # a field missing from every row: its row takes no gradient
    ids_c = ids_a.clone()
    ids_c[:, 2] = -1
    m(ids_c, dense).sum().backward()
    g = m.embedding.weight.grad
    assert float(g[7 + 50 + 30].abs().sum()) == 0
    assert float(g[5 + 50].abs().sum()) > 0
    ps = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8, sparse=True)
    ps(ids_c, dense)
    assert len(ps.embedding.table) == 2      # -1 never makes a row


def test_one_rank_data_mesh_trains():
    mesh_mod.set_mesh(None)
    mesh = mesh_mod.build_mesh({"data": 1})
    framework.seed(3)
    m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                     hidden_sizes=(16,))
    tr = ParallelTrainer(m, topt.Adam(5e-3), _bce, mesh=mesh, device="cpu")
    ids, dense, y = (torch.from_numpy(a) for a in _ctr_data(64))
    first = float(tr.train_step((ids, dense), y))
    for _ in range(10):
        last = float(tr.train_step((ids, dense), y))
    assert last < first


def test_jit_save_load_widedeep(tmp_path):
    framework.seed(9)
    m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                     hidden_sizes=(16,))
    m.eval()
    path = str(tmp_path / "wd" / "model")
    jit.save(m, path, input_spec=[jit.InputSpec([2, len(FIELDS)], "int64"),
                                  jit.InputSpec([2, DENSE], "float32")])
    loaded = jit.load(path, device="cpu")
    ids, dense, _ = _ctr_data(2, seed=7)
    ids, dense = torch.from_numpy(ids), torch.from_numpy(dense)
    np.testing.assert_allclose(loaded(ids, dense).detach().numpy(),
                               m(ids, dense).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_ps_backed_model_is_refused_by_the_trace():
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                     hidden_sizes=(16,), sparse=True)
    tr = ParallelTrainer(m, topt.Adam(LR), _bce, device="cpu")
    ids, dense, y = (torch.from_numpy(a) for a in _ctr_data(8))
    with pytest.raises(RuntimeError, match="cannot be traced"):
        tr.compile((ids, dense), y, analyze=True)
    with pytest.raises(RuntimeError, match="cannot be traced"):
        tr.staged_graph((ids, dense), y)
    assert len(m.embedding.table) == 0       # nothing pulled, nothing pushed
    # the refused trace left the trainer as it was: it trains eagerly
    assert torch.isfinite(tr.train_step((ids, dense), y))
    assert len(m.embedding.table) > 0
    # the lookup itself refuses a make_fx trace, fakes or not
    from torch.fx.experimental.proxy_tensor import make_fx
    rows = len(m.embedding.table)
    with pytest.raises(RuntimeError, match="cannot be traced"):
        make_fx(lambda i: m.embedding(i))(ids + 1000)
    assert len(m.embedding.table) == rows
    # the heter model's lookup is a device gather: it traces
    h = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                     hidden_sizes=(16,), sparse="heter", heter_capacity=64)
    htr = ParallelTrainer(h, topt.Adagrad(0.05, epsilon=1e-8), _bce,
                          device="cpu")
    _, rep = htr.compile((torch.from_numpy(h.prepare_batch(ids.numpy())),
                          dense), y, analyze=True)
    assert not rep.errors


def test_distributed_embedding_padding_pooling_and_push():
    """Padding ids read zero rows and are never pulled or pushed; the
    backward pushes each valid id's gradient once, in order, with the
    layer's lr; the hook's gradient is 0."""
    ref_t = SparseTable(4, "sgd", init_range=0.1, seed=3)
    emb = DistributedEmbedding(4, optimizer="sgd", lr=0.5,
                               table=SparseTable(4, "sgd", init_range=0.1,
                                                 seed=3), pooling="mean")
    ids = torch.tensor([[1, 2, -1], [2, -1, -1]])
    rows = ref_t.pull(np.array([1, 2]))
    out = emb(ids)
    np.testing.assert_array_equal(out[0].detach().numpy(),
                                  (rows[0] + rows[1]) / 2)
    np.testing.assert_array_equal(out[1].detach().numpy(), rows[1])
    assert len(emb.table) == 2
    g, = torch.autograd.grad((out * torch.arange(1.0, 5.0)).sum(),
                             [emb.grad_hook])
    assert float(g) == 0.0
    w = np.arange(1.0, 5.0, dtype=np.float32)
    ref_t.push(np.array([1, 2, 2]), np.stack([w / 2, w / 2, w]), 0.5)
    np.testing.assert_array_equal(emb.table.pull(np.array([1, 2])),
                                  ref_t.pull(np.array([1, 2])))


def test_a_skipped_step_has_already_pushed():
    """The push runs inside the backward, before the NaN guard decides:
    a step the guard skips leaves the dense parameters as they were but
    the table's rows moved, as in the reference."""
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    framework.seed(4)
    m = rec.WideDeep(FIELDS, dense_dim=DENSE, embedding_dim=8,
                     hidden_sizes=(16,), sparse=True)
    tr = ParallelTrainer(m, topt.Adam(LR), _bce, device="cpu")
    ids, dense, y = (torch.from_numpy(a) for a in _ctr_data(8))
    tr.train_step((ids, dense), y)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    folded = m._fold_ids(ids).numpy()
    keys = np.unique(folded[folded >= 0])
    rows0 = m.embedding.table.pull(keys).copy()
    tr.train_step((ids, dense), y, grad_taint=float("nan"))
    assert tr.skipped_steps() == 1
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not np.array_equal(m.embedding.table.pull(keys), rows0)
