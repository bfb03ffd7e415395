"""ZeRO stages 1-3 of the port over gloo ranks on the CPU, against the JAX
package's trainer on a mesh of the same shape.

The port ``spawn``s a world of 2 (``{"sharding": 2}``) and of 4
(``{"data": 2, "sharding": 2}``), each once, every case inside that one
spawn (``torch_zero_worker.py``); the reference runs in this process on as
many of the 8 virtual devices, from the same numpy weights and batches.

Tolerances, each derived where it is asserted:

- ``psum_scatter`` and ``compressed_psum_scatter`` against the
  reference's: bit-equal at 2 ranks (a + b rounds once in either order;
  the quantized sums are integer sums); at 4 ranks the lossless sum is
  over the 2 ranks of one sharding group, so bit-equal too; residuals
  within half an ulp of ``q * scale`` as in ``test_torch_data_parallel.py``
  (XLA contracts ``x - q*scale`` into one fused multiply-add).
- The port's stages against its own stage 0 on the same ranks: stage 1
  exchanges as stage 0 does, so bit-equal at 2 and 4 ranks; stages 2 and
  3 at 2 ranks reduce-scatter a + b where stage 0 all-reduces it (one
  rounding either way, the halving exact): the gradients, and without a
  clip the losses, parameters and slots, are bit-equal. A clip's norm of
  a sliced leaf adds each rank's sum of squares, where stage 0 sums the
  whole leaf in one reduction: the scale may differ in its last bit, so
  a clipped run is held as the 4-rank runs are. At 4 ranks stages 2 and
  3 take ((a+b)/2 + (c+d)/2)/2 where stage 0 sums four rows in gloo's
  order: the step-1 gradients the optimizer gets are within the
  sum-order bound of ``_sum_order_close`` of stage 0's, on the rows each
  rank recorded; AdamW carries that last-bit difference through 5 steps,
  so losses rtol 1e-6 and every parameter element within ``FP32_ATOL``.
- The port against the reference at the same stage and mesh cannot be
  bit-equal, at 2 ranks either: the MLP's float32 matmuls (PyTorch's CPU
  GEMM against XLA's CPU dot, forward and backward) add their products in
  other orders, and the cross-entropy's exp and log come from other
  libraries. So in float32 the losses agree to rtol 1e-6 and every
  parameter element within ``FP32_ATOL`` = 2e-6, a five-thousandth of
  one AdamW step (lr 1e-2): AdamW divides each gradient element by its
  own running scale, so an element that cancels to a small sum carries
  its relative rounding error into its step (the runs here differ by at
  most 1.1e-6, under the per-leaf clip). Under a
  quantized policy one such last-bit difference can put a gradient
  element on the other side of a rounding boundary, so that it is sent
  one quantum (its block's amax / 127 or / 7) away from the reference's
  and every later AdamW step of that element differs: losses rtol 1e-4
  and every element within ``QUANT_ATOL`` = 5e-4, a twentieth of one
  AdamW step (lr 1e-2): an element that took one wrong step fails, one
  sent a neighbouring quantum does not (3.2e-4 at most here). Residual
  rows atol 5e-3 (one int4 quantum of the largest gradients here, the DP
  test's bound).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed import compressed as ref_c
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.distributed.mesh import set_axis_links as ref_set_axis_links
from paddle_tpu.text.models import GPTForPretraining as RefGPT

import torch_zero_worker as worker
from paddle_tpu_torch.distributed.meta_parallel.sharding_parallel import \
    spec_dim
from paddle_tpu_torch.distributed.spawn import spawn
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=420)

DEGREES = {2: {"sharding": 2}, 4: {"data": 2, "sharding": 2}}
STEPS = 5
GPT_CFG = dict(tensor_parallel=False, vocab_size=512, hidden_size=64,
               num_layers=2, num_heads=2, max_position_embeddings=128,
               attn_dropout=0.0, hidden_dropout=0.0)
GPT_LR, GPT_STEPS, GPT_CHUNK = 3e-4, 3, 256


def _mlp_net():
    paddle.seed(0)
    return rnn.Sequential(rnn.Linear(16, 64), rnn.ReLU(),
                          rnn.Linear(64, 64), rnn.ReLU(), rnn.Linear(64, 4))


def _mlp_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 16).astype("float32"),
            rng.randint(0, 4, (8,)).astype("int64"))


def _mlp_cases():
    c = {"fp32-s0": dict(stage=0, k=1, policy="fp32"),
         "fp32-s1": dict(stage=1, k=1, policy="fp32"),
         "fp32-s3": dict(stage=3, k=1, policy="fp32"),
         "fp32-s0-k2": dict(stage=0, k=2, policy="fp32"),
         "fp32-s2-k2": dict(stage=2, k=2, policy="fp32"),
         "int8-s2": dict(stage=2, k=1, policy="int8", block=64),
         "int4-s2": dict(stage=2, k=1, policy="int4", block=64),
         "int8-s3": dict(stage=3, k=1, policy="int8", block=64),
         # plain leaves in 2 buckets issued inside the backward, beside the
         # stage-2 reduce-scatters
         "int8-s2-b2": dict(stage=2, k=1, policy="int8", block=64,
                            buckets=2),
         # loss scaling: the sliced gradients are unscaled before their
         # reduce-scatter, the finite flag is reduced over sharding
         "fp32-s3-amp": dict(stage=3, k=1, policy="fp32", scale=2.0 ** 10),
         # DCN gating: the quantized sharding hop only where "sharding"
         # crosses hosts; otherwise the zero-2 reduce-scatter stays fp32
         "int8-s2-dcn-sharding": dict(stage=2, k=1, policy="int8", block=64,
                                      dcn_only=True,
                                      links={"sharding": "dcn"}),
         "int8-s2-dcn-data": dict(stage=2, k=1, policy="int8", block=64,
                                  dcn_only=True, links={"data": "dcn"}),
         # the clips' norms over the slices: the global norm at stage 2,
         # each leaf's own norm at stage 3
         "fp32-s0-clip": dict(stage=0, k=1, policy="fp32",
                              clip=("global", 0.05)),
         "fp32-s2-clip": dict(stage=2, k=1, policy="fp32",
                              clip=("global", 0.05)),
         "fp32-s0-clipnorm": dict(stage=0, k=1, policy="fp32",
                                  clip=("norm", 0.02)),
         "fp32-s3-clipnorm": dict(stage=3, k=1, policy="fp32",
                                  clip=("norm", 0.02))}
    for v in c.values():
        v["steps"] = STEPS
    c["check-clean"] = dict(stage=2, k=1, policy="int8", block=64, steps=3,
                            check=1)
    c["check-flip"] = dict(stage=2, k=1, policy="int8", block=64, steps=3,
                           check=1, flip_at=1, flip_leaf="4.bias")
    return c


def _rs_cases(n):
    rs = np.random.RandomState(10 + n)
    out = {}
    for dim in (0, 1):
        x = (rs.randn(n, 8, 300) * 3).astype(np.float32)
        out[f"lossless-d{dim}"] = dict(x=x, dim=dim, policy="lossless")
        for pol in ("int8", "int4"):
            out[f"{pol}-d{dim}"] = dict(
                x=(rs.randn(n, 8, 300) * 3).astype(np.float32),
                res=(rs.randn(n, 8, 300) * 0.01).astype(np.float32),
                dim=dim, policy=pol, block=64)
    return out


def _gpt_batch():
    rs = np.random.RandomState(5)
    return (rs.randint(0, 512, (4, 128)).astype(np.int32),
            rs.randint(0, 512, (4, 128)).astype(np.int32))


def _ref_gpt_model():
    paddle.seed(0)
    return RefGPT(**GPT_CFG)


_RUNS = {}


def _run(n, tmp_path_factory):
    if n in _RUNS:
        return _RUNS[n]
    d = tmp_path_factory.mktemp(f"zero{n}")
    plan = {"degrees": DEGREES[n], "rs": _rs_cases(n), "mlp": _mlp_cases(),
            "mlp_weights": {k: np.asarray(v) for k, v in
                            _mlp_net().state_dict().items()},
            "mlp_batch": _mlp_batch()}
    if n == 2:
        plan.update(gpt={"int8-s3": dict(stage=3, policy="int8",
                                         steps=GPT_STEPS)},
                    gpt_cfg=GPT_CFG, gpt_chunk=GPT_CHUNK, gpt_lr=GPT_LR,
                    gpt_batch=_gpt_batch(),
                    gpt_weights={k: np.asarray(v) for k, v in
                                 _ref_gpt_model().state_dict().items()})
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(worker.main, args=(str(d / "plan.pkl"), str(d)), nprocs=n,
          timeout=300)
    ranks = []
    for r in range(n):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    _RUNS[n] = (plan, ranks)
    return _RUNS[n]


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


_REF = {}


def _ref_mlp(name, case, n):
    if (name, n) in _REF:
        return _REF[name, n]
    mesh = ref_build_mesh(DEGREES[n])
    if case.get("links"):
        ref_set_axis_links(case["links"], mesh=mesh)
    net = _mlp_net()
    clip = None
    if case.get("clip"):
        kind, norm = case["clip"]
        clip = (rnn.ClipGradByGlobalNorm if kind == "global" else
                rnn.ClipGradByNorm)(norm)
    opt = paddle.optimizer.AdamW(worker.MLP_LR, parameters=net.parameters(),
                                 grad_clip=clip)
    scaler = (paddle.amp.GradScaler(init_loss_scaling=case["scale"])
              if case.get("scale") else None)
    tr = RefTrainer(net, opt,
                    lambda o, y: rnn.functional.cross_entropy(o, y),
                    mesh=mesh, zero_stage=case["stage"],
                    accumulate_steps=case["k"], grad_sync=case["policy"],
                    grad_sync_block=case.get("block"),
                    grad_sync_buckets=case.get("buckets", 1),
                    grad_sync_dcn_only=case.get("dcn_only"), scaler=scaler)
    X, Y = _mlp_batch()
    losses = [float(tr.train_step(X, Y)) for _ in range(case["steps"])]
    p = tr.state["params"]["2.weight"]
    out = {"losses": losses,
           "params": {k: np.asarray(v) for k, v in
                      tr.state["params"].items()},
           "slots": {k: {s: np.asarray(v) for s, v in d.items()}
                     for k, d in tr.state["opt"]["slots"].items()},
           "comm_err": {k: np.asarray(v) for k, v in
                        tr.state["comm_err"].items()},
           "zero2_dims": dict(tr.zero2_dims),
           "zero3_dims": dict(tr.zero3_dims),
           "slot_dims": {k: {s: spec_dim(tuple(sp)) for s, sp in d.items()}
                         for k, d in tr.opt_specs["slots"].items()},
           "stored": p.addressable_shards[0].data.size,
           "buckets": tr.grad_sync_bucket_keys,
           "loss_scale": (float(tr.state["guard"]["amp"]["scale"])
                          if "amp" in tr.state["guard"] else None)}
    _REF[name, n] = out
    return out


FP32_ATOL = 2e-6
QUANT_ATOL = 5e-4


def _close(got, want, atol, *what):
    """Every element within ``atol`` (module docstring)."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= atol, (what, diff.max())


def _sum_order_close(got, want, rows, n, *what):
    """Two means of ``n`` float32 rows added in other orders differ by at
    most 2 (n - 1) u sum|x| / n, u = 2**-24."""
    bound = 2 * (n - 1) * 2.0 ** -24 * np.abs(rows).sum(axis=0) / n
    assert np.all(np.abs(np.asarray(got) - want) <= bound), what


def _ref_rs(case, n):
    mesh = ref_build_mesh(DEGREES[n])
    axes = ("data", "sharding") if n == 4 else ("sharding",)
    spec = P(axes)
    x = jnp.asarray(case["x"])

    if case["policy"] == "lossless":
        def f(xx):
            return lax.psum_scatter(xx[0], "sharding",
                                    scatter_dimension=case["dim"],
                                    tiled=True)[None]
        fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,),
                                   out_specs=spec, check_vma=False))
        return np.asarray(fn(x)), None

    def g(xx, rr):
        out, res = ref_c.compressed_psum_scatter(
            xx[0], "sharding", scatter_dim=case["dim"],
            policy=case["policy"], block=case["block"], residual=rr[0])
        return out[None], res[None]
    fn = jax.jit(jax.shard_map(g, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False))
    out, res = fn(x, jnp.asarray(case["res"]))
    return np.asarray(out), np.asarray(res)


def test_psum_scatter_matches_the_reference(world):
    n, (plan, ranks) = world
    for name, case in plan["rs"].items():
        want, want_res = _ref_rs(case, n)
        for r, out in enumerate(ranks):
            got, res = out["rs"][name]
            np.testing.assert_array_equal(got, want[r], err_msg=name)
            if want_res is None:
                continue
            x = case["x"][r] + case["res"][r]
            bound = 2.0 ** -24 * (np.abs(x) + np.abs(want_res[r]))
            assert np.all(np.abs(res - want_res[r]) <= bound), name


def test_mesh_coordinates_are_the_reference_reshape(world):
    n, (plan, ranks) = world
    dims = [plan["degrees"].get(a, 1) for a in
            ("data", "pipe", "sharding", "sep", "model")]
    for r, out in enumerate(ranks):
        want = np.unravel_index(r, dims)
        assert [out["coord"][a] for a in ("data", "pipe", "sharding", "sep",
                                          "model")] == list(want)


@pytest.mark.parametrize("name", [k for k in _mlp_cases()
                                  if not k.startswith("check")])
def test_zero_mlp_matches_the_reference(world, name):
    n, (plan, ranks) = world
    case = plan["mlp"][name]
    want = _ref_mlp(name, case, n)
    for r, out in enumerate(ranks):
        got = out["mlp"][name]
        assert got["skipped"] == 0
        assert got["buckets"] == want["buckets"], name
        assert got["loss_scale"] == want["loss_scale"], name
        assert got["zero2_dims"] == want["zero2_dims"], name
        assert got["zero3_dims"] == want["zero3_dims"], name
        assert got["slot_dims"] == want["slot_dims"], name
        fp32 = case["policy"] == "fp32"
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-6 if fp32 else 1e-4, err_msg=name)
        for k, w in want["params"].items():
            _close(got["params"][k], w, FP32_ATOL if fp32 else QUANT_ATOL,
                   name, k)
        assert set(got["comm_err"]) == set(want["comm_err"]), name
        for k, w in want["comm_err"].items():
            assert w.shape[0] == n
            np.testing.assert_allclose(got["comm_err"][k], w[r], atol=5e-3,
                                       err_msg=(name, k))
        if case["policy"] != "fp32":
            continue
        # this rank's slot slices are its chunk of the reference's slots;
        # the moving averages carry the gradients' last-bit differences,
        # within the losses' rtol
        for k, dims in got["slot_dims"].items():
            for s, d in dims.items():
                w = want["slots"][k][s]
                if d is not None:
                    w = np.split(w, plan["degrees"]["sharding"],
                                 axis=d)[out["coord"]["sharding"]]
                np.testing.assert_allclose(got["slots"][k][s], w, rtol=1e-4,
                                           atol=1e-7, err_msg=(name, k, s))
    # every rank holds the same logical parameters
    for out in ranks[1:]:
        for k, v in out["mlp"][name]["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["mlp"][name]["params"][k])


def _chunk(x, out, k, dims, n_shard, lead=0):
    """This rank's chunk of leaf ``k`` where ``dims`` splits it (``lead``
    leading dims of rows first)."""
    if k not in dims:
        return x
    return np.split(x, n_shard, axis=dims[k] + lead)[
        out["coord"]["sharding"]]


STAGE_PAIRS = [("fp32-s1", "fp32-s0"), ("fp32-s3", "fp32-s0"),
               ("fp32-s2-k2", "fp32-s0-k2"), ("fp32-s2-clip", "fp32-s0-clip"),
               ("fp32-s3-clipnorm", "fp32-s0-clipnorm")]


@pytest.mark.parametrize("name,base", STAGE_PAIRS)
def test_zero_stages_against_stage_0(world, name, base):
    n, (plan, ranks) = world
    n_shard = plan["degrees"]["sharding"]
    rows = {k: np.stack([out["rows"][k] for out in ranks])
            for k in ranks[0]["rows"]}
    for out in ranks:
        got, ref = out["mlp"][name], out["mlp"][base]
        ud = got["update_dims"]
        exact_grads = n == 2 or name == "fp32-s1"
        exact = exact_grads and "clip" not in name
        # the step-1 gradients the optimizer got: this rank's slices of
        # stage 0's exchanged means (a whole leaf where nothing splits)
        assert set(got["first_grads"]) == set(ref["first_grads"])
        for k, g in got["first_grads"].items():
            want = _chunk(ref["first_grads"][k], out, k, ud, n_shard)
            if exact_grads:
                np.testing.assert_array_equal(g, want, err_msg=(name, k))
            elif base.endswith("-k2"):
                continue    # two micro-batches a step: no single rows
            else:
                r = _chunk(rows[k], out, k, ud, n_shard, lead=1)
                _sum_order_close(g, want, r, n, name, k)
        if exact:
            assert got["losses"] == ref["losses"], name
            for k, v in ref["params"].items():
                np.testing.assert_array_equal(got["params"][k], v,
                                              err_msg=(name, k))
            # each slot slice is this rank's chunk of stage 0's whole slot
            for k, dims in got["slot_dims"].items():
                for s, d in dims.items():
                    w = ref["slots"][k][s]
                    if d is not None:
                        w = np.split(w, n_shard,
                                     axis=d)[out["coord"]["sharding"]]
                    np.testing.assert_array_equal(got["slots"][k][s], w)
        else:
            np.testing.assert_allclose(got["losses"], ref["losses"],
                                       rtol=1e-6)
            for k, v in ref["params"].items():
                _close(got["params"][k], v, FP32_ATOL, name, k)


def test_sharded_storage_is_one_nth(world):
    n, (plan, ranks) = world
    n_shard = plan["degrees"]["sharding"]
    for out in ranks:
        got = out["mlp"]["fp32-s3"]
        want = _ref_mlp("fp32-s3", plan["mlp"]["fp32-s3"], n)
        assert set(got["zero3_dims"]) == {"0.weight", "2.weight"}
        for k in got["full"]:
            if k in got["zero3_dims"]:
                assert got["storage"][k] * n_shard == got["full"][k]
                assert got["resident"][k] == 0     # the model's copy freed
            else:
                assert got["storage"][k] == got["full"][k]
        assert want["stored"] * n_shard == got["full"]["2.weight"]
        # stage 3 under int8: the lossless scatter carries no residual
        q = out["mlp"]["int8-s3"]
        assert not set(q["comm_err"]) & set(q["zero3_dims"])
        assert set(q["comm_err"]) == {"0.bias", "2.bias", "4.bias",
                                      "4.weight"}


def test_replica_check_under_zero(world):
    n, (plan, ranks) = world
    for out in ranks:
        clean = out["mlp"]["check-clean"]
        assert clean["divergence"] == [[], [], []]
        kinds = dict(clean["entries"])
        assert kinds["params['4.bias']"] == ()
        assert kinds["opt['slots']['2.weight']['m']"] == ("sharding",)
        flip = out["mlp"]["check-flip"]
        assert flip["flip"]["leaf"] == "4.bias"
        assert flip["divergence"][1] == ["params['4.bias']"]


def test_gpt_stage3_int8_matches_the_reference(tmp_path_factory):
    n = 2
    plan, ranks = _run(n, tmp_path_factory)
    model = _ref_gpt_model()

    class Loss(rnn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, chunk=GPT_CHUNK,
                                              ce_kernel="chunked")

    opt = paddle.optimizer.AdamW(GPT_LR, weight_decay=0.01,
                                 apply_decay_param_fun=worker.no_decay,
                                 parameters=model.parameters())
    tr = RefTrainer(Loss(model), opt, lambda out, _l: out,
                    mesh=ref_build_mesh(DEGREES[n]), zero_stage=3,
                    grad_sync="int8")
    batch = _gpt_batch()
    losses = [float(tr.train_step(batch, 0.0)) for _ in range(GPT_STEPS)]
    heads = GPT_CFG["num_heads"]
    hd = GPT_CFG["hidden_size"] // heads
    for out in ranks:
        got = out["gpt"]["int8-s3"]
        assert got["skipped"] == 0
        assert got["zero3_dims"] == dict(tr.zero3_dims)
        assert set(got["comm_err"]) == set(tr.state["comm_err"])
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        assert got["losses"][-1] < got["losses"][0]
        # the module docstring's quantized bound, scaled to this lr
        atol = QUANT_ATOL * GPT_LR / worker.MLP_LR
        for k, v in tr.state["params"].items():
            g, w = got["params"][k], np.asarray(v)
            if k.endswith("attn.qkv_proj.bias"):
                g = g.reshape(heads, 3, hd)[:, [0, 2]]
                w = w.reshape(heads, 3, hd)[:, [0, 2]]
            _close(g, w, atol, k)
