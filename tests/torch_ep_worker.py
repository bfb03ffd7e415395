"""One rank of the port's expert, lookup, LocalSGD and SyncBatchNorm tests
(``test_torch_moe.py``, ``test_torch_sharded_embedding.py``,
``test_torch_localsgd.py``, ``test_torch_conv_pool_norm.py``).

``spawn``ed once per world size and test file, gloo on the CPU; imports
torch and ``paddle_tpu_torch`` only. The inputs and weights come from the
numpy functions below, which the tests call too for the reference's side.
Each rank runs the kinds its file asks for and pickles what it got to
``<out>/rank<r>.pkl``:

- ``syncbn``: ``SyncBatchNorm`` at ``{"data": n}`` on this rank's slice of
  the batch: output, input and parameter gradients of ``sum(out * r)``,
  the running statistics;
- ``bnstats``: ``ParallelTrainer`` at ``{"data": n}`` on a batch norm
  (plain and sync) then a linear head: the running statistics after each
  step, one of them skipped by the NaN guard, and the eval-mode output;
- ``moe``: ``MoELayer`` at ``{"model": n}``, the tokens replicated over
  the axis and split over it: output, aux loss, gradients of the input and
  of this rank's parameters;
- ``moe_train``: ``ParallelTrainer`` at ``{"model": n}`` on an
  ``MoELayer`` and a linear head, with and without a global-norm clip:
  losses and this rank's parameters;
- ``lookup``: ``alltoall_lookup`` at ``{"data": n}`` for each bucket cap:
  the rows of this rank's ids and the gradient of its table slice;
- ``localsgd``: ``LocalSGDTrainer`` cases at ``{"data": n}`` (losses,
  every replica's weight after each step, k), and the port's
  ``ParallelTrainer`` on the same model as the data-parallel yardstick.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from torch_dp_worker import _np

# -- the shared inputs -------------------------------------------------------

SYNCBN_MOMENTUM = 0.8
MOE_CFG = dict(d_model=16, d_hidden=32, num_experts=8)
LOOKUP_ROWS, LOOKUP_DIM, LOOKUP_IDS = 64, 5, 16
LOOKUP_CAPS = (1, 3, 16)


def syncbn_data():
    rs = np.random.RandomState(0)
    x = (rs.randn(8, 3, 4, 4) * 2.0 + 0.5).astype(np.float32)
    r = rs.randn(8, 3, 4, 4).astype(np.float32)
    weights = {"weight": rs.randn(3).astype(np.float32),
               "bias": rs.randn(3).astype(np.float32),
               "_mean": np.zeros(3, np.float32),
               "_variance": np.ones(3, np.float32)}
    return x, r, weights


def moe_data():
    """Whole weights (random biases too), tokens (4, 8, 16) and the
    cotangent ``r``."""
    rs = np.random.RandomState(1)
    d, h, e = (MOE_CFG[k] for k in ("d_model", "d_hidden", "num_experts"))
    state = {"gate.weight": rs.randn(d, e).astype(np.float32),
             "w1": (rs.randn(e, d, h) / np.sqrt(d)).astype(np.float32),
             "b1": (0.1 * rs.randn(e, h)).astype(np.float32),
             "w2": (rs.randn(e, h, d) / np.sqrt(h)).astype(np.float32),
             "b2": (0.1 * rs.randn(e, d)).astype(np.float32)}
    x = rs.randn(4, 8, d).astype(np.float32)
    r = rs.randn(4, 8, d).astype(np.float32)
    return state, x, r


BNSTATS_STEPS = 4            # the third is skipped (grad_taint NaN)
MOE_TRAIN_CASES = {"momentum": dict(lr=0.1, clip=None),
                   "clip": dict(lr=0.1, clip=0.5)}
MOE_TRAIN_STEPS = 3


def moe_train_data():
    """The MoE model's whole weights (``moe.*`` as :func:`moe_data`'s, the
    head ``(16, 4)``), tokens (4, 8, 16) and labels (4,)."""
    state, x, _ = moe_data()
    rs = np.random.RandomState(3)
    state = {f"moe.{k}": v for k, v in state.items()}
    state["head.weight"] = (rs.randn(16, 4) / 4.0).astype(np.float32)
    state["head.bias"] = (0.1 * rs.randn(4)).astype(np.float32)
    return state, x, rs.randint(0, 4, (4,)).astype(np.int64)


def lookup_data(n):
    """The table, every rank's ids (n * 16, -1 padding among them,
    skewed so that small caps overflow) and the cotangent coefficients."""
    rs = np.random.RandomState(2)
    rows = rs.randn(LOOKUP_ROWS, LOOKUP_DIM).astype(np.float32)
    ids = rs.randint(-1, LOOKUP_ROWS, (LOOKUP_IDS * n,)).astype(np.int32)
    ids[::5] = 3          # one owner takes a fifth of every rank's ids
    coef = (1.0 + np.arange(LOOKUP_IDS * n, dtype=np.float32))[:, None]
    return rows, ids, coef


def localsgd_data():
    rs = np.random.RandomState(0)
    return rs.randn(16, 8).astype("f4"), rs.randn(16, 4).astype("f4")


def localsgd_weights(seed, hidden=False):
    """Linear(8, 4), or Linear(8, 16) -> Tanh -> Linear(16, 4): names as
    the reference's layers give them, (in, out) weights."""
    rs = np.random.RandomState(100 + seed)
    if not hidden:
        return {"weight": (rs.randn(8, 4) / np.sqrt(8)).astype("f4"),
                "bias": (0.1 * rs.randn(4)).astype("f4")}
    return {"0.weight": (rs.randn(8, 16) / np.sqrt(8)).astype("f4"),
            "0.bias": (0.1 * rs.randn(16)).astype("f4"),
            "2.weight": (rs.randn(16, 4) / np.sqrt(16)).astype("f4"),
            "2.bias": (0.1 * rs.randn(4)).astype("f4")}


# the reference's four cases (tests/test_localsgd_elastic.py:35-90) and
# the quantized param_sync
LOCALSGD_CASES = {
    "k1": dict(opt="sgd", lr=0.1, steps=5, k_steps=1, seed=0),
    "k4": dict(opt="sgd", lr=0.05, steps=8, k_steps=4, seed=1),
    "adaptive": dict(opt="sgd", lr=0.2, steps=30, adaptive=True,
                     init_k_steps=8, max_k_steps=16, seed=2, hidden=True),
    "adam": dict(opt="adam", lr=1e-2, steps=6, k_steps=2, seed=3),
    "int8": dict(opt="sgd", lr=0.05, steps=8, k_steps=4, seed=1,
                 param_sync="int8", param_sync_block=8),
    "int4": dict(opt="sgd", lr=0.05, steps=8, k_steps=4, seed=1,
                 param_sync="int4", param_sync_block=8),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the kinds ------------------------------------------------------------------

def run_syncbn(mesh_mod, n, rank):
    from paddle_tpu_torch import nn
    mesh_mod.build_mesh({"data": n})
    x, r, weights = syncbn_data()
    c = x.shape[0] // n
    layer = nn.SyncBatchNorm(3, momentum=SYNCBN_MOMENTUM)
    layer.set_state_dict_from_numpy(weights)
    xl = _t(x[rank * c:(rank + 1) * c]).requires_grad_(True)
    out = layer(xl)
    gx, gw, gb = torch.autograd.grad(
        (out * _t(r[rank * c:(rank + 1) * c])).sum(),
        [xl, layer.weight, layer.bias])
    return {"out": _np(out), "grad_x": _np(gx),
            "grads": {"weight": _np(gw), "bias": _np(gb)},
            "stats": {"_mean": _np(layer._mean),
                      "_variance": _np(layer._variance)}}


def _bn_net(sync):
    from paddle_tpu_torch import nn

    class BNNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = (nn.SyncBatchNorm if sync else nn.BatchNorm2D)(
                3, momentum=SYNCBN_MOMENTUM)
            self.fc = nn.Linear(48, 2)

        def forward(self, x):
            return self.fc(torch.flatten(self.bn(x), 1))

    return BNNet()


def run_bnstats(mesh_mod, n, rank):
    from paddle_tpu_torch import nn, optimizer as optim
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    x, _, weights = syncbn_data()
    y = (np.arange(x.shape[0]) % 2).astype(np.int64)
    out = {}
    for sync in (False, True):
        mesh = mesh_mod.build_mesh({"data": n})
        net = _bn_net(sync)
        net.bn.set_state_dict_from_numpy(weights)
        tr = ParallelTrainer(net, optim.SGD(0.1),
                             nn.functional.cross_entropy, mesh=mesh,
                             device="cpu")
        stats = []
        for step in range(BNSTATS_STEPS):
            tr.train_step(_t(x), _t(y),
                          grad_taint=float("nan") if step == 2 else None)
            stats.append({"_mean": _np(net.bn._mean),
                          "_variance": _np(net.bn._variance)})
        net.eval()
        with torch.no_grad():
            ev = net(_t(x))
        out["sync" if sync else "plain"] = {
            "stats": stats, "skipped": tr.skipped_steps(), "eval": _np(ev)}
    return out


def _moe_net():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate import MoELayer

    class MoENet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = MoELayer(**MOE_CFG)
            self.head = nn.Linear(16, 4)

        def forward(self, x):
            return self.head(self.moe(x).mean(dim=1)), self.moe.aux_loss

    return MoENet()


def moe_train_loss(F):
    """cross entropy plus 0.01 aux loss, for either package's ``F``."""
    return lambda out, y: F.cross_entropy(out[0], y) + 0.01 * out[1]


def run_moe_train(mesh_mod, n, rank):
    from paddle_tpu_torch import nn, optimizer as optim
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    state, x, y = moe_train_data()
    out = {}
    for name, case in MOE_TRAIN_CASES.items():
        mesh = mesh_mod.build_mesh({"model": n})
        net = _moe_net()
        net.set_state_dict_from_numpy(state, mesh)
        clip = (optim.ClipGradByGlobalNorm(case["clip"]) if case["clip"]
                else None)
        tr = ParallelTrainer(net, optim.Momentum(case["lr"], momentum=0.9,
                                                 grad_clip=clip),
                             moe_train_loss(nn.functional), mesh=mesh,
                             device="cpu")
        losses = [float(tr.train_step(_t(x), _t(y)))
                  for _ in range(MOE_TRAIN_STEPS)]
        out[name] = {"losses": losses, "skipped": tr.skipped_steps(),
                     "params": {k: _np(p) for k, p in
                                net.named_parameters()}}
    # a layer that takes its own tokens on each rank: the trainer refuses it
    mesh = mesh_mod.build_mesh({"model": n})
    net = _moe_net()
    net.moe = type(net.moe)(**MOE_CFG, split_tokens=True)
    try:
        ParallelTrainer(net, optim.SGD(0.1), moe_train_loss(nn.functional),
                        mesh=mesh, device="cpu")
        out["split_tokens_raise"] = None
    except ValueError as e:
        out["split_tokens_raise"] = str(e)
    return out


def run_moe(mesh_mod, n, rank):
    from paddle_tpu_torch.incubate import MoELayer
    mesh = mesh_mod.build_mesh({"model": n})
    state, x, r = moe_data()
    out = {}
    for mode in ("replicated", "split"):
        layer = MoELayer(**MOE_CFG, split_tokens=mode == "split")
        layer.set_state_dict_from_numpy(state, mesh)
        if mode == "split":
            c = x.shape[0] // n
            xl, rl = x[rank * c:(rank + 1) * c], r[rank * c:(rank + 1) * c]
        else:
            xl, rl = x, r
        xt = _t(xl).requires_grad_(True)
        y = layer(xt)
        names = [k for k, _ in layer.named_parameters()]
        grads = torch.autograd.grad((y * _t(rl)).sum(),
                                    [xt] + list(layer.parameters()))
        out[mode] = {"out": _np(y), "aux": float(layer.aux_loss),
                     "grad_x": _np(grads[0]),
                     "grads": {k: _np(g) for k, g in zip(names, grads[1:])},
                     "shapes": {k: tuple(p.shape) for k, p in
                                layer.named_parameters()},
                     "pspec": tuple(layer.w1.pspec)}
    return out


def run_lookup(mesh_mod, n, rank):
    from paddle_tpu_torch.ops.sharded_embedding import alltoall_lookup
    mesh_mod.build_mesh({"data": n})
    rows, ids, coef = lookup_data(n)
    rps = LOOKUP_ROWS // n
    out = {}
    for cap in LOOKUP_CAPS:
        local = _t(rows[rank * rps:(rank + 1) * rps]).requires_grad_(True)
        ids_l = _t(ids[rank * LOOKUP_IDS:(rank + 1) * LOOKUP_IDS]).long()
        got = alltoall_lookup(local, ids_l, "data", cap, rps)
        coef_l = _t(coef[rank * LOOKUP_IDS:(rank + 1) * LOOKUP_IDS])
        (g,) = torch.autograd.grad((got * coef_l).sum(), [local])
        out[cap] = {"out": _np(got), "grad": _np(g)}
    return out


def _localsgd_model(hidden):
    from paddle_tpu_torch import nn
    if hidden:
        return nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    return nn.Linear(8, 4)


def _mse(o, y):
    return ((o - y) ** 2).mean()


def run_localsgd(mesh_mod, n, rank):
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.meta_parallel import LocalSGDTrainer
    x, y = localsgd_data()
    out = {}
    for name, case in LOCALSGD_CASES.items():
        mesh = mesh_mod.build_mesh({"data": n})
        model = _localsgd_model(case.get("hidden", False))
        model.set_state_dict_from_numpy(localsgd_weights(
            case["seed"], case.get("hidden", False)))
        opt = (optim.Adam(case["lr"]) if case["opt"] == "adam"
               else optim.SGD(case["lr"]))
        kw = {k: case[k] for k in ("k_steps", "adaptive", "init_k_steps",
                                   "max_k_steps", "param_sync",
                                   "param_sync_block") if k in case}
        tr = LocalSGDTrainer(model, opt, _mse, mesh=mesh, device="cpu", **kw)
        wkey = "0.weight" if case.get("hidden") else "weight"
        losses, reps, ks = [], [], []
        for _ in range(case["steps"]):
            losses.append(float(tr.train_step(x, y)))
            reps.append(tr.replica_params(wkey))
            ks.append(tr.k_steps)
        out[name] = {"losses": losses, "replicas": reps, "k": ks,
                     "wire_bytes": tr.sync_wire_bytes(),
                     "averaged": {k: _np(v) for k, v in
                                  tr.averaged_state_dict().items()}}
    # the data-parallel yardstick of k = 1
    mesh = mesh_mod.build_mesh({"data": n})
    model = _localsgd_model(False)
    model.set_state_dict_from_numpy(localsgd_weights(0))
    dp = ParallelTrainer(model, optim.SGD(0.1), _mse, mesh=mesh,
                         device="cpu")
    out["dp"] = {"losses": [float(dp.train_step(x, y)) for _ in range(5)],
                 "weight": _np(dp.get_param("weight"))}
    return out


RUNNERS = {"syncbn": run_syncbn, "bnstats": run_bnstats, "moe": run_moe,
           "moe_train": run_moe_train, "lookup": run_lookup,
           "localsgd": run_localsgd}


def main(plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, mesh as mesh_mod
    env.init_parallel_env(device="cpu")
    rank, n = env.get_rank(), env.get_world_size()
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    out = {"rank": rank}
    for kind in plan["kinds"]:
        out[kind] = RUNNERS[kind](mesh_mod, n, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


# -- the test side --------------------------------------------------------------

_RUNS = {}


def world(n, tmp_path_factory, kinds=("syncbn",), timeout=300):
    """Spawn ``n`` ranks running ``kinds`` (once per world and kinds in
    this process) and read back every rank's pickle, in rank order."""
    key = (n, tuple(kinds))
    if key not in _RUNS:
        from paddle_tpu_torch.distributed.spawn import spawn
        d = tmp_path_factory.mktemp(f"ep{n}")
        with open(d / "plan.pkl", "wb") as f:
            pickle.dump({"kinds": list(kinds)}, f)
        spawn(main, args=(str(d / "plan.pkl"), str(d)), nprocs=n,
              timeout=timeout)
        ranks = []
        for r in range(n):
            with open(d / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        _RUNS[key] = ranks
    return _RUNS[key]
