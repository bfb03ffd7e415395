"""Experts, the sharded lookup and LocalSGD over a world of four cards:
NCCL, one process a card.

    python3 tests/torch_ep_cards.py          # a host with four cards
    python3 tests/torch_ep_cards.py --cpu    # rehearsal: four gloo ranks,
                                             # narrow shapes

Three runs, each on a fresh mesh of the four ranks:

- ``moe``: ``MoELayer(768, 3072, num_experts=8)`` at ``{"model": 4}``
  (two experts a card), bfloat16, built with ``split_tokens=True``, each
  card its own 8 x 1024 tokens; against the same weights with every
  expert local on each card's tokens (the layer built without a mesh):
  each card's output and input gradient, and the experts' gradients
  against the local layers' summed over the cards (an all-reduce), in
  relative L2 within ``MOE_REL_L2`` (bf16: the experts' GEMMs run on
  other row counts); then the default route, every card the same tokens
  (card 0's), against the local layer on them, the experts' gradients
  against the local layer's own slice; the expert bytes a card (a
  quarter of the whole), forward and forward+backward ms of both routes,
  and the bytes a card sends in the ``all_to_all``s and all-gathers;
- ``lookup``: ``alltoall_lookup`` at ``{"data": 4}`` on heter_ctr's table
  (26 fields x 100,000 rows x 16 float32, row-sharded, each card 650,000
  rows), each card's 4096 x 26 ids drawn ``zipf(1.3)`` (bench.py's
  ``draw_ids``, offset by field); a cap that holds every id and one an
  eighth of that, which overflows: the forward bit for bit the dense
  gather, the gradient of the card's table slice within rtol 1e-5 of
  the dense gather's (the CPU tests' bar); ms of a lookup, forward and
  forward+backward, and a profile of one forward+backward (collectives,
  their device time, the other kernels' and the wall);
- ``localsgd``, first GPT-base in float32 (TF32 off), dense logits and
  ``cross_entropy``, ``Momentum(LOCALSGD_LR, 0.9)``, 8 rows a card (a
  global batch of 32 x 1024), at ``{"data": 4}``, 4 steps each of the
  data-parallel ``ParallelTrainer``, k 1 with an fp32 sync, and k past
  the run (never synced, the control): the parameters' update from the
  initial weights, all leaves together, of k 1 against the data-parallel
  one in relative L2 within a bar of float32 rounding (``LOCALSGD_ULPS``),
  and the control's gap ``LOCALSGD_SEPARATION`` times that bar or more (a
  trainer that never synced, or never updated, fails); k 4 with an int8 sync over 8
  steps: after a local step the replicas of three leaves differ by at
  least ``LOCALSGD_APART`` of that leaf's update since the last sync, and
  after each sync they are equal bit for bit. Then bench's dtype,
  bfloat16, for the times: data-parallel and k 4 int8 steps, the
  ``_sync`` call alone, the wire bytes of a sync, and a profile of one
  sync step and one local step.

Any failed check exits non-zero. Prints one JSON object per line; the
last is ``{"ok": true, ...}``. Imports torch, numpy and
``paddle_tpu_torch`` only.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

MOE_REL_L2 = 1e-2
LOOKUP_RTOL = 1e-5
LOCALSGD_LR = 1e-2
# float32: k 1 averages four parameter copies where data parallelism
# averages four gradients, the same local gradients either way, so the
# two differ only by rounding: a step rounds each replica's new parameter
# (half an ulp), the three additions of the mean (an ulp and a half) and
# data parallelism's own update (half an ulp). The bar on k 1's update
# gap is that bound summed over the steps, LOCALSGD_ULPS * steps *
# |ulp(p)| / |update| over all leaves (its value is printed); a trainer
# that never syncs is off by order 1 (the --cpu rehearsal: 1.3-1.6)
LOCALSGD_ULPS = 2.5
LOCALSGD_SEPARATION = 10.0
LOCALSGD_APART = 1e-2


def shapes(cpu):
    if cpu:
        return dict(d_model=64, d_hidden=128, tokens=(2, 64), fields=4,
                    rows=500, dim=16, batch=64, gpt=dict(
                        vocab_size=512, hidden_size=64, num_layers=2,
                        num_heads=4, max_position_embeddings=128))
    return dict(d_model=768, d_hidden=3072, tokens=(8, 1024), fields=26,
                rows=100_000, dim=16, batch=4096, gpt=dict(
                    vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _timed(fn, sync, reps=5):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def _profiled(fn, sync, cpu):
    """One call of ``fn`` under torch.profiler: wall ms, collective kernels
    (count, device ms), other kernels (count, device ms), and the host's
    collective calls by name."""
    if cpu:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    comm = [0, 0.0]
    other = [0, 0.0]
    calls = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            slot = comm if "nccl" in e.name.lower() else other
            slot[0] += 1
            slot[1] += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name.startswith(("nccl:", "c10d::")):
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"wall_ms": wall, "comm_kernels": comm[0], "comm_ms": comm[1],
            "other_kernels": other[0], "other_ms": other[1],
            "host_collectives": calls}


def run_moe(cfg, rank, device, sync):
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.incubate import MoELayer
    d, h = cfg["d_model"], cfg["d_hidden"]
    rs = np.random.RandomState(0)
    state = {"gate.weight": rs.randn(d, 8) / np.sqrt(d),
             "w1": rs.randn(8, d, h) / np.sqrt(d), "b1": 0.1 * rs.randn(8, h),
             "w2": rs.randn(8, h, d) / np.sqrt(h), "b2": 0.1 * rs.randn(8, d)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    tok = np.random.RandomState(10 + rank)
    x = torch.from_numpy(tok.randn(*cfg["tokens"], d).astype(
        np.float32)).to(device, torch.bfloat16)
    r = torch.from_numpy(tok.randn(*cfg["tokens"], d).astype(
        np.float32)).to(device, torch.bfloat16)
    tok0 = np.random.RandomState(10)         # card 0's tokens, everywhere
    x0, r0 = (torch.from_numpy(tok0.randn(*cfg["tokens"], d).astype(
        np.float32)).to(device, torch.bfloat16) for _ in range(2))
    mesh = mesh_mod.build_mesh({"model": 4})
    ep = MoELayer(d, h, num_experts=8, split_tokens=True)
    ep.set_state_dict_from_numpy(state, mesh)
    rep = MoELayer(d, h, num_experts=8)
    rep.set_state_dict_from_numpy(state, mesh)
    mesh_mod.set_mesh(None)
    local = MoELayer(d, h, num_experts=8)
    local.set_state_dict_from_numpy(state)
    mesh_mod.set_mesh(mesh)
    ep, local = ep.to(device).bfloat16(), local.to(device).bfloat16()
    rep = rep.to(device).bfloat16()

    def fwd_bwd(layer, tokens=x, cot=r):
        xx = tokens.detach().requires_grad_(True)
        y = layer(xx)
        g = torch.autograd.grad((y * cot).sum(),
                                [xx] + list(layer.parameters()))
        return y.detach(), dict(zip(["x"] + [n for n, _ in
                                             layer.named_parameters()], g))

    y_ep, g_ep = fwd_bwd(ep)
    y_loc, g_loc = fwd_bwd(local)
    errs = {"out": _rel_l2(y_ep, y_loc), "grad_x": _rel_l2(g_ep["x"],
                                                           g_loc["x"]),
            "grad_gate": _rel_l2(g_ep["gate.weight"], g_loc["gate.weight"])}
    e = 8 // 4
    for k in ("w1", "b1", "w2", "b2"):
        whole = g_loc[k].float().contiguous()
        dist.all_reduce(whole)           # the experts' sum over the cards
        errs[f"grad_{k}"] = _rel_l2(g_ep[k], whole[rank * e:(rank + 1) * e])
    # the default route: every card the same tokens, each gradient the
    # single layer's
    y_rep, g_rep = fwd_bwd(rep, x0, r0)
    y_l0, g_l0 = fwd_bwd(local, x0, r0)
    rep_errs = {"out": _rel_l2(y_rep, y_l0),
                "grad_x": _rel_l2(g_rep["x"], g_l0["x"]),
                "grad_gate": _rel_l2(g_rep["gate.weight"],
                                     g_l0["gate.weight"])}
    for k in ("w1", "b1", "w2", "b2"):
        rep_errs[f"grad_{k}"] = _rel_l2(
            g_rep[k], g_l0[k][rank * e:(rank + 1) * e])
    expert_bytes = sum(p.numel() * p.element_size() for n, p in
                       ep.named_parameters() if n != "gate.weight")
    whole_bytes = sum(p.numel() * p.element_size() for n, p in
                      local.named_parameters() if n != "gate.weight")
    cap = ep.capacity(cfg["tokens"][0] * cfg["tokens"][1])
    # one tiled all_to_all (or all-gather) moves (n-1)/n of an (E, C, D)
    # bf16 buffer a card: the split route two of them in the forward and
    # two in the backward, the default route one all-gather in each
    a2a = 8 * cap * d * 2 * 3 / 4
    with torch.no_grad():
        fwd_ms = _timed(lambda: ep(x), sync)
        local_fwd_ms = _timed(lambda: local(x), sync)
    with torch.no_grad():
        rep_fwd_ms = _timed(lambda: rep(x0), sync)
    return {"rel_l2": errs, "replicated_rel_l2": rep_errs,
            "expert_bytes": expert_bytes,
            "whole_expert_bytes": whole_bytes, "capacity": cap,
            "all_to_all_bytes_fwd": 2 * a2a, "all_to_all_bytes_bwd": 2 * a2a,
            "all_gather_bytes_fwd": a2a, "all_gather_bytes_bwd": a2a,
            "fwd_ms": fwd_ms, "fwd_bwd_ms": _timed(lambda: fwd_bwd(ep), sync),
            "local_fwd_ms": local_fwd_ms,
            "local_fwd_bwd_ms": _timed(lambda: fwd_bwd(local), sync),
            "replicated_fwd_ms": rep_fwd_ms,
            "replicated_fwd_bwd_ms": _timed(lambda: fwd_bwd(rep, x0, r0),
                                            sync),
            "aux_loss": float(ep.aux_loss.detach())}


def run_lookup(cfg, rank, device, sync):
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops.sharded_embedding import alltoall_lookup
    mesh = mesh_mod.build_mesh({"data": 4})
    f, rows, dim, b = cfg["fields"], cfg["rows"], cfg["dim"], cfg["batch"]
    table = torch.from_numpy(np.random.RandomState(0).randn(
        f * rows, dim).astype(np.float32)).to(device)
    rps = f * rows // 4
    all_ids, all_coef = [], []
    for r in range(4):
        rs = np.random.RandomState(100 + r)
        u = rs.zipf(1.3, size=(b, f))
        ids = ((u % rows) + np.arange(f)[None, :] * rows).reshape(-1)
        all_ids.append(torch.from_numpy(ids.astype(np.int64)).to(device))
        all_coef.append(torch.from_numpy(rs.randn(ids.size, 1).astype(
            np.float32)).to(device))
    ids, coef = all_ids[rank], all_coef[rank]
    n = ids.numel()
    want_grad = torch.zeros_like(table)
    for i, c in zip(all_ids, all_coef):
        want_grad.index_add_(0, i, c.expand(-1, dim))
    want_grad = want_grad[rank * rps:(rank + 1) * rps]
    local = table[rank * rps:(rank + 1) * rps].contiguous()
    owners = torch.bincount(ids // rps, minlength=4)
    out = {"ids": n, "rows_per_card": rps,
           "ids_by_owner": owners.tolist()}
    for name, cap in (("fits", n), ("overflows", n // 8)):
        t = local.clone().requires_grad_(True)
        got = alltoall_lookup(t, ids, "data", cap, rps)
        (g,) = torch.autograd.grad((got * coef).sum(), [t])

        def both():
            tt = local.detach().requires_grad_(True)
            torch.autograd.grad((alltoall_lookup(tt, ids, "data", cap, rps)
                                 * coef).sum(), [tt])

        with torch.no_grad():
            fwd = _timed(lambda: alltoall_lookup(local, ids, "data", cap,
                                                 rps), sync)
        # checked in the parent: a rank that raised here would leave the
        # others waiting in their next collective
        out[name] = {"cap": cap, "overflow_ids": int(
            torch.clamp(owners - cap, min=0).sum()), "fwd_ms": fwd,
            "fwd_bwd_ms": _timed(both, sync),
            "equals_dense_gather": bool(torch.equal(got, table[ids])),
            "grad_within_bar": bool(torch.allclose(
                g, want_grad, rtol=LOOKUP_RTOL,
                atol=LOOKUP_RTOL * float(want_grad.abs().max()))),
            "grad_max_abs_err": float((g - want_grad).abs().max()),
            "profile_fwd_bwd": _profiled(both, sync, device.type == "cpu")}
    out["dense_gather_ms"] = _timed(lambda: table[ids], sync)
    return out


def _flat(tr):
    return torch.cat([p.detach().reshape(-1).float()
                      for p in tr.params.values()])


def run_localsgd(cfg, rank, device, sync, steps=8):
    from paddle_tpu_torch import framework, nn, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.distributed.meta_parallel import LocalSGDTrainer
    from paddle_tpu_torch.text.models import GPTForPretraining
    g = cfg["gpt"]
    seq = g["max_position_embeddings"]
    rs = np.random.RandomState(0)
    ids, lbl = (torch.from_numpy(rs.randint(0, g["vocab_size"], (32, seq))
                                 .astype(np.int32)).to(device)
                for _ in range(2))
    cpu = device.type == "cpu"

    def model(bf16):
        framework.seed(0)
        m = GPTForPretraining(tensor_parallel=False, attn_dropout=0.0,
                              hidden_dropout=0.0, **g)
        return m.bfloat16() if bf16 else m

    def ce(logits, y):
        return nn.functional.cross_entropy(logits, y)

    def trainer(bf16, **kw):
        m, mesh = model(bf16), build_mesh({"data": 4})
        opt = optimizer.Momentum(LOCALSGD_LR, momentum=0.9)
        if kw:
            return LocalSGDTrainer(m, opt, ce, mesh=mesh, device=device,
                                   **kw)
        return ParallelTrainer(m, opt, ce, mesh=mesh, device=device)

    def steps_of(tr, n):
        losses, ms = [], []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            losses.append(tr.train_step(ids, lbl).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    leaves = ("gpt.h.0.ln_1.weight", "gpt.h.11.mlp.fc_out.bias"
              if g["num_layers"] == 12 else "gpt.h.1.mlp.fc_out.bias",
              "gpt.h.0.attn.qkv_proj.weight")
    out = {}
    # float32: the checks
    tr = trainer(False)
    p0 = _flat(tr)
    out["f32_dp_losses"], _ = steps_of(tr, 4)
    u_dp = _flat(tr) - p0
    del tr
    p_dp = p0 + u_dp
    ulp = torch.ldexp(torch.ones_like(p_dp), torch.frexp(p_dp)[1] - 24)
    out["f32_k1_bar"] = float(LOCALSGD_ULPS * 4 * ulp.norm() / u_dp.norm())
    del p_dp, ulp
    for name, k in (("k1", 1), ("never", 10 ** 6)):
        tr = trainer(False, k_steps=k)
        out[f"f32_{name}_losses"], _ = steps_of(tr, 4)
        out[f"f32_{name}_update_gap"] = float(
            (_flat(tr) - p0 - u_dp).norm() / u_dp.norm())
        del tr
    out["f32_dp_update_rel"] = float(u_dp.norm() / p0.norm())
    del p0, u_dp
    tr = trainer(False, k_steps=4, param_sync="int8")
    base = {k: tr.replica_params(k)[0] for k in leaves}
    apart = []
    for step in range(1, steps + 1):
        tr.train_step(ids, lbl)
        reps = {k: tr.replica_params(k) for k in leaves}
        apart.append(min(
            float(np.abs(r - r[:1]).max()) /
            max(float(np.abs(r[0] - base[k]).max()), 1e-30)
            for k, r in reps.items()))
        if step % 4 == 0:
            base = {k: r[0] for k, r in reps.items()}
    out["f32_k4_int8_apart"] = apart
    del tr
    # bfloat16 (bench's dtype): the times
    tr = trainer(True)
    out["dp_losses"], out["dp_ms"] = steps_of(tr, 4)
    del tr
    k4 = trainer(True, k_steps=4, param_sync="int8")
    inner, sync_ms = k4._sync, []

    def timed_sync(*a):
        sync()
        t0 = time.perf_counter()
        res = inner(*a)
        sync()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    k4._sync = timed_sync
    losses, ms = steps_of(k4, steps)
    k4._sync = inner
    # one more round: a local step and a sync step, each profiled
    steps_of(k4, 2)
    prof = {"local": _profiled(lambda: k4.train_step(ids, lbl), sync, cpu),
            "sync": _profiled(lambda: k4.train_step(ids, lbl), sync, cpu)}
    out.update(k4_int8_losses=losses, k4_int8_ms=ms, k4_sync_call_ms=sync_ms,
               k4_profile=prof,
               k4_wire_bytes_per_sync=k4.sync_wire_bytes(),
               param_bytes=sum(p.numel() * p.element_size()
                               for p in k4.params.values()))
    return out


def rank_main(cpu, root, out_dir):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(device="cpu" if cpu else None)
    rank = env.get_rank()
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", env.get_local_rank())
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    cfg = shapes(cpu)
    out = {"rank": rank}
    for name, fn in (("moe", run_moe), ("lookup", run_lookup),
                     ("localsgd", run_localsgd)):
        if not cpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        out[name] = fn(cfg, rank, device, sync)
        out[name]["peak_gb"] = (0.0 if cpu else
                                torch.cuda.max_memory_allocated(device)
                                / 2 ** 30)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def main() -> int:
    cpu = "--cpu" in sys.argv
    sys.path.insert(0, ROOT)
    if not cpu:
        if torch.cuda.device_count() < 4:
            raise SystemExit("torch_ep_cards: needs four cards "
                             f"(found {torch.cuda.device_count()})")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(json.dumps({"cards": smi}), flush=True)
        from paddle_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build(["flash_attention"])   # once, for all ranks
        print(json.dumps({"build_seconds": time.perf_counter() - t0}),
              flush=True)
    from paddle_tpu_torch.distributed.spawn import spawn
    with tempfile.TemporaryDirectory(prefix="ep_cards_") as root:
        spawn(rank_main, args=(cpu, root, root), nprocs=4, timeout=1500)
        ranks = []
        for r in range(4):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))

    moe = [o["moe"] for o in ranks]
    print(json.dumps({"run": "moe", "degrees": {"model": 4},
                      "by_rank": moe}), flush=True)
    for o in moe:
        for route in ("rel_l2", "replicated_rel_l2"):
            for k, e in o[route].items():
                check(e <= MOE_REL_L2, f"moe {route} {k}: relative L2 {e}")
        check(o["expert_bytes"] * 4 == o["whole_expert_bytes"],
              f"moe: a card holds {o['expert_bytes']} expert bytes of "
              f"{o['whole_expert_bytes']}")

    lookup = [o["lookup"] for o in ranks]
    print(json.dumps({"run": "lookup", "degrees": {"data": 4},
                      "by_rank": lookup}), flush=True)
    for r, o in enumerate(lookup):
        for name in ("fits", "overflows"):
            check(o[name]["equals_dense_gather"],
                  f"lookup ({name}): rank {r} != the dense gather")
            check(o[name]["grad_within_bar"],
                  f"lookup ({name}): rank {r} gradient off the dense one")
    check(any(o["overflows"]["overflow_ids"] > 0 for o in lookup),
          "lookup: the small cap overflowed on no card")
    check(all(o["fits"]["overflow_ids"] == 0 for o in lookup),
          "lookup: the large cap overflowed")

    ls = [o["localsgd"] for o in ranks]
    base = ls[0]
    print(json.dumps({"run": "localsgd", "degrees": {"data": 4},
                      "rank0": base,
                      "k1_update_gap_by_rank": [o["f32_k1_update_gap"]
                                                for o in ls],
                      "k1_bar_by_rank": [o["f32_k1_bar"] for o in ls],
                      "never_update_gap_by_rank": [
                          o["f32_never_update_gap"] for o in ls],
                      "peak_gb_by_rank": [o["peak_gb"] for o in ls]}),
          flush=True)
    for o in ls:
        for key in ("f32_dp_losses", "f32_k1_losses", "dp_losses"):
            check(o[key] == base[key], f"localsgd: ranks disagree on {key}")
    for r, o in enumerate(ls):
        gap, bar = o["f32_k1_update_gap"], o["f32_k1_bar"]
        ctl = o["f32_never_update_gap"]
        check(gap <= bar, f"localsgd k1: rank {r}'s update {gap} off data "
              f"parallelism's, over the rounding bar {bar}")
        check(ctl >= LOCALSGD_SEPARATION * bar,
              f"localsgd: the never-synced control is only {ctl} off data "
              f"parallelism's update (bar {bar}): the check would not see it")
    for step, a in enumerate(base["f32_k4_int8_apart"], start=1):
        if step % 4 == 0:
            check(a == 0.0, f"localsgd k4: replicas differ after the sync "
                  f"at step {step} ({a})")
        else:
            check(a >= LOCALSGD_APART, f"localsgd k4: replicas only {a} of "
                  f"the update apart after local step {step}")
    check(all(np.isfinite(base["k4_int8_losses"])),
          f"localsgd k4 losses {base['k4_int8_losses']}")
    print(json.dumps({"ok": True, "device": "cpu" if cpu else
                      torch.cuda.get_device_name(0), "count": 4}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
