"""Tensor, pipeline and context parallelism over a world of four cards:
NCCL, one process a card.

    python3 tests/torch_hybrid_cards.py          # a host with four cards
    python3 tests/torch_hybrid_cards.py --cpu    # rehearsal: four gloo
                                                 # ranks, a narrow GPT

Each rank trains GPT-base (bf16, dropout 0, AdamW 3e-4, the loss through
``ParallelCrossEntropy``; on the CPU a 4-layer, width-64 GPT through the
kernels' plain versions) from one set of weights (seed 0) on a global
batch of 16 x 1024, 5 steps, in five runs:

- ``dp4``: ``{"data": 4}`` (the yardstick);
- ``tp4``: ``{"model": 4}``, ``GPTForPretraining(tensor_parallel=True)``;
- ``pp4-1f1b``: ``{"pipe": 4}``, ``gpt_pipeline_descs`` under 1F1B with
  M = 8 (3 blocks a stage);
- ``pp2-tp2-gpipe``: ``{"pipe": 2, "model": 2}``, the tensor-parallel
  descs under GPipe with M = 4; step 3 saved into one shared directory
  (the world's format), and a fresh trainer restores it and takes steps
  4-5;
- ``sep4``: ``{"sep": 4}``, ring attention over chunks of 256.

Checks (any failure exits non-zero): every run's losses finite, falling,
equal on every rank and within ``LOSS_RTOL`` of ``dp4``'s; the bytes of
parameters each rank stores equal the count the layout predicts
(:func:`predicted_param_bytes`, from GPT-base's widths); each rank's flash
launches a step; 1F1B's in-flight maximum ``S - s`` on stage ``s``; the
resumed steps equal the uninterrupted run's bit for bit. Reports per run
the step ms of steps 3-5 and each rank's peak allocated memory. Prints
one JSON object per line; the last is ``{"ok": true, ...}``. Imports
torch, numpy and ``paddle_tpu_torch`` only.
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

RUNS = (("dp4", {"data": 4}, None),
        ("tp4", {"model": 4}, None),
        ("pp4-1f1b", {"pipe": 4}, ("1f1b", 8)),
        ("pp2-tp2-gpipe", {"pipe": 2, "model": 2}, ("gpipe", 4)),
        ("sep4", {"sep": 4}, None))
# bf16 training through other layouts (split matmuls, the vocab-split
# cross entropy, micro-batch sums, the ring's merges): the gradients
# differ at bf16 precision and 5 steps carry it; chip_smoke.py's bar
LOSS_RTOL = 1e-2
GLOBAL_BATCH, STEPS, SAVE_AT = 16, 5, 3


def config(cpu):
    return (dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                 max_position_embeddings=128) if cpu else
            dict(vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=1024))


def predicted_param_bytes(cfg, degrees, bytes_per=2):
    """The parameter bytes one rank stores: GPT-base's leaves, the
    tensor-parallel ones (QKV and fc_in columns with their biases,
    out_proj and fc_out rows, the word embedding's vocab rows) divided
    by ``model``, the blocks by ``pipe``; the rest whole."""
    v, h, n = cfg["vocab_size"], cfg["hidden_size"], cfg["num_layers"]
    p = cfg["max_position_embeddings"]
    m, s = degrees.get("model", 1), degrees.get("pipe", 1)
    split = (h * 3 * h + 3 * h) + h * h + (h * 4 * h + 4 * h) + 4 * h * h
    whole = 2 * h + h + 2 * h + h            # ln_1, out bias, ln_2, fc_out bias
    block = split // m + whole
    total = (n // s) * block + v * h // m + p * h + 2 * h
    return total * bytes_per


def _dense(cpu):
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.text.models import GPTForPretraining
    framework.seed(0)
    return GPTForPretraining(tensor_parallel=False, attn_dropout=0.0,
                             hidden_dropout=0.0, **config(cpu))


class _Strategy:
    def __init__(self, schedule, m):
        self.pipeline_configs = {"accumulate_steps": m, "schedule": schedule}


def _pce(logits, labels):
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    return ParallelCrossEntropy()(logits, labels).mean()


def build(cpu, degrees, pipe, state, device):
    """(trainer, pipeline or None) of one run on a fresh mesh."""
    from paddle_tpu_torch import framework, optimizer
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import (CommunicateTopology,
                                                   HybridCommunicateGroup,
                                                   build_mesh)
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineLayer, PipelineParallel, TensorParallel)
    from paddle_tpu_torch.text.models import (GPTForPretraining,
                                              gpt_pipeline_descs,
                                              pipeline_state_from_dense)
    mesh = build_mesh(degrees)
    names = ("data", "pipe", "sharding", "model")
    topo = CommunicateTopology(names, [degrees.get(a, 1) for a in names])
    hcg = HybridCommunicateGroup(topo, topo.get_rank(
        **{a: mesh.coord[a] for a in names}))
    cfg = config(cpu)
    tp = degrees.get("model", 1) > 1
    framework.seed(0)
    pp = None
    if pipe is None:
        model = GPTForPretraining(tensor_parallel=tp, attn_dropout=0.0,
                                  hidden_dropout=0.0, **cfg)
        model.set_state_dict_from_numpy(state, mesh)
        net = TensorParallel(model, hcg) if tp else model
        loss_fn, m = model.loss, 1
    else:
        schedule, m = pipe
        pl = PipelineLayer(gpt_pipeline_descs(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
            max_position_embeddings=cfg["max_position_embeddings"],
            dropout=0.0, tensor_parallel=tp), num_stages=degrees["pipe"],
            seg_method="layer:GPTBlock")
        pl.set_state_dict_from_numpy(
            pipeline_state_from_dense(state, cfg["num_layers"]), mesh)
        net = pp = PipelineParallel(pl, hcg, _Strategy(schedule, m))
        loss_fn = _pce
    net = net.bfloat16()
    tr = ParallelTrainer(net, optimizer.AdamW(3e-4), loss_fn, mesh=mesh,
                         micro_batches=m, device=device)
    return tr, pp


def rank_main(cpu, root, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import flash_attention as fa
    env.init_parallel_env(device="cpu" if cpu else None)
    rank = env.get_rank()
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", env.get_local_rank())
    cfg = config(cpu)
    seq = cfg["max_position_embeddings"]
    rs = np.random.RandomState(0)
    ids, lbl = (torch.from_numpy(rs.randint(0, cfg["vocab_size"],
                                            (GLOBAL_BATCH, seq))
                                 .astype(np.int32)).to(device)
                for _ in range(2))
    state = {k: v.detach().numpy()
             for k, v in _dense(cpu).named_state().items()}
    out = {"rank": rank, "runs": {}}

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    for name, degrees, pipe in RUNS:
        if not cpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        tr, pp = build(cpu, degrees, pipe, state, device)
        losses, ms, launches = [], [], []
        for i in range(1, STEPS + 1):
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0
            sync()
            t0 = time.perf_counter()
            losses.append(tr.train_step(ids, lbl).item())
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(fa.LAUNCHES))
            if name == "pp2-tp2-gpipe" and i == SAVE_AT:
                path = os.path.join(root, "ckpt")
                t0 = time.perf_counter()
                tr.save_checkpoint(path)
                out["save_seconds"] = time.perf_counter() - t0
        stored = sum(v.numel() * v.element_size()
                     for v in tr.state["params"].values())
        out["runs"][name] = {
            "losses": losses, "ms": ms[2:], "launches": launches[-1],
            "coord": dict(tr.mesh.coord), "stored_param_bytes": stored,
            "in_flight": None if pp is None else pp.max_in_flight,
            "skipped": tr.skipped_steps(),
            "peak_gb": 0.0 if cpu else
            torch.cuda.max_memory_allocated(device) / 2 ** 30}
        if name == "pp2-tp2-gpipe":
            del tr
            fresh, _ = build(cpu, degrees, pipe, state, device)
            t0 = time.perf_counter()
            fresh.load_checkpoint(os.path.join(root, "ckpt"))
            sync()
            out["restore_seconds"] = time.perf_counter() - t0
            out["resumed"] = [fresh.train_step(ids, lbl).item()
                              for _ in range(STEPS - SAVE_AT)]
            tr = fresh
        del tr
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def expected_launches(cfg, name, coord):
    """Flash forwards (= dq = dk/dv launches) of one step on a rank."""
    n = cfg["num_layers"]
    if name == "pp4-1f1b":
        return n // 4 * 8
    if name == "pp2-tp2-gpipe":
        return n // 2 * 4
    if name == "sep4":
        return n * (coord["sep"] + 1)     # causal ring blocks of rank i
    return n


def main() -> int:
    cpu = "--cpu" in sys.argv
    sys.path.insert(0, ROOT)
    if not cpu:
        if torch.cuda.device_count() < 4:
            raise SystemExit("torch_hybrid_cards: needs four cards "
                             f"(found {torch.cuda.device_count()})")
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
    with tempfile.TemporaryDirectory(prefix="hybrid_cards_") as root:
        spawn(rank_main, args=(cpu, root, root), nprocs=4, timeout=1500)
        ranks = []
        for r in range(4):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    cfg = config(cpu)
    base = ranks[0]["runs"]["dp4"]["losses"]
    for name, degrees, pipe in RUNS:
        run = ranks[0]["runs"][name]
        want_bytes = predicted_param_bytes(cfg, degrees)
        for out in ranks:
            got = out["runs"][name]
            check(got["losses"] == run["losses"],
                  f"{name}: ranks disagree on the loss")
            check(got["skipped"] == 0, f"{name}: a step skipped")
            check(got["stored_param_bytes"] == want_bytes,
                  f"{name}: rank {out['rank']} stores "
                  f"{got['stored_param_bytes']}, the layout {want_bytes}")
            n = expected_launches(cfg, name, got["coord"])
            check(got["launches"] == {"flash_fwd": n, "flash_dq": n,
                                      "flash_dkv": n} or cpu,
                  f"{name}: rank {out['rank']} launches {got['launches']}")
            if pipe is not None and pipe[0] == "1f1b":
                s = got["coord"]["pipe"]
                check(got["in_flight"] == degrees["pipe"] - s,
                      f"{name}: stage {s} in flight {got['in_flight']}")
        check(all(np.isfinite(run["losses"])) and
              run["losses"][-1] < run["losses"][0], f"{name}: {run['losses']}")
        check(np.allclose(run["losses"], base, rtol=LOSS_RTOL),
              f"{name} losses {run['losses']} vs dp4 {base}")
        print(json.dumps({
            "run": name, "degrees": degrees, "losses": run["losses"],
            "loss_rel_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(run["losses"], base)),
            "ms_steps_3_5": run["ms"],
            "peak_gb_by_rank": [o["runs"][name]["peak_gb"] for o in ranks],
            "param_bytes_by_rank": [o["runs"][name]["stored_param_bytes"]
                                    for o in ranks],
            "param_bytes_predicted": want_bytes,
            "flash_launches_by_rank": [o["runs"][name]["launches"]
                                       for o in ranks],
            "in_flight_by_rank": [o["runs"][name]["in_flight"]
                                  for o in ranks]}), flush=True)
    uninterrupted = ranks[0]["runs"]["pp2-tp2-gpipe"]["losses"][SAVE_AT:]
    for out in ranks:
        check(out["resumed"] == uninterrupted,
              f"rank {out['rank']}: resumed {out['resumed']} vs "
              f"{uninterrupted}")
    print(json.dumps({"resume": "pp2-tp2-gpipe", "saved_step": SAVE_AT,
                      "resumed": ranks[0]["resumed"], "bit_equal": True,
                      "save_seconds": [o["save_seconds"] for o in ranks],
                      "restore_seconds": [o["restore_seconds"]
                                          for o in ranks]}), flush=True)
    print(json.dumps({"ok": True, "device": "cpu" if cpu else
                      torch.cuda.get_device_name(0), "count": 4}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
