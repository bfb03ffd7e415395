"""The links of four cards and the cost model's step against the measured
one: NCCL, one process a card.

    python3 tests/torch_analysis_cards.py          # a host with four cards
    python3 tests/torch_analysis_cards.py --cpu    # rehearsal: four gloo
                                                   # ranks, small sizes

1. **Links.** NCCL ``all_reduce``, ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` over the four ranks at 1, 4, 16, 64 and 256
   MiB (the payload a rank contributes; ``--cpu``: 4 to 64 KiB over gloo),
   each the median of 7 timed calls (CUDA events, 3 warm-ups). Each
   sample is priced by the cost model's ring wire bytes
   (``analysis.cost``: all-reduce 2(n-1)/n of the payload, all-gather
   (n-1)/n of the gathered result, reduce-scatter (n-1)/n of the input),
   and ``telemetry.calibration.fit`` fits ``t = latency + bytes /
   bandwidth`` for the ``"ici"`` link (NVLink on this box); the entry for
   this device kind is written to ``chiprun_out/calibration_links.json``
   in the calibration DB's format (the shipped seed,
   ``paddle_tpu_torch/telemetry/calibration_db.json``, takes it).
2. **Steps.** bench.py's ``fused_b8_pallas_ce`` GPT-base (bf16, AdamW
   3e-4, the fused-CE kernels; ``--cpu``: 2 layers, width 64) on a global
   batch of 32 x 1024 (8 rows a card) at ``{"data": 4}`` and at
   ``{"sharding": 4}`` stage 1: each step traced on fake tensors
   (``staged_graph``), its collective nodes counted by kind, and priced by
   the overlap model (``cost.overlap_plan`` + ``replay_overlap``) at the
   card's bf16 peak (989 TFLOP/s) with the fitted link constants; then
   2 warm-up and 5 timed steps measured. Reports per layout: the
   collective nodes, the predicted makespan, collective time and the
   exposed (stalled) share, the measured ms, and the difference between
   the two layouts in each.

Prints one JSON object per line; the last is ``{"ok": true, ...}``.
Imports torch, numpy and ``paddle_tpu_torch`` only.
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
MIB = 1 << 20
SIZES = (1 * MIB, 4 * MIB, 16 * MIB, 64 * MIB, 256 * MIB)
CPU_SIZES = (4096, 16384, 65536)
GLOBAL_BATCH, SEQ = 32, 1024
PEAK = 989e12            # H100 SXM bf16 dense tensor-core peak
LAYOUTS = (("data4", {"data": 4}, 0), ("sharding4-s1", {"sharding": 4}, 1))


def _model(cpu):
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.text.models import GPTForPretraining
    framework.seed(0)
    cfg = (dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                max_position_embeddings=128) if cpu else
           dict(vocab_size=50304, hidden_size=768, num_layers=12,
                num_heads=12, max_position_embeddings=SEQ))
    return GPTForPretraining(tensor_parallel=False, attn_dropout=0.0,
                             hidden_dropout=0.0, **cfg).bfloat16()


class _Loss(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch):
        ids, lbl = batch
        return self.inner.fused_head_loss(ids, lbl, chunk=8192,
                                          ce_kernel="pallas")


def _time(fn, cpu, warmup=3, reps=7):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cpu:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return float(np.median(times))


def _sweep(cpu, device, n):
    """(kind, payload bytes, wire bytes, seconds) of every sample."""
    import torch.distributed as dist
    out = []
    ring = (n - 1) / n
    for size in (CPU_SIZES if cpu else SIZES):
        x = torch.ones(size // 4, dtype=torch.float32, device=device)
        big = torch.empty(n * x.numel(), dtype=torch.float32, device=device)
        part = torch.empty(x.numel() // n, dtype=torch.float32,
                           device=device)
        cases = {
            "all_reduce": (lambda: dist.all_reduce(x), 2 * ring * size),
            "all_gather": (lambda: dist.all_gather_into_tensor(big, x),
                           ring * n * size),
            "reduce_scatter": (lambda: dist.reduce_scatter_tensor(part, x),
                               ring * size)}
        for kind, (fn, wire) in cases.items():
            out.append((kind, size, wire, _time(fn, cpu)))
    return out


def rank_main(cpu, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.analysis import cost, walker
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.engine import ParallelTrainer
    from paddle_tpu_torch.distributed.mesh import build_mesh
    env.init_parallel_env(device="cpu" if cpu else None)
    rank, n = env.get_rank(), dist.get_world_size()
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", env.get_local_rank())
    samples = _sweep(cpu, device, n)
    # every rank prices with rank 0's fit (one DB, one set of constants)
    fit = [None]
    if rank == 0:
        from paddle_tpu_torch.telemetry import calibration
        fit[0] = calibration.fit(
            collective_samples=[{"link": "ici", "wire_bytes": w,
                                 "seconds": t} for _, _, w, t in samples],
            save=False)["entry"]["links"]["ici"]
    dist.broadcast_object_list(fit, src=0)
    bw, lat = fit[0]["bandwidth_bps"], fit[0]["latency_s"]
    rs = np.random.RandomState(0)
    vocab, seq = (512, 128) if cpu else (50304, SEQ)
    ids, lbl = (torch.from_numpy(rs.randint(0, vocab, (GLOBAL_BATCH, seq))
                                 .astype(np.int32)).to(device)
                for _ in range(2))
    runs = {}
    for name, degrees, stage in LAYOUTS:
        if not cpu:
            torch.cuda.reset_peak_memory_stats(device)
        mesh = build_mesh(degrees)
        tr = ParallelTrainer(_Loss(_model(cpu)), optimizer.AdamW(3e-4),
                             lambda out, _l: out, mesh=mesh,
                             zero_stage=stage, device=device)
        t0 = time.perf_counter()
        graph = tr.staged_graph((ids, lbl), 0.0)
        trace_s = time.perf_counter() - t0
        kinds = {}
        for s in walker.walk(graph, mesh):
            if s.is_collective:
                kinds[s.op] = kinds.get(s.op, 0) + 1
        pred = cost.replay_overlap(
            cost.overlap_plan(graph, mesh), peak_flops=PEAK,
            bandwidths={"ici": bw}, latencies={"ici": lat})
        for _ in range(2):
            float(tr.train_step((ids, lbl), 0.0))
        if not cpu:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            loss = tr.train_step((ids, lbl), 0.0)
        float(loss)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        runs[name] = {"collective_nodes": kinds,
                      "n_collectives": sum(kinds.values()),
                      "trace_s": trace_s, "predicted": pred,
                      "measured_ms": ms, "loss": float(loss),
                      "peak_gb": (torch.cuda.max_memory_allocated(device)
                                  / 1e9 if not cpu else None)}
        del tr
        if not cpu:
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"rank": rank, "samples": samples, "fit": fit[0],
                     "runs": runs}, f)
    dist.barrier()
    dist.destroy_process_group()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    cpu = "--cpu" in sys.argv
    sys.path.insert(0, ROOT)
    card = "cpu"
    if not cpu:
        if torch.cuda.device_count() < 4:
            raise SystemExit("torch_analysis_cards: needs four cards "
                             f"(found {torch.cuda.device_count()})")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        card = smi[0] if smi else "nvidia-smi gave nothing"
        print(json.dumps({"cards": smi}), flush=True)
        from paddle_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build(["flash_attention", "fused_ce"])   # once, for all ranks
        print(json.dumps({"build_seconds": time.perf_counter() - t0}),
              flush=True)
    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.ops.tuner import device_kind
    with tempfile.TemporaryDirectory(prefix="analysis_cards_") as root:
        spawn(rank_main, args=(cpu, root), nprocs=4, timeout=1500)
        ranks = []
        for r in range(4):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0 = ranks[0]
    for kind, size, wire, t in r0["samples"]:
        print(json.dumps({"card": card, "collective": kind,
                          "payload_bytes": size, "wire_bytes": wire,
                          "seconds": t, "bus_gbps": wire / t / 1e9}),
              flush=True)
    fit = r0["fit"]
    check(fit["bandwidth_bps"] > 0 and fit["latency_s"] >= 0,
          f"link fit {fit}")
    entry = {"links": {"ici": fit},
             "fitted": {"n_collective": len(r0["samples"])},
             "source": f"tests/torch_analysis_cards.py on 4 x {card}"}
    print(json.dumps({"card": card, "fit_ici": fit}), flush=True)
    if not cpu:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "calibration_links.json"), "w") as f:
            json.dump({device_kind(): entry}, f, indent=1)
    for name, _, stage in LAYOUTS:
        runs = [r["runs"][name] for r in ranks]
        check(all(np.isfinite(x["loss"]) for x in runs), f"{name}: loss")
        check(len({x["n_collectives"] for x in runs}) == 1,
              f"{name}: ranks trace other collective counts")
        p = runs[0]["predicted"]
        print(json.dumps({
            "card": card, "layout": name, "zero_stage": stage,
            "collective_nodes": runs[0]["collective_nodes"],
            "trace_s": [x["trace_s"] for x in runs],
            "predicted_ms": p["makespan"] * 1e3,
            "predicted_compute_ms": p["compute_time"] * 1e3,
            "predicted_collective_ms": p["collective_time"] * 1e3,
            "predicted_exposed_ms": p["stalled_time"] * 1e3,
            "overlap_efficiency": p["overlap_efficiency"],
            "measured_ms": [x["measured_ms"] for x in runs],
            "peak_gb": [x["peak_gb"] for x in runs]}), flush=True)
    a, b = (r0["runs"][name] for name, _, _ in LAYOUTS)
    print(json.dumps({
        "card": card, "sharding4_minus_data4": {
            "predicted_ms": (b["predicted"]["makespan"] -
                             a["predicted"]["makespan"]) * 1e3,
            "predicted_exposed_ms": (b["predicted"]["stalled_time"] -
                                     a["predicted"]["stalled_time"]) * 1e3,
            "measured_ms": b["measured_ms"] - a["measured_ms"],
            "collective_nodes": b["n_collectives"] - a["n_collectives"]}}),
          flush=True)
    print(json.dumps({"ok": True, "device": card, "count": 4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
