"""Count the kernels that torch.profiler keeps of three GPT-base training
steps (``fused_b8_pallas_ce``: the flash and fused-CE kernels), for three
ways of opening the profiler's window, taken in turns on one trainer.
Runs on the card, from the repository root::

    python3 tests/torch_profiler_window.py [rounds]

Modes (each: one warm-up step, then three steps in the window):

- ``cold``: the warm-up step before the profiler; the window opens with
  the profiler, just before the first step.
- ``warm``: the warm-up step in the profiler's warm-up cycle
  (``schedule(wait=0, warmup=1, active=1)``); the window opens just before
  the first step.
- ``lead``: ``chip_smoke._profiled_steps``, the warm-up cycle and a host
  wait of ``chip_smoke.LEAD_S`` between the window's start and the first
  step.

A complete window holds the same kernels every time, so the largest count
seen is taken as the whole; a window short of it lost kernels, and the
position of its first flash forward says whether they went at its start.
Prints one JSON line per window, then a summary line per mode; writes
every line to ``chiprun_out/profiler_window.json`` as well. Exits 1 if a
``lead`` window lost a kernel.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
FLASH = {"fwd": "flash_fwd_mma_kernel", "dq": "flash_dq_mma_kernel",
         "dkv": "flash_dkv_mma_kernel"}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from paddle_tpu_torch import framework, nn, optimizer as optim
    from paddle_tpu_torch.distributed import engine
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.text.models import gpt

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build(["flash_attention", "fused_ce"])
    fa.load_kernel()
    fc.load_kernel()
    trainer, batch, _ = cs.gpt_base_trainer(nn, gpt, engine, optim,
                                            framework, head="pallas")
    inputs, lbls = batch
    for _ in range(2):
        float(trainer.train_step(inputs, lbls))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def cold():
        float(trainer.train_step(inputs, lbls))
        with profile(activities=acts) as prof:
            for _ in range(STEPS):
                loss = trainer.train_step(inputs, lbls)
            float(loss)
        return prof

    def warm():
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1)) as prof:
            float(trainer.train_step(inputs, lbls))
            torch.cuda.synchronize()
            prof.step()
            for _ in range(STEPS):
                loss = trainer.train_step(inputs, lbls)
            float(loss)
            torch.cuda.synchronize()
        return prof

    def lead():
        return cs._profiled_steps(trainer, batch, STEPS)[0]

    modes = {"cold": cold, "warm": warm, "lead": lead}
    lines = []
    t0 = time.perf_counter()
    for r in range(rounds):
        for mode, window in modes.items():
            prof = window()
            names = [e.name for e in sorted(
                (e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda e: e.time_range.start)]
            fwd_at = [i for i, n in enumerate(names) if FLASH["fwd"] in n]
            line = {"round": r, "mode": mode, "card": card,
                    "kernels": len(names),
                    **{k: sum(v in n for n in names)
                       for k, v in FLASH.items()},
                    "first_flash_fwd_at": fwd_at[0] if fwd_at else None,
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
    whole = max(x["kernels"] for x in lines)
    summary = []
    for mode in modes:
        got = [x for x in lines if x["mode"] == mode]
        summary.append({
            "mode": mode, "card": card, "windows": len(got),
            "whole_window_kernels": whole,
            "short_windows": sum(x["kernels"] < whole for x in got),
            "most_lost": max(whole - x["kernels"] for x in got),
            "flash_short_windows": sum(
                (x["fwd"], x["dq"], x["dkv"]) != (12 * STEPS,) * 3
                for x in got)})
        print(json.dumps(summary[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profiler_window.json"),
              "w") as f:
        json.dump({"windows": lines, "summary": summary}, f, indent=1)
    return 1 if summary[-1]["short_windows"] else 0


if __name__ == "__main__":
    sys.exit(main())
