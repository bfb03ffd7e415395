"""Time the tensor-core flash backward's design choices against each other
on the card, in turns in one process. Runs on the card, from the
repository root::

    python3 tests/torch_flash_variants.py

Each variant of ``VARIANTS`` edits the constants of ``MmaBwdCfg`` in a copy
of ``paddle_tpu_torch/csrc/flash_attention.cu`` in a temporary directory
(the checkout is never edited); all are built with nvcc at once. Then, at
GPT-base's call and at gpt_1p3b's heads (bf16, causal, q/k/v the QKV
split's strided views), each variant's dq and dk/dv are held against the
plain backward (``MMA_BWD_BOUND``) and timed (``chip_smoke.time_ms``, L2
flushed) in four rounds, the order of the variants reversed every other
round. Prints the card, each variant's ptxas registers and spills, one
JSON line per variant and shape (median and every round's time, TFLOP/s),
and exits 1 if a variant fails to build or breaks the bound.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BT = "  static constexpr int BT = 32;              // streamed rows a tile\n"
_HOLD_DQ = "  static constexpr bool kHoldDq = true;\n"
_HOLD_DKV = "  static constexpr bool kHoldDkv = D > 64;\n"
_MINB = ("  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;  "
         "// __launch_bounds__\n")
# name -> [(what the shipped source holds, what the variant puts there)]
VARIANTS = {
    "shipped": [],
    "tiles_of_64": [(_BT, "  static constexpr int BT = 64;\n")],
    "dq_no_hold_at_d64": [(_HOLD_DQ, "  static constexpr bool kHoldDq = "
                                     "D > 64;\n")],
    "dq_no_hold_at_d128": [(_HOLD_DQ, "  static constexpr bool kHoldDq = "
                                      "D <= 64;\n")],
    "dkv_hold_at_d64": [(_HOLD_DKV, "  static constexpr bool kHoldDkv = "
                                    "true;\n")],
    "dkv_no_hold_at_d128": [(_HOLD_DKV, "  static constexpr bool kHoldDkv = "
                                        "false;\n")],
    "one_block_an_sm": [(_MINB, "  static constexpr int kMinBlocks = 1;\n")],
}
SHAPES = ((8, 12, 1024, 64), (8, 16, 1024, 128))   # (B, H, S, D)


def _build_all(work):
    from paddle_tpu_torch.ops import _build
    src = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    text = open(os.path.join(src, "flash_attention.cu")).read()
    for name in os.listdir(src):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(src, name), work)
    procs = {}
    for name, edits in VARIANTS.items():
        variant = text
        for sound, edit in edits:
            if variant.count(sound) != 1:
                raise SystemExit(f"{name}: the shipped line is not in the "
                                 f"source once; update VARIANTS")
            variant = variant.replace(sound, edit)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(work, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        ptxas = {}
        for i, line in enumerate(lines):
            kernel = re.search(r"flash_(dq|dkv)_mma_kernelILi(\d+)", line)
            if kernel and "Compiling entry" in line:
                ptxas[f"{kernel.group(1)}<{kernel.group(2)}>"] = " | ".join(
                    ln.strip() for ln in lines[i + 2:i + 4])
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        libs[name] = os.path.join(work, f"lib{name}.so")
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    work = tempfile.mkdtemp(prefix="flash_variants_")
    try:
        libs = {name: fa.bind(ctypes.CDLL(path))
                for name, path in _build_all(work).items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ok = True
    for b, h, s, d in SHAPES:
        q, k, v, do = cs._qkv_views(b, s, h, d)
        rest = (None, 0, None, True, 0.0, fa.keying_blocks(q.dtype, d, s, s))
        fa._lib = libs["shipped"]
        out, lse = fa.flash_attention_fwd(q, k, v, *rest)
        delta = fa._delta(out, do)
        ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, *rest)
        ref = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do,
                                           *rest)
        rel = {}
        for name, lib in libs.items():
            fa._lib = lib
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest,
                                           route="mma")
            rel[name] = {f"{n}_rel": ((g.float() - r.float()).norm() /
                                      r.float().norm()).item()
                         for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
            ok = ok and all(x <= cs.MMA_BWD_BOUND[key]
                            for key, x in rel[name].items())
        times = {name: {"dq": [], "dkv": []} for name in libs}
        order = list(libs)
        for rnd in range(4):
            for name in order if rnd % 2 == 0 else order[::-1]:
                fa._lib = libs[name]
                for key, launch in (("dq", fa._launch_dq),
                                    ("dkv", fa._launch_dkv)):
                    times[name][key].append(cs.time_ms(
                        lambda: launch(q, k, v, do, lse, delta, *rest,
                                       route="mma"), flush=flush))
        prod = b * h * s * s * d
        for name in order:
            dq, dkv = (float(np.median(times[name][key]))
                       for key in ("dq", "dkv"))
            print(json.dumps({
                "card": card, "shape": [b, s, h, d], "variant": name,
                "dq_ms": dq, "dkv_ms": dkv, "pair_ms": dq + dkv,
                "dq_tflops": 3 * prod / dq / 1e9,
                "dkv_tflops": 4 * prod / dkv / 1e9,
                "dq_rounds": times[name]["dq"],
                "dkv_rounds": times[name]["dkv"], **rel[name]}), flush=True)
    fa._lib = None
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
