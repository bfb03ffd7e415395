"""Time the paged split route's design choices against each other on the
card, in turns in one process. Runs on the card, from the repository
root::

    python3 tests/torch_paged_variants.py

Each variant of ``VARIANTS`` edits a constant of the split kernel (the
ring's depth, the keys a stage), and each of ``ABLATIONS`` removes one part
of its work, in a copy of
``paddle_tpu_torch/csrc/paged_attention.cu`` in a temporary directory (the
checkout is never edited); all are built with nvcc at once. Then, at the
main shape (B 8, H 12, D 64, page 16, 1024 cached tokens a row, float32
pools) at Tq 1, 5 and 32, each variant is held against the plain version
(``chip_smoke.ATOL``/``RTOL``) and timed (``chip_smoke.time_ms``, L2
flushed, behind a lead spin) in four rounds, the order of the variants
reversed every other round (the ablations are timed, not held: their
outputs are wrong by design). Prints the card, one JSON line per variant
and shape (median and every round's time) and exits 1 if a variant fails
to build or breaks the bar.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STAGES = "constexpr int kStages = 3;   // cp.async ring depth\n"
_TILE = "  static constexpr int kRawTile = 8192 / (2 * kRowBytes);\n"
# name -> [(what the shipped source holds, what the variant puts there)]
VARIANTS = {
    "shipped": [],
    "stages_2": [(_STAGES, "constexpr int kStages = 2;\n")],
    "stages_4": [(_STAGES, "constexpr int kStages = 4;\n")],
    "tile_16kb": [(_TILE, "  static constexpr int kRawTile = 16384 / "
                          "(2 * kRowBytes);\n")],
    "tile_16kb_stages_2": [
        (_TILE, "  static constexpr int kRawTile = 16384 / "
                "(2 * kRowBytes);\n"),
        (_STAGES, "constexpr int kStages = 2;\n")],
    # at Tq > 16 (8 rows a warp), registers capped for three blocks an SM
    "three_blocks_at_rw8": [(
        "__global__ void __launch_bounds__(32 * kWarps) paged_split_kernel(",
        "__global__ void __launch_bounds__(32 * kWarps, RW >= 8 ? 3 : 1) "
        "paged_split_kernel(")],
}
# ablations: each removes one part of the work to show what it costs;
# their outputs are wrong by design, so they are timed and not held to
# the bar
ABLATIONS = {
    "no_global_reads": [("        bytes = 16;\n", "        bytes = 0;\n")],
    "no_dot_shuffles": [
        ("      v[k] = keep + __shfl_xor_sync(kFull, send, O);\n",
         "      v[k] = keep + send;\n"),
        ("    v[0] += __shfl_xor_sync(kFull, v[0], O);\n", "")],
    "no_pv_fma": [("        for (int e = 0; e < DPL; ++e) acc[i][e] = "
                   "fmaf(pi, vf[e], acc[i][e]);\n", "")],
    "no_exp": [("                   ? exp2f(fmaf(s[k][j], kLog2e, -ml[k])) "
                ": 0.f;\n",
                "                   ? fmaf(s[k][j], kLog2e, -ml[k]) : 0.f;\n")],
}
TQS = (1, 5, 32)


def _build_all(work):
    from paddle_tpu_torch.ops import _build
    src = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    text = open(os.path.join(src, "paged_attention.cu")).read()
    for name in os.listdir(src):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(src, name), work)
    procs = {}
    for name, edits in {**VARIANTS, **ABLATIONS}.items():
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
        libs[name] = os.path.join(work, f"lib{name}.so")
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    work = tempfile.mkdtemp(prefix="paged_variants_")
    try:
        libs = {name: pa.bind(ctypes.CDLL(path))
                for name, path in _build_all(work).items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rs = np.random.RandomState(0)
    ok = True
    for tq in TQS:
        q, kp, vp, tab, ln = cs.paged_inputs(rs, tq, torch.float32,
                                             [1024] * 8)
        want = pa.paged_attention_plain(q, kp, vp, tab, ln)
        errs = {}
        for name, lib in libs.items():
            pa._lib = lib
            got = pa.paged_attention(q, kp, vp, tab, ln)
            errs[name] = max((g - w).abs().max().item()
                             for g, w in zip(got, want))
            ok = ok and (name in ABLATIONS or all(
                torch.allclose(g, w, atol=cs.ATOL, rtol=cs.RTOL)
                for g, w in zip(got, want)))
        times = {name: [] for name in libs}
        order = list(libs)
        for rnd in range(4):
            for name in order if rnd % 2 == 0 else order[::-1]:
                pa._lib = libs[name]
                times[name].append(cs.time_ms(
                    lambda: pa.paged_attention(q, kp, vp, tab, ln),
                    flush=flush, lead=True))
        for name in order:
            print(json.dumps({
                "card": card, "tq": tq, "variant": name,
                "ablation": name in ABLATIONS,
                "ms": float(np.median(times[name])),
                "rounds": times[name], "max_abs_err": errs[name]}),
                flush=True)
    pa._lib = None
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
