"""Plant faults in a copy of the tiled fused-CE forward and read how far
each moves lse and tgt from the plain version, against the bar that
``chip_smoke.py`` holds the kernel to: ``CE_STAT_ATOL`` (max abs error of
lse and of tgt). Runs on the card, from the repository root::

    python3 tests/torch_ce_faults.py

Each variant (the sound kernel, then each fault of ``FAULTS``) gets its own
copy of ``paddle_tpu_torch/`` in a temporary directory, with
``csrc/fused_ce.cu`` edited there, and its own process, which builds the
copy with nvcc (all variants at once) and runs every case of
``chip_smoke.py``'s ``ce_parity`` that takes the tiled forward. The
checkout is never edited. Prints one JSON line per variant and case, then
a summary line; exits 1 unless the sound kernel holds the bar on every
case and each fault breaks it on every case whose output it changes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (what the sound source holds, what the fault puts in its place)
FAULTS = {
    # the merge never sees the last vocab split
    "merge_skips_last_split": (
        "  for (int i = 0; i < p.splits; ++i) {\n",
        "  for (int i = 0; i + 1 < p.splits; ++i) {\n"),
    # the mainloop leaves the last H chunk out of every logit
    "skip_last_chunk": (
        "      slot = slot + 1 == FT_STAGES ? 0 : slot + 1;\n",
        "      slot = slot + 1 == FT_STAGES ? 0 : slot + 1;\n"
        "      if (c + 1 == nc) continue;\n"),
    # the running sum is not rescaled when the running max grows
    "no_rescale": (
        "      s[r] *= exp2f((m[r] - m_new) * kLog2e);   // NEG_INF start -> 0\n",
        ""),
}


def read_variant(work):
    """In a variant's process: run every tiled-forward case on the copy in
    ``work`` and print one JSON line per case."""
    sys.path[:0] = [work]
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import fused_ce as fc

    for i, (shape, dtype, ignore, transposed, oor) in enumerate(
            cs.ce_parity_cases()):
        h = 768 if shape == "main path" else shape[1]
        if fc.fwd_route(dtype, h) != "tiled":
            continue
        if shape == "main path":
            hid, w, lbl, _ = cs.ce_main_inputs()
        else:
            hid, w, lbl, _ = cs.ce_inputs(np.random.RandomState(i), *shape,
                                          dtype, ignore, transposed, oor)
        r0 = fc.ROUTES["ce_fwd_tiled"]
        lse, tgt = fc.ce_fwd(hid, w, lbl)
        ref_lse, ref_tgt = fc.fused_ce_plain_fwd(hid, w, lbl)
        torch.cuda.synchronize()
        if fc.ROUTES["ce_fwd_tiled"] != r0 + 1:
            raise SystemExit(f"case {i}: the forward did not take the "
                             f"tiled route")
        lse_err = (lse - ref_lse).abs().max().item()
        tgt_err = (tgt - ref_tgt).abs().max().item()
        digest = hashlib.sha1(lse.cpu().numpy().tobytes())
        digest.update(tgt.cpu().numpy().tobytes())
        print(json.dumps({
            "case": [shape, str(dtype).split(".")[-1], ignore, transposed,
                     oor],
            "lse_abs": lse_err, "tgt_abs": tgt_err,
            "stat_atol": (lse_err <= cs.CE_STAT_ATOL and
                          tgt_err <= cs.CE_STAT_ATOL),
            "digest": digest.hexdigest()}), flush=True)


def _copy(name, base):
    work = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(work, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
    if name in FAULTS:
        src = os.path.join(work, "paddle_tpu_torch", "csrc", "fused_ce.cu")
        with open(src) as f:
            text = f.read()
        sound, fault = FAULTS[name]
        if text.count(sound) != 1:
            raise SystemExit(f"{name}: the sound lines are not in the source "
                             f"once; update FAULTS")
        with open(src, "w") as f:
            f.write(text.replace(sound, fault))
    return work


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ce_faults: no CUDA device")
    names = ["sound", *FAULTS]
    base = tempfile.mkdtemp(prefix="ce_faults_")
    try:
        procs = {n: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--read",
             _copy(n, base)], stdout=subprocess.PIPE, text=True)
            for n in names}
        rows = {}
        for n, p in procs.items():
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise SystemExit(f"{n}: the variant's process failed "
                                 f"({p.returncode})")
            rows[n] = [json.loads(ln) for ln in out.splitlines()
                       if ln.startswith("{")]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    sound = rows["sound"]
    ok = len(sound) > 0 and all(r["stat_atol"] for r in sound)
    summary = {}
    for n in names:
        changed = [r for r, s in zip(rows[n], sound)
                   if r["digest"] != s["digest"]]
        judged = rows[n] if n == "sound" else changed
        caught = sum(not r["stat_atol"] for r in changed)
        if n != "sound":
            ok = ok and len(rows[n]) == len(sound) and \
                caught == len(changed) > 0
        # a fault's reading on a case is the larger of its two errors
        reads = [max(r["lse_abs"], r["tgt_abs"]) for r in judged]
        summary[n] = {
            "cases": len(rows[n]), "changed": len(changed),
            "caught_by_stat_atol": caught,
            "read_min": min(reads, default=None),
            "read_max": max(reads, default=None),
            "lse_abs_max": max((r["lse_abs"] for r in judged), default=None),
            "tgt_abs_max": max((r["tgt_abs"] for r in judged), default=None)}
        for r in rows[n]:
            print(json.dumps({"variant": n, **r}), flush=True)
    from chip_smoke import CE_STAT_ATOL
    print(json.dumps({"summary": summary, "stat_atol": CE_STAT_ATOL,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--read":
        read_variant(sys.argv[2])
    else:
        sys.path.insert(0, ROOT)
        sys.exit(main())
