"""Plant faults in a copy of the paged split route and read how far each
moves acc, m and l from the plain version, against the bar that
``chip_smoke.py`` holds the kernels to: ``ATOL``/``RTOL`` (1e-4,
elementwise). Runs on the card, from the repository root::

    python3 tests/torch_paged_faults.py

Each variant (the sound kernels, then each fault of ``FAULTS``) gets its
own copy of ``paddle_tpu_torch/`` in a temporary directory, with
``csrc/paged_attention.cu`` edited there, and its own process, which builds
the copy with nvcc (all variants at once) and runs ``chip_smoke.py``'s
paged parity inputs on the split route, each at the route's own split
count and forced to 1, 2 and the table's width. The checkout is never
edited. Prints one JSON line per variant and case, then a summary line;
exits 1 unless the sound kernels hold the bar on every case and each fault
breaks it on every case whose output it changes (and changes at least
one).
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
# name -> [(what the sound source holds, what the fault puts in its place)]
FAULTS = {
    # the merge never sees split 1
    "merge_skips_split_1": [(
        "    const float* part = base + s * stride;\n",
        "    if (s == 1) continue;\n"
        "    const float* part = base + s * stride;\n")],
    # acc and l are not rescaled when a later stage raises the running max
    "no_alpha_rescale": [
        ("      for (int e = 0; e < DPL; ++e) acc[i][e] *= a;\n", ""),
        ("    for (int k = 0; k < RPL; ++k) l[k] *= alpha[k];\n", "")],
    # the key one past the split's end is scored (its K/V are zero-filled)
    "tail_mask_off_by_one": [(
        "        s[k][j] = base + key < ke ? dot[k] : kNegInf;\n",
        "        s[k][j] = base + key <= ke ? dot[k] : kNegInf;\n")],
    # a ring stage is read while its cp.async copies may still be in flight
    "read_before_wait": [(
        "    cp_wait<kStages - 2>();   // tile t has landed (this thread's "
        "part)\n",
        "    cp_wait<kStages - 1>();\n")],
}


def _cases(cs):
    """chip_smoke.py's paged parity inputs, each at the split route's own
    split count (None) and forced to 1, 2 and the width (64): (tq, bf16,
    lens, splits)."""
    lens_a = [0, 1, 15, 16, 17, 513, 1023, 1024]
    lens_b = [0, 1, 15, 16, 17, 513, 5000, 1024]
    inputs = ([(tq, False, lens) for tq in cs.PARITY_TQ
               for lens in (lens_a, lens_b)] +
              [(tq, True, lens_a) for tq in (1, 5, 8)])
    return [(tq, bf16, lens, splits) for tq, bf16, lens in inputs
            for splits in (None, 1, 2, 64)]


def read_variant(work):
    """In a variant's process: run every case on the copy in ``work`` and
    print one JSON line per case."""
    sys.path[:0] = [work]
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa

    def digest(ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    for i, (tq, bf16, lens, splits) in enumerate(_cases(cs)):
        rs = np.random.RandomState(i)
        dtype = torch.bfloat16 if bf16 else torch.float32
        q, kp, vp, tab, ln = cs.paged_inputs(rs, tq, dtype, lens)
        got = pa.paged_attention(q, kp, vp, tab, ln, route="split",
                                 splits=splits)
        want = pa.paged_attention_plain(q, kp, vp, tab, ln)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        print(json.dumps({
            "case": [tq, "bfloat16" if bf16 else "float32", lens, splits],
            "max_abs_err": err,
            "finite": all(torch.isfinite(g).all().item() for g in got),
            "atol": all(torch.allclose(g, w, atol=cs.ATOL, rtol=cs.RTOL)
                        for g, w in zip(got, want)),
            "digest": digest(got)}), flush=True)


def _copy(name, base):
    work = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(work, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
    if name in FAULTS:
        src = os.path.join(work, "paddle_tpu_torch", "csrc",
                           "paged_attention.cu")
        with open(src) as f:
            text = f.read()
        for sound, fault in FAULTS[name]:
            if text.count(sound) != 1:
                raise SystemExit(f"{name}: the sound lines are not in the "
                                 f"source once; update FAULTS")
            text = text.replace(sound, fault)
        with open(src, "w") as f:
            f.write(text)
    return work


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_paged_faults: no CUDA device")
    names = ["sound", *FAULTS]
    base = tempfile.mkdtemp(prefix="paged_faults_")
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
    ok = all(r["atol"] and r["finite"] for r in sound)
    summary = {}
    for n in names:
        changed = [r for r, s in zip(rows[n], sound)
                   if r["digest"] != s["digest"]]
        judged = rows[n] if n == "sound" else changed
        caught = sum(not r["atol"] for r in changed)
        if n != "sound":
            ok = ok and caught == len(changed) > 0
        errs = [r["max_abs_err"] for r in judged]
        summary[n] = {"cases": len(rows[n]), "changed": len(changed),
                      "caught_by_atol": caught,
                      "err_min": min(errs, default=None),
                      "err_max": max(errs, default=None)}
        for r in rows[n]:
            print(json.dumps({"variant": n, **r}), flush=True)
    from chip_smoke import ATOL, RTOL
    print(json.dumps({"summary": summary, "atol": ATOL, "rtol": RTOL,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--read":
        read_variant(sys.argv[2])
    else:
        sys.path.insert(0, ROOT)
        sys.exit(main())
