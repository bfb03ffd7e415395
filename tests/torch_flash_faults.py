"""Plant faults in a copy of the tensor-core flash kernels and read how far
each moves its outputs from the plain version, against the bars that
``chip_smoke.py`` holds the kernels to: ``FLASH_TOL`` (elementwise),
``MMA_FWD_BOUND`` (the forward: the whole output's relative L2 error, the
lse's largest error) and ``MMA_BWD_BOUND`` (dq and dk/dv: each gradient's
relative L2 error). Runs on the card, from the repository root::

    python3 tests/torch_flash_faults.py

Each variant (the sound kernels, then each fault of ``FAULTS``) gets its
own copy of ``paddle_tpu_torch/`` in a temporary directory, with
``csrc/flash_attention.cu`` edited there, and its own process, which builds
the copy with nvcc (all variants at once) and runs the bf16 cases of
``chip_smoke.py``'s ``flash_parity`` on the mma route: the forward, then
dq and dk/dv on its out and lse. The checkout is never edited. Prints one
JSON line per variant and case, then a summary line; exits 1 unless the
sound kernels hold every bar on every case and each fault breaks the bound
of the kernel it sits in (``MMA_FWD_BOUND`` or ``MMA_BWD_BOUND``) on every
case whose outputs of that kernel it changes.
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
# (the kernel it sits in: "fwd" or "bwd", what the sound source holds, what
# the fault puts in its place)
FAULTS = {
    # the forward: the second K/V tile of every q tile is never seen
    "skip_tile": ("fwd", "    if (p.causal && k0 > qw + 15) continue;\n",
                  "    if (p.causal && k0 > qw + 15) continue;\n"
                  "    if (j == 1) continue;\n"),
    # the forward: O is not rescaled when the running max grows
    "no_rescale": ("fwd",
                   "      o[n][0] *= alpha[0];\n      o[n][1] *= alpha[0];\n"
                   "      o[n][2] *= alpha[1];\n      o[n][3] *= alpha[1];\n",
                   ""),
    # dk/dv: the second query tile of every key block is never seen
    "bwd_skip_q_tile": ("bwd",
                        "    if ((p.causal && q0 + BT <= kw) || kw >= len) "
                        "continue;\n",
                        "    if ((p.causal && q0 + BT <= kw) || kw >= len) "
                        "continue;\n    if (j == 1) continue;\n"),
    # dq and dk: ds = p∘dp, the − delta left out
    "bwd_no_delta": ("bwd", "  return p * (dp - delta);\n",
                     "  return p * dp;\n"),
    # dq: the last K/V tile of every q tile is never seen
    "bwd_skip_last_k_tile": ("bwd",
                             "    if (p.causal && k0 >= qw + 16) continue;\n",
                             "    if (p.causal && k0 >= qw + 16) continue;\n"
                             "    if (j == ntiles - 1) continue;\n"),
}


def _cases():
    """chip_smoke.py's bf16 flash_parity cases: (s, d, causal, lens, rate,
    b, h, split_qkv)."""
    cases = [(s, d, c, lens, 0.0, 2, 4, False)
             for s in (128, 200, 1024) for d in (64, 128)
             for c in (True, False) for lens in (None, [s, 37], [0, 37])]
    cases += [(1024, d, True, None, 0.1, 2, 4, False) for d in (64, 128)]
    cases.append((1024, 64, True, None, 0.0, 8, 12, True))
    return cases


def read_variant(work):
    """In a variant's process: run every case on the copy in ``work`` and
    print one JSON line per case."""
    sys.path[:0] = [work]
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    atol, rtol = cs.FLASH_TOL[bf16]

    def rel(g, r):
        g, r = g.float(), r.float()
        return ((g - r).norm() / r.norm().clamp_min(1e-30)).item()

    def digest(*ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    def close(gots, refs):
        return all(torch.allclose(g.float(), r.float(), atol=atol, rtol=rtol)
                   for g, r in zip(gots, refs))

    for i, (s, d, causal, lens, rate, b, h, split) in enumerate(_cases()):
        rs = np.random.RandomState(i)
        rand = lambda *shape: torch.as_tensor(  # noqa: E731
            rs.randn(*shape).astype(np.float32), device="cuda").to(bf16)
        if split:
            q, k, v = torch.split(rand(b, s, h, 3 * d), d, dim=-1)
        else:
            q, k, v = rand(b, s, h, d), rand(b, s, h, d), rand(b, s, h, d)
        do = rand(b, s, h, d)
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
        rest = (ln, 7, None, causal, rate, fa.keying_blocks(bf16, d, s, s))
        out, lse = fa.flash_attention_fwd(q, k, v, *rest, route="mma")
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *rest,
                                       route="mma")
        ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, *rest)
        ref_grads = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse,
                                                 do, *rest)
        out_rel = rel(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        bwd_rel = {f"{n}_rel": rel(g, r) for n, g, r in
                   zip(("dq", "dk", "dv"), grads, ref_grads)}
        print(json.dumps({
            "case": [s, d, causal, lens, rate, b, h, split],
            "out_rel": out_rel, "lse_abs": lse_err, **bwd_rel,
            "out_abs": (out.float() - ref_out.float()).abs().max().item(),
            "flash_tol": close((out, lse), (ref_out, ref_lse)),
            "flash_tol_bwd": close(grads, ref_grads),
            "mma_bound": (out_rel <= cs.MMA_FWD_BOUND["out_rel"] and
                          lse_err <= cs.MMA_FWD_BOUND["lse_abs"]),
            "mma_bwd_bound": all(v <= cs.MMA_BWD_BOUND[k]
                                 for k, v in bwd_rel.items()),
            "digest": digest(out, lse),
            "digest_bwd": digest(*grads)}), flush=True)


def _copy(name, base):
    work = os.path.join(base, name)
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(work, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
    if name in FAULTS:
        src = os.path.join(work, "paddle_tpu_torch", "csrc",
                           "flash_attention.cu")
        with open(src) as f:
            text = f.read()
        _, sound, fault = FAULTS[name]
        if text.count(sound) != 1:
            raise SystemExit(f"{name}: the sound lines are not in the source "
                             f"once; update FAULTS")
        with open(src, "w") as f:
            f.write(text.replace(sound, fault))
    return work


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_faults: no CUDA device")
    names = ["sound", *FAULTS]
    base = tempfile.mkdtemp(prefix="flash_faults_")
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
    ok = all(r["flash_tol"] and r["mma_bound"] and r["flash_tol_bwd"] and
             r["mma_bwd_bound"] for r in sound)
    summary = {}
    for n in names:
        # a fault is judged on the outputs of the kernel it sits in; the
        # sound variant on everything
        kind = FAULTS[n][0] if n in FAULTS else "fwd"
        suffix = "_bwd" if kind == "bwd" else ""
        changed = [r for r, s in zip(rows[n], sound)
                   if r["digest" + suffix] != s["digest" + suffix]]
        judged = rows[n] if n == "sound" else changed
        caught = sum(not r["mma" + suffix + "_bound"] for r in changed)
        if n != "sound":
            ok = ok and caught == len(changed) > 0
        grad_rel = [max(r["dq_rel"], r["dk_rel"], r["dv_rel"])
                    for r in judged]
        summary[n] = {
            "kernel": kind, "cases": len(rows[n]), "changed": len(changed),
            "caught_by_mma_bound": caught,
            "caught_by_flash_tol": sum(not r["flash_tol" + suffix]
                                       for r in changed),
            "out_rel_min": min((r["out_rel"] for r in judged), default=None),
            "out_rel_max": max((r["out_rel"] for r in judged), default=None),
            "lse_abs_max": max((r["lse_abs"] for r in judged), default=None),
            "out_abs_max": max((r["out_abs"] for r in judged), default=None),
            "grad_rel_min": min(grad_rel, default=None),
            "grad_rel_max": max(grad_rel, default=None)}
        for r in rows[n]:
            print(json.dumps({"variant": n, **r}), flush=True)
    from chip_smoke import MMA_BWD_BOUND, MMA_FWD_BOUND
    print(json.dumps({"summary": summary, "mma_bound": MMA_FWD_BOUND,
                      "mma_bwd_bound": MMA_BWD_BOUND, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--read":
        read_variant(sys.argv[2])
    else:
        sys.path.insert(0, ROOT)
        sys.exit(main())
