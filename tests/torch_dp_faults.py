"""Plant faults in the error feedback of the quantized gradient exchange and
read how far each moves GPT-base's losses from ``fused_b8``'s, against the
band that ``chip_smoke.py``'s ``train_dp`` holds them to
(``DP_LOSS_BAND``). Runs on the card, from the repository root::

    python3 tests/torch_dp_faults.py

One process, an NCCL data mesh of one rank, ``train_dp``'s runs (2 warm-up
and 10 timed steps, bf16, AdamW keeping biases and norms out of its decay)
under int8 and int4: the sound exchange, then each fault of ``FAULTS``,
planted around ``train_step`` (the package is not edited):

- ``no_error_feedback``: every residual zeroed after each step, so no
  quantization error is carried into the next step;
- ``residual_sign_flipped``: the residual subtracted from the next step's
  gradient instead of added.

Prints one JSON line per run, then a summary line saying which runs the
band catches (a fault inside the band is a reading: then the band is not
the check that catches it). Exits 1 unless every sound run is inside the
band.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

FAULTS = (None, "no_error_feedback", "residual_sign_flipped")


def plant(trainer, fault):
    """Wrap ``trainer.train_step`` with ``fault`` (None: as it is)."""
    if fault is None:
        return
    step = trainer.train_step

    def faulty(*args, **kw):
        if fault == "residual_sign_flipped":
            for v in trainer.comm_err.values():
                v.neg_()
        out = step(*args, **kw)
        if fault == "no_error_feedback":
            for v in trainer.comm_err.values():
                v.zero_()
        return out

    trainer.train_step = faulty


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_faults: no CUDA device")
    import torch.distributed as dist
    from paddle_tpu_torch import framework, nn, optimizer as optim
    from paddle_tpu_torch.distributed import engine
    from paddle_tpu_torch.ops import _build, tuner
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention"])
    fa.load_kernel()
    nccl, _, _ = cs.dp_setup()
    rows = []
    try:
        trainer, batch, n = cs.gpt_base_trainer(nn, gpt, engine, optim,
                                                framework)
        base = cs.train(fa, tuner, trainer, batch, n)["losses"]
        del trainer, batch
        print(json.dumps({"run": "fused_b8", "losses": base}), flush=True)
        for policy in ("int8", "int4"):
            band = cs.DP_LOSS_BAND[policy]
            for fault in FAULTS:
                trainer, batch, n = cs.gpt_base_trainer(
                    nn, gpt, engine, optim, framework, mesh=nccl,
                    opt=optim.AdamW(3e-4, apply_decay_param_fun=cs.no_decay),
                    grad_sync=policy)
                plant(trainer, fault)
                row = {"policy": policy, "fault": fault, "band": band}
                try:
                    losses = cs.train(fa, tuner, trainer, batch, n)["losses"]
                    rel = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, base))
                    row.update(losses=losses, max_rel_loss_vs_fused_b8=rel,
                               caught_by_band=rel > band)
                except AssertionError as e:
                    row.update(raised=str(e)[:300], caught_by_band=None)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del trainer, batch
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    sound_ok = all(r["caught_by_band"] is False for r in rows
                   if r["fault"] is None)
    print(json.dumps({"summary": {
        f"{r['policy']}/{r['fault']}": r.get("max_rel_loss_vs_fused_b8",
                                             r.get("raised"))
        for r in rows},
        "caught": [f"{r['policy']}/{r['fault']}" for r in rows
                   if r["fault"] and r["caught_by_band"]],
        "sound_within_band": sound_ok}), flush=True)
    return 0 if sound_ok else 1


if __name__ == "__main__":
    sys.exit(main())
