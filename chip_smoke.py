#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's decode-serving and GPT training paths on
one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from ``paddle_tpu_torch/csrc`` with nvcc (one process
per source, all started together), then:

- tuning: ``python -m paddle_tpu_torch.ops.tuner``'s H100 suite, twice,
  into a temporary overlay the rest of the run resolves through: every
  candidate split count of the CE forward and of the paged split route
  held against the plain version, then timed; the winners beside the
  formula, the drift of the second sweep, the seed's rows against this
  run's winners; ``resolve`` and the next launches take the winners, the
  reference's generic rows answer as off the card (``tune``);

- serving: holds the paged-attention kernels against their plain PyTorch
  version (the split route at its own and at forced split counts, also on
  pools holding NaN wherever no context reaches, and the simple route),
  checks that repeats are bit-identical, times both routes (the split
  route at the formula's and at the tuned count) beside plain and the
  library, and serves generations at GPT-base widths through
  ``DecodeServer`` and ``SpeculativeDecodeServer``, checking every token
  against the dense oracle and the JAX reference's golden tokens
  (``paddle_tpu_torch/testdata/decode_golden.json``);
- training: holds the flash-attention kernels (forward, dq and dk/dv;
  each on both its routes, tensor-core and scalar) and the three fused-CE
  kernels (forward, dh, dw; each on both its routes, tiled and staged)
  against their plain versions and times them at GPT-base (the flash
  kernels also at GPT-1.3B's head dim, the CE forward also at its width);
  checks that
  float16 inputs fall back to the
  plain attention and the chunked CE, counted; trains GPT-base widths at
  depth 2
  in float32 against the JAX reference's golden losses
  (``paddle_tpu_torch/testdata/gpt_train_golden.json``) through the three
  routes of the head loss (chunked CE, fused CE kernels, dense logits +
  ``cross_entropy``); runs full GPT-base training steps in bfloat16,
  bench.py's ``fused_b8`` (chunked CE) and this slice's main path
  ``fused_b8_pallas_ce`` (the fused CE kernels), profiling three steps of
  each; three more of the latter inside ``telemetry.scope`` with the
  profiler on, checking the run's four artifacts, a calibration fit and
  the one-rank merge (``telemetry``); its checkpoint: six steps with
  ``CheckpointManager`` saves after steps 3 and 6, a byte of step 6
  inverted, a fresh trainer restored (falling back to step 3) and
  resumed bit for bit (``checkpoint``); the main path again with dh and
  dw on the staged route as a yardstick for its losses; then bench.py's
  other single-card variants
  (``dense_b8``, ``fused_b32``, ``fused_b32_remat``, and ``fused_b8`` with
  gradient merge over two chunks);
- data parallelism over an NCCL process group of one rank: the
  compressed gradient exchange of real GPT-base gradients under fp32,
  bf16, int8 and int4, held bit for bit against the same calls on the CPU
  over gloo, with its time, the card's busy time in it and its wire model
  (``dp_exchange``);
  bench.py's ``fused_b8_int8dp`` and ``fused_b8_int4dp`` and int8 with
  four buckets (every bucket issued inside the backward), each against
  ``fused_b8``'s losses and time (``train_dp``); loss scaling under ``auto_cast(bfloat16)`` with one
  tainted step, against the reference's scale sequence (``amp``);
- resilience, after ``async_checkpoint``: the main path under
  ``run_resilient`` with the replica integrity check every 2 steps and
  the asynchronous pipeline with its deep tier: an uninterrupted run, and
  one with a torn commit (an in-process restart), a NaN-skipped step and a
  SIGTERM drain resumed on a fresh trainer, bit for bit the same; the
  engine's fingerprints on the card against the CPU's; ``replay_step``
  saying ``ok`` for a clean step and ``sdc`` for a flipped one; the hang
  watchdog firing once (``resilient``);
- the serving tier, after ``resilient`` (``serving_tier``): a depth-2
  GPT-base-width model saved by ``jit.save`` and served by a ``Predictor``
  against the JAX package's Predictor (``predictor_golden.json``); full
  GPT-base as float32 and bfloat16 artifacts, Predictors over them raw
  and under int8/int4 weights (the flash forward inside the exported
  program on its scalar and its mma route), each against the eager module
  or the float32 Predictor, timed at rows 1, 2 and 4, with export, save
  and load seconds; ``InferenceServer.from_config`` primed from an
  ``ExecutorCache`` with no recompile; a ``ServingFleet`` of int8
  Predictors that promotes a good checkpoint step, rolls back a NaN one,
  scales up on a burst and down when idle, and drains on SIGTERM; a fleet
  of ``DecodeServer``s against the dense oracle; the admission seeded
  from ``calibration.fit(serving_samples=...)``;
- ZeRO, after ``serving_tier`` (``zero``): the main path built through
  the fleet API (``fleet.init`` with every degree 1 and
  ``strategy.sharding``, ``distributed_model``, ``distributed_optimizer``,
  ``sharding.group_sharded_parallel`` at ``os``/``os_g``/``p_g_os``,
  ``sharding.build_trainer``) on an NCCL mesh of one rank, stages 0-3,
  2 warm-up and 3 timed steps each: losses and final parameters of
  stages 1-3 bit for bit stage 0's, step times and peak memory per stage,
  the six training kernels' launches counted; step 3 of stage 3 saved
  through ``CheckpointManager`` (a state of one rank: the one-rank
  format, as the format follows the state) and resumed on a fresh
  fleet-built trainer bit for bit.

- tensor, pipeline and context parallelism, after ``zero``
  (``hybrid``): ``GPTForPretraining(tensor_parallel=True)`` under
  ``TensorParallel`` at ``mp_degree`` 1 through the fleet API against
  ``dense_b8`` on the same weights; ``PipelineLayer`` of
  ``gpt_pipeline_descs`` at one stage under GPipe and 1F1B, bit for bit
  each other and the trainer's gradient merge; the ring attention's block
  steps over four chunks of a 4096-row sequence against the flash kernels
  over the whole sequence, with their device times and launches.

- the high-level API, after ``vision`` (``hapi``; lines ``hapi_a1`` to
  ``hapi_a3``): (a1) GPT-base in bf16 through ``hapi.Model.fit`` over a
  ``DataLoader`` of seeded token batches against ``fused_b8_pallas_ce``'s
  trainer on the same weights and batches: 12 launches of each flash
  kernel and one of each CE kernel a step (the ``kernels`` line's
  ``launches_by_path["hapi"]``), the losses within ``HAPI_LOSS_RTOL``,
  both steps timed and profiled; (a2) MobileNetV2 under ``amp_configs=
  "O1"`` at 128 x 224^2 through ``Model.fit``, fed by the loading process
  and by DataLoader workers (min(8, usable cores - 1)) that draw and
  transform each image, each run timed only after the batches its loader
  can hold ready (``fed_ahead``), against the same step on one batch
  already on the card: images/s, the loader's wait a step, the busy share
  of a profiled fed step; (a3) LeNet's
  fit with ``ModelCheckpoint`` and ``EarlyStopping`` against the
  reference's (``hapi_golden.json``), ``evaluate`` and ``predict`` against
  the same Model on the CPU, ``save`` on the card and ``load`` on the CPU.

- BERT/ERNIE, after ``analysis`` (``text``): the golden at BERT-base
  widths, depth 2, float32 (``bert_golden.json``); bench.py's
  ``bert_base_amp`` (BERT-base, bf16, 16 x 128: every attention refused
  by the flash gate, counted) and the same model at 16 x 512 (each flash
  kernel 12 times a step, non-causal, on the mma route); the flash
  kernels at BERT's shape against their plain versions, timed;
- recommendation and the parameter server (``rec``): bench.py's
  ``widedeep_ctr`` and ``heter_ctr`` (the host table against the hot
  tier on the card, its overlapped loop bit for bit the serial one), and
  a server process driven through the fleet lifecycle, Wide&Deep training
  over it, its rows bit for bit a local table's given the same pulls and
  pushes. The analysis phase lints BERT's step at S 128 and 512;
- the declarative mode (``static``, after ``amp``): GPT-base's forward
  staged by ``jit.to_static`` (12 flash-forward nodes and launches a
  call, logits against the eager forward), a ``static.Program`` of
  ``fused_head_loss(ce_kernel="pallas")``'s loss and parameter gradients
  run 10 steps by ``Executor.run`` with AdamW (36 flash and 3 CE launches
  a step, losses against ``fused_b8_pallas_ce``'s trainer, both steps
  timed, its analysis), and converted ``if``/``while``/``for`` functions
  and a converted layer's ``jit.save``/``jit.load`` on the card;
- ONNX export, after ``mt`` (``onnx``): ResNet-50 in float32 exported with
  a dynamic batch (53 ``Conv`` nodes), the file evaluated on the card at
  batch 4 by ``testdata/onnx_eval.py`` against the eager forward
  (``ONNX_R50_TOL``); the GPT-base trunk in float32 at S 1024, whose
  eager forward launches the flash forward 12 times, exported with the
  flash node mapped to its plain subgraph (no custom op in the file) and
  evaluated against that forward (``ONNX_GPT_TOL``); a layer calling
  ``torch.sort`` falling back, with the warning, to the ``jit.save``
  artifact, which ``jit.load`` runs on the card; export seconds and file
  sizes;
- the small modules, after ``onnx`` (``incubate``; lines ``incubate_i1``
  to ``incubate_i6``): (i1) GPT-base in ``fused_b8_pallas_ce``'s trainer
  2:4-pruned by ``incubate.asp`` with the AdamW ``decorate``d, 5 steps:
  every pruned weight 2:4 and every pruned position zero after each, 36
  flash and 3 CE launches a step, the pruned step timed beside the
  unpruned; (i2) ``LookAhead`` and ``ModelAverage`` beside AdamW on a
  narrow GPT against ``incubate_golden.json``; (i3) ``Normal``,
  ``Uniform`` and ``Categorical`` drawing 10^6 samples each, their
  moments and ``log_prob`` against the CPU; (i4) the masked softmax at
  GPT-base's score shape against float64, timed; (i5) a host custom op
  built by ``cpp_extension.load`` with g++, forward and gradient on CUDA
  tensors against the CPU, the µs of its round trip; (i6) ``run_check``,
  ``get_device``, ``CUDAPlace`` and ``check_numerics`` on the card.

Prints one JSON object per line; the line before the last is the
``{"kernels": [...]}`` summary, the last is ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero and never
prints ``"ok": true``. Without a CUDA device it fails at once. Imports
torch, numpy and ``paddle_tpu_torch`` only.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# raw (acc, m, l) and final outputs, kernel vs plain, both float32 math:
# the two take their sums in different orders. It holds for bfloat16 pools
# too: both versions upcast the same bfloat16 values exactly and then do
# float32 math
ATOL, RTOL = 1e-4, 1e-4
# query widths the kernel sees: 1 (decode), the executor's power-of-two
# buckets of a uniform chunk (2..32), and an unbucketed 5 (1 + K, K = 4)
PARITY_TQ = (1, 2, 4, 5, 8, 16, 32)
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12         # bf16 dense tensor cores
LEAD_CYCLES = 1_000_000          # ~0.5 ms of spinning at the H100's clocks
# the depth of the GPT-base trainers the analysis phase's planner stages
# and times (its top three one-card plans): cut to 4 of 12 layers, which
# keeps each plan's trace and timed steps to a few seconds
PLAN_LAYERS = 4

SRC = "paddle_tpu_torch/csrc/paged_attention.cu"
FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
CE_SRC = "paddle_tpu_torch/csrc/fused_ce.cu"
SOURCES = (SRC, FLASH_SRC, CE_SRC)
REPLACES = {"decode": "paddle_tpu/ops/pallas/paged_attention.py:141",
            "verify": "paddle_tpu/ops/pallas/paged_attention.py:191",
            "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:102",
            "flash_dq": "paddle_tpu/ops/pallas/flash_attention.py:205",
            "flash_dkv": "paddle_tpu/ops/pallas/flash_attention.py:247",
            "ce_fwd": "paddle_tpu/ops/pallas/fused_ce.py:59",
            "ce_dh": "paddle_tpu/ops/pallas/fused_ce.py:109",
            "ce_dw": "paddle_tpu/ops/pallas/fused_ce.py:138"}
# flash kernel vs plain: float32 math in both, sums in other orders
# (float32); one bfloat16 rounding of each output (bfloat16)
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# the tensor-core forward against the plain version, beside FLASH_TOL, on
# every bf16 case: ||out - plain|| / ||plain|| over the whole output and
# max |lse - plain lse|, each held at a few times the largest that sound
# runs read (PERF.md §6); a skipped K tile reads far above both
MMA_FWD_BOUND = {"out_rel": 8e-3, "lse_abs": 5e-6}
# the tensor-core dq and dk/dv (through the autograd path, on the mma
# forward's out and lse) against the plain backward, beside FLASH_TOL, on
# every bf16 case: ||g - plain|| / ||plain|| of each gradient. About three
# times the largest reading of a CPU model of the route's bf16 roundings
# (p, ds and the forward's p; tests/test_torch_flash_bwd_rounding.py:
# 2.5e-3 to 3.24e-3, 2.86e-3 since the dropout scale stays out of p), set
# before any card run and never raised after one
MMA_BWD_BOUND = {"dq_rel": 1e-2, "dk_rel": 1e-2, "dv_rel": 1e-2}
FLASH_SEED = 7
# fused-CE kernel vs plain, as errors normalized by the plain tensor's
# largest magnitude (the 1/denom factor makes dh and dw small): float32
# math in both (float32), one bfloat16 rounding of each output (bfloat16);
# lse and tgt are float32 in both: atol 1e-4
CE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CE_STAT_ATOL = 1e-4
# the amp phase: GPT-base widths at depth 2, float32 master weights under
# auto_cast(bfloat16) and this GradScaler; the step at index 2 is tainted
# with inf. The scale after each step and the one skip are the values the
# JAX reference gives (pinned on the CPU by tests/test_torch_amp.py)
AMP_SCALER = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                  decr_every_n_nan_or_inf=1)
AMP_TAINTED = (2,)
AMP_SCALES = (32768.0, 65536.0, 32768.0, 32768.0, 65536.0)
# train_dp: the largest relative gap between a quantized run's losses and
# fused_b8's over the same 10 timed steps, by policy. Ten times the gap of
# the same comparison on the CPU at depth 2 and narrow widths (bf16, 12
# steps; tests/test_torch_data_parallel.py::test_quantized_loss_band)
DP_LOSS_BAND = {"int8": 1e-3, "int4": 3.5e-2}
# eager: the port's optimizers on the card against the JAX reference's
# (optimizer_golden.json), the CPU tests' bar (tests/test_torch_optimizer.py)
OPT_TOL = (1e-5, 1e-7)      # rtol, atol
# serving_tier: the card's float32 Predictor against the JAX package's (the
# golden file; float32 on the CPU there, float32 with TF32 off here: sums
# in other orders), abs on the logits and their logsumexp; a served answer
# against a direct Predictor.run of the same rows (a padded bucket runs
# other GEMM shapes), abs
PREDICTOR_GOLDEN_TOL = 1e-4
SERVER_TOL = 1e-4
# a replica's per-call deadline: the first server's first batch at each
# bucket is the program's first call at that shape on its worker thread;
# servers built later are primed from the executor cache before traffic
SERVING_CALL_TIMEOUT_S = 60.0
SERVING_ROWS = (1, 2, 4)
# the fleet scales up on queue depth (a burst), not on a modeled wait
# that one GPT-base batch reaches; the canary's latency slack covers a
# GPT-base call (FleetConfig's defaults are sized for the CPU)
FLEET_SCALE_UP_WAIT_S = 1.0
FLEET_CANARY_SLACK_S = 0.25
# live traffic during the hot swaps: one 1-row request every 20 ms
FLEET_PUMP_INTERVAL_S = 0.02
# the fused-CE kernels by name (no name holds another)
CE_KERNELS = ("ce_fwd_tiled_kernel", "ce_fwd_merge_kernel", "ce_fwd_kernel",
              "ce_dh_kernel", "ce_dw_kernel", "ce_bwd_tiled_kernel")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=25, warmup=5, flush=None, lead=False):
    """Median device time of one call (CUDA events), L2 flushed before
    each timed call when ``flush`` is given. ``lead``: a spin kernel of
    about 0.5 ms runs before the start event, so that the call's host-side
    work is queued behind it and the events time the device alone (for
    calls of a few microseconds, where the host would otherwise keep the
    card waiting inside the timed interval)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def paged_inputs(rs, tq, dtype, lens, b=8, h=12, d=64, ps=16, w=64,
                 p=2048):
    """q, pools, tables and lens on the card: random pools, shuffled pages,
    slots past each row's pages set to -1 or P+7."""
    dev = "cuda"
    q = torch.as_tensor(rs.randn(b, tq, h, d).astype(np.float32), device=dev)
    kp = torch.as_tensor(rs.randn(p, ps, h, d).astype(np.float32),
                         device=dev).to(dtype)
    vp = torch.as_tensor(rs.randn(p, ps, h, d).astype(np.float32),
                         device=dev).to(dtype)
    tab = np.stack([rs.permutation(p)[:w] for _ in range(b)]).astype(np.int32)
    for i, n in enumerate(lens):
        used = -(-min(n, w * ps) // ps)
        tab[i, used:] = -1 if i % 2 == 0 else p + 7
    tab = torch.as_tensor(tab, device=dev)
    ln = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    return q, kp, vp, tab, ln


def _raw_errs(got, want, what):
    errs = {}
    for name, g, r in zip(("acc", "m", "l"), got, want):
        check(torch.isfinite(g).all().item(), f"{what}: {name} not finite")
        check(torch.allclose(g, r, atol=ATOL, rtol=RTOL),
              f"{what}: raw {name} max err {(g - r).abs().max().item()}")
        errs[name] = (g - r).abs().max().item()
    return max(errs.values())


def nan_outside(pool, tab, ln):
    """``pool`` with NaN in every slot that no row's context reaches:
    unused pages and the tail of each row's last page."""
    p, ps = pool.shape[:2]
    used = torch.zeros((p, ps), dtype=torch.bool, device=pool.device)
    w = tab.shape[1]
    pos = torch.arange(w * ps, device=pool.device)
    for row, n in zip(tab.long(), ln.tolist()):
        mine = pos[:min(n, w * ps)]
        used[row.clamp(0, p - 1)[mine // ps], mine % ps] = True
    return torch.where(used[..., None, None], pool,
                       torch.full_like(pool, float("nan")))


def parity_case(pa, rs, tq, dtype, lens, b=8, h=12, d=64, ps=16, w=64,
                p=2048):
    """Both routes against the plain version on one input: the split route
    at its own split count and forced to 1, 2 and the table width, on the
    pools and on the pools with NaN wherever no context reaches; the
    simple route; then the dispatcher's final output against the gather
    path. Returns the max abs errors."""
    q, kp, vp, tab, ln = paged_inputs(rs, tq, dtype, lens, b, h, d, ps, w, p)
    kn = torch.as_tensor(rs.randn(b, tq, h, d).astype(np.float32),
                         device="cuda")
    vn = torch.as_tensor(rs.randn(b, tq, h, d).astype(np.float32),
                         device="cuda")
    want = pa.paged_attention_plain(q, kp, vp, tab, ln)
    key = "decode" if tq == 1 else "verify"
    what = f"tq={tq} {dtype} lens={lens}"
    errs = {}
    r0 = dict(pa.ROUTES)
    errs["split"] = _raw_errs(pa.paged_attention(q, kp, vp, tab, ln), want,
                              f"split {what}")
    check(pa.ROUTES[f"{key}_split"] == r0[f"{key}_split"] + 1,
          f"{what}: the default route is not split")
    nan_k, nan_v = nan_outside(kp, tab, ln), nan_outside(vp, tab, ln)
    for splits in (1, 2, w):
        errs[f"split_{splits}"] = _raw_errs(
            pa.paged_attention(q, kp, vp, tab, ln, splits=splits), want,
            f"split={splits} {what}")
        errs[f"split_{splits}_nan_pool"] = _raw_errs(
            pa.paged_attention(q, nan_k, nan_v, tab, ln, splits=splits),
            want, f"split={splits} NaN pool {what}")
    errs["split_nan_pool"] = _raw_errs(
        pa.paged_attention(q, nan_k, nan_v, tab, ln), want,
        f"split NaN pool {what}")
    errs["simple"] = _raw_errs(
        pa.paged_attention(q, kp, vp, tab, ln, route="simple"), want,
        f"simple {what}")
    torch.cuda.synchronize()
    for new in (False, True):
        extra = dict(k_new=kn, v_new=vn) if new else {}
        out = pa.paged_decode_attention(q, kp, vp, tab, ln, kernel="kernel",
                                        **extra)
        ref = pa.paged_decode_attention(q, kp, vp, tab, ln, kernel="gather",
                                        **extra)
        check(torch.allclose(out, ref, atol=ATOL, rtol=RTOL),
              f"final tq={tq} {dtype} new={new}: max err "
              f"{(out - ref).abs().max().item()}")
        errs["final_new" if new else "final"] = (out - ref).abs().max().item()
    return errs


def paged_repeat(pa, rs, tq, ctx=1024, b=8):
    """Repeat launches of the split route at the main shape are
    bit-identical (no atomics, a fixed merge order)."""
    q, kp, vp, tab, _ = paged_inputs(rs, tq, torch.float32, [ctx] * b, b=b)
    ln = torch.full((b,), ctx, dtype=torch.int32, device="cuda")
    first = [t.clone() for t in pa.paged_attention(q, kp, vp, tab, ln)]
    for _ in range(5):
        for f, g in zip(first, pa.paged_attention(q, kp, vp, tab, ln)):
            check(torch.equal(f, g), f"split route tq={tq}: repeat launches "
                                     "differ")
    return True


def kernel_timing(pa, rs, tq, flush, b=8, dtype=torch.float32, h=12, d=64,
                  ps=16, w=64, p=2048, ctx=1024, sweep=()):
    """The split route (at the formula's split count, ``ms``; at the count
    the tuning DB resolves, ``tuned_ms``, as the main path calls it; and
    at each count of ``sweep``), the simple route, plain and library times
    at one shape, each behind a lead spin (device time alone); every row's
    context is ``ctx`` tokens, so the kernels read b*ctx*h*d of K and of
    V."""
    q, kp, vp, tab, _ = paged_inputs(rs, tq, dtype, [ctx] * b, b, h, d, ps,
                                     w, p)
    ln = torch.full((b,), ctx, dtype=torch.int32, device="cuda")
    # library yardstick: one fused attention call on the same K/V, already
    # gathered contiguous (it excludes the gather; the port never calls it)
    kc = pa._gather_ctx(kp, tab)[:, :ctx].transpose(1, 2).contiguous()
    vc = pa._gather_ctx(vp, tab)[:, :ctx].transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous().to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    key = "decode" if tq == 1 else "verify"
    formula = pa.paged_splits(b, h, w, ps, sm_count())
    tuned = pa.route_splits(dtype, b, tq, h, d, ps, w, sm_count())
    ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tab, ln,
                                            splits=formula),
                 flush=flush, lead=True)
    # the call as the main path makes it: the count resolved from the DB
    r0, s0 = dict(pa.ROUTES), pa.SPLITS[(key, tuned)]
    tuned_ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tab, ln),
                       flush=flush, lead=True)
    check(pa.ROUTES[f"{key}_split"] > r0[f"{key}_split"] and
          pa.ROUTES[f"{key}_simple"] == r0[f"{key}_simple"] and
          pa.SPLITS[(key, tuned)] > s0,
          f"timing tq={tq}: the split route at {tuned} splits was not "
          "taken")
    simple_ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tab, ln,
                                                   route="simple"),
                        flush=flush, lead=True)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q, kp, vp, tab, ln),
                       flush=flush, lead=True)
    library_ms = time_ms(lambda: sdpa(qt, kc, vc), flush=flush, lead=True)
    sweep_ms = {str(n): time_ms(lambda: pa.paged_attention(
        q, kp, vp, tab, ln, splits=n), flush=flush, lead=True)
        for n in sweep}
    # the same call with every row empty: launches and fixed work only
    ln0 = torch.zeros_like(ln)
    empty_ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tab, ln0),
                       flush=flush, lead=True)
    from paddle_tpu_torch.analysis.cost import paged_work
    # K and V context read once, q, tables, lens read once, acc, m, l
    # written once; QK^T and PV (the cost model's price of the node, at
    # this run's context lengths)
    flops, moved = paged_work(b, h, tq, ctx, d, kp.element_size(),
                              tab.numel(), q.element_size())
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    return {"tq": tq, "b": b, "pools": str(dtype).split(".")[-1],
            "splits": formula, "ms": ms, "tuned_splits": tuned,
            "tuned_ms": tuned_ms, "empty_ms": empty_ms,
            "simple_ms": simple_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": moved, "flops": flops,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "over_bound": ms / bound, "library_over_split": library_ms / ms,
            "simple_over_split": simple_ms / ms, "splits_ms": sweep_ms}


def oracle_margins(params, prompt, generated):
    """Top-2 logit margin of the dense oracle at each generated position
    (one causal forward over prompt + generated[:-1], on the card)."""
    p = params
    h, d = p["num_heads"], p["head_dim"]
    toks = list(prompt) + list(generated[:-1])
    t = len(toks)
    with torch.no_grad():
        x = p["embed"][torch.tensor(toks, device="cuda")] + p["pos"][:t]
        q = (x @ p["wq"]).reshape(t, h, d)
        k = (x @ p["wk"]).reshape(t, h, d)
        v = (x @ p["wv"]).reshape(t, h, d)
        s = torch.einsum("thd,uhd->htu", q / np.sqrt(d), k)
        causal = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        s = torch.where(causal[None], s, torch.full_like(s, -1e30))
        o = torch.einsum("htu,uhd->thd", torch.softmax(s, -1), v)
        y = x + o.reshape(t, h * d) @ p["wo"]
        logits = y[len(prompt) - 1:] @ p["head"]
        top2 = torch.topk(logits, 2).values
        check(torch.equal(logits.argmax(-1).cpu(),
                          torch.tensor(generated)),
              "oracle full forward disagrees with dense_generate")
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def serve(srv_cls, params, prompts, max_new, srv_kw, pa, dm, kvc, serving,
          tuner):
    """Warm up on prompts[0], zero the kernel counts, serve prompts[1:]
    concurrently, read the counts. Returns (outputs, report)."""
    cache = kvc.PagedKVCache(num_pages=2048, page_size=16, num_heads=12,
                             head_dim=64)
    step = dm.make_step_fn(params, cache)
    cfg = serving.ServingConfig(max_batch=256, call_timeout_s=10.0)
    srv = srv_cls(step, cache, replicas=2, config=cfg, prefill_chunk=32,
                  max_pages_per_seq=64, max_batch_rows=8, **srv_kw)
    with srv:
        warm = srv.submit_generate(prompts[0], max_new).result(timeout=300)
        hits0 = cache.prefix_hit_tokens
        calls0 = [f.calls for f in step.jit_fns]
        torch.cuda.synchronize()
        for counts in (pa.LAUNCHES, pa.ROUTES):
            for k in counts:
                counts[k] = 0
        pa.SPLITS.clear()
        tuner.FALLBACKS.clear()
        t0 = time.perf_counter()
        reqs = [srv.submit_generate(pr, max_new) for pr in prompts[1:]]
        outs = [[int(t) for t in r.result(timeout=600)[0]] for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        routes = dict(pa.ROUTES)
        splits = {f"{k}:{n}": c for (k, n), c in sorted(pa.SPLITS.items())}
        fallbacks = tuner.FALLBACKS["paged_attention"]
        lat = sorted(r.latency for r in reqs)
        stats = srv.stats()
        check(srv.accounted(), "server accounting does not close")
    st = cache.stats()
    check(st["pages_used"] == st["evictable"],
          f"pages leaked after drain: {st}")
    report = {
        "launches": launches, "routes": routes, "splits": splits,
        "fallbacks": fallbacks,
        "prefix_hit_tokens": cache.prefix_hit_tokens - hits0,
        "decode_tokens_per_s": len(reqs) * max_new / wall,
        "wall_s": wall,
        "latency_p50_s": lat[len(lat) // 2],
        "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "steps": {f.name: f.calls - c0 for f, c0 in zip(step.jit_fns,
                                                         calls0)},
        "verify_shapes": [list(s[0]) for s in step.jit_fns[2].shapes()],
        "failovers": stats["failovers"],
        "kv_cache": st,
        "spec_decode": stats.get("spec_decode"),
    }
    return [[int(t) for t in warm[0]]] + outs, report


@contextlib.contextmanager
def paged_route_forced(pa, route):
    """Within the block, every paged launch takes ``route`` (the split
    route's yardstick), after the main path's own counted run."""
    picked = pa.paged_route
    pa.paged_route = lambda dtype, d, aligned: route
    try:
        yield
    finally:
        pa.paged_route = picked


def check_split_routes(rep):
    """Every decode and verify launch of a serving run took the split
    route."""
    launches, routes = rep["launches"], rep["routes"]
    for key in ("decode", "verify"):
        check(routes[f"{key}_split"] == launches[key] and
              routes[f"{key}_simple"] == 0,
              f"serving {key}: {launches[key]} launches, routes {routes}")


def _device_time(prof):
    """Kernel time on the card from a torch.profiler run: per kernel name
    (device us, launches), largest first, and the busy time, the union of
    all device intervals in us (host-side op rows are not counted, so no
    kernel is counted twice)."""
    from torch.autograd import DeviceType
    by_name, spans = {}, []
    for e in prof.events():
        # a range on the device's timeline (ProfilerStep#) is no kernel
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + end - start, n + 1)
        spans.append((start, end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()),
                  reverse=True)
    return rows, busy


def _profile_report(prof, wall):
    rows, busy_us = _device_time(prof)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall if rows else None,
            "top": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:8]]}, rows


def profile_serving(params, prompts, max_new, dm, kvc, serving):
    """Device time by kernel and the device's busy share over a steady
    serving window (torch.profiler); the serve() set-up, not timed here."""
    from torch.profiler import ProfilerActivity, profile
    cache = kvc.PagedKVCache(num_pages=2048, page_size=16, num_heads=12,
                             head_dim=64)
    step = dm.make_step_fn(params, cache)
    srv = serving.DecodeServer(
        step, cache, replicas=2,
        config=serving.ServingConfig(max_batch=256, call_timeout_s=10.0),
        prefill_chunk=32, max_pages_per_seq=64, max_batch_rows=8)
    with srv:
        srv.submit_generate(prompts[0], max_new).result(timeout=300)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reqs = [srv.submit_generate(pr, max_new) for pr in prompts[1:]]
            for r in reqs:
                r.result(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rep, rows = _profile_report(prof, wall)
    paged = [(us, name, n) for us, name, n in rows if "paged_" in name]
    rep["paged_device_ms"] = sum(us for us, _, _ in paged) / 1e3
    rep["paged_by_kernel"] = [{"name": name[:80], "device_ms": us / 1e3,
                               "count": n} for us, name, n in paged]
    return rep


# ---------------------------------------------------------------------------
# training: flash kernels and GPT-base steps
# ---------------------------------------------------------------------------

def flash_parity_case(fa, rs, s, d, causal, lens, dtype, rate=0.0, b=2, h=4,
                      split_qkv=False):
    """Kernel vs plain on the card: forward (out, lse) and, through the
    registered op's autograd, backward (dq, dk, dv). With ``split_qkv`` q, k and v
    are what GPTAttention hands the kernels: strided views of one
    (B, S, H, 3*D) tensor, split per head. On the mma route the scalar
    kernels run on the same inputs beside it (the backward on the mma
    forward's out and lse). Returns the max abs errors, on the mma route
    also the relative errors that :data:`MMA_FWD_BOUND` and
    :data:`MMA_BWD_BOUND` hold, and the forward's and backward's routes."""
    dev = "cuda"
    rand = lambda *shape: torch.as_tensor(  # noqa: E731
        rs.randn(*shape).astype(np.float32), device=dev).to(dtype)
    if split_qkv:
        qkv = rand(b, s, h, 3 * d)
        q, k, v = torch.split(qkv, d, dim=-1)
        check(not q.is_contiguous() and q.stride(2) == 3 * d,
              f"q is not the QKV split's view: strides {q.stride()}")
        qkv_g = qkv.clone().requires_grad_()
        leaves = (qkv_g,)
        qg, kg, vg = torch.split(qkv_g, d, dim=-1)
    else:
        q, k, v = rand(b, s, h, d), rand(b, s, h, d), rand(b, s, h, d)
        qg, kg, vg = leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    do = rand(b, s, h, d)
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    seed = FLASH_SEED
    blocks = fa.keying_blocks(dtype, d, s, s)
    # the random tensors and the QKV split's views are 16-byte aligned
    route = fa.fwd_route(dtype, d, True)
    broute = fa.bwd_route(dtype, d, True)
    r0 = dict(fa.ROUTES)
    out, lse = fa.flash_attention_fwd(q, k, v, ln, seed, None, causal, rate,
                                      blocks)
    ref_out, ref_lse = fa.flash_attention_plain_fwd(q, k, v, ln, seed, None,
                                                    causal, rate, blocks)
    out2 = fa.flash_attention(qg, kg, vg, causal=causal, kv_lens=ln,
                              dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad(out2, leaves, do)
    if split_qkv:
        grads = torch.split(grads[0], d, dim=-1)
    ref_grads = fa.flash_attention_plain_bwd(q, k, v, ref_out, ref_lse, do, ln,
                                             seed, None, causal, rate, blocks)
    torch.cuda.synchronize()
    routes = {key: fa.ROUTES[key] - r0[key] for key in r0}
    want = {f"flash_fwd_{route}": 2, f"flash_dq_{broute}": 1,
            f"flash_dkv_{broute}": 1}
    check(routes == {key: want.get(key, 0) for key in routes},
          f"flash routes {routes}, want {want} (s={s} d={d} {dtype})")
    names = ["out", "lse", "out_autograd", "dq", "dk", "dv"]
    gots, refs = [out, lse, out2, *grads], [ref_out, ref_lse, ref_out,
                                            *ref_grads]
    if route == "mma":    # the scalar kernels on the same inputs, beside it
        names += ["out_scalar_route", "lse_scalar_route"]
        gots += list(fa.flash_attention_fwd(q, k, v, ln, seed, None, causal,
                                            rate, blocks, route="scalar"))
        refs += [ref_out, ref_lse]
    if broute == "mma":
        names += ["dq_scalar_route", "dk_scalar_route", "dv_scalar_route"]
        gots += list(fa.flash_attention_bwd(q, k, v, out, lse, do, ln, seed,
                                            None, causal, rate, blocks,
                                            route="scalar"))
        refs += list(ref_grads)
    atol, rtol = FLASH_TOL[dtype]
    errs = {}
    for name, g, r in zip(names, gots, refs):
        g, r = g.float(), r.float()
        check(torch.isfinite(g).all().item(), f"kernel {name} not finite")
        errs[name] = (g - r).abs().max().item()
        check(torch.allclose(g, r, atol=atol, rtol=rtol),
              f"flash {name} s={s} d={d} causal={causal} lens={lens} "
              f"{dtype} rate={rate} split_qkv={split_qkv}: max err "
              f"{errs[name]}")
    if route == "mma":
        for name in ("out", "out_autograd", "out_scalar_route"):
            g = gots[names.index(name)].float()
            errs[f"{name}_rel"] = ((g - ref_out.float()).norm() /
                                   ref_out.float().norm().clamp_min(1e-30)
                                   ).item()
        worst = max(errs["out_rel"], errs["out_autograd_rel"])
        check(worst <= MMA_FWD_BOUND["out_rel"] and
              errs["lse"] <= MMA_FWD_BOUND["lse_abs"],
              f"flash mma forward s={s} d={d} causal={causal} lens={lens} "
              f"rate={rate}: relative out error {worst}, lse error "
              f"{errs['lse']} against {MMA_FWD_BOUND}")
    if broute == "mma":
        for i, name in enumerate(("dq", "dk", "dv")):
            r = ref_grads[i].float()
            for key in (name, f"{name}_scalar_route"):
                g = gots[names.index(key)].float()
                errs[f"{key}_rel"] = ((g - r).norm() /
                                      r.norm().clamp_min(1e-30)).item()
        bad = {n: errs[f"{n}_rel"] for n in ("dq", "dk", "dv")
               if errs[f"{n}_rel"] > MMA_BWD_BOUND[f"{n}_rel"]}
        check(not bad, f"flash mma backward s={s} d={d} causal={causal} "
              f"lens={lens} rate={rate}: relative errors {bad} against "
              f"{MMA_BWD_BOUND}")
    return errs, route, broute


def _qkv_views(b, s, h, d, seed=0):
    """q, k, v as GPTAttention hands them to the kernels (strided views of
    one (B, S, H, 3*D) bf16 tensor) and a (B, S, H, D) output gradient."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qkv, do = [torch.randn(b, s, h, n * d, device="cuda", generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
               for n in (3, 1)]
    return (*torch.split(qkv, d, dim=-1), do)


def _fwd_bound(b, h, s, d, e=2, causal=True):
    """The forward's least time on this card: 2 products of B*H*S*S*D
    multiply-adds (2 FLOPs each; half of them causal) against q, k, v read
    and out written once plus lse (``analysis.cost.flash_fwd_work``, the
    cost model's price of the kernel node)."""
    from paddle_tpu_torch.analysis.cost import flash_fwd_work
    flops, moved = flash_fwd_work(b, h, s, s, d, e, causal=causal)
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    return flops, moved, max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def flash_fwd_routes_timing(fa, flush, b, h, s, d, causal=True):
    """The forward at one shape (bf16, QKV split views): its plain
    version, the tensor-core kernel, the scalar kernel and SDPA's forward,
    one after another in this run, with the bound."""
    q, k, v, _ = _qkv_views(b, s, h, d)
    rest = (None, 0, None, causal, 0.0, fa.keying_blocks(q.dtype, d, s, s))
    plain = time_ms(lambda: fa.flash_attention_plain_fwd(q, k, v, *rest),
                    reps=5, flush=flush)
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, *rest, route="mma"),
                 flush=flush)
    scalar = time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, *rest, route="scalar"), flush=flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
    lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), flush=flush)
    flops, moved, bound, bound_by = _fwd_bound(b, h, s, d, causal=causal)
    return {"shape": [b, s, h, d], "fwd_route": "mma", "ms": ms,
            "scalar_ms": scalar, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound,
            "bound_by": bound_by, "flops": flops, "bytes": moved,
            "tflops": flops / ms / 1e9, "scalar_over_mma": scalar / ms,
            "mma_over_library": ms / lib}


def flash_bwd_routes_timing(fa, flush, b, h, s, d, causal=True):
    """dq and dk/dv at one shape (bf16; q, k, v the QKV split's
    strided views, as the main path gives them), each on the mma and the
    scalar route, beside each kernel's plain version and the library's
    whole backward (SDPA's; no library call computes dq or dk/dv alone),
    one after another in this run, with each kernel's bound on this card.
    Returns ({"flash_dq": ..., "flash_dkv": ...}, the whole backward's
    numbers)."""
    q, k, v, do = _qkv_views(b, s, h, d)
    blocks = fa.keying_blocks(q.dtype, d, s, s)
    out, lse = fa.flash_attention_fwd(q, k, v, None, 0, None, causal, 0.0,
                                      blocks)
    delta = fa._delta(out, do)
    rest = (None, 0, None, causal, 0.0, blocks)
    launch = {"flash_dq": fa._launch_dq, "flash_dkv": fa._launch_dkv}
    ms = {name: time_ms(lambda fn=fn: fn(q, k, v, do, lse, delta, *rest,
                                         route="mma"), flush=flush)
          for name, fn in launch.items()}
    scalar = {name: time_ms(lambda fn=fn: fn(q, k, v, do, lse, delta, *rest,
                                             route="scalar"), flush=flush)
              for name, fn in launch.items()}

    # each kernel's plain version; both backward ones recompute ds
    def plain_dq():
        ds, _, scale = fa._plain_ds(q, k, v, out, lse, do, *rest)
        return fa._plain_dq(ds, q, k, scale)

    def plain_dkv():
        ds, p_drop, scale = fa._plain_ds(q, k, v, out, lse, do, *rest)
        return fa._plain_dkv(ds, p_drop, q, k, v, do, scale)

    plain = {"flash_dq": time_ms(plain_dq, reps=5, flush=flush),
             "flash_dkv": time_ms(plain_dkv, reps=5, flush=flush)}
    plain_bwd = time_ms(lambda: fa.flash_attention_plain_bwd(
        q, k, v, out, lse, do, *rest), reps=5, flush=flush)
    # library yardstick, (B, H, S, D) layout; the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = [x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v)]
    dot = do.transpose(1, 2).contiguous()
    o_lib = sdpa(qt, kt, vt, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), dot, retain_graph=True), flush=flush)
    lib_fwdbwd = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=causal), (qt, kt, vt), dot), flush=flush)
    from paddle_tpu_torch.analysis.cost import flash_bwd_work
    e = q.element_size()
    tensor = b * s * h * d * e                 # one (B, S, H, D) tensor
    stat = b * h * s * 4                       # lse or delta, float32
    # FLOPs of one S x S x D product (its causal half when causal)
    prod = b * h * s * s * d * (1 if causal else 2)
    # the cost model's prices of the two kernel nodes: 3 and 4 products
    work = {"flash_dq": flash_bwd_work("dq", b, h, s, s, d, e, causal),
            "flash_dkv": flash_bwd_work("dkv", b, h, s, s, d, e, causal)}
    bwd_ms = ms["flash_dq"] + ms["flash_dkv"]
    scalar_bwd = scalar["flash_dq"] + scalar["flash_dkv"]
    # no library call computes dq alone or dk/dv alone: the backward rows
    # carry library_ms null, and the whole backward (SDPA's, the plain one,
    # dq + dk/dv on each route) under keys of its own
    whole_bwd = {"bwd_ms": bwd_ms, "scalar_bwd_ms": scalar_bwd,
                 "plain_bwd_ms": plain_bwd, "library_bwd_ms": lib_bwd,
                 "bwd_over_library": bwd_ms / lib_bwd,
                 "scalar_bwd_over_mma": scalar_bwd / bwd_ms}
    res = {}
    for name, (flops, moved) in work.items():
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = moved / H100_BYTES_PER_S * 1e3
        res[name] = {
            "shape": [b, s, h, d], "bwd_route": "mma", "ms": ms[name],
            "scalar_ms": scalar[name], "flops": flops, "bytes": moved,
            "plain_ms": plain[name], "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms[name] / 1e9,
            "scalar_tflops": flops / scalar[name] / 1e9,
            "scalar_over_mma": scalar[name] / ms[name], **whole_bwd}
    # the backward as one minimal pass (scores, dp, dq, dk, dv: 5 products)
    bwd_bound = max(5 * prod / H100_BF16_FLOPS,
                    (5 * tensor + 3 * tensor + 2 * stat) / H100_BYTES_PER_S)
    return res, {"shape": [b, s, h, d], "bwd_minimal_bound_ms":
                 bwd_bound * 1e3, **whole_bwd, "sdpa_bwd_ms": lib_bwd,
                 "sdpa_fwd_bwd_ms": lib_fwdbwd}


def flash_timing(fa, flush, b=8, h=12, s=1024, d=64):
    """Each kernel on each of its routes, its plain version and the library
    call at one shape (GPT-base by default): :func:`flash_fwd_routes_timing`
    and :func:`flash_bwd_routes_timing`."""
    fwd = flash_fwd_routes_timing(fa, flush, b, h, s, d)
    res, extra = flash_bwd_routes_timing(fa, flush, b, h, s, d)
    return {"flash_fwd": fwd, **res}, {**extra,
                                       "sdpa_fwd_ms": fwd["library_ms"]}


# ---------------------------------------------------------------------------
# fused LM-head cross entropy: forward, dh and dw kernels
# ---------------------------------------------------------------------------

def ce_inputs(rs, n, h, v, dtype, ignore, transposed, out_of_range=False):
    """hid (n, h), w (h, v) (the .T view of a (v, h) tensor when
    ``transposed``, as the tied head gives it), labels with a share
    ``ignore`` of -100 (and, with ``out_of_range``, some of V + 3 and -5:
    target logit 0), and the backward's scale g * valid / denom."""
    dev = "cuda"
    hid = torch.as_tensor(rs.randn(n, h).astype(np.float32),
                          device=dev).to(dtype)
    w = torch.as_tensor((rs.randn(v, h) * 0.05).astype(np.float32),
                        device=dev).to(dtype)
    w = w.T if transposed else w.T.contiguous()
    lbl = rs.randint(0, v, n)
    lbl[rs.rand(n) < ignore] = -100
    if out_of_range:
        lbl[1::11] = v + 3
        lbl[2::13] = -5
    lbl = torch.as_tensor(lbl, device=dev)
    valid = (lbl != -100).float()
    return hid, w, lbl, valid / valid.sum().clamp(min=1.0)


def ce_parity_case(fc, hid, w, lbl, scale, twice=False):
    """Each kernel against its plain version on the same inputs; the
    forward must take the route ``fwd_route`` names for (dtype, H), dh and
    dw the one ``bwd_route`` names, and with ``twice`` a second launch must
    give every output bit for bit. Returns the max abs and normalized
    errors per kernel output, the routes and the forward's vocab splits."""
    n, h = hid.shape
    v = w.shape[1]
    r0 = dict(fc.ROUTES)
    lse, tgt = fc.ce_fwd(hid, w, lbl)
    ref_lse, ref_tgt = fc.fused_ce_plain_fwd(hid, w, lbl)
    dh = fc.ce_dh(hid, w, lbl, ref_lse, scale)
    dw = fc.ce_dw(hid, w, lbl, ref_lse, scale)
    ref_dh = fc.fused_ce_plain_dh(hid, w, lbl, ref_lse, scale)
    ref_dw = fc.fused_ce_plain_dw(hid, w, lbl, ref_lse, scale)
    torch.cuda.synchronize()
    fwd = fc.fwd_route(hid.dtype, h)
    route = fc.bwd_route(hid.dtype, h)
    routes = {k: fc.ROUTES[k] - r0[k] for k in r0}
    check(routes == {k: int(k in (f"ce_fwd_{fwd}", f"ce_dh_{route}",
                                  f"ce_dw_{route}")) for k in r0},
          f"routes {routes}, expected forward {fwd}, backward {route}")
    check(dh.dtype == hid.dtype and dw.dtype == w.dtype and
          dw.shape == w.shape, "dh/dw dtype or shape")
    check(dw.T.is_contiguous(), "dw is not the .T view of a (V, H) buffer")
    if twice:
        again = fc.ce_fwd(hid, w, lbl)
        check(torch.equal(lse, again[0]) and torch.equal(tgt, again[1]),
              "a second launch changed lse or tgt")
        check(torch.equal(dh, fc.ce_dh(hid, w, lbl, ref_lse, scale)) and
              torch.equal(dw, fc.ce_dw(hid, w, lbl, ref_lse, scale)),
              "a second launch changed dh or dw")
    tol = CE_TOL[hid.dtype]
    errs = {}
    for name, g, r in (("lse", lse, ref_lse), ("tgt", tgt, ref_tgt),
                       ("dh", dh, ref_dh), ("dw", dw, ref_dw)):
        g, r = g.float(), r.float()
        check(torch.isfinite(g).all().item(), f"kernel {name} not finite")
        err = (g - r).abs().max().item()
        norm = err / max(r.abs().max().item(), 1e-30)
        errs[name] = {"abs": err, "norm": norm}
        if name in ("lse", "tgt"):
            check(err <= CE_STAT_ATOL, f"ce {name}: max err {err}")
        else:
            check(norm <= tol, f"ce {name}: normalized err {norm} > {tol}")
    ignored = lbl == -100
    if ignored.any():
        check(dh[ignored].abs().max().item() == 0.0,
              "ignored rows have a nonzero dh")
    errs["route"] = route
    errs["fwd_route"] = fwd
    errs["splits"] = fc.tiled_splits(hid.dtype, n, h, v, sm_count()) \
        if fwd == "tiled" else None
    return errs


def ce_parity_cases():
    """``ce_parity``'s cases: (shape (N, H, V) or "main path", dtype,
    share of ignored labels, w the tied .T view, labels out of range).
    Every bfloat16 case with H a multiple of 64 takes the tiled forward."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, dtype, ignore, transposed, False)
             for shape in ((128, 64, 512), (200, 32, 500), (1000, 768, 50304))
             for dtype in (f32, bf16) for ignore in (0.0, 0.3, 1.0)
             for transposed in (False, True)]
    cases += [((300, 2048, 5000), bf16, 0.3, True, False),
              ((300, 2048, 5000), f32, 0.3, False, False)]
    # the tiled backward (bf16, H = 768 and 1024) with N and V tails, all
    # rows ignored, w strided (the tied .T view) and contiguous
    cases += [((1000, 768, 5003), bf16, 0.3, t, False) for t in (False, True)]
    cases += [((257, 1024, 50304), bf16, 0.3, t, False)
              for t in (False, True)]
    cases += [((100, 768, 700), bf16, 1.0, True, False),
              ((100, 1024, 700), bf16, 1.0, True, False)]
    # what the tiled forward's split rule makes new: one token past a
    # tile; V = 700, which the rule leaves in one split; labels V + 3 and
    # -5 (target logit 0)
    cases += [((129, 768, 5003), bf16, 0.3, True, False),
              ((300, 768, 700), bf16, 0.3, True, False),
              ((1000, 768, 5003), bf16, 0.3, True, True),
              ((300, 2048, 700), bf16, 0.0, False, True)]
    # the last: the main path's own call (labels from the train recipe),
    # launched twice: every output must agree bit for bit
    cases.append(("main path", bf16, 0.0, True, False))
    return cases


def ce_main_inputs(model_seed=0, h=768):
    """The main path's head call: GPT-base, 8 x 1024 tokens of hidden
    states, labels from the train phase's recipe, w the tied embedding's
    (h, 50304) .T view (h 2048: the same call at gpt_1p3b's width)."""
    n, v = 8 * 1024, 50304
    gen = torch.Generator(device="cuda")
    gen.manual_seed(model_seed)
    emb = (torch.randn(v, h, device="cuda", generator=gen) * 0.02).to(
        torch.bfloat16)
    hid = torch.randn(n, h, device="cuda", generator=gen).to(torch.bfloat16)
    rs = np.random.RandomState(0)
    rs.randint(0, v, (8, 1024))                  # the recipe's ids
    lbl = torch.from_numpy(rs.randint(0, v, (8, 1024)).astype(np.int32)
                           ).cuda().reshape(-1)
    scale = torch.full((n,), 1.0 / n, device="cuda")
    return hid, emb.T, lbl, scale


def staged_bwd(fc, entry, hid, w, lbl, lse, scale):
    """The staged route's dh or dw (``entry`` "fused_ce_dh" or
    "fused_ce_dw") called at the library's own entry point, so that it can
    be timed beside the tiled route at the main path's call; counts no
    launch. Returns dh (N, H) or dw (H, V)."""
    lib = fc.load_kernel()
    n, h = hid.shape
    v = w.shape[1]
    out = torch.empty((n, h) if entry == "fused_ce_dh" else (v, h),
                      dtype=hid.dtype, device=hid.device)
    err = getattr(lib, entry)(
        hid.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        lbl.data_ptr(), lse.data_ptr(), scale.data_ptr(), out.data_ptr(),
        n, h, v, int(hid.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"{entry}: cudaError {err}")
    return out if entry == "fused_ce_dh" else out.T


def fwd_at_entry(fc, hid, w, lbl32, splits=None):
    """The forward called at the library's own entry point, so that it can
    be timed beside the wrapper's launch; counts no launch. Without
    ``splits`` the staged kernel (``ce_fwd_kernel``, the first design),
    else the tiled kernel over that many vocab splits (the wrapper takes
    the number ``fwd_splits`` gives). Returns (lse, tgt)."""
    lib = fc.load_kernel()
    n, h = hid.shape
    v = w.shape[1]
    lse, tgt = [torch.empty(n, dtype=torch.float32, device=hid.device)
                for _ in range(2)]
    head = (hid.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
            lbl32.data_ptr(), lse.data_ptr(), tgt.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if splits is None:
        err = lib.fused_ce_fwd(*head, n, h, v,
                               int(hid.dtype == torch.bfloat16), stream)
    else:
        work = torch.empty((3, splits, n), dtype=torch.float32,
                           device=hid.device)
        err = lib.fused_ce_fwd_tiled(*head, work.data_ptr(), n, h, v, 1,
                                     splits, stream)
    check(err == 0, f"forward at splits {splits}: cudaError {err}")
    return lse, tgt


def sm_count():
    """The card's SMs, which the split rules of the tiled CE forward and of
    the paged split route read."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def _ce_fwd_work(n, h, v, e):
    """The forward's FLOPs and bytes (hid and w read once, lse and tgt
    written once, labels read once; ``analysis.cost.ce_fwd_work``) and its
    bound on this card."""
    from paddle_tpu_torch.analysis.cost import ce_fwd_work
    flops, moved = ce_fwd_work(n, h, v, e)
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    return flops, moved, max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def ce_fwd_timing(fc, flush, hid, w, lbl):
    """The forward at one call: the tiled route (through ``ce_fwd``, at
    the formula's vocab splits, ``ms``, and at the count the tuning DB
    resolves, ``tuned_ms``, as the main path calls it), the staged kernel
    (at its C entry), the plain version and the library forward (cuBLAS
    bf16 hid @ w + F.cross_entropy), one after another in this run, with
    the bound; the staged kernel is held against the plain version on the
    same inputs first. Then the tiled kernel over other numbers of vocab
    splits than the rule's (a reading of the rule, no check)."""
    n, h = hid.shape
    v = w.shape[1]
    check(fc.fwd_route(hid.dtype, h) == "tiled", f"H {h}: not tiled")
    lbl32 = lbl.to(torch.int32).contiguous()
    ref_lse, ref_tgt = fc.fused_ce_plain_fwd(hid, w, lbl)
    got = fwd_at_entry(fc, hid, w, lbl32)
    for name, g, r in zip(("lse", "tgt"), got, (ref_lse, ref_tgt)):
        err = (g - r).abs().max().item()
        check(err <= CE_STAT_ATOL, f"staged forward {name}: max err {err}")
    del got, ref_lse, ref_tgt
    splits = fc.fwd_splits(n, v, sm_count())
    tuned = fc.tiled_splits(hid.dtype, n, h, v, sm_count())
    ms = time_ms(lambda: fc.ce_fwd(hid, w, lbl, splits=splits), flush=flush)
    s0 = fc.SPLITS[tuned]
    tuned_ms = time_ms(lambda: fc.ce_fwd(hid, w, lbl), flush=flush)
    check(fc.SPLITS[tuned] > s0, f"the forward did not take the DB's "
          f"{tuned} splits")
    staged = time_ms(lambda: fwd_at_entry(fc, hid, w, lbl32), flush=flush)
    plain = time_ms(lambda: fc.fused_ce_plain_fwd(hid, w, lbl), reps=5,
                    flush=flush)
    lib = time_ms(lambda: torch.nn.functional.cross_entropy(
        hid @ w, lbl.long()), flush=flush)
    flops, moved, bound, bound_by = _ce_fwd_work(n, h, v,
                                                 hid.element_size())
    check(ms < staged and ms < plain,
          f"tiled forward {ms} ms not below the staged kernel {staged} ms "
          f"and the plain version {plain} ms (N {n}, H {h}, V {v})")
    sweep = {k: time_ms(lambda: fwd_at_entry(fc, hid, w, lbl32, k),
                        flush=flush)
             for k in sorted({1, 2, splits - 1, splits, splits + 1,
                              2 * splits, 4 * splits}) if k >= 1}
    return {"shape": [n, h, v], "fwd_route": "tiled", "splits": splits,
            "ms_by_splits": sweep, "ms": ms, "tuned_splits": tuned,
            "tuned_ms": tuned_ms, "staged_ms": staged, "plain_ms": plain,
            "library_fwd_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "flops": flops, "bytes": moved, "tflops": flops / ms / 1e9,
            "staged_over_tiled": staged / ms, "tiled_over_library": ms / lib}


def ce_timing(fc, chunked_ce, flush):
    """Each kernel and its plain version at the main path's call, with
    each kernel's bound on this card; every kernel also on the staged route
    (the first design's kernels), held against the plain version and
    timed in the same run (the forward by :func:`ce_fwd_timing`); the
    whole function four ways: the port's kernels, its chunked CE, its
    plain versions and the library (cuBLAS bf16 hid @ w +
    F.cross_entropy). Returns the rows and the forward at H 2048."""
    h2048 = ce_fwd_timing(fc, flush, *ce_main_inputs(h=2048)[:3])
    hid, w, lbl, scale = ce_main_inputs()
    fwd = ce_fwd_timing(fc, flush, hid, w, lbl)
    n, h = hid.shape
    v = w.shape[1]
    lse, _ = fc.ce_fwd(hid, w, lbl)
    lbl32 = lbl.to(torch.int32).contiguous()
    check(fc.bwd_route(hid.dtype, h) == "tiled", "main call not tiled")
    staged = {}
    for name, entry, plain in (("ce_dh", "fused_ce_dh", fc.fused_ce_plain_dh),
                               ("ce_dw", "fused_ce_dw", fc.fused_ce_plain_dw)):
        got = staged_bwd(fc, entry, hid, w, lbl32, lse, scale).float()
        tiled = getattr(fc, name)(hid, w, lbl, lse, scale).float()
        ref = plain(hid, w, lbl, lse, scale).float()
        norm = (got - ref).abs().max().item() / ref.abs().max().item()
        check(norm <= CE_TOL[hid.dtype], f"staged {name}: {norm}")
        rms = lambda x: x.square().mean().sqrt().item()  # noqa: E731
        staged[name] = {
            "staged_norm_err": norm, "rms_plain": rms(ref),
            "rms_err": rms(tiled - ref), "staged_rms_err": rms(got - ref),
            "staged_ms": time_ms(
                lambda: staged_bwd(fc, entry, hid, w, lbl32, lse, scale),
                flush=flush)}
        del got, tiled, ref
    ms = {"ce_fwd": fwd["ms"],
          "ce_dh": time_ms(lambda: fc.ce_dh(hid, w, lbl, lse, scale),
                           flush=flush),
          "ce_dw": time_ms(lambda: fc.ce_dw(hid, w, lbl, lse, scale),
                           flush=flush)}
    plain = {"ce_fwd": fwd["plain_ms"],
             "ce_dh": time_ms(lambda: fc.fused_ce_plain_dh(
                 hid, w, lbl, lse, scale), reps=5, flush=flush),
             "ce_dw": time_ms(lambda: fc.fused_ce_plain_dw(
                 hid, w, lbl, lse, scale), reps=5, flush=flush)}
    hg = hid.clone().requires_grad_()
    wg = w.T.clone().requires_grad_()            # the embedding, (V, H)

    def fwd_bwd(loss_fn):
        def run():
            loss = loss_fn(hg, wg.T)
            torch.autograd.grad(loss, (hg, wg))
        return run

    fused = lambda a, b: fc.fused_lm_ce(a, b, lbl)  # noqa: E731
    chunk = lambda a, b: chunked_ce.chunked_lm_ce(a, b, lbl)  # noqa: E731
    lib = lambda a, b: torch.nn.functional.cross_entropy(  # noqa: E731
        a @ b, lbl.long())
    whole = {
        "fused_fwd_ms": time_ms(lambda: fused(hid, w), flush=flush),
        "fused_fwd_bwd_ms": time_ms(fwd_bwd(fused), flush=flush),
        "chunked_fwd_ms": time_ms(lambda: chunk(hid, w), reps=5,
                                  flush=flush),
        "chunked_fwd_bwd_ms": time_ms(fwd_bwd(chunk), reps=5, flush=flush),
        "library_fwd_ms": time_ms(lambda: lib(hid, w), flush=flush),
        "library_fwd_bwd_ms": time_ms(fwd_bwd(lib), flush=flush)}
    from paddle_tpu_torch.analysis.cost import ce_bwd_work
    e = hid.element_size()
    work = {"ce_fwd": _ce_fwd_work(n, h, v, e)[:2],
            "ce_dh": ce_bwd_work("dh", n, h, v, e),
            "ce_dw": ce_bwd_work("dw", n, h, v, e)}
    res = {}
    for name, (flops, moved) in work.items():
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = moved / H100_BYTES_PER_S * 1e3
        res[name] = {
            "ms": ms[name], "flops": flops, "bytes": moved,
            "plain_ms": plain[name], "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms[name] / 1e9, **staged.get(name, {}),
            **whole}
    res["ce_fwd"].update(fwd_route="tiled", staged_ms=fwd["staged_ms"],
                         splits=fwd["splits"],
                         tuned_splits=fwd["tuned_splits"],
                         tuned_ms=fwd["tuned_ms"],
                         ms_by_splits=fwd["ms_by_splits"])
    for name in staged:
        check(ms[name] < staged[name]["staged_ms"] and
              ms[name] < plain[name],
              f"{name}: tiled {ms[name]} ms not below the staged route "
              f"{staged[name]['staged_ms']} ms and the plain version "
              f"{plain[name]} ms")
    return res, h2048


def golden_weights(names_shapes, seed):
    """The golden file's weight recipe (tests/torch_gpt_train_golden.py):
    every parameter in state_dict order from one RandomState(seed);
    biases zeros, 1-d (LayerNorm) weights ones, else normal(0, 0.02)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rs.normal(0.0, 0.02, shape).astype(np.float32)
    return out


def golden_data(vocab, batch, seq, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    return ids, labels


def fused_loss_layer(nn, model, chunk, ce_kernel="chunked"):
    """(ids, labels) -> loss Layer around ``fused_head_loss``, as bench.py
    wraps the model for ParallelTrainer: called with the pair (the
    trainer's input) or with ids and labels apart (``hapi.Model``'s)."""
    class FusedLoss(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, *batch):
            ids, lbl = batch[0] if len(batch) == 1 else batch
            return self.inner.fused_head_loss(ids, lbl, chunk=chunk,
                                              ce_kernel=ce_kernel)

    return FusedLoss(model)


def train_golden(fa, fc, nn, gpt, engine, optim, head="chunked"):
    """GPT-base widths at depth 2, fp32: step-0 loss and grad norm, then
    four train_step losses, against the JAX package's golden file. head:
    the chunked CE, the fused CE kernels ("pallas") or the dense logits +
    ``cross_entropy`` ("dense"): one loss, three routes."""
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "gpt_train_golden.json")) as f:
        gold = json.load(f)
    cfg = gold["config"]
    check(cfg["hidden_size"] == 768 and cfg["num_heads"] == 12 and
          cfg["vocab_size"] == 50304, f"golden config is not GPT-base: {cfg}")
    model = gpt.GPTForPretraining(tensor_parallel=False, **cfg)
    names_shapes = [(n, tuple(t.shape)) for n, t in model.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port state names/shapes differ from the golden file")
    model.set_state_dict_from_numpy(golden_weights(
        names_shapes, gold["recipe"]["weights"]["seed"]))
    ids, labels = golden_data(cfg["vocab_size"], gold["batch"], gold["seq"],
                              gold["recipe"]["data"]["seed"])
    opt = gold["optimizer"]
    opt = optim.AdamW(opt["learning_rate"], weight_decay=opt["weight_decay"])
    ids, labels = torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda()
    if head == "dense":
        trainer = engine.ParallelTrainer(
            model, opt,
            lambda logits, lbl: nn.functional.cross_entropy(logits, lbl))
        inputs, lbls = ids, labels
        loss0 = nn.functional.cross_entropy(model(ids), labels)
    else:
        wrapped = fused_loss_layer(
            nn, model, gold["loss"]["fused_head_loss_chunk"], ce_kernel=head)
        trainer = engine.ParallelTrainer(wrapped, opt, lambda out, _lbl: out)
        inputs, lbls = (ids, labels), 0.0
        loss0 = wrapped(inputs)
    grads = torch.autograd.grad(loss0, list(trainer.params.values()))
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).item()
    loss0 = loss0.item()
    for counts in (fa.LAUNCHES, fa.ROUTES, fc.LAUNCHES, fc.ROUTES):
        for key in counts:
            counts[key] = 0
    fc.SPLITS.clear()
    losses = [trainer.train_step(inputs, lbls) for _ in gold["losses"]]
    losses = [x.item() for x in losses]
    # float32 takes the staged forward: no split count reaches this run
    check(not fc.SPLITS, f"train_golden ({head}) launched tiled forwards "
          f"{dict(fc.SPLITS)}")
    launches = dict(fa.LAUNCHES)
    # float32: every flash kernel stays on its scalar route
    check(fa.ROUTES == {f"{key}_{route}": launches[key] * (route == "scalar")
                        for key in launches for route in ("mma", "scalar")},
          f"flash routes {fa.ROUTES} ({head}, float32)")
    ce_launches = dict(fc.LAUNCHES)
    ce_routes = dict(fc.ROUTES)
    n_layers = cfg["num_layers"]
    check(all(n == n_layers * len(losses) for n in launches.values()),
          f"flash launches {launches} != {n_layers} per step")
    want_ce = len(losses) if head == "pallas" else 0
    check(all(n == want_ce for n in ce_launches.values()),
          f"fused CE launches {ce_launches} != {want_ce} ({head})")
    # float32: the staged route
    check(ce_routes == {k: want_ce * k.endswith("_staged") for k in ce_routes},
          f"fused CE routes {ce_routes} ({head})")
    check(abs(loss0 - gold["losses"][0]) <= 1e-4 * abs(gold["losses"][0]),
          f"step-0 loss {loss0} vs golden {gold['losses'][0]}")
    check(abs(gnorm - gold["step0_grad_norm"]) <=
          1e-4 * gold["step0_grad_norm"],
          f"step-0 grad norm {gnorm} vs golden {gold['step0_grad_norm']}")
    check(abs(losses[0] - gold["losses"][0]) <= 1e-4 * abs(gold["losses"][0]),
          f"train_step 0 loss {losses[0]} vs golden {gold['losses'][0]}")
    for i in range(1, len(losses)):
        check(abs(losses[i] - gold["losses"][i]) <=
              1e-3 * abs(gold["losses"][i]),
              f"loss after {i} updates {losses[i]} vs golden "
              f"{gold['losses'][i]}")
    return {"head": head, "loss0": loss0, "grad_norm": gnorm,
            "losses": losses, "golden_losses": gold["losses"],
            "golden_grad_norm": gold["step0_grad_norm"],
            "launches": launches, "flash_routes": dict(fa.ROUTES),
            "ce_launches": ce_launches, "ce_routes": ce_routes}


def gpt_base_model(gpt, framework, seq=1024, layers=12, bf16=True):
    """bench.py's GPT-base model from seed 0, dropout 0, bf16 by default
    (``layers`` cuts the depth), on the CPU."""
    framework.seed(0)
    model = gpt.GPTForPretraining(
        tensor_parallel=False, vocab_size=50304, hidden_size=768,
        num_layers=layers, num_heads=12, max_position_embeddings=seq,
        attn_dropout=0.0, hidden_dropout=0.0)
    return model.bfloat16() if bf16 else model


def gpt_base_batch(batch=8, seq=1024):
    """One fixed batch of random ids and labels on the card."""
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                           .astype(np.int32)).cuda()
    labels = torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                              .astype(np.int32)).cuda()
    return ids, labels


def gpt_base_trainer(nn, gpt, engine, optim, framework, batch=8, seq=1024,
                     head="chunked", layers=12, bf16=True, opt=None,
                     **trainer_kw):
    """bench.py's GPT-base variants: bf16 params, AdamW(3e-4), dropout 0,
    one fixed batch of random ids. head: "chunked" (fused_b*: chunked CE,
    chunk 8192), "pallas" (fused_b8_pallas_ce: the fused CE kernels) or
    "dense" (dense_b*: logits + cross_entropy). ``layers`` cuts the depth,
    ``bf16=False`` keeps float32 weights, ``opt`` replaces the AdamW.
    Returns (trainer, (inputs, labels), n_params)."""
    model = gpt_base_model(gpt, framework, seq, layers, bf16)
    opt = opt if opt is not None else optim.AdamW(3e-4)
    n_params = sum(p.numel() for p in model.parameters())
    ids, labels = gpt_base_batch(batch, seq)
    if head == "dense":
        trainer = engine.ParallelTrainer(
            model, opt,
            lambda logits, lbl: nn.functional.cross_entropy(logits, lbl),
            **trainer_kw)
        return trainer, (ids, labels), n_params
    trainer = engine.ParallelTrainer(
        fused_loss_layer(nn, model, 8192, ce_kernel=head), opt,
        lambda out, _l: out, **trainer_kw)
    return trainer, ((ids, labels), 0.0), n_params


def train(fa, tuner, trainer, batch, n_params, warmup=2, iters=10, fc=None):
    """A GPT-base run: warm-up, then timed steps synced on the last loss
    (bench.py's _timed_steps); the flash (and, given ``fc``, fused-CE)
    counts are zeroed just before the timed steps and read just after.
    ``batch`` is (inputs, labels) as ``gpt_base_trainer`` returns it."""
    inputs, lbls = batch
    ids = inputs[0] if isinstance(inputs, tuple) else inputs
    b, s = ids.shape
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        loss = trainer.train_step(inputs, lbls)
    float(loss)
    counts = [fa.LAUNCHES, fa.ROUTES] + ([fc.LAUNCHES, fc.ROUTES]
                                         if fc is not None else [])
    for c in counts:
        for key in c:
            c[key] = 0
    if fc is not None:
        fc.SPLITS.clear()
    tuner.FALLBACKS.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(trainer.train_step(inputs, lbls))
    last = float(losses[-1])
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    flash_routes = dict(fa.ROUTES)
    ce_launches = dict(fc.LAUNCHES) if fc is not None else {}
    ce_routes = dict(fc.ROUTES) if fc is not None else {}
    ce_splits = dict(fc.SPLITS) if fc is not None else {}
    fallbacks = tuner.FALLBACKS["flash_attention"]
    ce_fallbacks = tuner.FALLBACKS["fused_ce"]
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(last < losses[0], f"loss did not fall: {losses}")
    check(trainer.skipped_steps() == 0, "the NaN guard skipped a step")
    check(fallbacks == 0, f"{fallbacks} flash fallbacks")
    check(ce_fallbacks == 0, f"{ce_fallbacks} fused_ce fallbacks")
    per_step = 12 * trainer.accumulate_steps      # layers x chunks
    # remat runs each forward twice: once in the step, once in backward
    want = {"flash_fwd": per_step * (2 if trainer.remat else 1),
            "flash_dq": per_step, "flash_dkv": per_step}
    check(launches == {k: n * iters for k, n in want.items()},
          f"flash launches {launches} != {want} per step")
    # bf16 at D = 64 on the QKV split's views: every forward, dq and dk/dv
    # on the tensor-core route
    check(flash_routes == {f"{key}_{route}": n * (route == "mma")
                           for key, n in launches.items()
                           for route in ("mma", "scalar")},
          f"flash routes {flash_routes}: not all on the mma route")
    check(all(n == iters for n in ce_launches.values()),
          f"fused CE launches {ce_launches} != 1 per step")
    # bf16 at GPT-base's H: dh and dw on the tiled route, every step
    check(not ce_routes or ce_routes == {
        k: iters * k.endswith("_tiled") for k in ce_routes},
        f"fused CE routes {ce_routes}: the tiled route not once per step")
    tokens = b * s * iters
    # model FLOPs per token: 6 N (matmuls fwd + bwd) + 6 L S d_model
    # (causal attention QK^T and PV, fwd + bwd)
    flops = (6 * n_params + 6 * 12 * s * 768) * tokens
    return {"batch": b, "seq": s, "timed_steps": iters, "losses": losses,
            "tokens_per_s": tokens / dt, "ms_per_step": dt / iters * 1e3,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "params": n_params, "model_flops_per_step": flops / iters,
            "mfu_vs_989_tflops": flops / dt / H100_BF16_FLOPS,
            "launches": launches, "flash_routes": flash_routes,
            "ce_launches": ce_launches, "ce_routes": ce_routes,
            "ce_splits": ce_splits, "flash_fallbacks": fallbacks,
            "fused_ce_fallbacks": ce_fallbacks, "skipped_steps": 0}


@contextlib.contextmanager
def staged_route(fc):
    """Within the block, dh and dw take the staged route (the first design)
    whatever the dtype and H: a yardstick for the main path's losses, run
    after the main path's own counted run."""
    route = fc.bwd_route
    fc.bwd_route = lambda dtype, h: "staged"
    try:
        yield
    finally:
        fc.bwd_route = route


LEAD_S = 0.01   # host wait between a profiler window's start and its work


def _profiled_steps(trainer, batch, steps):
    """One warm-up step, then ``steps`` steps under torch.profiler; returns
    (profiler, wall seconds of the ``steps`` steps). The warm-up step runs
    in the profiler's warm-up cycle, so CUPTI is collecting before the
    window opens and that step's events are discarded; the window then
    opens ``LEAD_S`` before the first launch. A window opened cold drops
    the first kernels of its first step, more of them the more windows
    the process has opened (one flash forward of 36 on the card)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    inputs, lbls = batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        float(trainer.train_step(inputs, lbls))
        torch.cuda.synchronize()
        prof.step()
        time.sleep(LEAD_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = trainer.train_step(inputs, lbls)
        float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def profile_train(trainer, batch, steps=3):
    """Device busy share and the top device kernels over ``steps`` steps
    of a GPT-base run (torch.profiler)."""
    prof, wall = _profiled_steps(trainer, batch, steps)
    report, rows = _profile_report(prof, wall)
    check(rows, "the profiler saw no kernel on the card")
    groups = {}
    for us, name, n in rows:
        if "flash_" in name:
            key = "flash kernels"
        elif any(k in name for k in CE_KERNELS):
            key = "fused CE kernels"
        elif "sgemm" in name or "f32f32_f32f32" in name:
            key = "float32 GEMMs (chunked CE)"
        elif "gemm" in name.lower() or name.startswith("nvjet"):
            key = "other GEMMs"     # cuBLAS's Hopper GEMMs are nvjet_*
        else:
            key = "the rest"
        ms, launches = groups.get(key, (0.0, 0))
        groups[key] = (ms + us / 1e3 / steps, launches + n)
    groups = {k: {"ms_per_step": v[0], "launches_per_step": v[1] / steps}
              for k, v in groups.items()}
    flash = {}
    for us, name, n in rows:
        for kernel in ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                       "flash_dq_mma_kernel", "flash_dq_kernel",
                       "flash_dkv_mma_kernel", "flash_dkv_kernel"):
            if kernel in name:
                ms, launches = flash.get(kernel, (0.0, 0))
                flash[kernel] = (ms + us / 1e3 / steps, launches + n)
    flash = {k: {"ms_per_step": v[0], "launches_per_step": v[1] / steps}
             for k, v in flash.items()}
    ce = {}
    for us, name, n in rows:
        for kernel in CE_KERNELS:
            if kernel in name:
                ms, launches = ce.get(kernel, (0.0, 0))
                ce[kernel] = (ms + us / 1e3 / steps, launches + n)
    ce = {k: {"ms_per_step": v[0], "launches_per_step": v[1] / steps}
          for k, v in ce.items()}
    return dict(steps=steps, by_group=groups, flash_by_kernel=flash,
                ce_by_kernel=ce, **report)


def gates(fa, fc, nn, tuner, optim, rs):
    """The repaired dispatch on the card: float16 attention and head loss
    take the plain attention and the chunked CE, each counting one fallback
    and launching no kernel; AdamW takes its slot dtype by name."""
    from paddle_tpu_torch.nn.functional.attention import _xla_attention
    F = nn.functional
    rand = lambda *shape: torch.as_tensor(  # noqa: E731
        rs.randn(*shape).astype(np.float32), device="cuda")
    q, k, v = [rand(2, 512, 4, 64).half() for _ in range(3)]
    n0, l0 = tuner.FALLBACKS["flash_attention"], dict(fa.LAUNCHES)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    check(tuner.FALLBACKS["flash_attention"] == n0 + 1 and
          fa.LAUNCHES == l0, "float16 attention did not fall back, counted")
    check(torch.equal(out, _xla_attention(q, k, v, causal=True)),
          "float16 attention != the plain attention")
    hid, w = rand(256, 768).half(), (0.05 * rand(768, 1000)).half()
    lbl = torch.as_tensor(rs.randint(0, 1000, 256), device="cuda")
    c0, cl0 = tuner.FALLBACKS["fused_ce"], dict(fc.LAUNCHES)
    loss = F.fused_linear_cross_entropy(hid, w, lbl, kernel="auto")
    check(tuner.FALLBACKS["fused_ce"] == c0 + 1 and fc.LAUNCHES == cl0,
          "float16 head loss did not fall back, counted")
    chunked = F.fused_linear_cross_entropy(hid, w, lbl, kernel="chunked")
    check(torch.equal(loss, chunked), "float16 head loss != chunked CE")
    opt = optim.AdamW(1e-3, slot_dtype="bfloat16")
    p = {"w": rand(64, 64).to(torch.bfloat16)}
    state = opt.init_state(p)
    p2, state = opt.apply_gradients(p, {"w": rand(64, 64)}, state)
    check(state["slots"]["w"]["m"].dtype == torch.bfloat16 and
          torch.isfinite(p2["w"].float()).all().item(),
          "AdamW(slot_dtype='bfloat16') on the card")
    return {"float16_attention_fallbacks": 1, "float16_ce_fallbacks": 1,
            "float16_loss": loss.item(), "adamw_slot_dtype": "bfloat16"}


def paged_kernel_phases(pa, card, rs):
    """Phases ``parity``, ``paged_repeat`` and ``timing`` of the paged
    kernels, inputs drawn from ``rs``. Returns (max abs error by kernel,
    timings by (tq, b, pools))."""
    # 3. kernel parity against the plain version, on the card: both routes,
    # forced split counts and the NaN pool (parity_case), then repeats
    lens_a = [0, 1, 15, 16, 17, 513, 1023, 1024]
    lens_b = [0, 1, 15, 16, 17, 513, 5000, 1024]   # 5000 > W*ps: capped
    max_err = {"decode": 0.0, "verify": 0.0}
    cases = ([(tq, torch.float32, lens) for tq in PARITY_TQ
              for lens in (lens_a, lens_b)] +
             [(tq, torch.bfloat16, lens_a) for tq in (1, 5, 8)])
    for tq, dtype, lens in cases:
        errs = parity_case(pa, rs, tq, dtype, lens)
        key = "decode" if tq == 1 else "verify"
        max_err[key] = max(max_err[key], *errs.values())
        emit(phase="parity", tq=tq, dtype=str(dtype).split(".")[-1],
             lens=lens, max_abs_err=errs, atol=ATOL, rtol=RTOL)
    emit(phase="paged_repeat", bit_identical={
        tq: paged_repeat(pa, rs, tq) for tq in (1, 5, 32)})

    # 4. timing (every row 1024 cached tokens): the split route beside the
    # simple route, plain and the library, at B 8 and B 1, float32 pools
    # (and bf16 at Tq 1), with a sweep of split counts at the main shape
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timing = {}
    sweep = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16)
    for tq, b, dtype in ((1, 8, torch.float32), (5, 8, torch.float32),
                         (8, 8, torch.float32),
                         (32, 8, torch.float32), (1, 1, torch.float32),
                         (5, 1, torch.float32), (32, 1, torch.float32),
                         (1, 8, torch.bfloat16)):
        t = kernel_timing(pa, rs, tq, flush, b=b, dtype=dtype,
                          sweep=sweep if b == 8 and dtype == torch.float32
                          and tq in (1, 32) else ())
        timing[(tq, b, str(dtype))] = t
        emit(phase="timing", card=card, **t)
    del flush
    return max_err, timing


def no_decay(name):
    """AdamW's decay filter of the data-parallel runs: biases and norms
    take no decay."""
    return not (name.endswith("bias") or ".ln" in name or "norm" in name)


def dp_setup():
    """An NCCL process group of one rank on the card (the default group)
    and a gloo group beside it; a data mesh over each. Every collective is
    the identity at one rank; one all_reduce on each checks the groups."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import env, mesh
    from paddle_tpu_torch.distributed.spawn import free_port
    env.init_parallel_env(device="cuda:0", world_size=1, rank=0,
                          init_method=f"tcp://127.0.0.1:{free_port()}")
    gloo_pg = dist.new_group(backend="gloo")
    check(dist.get_backend() == "nccl" and
          dist.get_backend(gloo_pg) == "gloo",
          f"backends {dist.get_backend()}, {dist.get_backend(gloo_pg)}")
    one = torch.ones(4, device="cuda")
    dist.all_reduce(one)
    cpu_one = torch.ones(4)
    dist.all_reduce(cpu_one, group=gloo_pg)
    check(float(one.sum()) == 4.0 and float(cpu_one.sum()) == 4.0,
          "an all_reduce over one rank changed its input")
    nccl = mesh.build_mesh({"data": 1})
    gloo = mesh.Mesh({"data": 1}, group=gloo_pg)
    return nccl, gloo, gloo_pg


def base_grads(nn, gpt, engine, optim, framework):
    """Real GPT-base gradients (bf16) of one fused_b8 step, by name."""
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework)
    inputs, _ = batch
    params = dict(trainer.params)
    loss = trainer.model(inputs)
    grads = torch.autograd.grad(loss, list(params.values()))
    out = {k: g.detach() for k, g in zip(params, grads)}
    del trainer, batch, loss, grads
    return out, n_params


def _same_bits(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def profile_calls(fn, calls=2):
    """Per call of ``fn``, from a torch.profiler trace of ``calls`` calls:
    the device's busy time (the union of its kernels' intervals), its
    kernel launches, the wall time under the profiler and the device's
    idle share of it, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy_us = _device_time(prof)
    check(rows, "the profiler saw no kernel on the card")
    return {"device_busy_ms": busy_us / 1e3 / calls,
            "kernels_per_call": sum(n for _, _, n in rows) / calls,
            "profiled_wall_ms": wall * 1e3 / calls,
            "profiled_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top": [{"name": k[:80], "device_ms": us / 1e3 / calls,
                     "count": n / calls} for us, k, n in rows[:6]]}


def dp_exchange(cm, nccl, gloo, grads):
    """compressed_tree_mean of real GPT-base gradients under each policy on
    the card (NCCL mesh of one rank) and on the CPU (gloo mesh of one
    rank), twice (the second call consumes the first's residuals): means
    and residuals bit-identical, and the quantizers' payloads and scales
    over the whole flat gradient bit-identical; the exchange's time, its
    device busy time and idle share (``profile_calls``); the wire model's
    bytes at 2, 4 and 8 ranks."""
    cpu = {k: v.cpu() for k, v in grads.items()}
    numel = sum(v.numel() for v in grads.values())
    flat = torch.cat([grads[k].float().reshape(-1) for k in sorted(grads)])
    flat_cpu = flat.cpu()
    fp32_bytes = {n: cm.tree_wire_bytes(grads, n, "fp32") for n in (2, 4, 8)}
    out = {}
    for pol in ("fp32", "bf16", "int8", "int4"):
        quant = pol in cm.QUANTIZED_POLICIES
        row = {"policy": pol}
        if quant:
            blk = cm.resolve_block(pol, None)
            qfn = (cm.quantize_int8_blocks if pol == "int8"
                   else cm.quantize_int4_blocks)
            pad = (-flat.numel()) % blk
            q, sc = qfn(torch.nn.functional.pad(flat, (0, pad)), blk)
            q_c, sc_c = qfn(torch.nn.functional.pad(flat_cpu, (0, pad)), blk)
            check(_same_bits(q, q_c) and _same_bits(sc, sc_c),
                  f"{pol} payload or scales differ between card and CPU")
            if pol == "int4":
                check(_same_bits(cm.pack_int4(q), cm.pack_int4(q_c)),
                      "packed int4 payloads differ between card and CPU")
            del q, sc, q_c, sc_c
        res_g = cm.init_residuals(grads) if quant else None
        res_c = cm.init_residuals(cpu) if quant else None
        for call in (1, 2):
            m_g, res_g = cm.compressed_tree_mean(grads, "data", policy=pol,
                                                 residuals=res_g, mesh=nccl)
            m_c, res_c = cm.compressed_tree_mean(cpu, "data", policy=pol,
                                                 residuals=res_c, mesh=gloo)
            for k in grads:
                check(_same_bits(m_g[k], m_c[k]),
                      f"{pol} call {call}: mean of {k} differs card/CPU")
                if quant:
                    check(_same_bits(res_g[k], res_c[k]),
                          f"{pol} call {call}: residual of {k} differs")
                else:
                    check(_same_bits(m_g[k], grads[k]),
                          f"{pol} at one rank is not the identity")
        row["bit_identical_card_vs_cpu"] = True
        if quant:
            row["residual_norm"] = cm.residual_norm(res_g)
            check(row["residual_norm"] > 0, f"{pol}: no quantization error")
            row["mean_rel_err"] = float(
                sum(torch.sum((m_g[k].float() - grads[k].float()) ** 2)
                    for k in grads).sqrt() /
                sum(torch.sum(grads[k].float() ** 2)
                    for k in grads).sqrt())
        call = (lambda: cm.compressed_tree_mean(
            grads, "data", policy=pol, residuals=res_g, mesh=nccl))
        # the call's events (the host's launch gaps inside), then the
        # device's busy time and idle share from a profiler trace
        row["ms"] = time_ms(call, reps=5, warmup=1)
        row.update(profile_calls(call))
        row["idle_share_of_ms"] = 1.0 - row["device_busy_ms"] / row["ms"]
        row["wire_bytes_per_rank"] = {
            n: cm.tree_wire_bytes(grads, n, pol) for n in (2, 4, 8)}
        row["compression_x"] = {
            n: fp32_bytes[n] / row["wire_bytes_per_rank"][n]
            for n in (2, 4, 8)}
        row["numel"] = numel
        out[pol] = row
        del m_g, m_c, res_c
    for pol, lo, hi in (("int8", 3.8, 4.0), ("int4", 7.0, 7.5)):
        x = out[pol]["compression_x"][8]
        check(lo <= x <= hi, f"{pol} compression {x} outside [{lo}, {hi}]")
    return out


def train_dp(fa, tuner, cm, nn, gpt, engine, optim, framework, nccl,
             fused_b8):
    """bench.py's fused_b8_int8dp and fused_b8_int4dp, then int8 with four
    buckets, each as ``train`` runs fused_b8 (2 warm-up + 10 timed steps,
    bf16) on the data mesh of one rank over NCCL, with AdamW keeping
    biases and norms out of its decay; losses within DP_LOSS_BAND of
    fused_b8's from the same run."""
    out = {}
    for name, kw in (("fused_b8_int8dp", dict(grad_sync="int8")),
                     ("fused_b8_int4dp", dict(grad_sync="int4")),
                     ("fused_b8_int8dp_buckets4",
                      dict(grad_sync="int8", grad_sync_buckets=4))):
        trainer, batch, n_params = gpt_base_trainer(
            nn, gpt, engine, optim, framework, mesh=nccl,
            opt=optim.AdamW(3e-4, apply_decay_param_fun=no_decay), **kw)
        check(trainer.n_data == 1 and len(trainer.comm_err) == len(
            trainer.params), "the quantized trainer holds no residuals")
        check(len(trainer.grad_sync_bucket_keys) ==
              kw.get("grad_sync_buckets", 1),
              f"buckets {len(trainer.grad_sync_bucket_keys)}")
        # buckets issued from the backward's tensor hooks, per step: what
        # finish() finds already issued when autograd.grad has returned
        issued, real_finish = [], engine._BucketHooks.finish

        def finish(self, grads):
            issued.append(len(self.finishers))
            return real_finish(self, grads)

        engine._BucketHooks.finish = finish
        try:
            rep = train(fa, tuner, trainer, batch, n_params)
        finally:
            engine._BucketHooks.finish = real_finish
        buckets = len(trainer.grad_sync_bucket_keys)
        check(issued == ([buckets] * 12 if buckets > 1 else []),
              f"{name}: buckets issued inside the backward, per step: "
              f"{issued} of {buckets}")
        rep["profile"] = {k: v for k, v in profile_train(
            trainer, batch, steps=2).items()
            if k in ("wall_s", "device_busy_s", "busy_share", "by_group")}
        rel = [abs(a - b) / abs(b) for a, b in zip(rep["losses"],
                                                  fused_b8["losses"])]
        band = DP_LOSS_BAND[kw["grad_sync"]]
        check(max(rel) <= band, f"{name}: losses {rep['losses']} vs "
              f"fused_b8 {fused_b8['losses']}: {max(rel)} > {band}")
        res = cm.residual_norm(dict(trainer.comm_err))
        check(res > 0, f"{name}: the residuals never moved")
        rep.update(
            grad_sync=kw["grad_sync"],
            buckets=buckets, buckets_issued_in_backward=issued,
            bucket_params=[len(b) for b in trainer.grad_sync_bucket_keys],
            wire_bytes_per_step_this_run=trainer._wire_bytes_per_step,
            wire_bytes_per_step_at_8_ranks=cm.tree_wire_bytes(
                {k: p.detach() for k, p in trainer.params.items()}, 8,
                kw["grad_sync"]),
            residual_norm=res, rel_loss_vs_fused_b8=rel,
            max_rel_loss_vs_fused_b8=max(rel), band=band,
            ms_per_step_fused_b8=fused_b8["ms_per_step"],
            tokens_per_s_fused_b8=fused_b8["tokens_per_s"],
            ms_over_fused_b8=rep["ms_per_step"] / fused_b8["ms_per_step"])
        out[name] = rep
        del trainer, batch
        torch.cuda.empty_cache()
    return out


def amp_phase(amp, fa, nn, gpt, engine, optim, framework):
    """GPT-base widths at depth 2 with float32 master weights, under
    auto_cast(bfloat16) and a GradScaler; step AMP_TAINTED is tainted with
    inf. The scale after each step and the skip count must be the
    reference's (AMP_SCALES)."""
    trainer, batch, _ = gpt_base_trainer(
        nn, gpt, engine, optim, framework, layers=2, bf16=False,
        scaler=amp.GradScaler(**AMP_SCALER))
    inputs, lbls = batch
    for c in (fa.LAUNCHES, fa.ROUTES):
        for key in c:
            c[key] = 0
    losses, scales = [], []
    for step in range(len(AMP_SCALES)):
        taint = float("inf") if step in AMP_TAINTED else None
        with amp.auto_cast(dtype="bfloat16"):
            losses.append(float(trainer.train_step(inputs, lbls,
                                                   grad_taint=taint)))
        scales.append(trainer.loss_scale())
    skipped = trainer.skipped_steps()
    check(scales == list(AMP_SCALES), f"loss scales {scales} != "
          f"{list(AMP_SCALES)}")
    check(skipped == len(AMP_TAINTED), f"{skipped} skipped steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    name = "inner.gpt.h.0.attn.qkv_proj.weight"
    check(trainer.get_param(name).dtype == torch.float32,
          "the master weights are not float32")
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTES)
    check(launches["flash_fwd"] == 2 * len(AMP_SCALES) and
          routes["flash_fwd_mma"] == launches["flash_fwd"],
          f"bf16 attention under auto_cast: launches {launches}, "
          f"routes {routes}")
    del trainer, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "scales": scales, "skipped_steps": skipped,
            "tainted": list(AMP_TAINTED), "scaler": AMP_SCALER,
            "flash_launches": launches, "flash_routes": routes}


def tune_phase(tuner, fc, pa, fa, calibration, card, rs):
    """``tune``: the tuner's H100 suite, twice, into the overlay that
    ``PADDLE_TPU_TORCH_TUNING_DB`` names (a temporary file; the rest of the
    run resolves through it). Every candidate of every case must pass its
    bar against the plain version before it is timed; then ``resolve``
    must give the winner, the next CE forward and paged launches at the
    suite's shapes must take it, and the reference's generic rows (flash
    blocks, CE blocks, q_pad) must answer as off the card. Reports each
    candidate, the winners beside the formula, the ``tuner:<kernel>``
    drift of the second sweep against the first, and whether the seed's
    H100 rows equal this run's winners (a difference is no failure)."""
    cases = tuner.suite("h100")
    seed = tuner.TuningDB.load(tuner.default_db_path())
    calibration.reset()
    sweeps = []
    for i in range(2):
        t0 = time.perf_counter()
        db = tuner.tune(cases)
        keys = {}
        for kernel, case, dtype in cases:
            dims = (tuner.ce_dims(case["h"], case["v"], case["n"])
                    if kernel == tuner.CE_SPLIT_KERNEL else
                    tuner.paged_split_dims(case["b"], case["h"], case["d"],
                                           case["ps"], case["width"],
                                           case["tq"]))
            key = tuner.make_key(kernel, tuner.device_kind(), dtype, dims)
            e = db.lookup(key)
            check(e is not None and e["validated"] == "device",
                  f"tune: no device row for {key}")
            check(e["swept"] == len(e["candidates"]) and
                  all(c["mean_us"] is not None for c in e["candidates"]),
                  f"tune: a candidate of {key} failed its bar: "
                  f"{e['candidates']}")
            for c in e["candidates"]:
                emit(phase="tune_candidate", card=card, sweep=i, key=key,
                     splits=c["config"]["splits"], max_err=c["max_err"],
                     us=c["mean_us"])
            emit(phase="tune", card=card, sweep=i, key=key,
                 winner=e["config"]["splits"], winner_us=e["mean_us"],
                 formula=e["default"]["config"]["splits"],
                 formula_us=e["default"]["mean_us"],
                 fastest=e["fastest"]["config"]["splits"],
                 fastest_us=e["fastest"]["mean_us"],
                 formula_over_fastest=(e["default"]["mean_us"] /
                                       e["fastest"]["mean_us"]))
            keys[key] = (kernel, dtype, dims, e)
        sweeps.append(keys)
        emit(phase="tune_sweep", card=card, sweep=i,
             seconds=time.perf_counter() - t0)
    drift = {key: sweeps[1][key][3]["mean_us"] / sweeps[0][key][3]["mean_us"]
             for key in sweeps[1]}
    # a pair for every key the DB already timed: the seed's rows in the
    # first sweep, the first sweep's in the second
    summary = calibration.summary()
    for k in (tuner.CE_SPLIT_KERNEL, tuner.PAGED_SPLIT_KERNEL):
        want = sum(1 + ((seed.lookup(key) or {}).get("mean_us") is not None)
                   for key, row in sweeps[1].items() if row[0] == k)
        check(summary[f"tuner:{k}"]["n"] == want,
              f"tune: {summary} calibration pairs, {want} for {k}")
    emit(phase="tune_drift", card=card, fresh_over_prior=drift,
         calibration={k: v for k, v in summary.items()
                      if k.startswith("tuner:")})
    # the overlay holds the second sweep: resolve and the launches take it
    winners = {}
    for key, (kernel, dtype, dims, e) in sweeps[1].items():
        want = e["config"]["splits"]
        got = tuner.resolve(kernel, dtype, dims, e["default"]["config"])
        check(got == ({"splits": want}, "db"), f"resolve {key}: {got}")
        winners[key] = want
    hid, w, lbl, _ = ce_main_inputs()
    want = winners[[k for k in winners if "h768," in k][0]]
    s0 = fc.SPLITS[want]
    fc.ce_fwd(hid, w, lbl)
    check(fc.SPLITS[want] == s0 + 1, f"the next CE forward did not take "
          f"{want} splits: {dict(fc.SPLITS)}")
    del hid, w, lbl
    for tq in (1, 8):
        want = winners[[k for k in winners
                        if k.startswith(tuner.PAGED_SPLIT_KERNEL) and
                        k.endswith(f",sq{tq}")][0]]
        q, kp, vp, tab, ln = paged_inputs(rs, tq, torch.float32, [1024] * 8)
        key = "decode" if tq == 1 else "verify"
        s0 = pa.SPLITS[(key, want)]
        pa.paged_attention(q, kp, vp, tab, ln)
        check(pa.SPLITS[(key, want)] == s0 + 1, f"the next paged {key} "
              f"launch did not take {want} splits: {dict(pa.SPLITS)}")
    # the reference's generic rows answer as they do off the card
    for key, e in seed.entries.items():
        if "|any|" not in key:
            continue
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[e["dtype"]]
        dflt = {k: -1 for k in e["config"]}
        check(tuner.resolve(e["kernel"], dtype, e["dims"], dflt) ==
              (e["config"], "db"), f"generic row {key} on the card")
    check(fa.keying_blocks(torch.bfloat16, 64, 1024, 1024) == (256, 512),
          "the flash blocks that key the dropout mask moved")
    check(fc.resolve_blocks(torch.bfloat16, 8192, 768, 50304) == (256, 2048),
          "the reference's CE blocks moved")
    same = {key: seed.lookup(key) is not None and
            seed.lookup(key)["config"] == sweeps[i][key][3]["config"]
            for i in range(2) for key in sweeps[i]}
    emit(phase="tune_vs_seed", card=card, seed_rows_equal_winners={
        key: {"seed": (seed.lookup(key) or {}).get("config"),
              "sweep0": sweeps[0][key][3]["config"],
              "sweep1": sweeps[1][key][3]["config"]} for key in sweeps[1]},
        all_equal=all(same.values()))
    return winners


@contextlib.contextmanager
def splits_memoised(pa):
    """Within the block, the paged wrapper takes its split count from a
    plain dict instead of resolving it through the tuning DB: the
    yardstick of ``resolve``'s host cost in serving."""
    resolve = pa.route_splits
    memo = {}

    def route_splits(*args):
        if args not in memo:
            memo[args] = resolve(*args)
        return memo[args]
    pa.route_splits = route_splits
    try:
        yield
    finally:
        pa.route_splits = resolve


def resolve_host_us(pa, calls=20000):
    """Host microseconds a call of ``route_splits`` (the DB resolution a
    paged launch makes) and of the bare formula take, at the serving
    shape."""
    args = (torch.float32, 8, 1, 12, 64, 16, 64, sm_count())
    out = {}
    for name, fn in (("route_splits", lambda: pa.route_splits(*args)),
                     ("paged_splits", lambda: pa.paged_splits(
                         8, 12, 64, 16, args[-1]))):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[f"{name}_us"] = (time.perf_counter() - t0) / calls * 1e6
    return out


def _prom_names(text):
    """Metric names of a Prometheus text exposition; raises on a line that
    is not a comment or ``name{labels} value``."""
    import re
    names = set()
    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        check(m is not None, f"metrics.prom: bad line {line!r}")
        float(m.group(3))
        names.add(m.group(1))
    return names


def telemetry_phase(trainer, batch, n_params, work, card):
    """``telemetry``: three ``fused_b8_pallas_ce`` steps inside
    ``telemetry.scope(run_dir)`` with the profiler on (host ranges and the
    card) and every step a kept trace. The four artifacts must be there
    and valid; ``calibration.fit`` takes the measured steps with FLOPs from
    PERF.md's formula and ``peak_flops_per_sec`` must read the fitted rate
    back from a temporary overlay; ``gather_registries`` at one rank must
    return the merge tagged with process 0."""
    from paddle_tpu_torch import profiler, telemetry
    from paddle_tpu_torch.telemetry import aggregate, calibration, tracing
    run_dir = os.path.join(work, "telemetry_run")
    os.environ["PADDLE_TPU_TORCH_CALIBRATION_DB"] = os.path.join(
        work, "calibration_db.json")
    os.environ.pop("PADDLE_TPU_TORCH_PEAK_FLOPS", None)
    calibration.clear_cache()
    inputs, lbls = batch
    ids = inputs[0]
    tokens = ids.numel()
    float(trainer.train_step(inputs, lbls))
    tracing.enable(policy=tracing.KeepPolicy(keep_all=True))
    profiler.start_profiler("All")
    secs = []
    try:
        with telemetry.scope(run_dir) as sc:
            for i in range(3):
                tr = tracing.start_trace("train_step", step=i)
                t0 = time.perf_counter()
                trainer.train_step(inputs, lbls)    # synced: telemetry on
                secs.append(time.perf_counter() - t0)
                tr.close("completed")
            merged = aggregate.gather_registries()
            snapshot = sc.registry.to_dict()
    finally:
        profiler.stop_profiler(profile_path="", verbose=False)
        tracing.disable()
        tracing.reset()
    files = sorted(os.listdir(run_dir))
    check(files == ["events.jsonl", "metrics.prom", "trace.json",
                    "traces_kept.json"], f"telemetry artifacts: {files}")
    with open(os.path.join(run_dir, "metrics.prom")) as f:
        names = _prom_names(f.read())
    for name in ("step_time_seconds_count", "tokens_per_sec",
                 "kernel_config_resolved_total"):
        check(name in names, f"metrics.prom lacks {name}: {sorted(names)}")
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    check(events[0]["event"] == "scope_start" and
          events[-1]["event"] == "summary", "events.jsonl: "
          f"{[e['event'] for e in events]}")
    with open(os.path.join(run_dir, "trace.json")) as f:
        trace = json.load(f)
    ranges = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "host"]
    check([e["name"] for e in ranges] == ["train_step"] * 3 and
          all(e["dur"] > 0 and e["ts"] >= 0 for e in ranges),
          f"trace.json host ranges: {ranges}")
    with open(os.path.join(run_dir, "traces_kept.json")) as f:
        kept = json.load(f)["traces"]
    check(len(kept) == 3, f"{len(kept)} kept traces")
    rows, busy_us = _device_time(profiler.device_profile())
    check(rows, "the device trace holds no kernel")
    flops = (6 * n_params + 6 * 12 * ids.shape[1] * 768) * tokens
    fit = calibration.fit(compute_samples=[
        {"flops": flops, "seconds": t} for t in secs])
    peak = telemetry.peak_flops_per_sec()
    check(peak == fit["entry"]["peak_flops_per_sec"],
          f"peak_flops_per_sec {peak} is not the fitted "
          f"{fit['entry']['peak_flops_per_sec']}")
    step_series = merged["step_time_seconds"]["series"]
    check(list(step_series) == ["process_index=0"] and
          step_series["process_index=0"] ==
          snapshot["step_time_seconds"]["series"][""],
          f"gather_registries at one rank: {step_series}")
    resolved = snapshot["kernel_config_resolved_total"]["series"]
    return {"artifacts": files, "step_seconds": secs,
            "tokens_per_s": [tokens / t for t in secs],
            "device_busy_ms_3_steps": busy_us / 1e3,
            "fitted_peak_flops_per_sec": peak,
            "fitted_over_989_tflops": peak / H100_BF16_FLOPS,
            "calibration_device": fit["device"],
            "kernel_config_resolved_total": resolved,
            "kept_traces": len(kept), "trace_events":
                len(trace["traceEvents"])}


def _flip_a_byte(step_dir, at=0.5):
    """One byte of the largest file of a saved step, inverted (at the
    fraction ``at`` of its length)."""
    files = [os.path.join(step_dir, n) for n in os.listdir(step_dir)
             if n != "MANIFEST.json"]
    path = max(files, key=os.path.getsize)
    with open(path, "r+b") as f:
        f.seek(int(os.path.getsize(path) * at))
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    return os.path.basename(path)


def checkpoint_phase(nn, gpt, engine, optim, framework, work, card):
    """``checkpoint``: run A, ``fused_b8_pallas_ce`` (batch 8 x 1024,
    dropout 0), takes 6 steps and ``CheckpointManager`` saves its whole
    state after steps 3 and 6; one byte of step 6 is then inverted. A fresh
    trainer's ``restore()`` must fall back to step 3, counting one
    fallback, and its next 3 steps must give run A's last 3 losses and
    final parameters bit for bit."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed import checkpoint as ck
    root = os.path.join(work, "ckpt")
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    inputs, lbls = batch
    mgr = ck.CheckpointManager(root, max_to_keep=3)
    saves = {}
    losses_a = []
    with telemetry.scope(None, profile=False) as sc:
        for i in range(1, 7):
            losses_a.append(trainer.train_step(inputs, lbls))
            if i in (3, 6):
                t0 = time.perf_counter()
                check(mgr.save(i, trainer.state), f"save of step {i}")
                saves[i] = time.perf_counter() - t0
        save_bytes = sc.registry.get("checkpoint_bytes_total").value(
            op="save")
        stall_ms = sc.registry.get("ckpt_step_stall_ms").sum()
    final_a = {n: p.detach().clone() for n, p in trainer.params.items()}
    losses_a = [x.item() for x in losses_a]
    del trainer
    torch.cuda.empty_cache()
    check(mgr.all_steps() == [3, 6] and mgr.latest_valid_step() == 6,
          f"steps {mgr.all_steps()}")
    flipped = _flip_a_byte(os.path.join(root, "6"))
    trainer, _, _ = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                     head="pallas")
    with telemetry.scope(None, profile=False) as sc:
        t0 = time.perf_counter()
        trainer.state = mgr.restore(template=trainer.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_bytes = sc.registry.get("checkpoint_bytes_total").value(
            op="restore")
        fallbacks = sc.registry.get("ckpt_restore_fallbacks_total").value()
    check(mgr.last_restored_step == 3 and mgr.restore_fallbacks_total == 1
          and fallbacks == 1, f"restore took step {mgr.last_restored_step} "
          f"with {mgr.restore_fallbacks_total} fallbacks")
    dtypes = {str(p.dtype) for p in trainer.params.values()}
    slot_dtypes = {str(v.dtype) for s in trainer.opt_state["slots"].values()
                   for v in s.values()}
    check(dtypes == {"torch.bfloat16"} and slot_dtypes == {"torch.float32"},
          f"restored dtypes {dtypes}, slots {slot_dtypes}")
    losses_b = [trainer.train_step(inputs, lbls).item() for _ in range(3)]
    check(losses_b == losses_a[3:], f"resumed losses {losses_b} != run A's "
          f"{losses_a[3:]}")
    same = all(torch.equal(p, final_a[n]) for n, p in trainer.params.items())
    check(same, "resumed parameters differ from run A's")
    del trainer, final_a
    torch.cuda.empty_cache()
    return {"params": n_params, "losses_a": losses_a, "losses_b": losses_b,
            "bit_equal": True, "save_seconds": saves,
            "save_bytes_each": save_bytes / 2,
            "step_stall_ms_total": stall_ms, "restore_seconds": restore_s,
            "restore_bytes": restore_bytes,
            "save_gb_per_s": save_bytes / 2 / saves[3] / 1e9,
            "restore_gb_per_s": restore_bytes / restore_s / 1e9,
            "corrupted": f"6/{flipped}", "restored_step": 3,
            "restore_fallbacks": fallbacks}


# ---------------------------------------------------------------------------
# this slice: the eager optimizer API, remat policies, asynchronous saves
# ---------------------------------------------------------------------------

def zero_counts(fa, fc):
    """Every launch, route and split count of the six training kernels
    set to 0, just before a path runs."""
    for c in (fa.LAUNCHES, fa.ROUTES, fc.LAUNCHES, fc.ROUTES):
        for key in c:
            c[key] = 0
    fc.SPLITS.clear()


def check_path(fa, fc, what, flash_fwd, flash_bwd, ce):
    """The counts of a path just after it ran: ``flash_fwd`` forwards,
    ``flash_bwd`` dq and dk/dv launches, ``ce`` of each CE kernel, every
    flash launch on the mma route and every CE launch on the tiled one.
    Returns the launches by kernel."""
    launches = {**fa.LAUNCHES, **fc.LAUNCHES}
    want = {"flash_fwd": flash_fwd, "flash_dq": flash_bwd,
            "flash_dkv": flash_bwd, "ce_fwd": ce, "ce_dh": ce, "ce_dw": ce}
    check(launches == want, f"{what}: launches {launches} != {want}")
    routes = {**fa.ROUTES, **fc.ROUTES}
    check(all(n == 0 for k, n in routes.items()
              if k.endswith("_scalar") or k.endswith("_staged")),
          f"{what}: routes {routes}")
    return launches


def make_optimizer(optim, name, kwargs, parameters):
    """``tests/torch_optimizer_golden.py``'s ``make`` on the port: a golden
    case's keyword arguments, ``exclude`` as Lamb's and Lars's exclusion."""
    kw = dict(kwargs, parameters=parameters)
    sub = kw.pop("exclude", None)
    if name == "Lamb" and sub:
        kw["exclude_from_weight_decay_fn"] = lambda key: sub in str(key)
    if name == "Lars" and sub:
        kw["exclude_from_weight_decay"] = [sub]
    if "sparsity" in kw:
        kw["sparsity"] = tuple(kw["sparsity"])
    return getattr(optim, name)(**kw)


def optimizer_golden(optim):
    """Each optimizer's three eager ``step()``s on the card against the
    JAX reference's ``apply_gradients`` (``paddle_tpu_torch/testdata/
    optimizer_golden.json``), within ``OPT_TOL``; the largest absolute
    error by optimizer."""
    import base64
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "optimizer_golden.json")) as f:
        gold = json.load(f)
    rec = gold["recipe"]
    shapes = {k: tuple(v) for k, v in rec["shapes"].items()}

    def arrays(seed):
        rs = np.random.RandomState(seed)
        return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}

    errs = {}
    for case in gold["cases"]:
        params = {}
        for k, v in arrays(rec["param_seed"]).items():
            p = torch.nn.Parameter(torch.from_numpy(v).cuda())
            if k in rec["lr_scales"]:
                p.optimize_attr = {"learning_rate": rec["lr_scales"][k]}
            params[k] = p
        opt = make_optimizer(optim, case["name"], case["kwargs"],
                             list(params.items()))
        for i in range(rec["steps"]):
            for k, g in arrays(rec["grad_seed"] + i).items():
                params[k].grad = torch.from_numpy(g).cuda()
            opt.step()
            opt.clear_grad()
        check(int(opt.state["step"]) == rec["steps"] and
              opt.state["step"].is_cuda, f"{case['name']}: state step")
        err = 0.0
        for k, shape in shapes.items():
            want = np.frombuffer(base64.b64decode(case["params"][k]),
                                 dtype="<f4").reshape(shape)
            got = params[k].detach().cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=OPT_TOL[0],
                                       atol=OPT_TOL[1],
                                       err_msg=f"{case['name']} {k}")
            err = max(err, float(np.max(np.abs(got - want))))
        errs[case["name"]] = err
    return errs


def eager_steps(model, opt, batch, warmup, iters):
    """The reference's dygraph loop, ``loss = model(batch);
    loss.backward(); opt.step(); opt.clear_grad()``: the losses and the ms
    of a timed step (synced before and after the timed steps)."""
    losses = []

    def one():
        loss = model(batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
    torch.cuda.synchronize()
    return [x.item() for x in losses], (time.perf_counter() - t0) / iters * 1e3


def eager_phase(fa, fc, nn, gpt, engine, optim, framework, amp):
    """``eager``: the golden optimizer steps; then ``fused_b8_pallas_ce``'s
    model and batch trained through the eager API, ``AdamW(3e-4,
    parameters=model.parameters())`` for 2 + 5 steps, which must give the
    losses and weights of ``ParallelTrainer`` on the same model and batch
    bit for bit (both call one ``apply_gradients``; the kernels are
    deterministic), then ``Lamb`` for 2 + 3 steps; then
    ``GradScaler.minimize`` on the ``amp`` phase's depth-2 float32 model
    under ``auto_cast(bfloat16)``, the step at index 2 tainted: the scale
    after each step must be ``AMP_SCALES``, with one skipped step."""
    golden_err = optimizer_golden(optim)
    ids, lbl = gpt_base_batch()
    # the yardstick: the trainer's steps on the same weights and batch
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    inputs, lbls = batch
    t_losses = [trainer.train_step(inputs, lbls) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_losses += [trainer.train_step(inputs, lbls) for _ in range(5)]
    torch.cuda.synchronize()
    trainer_ms = (time.perf_counter() - t0) / 5 * 1e3
    t_losses = [x.item() for x in t_losses]
    t_final = {n: p.detach().clone()
               for n, p in trainer.model.named_parameters()}
    del trainer, batch
    torch.cuda.empty_cache()

    model = fused_loss_layer(nn, gpt_base_model(gpt, framework), 8192,
                             ce_kernel="pallas").cuda()
    opt = optim.AdamW(3e-4, parameters=model.parameters())
    zero_counts(fa, fc)
    losses, ms = eager_steps(model, opt, (ids, lbl), warmup=2, iters=5)
    launches = check_path(fa, fc, "eager AdamW", 12 * 7, 12 * 7, 7)
    diff = [i for i, (a, b) in enumerate(zip(losses, t_losses)) if a != b]
    check(not diff, f"eager AdamW loss after {diff[0] if diff else 0} "
          f"updates {losses[diff[0]] if diff else None} != the trainer's "
          f"{t_losses[diff[0]] if diff else None}")
    same = all(torch.equal(p, t_final[n]) for n, p in model.named_parameters())
    check(same, "eager AdamW weights differ from the trainer's")
    del model, opt, t_final
    torch.cuda.empty_cache()

    model = fused_loss_layer(nn, gpt_base_model(gpt, framework), 8192,
                             ce_kernel="pallas").cuda()
    opt = optim.Lamb(2e-3, lamb_weight_decay=0.01,
                     parameters=model.named_parameters(),
                     exclude_from_weight_decay_fn=lambda k: not no_decay(k))
    zero_counts(fa, fc)
    lamb_losses, lamb_ms = eager_steps(model, opt, (ids, lbl), warmup=2,
                                       iters=3)
    lamb_launches = check_path(fa, fc, "eager Lamb", 12 * 5, 12 * 5, 5)
    check(all(np.isfinite(lamb_losses)) and lamb_losses[-1] < lamb_losses[0],
          f"Lamb losses {lamb_losses}")
    del model, opt
    torch.cuda.empty_cache()
    return {"params": n_params, "optimizer_golden_max_abs_err": golden_err,
            "optimizer_golden_tol": OPT_TOL,
            "adamw": {"losses": losses, "trainer_losses": t_losses,
                      "bit_equal_to_trainer": True, "ms_per_step": ms,
                      "trainer_ms_per_step": trainer_ms,
                      "launches": launches},
            "lamb": {"losses": lamb_losses, "ms_per_step": lamb_ms,
                     "launches": lamb_launches},
            "grad_scaler": eager_amp(amp, fa, nn, gpt, optim, framework)}


def eager_amp(amp, fa, nn, gpt, optim, framework):
    """``GradScaler.minimize`` over an eager AdamW on the ``amp`` phase's
    model (depth 2, float32 weights, chunked CE) under
    ``auto_cast(bfloat16)``; the first parameter by name has its gradient
    tainted with inf at the steps in ``AMP_TAINTED``."""
    model = fused_loss_layer(
        nn, gpt_base_model(gpt, framework, layers=2, bf16=False), 8192,
        ce_kernel="chunked").cuda()
    named = dict(model.named_parameters())
    opt = optim.AdamW(3e-4, parameters=list(named.items()))
    scaler = amp.GradScaler(**AMP_SCALER)
    batch = gpt_base_batch()
    for c in (fa.LAUNCHES, fa.ROUTES):
        for key in c:
            c[key] = 0
    losses, scales = [], []
    for step in range(len(AMP_SCALES)):
        with amp.auto_cast(dtype="bfloat16"):
            loss = model(batch)
        scaled = scaler.scale(loss)
        scaled.backward()
        if step in AMP_TAINTED:
            named[min(named)].grad.mul_(float("inf"))
        scaler.minimize(opt, scaled)
        opt.clear_grad()
        losses.append(loss.item())
        scales.append(scaler.get_loss_scaling())
    skipped = len(AMP_SCALES) - int(opt.state["step"])
    check(scales == list(AMP_SCALES), f"eager loss scales {scales} != "
          f"{list(AMP_SCALES)}")
    check(skipped == len(AMP_TAINTED), f"{skipped} skipped eager steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(all(p.dtype == torch.float32 for p in named.values()),
          "the master weights are not float32")
    launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTES)
    check(launches["flash_fwd"] == 2 * len(AMP_SCALES) and
          routes["flash_fwd_mma"] == launches["flash_fwd"],
          f"bf16 attention under auto_cast: launches {launches}")
    del model, opt, named
    torch.cuda.empty_cache()
    return {"losses": losses, "scales": scales, "skipped_steps": skipped,
            "tainted": list(AMP_TAINTED), "flash_launches": launches}


REMAT_POLICIES = (None, "full", "dots_saveable",
                  "dots_with_no_batch_dims_saveable", "nothing_saveable",
                  "everything_saveable")


def remat_phase(fa, fc, nn, gpt, framework):
    """``remat_policies``: GPT-base (bf16) at batch 32 x 1024, one forward
    and backward: embeddings, each of the 12 blocks through
    ``fleet.utils.recompute(block, h, policy=p)``, the final norm, the
    fused CE head. Once without ``recompute`` and once a policy: the peak
    allocated memory and the median ms of 3 passes after a warm-up; the
    loss and every gradient equal the plain pass's bit for bit."""
    from paddle_tpu_torch.distributed.fleet import utils as fleet_utils
    model = gpt_base_model(gpt, framework).cuda()
    ids, lbl = gpt_base_batch(batch=32)
    params = list(model.parameters())

    def one_pass(policy):
        h = model.gpt.embeddings(ids)
        for block in model.gpt.h:
            h = block(h) if policy == "no_recompute" else \
                fleet_utils.recompute(block, h, policy=policy)
        h = model.gpt.ln_f(h)
        loss = nn.functional.fused_linear_cross_entropy(
            h, model.lm_head.weight.T, lbl, chunk=8192, kernel="pallas")
        return loss.detach(), torch.autograd.grad(loss, params)

    rows, base = {}, None
    for policy in ("no_recompute",) + REMAT_POLICIES:
        zero_counts(fa, fc)
        one_pass(policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss, grads = one_pass(policy)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        # a recompute runs each block's forward, its flash forward too,
        # once more in the backward; the flash forward is a registered op,
        # which a policy sees: "everything_saveable" keeps its output
        fwd = 12 if policy in ("no_recompute", "everything_saveable") \
            else 24
        launches = check_path(fa, fc, f"remat {policy}", 4 * fwd, 4 * 12, 4)
        host = (loss.cpu(), [g.cpu() for g in grads])
        del loss, grads
        if base is None:
            base = host
        else:
            same = torch.equal(host[0], base[0]) and all(
                torch.equal(a, b) for a, b in zip(host[1], base[1]))
            check(same, f"remat {policy}: the loss or a gradient differs "
                  "from the pass without recompute")
        rows[str(policy)] = {
            "peak_gb": peak / 2 ** 30, "peak_bytes": peak,
            "ms": float(np.median(times)), "times_ms": times,
            "loss": float(host[0]), "bit_equal": True, "launches": launches}
    del model, params
    torch.cuda.empty_cache()
    return rows


def _reattest(step_dir, path):
    """Rewrite the manifest's entry for ``path`` so that its CRC attests
    the bytes now on disk (the file layer then passes)."""
    from paddle_tpu_torch.distributed import checkpoint as ck
    mpath = os.path.join(step_dir, ck.MANIFEST_NAME)
    with open(mpath) as f:
        man = json.load(f)
    man["files"][os.path.relpath(path, step_dir)] = {
        "size": os.path.getsize(path), "crc32": ck._crc_file(path)}
    with open(mpath, "w") as f:
        json.dump(man, f)


def async_checkpoint_phase(nn, gpt, engine, optim, framework, fa, fc, work):
    """``async_checkpoint``: the ``checkpoint`` phase's run A with
    ``CheckpointManager(max_to_keep=3, async_commit=True, deep_every=2)``:
    saves after steps 3 (deep) and 6 (cheap), then
    ``wait_until_finished()``. The stall, snapshot and commit times of
    each save; the ms of each step, with or without a commit in flight.

    The tamper test: a byte of step 6 inverted and its manifest rewritten
    to attest it: ``verify(6)`` and ``verify(6, deep=True)`` pass (6 has
    no digests), and on a copy of the deep step 3 treated so the deep
    verify fails. A second byte of step 6 under that manifest: a fresh
    trainer's ``restore(prefer_deep=True)`` takes step 3 with no fallback
    (a cheap step is no candidate of the deep pass, as in the reference),
    a plain ``restore()`` takes 3 with one; run B resumes bit for bit.
    Then three idle steps, a save into the reused buffers and six steps
    with its commit in flight. Last, a manager whose commits are held
    (``commit_delay``) takes two more saves: one is superseded."""
    import shutil
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.telemetry import tracing
    root = os.path.join(work, "ckpt_async")
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    inputs, lbls = batch
    mgr = ck.CheckpointManager(root, max_to_keep=3, async_commit=True,
                               deep_every=2)
    steps, saves = [], {}

    def timed_step(tr, i, run):
        busy = mgr.inflight() > 0
        t0 = time.perf_counter()
        loss = tr.train_step(inputs, lbls).item()
        steps.append({"run": run, "step": i,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "commit_in_flight": busy or mgr.inflight() > 0,
                      # a trainer's first step also warms its allocations
                      "cold": not any(r["run"] == run for r in steps)})
        return loss

    def timed_save(tr, i):
        nbuf, stall0 = len(mgr._buffers), ck.stall_seconds()
        t0 = time.perf_counter()
        check(mgr.save(i, tr.state), f"async save of step {i}")
        saves[i] = {"call_ms": (time.perf_counter() - t0) * 1e3,
                    "stall_ms": (ck.stall_seconds() - stall0) * 1e3,
                    "new_pinned_buffer": len(mgr._buffers) > nbuf}

    tracing.reset(tracing.KeepPolicy(keep_all=True))
    tracing.enable(True)
    try:
        zero_counts(fa, fc)
        losses_a = []
        with telemetry.scope(None, profile=False) as sc:
            for i in range(1, 7):
                losses_a.append(timed_step(trainer, i, "A"))
                if i in (3, 6):
                    timed_save(trainer, i)
            t0 = time.perf_counter()
            mgr.wait_until_finished()
            drain_ms = (time.perf_counter() - t0) * 1e3
            save_bytes = sc.registry.get("checkpoint_bytes_total").value(
                op="save")
        launches_a = check_path(fa, fc, "async_checkpoint run A", 72, 72, 6)
        final_a = {n: p.detach().clone() for n, p in trainer.params.items()}
        del trainer
        torch.cuda.empty_cache()
        check(mgr.all_steps() == [3, 6] and mgr.latest_valid_step() == 6,
              f"steps {mgr.all_steps()}")
        check(bool(mgr._manifest_arrays(3)) and not mgr._manifest_arrays(6),
              "step 3 is not the deep save or step 6 not the cheap one")
        check(mgr.committed_total == 2 and mgr.failed_total == 0 and
              mgr.accounted(), "run A's snapshots are not all committed")

        # the tamper test
        d6 = os.path.join(root, "6")
        p6 = os.path.join(d6, _flip_a_byte(d6))
        _reattest(d6, p6)
        tamper = {"verify_6": mgr.verify(6),
                  "verify_6_deep": mgr.verify(6, deep=True),
                  "verify_3_deep": mgr.verify(3, deep=True)}
        copy_root = os.path.join(work, "ckpt_async_copy")
        d3 = os.path.join(copy_root, "3")
        shutil.copytree(os.path.join(root, "3"), d3)
        _reattest(d3, os.path.join(d3, _flip_a_byte(d3)))
        copy = ck.CheckpointManager(copy_root)
        tamper.update(copy_verify_3=copy.verify(3),
                      copy_verify_3_deep=copy.verify(3, deep=True))
        copy.close()
        shutil.rmtree(copy_root)
        check(tamper == {"verify_6": True, "verify_6_deep": True,
                         "verify_3_deep": True, "copy_verify_3": True,
                         "copy_verify_3_deep": False},
              f"tamper verdicts {tamper}")

        # the fallback: a second byte of step 6 under that manifest
        _flip_a_byte(d6, at=1 / 3)
        check(mgr.verify(6) is False, "step 6 still verifies")
        trainer, _, _ = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                         head="pallas")
        f0 = mgr.restore_fallbacks_total
        with telemetry.scope(None, profile=False) as sc:
            t0 = time.perf_counter()
            trainer.state = mgr.restore(template=trainer.state,
                                        prefer_deep=True)
            torch.cuda.synchronize()
            restore_deep_s = time.perf_counter() - t0
            deep_pick = (mgr.last_restored_step,
                         mgr.restore_fallbacks_total - f0)
            other = mgr.restore(template=trainer.state)
            plain_pick = (mgr.last_restored_step,
                          mgr.restore_fallbacks_total - f0 - deep_pick[1])
            by_reason = sc.registry.get("ckpt_restore_fallbacks_total"
                                        ).value(reason="manifest")
        del other
        check(deep_pick == (3, 0) and plain_pick == (3, 1) and by_reason == 1,
              f"restore(prefer_deep) took {deep_pick}, restore() "
              f"{plain_pick} (step, fallbacks), {by_reason} by manifest")
        zero_counts(fa, fc)
        losses_b = [timed_step(trainer, i, "B") for i in (4, 5, 6)]
        check(losses_b == losses_a[3:], f"resumed losses {losses_b} != run "
              f"A's {losses_a[3:]}")
        check(all(torch.equal(p, final_a[n])
                  for n, p in trainer.params.items()),
              "resumed parameters differ from run A's")
        del final_a

        # steady state: idle steps, a save into the reused buffers, steps
        # with its commit in flight
        for i in (7, 8, 9):
            timed_step(trainer, i, "B")
        timed_save(trainer, 9)
        for i in range(10, 16):
            timed_step(trainer, i, "B")
        mgr.wait_until_finished()
        launches_b = check_path(fa, fc, "async_checkpoint run B", 144, 144,
                                12)
        check(mgr.failed_total == 0 and mgr.accounted() and
              mgr.latest_valid_step() == 9, "the steady-state save")
        commits = {}
        for t in tracing.snapshot_kept():
            if t["name"] != "ckpt_save":
                continue
            sp = {s["name"]: s for s in t["spans"]}
            step = sp["ckpt_save"]["attrs"]["step"]
            commits[step] = {
                "outcome": t["outcome"],
                "snapshot_ms": (sp["snapshot"]["t1_ns"] -
                                sp["snapshot"]["t0_ns"]) / 1e6,
                "commit_ms": sp["commit"]["attrs"].get("commit_ms"),
                "deep": sp["ckpt_save"]["attrs"]["deep"]}
        check(sorted(commits) == [3, 6, 9] and all(
            c["outcome"] == "committed" for c in commits.values()),
            f"kept ckpt_save traces {commits}")
        for i, s in saves.items():
            s.update(commits[i])
    finally:
        tracing.enable(False)
        tracing.reset()

    # the double buffer at full size: the first commit held, two saves
    mgr2 = ck.CheckpointManager(os.path.join(work, "ckpt_async2"),
                                max_to_keep=1, async_commit=True,
                                commit_delay=2.0)
    mgr2.save(20, trainer.state)
    deadline = time.monotonic() + 10.0
    while mgr2._committing != 20 and time.monotonic() < deadline:
        time.sleep(0.002)
    check(mgr2._committing == 20, "the first commit did not start")
    held = {}
    for i in (21, 22):
        t0 = time.perf_counter()
        mgr2.save(i, trainer.state)
        held[i] = (time.perf_counter() - t0) * 1e3
    check(mgr2.superseded_total == 1 and mgr2.inflight() == 2,
          f"superseded {mgr2.superseded_total}, in flight {mgr2.inflight()}")
    check(mgr2.flush(timeout=300.0), "the held pipeline did not drain")
    check(mgr2.committed_total == 2 and mgr2.accounted() and
          mgr2.all_steps() == [22] and len(mgr2._buffers) == 2,
          f"committed {mgr2.committed_total}, steps {mgr2.all_steps()}")
    mgr2.close()
    mgr.close()
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    shutil.rmtree(os.path.join(work, "ckpt_async2"))

    def mean_ms(rows):
        return float(np.mean([r["ms"] for r in rows])) if rows else None

    warm = [r for r in steps if not r["cold"]]
    idle = [r for r in warm if not r["commit_in_flight"]]
    busy = [r for r in warm if r["commit_in_flight"]]
    after_save = [r for r in warm if (r["run"], r["step"]) in
                  (("A", 4), ("B", 10))]
    return {"params": n_params, "save_bytes_each": save_bytes / 2,
            "saves": saves, "drain_ms": drain_ms, "steps": steps,
            "idle_step_ms": mean_ms(idle), "inflight_step_ms": mean_ms(busy),
            "first_step_after_save_ms": [r["ms"] for r in after_save],
            "inflight_over_idle": mean_ms(busy) / mean_ms(idle),
            "tamper": tamper, "restore_prefer_deep": deep_pick,
            "restore_plain": plain_pick,
            "restore_prefer_deep_seconds": restore_deep_s,
            "losses_a": losses_a, "losses_b": losses_b, "bit_equal": True,
            "held_commit_save_ms": held, "superseded": 1,
            "launches": {"A": launches_a, "B": launches_b}}


# ---------------------------------------------------------------------------
# this slice: the resilient training runtime
# ---------------------------------------------------------------------------

def resilient_batches(n=4, batch=8, seq=1024):
    """``n`` batches of random ids and labels on the card, the loader of
    the resilient runs (a fixed order, so the cursor can fast-forward)."""
    out = []
    for i in range(n):
        rs = np.random.RandomState(100 + i)
        ids = torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                               .astype(np.int32)).cuda()
        lbl = torch.from_numpy(rs.randint(0, 50304, (batch, seq))
                               .astype(np.int32)).cuda()
        out.append(((ids, lbl), 0.0))
    return out


class StepLog:
    """Wraps a trainer's ``train_step``: the loss, the wall ms (synced on
    the card) and whether the step ran the integrity check, per step."""

    def __init__(self, trainer, rows):
        self.rows = rows
        inner = trainer.train_step

        def step(*a, **kw):
            t0 = time.perf_counter()
            loss = inner(*a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ce = trainer.integrity_check_every
            rows.append({"loss": loss.item(), "ms": (t1 - t0) * 1e3,
                         "t0": t0, "t1": t1,
                         "check": bool(ce) and trainer._steps_run % ce == 0})
            return loss

        trainer.train_step = step


def _state_of(trainer):
    """Parameters and AdamW slots, cloned on the card."""
    return ({n: p.detach().clone() for n, p in trainer.params.items()},
            {n: {s: t.clone() for s, t in v.items()}
             for n, v in trainer.opt_state["slots"].items()})


def resilient_phase(nn, gpt, engine, optim, framework, fa, fc, work):
    """``resilient``: ``run_resilient`` over the main path
    (``fused_b8_pallas_ce``, full GPT-base, bf16, AdamW) with
    ``integrity_check_every=2`` and ``CheckpointManager(async_commit=True,
    deep_every=2)``, saving every 2 steps, ``nan_grad`` at step 4, over a
    loader of 4 batches.

    - Run A: 10 steps, uninterrupted.
    - Run B: the same plus ``ckpt_torn`` at 2 (a ``SimulatedCrash``, an
      in-process restart from step 0) and ``sigterm`` at 7 (exit 143 after
      the final checkpoint); a fresh trainer and manager then resume to
      step 10. B's losses after the resume and every parameter and AdamW
      slot at the end equal A's bit for bit. Counters: one skipped step,
      one restart, and no restore fallback (an aborted asynchronous commit
      is debris, not a fallback, in the reference as here).
    - The engine's fingerprints of A's final state on the card equal the
      CPU fingerprints of the same tensors copied to the host.
    - Replay: run A's state is saved as step 9 into a manager that keeps
      every save deep, ``run_resilient`` takes step 10, and
      ``replay_step(10)`` twice says ``ok``; then a run with ``param_flip``
      at step 11 (one rank: no replica sees it) commits it, and
      ``replay_step(11)`` says ``sdc``. The factory hands back the phase's
      trainer, whose whole state each replay restores.
    - Hang: ``host_hang`` at one step with ``hang_timeout=2.0`` and no
      ``hang_exit``: the watchdog fires once, the flight dump exists and
      the heartbeat stops.

    Times: the ms of check and off-cadence steps, taken in turns on run
    A's trainer after its run with no save near them (run A's own check
    steps each follow a save, whose copy off the card lands on the next
    step; its means, first step left out, are printed beside), the
    fingerprint pass alone, the drain (the end of step 6 to the return of run B's first
    call: the signal is raised at the next step boundary), the crash back
    to training (the torn commit's raise to the start of the next step)
    and the seconds of each replay."""
    import shutil
    import signal
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.resilience import (faults, integrity, replay_step,
                                             run_resilient, runner)
    from paddle_tpu_torch.telemetry import flight
    root = os.path.join(work, "resilient")
    loader = resilient_batches()
    flight_dir = os.path.join(root, "flight")
    flight.reset()
    flight.configure(flight_dir)
    sig_before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                   signal.SIGINT)}

    def trainer_for(rows):
        tr, _, n = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                    head="pallas", integrity_check_every=2)
        StepLog(tr, rows)
        return tr, n

    def manager(name, **kw):
        return ck.CheckpointManager(os.path.join(root, name), max_to_keep=3,
                                    async_commit=True, **kw)

    zero_counts(fa, fc)
    # run B's second trainer also takes the replay and hang steps, so
    # steps_b grows past run B
    steps_a, steps_b = [], []
    # run A
    with telemetry.scope(None, profile=False) as sc:
        trainer, n_params = trainer_for(steps_a)
        mgr = manager("a", deep_every=2)
        with faults.inject("nan_grad", at_step=4):
            res_a = run_resilient(trainer, loader, 10, manager=mgr,
                                  save_every=2)
        mgr.close()
        checks_a = sc.registry.get("integrity_check_steps_total").value()
    check((res_a.exit_code, res_a.steps_done, res_a.skipped_steps,
           res_a.restarts) == (0, 10, 1, 0), f"run A: {res_a}")
    check(checks_a == 5, f"run A: {checks_a} check steps, not 5")
    final_a = _state_of(trainer)
    # the engine's fingerprints of the final state (step 10 was a check
    # step) against the CPU's of the same tensors
    fps_card = trainer.last_fingerprints.tolist()
    live = [v for _, tree in trainer._integrity_trees()
            for _, v in integrity._leaves_with_path(tree)]
    t0 = time.perf_counter()
    fps_cpu = [int(integrity.fingerprint_array(v.cpu())) for v in live]
    fp_cpu_s = time.perf_counter() - t0
    check(fps_card == fps_cpu, "card fingerprints differ from the CPU's: " +
          str([trainer._integrity_entries[i][0] for i, (a, b) in
               enumerate(zip(fps_card, fps_cpu)) if a != b][:5]))
    fp_card_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._integrity_check()
        torch.cuda.synchronize()
        fp_card_ms.append((time.perf_counter() - t0) * 1e3)
    # run A's check steps each follow a save, whose copy off the card
    # lands on the next step: check and plain steps in turns, no save
    n_turns = len(steps_a)
    for every in (1, 0, 0, 1, 1, 0):
        trainer.integrity_check_every = every
        trainer.train_step(*loader[0])
    turns = steps_a[n_turns:]
    del trainer, live
    torch.cuda.empty_cache()

    # run B: a torn commit, a restart, a drain, a fresh resume
    crash_at = []
    with telemetry.scope(None, profile=False) as sc:
        trainer, _ = trainer_for(steps_b)
        mgr = manager("b", deep_every=2)
        inner_flush = mgr.flush

        def flush(*a, **kw):
            try:
                return inner_flush(*a, **kw)
            except faults.SimulatedCrash:
                crash_at.append(time.perf_counter())
                raise

        mgr.flush = flush
        with faults.inject("nan_grad", at_step=4), \
                faults.inject("ckpt_torn", at_step=2) as torn, \
                faults.inject("sigterm", at_step=7) as term:
            res_b1 = run_resilient(trainer, loader, 10, manager=mgr,
                                   save_every=2)
            t_return = time.perf_counter()
            mgr.close()
            del trainer
            torch.cuda.empty_cache()
            n_first = len(steps_b)
            trainer, _ = trainer_for(steps_b)
            mgr = manager("b", deep_every=2)
            res_b2 = run_resilient(trainer, loader, 10, manager=mgr,
                                   save_every=2)
            fallbacks = mgr.restore_fallbacks_total
            mgr.close()
        restarts = sc.registry.get("resilience_restarts_total").value()
    check(torn.fired == 1 and term.fired == 1, "run B's faults did not fire")
    check((res_b1.exit_code, res_b1.status, res_b1.restarts,
           res_b1.skipped_steps, res_b1.steps_done) ==
          (143, "sigterm", 1, 1, 7), f"run B, first call: {res_b1}")
    check((res_b2.exit_code, res_b2.steps_done, res_b2.skipped_steps) ==
          (0, 10, 1), f"run B, resumed: {res_b2}")
    check(restarts == 1 and fallbacks == 0 and
          res_b1.restore_fallbacks == res_b2.restore_fallbacks == 0,
          f"run B: {restarts} restarts, {fallbacks} fallbacks")
    losses_a = [r["loss"] for r in steps_a[:n_turns]]
    losses_b = [r["loss"] for r in steps_b]
    # steps 0-2, then 1-6 after the restart, then 7-9 after the resume
    check(losses_b[:3] == losses_a[:3] and
          losses_b[3:n_first] == losses_a[1:7],
          f"run B's losses {losses_b[:n_first]} != run A's")
    check(losses_b[n_first:] == losses_a[7:],
          f"resumed losses {losses_b[n_first:]} != run A's {losses_a[7:]}")
    params_b, slots_b = _state_of(trainer)
    check(all(torch.equal(params_b[n], final_a[0][n]) for n in params_b),
          "run B's parameters differ from run A's")
    check(all(torch.equal(slots_b[n][s], final_a[1][n][s])
              for n in slots_b for s in slots_b[n]),
          "run B's AdamW slots differ from run A's")
    del final_a, params_b, slots_b
    drain_s = t_return - steps_b[n_first - 1]["t1"]
    crash_to_training_s = steps_b[3]["t0"] - crash_at[0]

    # replay: A's end state as step 9, then steps 10 and (flipped) 11
    rec = ck.CheckpointManager(os.path.join(root, "rec"), max_to_keep=4,
                               async_commit=True, deep_digests=True)
    runner._save(rec, trainer, 9, 10 // len(loader), 10 % len(loader))
    rec.wait_until_finished()
    res_r = run_resilient(trainer, loader, 11, manager=rec, save_every=1)
    check((res_r.exit_code, res_r.steps_done) == (0, 11),
          f"the recording run: {res_r}")
    replays = {}
    t0 = time.perf_counter()
    rep_ok = replay_step(rec, 10, lambda: trainer, loader)
    replays["ok_s"] = (time.perf_counter() - t0) / 2
    with faults.inject("param_flip", at_step=11, seed=11) as flip:
        res_f = run_resilient(trainer, loader, 12, manager=rec,
                              save_every=1)
    check(flip.fired == 1 and res_f.exit_code == 0, f"the flip run: {res_f}")
    t0 = time.perf_counter()
    rep_sdc = replay_step(rec, 11, lambda: trainer, loader)
    replays["sdc_s"] = (time.perf_counter() - t0) / 2
    rec.close()
    check(rep_ok["verdict"] == "ok", f"replay of step 10: {rep_ok}")
    check(rep_sdc["verdict"] == "sdc" and rep_sdc["mismatched_keys"],
          f"replay of the flipped step 11: {rep_sdc}")

    # the hang watchdog around one wedged step
    class Beats:
        """A membership that never changes; its heartbeats are timed."""

        def __init__(self):
            self.times = []

        def heartbeat(self):
            self.times.append(time.time())

        def watch(self, proc_alive=lambda: True):
            from paddle_tpu_torch.distributed.fleet.elastic import \
                ElasticStatus
            return ElasticStatus.HOLD

    beats = Beats()
    with telemetry.scope(None, profile=False) as sc:
        with faults.inject("host_hang", at_step=1) as hang:
            t0 = time.perf_counter()
            res_h = run_resilient(trainer, loader, 3, elastic=beats,
                                  hang_timeout=2.0)
            hang_s = time.perf_counter() - t0
        fired = sc.registry.get("hang_watchdog_fired_total").value()
    check(hang.fired == 1 and res_h.exit_code == 0 and res_h.hangs == 1 and
          fired == 1, f"the hang run: {res_h}, fired {fired}")
    dumps = flight.find_dumps(flight_dir, reason="hang_watchdog")
    check(len(dumps) == 1, f"hang flight dumps {dumps}")
    with open(dumps[0]) as f:
        fired_at = json.load(f)["wall_time"]
    after = [t for t in beats.times if t > fired_at]
    check(beats.times and not after, f"{len(after)} heartbeats after the "
          f"watchdog fired ({len(beats.times)} in all)")

    n_steps = len(steps_a) + len(steps_b)
    launches = check_path(fa, fc, "resilient", 12 * n_steps, 12 * n_steps,
                          n_steps)
    del trainer
    torch.cuda.empty_cache()
    flight.configure(None)
    check({s: signal.getsignal(s) for s in sig_before} == sig_before,
          "run_resilient left a signal handler behind")
    shutil.rmtree(root)

    def mean_ms(rows, checked):
        return float(np.mean([r["ms"] for r in rows
                              if r["check"] == checked]))

    warm = steps_a[1:n_turns]
    return {"params": n_params, "losses_a": losses_a,
            "losses_b": losses_b, "bit_equal": True,
            "check_step_ms": mean_ms(turns, True),
            "off_cadence_step_ms": mean_ms(turns, False),
            "check_minus_off_ms": mean_ms(turns, True) -
            mean_ms(turns, False),
            "run_a_check_step_ms": mean_ms(warm, True),
            "run_a_off_cadence_step_ms": mean_ms(warm, False),
            "step_ms_a": [r["ms"] for r in steps_a[:n_turns]],
            "step_ms_turns": [(r["check"], r["ms"]) for r in turns],
            "fingerprint_leaves": len(fps_card),
            "fingerprint_card_ms": fp_card_ms,
            "fingerprint_cpu_s": fp_cpu_s, "fingerprints_card_eq_cpu": True,
            "integrity_check_steps_total": checks_a,
            "drain_s": drain_s, "crash_to_training_s": crash_to_training_s,
            "restarts": restarts, "skipped_steps": res_b2.skipped_steps,
            "restore_fallbacks": fallbacks,
            "replay": {"ok": rep_ok["verdict"], "sdc": rep_sdc["verdict"],
                       "sdc_keys": rep_sdc["mismatched_keys"][:4],
                       "seconds_per_replay": replays},
            "hang": {"fired": fired, "seconds": hang_s,
                     "heartbeats": len(beats.times)},
            "train_steps": n_steps, "launches": launches}


# ---------------------------------------------------------------------------
# serving_tier: jit.save/load, the Predictor, the executor cache, the fleet
# ---------------------------------------------------------------------------

def last_logits_layer(nn, model):
    """The served GPT (``tests/torch_predictor_golden.py``'s layer): the
    trunk, then the tied head on each row's last position."""
    class LastLogits(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.model = inner

        def forward(self, ids):
            h = self.model.gpt(ids)
            return self.model.lm_head(h[:, -1, :])

    return LastLogits(model)


def serving_ids(rows, seed, seq=1024, vocab=50304):
    return np.random.RandomState(seed).randint(
        0, vocab, (rows, seq)).astype(np.int32)


def golden_summary(logits, stride):
    """``tests/torch_predictor_golden.py``'s ``summarize``."""
    logits = np.asarray(logits, np.float32)
    l64 = logits.astype(np.float64)
    m = l64.max(axis=1, keepdims=True)
    return {"argmax": [int(i) for i in logits.argmax(axis=1)],
            "logsumexp": m[:, 0] + np.log(np.exp(l64 - m).sum(axis=1)),
            "strided": logits[:, ::stride]}


def predictor_ms(pred, x, reps=10, warmup=3):
    """Median ms of ``pred.run([x])`` (host ids in, host logits out) by
    CUDA events, after warm-up."""
    for _ in range(warmup):
        pred.run([x])
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        pred.run([x])
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def _route_delta(fa, before):
    return {k: fa.ROUTES[k] - before[k] for k in fa.ROUTES
            if k.startswith("flash_fwd") and fa.ROUTES[k] - before[k]}


def predictor_golden_check(fa, nn, gpt, jit, inference, root):
    """A depth-2 GPT-base-width model from the golden file's recipe,
    saved by the port and served by a Predictor on the card, against the
    JAX package's Predictor (``predictor_golden.json``)."""
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "predictor_golden.json")) as f:
        gold = json.load(f)
    cfg = gold["config"]
    model = last_logits_layer(nn, gpt.GPTForPretraining(
        tensor_parallel=False, **cfg))
    names_shapes = [(n, tuple(s)) for n, s in gold["names_shapes"]]
    check([n for n, _ in names_shapes] == list(model.named_state()),
          "predictor golden: parameter names differ from the port's")
    model.set_state_dict_from_numpy(golden_weights(
        names_shapes, gold["recipe"]["weights"]["seed"]))
    model.cuda()
    prefix = os.path.join(root, "golden", "model")
    jit.save(model, prefix,
             input_spec=[jit.InputSpec([None, gold["seq"]], "int32")])
    del model
    ids = np.random.RandomState(gold["recipe"]["ids"]["seed"]).randint(
        0, cfg["vocab_size"], (gold["rows"], gold["seq"])).astype(np.int32)
    before = dict(fa.ROUTES)
    out = inference.create_predictor(inference.Config(prefix)).run([ids])[0]
    routes = _route_delta(fa, before)
    got = golden_summary(out, gold["stride"])
    lse_err = float(np.abs(got["logsumexp"] - gold["logsumexp"]).max())
    logit_err = float(np.abs(got["strided"] - np.asarray(
        gold["strided"], np.float32)).max())
    check(got["argmax"] == gold["argmax"],
          f"predictor golden: argmax {got['argmax']} != {gold['argmax']}")
    check(lse_err <= PREDICTOR_GOLDEN_TOL and
          logit_err <= PREDICTOR_GOLDEN_TOL,
          f"predictor golden: lse err {lse_err}, logit err {logit_err} > "
          f"{PREDICTOR_GOLDEN_TOL}")
    check(routes == {"flash_fwd_scalar": cfg["num_layers"]},
          f"predictor golden: flash forward routes {routes}")
    inference.clear_layer_cache()
    return {"argmax": got["argmax"], "lse_max_abs_err": lse_err,
            "logits_max_abs_err": logit_err, "tol": PREDICTOR_GOLDEN_TOL,
            "flash_routes": routes}


def serving_generations(fa, nn, gpt, framework, jit, inference, quant,
                        root):
    """Full GPT-base (12 layers, float32 weights from seed 0) saved as a
    float32 and a bfloat16 artifact; Predictors over the float32 one raw,
    int8 and int4, and over the bfloat16 one raw and int8. Each raw
    Predictor against the eager module on the card; the quantized ones
    against the float32 Predictor; quantization on the card against the
    CPU's, bits; a batch at rows 1, 2 and 4 timed for each, and profiled
    (float32 and bfloat16, rows 1 and 4). Returns
    (report, float32 prefix, serving samples for the calibration fit)."""
    spec = [jit.InputSpec([None, 1024], "int32")]
    model = last_logits_layer(nn, gpt_base_model(gpt, framework,
                                                 bf16=False)).cuda()
    x4 = serving_ids(4, seed=11)
    x8 = serving_ids(8, seed=12)
    rep = {"export_s": {}, "load_s": {}, "vs_eager": {}, "ms": {},
           "flash_routes": {}}
    prefixes = {}
    preds = {}
    for gen in ("f32", "bf16"):
        if gen == "bf16":
            model.bfloat16()
        prefix = prefixes[gen] = os.path.join(root, gen, "model")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=spec)
        rep["export_s"][gen] = time.perf_counter() - t0
        with torch.no_grad():
            eager = model(torch.from_numpy(x4).cuda()).float().cpu().numpy()
        inference.clear_layer_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[gen] = inference.create_predictor(inference.Config(prefix))
        torch.cuda.synchronize()
        rep["load_s"][gen] = time.perf_counter() - t0
        got = preds[gen].run([x4])[0]
        rep["vs_eager"][gen] = {
            "bit_identical": bool(np.array_equal(got, eager)),
            "max_abs_diff": float(np.abs(got - eager).max())}
        check(np.isfinite(got).all() and got.shape == (4, 50304),
              f"{gen} Predictor output {got.shape}")
    del model
    torch.cuda.empty_cache()
    ref8 = preds["f32"].run([x8])[0]
    rep["quant"] = {}
    for gen, base, policy in (("int8", "f32", "int8"),
                              ("int4", "f32", "int4"),
                              ("bf16_int8", "bf16", "int8")):
        cfg = inference.Config(prefixes[base])
        cfg.enable_weight_quantize(policy)
        t0 = time.perf_counter()
        preds[gen] = inference.create_predictor(cfg)
        torch.cuda.synchronize()
        rep["load_s"][gen] = time.perf_counter() - t0
        stats = dict(preds[gen]._layer.quant_stats)
        if base == "f32":
            got = preds[gen].run([x8])[0]
            stats["max_abs_err_vs_f32"] = float(np.abs(got - ref8).max())
            stats["argmax_agree"] = float(np.mean(
                got.argmax(axis=1) == ref8.argmax(axis=1)))
        rep["quant"][gen] = stats
    q8, q4 = rep["quant"]["int8"], rep["quant"]["int4"]
    check(3.9 <= q8["compression_x"] <= 4.0 and
          7.0 <= q4["compression_x"] <= 7.2,
          f"compression_x int8 {q8['compression_x']}, int4 "
          f"{q4['compression_x']}")
    check(rep["quant"]["bf16_int8"]["n_quantized"] == 0 and
          rep["quant"]["bf16_int8"]["compression_x"] == 1.0,
          f"bf16 under int8: {rep['quant']['bf16_int8']}")
    # the block quantizers on the card against the CPU's, bit for bit
    w = preds["f32"]._layer._params[
        "model.gpt.embeddings.word_embeddings.weight"]
    same = {}
    for policy in ("int8", "int4"):
        card_q = quant.quantize_array(w, policy)
        cpu_q = quant.quantize_array(w.cpu(), policy)
        same[policy] = bool(torch.equal(card_q.q.cpu(), cpu_q.q) and
                            torch.equal(card_q.scale.cpu(), cpu_q.scale))
        check(same[policy], f"{policy} quantization: card != CPU")
    rep["card_quant_equals_cpu"] = same
    samples = []
    for gen in ("f32", "bf16", "int8", "int4"):
        before = dict(fa.ROUTES)
        rep["ms"][gen] = {}
        for rows in SERVING_ROWS:
            t = predictor_ms(preds[gen], serving_ids(rows, seed=30 + rows))
            rep["ms"][gen][rows] = t
            if gen == "f32":
                samples.append({"rows": rows, "seconds": t / 1e3})
        rep["flash_routes"][gen] = _route_delta(fa, before)
    # where a batch's time goes: the card's busy share of a Predictor call
    rep["profile"] = {
        f"{gen}_rows{rows}": profile_calls(
            lambda g=gen, r=rows: preds[g].run([serving_ids(r, seed=30 + r)]),
            calls=3)
        for gen in ("f32", "bf16") for rows in (1, 4)}
    check(set(rep["flash_routes"]["bf16"]) == {"flash_fwd_mma"} and
          all(set(rep["flash_routes"][g]) == {"flash_fwd_scalar"}
              for g in ("f32", "int8", "int4")),
          f"served flash routes by generation: {rep['flash_routes']}")
    del preds
    inference.clear_layer_cache()
    torch.cuda.empty_cache()
    return rep, prefixes["f32"], samples


def serving_from_config(serving, inference, ec, prefix, root):
    """``InferenceServer.from_config(replicas=2)``: a first server records
    its shapes in an ``ExecutorCache``; a second, primed from the manifest,
    serves rows 1 to 4 with no recompile; every answer against a direct
    ``Predictor.run`` of the same rows."""
    cache = ec.ExecutorCache(path=os.path.join(root, "executor_cache.json"))
    key = ec.artifact_key(prefix)
    cfg = inference.Config(prefix)
    scfg = serving.ServingConfig(max_batch=4,
                                 call_timeout_s=SERVING_CALL_TIMEOUT_S)
    direct = inference.create_predictor(cfg)
    xs = {n: serving_ids(n, seed=20 + n) for n in (1, 2, 3, 4)}
    want = {n: direct.run([x])[0] for n, x in xs.items()}
    with serving.InferenceServer.from_config(cfg, replicas=2,
                                             serving=scfg) as s1:
        ec.attach(s1, key, cache)
        for n, x in xs.items():
            s1.submit([x], deadline_s=60.0).result(timeout=120)
        first = s1.stats()
        check(s1.accounted(), "from_config: first server's accounting")
    s2 = serving.InferenceServer.from_config(cfg, replicas=2, serving=scfg)
    t0 = time.perf_counter()
    primed = ec.prime(s2, key, cache)
    prime_s = time.perf_counter() - t0
    with s2:
        got = {n: s2.submit([x], deadline_s=60.0).result(timeout=120)[0]
               for n, x in xs.items()}
        st = s2.stats()
        check(s2.accounted(), "from_config: primed server's accounting")
    errs = {n: float(np.abs(got[n] - want[n]).max()) for n in xs}
    check(first["recompiles"] == len(cache.shapes(key)) == primed == 3,
          f"from_config: recompiles {first['recompiles']}, recorded "
          f"{cache.shapes(key)}, primed {primed}")
    check(st["recompiles"] == 0, f"primed server recompiled: {st}")
    check(max(errs.values()) <= SERVER_TOL,
          f"served answers vs Predictor.run: {errs}")
    del direct
    inference.clear_layer_cache()
    return {"first_recompiles": first["recompiles"], "primed": primed,
            "prime_s": prime_s, "primed_recompiles": st["recompiles"],
            "max_abs_diff_vs_predictor": errs,
            "bit_identical": {n: bool(np.array_equal(got[n], want[n]))
                              for n in xs},
            "tol": SERVER_TOL, "call_timeout_s": SERVING_CALL_TIMEOUT_S}


def serving_fleet_run(nn, gpt, engine, optim, framework, serving,
                      inference, ec, fleet_mod, prefix, root):
    """``ServingFleet`` over ``predictor_generation(int8)`` of full
    GPT-base, ``watch_fn`` a ``CheckpointManager``'s ``latest_valid_step``,
    members advertised under a ``FileCoordinator`` root. Three
    ``fused_b8_pallas_ce`` steps commit step 3: published (the step's
    weights, as float32, into the artifact's ``.pdiparams`` in place, as
    the reference's chaos scenario publishes), canaried, promoted. Step 4
    holds an inf weight, which the int8 generation serves as NaN: rolled
    back and remembered; the incumbent serves on from
    its pinned layer. Live traffic runs through both swaps, and a request
    the fleet rejects fails the phase. A burst scales up, idling scales
    down, a SIGTERM drains every member once."""
    import pickle
    import shutil
    import signal
    import threading
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience.elastic import FileCoordinator

    fleet_dir = os.path.join(root, "fleet")
    os.makedirs(fleet_dir)
    fprefix = os.path.join(fleet_dir, "model")
    for suffix in (".pt2", ".pdiparams"):
        shutil.copy(prefix + suffix, fprefix + suffix)
    qspec = ("int8", None)
    cache = ec.ExecutorCache(path=os.path.join(fleet_dir, "ec.json"))
    for bucket in (1, 2, 4):    # every bucket 1-row traffic can make
        cache.record(ec.artifact_key(fprefix, qspec), (((1024,), "<i4"),),
                     bucket)
    scfg = serving.ServingConfig(max_batch=4, max_queue=256,
                                 call_timeout_s=SERVING_CALL_TIMEOUT_S)

    def make_gen(gen_id):
        return fleet_mod.predictor_generation(
            gen_id, fprefix, quant=qspec, serving=scfg,
            executor_cache=cache)

    mgr = CheckpointManager(os.path.join(fleet_dir, "ckpt"), max_to_keep=3,
                            use_async=False)

    def publish(step):
        params = mgr.restore(step)["params"]
        with open(fprefix + ".pdiparams", "rb") as fh:
            blob = pickle.load(fh)
        blob["params"] = {
            k: torch.as_tensor(params["inner." + k.split(".", 1)[1]])
            .float().cpu().numpy() for k in blob["params"]}
        tmp = fprefix + ".pdiparams.tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(blob, fh, protocol=4)
        os.replace(tmp, fprefix + ".pdiparams")
        return make_gen(step)

    coord = FileCoordinator(os.path.join(fleet_dir, "coord"), "serving")
    fcfg = fleet_mod.FleetConfig(
        min_members=2, max_members=3, cooldown_s=0.0,
        scale_up_wait_s=FLEET_SCALE_UP_WAIT_S, scale_up_queue_depth=8,
        scale_down_idle_s=1.0, canary_shadow_fraction=1.0,
        canary_min_shadow=6, canary_timeout_s=60.0,
        canary_latency_factor=3.0,
        canary_latency_slack_s=FLEET_CANARY_SLACK_S, drain_timeout_s=60.0)
    fleet = fleet_mod.ServingFleet(make_gen(0), config=fcfg,
                                   membership_root=coord.root,
                                   fleet_id="gpt_base",
                                   watch_fn=mgr.latest_valid_step,
                                   publish_fn=publish)
    rep = {}
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    stop = threading.Event()
    pump = None
    try:
        fleet.start()
        check(len(fleet.live_members()) == 2, "fleet: member files")
        probe = serving_ids(1, seed=50)
        for r in [fleet.submit([serving_ids(1, seed=60 + i)],
                               deadline_s=60.0) for i in range(8)]:
            check(np.isfinite(r.result(timeout=120)[0]).all(),
                  "fleet: warm-up output not finite")
        out0 = fleet.submit([probe], deadline_s=60.0).result(timeout=120)[0]

        pumped = {"submitted": 0, "rejected": []}

        def pump_loop():
            i = 0
            while not stop.is_set():
                try:
                    fleet.submit([serving_ids(1, seed=1000 + i)],
                                 deadline_s=60.0)
                    pumped["submitted"] += 1
                except RuntimeError as e:   # no active member: an outage
                    pumped["rejected"].append(str(e))
                i += 1
                time.sleep(FLEET_PUMP_INTERVAL_S)

        pump = threading.Thread(target=pump_loop, daemon=True)
        pump.start()
        # a good step: three main-path steps, committed, published, promoted
        trainer, batch, _ = gpt_base_trainer(nn, gpt, engine, optim,
                                             framework, head="pallas")
        inputs, lbls = batch
        losses = [float(trainer.train_step(inputs, lbls)) for _ in range(3)]
        mgr.save(3, trainer.state)
        t_commit = time.perf_counter()
        fleet.poll_once()
        rep["commit_to_promotion_s"] = time.perf_counter() - t_commit
        st = fleet.stats()
        rep["good_canary"] = dict(fleet.last_canary_checks or {})
        check(st["promoted"] == 1 and st["generation"] == 3 and
              set(st["member_generations"]) == {3},
              f"fleet: the good step was not promoted: {st}")
        out3 = fleet.submit([probe], deadline_s=60.0).result(timeout=120)[0]
        check(not np.array_equal(out3, out0), "fleet: promotion changed "
              "nothing")
        # a poisoned step: one weight overflowed to inf. Its int8 block's
        # scale is inf, so the block dequantizes to NaN (0 * inf) and the
        # step serves NaN. A NaN weight would not show: the quantizer, as
        # the reference's, gives a NaN block scale 1 and casts the NaN to 0
        with torch.no_grad():
            trainer.model.inner.gpt.h[0].mlp.fc_in.weight.view(-1)[7] = \
                float("inf")
        mgr.save(4, trainer.state)
        t_commit = time.perf_counter()
        fleet.poll_once()
        rep["commit_to_rollback_s"] = time.perf_counter() - t_commit
        st = fleet.stats()
        rep["bad_canary"] = dict(fleet.last_canary_checks or {})
        check(st["rolled_back"] == 1 and st["generation"] == 3 and
              rep["bad_canary"].get("sanity") is False,
              f"fleet: the inf step was not rolled back: {st}, "
              f"{rep['bad_canary']}")
        fleet.poll_once()       # remembered: not published again
        check(fleet.stats()["rolled_back"] == 1, "fleet: retried step 4")
        again = fleet.submit([probe], deadline_s=60.0).result(timeout=120)[0]
        rep["incumbent_after_rollback_max_abs_diff"] = float(
            np.abs(again - out3).max())
        # the same generation; the probe may share a batch with live
        # traffic (other GEMM shapes), so not bit for bit
        check(rep["incumbent_after_rollback_max_abs_diff"] <= SERVER_TOL,
              "fleet: the incumbent's answer changed after the rollback")
        del trainer, batch, inputs, lbls
        stop.set()
        pump.join(timeout=30)
        rep["pump_submitted"] = pumped["submitted"]
        rep["pump_rejected"] = len(pumped["rejected"])
        check(not pumped["rejected"] and pumped["submitted"] > 0,
              f"fleet: {pumped['submitted']} live requests during the "
              f"swaps, {len(pumped['rejected'])} rejected: "
              f"{pumped['rejected'][:3]}")
        torch.cuda.empty_cache()
        # a burst scales up; idling scales down
        burst = [fleet.submit([serving_ids(1, seed=2000 + i)],
                              deadline_s=120.0) for i in range(32)]
        fleet.poll_once()
        rep["members_after_burst"] = fleet.stats()["members"]
        for r in burst:
            r.result(timeout=300)
        t = time.monotonic() + 100.0
        fleet.poll_once(now=t)
        fleet.poll_once(now=t + fcfg.scale_down_idle_s + 1.0)
        st = fleet.stats()
        rep["members_after_idle"] = st["members"]
        check(rep["members_after_burst"] == 3 and st["scale_ups"] == 1 and
              st["members"] == 2 and st["scale_downs"] == 1,
              f"fleet: burst {rep['members_after_burst']} members, then "
              f"{st}")
        # SIGTERM: one drain of every member
        drains = {}
        with fleet._lock:
            members = list(fleet._members)
        for mem in members:
            real = mem.server.shutdown

            def counting(drain=True, timeout=30.0, _real=real,
                         _name=mem.name):
                _real(drain=drain, timeout=timeout)
                drains.setdefault(_name, []).append(time.perf_counter())

            mem.server.shutdown = counting
        tail = [fleet.submit([serving_ids(1, seed=3000 + i)],
                             deadline_s=60.0) for i in range(8)]
        fleet.install_sigterm_drain()
        t_kill = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 120.0
        while len(drains) < len(members) and time.monotonic() < deadline:
            time.sleep(0.01)
        rep["drain_s"] = max(v[0] for v in drains.values()) - t_kill \
            if drains else None
        fleet.shutdown(drain=True)      # a second call: a no-op
        check({k: len(v) for k, v in drains.items()} ==
              {m.name: 1 for m in members} and fleet._shutdowns == 1,
              f"fleet: drains {drains}")
        check(all(r.done() for r in tail), "fleet: a request outlived the "
              "drain")
        check(fleet.live_members() == [], "fleet: member files left")
    finally:
        stop.set()
        if pump is not None:
            pump.join(timeout=30)
        fleet.shutdown(drain=True)
        signal.signal(signal.SIGTERM, prev_sigterm)
        mgr.close()
    st = fleet.stats()
    check(fleet.accounted(), "fleet: accounting does not close")
    check(st["recompiles"] == 0 and st["failed"] == 0,
          f"fleet: {st['recompiles']} recompiles, {st['failed']} failed")
    rep.update({"losses": losses, "promoted": st["promoted"],
                "rolled_back": st["rolled_back"],
                "scale_ups": st["scale_ups"],
                "scale_downs": st["scale_downs"],
                "servers_ever": st["servers_ever"],
                "submitted": st["submitted"], "completed": st["completed"],
                "shed": st["shed"], "recompiles": st["recompiles"],
                "accounted": True})
    inference.clear_layer_cache()
    torch.cuda.empty_cache()
    return rep


def decode_fleet_run(pa, dm, kvc, serving, fleet_mod, params, prompts,
                     oracle, max_new):
    """A fleet of two ``DecodeServer``s at GPT-base widths (the decode
    golden's model, each member with its own paged cache) through
    ``submit_generate``: every token against the dense oracle."""
    def make_server():
        cache = kvc.PagedKVCache(num_pages=1024, page_size=16, num_heads=12,
                                 head_dim=64)
        return serving.DecodeServer(
            dm.make_step_fn(params, cache), cache, replicas=1,
            config=serving.ServingConfig(max_batch=256,
                                         call_timeout_s=60.0),
            prefill_chunk=32, max_pages_per_seq=64, max_batch_rows=8)

    fleet = fleet_mod.ServingFleet(
        fleet_mod.ModelGeneration(0, make_server),
        config=fleet_mod.FleetConfig(min_members=2, max_members=2))
    n = 8
    before = dict(pa.LAUNCHES)
    t0 = time.perf_counter()
    with fleet:
        reqs = [fleet.submit_generate(pr, max_new) for pr in prompts[:n]]
        outs = [[int(t) for t in r.result(timeout=600)[0]] for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        served = [m.server.stats()["completed"] for m in fleet._members]
    launches = {k: pa.LAUNCHES[k] - before[k] for k in pa.LAUNCHES}
    for i, toks in enumerate(outs):
        check(toks == oracle[i], f"decode fleet: prompt {i} != oracle")
    check(fleet.accounted(), "decode fleet: accounting does not close")
    check(launches["decode"] > 0 and launches["verify"] > 0,
          f"decode fleet: paged launches {launches}")
    return {"generations": n, "max_new": max_new, "tokens_equal": True,
            "served_by_member": served, "launches": launches,
            "wall_s": wall}


def serving_calibration(serving, inference, calibration, prefix, samples,
                        root):
    """``calibration.fit(serving_samples=...)`` on the Predictor batches
    the card served; a new server starts ``"calibrated"``, turns
    ``"ewma"`` after its first batch and records the
    ``serving_queue_wait`` pair."""
    old = os.environ.get("PADDLE_TPU_TORCH_CALIBRATION_DB")
    os.environ["PADDLE_TPU_TORCH_CALIBRATION_DB"] = os.path.join(
        root, "calibration_db.json")
    calibration.clear_cache()
    calibration.reset()
    try:
        fit = calibration.fit(serving_samples=samples)
        srv = serving.InferenceServer.from_config(
            inference.Config(prefix), replicas=1,
            serving=serving.ServingConfig(
                max_batch=4, call_timeout_s=SERVING_CALL_TIMEOUT_S))
        src0 = srv.stats()["modeled_wait_source"]
        wait0 = srv.modeled_wait(1)
        with srv:
            req = srv.submit([serving_ids(1, seed=40)], deadline_s=60.0)
            req.result(timeout=120)
            src1 = srv.stats()["modeled_wait_source"]
        pair = calibration.pair("serving_queue_wait")
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_TORCH_CALIBRATION_DB", None)
        else:
            os.environ["PADDLE_TPU_TORCH_CALIBRATION_DB"] = old
        calibration.clear_cache()
    check(src0 == "calibrated" and src1 == "ewma",
          f"modeled_wait_source {src0} then {src1}")
    check(pair is not None and req.t_predicted_wait,
          f"no serving_queue_wait pair: {pair}")
    inference.clear_layer_cache()
    return {"fitted": fit["entry"]["serving"], "first_source": src0,
            "modeled_wait_s_cold": wait0, "after_first_batch": src1,
            "serving_queue_wait": pair}


def serving_tier_phase(fa, fc, pa, nn, gpt, engine, optim, framework, dm,
                       kvc, serving, params, prompts, oracle, max_new,
                       work):
    """``serving_tier``: the serving path of GPT-base on the card (module
    functions above, in order): the Predictor golden; three generations of
    full GPT-base (float32, bfloat16, float32 under int8 and int4); the
    executor cache under ``InferenceServer.from_config``; the int8 fleet
    rolled from checkpoints; a decode fleet; the calibrated admission.
    Every launch count of the flash, CE and paged kernels set to 0 before,
    read after."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.inference import executor_cache as ec
    from paddle_tpu_torch.inference import fleet as fleet_mod
    from paddle_tpu_torch.inference import quant
    from paddle_tpu_torch.telemetry import calibration

    import gc
    root = os.path.join(work, "serving_tier")
    os.makedirs(root)
    t0 = time.perf_counter()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    zero_counts(fa, fc)
    for counts in (pa.LAUNCHES, pa.ROUTES):
        for k in counts:
            counts[k] = 0
    rep = {"golden": predictor_golden_check(fa, nn, gpt, jit, inference,
                                            root)}
    gens, prefix, samples = serving_generations(fa, nn, gpt, framework, jit,
                                                inference, quant, root)
    rep["generations"] = gens
    rep["from_config"] = serving_from_config(serving, inference, ec, prefix,
                                             root)
    rep["fleet"] = serving_fleet_run(nn, gpt, engine, optim, framework,
                                     serving, inference, ec, fleet_mod,
                                     prefix, root)
    rep["decode_fleet"] = decode_fleet_run(pa, dm, kvc, serving, fleet_mod,
                                           params, prompts, oracle, max_new)
    rep["calibration"] = serving_calibration(serving, inference,
                                             calibration, prefix, samples,
                                             root)
    launches = {**fa.LAUNCHES, **fc.LAUNCHES, **pa.LAUNCHES}
    routes = {**fa.ROUTES, **pa.ROUTES}
    check(fa.ROUTES["flash_fwd_scalar"] > 0 and fa.ROUTES["flash_fwd_mma"] > 0
          and pa.LAUNCHES["decode"] > 0 and pa.LAUNCHES["verify"] > 0,
          f"serving_tier launches {launches}, routes {routes}")
    # what the phase leaves on the card: each worker thread that ran a GEMM
    # took a cuBLAS handle whose workspace PyTorch keeps after the thread
    # ends; with those freed, nothing of the phase may stay
    gc.collect()
    held = torch.cuda.memory_allocated() - mem0
    torch._C._cuda_clearCublasWorkspaces()
    held_cleared = torch.cuda.memory_allocated() - mem0
    check(held_cleared <= 16 * 2 ** 20,
          f"serving_tier left {held_cleared} bytes allocated on the card")
    rep.update(launches=launches, routes=routes,
               bytes_held_after={"with_cublas_workspaces": held,
                                 "workspaces_freed": held_cleared},
               seconds=time.perf_counter() - t0)
    return rep


# ---------------------------------------------------------------------------
# this slice: ZeRO through the fleet API, and the checkpoint of a world
# ---------------------------------------------------------------------------

ZERO_LEVELS = {1: "os", 2: "os_g", 3: "p_g_os"}


def zero_trainer(nn, gpt, optim, framework, fleet, sharding, stage):
    """The main path built as a fleet user builds it: ``fleet.init`` with
    every degree 1 and ``strategy.sharding``, ``distributed_model`` and
    ``distributed_optimizer``, then (stage > 0) ``group_sharded_parallel``
    at the stage's level and ``sharding.build_trainer``. Full GPT-base,
    bf16, the fused CE kernels, AdamW(3e-4)."""
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": max(stage, 1)}
    fleet.init(is_collective=True, strategy=strategy)
    model = gpt_base_model(gpt, framework)
    dm = fleet.distributed_model(fused_loss_layer(nn, model, 8192,
                                                  ce_kernel="pallas"))
    opt = fleet.distributed_optimizer(optim.AdamW(3e-4))
    if stage:
        dm, opt, _ = sharding.group_sharded_parallel(dm, opt,
                                                     ZERO_LEVELS[stage])
    return sharding.build_trainer(dm, opt, lambda out, _l: out)


def _timed_step(trainer, inputs, lbls):
    """One step, synced before and after -> (loss, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_step(inputs, lbls).item()
    return loss, (time.perf_counter() - t0) * 1e3


def zero_phase(fa, fc, nn, gpt, optim, framework, work):
    """``zero``: ``fused_b8_pallas_ce`` through the fleet API at ZeRO
    stages 0-3 on an NCCL mesh of one rank (``dp_setup``), 2 warm-up and 3
    timed steps each. At one rank every stage is stage 0, as the
    reference gates each at n_shard > 1: the losses and final parameters
    of stages 1-3 must equal stage 0's bit for bit, and the six kernels
    launch 36/36/36 and 3/3/3 times in the timed steps, on the mma and
    tiled routes. Stage 3 saves step 3 through ``CheckpointManager``
    (the trainer's state over one rank is no world: the one-rank format);
    a fresh fleet-built trainer restores it and its steps 4-5 must equal
    the uninterrupted run's bit for bit. Peak allocated memory per
    stage."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import fleet, sharding
    dp_setup()
    root = os.path.join(work, "zero_ckpt")
    stages, launches = {}, {k: 0 for k in REPLACES if k not in
                            ("decode", "verify")}
    final0 = None
    try:
        for stage in (0, 1, 2, 3):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer = zero_trainer(nn, gpt, optim, framework, fleet,
                                   sharding, stage)
            batch = (gpt_base_batch(), 0.0)
            losses, ms = [], []
            for _ in range(2):
                losses.append(trainer.train_step(*batch).item())
            zero_counts(fa, fc)
            save = {}
            for i in range(3, 6):
                loss, t = _timed_step(trainer, *batch)
                losses.append(loss)
                ms.append(t)
                if stage == 3 and i == 3:
                    mgr = ck.CheckpointManager(root)
                    t0 = time.perf_counter()
                    check(mgr.save(3, {"trainer": trainer.state}),
                          "the stage-3 save of step 3")
                    save["seconds"] = time.perf_counter() - t0
                    save["files"] = sorted(os.listdir(
                        os.path.join(root, "3")))
            got = check_path(fa, fc, f"zero stage {stage}", 36, 36, 3)
            for k, n in got.items():
                launches[k] += n
            check(trainer.skipped_steps() == 0, "the NaN guard skipped")
            check((trainer.zero_stage, trainer.n_shard, trainer.zero2_dims,
                   trainer.zero3_dims) == (stage, 1, {}, {}),
                  f"stage {stage}: a ZeRO split at one rank")
            final = {n: p.detach().cpu().clone()
                     for n, p in trainer.params.items()}
            stages[stage] = {
                "losses": losses, "ms_per_step": ms,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2 ** 30,
                "optimizer": type(trainer.optimizer).__name__,
                "model": type(trainer.model).__name__}
            if stage == 0:
                base, final0 = losses, final
            else:
                check(losses == base, f"stage {stage} losses {losses} != "
                      f"stage 0's {base}")
                check(all(torch.equal(v, final0[n])
                          for n, v in final.items()),
                      f"stage {stage} parameters differ from stage 0's")
            del trainer
        # resume stage 3 from the checkpoint on a fresh trainer
        check(not ck.is_sharded_dir(os.path.join(root, "3")) and
              save["files"] == ["MANIFEST.json", "trainer.pt"],
              f"the step directory holds {save['files']}")
        torch.cuda.empty_cache()
        trainer = zero_trainer(nn, gpt, optim, framework, fleet, sharding,
                               3)
        mgr = ck.CheckpointManager(root)
        t0 = time.perf_counter()
        trainer.state = mgr.restore(template={"trainer": trainer.state}
                                    )["trainer"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(mgr.last_restored_step == 3 and mgr.verify(3) is True,
              f"restored step {mgr.last_restored_step}")
        zero_counts(fa, fc)
        resumed = [trainer.train_step(*batch).item() for _ in range(2)]
        got = check_path(fa, fc, "zero resume", 24, 24, 2)
        for k, n in got.items():
            launches[k] += n
        check(resumed == base[3:], f"resumed losses {resumed} != "
              f"{base[3:]}")
        check(all(torch.equal(p.detach().cpu(), final0[n])
                  for n, p in trainer.params.items()),
              "resumed parameters differ from the uninterrupted run's")
        del trainer, final0
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"stages": stages, "bit_equal_to_stage_0": True,
            "checkpoint": {"format": "one-rank", "step": 3,
                           "save_seconds": save["seconds"],
                           "restore_seconds": restore_s,
                           "files": save["files"],
                           "resumed_losses": resumed,
                           "resume_bit_equal": True},
            "launches": launches}


# hybrid (h3): the ring's block steps over four chunks against the flash
# kernels over the whole sequence.
# - out and lse: each side within its kernels' bound of exact attention
#   (MMA_FWD_BOUND; each ring block the same kernel at its own rows), and
#   the ring rounds each block's out to bf16 once before its float32
#   merge, a convex combination of block outputs (one rounding, 2**-8 of
#   it); lse is float32 on both sides (the merge's logaddexp), within 2 x
#   MMA_FWD_BOUND's lse bar plus 8 float32 ulps of lse ~ 9 (8 * 2**-20).
# - the accumulation: the ring's dq, dk and dv equal, bit for bit, the
#   float32 sums, in the ring's order, of its blocks' kernel outputs
#   launched one by one (ring_block_sums; the kernels repeat their bits,
#   flash_repeat). That is what float32 accumulators give; one kept in
#   bf16 rounds each partial sum and fails it
#   (tests/test_torch_ring_rounding.py).
# - dq, dk, dv against the whole-sequence backward kernels run on the
#   ring's own out and lse: the same lse and delta, so the same p and ds
#   on both sides. They differ by the bf16 roundings of the block outputs
#   g_j and of the two results, independent, each with an RMS error at
#   most RING_ROUNDING of its value (the error uniform within half an ulp,
#   the ulp at most 2**-7 of the value), so ||ring - whole|| / ||whole||
#   <= RING_ROUNDING * sqrt(sum_j ||g_j||**2 / ||whole||**2 + 2)
#   (ring_grad_bar), over a few million elements
RING_CHUNKS = 4
RING_BOUND = {"out_rel": 2 * MMA_FWD_BOUND["out_rel"] + 2 ** -8,
              "lse_abs": 2 * MMA_FWD_BOUND["lse_abs"] + 8 * 2 ** -20}
RING_ROUNDING = 2 ** -7 / 12 ** 0.5


def ring_block_sums(ra, q, k, v, do, out, lse, n, causal):
    """The ring's gradients rebuilt from its blocks: each block's
    ``block_backward`` (the dq and dk/dv kernels on a CUDA tensor, their
    plain versions on the CPU) on the ring's ``out`` and ``lse``, summed in
    float32 in the ring's order (hop ``j`` adds block ``(i, (i - j) mod
    n)``) -> ``((dq, dk, dv) in q's dtype, [sum_j ||g_j||**2 of each])``."""
    sm_scale = ra._scale(q.shape[-1], None)
    qs, ks, vs, dos, outs = (t.chunk(n, dim=1) for t in (q, k, v, do, out))
    lses = [t.contiguous() for t in lse.chunk(n, dim=2)]
    acc = [[torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in ts] for ts in (qs, ks, vs)]
    sq = [0.0, 0.0, 0.0]
    for j in range(n):
        for i in range(n):
            src = (i - j) % n
            mode = ra._mode(i, src, causal)
            if mode is None:
                continue
            g = ra.block_backward(qs[i], ks[src], vs[src], dos[i], lses[i],
                                  ra._delta(outs[i], dos[i]), mode,
                                  sm_scale)
            for x, at in enumerate((i, src, src)):
                acc[x][at] += g[x].float()
                sq[x] += float(g[x].float().square().sum())
    return tuple(torch.cat(a, dim=1).to(q.dtype) for a in acc), sq


def ring_grad_bar(block_sq, whole) -> float:
    """The bar of ||ring - whole|| / ||whole|| for one gradient, from its
    blocks' ``sum_j ||g_j||**2`` (the comment above RING_CHUNKS)."""
    w = float(whole.float().square().sum())
    return RING_ROUNDING * (block_sq / w + 2) ** 0.5


# hybrid (h1): GPTForPretraining(tensor_parallel=True) at mp 1 against the
# dense logits + cross_entropy on the same weights: bf16 training drifts
# apart in the summation order of the loss (ParallelCrossEntropy's float32
# max/sum-exp against logsumexp): train_variants' band
HYBRID_LOSS_RTOL = 1e-2


def hybrid_phase(fa, fc, nn, gpt, optim, framework, layers=12, seq=1024,
                 batch=8, ring=(4, 4096, 12, 64)):
    """``hybrid``: tensor, pipeline and context parallelism on one card
    through the fleet API, on an NCCL mesh of one rank (``dp_setup``).

    - (h1) ``GPTForPretraining(tensor_parallel=True)`` at ``mp_degree`` 1
      under ``TensorParallel`` (built on ``fleet.init``'s hcg; at degree 1
      ``distributed_model`` gives ``DataParallel``, as the reference's),
      ``loss`` through ``ParallelCrossEntropy``, batch 8 x 1024, 2 warm-up
      and 3 timed steps, against ``dense_b8`` (the same weights, dense
      logits + ``cross_entropy``) within ``HYBRID_LOSS_RTOL``; 36
      launches of each flash kernel on the mma route, no CE launch.
    - (h2) ``PipelineLayer(gpt_pipeline_descs(tensor_parallel=False))`` at
      one stage under ``PipelineParallel`` with ``accumulate_steps`` 4
      (micro-batches of 2 x 1024), GPipe and 1F1B: bit for bit each
      other and the trainer's gradient merge over 4 chunks on the same
      weights (the same operations in the same order).
    - (h3) the ring's block steps (``ring_attention_local``) over
      ``RING_CHUNKS`` chunks of one sequence (B 4, S 4096, H 12, D 64,
      bf16), causal and not: out and lse against the flash kernels over
      the whole sequence within ``RING_BOUND``; dq, dk, dv bit for bit
      the float32 sums of the blocks' kernel outputs
      (``ring_block_sums``) and against the whole-sequence backward on
      the ring's out and lse within ``ring_grad_bar``; the device times
      of both, and the blocks' launches (10 causal, 16 not, each on the
      mma route).
    """
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import engine, fleet
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineLayer, PipelineParallel, TensorParallel)
    from paddle_tpu_torch.ops import ring_attention as ra
    dp_setup()
    out = {}
    launches = {k: 0 for k in REPLACES if k not in ("decode", "verify")}

    def count(got):
        for k, n in got.items():
            launches[k] += n

    def run_steps(trainer, batch_args, what, fwd, bwd):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = [trainer.train_step(*batch_args).item() for _ in range(2)]
        zero_counts(fa, fc)
        ms = []
        for _ in range(3):
            loss, t = _timed_step(trainer, *batch_args)
            losses.append(loss)
            ms.append(t)
        count(check_path(fa, fc, what, fwd, bwd, 0))
        check(trainer.skipped_steps() == 0, f"{what}: a step skipped")
        check(all(np.isfinite(losses)), f"{what}: losses {losses}")
        return {"losses": losses, "ms_per_step": ms,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2 ** 30}

    try:
        ids, lbl = gpt_base_batch(batch, seq)
        dense = gpt_base_model(gpt, framework, seq, layers)
        state = {k: v.detach().float().numpy()
                 for k, v in dense.named_state().items()}
        ce = lambda lg, y: nn.functional.cross_entropy(lg, y)  # noqa: E731
        per = 3 * layers

        # the yardstick: dense_b8 on these weights
        tr = engine.ParallelTrainer(dense, optim.AdamW(3e-4), ce)
        out["dense_b8"] = run_steps(tr, (ids, lbl), "hybrid dense_b8", per,
                                    per)
        del tr, dense

        # (h1) tensor parallelism at mp_degree 1
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                                   "pp_degree": 1, "sharding_degree": 1}
        strategy.pipeline_configs = {"accumulate_steps": 4,
                                     "schedule": "gpipe"}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        framework.seed(0)
        model = gpt.GPTForPretraining(
            tensor_parallel=True, vocab_size=50304, hidden_size=768,
            num_layers=layers, num_heads=12, max_position_embeddings=seq,
            attn_dropout=0.0, hidden_dropout=0.0)
        model.set_state_dict_from_numpy(state)
        model = TensorParallel(model.bfloat16(), hcg, strategy)
        tr = engine.ParallelTrainer(
            model, fleet.distributed_optimizer(optim.AdamW(3e-4)),
            model.loss)
        h1 = run_steps(tr, (ids, lbl), "hybrid h1", per, per)
        check(np.allclose(h1["losses"], out["dense_b8"]["losses"],
                          rtol=HYBRID_LOSS_RTOL),
              f"h1 losses {h1['losses']} vs dense_b8 "
              f"{out['dense_b8']['losses']}")
        h1["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in zip(
            h1["losses"], out["dense_b8"]["losses"]))
        out["h1_tensor_parallel"] = h1
        del tr, model

        # (h2) the pipeline at one stage, GPipe and 1F1B, and the trainer's
        # gradient merge over the same 4 chunks
        pstate = gpt.pipeline_state_from_dense(state, layers)
        rows = {}
        for schedule in ("gpipe", "1f1b"):
            strategy.pipeline_configs = {"accumulate_steps": 4,
                                         "schedule": schedule}
            pl = PipelineLayer(gpt.gpt_pipeline_descs(
                vocab_size=50304, hidden_size=768, num_layers=layers,
                num_heads=12, max_position_embeddings=seq, dropout=0.0,
                tensor_parallel=False), num_stages=1)
            pl.set_state_dict_from_numpy(pstate)
            pp = PipelineParallel(pl.bfloat16(), hcg, strategy)
            tr = engine.ParallelTrainer(pp, optim.AdamW(3e-4), ce,
                                        micro_batches=4)
            rows[schedule] = run_steps(tr, (ids, lbl), f"hybrid h2 "
                                       f"{schedule}", 4 * per, 4 * per)
            rows[schedule]["max_in_flight"] = pp.max_in_flight
            rows[schedule]["final"] = {
                k: p.detach().cpu().clone() for k, p in tr.params.items()}
            del tr, pp, pl
        dense = gpt_base_model(gpt, framework, seq, layers)
        dense.set_state_dict_from_numpy(state)
        tr = engine.ParallelTrainer(dense, optim.AdamW(3e-4), ce,
                                    accumulate_steps=4)
        merge = run_steps(tr, (ids, lbl), "hybrid h2 merge", 4 * per,
                          4 * per)
        merged = gpt.pipeline_state_from_dense(
            {k: p.detach().cpu() for k, p in tr.params.items()}, layers)
        del tr, dense
        g, f = rows["gpipe"], rows["1f1b"]
        check(g["losses"] == f["losses"] and all(
            torch.equal(v, f["final"][k]) for k, v in g["final"].items()),
            "h2: GPipe and 1F1B differ")
        check((g["max_in_flight"], f["max_in_flight"]) == (4, 1),
              f"h2 in flight {g['max_in_flight']}, {f['max_in_flight']}")
        check(g["losses"] == merge["losses"] and all(
            torch.equal(v, merged[k]) for k, v in g["final"].items()),
            f"h2: the pipeline and the gradient merge differ (losses "
            f"{g['losses']} vs {merge['losses']}, or a final parameter)")
        for r in rows.values():
            r.pop("final")
        out["h2_pipeline"] = {**rows, "gradient_merge": merge,
                              "bit_equal_to_merge": True,
                              "gpipe_equals_1f1b": True}
        del merged
        torch.cuda.empty_cache()

        # (h3) the ring on one card
        out["h3_ring"] = ring_on_one_card(fa, ra, *ring)
        count(out["h3_ring"].pop("launches"))
    finally:
        dist.destroy_process_group()
    out["launches"] = launches
    return out


def ring_on_one_card(fa, ra, b, s, h, d):
    """(h3): the ring's block steps over RING_CHUNKS chunks against the
    flash kernels over the whole sequence, causal and not."""
    n = RING_CHUNKS
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    res, launches = {}, {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for causal in (True, False):
        for c in (fa.LAUNCHES, fa.ROUTES):
            for key in c:
                c[key] = 0
        r_out, r_lse, r_grads = ra.ring_attention_local(q, k, v, n, causal,
                                                        do=do)
        torch.cuda.synchronize()
        blocks = n * (n + 1) // 2 if causal else n * n
        got = dict(fa.LAUNCHES)
        check(got == {"flash_fwd": blocks, "flash_dq": blocks,
                      "flash_dkv": blocks},
              f"ring launches {got}, not {blocks} blocks each")
        check(fa.ROUTES == {f"{key}_{route}": blocks * (route == "mma")
                            for key in got for route in ("mma", "scalar")},
              f"ring routes {fa.ROUTES}")
        for key in launches:
            launches[key] += got[key]
        w_out, w_lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        w_grads = fa.flash_attention_bwd(q, k, v, w_out, w_lse, do,
                                         causal=causal)
        # the whole-sequence backward on the ring's own out and lse, and
        # the ring's blocks one by one (comparison launches, not counted)
        o_grads = fa.flash_attention_bwd(q, k, v, r_out, r_lse, do,
                                         causal=causal)
        sums, block_sq = ring_block_sums(ra, q, k, v, do, r_out, r_lse, n,
                                         causal)
        rel = lambda a, w: float((a.float() - w.float()).norm() /  # noqa
                                 w.float().norm())
        names = ("dq", "dk", "dv")
        errs = {"out_rel": rel(r_out, w_out),
                "lse_abs": float((r_lse - w_lse).abs().max()),
                **{f"{x}_rel": rel(a, w) for x, a, w in
                   zip(names, r_grads, o_grads)}}
        bars = {f"{x}_rel": ring_grad_bar(sq, w)
                for x, sq, w in zip(names, block_sq, o_grads)}
        # the gradients against the whole-sequence kernels' own forward
        # and backward: a reading (its lse and delta differ from the
        # ring's by float32 ulps and out's roundings)
        independent = {f"{x}_rel": rel(a, w) for x, a, w in
                       zip(names, r_grads, w_grads)}
        what = "causal" if causal else "full"
        check(all(torch.equal(a, b) for a, b in zip(r_grads, sums)),
              f"ring ({what}): dq/dk/dv are not the float32 sums of the "
              f"blocks' kernel outputs")
        check(errs["out_rel"] <= RING_BOUND["out_rel"] and
              errs["lse_abs"] <= RING_BOUND["lse_abs"] and
              all(errs[x] <= bars[x] for x in bars),
              f"ring vs whole ({what}): {errs} over {RING_BOUND}, {bars}")
        fwd_ms = time_ms(lambda: ra.ring_attention_local(q, k, v, n, causal),
                         reps=10, warmup=2)
        both_ms = time_ms(lambda: ra.ring_attention_local(q, k, v, n, causal,
                                                          do=do),
                          reps=10, warmup=2)
        w_fwd_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                          causal=causal),
                           reps=10, warmup=2)

        def whole_both():
            o, l_ = fa.flash_attention_fwd(q, k, v, causal=causal)
            fa.flash_attention_bwd(q, k, v, o, l_, do, causal=causal)
        w_both_ms = time_ms(whole_both, reps=10, warmup=2)
        res["causal" if causal else "full"] = {
            "shape": [b, s, h, d], "chunks": n, "blocks": blocks,
            "errors": errs, "bound": {**RING_BOUND, **bars},
            "grads_vs_independent_whole": independent,
            "grads_equal_block_sums": True,
            "ring_fwd_ms": fwd_ms, "ring_fwd_bwd_ms": both_ms,
            "whole_fwd_ms": w_fwd_ms, "whole_fwd_bwd_ms": w_both_ms}
    res["launches"] = launches
    return res


# -- vision: ResNet-50 ---------------------------------------------------------

RESNET_LOSS_RTOL = (1e-4, 1e-3)     # step 0, later steps (train_golden's)
RESNET_GRAD_NORM_RTOL = 2e-3
RESNET_UPDATE_RTOL = 1e-2


def _ce(nn):
    return lambda logits, y: nn.functional.cross_entropy(logits, y)


def resnet_golden(nn, optim, engine, mesh_mod, models):
    """(v1) ResNet-50 at full width, float32 (TF32 off), the golden's
    batch and optimizer, three ``train_step``s against
    ``resnet_golden.json``: the step-0 loss (rtol 1e-4) and gradient norm
    (``RESNET_GRAD_NORM_RTOL``), the later losses (1e-3) and the tracked
    parameters' update norms (``RESNET_UPDATE_RTOL``; their sums beside
    the golden's, unchecked)."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "resnet_golden.json")) as f:
        gold = json.load(f)
    cfg, rw = gold["config"], gold["recipe"]["weights"]
    check(cfg["model"] == "resnet50" and cfg["dtype"] == "float32",
          f"golden config {cfg}")
    model = models.resnet50()
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port state names/shapes differ from the ResNet golden")
    w = recipes.resnet_weights(names_shapes, rw["seed"], rw["conv_std"],
                               rw["linear_std"])
    model.set_state_dict_from_numpy(w)
    x, y = recipes.resnet_data(gold["recipe"]["data"]["seed"], cfg["batch"],
                               cfg["image"], cfg["num_classes"])
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    opt = gold["optimizer"]
    trainer = engine.ParallelTrainer(
        model, optim.Momentum(opt["learning_rate"], momentum=opt["momentum"]),
        _ce(nn), mesh=mesh_mod.build_mesh({"data": 1}))
    loss0 = _ce(nn)(model(x), y)
    grads = torch.autograd.grad(loss0, list(trainer.params.values()))
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).item()
    loss0 = loss0.item()
    del grads
    ms = []
    losses = []
    for _ in gold["losses"]:
        loss, t = _timed_step(trainer, x, y)
        losses.append(loss)
        ms.append(t)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    check(rel(loss0, gold["losses"][0]) <= RESNET_LOSS_RTOL[0],
          f"v1 step-0 loss {loss0} vs golden {gold['losses'][0]}")
    check(rel(gnorm, gold["step0_grad_norm"]) <= RESNET_GRAD_NORM_RTOL,
          f"v1 step-0 grad norm {gnorm} vs {gold['step0_grad_norm']}")
    check(rel(losses[0], gold["losses"][0]) <= RESNET_LOSS_RTOL[0],
          f"v1 train_step 0 loss {losses[0]} vs {gold['losses'][0]}")
    for i in range(1, len(losses)):
        check(rel(losses[i], gold["losses"][i]) <= RESNET_LOSS_RTOL[1],
              f"v1 loss after {i} updates {losses[i]} vs "
              f"{gold['losses'][i]}")
    after = {}
    for k, g in gold["after"].items():
        p = trainer.get_param(k).double().cpu().numpy()
        upd = float(np.linalg.norm(p - w[k].astype(np.float64)))
        check(rel(upd, g["update_norm"]) <= RESNET_UPDATE_RTOL,
              f"v1 {k}: update norm {upd} vs golden {g['update_norm']}")
        after[k] = {"update_norm": upd, "golden_update_norm":
                    g["update_norm"], "sum": float(p.sum()),
                    "golden_sum": g["sum"]}
    check(trainer.skipped_steps() == 0, "v1: a step skipped")
    return {"loss0": loss0, "grad_norm": gnorm, "losses": losses,
            "golden_losses": gold["losses"],
            "golden_grad_norm": gold["step0_grad_norm"],
            "loss_rel_err": [rel(a, b) for a, b in
                             zip([loss0] + losses, gold["losses"][:1]
                                 + gold["losses"])],
            "grad_norm_rel_err": rel(gnorm, gold["step0_grad_norm"]),
            "after": after, "ms_per_step": ms, "batch": cfg["batch"],
            "image": cfg["image"], "lr": opt["learning_rate"]}


def _group_vision(name):
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "winograd",
                              "dgrad", "wgrad", "fprop")):
        return "convolutions (cuDNN)"
    if "gemm" in low or low.startswith("nvjet") or "cutlass" in low:
        return "GEMMs"
    if "reduce" in low or "welford" in low:
        return "reductions (batch-norm statistics, loss)"
    if "pool" in low:
        return "pooling"
    return "elementwise and the rest"


def profile_steps(trainer, batch, group, steps=3):
    """Device busy share and kernel time by ``group(name)`` over ``steps``
    steps (torch.profiler)."""
    prof, wall = _profiled_steps(trainer, batch, steps)
    report, rows = _profile_report(prof, wall)
    check(rows, "the profiler saw no kernel on the card")
    groups = {}
    for us, name, n in rows:
        ms, launches = groups.get(group(name), (0.0, 0))
        groups[group(name)] = (ms + us / 1e3 / steps, launches + n)
    return dict(steps=steps, by_group={
        k: {"ms_per_step": v[0], "launches_per_step": v[1] / steps}
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        **report)


def resnet_main(nn, optim, engine, mesh_mod, models, framework, batch=128,
                size=224, warmup=2, iters=10):
    """(v2) bench_resnet50's configuration: ``resnet50()`` (weights from
    seed 0), ``model.bfloat16()`` (parameters and running statistics),
    ``Momentum(0.1, momentum=0.9)``, ``ParallelTrainer`` with
    ``cross_entropy`` on a data mesh of one, one fixed batch of bfloat16
    3x224x224 images (NCHW) and int32 labels from RandomState(0)."""
    framework.seed(0)
    model = models.resnet50()
    model.bfloat16()
    trainer = engine.ParallelTrainer(
        model, optim.Momentum(0.1, momentum=0.9), _ce(nn),
        mesh=mesh_mod.build_mesh({"data": 1}))
    check(all(b.dtype == torch.bfloat16 for b in
              trainer.state["buffers"].values()),
          "bfloat16() left a running statistic in another dtype")
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randn(batch, 3, size, size).astype(
        np.float32)).to("cuda", torch.bfloat16)
    lbls = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(
        np.int32)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(imgs, lbls).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step(imgs, lbls) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"v2 losses {losses}")
    check(trainer.skipped_steps() == 0, "v2: a step skipped")
    stats = trainer.state["buffers"]
    moved = float(stats["bn1._variance"].float().sub(1).abs().max())
    check(moved > 0, "v2: the running statistics did not move")
    prof = profile_steps(trainer, (imgs, lbls), _group_vision)
    del trainer, model, imgs
    torch.cuda.empty_cache()
    return {"batch": batch, "image": size, "dtype": "bfloat16",
            "layout": "NCHW", "warmup": warmup, "iters": iters,
            "losses": losses, "losses_fell": losses[-1] < losses[0],
            "skipped": 0, "images_per_s": batch * iters / dt,
            "ms_per_step": dt / iters * 1e3,
            "max_memory_allocated_gb": peak,
            "bn1_variance_moved": moved, "profile": prof}


# -- vision: the zoo (LeNet, MobileNetV2, VGG-16) and the detection ops -------

ZOO_LOSS_RTOL = RESNET_LOSS_RTOL             # step 0, later steps
ZOO_GRAD_NORM_RTOL = RESNET_GRAD_NORM_RTOL
IMAGENET_MEAN = [123.675, 116.28, 103.53]    # the 0-255 scale
IMAGENET_STD = [58.395, 57.12, 57.375]


def zoo_golden(nn, optim, engine, mesh_mod, models):
    """(v3) ``mobilenet_v2()``, ``vgg16()`` and ``LeNet()`` at full width,
    float32 (TF32 off), each ``Dropout`` at p 0, the golden's batch and
    ``Momentum(1e-4, 0.9)``: the step-0 loss and gradient norm, then
    three ``train_step``s, against ``vision_zoo_golden.json`` (v1's bars:
    step-0 loss rtol 1e-4, gradient norm 2e-3, later losses 1e-3); the
    tracked parameters' update norms beside the golden's, unchecked."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "vision_zoo_golden.json")) as f:
        gold = json.load(f)
    rw, opt = gold["recipe"]["weights"], gold["optimizer"]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    out = {}
    for name, g in gold["models"].items():
        cfg = g["config"]
        model = getattr(models, cfg["constructor"])(
            num_classes=cfg["num_classes"])
        recipes.no_dropout(model)
        names_shapes = [(n, tuple(t.shape)) for n, t in
                        model.named_state().items()]
        check([[n, list(s)] for n, s in names_shapes] == g["names_shapes"],
              f"v3 {name}: port state names/shapes differ from the golden")
        w = recipes.zoo_weights(names_shapes, rw["seed"], rw["conv_gain"],
                                rw["linear_gain"])
        model.set_state_dict_from_numpy(w)
        x, y = recipes.zoo_data(gold["recipe"]["data"]["seed"],
                                cfg["batch"], cfg["channels"], cfg["image"],
                                cfg["num_classes"])
        x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        trainer = engine.ParallelTrainer(
            model, optim.Momentum(opt["learning_rate"],
                                  momentum=opt["momentum"]),
            _ce(nn), mesh=mesh_mod.build_mesh({"data": 1}))
        loss0 = _ce(nn)(model(x), y)
        grads = torch.autograd.grad(loss0, list(trainer.params.values()))
        gnorm = torch.sqrt(sum(t.double().square().sum()
                               for t in grads)).item()
        loss0 = loss0.item()
        del grads
        losses, ms = [], []
        for _ in g["losses"]:
            loss, t = _timed_step(trainer, x, y)
            losses.append(loss)
            ms.append(t)
        check(rel(loss0, g["losses"][0]) <= ZOO_LOSS_RTOL[0],
              f"v3 {name}: step-0 loss {loss0} vs golden {g['losses'][0]}")
        check(rel(gnorm, g["step0_grad_norm"]) <= ZOO_GRAD_NORM_RTOL,
              f"v3 {name}: step-0 grad norm {gnorm} vs "
              f"{g['step0_grad_norm']}")
        check(rel(losses[0], g["losses"][0]) <= ZOO_LOSS_RTOL[0],
              f"v3 {name}: train_step 0 loss {losses[0]} vs "
              f"{g['losses'][0]}")
        for i in range(1, len(losses)):
            check(rel(losses[i], g["losses"][i]) <= ZOO_LOSS_RTOL[1],
                  f"v3 {name}: loss after {i} updates {losses[i]} vs "
                  f"{g['losses'][i]}")
        check(trainer.skipped_steps() == 0, f"v3 {name}: a step skipped")
        after = {}
        for k, a in g["after"].items():
            p = trainer.get_param(k).double().cpu().numpy()
            upd = float(np.linalg.norm(p - w[k].astype(np.float64)))
            after[k] = {"update_norm": upd,
                        "golden_update_norm": a["update_norm"],
                        "rel_err": rel(upd, a["update_norm"])}
        out[name] = {
            "parameters": cfg["parameters"], "batch": cfg["batch"],
            "image": cfg["image"], "loss0": loss0, "grad_norm": gnorm,
            "losses": losses, "golden_losses": g["losses"],
            "loss_rel_err": [rel(a, b) for a, b in zip(
                [loss0] + losses, g["losses"][:1] + g["losses"])],
            "grad_norm_rel_err": rel(gnorm, g["step0_grad_norm"]),
            "after": after, "ms_per_step": ms}
        del trainer, model, x, y
        torch.cuda.empty_cache()
    return out


def imagenet_batch(transforms, batch, seed=0, size=224, source=256):
    """``batch`` seeded uint8 ``source``x``source`` HWC images through
    ``RandomResizedCrop(size)``, ``RandomHorizontalFlip``, ``Normalize``
    (the ImageNet mean and std) and ``Transpose`` on the host ->
    (float32 NCHW array, images/s of the pipeline)."""
    import random
    pipe = transforms.Compose([
        transforms.RandomResizedCrop(size),
        transforms.RandomHorizontalFlip(),
        transforms.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="HWC"),
        transforms.Transpose()])
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (batch, source, source, 3)).astype(np.uint8)
    random.seed(seed)
    t0 = time.perf_counter()
    out = np.stack([pipe(img) for img in images])
    dt = time.perf_counter() - t0
    check(out.shape == (batch, 3, size, size) and out.dtype == np.float32
          and np.isfinite(out).all(), f"transform pipeline gave "
          f"{out.shape} {out.dtype}")
    return out, batch / dt


def zoo_main(nn, optim, engine, mesh_mod, model, images, stat, what,
             lr=0.1, warmup=2, iters=10):
    """(v4, v5) ``model`` (weights from seed 0) in bfloat16 through
    ``ParallelTrainer`` with ``Momentum(lr, 0.9)`` and ``cross_entropy``
    on a data mesh of one, on one fixed batch of ``images`` (a float32
    NCHW array) and int32 labels from RandomState(0): losses finite and
    falling, no step skipped, the running statistic ``stat`` moved;
    images/s, ms a step, peak GB and the profile by kernel group."""
    model.bfloat16()
    trainer = engine.ParallelTrainer(
        model, optim.Momentum(lr, momentum=0.9), _ce(nn),
        mesh=mesh_mod.build_mesh({"data": 1}))
    batch = images.shape[0]
    imgs = torch.from_numpy(images).to("cuda", torch.bfloat16)
    lbls = torch.from_numpy(np.random.RandomState(0).randint(
        0, 1000, (batch,)).astype(np.int32)).cuda()
    before = trainer.state["buffers"][stat].float().clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(imgs, lbls).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step(imgs, lbls) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(losses)), f"{what} losses {losses}")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall {losses}")
    check(trainer.skipped_steps() == 0, f"{what}: a step skipped")
    moved = float((trainer.state["buffers"][stat].float() - before)
                  .abs().max())
    check(moved > 0, f"{what}: the running statistics did not move")
    prof = profile_steps(trainer, (imgs, lbls), _group_vision)
    del trainer, imgs
    torch.cuda.empty_cache()
    return {"batch": batch, "image": images.shape[-1], "dtype": "bfloat16",
            "layout": "NCHW", "lr": lr, "warmup": warmup, "iters": iters,
            "losses": losses, "losses_fell": losses[-1] < losses[0],
            "skipped": 0, "images_per_s": batch * iters / dt,
            "ms_per_step": dt / iters * 1e3,
            "max_memory_allocated_gb": peak, "stat": stat,
            "stat_moved": moved, "profile": prof}


# card-vs-CPU bars of the detection ops, relative to the largest element
# of the CPU result: float32 sums in other orders (cuDNN/cuBLAS against
# the CPU's) and the backward's scatter-adds in another order
DET_FWD_TOL = 1e-4
DET_BWD_TOL = 1e-3
DET_GOLDEN_TOL = 1e-4     # the summaries' sums against the reference's


def _rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def _on(d, device, keys):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(device)
            for k in keys]


def _hold_summary(what, got, gold):
    """``got`` (a CPU tensor) against a golden summary: shape, then the sum,
    the absolute sum and the strided sample (relative to the largest)."""
    a = got.double().numpy().reshape(-1)
    check(list(got.shape) == gold["shape"], f"v6 {what}: shape "
          f"{list(got.shape)} vs golden {gold['shape']}")
    sample = a[::gold["stride"]][:len(gold["sample"])]
    scale = max(1.0, float(np.abs(gold["sample"]).max()))
    errs = {"sum": abs(a.sum() - gold["sum"]) / max(1.0, abs(gold["sum"])),
            "abs_sum": abs(np.abs(a).sum() - gold["abs_sum"]) /
            gold["abs_sum"],
            "sample": float(np.abs(sample - gold["sample"]).max()) / scale}
    check(max(errs.values()) <= DET_GOLDEN_TOL,
          f"v6 {what}: against the golden summary {errs}")
    return errs


def _time_op(fn, reps):
    """Median card time of ``fn`` (CUDA events), then one call under
    torch.profiler: the device's busy time and the share of the call's
    wall time it sat idle (the host's share; a selection op launches no
    kernel at all, only its copies)."""
    from torch.profiler import ProfilerActivity, profile
    t = time_ms(fn, reps=reps, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy_us = _device_time(prof)
    return {"card_ms": t, "profiled_wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "host_share": 1.0 - busy_us / 1e6 / wall,
            "device_ops": sum(n for _, _, n in rows)}


def detection_ops(vops):
    """(v6) each detection op on the card against the port's CPU run on
    the same inputs (``recipes.detection_inputs``), and against the
    reference's summaries (``vision_zoo_golden.json``) where it has them:
    the error, the card ms (CUDA events) and the share of the call the
    card sat idle (host time: the selection ops run on the host)."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "vision_zoo_golden.json")) as f:
        gold = json.load(f)["ops"]
    out = {}

    def fwd_bwd(name, call, keys, d, wrt, reps=10):
        """forward and backward of ``sum(out * r)`` on both devices."""
        res = {}
        for dev in ("cpu", "cuda"):
            args = _on(d, dev, keys)
            for i in wrt:
                args[i].requires_grad_()
            y = call(*args)
            r = torch.from_numpy(np.random.RandomState(5).randn(
                *y.shape).astype(np.float32)).to(dev)
            grads = torch.autograd.grad((y * r).sum(), [args[i] for i in wrt])
            res[dev] = (y.detach().cpu(), [t.cpu() for t in grads], args, r)
        yc, gc, _, _ = res["cpu"]
        yg, gg, args, r = res["cuda"]
        fe = _rel_err(yg, yc)
        be = max(_rel_err(a, b) for a, b in zip(gg, gc))
        check(fe <= DET_FWD_TOL, f"v6 {name}: forward card vs CPU {fe}")
        check(be <= DET_BWD_TOL, f"v6 {name}: backward card vs CPU {be}")
        plain = [a.detach() for a in args]
        rep = {"shape": list(yg.shape), "fwd_err": fe, "bwd_err": be,
               "fwd": _time_op(lambda: call(*plain), reps)}

        def both():
            a = [t.detach().requires_grad_(i in wrt)
                 for i, t in enumerate(plain)]
            y = call(*a)
            torch.autograd.grad((y * r).sum(), [a[i] for i in wrt])
        rep["fwd_bwd"] = _time_op(both, reps)
        return rep, yc

    d = recipes.detection_inputs("roi_align")
    out["roi_align"], _ = fwd_bwd(
        "roi_align", lambda x, b, n: vops.roi_align(
            x, b, n, d["output_size"], d["spatial_scale"],
            d["sampling_ratio"]),
        ("x", "boxes", "boxes_num"), d, (0,))
    out["roi_align"]["golden"] = "none: the reference's copy of each RoI's "\
        "map would take 57 GB"
    d = recipes.detection_inputs("deform_conv2d")
    out["deform_conv2d"], y = fwd_bwd(
        "deform_conv2d", lambda x, o, m, w, b: vops.deform_conv2d(
            x, o, w, b, padding=d["padding"], mask=m),
        ("x", "offset", "mask", "weight", "bias"), d, (0, 1, 2, 3, 4))
    out["deform_conv2d"]["golden_err"] = _hold_summary(
        "deform_conv2d", y, gold["deform_conv2d"])
    d = recipes.detection_inputs("yolo_loss")
    out["yolo_loss"], y = fwd_bwd(
        "yolo_loss", lambda x, g, lb: vops.yolo_loss(
            x, g, lb, d["anchors"], d["anchor_mask"], d["class_num"],
            d["ignore_thresh"], d["downsample_ratio"]),
        ("x", "gt_box", "gt_label"), d, (0,))
    out["yolo_loss"]["golden_err"] = _hold_summary("yolo_loss", y,
                                                   gold["yolo_loss"])
    d = recipes.detection_inputs("yolo_box")
    anchors = [d["anchors"][2 * i + j] for i in d["anchor_mask"]
               for j in (0, 1)]

    def yolo_box(x, s):
        return vops.yolo_box(x, s, anchors, d["class_num"], d["conf_thresh"],
                             d["downsample_ratio"])
    (bc, sc), (bg, sg) = (yolo_box(*_on(d, dev, ("x", "img_size")))
                          for dev in ("cpu", "cuda"))
    err = max(_rel_err(bg, bc), _rel_err(sg, sc))
    check(err <= DET_FWD_TOL, f"v6 yolo_box: card vs CPU {err}")
    args = _on(d, "cuda", ("x", "img_size"))
    out["yolo_box"] = {"fwd_err": err, "golden_err": _hold_summary(
        "yolo_box scores", sc, gold["yolo_box_scores"]),
        "fwd": _time_op(lambda: yolo_box(*args), 10)}

    # the selection ops: the same host code on the card's inputs
    d = recipes.detection_inputs("nms")
    res = [vops.nms(b, d["iou_threshold"], scores=s)
           for b, s in (_on(d, dev, ("boxes", "scores"))
                        for dev in ("cpu", "cuda"))]
    check(res[1].device.type == "cuda", "v6 nms: not on the card")
    check(torch.equal(res[0], res[1].cpu()), "v6 nms: card vs CPU")
    check(res[0].tolist() == gold["nms"]["indices"],
          "v6 nms: the kept indices differ from the reference's")
    b, s = _on(d, "cuda", ("boxes", "scores"))
    out["nms"] = {"kept": len(res[0]), "golden_kept": gold["nms"]["kept"],
                  "fwd": _time_op(lambda: vops.nms(
                      b, d["iou_threshold"], scores=s), 5)}
    d = recipes.detection_inputs("generate_proposals")
    keys = ("scores", "bbox_deltas", "img_size", "anchors", "variances")
    kw = dict(pre_nms_top_n=d["pre_nms_top_n"],
              post_nms_top_n=d["post_nms_top_n"], return_rois_num=True)
    res = [vops.generate_proposals(*_on(d, dev, keys), **kw)
           for dev in ("cpu", "cuda")]
    check(all(torch.equal(a, b.cpu()) for a, b in zip(*res)),
          "v6 generate_proposals: card vs CPU")
    args = _on(d, "cuda", keys)
    out["generate_proposals"] = {
        "rois": int(res[0][2].sum()),
        "fwd": _time_op(lambda: vops.generate_proposals(*args, **kw), 2)}
    d = recipes.detection_inputs("multiclass_nms")
    kw = {k: d[k] for k in ("score_threshold", "nms_top_k", "keep_top_k",
                            "nms_threshold")}
    res = [vops.multiclass_nms(*_on(d, dev, ("bboxes", "scores")), **kw)
           for dev in ("cpu", "cuda")]
    check(all(torch.equal(a, b.cpu()) for a, b in zip(*res)),
          "v6 multiclass_nms: card vs CPU")
    args = _on(d, "cuda", ("bboxes", "scores"))
    out["multiclass_nms"] = {
        "detections": [len(t) for t in res[0]],
        "fwd": _time_op(lambda: vops.multiclass_nms(*args, **kw), 3)}
    return out


def vision_phase(fa, fc, nn, optim, engine, framework, card=None):
    """``vision``: (v1) the ResNet-50 golden, (v2) bench_resnet50's main
    path, (v3) the zoo's goldens, (v4) MobileNetV2 at batch 128 on a batch
    made by ``vision.transforms``, (v5) VGG-16 at batch 64, (v6) the
    detection ops on the card against their CPU runs; v3-v6 each print a
    line of their own (``vision_v3`` ...). No kernel of the port runs on
    this path (the reference's convolutions, pooling, batch norm and
    detection ops are XLA ops, no Pallas kernel): the six training
    kernels' counts stay 0."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.vision import models, ops as vops, transforms
    zero_counts(fa, fc)
    out = {"v1_golden": resnet_golden(nn, optim, engine, mesh_mod, models)}
    torch.cuda.empty_cache()
    out["v2_resnet50_b128"] = resnet_main(nn, optim, engine, mesh_mod,
                                          models, framework)
    seconds = {}

    def sub(key, fn):
        t0 = time.perf_counter()
        rep = fn()
        seconds[key] = time.perf_counter() - t0
        emit(phase=f"vision_{key}", card=card, seconds=seconds[key], **rep)
        torch.cuda.empty_cache()

    sub("v3", lambda: {"golden": zoo_golden(nn, optim, engine, mesh_mod,
                                            models)})
    images, rate = imagenet_batch(transforms, 128)

    def v4():
        framework.seed(0)
        return {"transform_images_per_s": rate, **zoo_main(
            nn, optim, engine, mesh_mod, models.mobilenet_v2(), images,
            "features.0.bn._variance", "v4 mobilenet_v2")}
    sub("v4", v4)

    def v5():
        # configuration D with batch norm (the golden's v3 holds the plain
        # one), so that the step has running statistics to move. lr 1e-3:
        # on one fixed batch (measured on the CPU, batch 16 at 96x96, bf16)
        # 0.1 reaches NaN by the 6th step, the paper's 1e-2 (batch 256 of
        # fresh images) climbs to 17x its first loss, 3e-3 climbs after
        # its 4th step; 1e-3 falls from 8.5 to under 1
        framework.seed(0)
        return zoo_main(nn, optim, engine, mesh_mod,
                        models.vgg16(batch_norm=True), images[:64],
                        "features.1._variance", "v5 vgg16_bn", lr=1e-3)
    sub("v5", v5)
    sub("v6", lambda: detection_ops(vops))
    out["sub_phase_seconds"] = seconds
    out["launches"] = check_path(fa, fc, "vision", 0, 0, 0)
    return out


# -- hapi: Model.fit, the DataLoader and its workers on the card -------------

# (a1) Model.fit's losses against fused_b8_pallas_ce's trainer on the same
# weights and batches: the largest relative gap over the 12 steps. Set
# before any card run from the same comparison on the CPU (bf16 GPT, depth
# 2, narrow widths; tests/test_torch_hapi.py::test_gpt_model_loss_bar),
# which reads 0: one step, the same ops in the same order. The bar is at
# least ten times that reading; it is the static phase's STATIC_LOSS_RTOL,
# the bar of another way of running the same step
HAPI_LOSS_RTOL = 1e-5
# (a3) the card's LeNet fit against hapi_golden.json (the reference's
# Model.fit on the CPU, float32): each per-batch loss, relative
HAPI_GOLDEN_RTOL = 1e-5
# (a3) evaluate's loss and predict's outputs on the card against the same
# Model on the CPU with the same weights, of the largest element
HAPI_CPU_TOL = 1e-5
HAPI_WARMUP, HAPI_ITERS = 2, 10
# (a2) timed steps of the run fed by DataLoader workers: five times the
# most its loader can hold ready at 7 workers (fed_ahead), so the rate is
# the workers' sustained one, not that of batches made during the warm-up
HAPI_FED_TIMED = 5 * 17
# (a2) timed steps of the run fed by the loading process alone: 12 steps
# in all with the warm-up and fed_ahead(0)
HAPI_LOADER_TIMED = 7
HAPI_PREFETCH = 2       # io.DataLoader's prefetch_factor, its default
# (a3) the LeNet fit, which tests/torch_hapi_golden.py runs through the
# reference: LeNet on recipes.zoo_weights(seed 0), Momentum, cross entropy
# and top-1/top-5 accuracy, HapiEasyData (labels drawn into the image, so
# the model learns) shuffled from np.random.seed(shuffle_seed), evaluated
# after each epoch on the eval set
HAPI_LENET = {"weights_seed": 0, "lr": 1e-2, "momentum": 0.9, "epochs": 2,
              "batch": 32, "train_size": 256, "eval_size": 64,
              "eval_seed": 999, "shuffle_seed": 0, "topk": [1, 5]}


def step_clock(callbacks, probe=None):
    """A callback keeping each train batch's loss and the host clock at
    its end hook, which runs after ``train_batch`` read the loss on the
    host (a wait for the card), and what ``probe()`` reads then."""
    class StepClock(callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.t = [], []
            self.probe, self.probes = probe, []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            self.t.append(time.perf_counter())
            if self.probe is not None:
                self.probes.append(self.probe())

        def ms_per_step(self, warmup=HAPI_WARMUP):
            """Mean ms of the steps after ``warmup``: batch fetch, copy
            to the card, step and loss read included."""
            return (self.t[-1] - self.t[warmup - 1]) / (
                len(self.t) - warmup) * 1e3

    return StepClock()


def fed_ahead(workers, prefetch=HAPI_PREFETCH):
    """The most batches an ``io.DataLoader`` holds ready ahead of its
    consumer: ``workers * prefetch`` in flight in the workers (none
    without them), ``prefetch`` in the prefetch thread's queue and one in
    its hand."""
    return workers * prefetch + prefetch + 1


def hapi_gpt_batches(steps, batch, seq, vocab=50304, seed=0):
    """``steps`` batches of seeded ids and labels, row-stacked (int32)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (steps * batch, seq)).astype(np.int32)
    lbl = rs.randint(0, vocab, (steps * batch, seq)).astype(np.int32)
    return ids, lbl


def gpt_trainer_run(nn, engine, optim, model, ids, lbl, batch,
                    warmup=HAPI_WARMUP, iters=HAPI_ITERS, device=None):
    """fused_b8_pallas_ce's trainer (AdamW(3e-4), the fused CE kernels)
    over the batches in order, each on the device before the steps ->
    (trainer, losses, ms a timed step, the last batch)."""
    trainer = engine.ParallelTrainer(
        fused_loss_layer(nn, model, 8192, ce_kernel="pallas"),
        optim.AdamW(3e-4), lambda out, _l: out, device=device)
    dev = trainer.device
    batches = [(torch.from_numpy(ids[i * batch:(i + 1) * batch]).to(dev),
                torch.from_numpy(lbl[i * batch:(i + 1) * batch]).to(dev))
               for i in range(warmup + iters)]
    losses = [trainer.train_step(b, 0.0) for b in batches[:warmup]]
    float(losses[-1])
    t0 = time.perf_counter()
    losses += [trainer.train_step(b, 0.0) for b in batches[warmup:]]
    float(losses[-1])
    ms = (time.perf_counter() - t0) / iters * 1e3
    return trainer, [float(x) for x in losses], ms, batches[-1]


def gpt_model_fit(nn, optim, io, hapi, model, ids, lbl, batch,
                  steps=HAPI_WARMUP + HAPI_ITERS, device=None):
    """The same run through ``hapi.Model``: ``fit(num_iters=steps)`` over
    a ``DataLoader`` (``num_workers=0``) of a ``TensorDataset`` of (ids,
    labels, a zero label), the network computing its fused head loss from
    ids and labels and ``loss`` returning it -> (Model, StepClock)."""
    m = hapi.Model(fused_loss_layer(nn, model, 8192, ce_kernel="pallas"),
                   device=device)
    m.prepare(optim.AdamW(3e-4), loss=lambda out, _zero: out)
    data = io.TensorDataset([ids, lbl, np.zeros(len(ids), np.float32)])
    clock = step_clock(hapi.callbacks)
    m.fit(io.DataLoader(data, batch_size=batch), epochs=1, num_iters=steps,
          verbose=0, callbacks=[clock])
    return m, clock


def hapi_a1(fa, fc, nn, gpt, engine, optim, framework, io, hapi,
            layers=12, batch=8, seq=1024):
    """(a1) GPT-base (bf16, the fused CE kernels) through ``Model.fit``
    against fused_b8_pallas_ce's trainer on the same weights and batches:
    per step 12 launches of each flash kernel and one of each CE kernel,
    all on the mma and tiled routes, the losses within ``HAPI_LOSS_RTOL``;
    ms a step of each and the card's busy share of one step of each
    (``profile_calls``)."""
    steps = HAPI_WARMUP + HAPI_ITERS
    ids, lbl = hapi_gpt_batches(steps, batch, seq)
    trainer, t_losses, trainer_ms, last = gpt_trainer_run(
        nn, engine, optim, gpt_base_model(gpt, framework, seq, layers), ids,
        lbl, batch)
    trainer_prof = profile_calls(lambda: trainer.train_step(last, 0.0))
    del trainer
    torch.cuda.empty_cache()
    zero_counts(fa, fc)
    m, clock = gpt_model_fit(nn, optim, io, hapi,
                             gpt_base_model(gpt, framework, seq, layers),
                             ids, lbl, batch, steps)
    torch.cuda.synchronize()
    launches = check_path(fa, fc, "hapi a1", layers * steps, layers * steps,
                          steps)
    losses = clock.losses
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, t_losses)]
    # fresh random tokens each step: the loss stays near ln(50304), so
    # it is held to the trainer's, not asked to fall
    check(all(np.isfinite(losses)), f"hapi a1: losses {losses}")
    check(max(rel) <= HAPI_LOSS_RTOL,
          f"hapi a1: losses {losses} vs the trainer's {t_losses}")
    model_prof = profile_calls(
        lambda: m.train_batch([last[0], last[1]], [torch.zeros(batch)]))
    del m
    torch.cuda.empty_cache()
    return {"layers": layers, "batch": batch, "seq": seq,
            "warmup": HAPI_WARMUP, "iters": HAPI_ITERS, "losses": losses,
            "trainer_losses": t_losses, "max_rel_gap": max(rel),
            "rtol": HAPI_LOSS_RTOL,
            "bit_equal_to_trainer": losses == t_losses,
            "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "ms_per_step": clock.ms_per_step(),
            "trainer_ms_per_step": trainer_ms,
            "busy_share": 1.0 - model_prof["profiled_idle_share"],
            "trainer_busy_share": 1.0 - trainer_prof["profiled_idle_share"],
            "profile": model_prof, "trainer_profile": trainer_prof}


class HapiImages:
    """``n`` seeded uint8 ``source`` x ``source`` x 3 images, each made
    from ``RandomState(seed + idx)`` when it is asked for, with a label
    from the same draw, through ``RandomResizedCrop(size)``,
    ``RandomHorizontalFlip``, ``Normalize`` (ImageNet's mean and std) and
    ``Transpose`` in ``__getitem__``: the per-sample work of an ImageNet
    training loader (``FakeData``'s draw per index)."""

    def __init__(self, transforms, n=1536, size=224, source=256, seed=0,
                 classes=1000):
        self.n, self.source, self.seed, self.classes = n, source, seed, \
            classes
        self.pipe = transforms.Compose([
            transforms.RandomResizedCrop(size),
            transforms.RandomHorizontalFlip(),
            transforms.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                 data_format="HWC"),
            transforms.Transpose()])

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState(self.seed + idx)
        img = rs.randint(0, 256, (self.source, self.source, 3)).astype(
            np.uint8)
        label = np.asarray(rs.randint(0, self.classes), dtype=np.int64)
        return self.pipe(img), label


def hapi_a2(nn, optim, framework, io, hapi, metric, telemetry, models,
            transforms, batch=128, timed=(HAPI_LOADER_TIMED, HAPI_FED_TIMED)):
    """(a2) ``mobilenet_v2()`` under ``amp_configs="O1"`` (bf16) with
    ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss`` and ``Accuracy`` through
    ``Model.fit`` on ``HapiImages`` at batch 128 x 224², at ``num_workers``
    0 and at W = min(8, usable cores - 1), each inside a telemetry scope;
    then ``train_batch`` on one batch already on the card. A fed run steps
    ``HAPI_WARMUP`` steps, then as many as the loader may hold ready
    (``fed_ahead``), then ``timed[0]`` (no workers) or ``timed[1]`` steps:
    its images/s (also over the timed steps' second half) and the loader's
    wait a step (``dataloader_fetch_seconds``) are the timed steps'. The
    busy share of a run is the device ms of one profiled ``train_batch``
    on a CPU batch from that run's loader (the copy to the card included)
    over the run's ms a step; the fixed batch's, its own profiled step.
    Losses finite, falling on the fixed batch, batch norm's running
    statistics moved."""
    cores, usable = os.cpu_count(), len(os.sched_getaffinity(0))
    workers = min(8, usable - 1)
    framework.seed(0)
    net = models.mobilenet_v2()
    m = hapi.Model(net)
    m.prepare(optim.Momentum(0.1, momentum=0.9), nn.CrossEntropyLoss(),
              metric.Accuracy(), amp_configs="O1")
    stat = "features.0.bn._variance"
    before = dict(net.named_buffers())[stat].float().clone()
    runs = {}
    for w, n_timed in zip((0, workers), timed):
        skip = HAPI_WARMUP + fed_ahead(w)
        steps = skip + n_timed
        ds = HapiImages(transforms, n=batch * steps)
        np.random.seed(0)
        with telemetry.scope(profile=False) as tel:
            def waited(reg=tel.registry):
                h = reg.get("dataloader_fetch_seconds")
                return h.sum(), h.count()
            clock = step_clock(hapi.callbacks, probe=waited)
            t0 = time.perf_counter()
            m.fit(io.DataLoader(ds, batch_size=batch, shuffle=True,
                                num_workers=w), epochs=1, num_iters=steps,
                  verbose=0, callbacks=[clock])
            wall = time.perf_counter() - t0
        check(len(clock.losses) == steps and all(np.isfinite(clock.losses)),
              f"hapi a2 workers {w}: losses {clock.losses}")
        ms = clock.ms_per_step(skip)
        half = skip + n_timed // 2
        (w_end, n_end), (w_skip, n_skip) = clock.probes[-1], \
            clock.probes[skip - 1]
        it = iter(io.DataLoader(ds, batch_size=batch, num_workers=w))
        xb, yb = next(it)
        it.close()
        prof = profile_calls(lambda: m.train_batch([xb], [yb]))
        runs[f"workers_{w}"] = {
            "num_workers": w, "steps": steps, "untimed_steps": skip,
            "timed_steps": n_timed, "losses": clock.losses,
            "ms_per_step": ms, "images_per_s": batch / ms * 1e3,
            "images_per_s_second_half": batch / clock.ms_per_step(half)
            * 1e3,
            "fetch_wait_ms_per_step": (w_end - w_skip) / (n_end - n_skip)
            * 1e3,
            "first_fetch_s": clock.probes[0][0],
            "untimed_fetch_wait_s": w_skip, "fit_wall_s": wall,
            "fed_step_device_ms": prof["device_busy_ms"],
            "busy_share": prof["device_busy_ms"] / ms, "profile": prof}
        del xb, yb
    # collated here, not by a loader, whose prefetch thread would go on
    # transforming batches beside the timed steps
    xb, yb = io.default_collate_fn([ds[i] for i in range(batch)])
    xb, yb = xb.cuda(), yb.cuda()
    n_fixed = HAPI_WARMUP + HAPI_ITERS
    losses = [m.train_batch([xb], [yb])[0] for _ in range(HAPI_WARMUP)]
    t0 = time.perf_counter()
    losses += [m.train_batch([xb], [yb])[0] for _ in range(HAPI_ITERS)]
    fixed_ms = (time.perf_counter() - t0) / HAPI_ITERS * 1e3
    check(all(np.isfinite(losses)), f"hapi a2 fixed batch: losses {losses}")
    check(losses[-1] < losses[0],
          f"hapi a2 fixed batch: the loss did not fall {losses}")
    prof = profile_calls(lambda: m.train_batch([xb], [yb]))
    moved = float((dict(net.named_buffers())[stat].float() - before)
                  .abs().max())
    check(moved > 0, "hapi a2: the running statistics did not move")
    busy_ms = prof["device_busy_ms"]
    del m, net, xb, yb
    torch.cuda.empty_cache()
    return {"batch": batch, "image": 224, "source": 256, "amp": "O1",
            "warmup": HAPI_WARMUP, "cpu_count": cores,
            "usable_cores": usable, "workers": workers, "runs": runs,
            "fixed_batch": {"steps": n_fixed, "losses": losses,
                            "ms_per_step": fixed_ms,
                            "images_per_s": batch / fixed_ms * 1e3,
                            "busy_share": busy_ms / fixed_ms,
                            "profile": prof},
            "stat": stat, "stat_moved": moved}


def hapi_easy_data(fake_data):
    """``FakeData``'s subclass whose label is drawn into the image (a bar
    of ones at rows 2*label, 2*label+1), so a LeNet learns it: the
    reference's test_lenet_fit_learns data, for either package."""
    class HapiEasyData(fake_data):
        def __getitem__(self, idx):
            rng = np.random.RandomState(self.seed + idx)
            label = rng.randint(0, self.num_classes)
            img = np.zeros(self.image_shape, dtype=np.float32)
            img[0, label * 2:(label * 2 + 2), :] = 1.0
            img += rng.rand(*self.image_shape).astype(np.float32) * 0.1
            return img, np.asarray(label, dtype=np.int64)
    return HapiEasyData


class _Inputs:
    """The first field of each sample of ``ds`` (what ``predict`` feeds
    the network)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        return self.ds[idx][0]


def hapi_lenet(models, weights_seed=0):
    from paddle_tpu_torch.testdata import recipes
    net = models.LeNet()
    net.set_state_dict_from_numpy(recipes.zoo_weights(
        [(n, tuple(t.shape)) for n, t in net.named_state().items()],
        weights_seed))
    return net


def hapi_lenet_fit(nn, optim, hapi, metric, models, datasets, save_dir,
                   device=None, cfg=HAPI_LENET):
    """(a3)'s fit (``HAPI_LENET``) with ``ModelCheckpoint`` into
    ``save_dir`` and ``EarlyStopping`` on top-1 accuracy (patience 2)
    -> (Model, StepClock, evaluation after the fit)."""
    easy = hapi_easy_data(datasets.FakeData)
    m = hapi.Model(hapi_lenet(models, cfg["weights_seed"]), device=device)
    m.prepare(optim.Momentum(cfg["lr"], momentum=cfg["momentum"]),
              nn.CrossEntropyLoss(), metric.Accuracy(topk=tuple(cfg["topk"])))
    clock = step_clock(hapi.callbacks)
    cbs = hapi.callbacks
    eval_ds = easy(size=cfg["eval_size"], seed=cfg["eval_seed"])
    np.random.seed(cfg["shuffle_seed"])
    m.fit(easy(size=cfg["train_size"]), eval_data=eval_ds,
          batch_size=cfg["batch"], epochs=cfg["epochs"], verbose=0,
          callbacks=[clock, cbs.ModelCheckpoint(1, save_dir),
                     cbs.EarlyStopping(monitor="acc_top1", patience=2,
                                       verbose=0, save_best_model=False)])
    ev = m.evaluate(eval_ds, batch_size=cfg["batch"], verbose=0)
    return m, clock, ev


def _hapi_golden():
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "hapi_golden.json")) as f:
        return json.load(f)


def hapi_a3(nn, optim, io, hapi, metric, models, datasets, work):
    """(a3) LeNet: the fit on the card (2 epochs, ``ModelCheckpoint`` and
    ``EarlyStopping``) against ``hapi_golden.json`` (per-batch losses
    within ``HAPI_GOLDEN_RTOL``, the accuracies equal); ``evaluate`` and
    ``predict(stack_outputs=True)`` on the card against the same Model on
    the CPU with the same weights (within ``HAPI_CPU_TOL`` of the largest
    element, the accuracies equal); ``save`` on the card and ``load`` into
    a CPU Model: its predictions equal the CPU Model's, its optimizer
    state the card's."""
    gold = _hapi_golden()
    check(gold["recipe"] == HAPI_LENET, "hapi a3: the golden's recipe "
          f"{gold['recipe']} is not HAPI_LENET")
    save_dir = os.path.join(work, "hapi_lenet")
    t0 = time.perf_counter()
    m, clock, ev = hapi_lenet_fit(nn, optim, hapi, metric, models, datasets,
                                  save_dir)
    fit_s = time.perf_counter() - t0
    losses = clock.losses
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, gold["losses"])]
    check(len(losses) == len(gold["losses"]) and
          max(rel) <= HAPI_GOLDEN_RTOL,
          f"hapi a3: losses {losses} vs the golden's {gold['losses']}")
    check({k: ev[k] for k in gold["eval"] if k != "loss"} ==
          {k: v for k, v in gold["eval"].items() if k != "loss"},
          f"hapi a3: evaluation {ev} vs the golden's {gold['eval']}")
    saved = sorted(os.listdir(save_dir))
    check(saved == sorted(f"{e}.{x}" for e in ("0", "1", "final")
                          for x in ("pdopt", "pdparams")),
          f"hapi a3: ModelCheckpoint wrote {saved}")
    check(not m.stop_training, "hapi a3: EarlyStopping stopped the fit")

    easy = hapi_easy_data(datasets.FakeData)
    eval_ds = easy(size=HAPI_LENET["eval_size"], seed=HAPI_LENET["eval_seed"])
    cpu_net = models.LeNet()
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             m.network.state_dict().items()})
    cm = hapi.Model(cpu_net, device="cpu")
    cm.prepare(loss=nn.CrossEntropyLoss(),
               metrics=metric.Accuracy(topk=tuple(HAPI_LENET["topk"])))
    ev_card = m.evaluate(eval_ds, batch_size=32, verbose=0)
    ev_cpu = cm.evaluate(eval_ds, batch_size=32, verbose=0)
    check(abs(ev_card["loss"] - ev_cpu["loss"]) <=
          HAPI_CPU_TOL * abs(ev_cpu["loss"]) and
          {k: v for k, v in ev_card.items() if k != "loss"} ==
          {k: v for k, v in ev_cpu.items() if k != "loss"},
          f"hapi a3: evaluate on the card {ev_card} vs the CPU {ev_cpu}")
    # a loader, not the bare samples: predict iterates what is not an
    # io.Dataset as it comes, and FakeData's indices never run out
    inputs = io.DataLoader(_Inputs(eval_ds), batch_size=32)
    p_card = m.predict(inputs, stack_outputs=True)[0]
    p_cpu = cm.predict(inputs, stack_outputs=True)[0]
    gap = float(np.abs(p_card - p_cpu).max())
    check(p_card.shape == (HAPI_LENET["eval_size"], 10) and
          gap <= HAPI_CPU_TOL * float(np.abs(p_cpu).max()),
          f"hapi a3: predict gap {gap} between the card and the CPU")
    path = os.path.join(work, "hapi_lenet_saved", "model")
    m.save(path)
    lm = hapi.Model(models.LeNet(), device="cpu")
    lm.prepare(optim.Momentum(HAPI_LENET["lr"],
                              momentum=HAPI_LENET["momentum"]),
               nn.CrossEntropyLoss())
    lm.load(path)
    p_loaded = lm.predict(inputs, stack_outputs=True)[0]
    check(np.array_equal(p_loaded, p_cpu),
          "hapi a3: the loaded CPU Model predicts otherwise")
    same_opt = int(lm._opt_state["step"]) == int(m._opt_state["step"]) and \
        all(torch.equal(lm._opt_state["slots"][k]["velocity"],
                        v["velocity"].cpu())
            for k, v in m._opt_state["slots"].items())
    check(same_opt, "hapi a3: the loaded optimizer state differs")
    opt_step = int(lm._opt_state["step"])
    del m, cm, lm
    return {"losses": losses, "golden_losses": gold["losses"],
            "max_rel_gap": max(rel), "rtol": HAPI_GOLDEN_RTOL,
            "eval": ev, "golden_eval": gold["eval"], "fit_s": fit_s,
            "ms_per_step": clock.ms_per_step(), "checkpoints": saved,
            "eval_card": ev_card, "eval_cpu": ev_cpu,
            "predict_max_abs_gap": gap, "cpu_tol": HAPI_CPU_TOL,
            "loaded_predictions_equal": True, "optimizer_step": opt_step}


def hapi_phase(fa, fc, nn, gpt, engine, optim, framework, work, card=None):
    """``hapi``: (a1) GPT-base through ``Model.fit`` against the trainer,
    (a2) MobileNetV2 through ``Model.fit`` fed by ``DataLoader`` workers,
    (a3) LeNet's fit, evaluate, predict, save and load across the card
    and the CPU; each prints a line of its own (``hapi_a1`` ...). (a1)
    runs the six training kernels, (a2) and (a3) none."""
    from paddle_tpu_torch import hapi, io, metric, telemetry
    from paddle_tpu_torch.vision import datasets, models, transforms
    seconds = {}
    reps = {}

    def sub(key, fn):
        t0 = time.perf_counter()
        reps[key] = fn()
        seconds[key] = time.perf_counter() - t0
        emit(phase=f"hapi_{key}", card=card, seconds=seconds[key],
             **reps[key])
        torch.cuda.empty_cache()

    sub("a1", lambda: hapi_a1(fa, fc, nn, gpt, engine, optim, framework, io,
                              hapi))
    zero_counts(fa, fc)
    sub("a2", lambda: hapi_a2(nn, optim, framework, io, hapi, metric,
                              telemetry, models, transforms))
    sub("a3", lambda: hapi_a3(nn, optim, io, hapi, metric, models,
                              datasets, work))
    check_path(fa, fc, "hapi a2/a3", 0, 0, 0)
    return {"sub_phase_seconds": seconds, "launches": reps["a1"]["launches"]}


# -- experts, the sharded lookup, LocalSGD -------------------------------------

MOE_TOL = 1e-5          # rtol; atol 1e-5 of the largest element


def _close(got, want, what, tol=MOE_TOL):
    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    bar = tol * max(1.0, float(want.abs().max()))
    check(torch.allclose(got, want, rtol=tol, atol=bar),
          f"{what}: max abs error {err} over the bar")
    return err


def _moe_fwd_bwd(layer, x, r):
    x = x.detach().requires_grad_(True)
    y = layer(x)
    grads = torch.autograd.grad((y * r).sum(), [x] + list(layer.parameters()))
    return y.detach(), grads


def moe_e1(incubate, tokens=(8, 1024)):
    """(e1) ``MoELayer(768, 3072, num_experts=8)`` with every expert local:
    the golden (2 x 8 tokens) within 1e-5; 8 x 1024 tokens in float32 (TF32
    off) held against the port's CPU run of the same weights and tokens
    (output, aux loss, input and parameter gradients within ``MOE_TOL``),
    and in bfloat16 (finite, against float32 in relative L2); forward and
    forward+backward device ms of each, and the share of a bfloat16
    forward+backward's device time outside the GEMMs (the routing,
    dispatch and combine)."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "moe_golden.json")) as f:
        gold = json.load(f)
    cfg = gold["config"]
    check(cfg == {"d_model": 768, "d_hidden": 3072, "num_experts": 8,
                  "capacity_factor": 2.0}, f"MoE golden config {cfg}")
    layer = incubate.MoELayer(**cfg)
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    layer.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port MoE names/shapes differ from the golden")
    w = recipes.moe_weights(names_shapes, gold["recipe"]["weights"]["seed"])
    layer.set_state_dict_from_numpy(w)
    cpu_layer = incubate.MoELayer(**cfg)
    cpu_layer.set_state_dict_from_numpy(w)
    layer.cuda()
    xg = torch.from_numpy(recipes.moe_tokens(gold["recipe"]["data"]["seed"],
                                             gold["tokens"]))
    with torch.no_grad():
        yg = layer(xg.cuda())
    out = {"golden_err": _close(yg, torch.tensor(gold["out"]).reshape(
        yg.shape), "e1 golden")}
    check(abs(float(layer.aux_loss) - gold["aux_loss"]) <=
          MOE_TOL * max(1.0, abs(gold["aux_loss"])), "e1 golden aux_loss")
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(*tokens, 768).astype(np.float32))
    r = torch.from_numpy(rs.randn(*tokens, 768).astype(np.float32))
    y_cpu, g_cpu = _moe_fwd_bwd(cpu_layer, x, r)
    aux_cpu = float(cpu_layer.aux_loss)
    xc, rc = x.cuda(), r.cuda()
    y, g = _moe_fwd_bwd(layer, xc, rc)
    errs = {"out": _close(y, y_cpu, "e1 out f32")}
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    for n, a, b in zip(names, g, g_cpu):
        errs[f"grad_{n}"] = _close(a, b, f"e1 grad {n} f32")
    check(abs(float(layer.aux_loss) - aux_cpu) <= MOE_TOL, "e1 aux f32")
    out["f32_vs_cpu_max_abs_err"] = errs
    cap = layer.capacity(tokens[0] * tokens[1])
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        lay = layer.to(dtype)
        xd, rd = xc.to(dtype), rc.to(dtype)
        with torch.no_grad():
            fwd = time_ms(lambda: lay(xd), reps=10, warmup=2)
        both = time_ms(lambda: _moe_fwd_bwd(lay, xd, rd), reps=10, warmup=2)
        # the experts' FLOPs: 2 GEMMs of E*cap rows, forward; twice that
        # more in the backward
        flops = 2 * 2 * cfg["num_experts"] * cap * 768 * 3072
        timing[str(dtype).split(".")[-1]] = {
            "fwd_ms": fwd, "fwd_bwd_ms": both,
            "expert_tflops_fwd": flops / fwd / 1e9}
    yb, _ = _moe_fwd_bwd(layer, xc.bfloat16(), rc.bfloat16())
    check(bool(torch.isfinite(yb).all()), "e1 bf16 output not finite")
    rel_l2 = float((yb.float() - y).norm() / y.norm())
    check(rel_l2 < 0.1, f"e1 bf16 output {rel_l2} off float32 in L2")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _moe_fwd_bwd(layer, xc.bfloat16(), rc.bfloat16())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report, rows = _profile_report(prof, wall)
    check(rows, "the profiler saw no kernel of the MoE on the card")
    gemm = sum(us for us, name, _ in rows if "gemm" in name.lower() or
               name.startswith("nvjet") or "cutlass" in name.lower())
    total = sum(us for us, _, _ in rows)
    out.update(timing=timing, capacity=cap, tokens=list(tokens),
               bf16_rel_l2_vs_f32=rel_l2,
               bf16_outside_gemm_share=(total - gemm) / total,
               bf16_profile=report)
    del layer, cpu_layer
    torch.cuda.empty_cache()
    return out


def lookup_e2(sharded_embedding, mesh, fields=26, rows=100_000, dim=16,
              batch=4096):
    """(e2) ``alltoall_lookup`` at one rank on heter_ctr's table (26 fields
    x 100,000 rows x 16 float32, ids ``zipf(1.3)`` of a 4096 x 26 batch):
    a cap that holds every id and one that overflows; the forward bit for
    bit the dense gather, the table's gradient within 1e-5 of the dense
    gather's (``index_add_``); ms of a lookup."""
    rs = np.random.RandomState(0)
    table = torch.from_numpy(rs.randn(fields * rows, dim).astype(
        np.float32)).cuda()
    u = rs.zipf(1.3, size=(batch, fields))
    ids = ((u % rows) + np.arange(fields)[None, :] * rows).reshape(-1)
    ids = torch.from_numpy(ids.astype(np.int64)).cuda()
    n = ids.numel()
    coef = torch.from_numpy(rs.randn(n, 1).astype(np.float32)).cuda()
    dense = table[ids]
    want = torch.zeros_like(table).index_add_(0, ids, coef.expand(n, dim))
    out = {}
    for name, cap in (("fits", n), ("overflows", n // 2)):
        t = table.clone().requires_grad_(True)
        got = sharded_embedding.alltoall_lookup(t, ids, "data", cap,
                                                table.shape[0], mesh=mesh)
        check(torch.equal(got, dense), f"e2 lookup ({name}) != dense gather")
        (g,) = torch.autograd.grad((got * coef).sum(), [t])
        err = _close(g, want, f"e2 lookup grad ({name})")
        with torch.no_grad():
            ms = time_ms(lambda: sharded_embedding.alltoall_lookup(
                table, ids, "data", cap, table.shape[0], mesh=mesh),
                reps=10, warmup=2)
        out[name] = {"cap": cap, "grad_max_abs_err": err, "ms": ms}
    out.update(ids=n, dense_gather_ms=time_ms(lambda: table[ids], reps=10,
                                              warmup=2))
    return out


def localsgd_e2(nn, optim, engine, meta_parallel, mesh, steps=4):
    """(e2) ``LocalSGDTrainer`` at one rank on the NCCL mesh: k 1 fp32 bit
    for bit the plain ``ParallelTrainer`` (the mean over one rank is the
    identity); k 2 int8 runs with finite, falling losses."""
    from paddle_tpu_torch.framework import seed

    def model():
        seed(0)
        return nn.Sequential(nn.Linear(768, 3072), nn.GELU(),
                             nn.Linear(3072, 768))

    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(64, 768).astype(np.float32)).cuda()
    y = torch.from_numpy(rs.randn(64, 768).astype(np.float32)).cuda()
    mse = lambda o, t: ((o - t) ** 2).mean()  # noqa: E731
    plain = engine.ParallelTrainer(model(), optim.Momentum(0.05), mse,
                                   mesh=mesh)
    local = meta_parallel.LocalSGDTrainer(model(), optim.Momentum(0.05), mse,
                                          mesh=mesh)
    lp = [plain.train_step(x, y).item() for _ in range(steps)]
    ll = [local.train_step(x, y).item() for _ in range(steps)]
    check(lp == ll and all(torch.equal(plain.params[k], local.params[k])
                           for k in plain.params),
          f"e2 LocalSGD k1 != ParallelTrainer: {ll} vs {lp}")
    q = meta_parallel.LocalSGDTrainer(model(), optim.Momentum(0.05), mse,
                                      mesh=mesh, k_steps=2,
                                      param_sync="int8")
    lq = [q.train_step(x, y).item() for _ in range(steps)]
    check(all(np.isfinite(lq)) and lq[-1] < lq[0], f"e2 int8 losses {lq}")
    return {"k1_losses": ll, "k1_bit_equal_plain": True,
            "int8_k2_losses": lq}


def experts_phase(fa, fc, nn, optim, engine):
    """``experts``: (e1) the MoE layer on one card; (e2) the lookup and
    LocalSGD at one rank over NCCL (``dp_setup``). A mesh of one rank
    issues no collective (its groups are the identity); the collectives
    are held on gloo (the CPU tests) and on four cards
    (``tests/torch_ep_cards.py``). No kernel of the port runs here."""
    import torch.distributed as dist
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.distributed import meta_parallel
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops import sharded_embedding
    zero_counts(fa, fc)
    mesh_mod.set_mesh(None)
    out = {"e1_moe": moe_e1(incubate)}
    nccl, _, _ = dp_setup()
    try:
        out["e2_lookup"] = lookup_e2(sharded_embedding, nccl)
        out["e2_localsgd"] = localsgd_e2(nn, optim, engine, meta_parallel,
                                         nccl)
        out["e2_backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    out["launches"] = check_path(fa, fc, "experts", 0, 0, 0)
    return out


def op_host_us(fa, fc, pa, calls=2000):
    """Host microseconds a call of each registered kernel op takes beside
    its bare launcher (the op's dispatch is the difference), at small
    shapes whose kernels finish within the launch interval."""
    rs = np.random.RandomState(5)

    def t(*shape, dtype=torch.bfloat16):
        return torch.as_tensor(rs.randn(*shape).astype(np.float32),
                               device="cuda").to(dtype)
    q, k, v, do = (t(1, 128, 2, 64) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa._delta(out, do)
    scale = 1.0 / 8.0
    blocks = fa.keying_blocks(q.dtype, 64, 128, 128)
    hid, w = t(128, 64), t(64, 512)
    lbl = torch.as_tensor(rs.randint(0, 512, 128).astype(np.int32),
                          device="cuda")
    clse, _ = fc.ce_fwd(hid, w, lbl)
    cscale = torch.full((128,), 1.0 / 128, device="cuda")
    pq, kp, vp, tab, _ = paged_inputs(rs, 1, torch.float32, [64] * 2, b=2,
                                      h=2, d=64, w=4, p=16)
    ln = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    args = (None, None, scale, True, 0.0, *blocks)
    pairs = {
        "flash_dq": (lambda: fa.FLASH_DQ_OP(q, k, v, out, do, lse, delta,
                                            *args),
                     lambda: fa._launch_dq(q, k, v, do, lse, delta, None, 0,
                                           scale, True, 0.0, blocks)),
        "flash_dkv": (lambda: fa.FLASH_DKV_OP(q, k, v, out, do, lse, delta,
                                              *args),
                      lambda: fa._launch_dkv(q, k, v, do, lse, delta, None,
                                             0, scale, True, 0.0, blocks)),
        "ce_fwd": (lambda: fc.CE_FWD_OP(hid, w, lbl),
                   lambda: fc.ce_fwd(hid, w, lbl)),
        "ce_dh": (lambda: fc.CE_DH_OP(hid, w, lbl, clse, cscale),
                  lambda: fc.ce_dh(hid, w, lbl, clse, cscale)),
        "ce_dw": (lambda: fc.CE_DW_OP(hid, w, lbl, clse, cscale),
                  lambda: fc.ce_dw(hid, w, lbl, clse, cscale)),
        "paged": (lambda: pa.PAGED_OP(pq, kp, vp, tab, ln, scale, None,
                                      None),
                  lambda: pa._paged_attention(pq, kp, vp, tab, ln, scale,
                                              None, None)),
    }
    res = {}
    for name, (op, bare) in pairs.items():
        row = {}
        for label, fn in (("op_us", op), ("bare_us", bare)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            row[label] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
        row["dispatch_us"] = row["op_us"] - row["bare_us"]
        res[name] = row
    return res


def gpt_params(vocab, h, layers, seq):
    """GPT's parameter count: embeddings, 12h^2 + 13h a block, the final
    LayerNorm (bench.py's widths; 124,475,904 at GPT-base)."""
    return vocab * h + seq * h + layers * (12 * h * h + 13 * h) + 2 * h


def _kernel_nodes(walker, graph):
    return {walker.KERNEL_OPS[k]: n for k, n in
            walker.count_by_op(graph).items() if k in walker.KERNEL_OPS}


def _step_kernels(trainer, batch):
    """Device kernels of one real step under torch.profiler, and the
    step's wall ms."""
    from torch.profiler import ProfilerActivity, profile
    inputs, lbls = batch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(inputs, lbls))
        wall = time.perf_counter() - t0
    _, rows = _profile_report(prof, wall)
    return sum(n for _, _, n in rows), wall * 1e3


def _timed_ms(trainer, batch, warmup=2, iters=3):
    """Mean ms of a synced step after ``warmup`` steps."""
    inputs, lbls = batch
    for _ in range(warmup):
        float(trainer.train_step(inputs, lbls))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = trainer.train_step(inputs, lbls)
    float(loss)
    return (time.perf_counter() - t0) / iters * 1e3


# -- the declarative mode: staged graphs on the card -----------------------------
STATIC_STEPS = 10
STATIC_LOSS_RTOL = 1e-5


def _dy_if(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def _dy_while(x):
    s = x.sum() * 0.0
    while s < 10.0:
        s = s + x.abs().sum()
    return s


def _dy_for(x, n):
    acc = x * 0.0
    for i in range(n):
        acc = acc + x * i
    return acc


def _graph_ops(graph):
    """Call-node op names of a graph and of its control-flow subgraphs."""
    out = []
    for gm in [graph] + [m for m in graph.modules()
                         if isinstance(m, torch.fx.GraphModule)]:
        out += [getattr(n.target, "__name__", str(n.target))
                for n in gm.graph.nodes if n.op == "call_function"]
    return out


def static_dy2static(nn, jit):
    """(c) converted functions with a tensor-dependent ``if``, ``while``
    and ``for range``, staged by ``to_static`` on the card: their graphs
    hold ``cond`` / ``while_loop`` nodes, and each output equals the
    converted function's eager run on the card and its staged run on the
    CPU; a converted layer through ``jit.save`` / ``jit.load`` on the
    card."""
    from paddle_tpu_torch.jit.dy2static import convert_function
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(64, 64).astype(np.float32))
    n = torch.tensor(5, dtype=torch.int32)
    rows = {}
    for name, fn, args, op in (
            ("if", _dy_if, (x,), "cond"), ("if_neg", _dy_if, (-x.abs(),),
                                           "cond"),
            ("while", _dy_while, (x,), "while_loop"),
            ("for_range", _dy_for, (x, n), "while_loop")):
        card_args = [a.cuda() for a in args]
        staged = jit.to_static(fn)
        out = staged(*card_args)
        torch.cuda.synchronize()
        ops = _graph_ops(staged.graph(*card_args))
        check(any(op in o for o in ops), f"static (c) {name}: no {op} node "
              f"in the staged graph: {sorted(set(ops))}")
        eager = convert_function(fn)(*card_args)
        cpu = jit.to_static(fn)(*args)
        same_eager = _same_bits(out, eager)
        check(same_eager, f"static (c) {name}: staged {out} != eager "
              f"{eager} on the card")
        check(torch.allclose(out.cpu(), cpu, rtol=1e-5, atol=1e-5),
              f"static (c) {name}: card {out} vs CPU {cpu}")
        rows[name] = {"node": op, "bit_equal_to_eager": same_eager,
                      "max_abs_vs_cpu": (out.cpu() - cpu).abs().max().item()}

    class Gate(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(64, 32)

        def forward(self, h):
            out = nn.functional.relu(self.fc(h))
            if h.mean() > 1e9:
                out = out * 0.0
            return out

    layer = Gate().cuda()
    layer.eval()
    converted = jit.to_static(layer).layer
    with tempfile.TemporaryDirectory(prefix="static_save_") as d:
        path = os.path.join(d, "gate")
        jit.save(converted, path, input_spec=[jit.InputSpec([8, 64])])
        loaded = jit.load(path)
        xb = x[:8].cuda()
        got = loaded(xb)
        with torch.no_grad():
            want = converted(xb)
        check(loaded.device.type == "cuda" and _same_bits(got, want),
              "static (c): the converted layer's jit.load differs")
    rows["jit_save_load"] = {"device": str(loaded.device),
                             "bit_equal": True}
    return rows


def static_phase(fa, fc, nn, gpt, engine, optim, framework, card,
                 layers=12, batch=8, seq=1024):
    """``static``: the declarative mode on the existing kernels.

    (a) ``jit.to_static(GPTForPretraining)`` at GPT-base widths: the
        staged forward's graph holds 12 flash-forward nodes; a call
        launches 12 flash forwards on the mma route, its logits held
        against the layer's eager forward (bit equality printed; the
        largest gap within ``FLASH_TOL[bf16]``).
    (b) a ``static.Program`` of ``fused_head_loss(ce_kernel="pallas")``'s
        value and parameter gradients (``append_backward``), the
        parameters graph inputs, run for ``STATIC_STEPS`` steps by
        ``Executor.run(return_numpy=False)`` with the port's AdamW applying
        the fetched gradients: each step launches 36 flash kernels and
        the CE forward, dh and dw once; its losses within
        ``STATIC_LOSS_RTOL`` of ``fused_b8_pallas_ce``'s trainer on the
        same init and batch, step times beside the trainer's; the
        program's analysis summary (traced on fakes).
    (s) ``jit.to_static`` of the same loss, trained ``STATIC_STEPS``
        steps through autograd over the staged graph with the port's
        AdamW: 12 flash launches of each kernel and one of each CE kernel
        a step, losses within ``STATIC_LOSS_RTOL`` of the trainer's.
    (c) :func:`static_dy2static`."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.analysis.walker import count_by_op
    rep = {"card": card}
    ids, lbl = gpt_base_batch(batch, seq)

    # (a) the staged forward
    model = gpt_base_model(gpt, framework, seq, layers).cuda()
    model.eval()
    t0 = time.perf_counter()
    staged = jit.to_static(model)
    with torch.no_grad():
        graph = staged.graph(ids)
    trace_s = time.perf_counter() - t0
    nodes = count_by_op(graph)
    check(nodes.get("paddle_tpu_torch.flash_attention_fwd") == layers,
          f"static (a): {nodes.get('paddle_tpu_torch.flash_attention_fwd')} "
          f"flash-forward nodes, want {layers}")
    with torch.no_grad():
        eager = model(ids)
        zero_counts(fa, fc)
        logits = staged(ids)
        torch.cuda.synchronize()
        launches_a = check_path(fa, fc, "static (a)", layers, 0, 0)
        call_ms = time_ms(lambda: staged(ids), reps=10, warmup=2)
        eager_ms = time_ms(lambda: model(ids), reps=10, warmup=2)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    gap = (logits.float() - eager.float()).abs().max().item()
    check(torch.allclose(logits.float(), eager.float(), rtol=rtol,
                         atol=atol), f"static (a): logits gap {gap}")
    rep["a"] = {"graph_nodes": sum(nodes.values()),
                "flash_fwd_nodes": layers, "trace_s": trace_s,
                "launches": launches_a,
                "bit_equal_to_eager": _same_bits(logits, eager),
                "max_abs_gap": gap, "tol": [rtol, atol],
                "call_ms": call_ms, "eager_forward_ms": eager_ms}
    del model, staged, graph, eager, logits
    torch.cuda.empty_cache()

    # (b) the yardstick: fused_b8_pallas_ce's trainer, same init and batch
    trainer, tbatch, n_params = gpt_base_trainer(
        nn, gpt, engine, optim, framework, batch, seq, head="pallas",
        layers=layers)
    inputs, lbls = tbatch
    t_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STATIC_STEPS):
        t_losses.append(trainer.train_step(inputs, lbls))
    torch.cuda.synchronize()
    trainer_ms = (time.perf_counter() - t0) / STATIC_STEPS * 1e3
    t_losses = [x.item() for x in t_losses]
    trainer_prof = profile_calls(lambda: trainer.train_step(inputs, lbls))
    del trainer, tbatch
    torch.cuda.empty_cache()

    model = gpt_base_model(gpt, framework, seq, layers).cuda()
    names = [n for n, _ in model.named_parameters()]
    grad_fn = static.append_backward(
        lambda i, t: model.fused_head_loss(i, t, chunk=8192,
                                           ce_kernel="pallas"),
        parameter_list=model)

    def step_fn(i, t):
        loss, grads = grad_fn(i, t)
        return (loss, *grads)

    t0 = time.perf_counter()
    prog = static.Program.trace(
        step_fn, static.data("ids", [batch, seq], "int32"),
        static.data("lbl", [batch, seq], "int32"), parameters=model,
        fetch_names=["loss"] + [n + "@GRAD" for n in names])
    prog_trace_s = time.perf_counter() - t0
    pnodes = count_by_op(prog.graph)
    for op, want in (("flash_attention_fwd", layers),
                     ("flash_attention_dq", layers),
                     ("flash_attention_dkv", layers), ("fused_ce_fwd", 1),
                     ("fused_ce_dh", 1), ("fused_ce_dw", 1)):
        got = pnodes.get("paddle_tpu_torch." + op, 0)
        check(got == want, f"static (b): {got} {op} nodes, want {want}")
    t0 = time.perf_counter()
    summary = prog.analyze().summary()
    analyze_s = time.perf_counter() - t0
    exe = static.Executor()
    opt = optim.AdamW(3e-4, parameters=model.named_parameters())
    params = dict(model.named_parameters())
    feed = {"ids": ids, "lbl": lbl}

    def one():
        outs = exe.run(prog, feed=feed, fetch_list=prog.fetch_names,
                       return_numpy=False)
        for n, g in zip(names, outs[1:]):
            params[n].grad = g
        opt.step()
        opt.clear_grad()
        return outs[0]

    zero_counts(fa, fc)
    s_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STATIC_STEPS):
        s_losses.append(one())
    torch.cuda.synchronize()
    static_ms = (time.perf_counter() - t0) / STATIC_STEPS * 1e3
    launches_b = check_path(fa, fc, "static (b)", layers * STATIC_STEPS,
                            layers * STATIC_STEPS, STATIC_STEPS)
    s_losses = [x.item() for x in s_losses]
    rel = [abs(a - b) / abs(b) for a, b in zip(s_losses, t_losses)]
    check(all(r <= STATIC_LOSS_RTOL for r in rel),
          f"static (b): losses {s_losses} vs the trainer's {t_losses}")
    check(len(prog._compiled) == 1, "static (b): traced more than once")
    static_prof = profile_calls(one)
    rep["b"] = {"params": n_params, "steps": STATIC_STEPS,
                "losses": s_losses, "trainer_losses": t_losses,
                "rel_gap": rel, "rtol": STATIC_LOSS_RTOL,
                "bit_equal_to_trainer": s_losses == t_losses,
                "launches": launches_b, "graph_nodes": sum(pnodes.values()),
                "trace_s": prog_trace_s, "analyze_s": analyze_s,
                "analysis": summary,
                "ms_per_step": static_ms, "trainer_ms_per_step": trainer_ms,
                "profile": static_prof, "trainer_profile": trainer_prof}
    del model, opt, prog, params
    torch.cuda.empty_cache()

    # (s) the same loss staged by to_static, trained through autograd over
    # the staged graph (the CE and flash ops keep their backward)
    model = gpt_base_model(gpt, framework, seq, layers).cuda()

    def head_loss(i, t):
        return model.fused_head_loss(i, t, chunk=8192, ce_kernel="pallas")

    staged_loss = jit.to_static(head_loss)
    t0 = time.perf_counter()
    sgraph = staged_loss.graph(ids, lbl)
    s_trace_s = time.perf_counter() - t0
    snodes = count_by_op(sgraph)
    for op, want in (("flash_attention_fwd", layers), ("fused_ce_fwd", 1)):
        got = snodes.get("paddle_tpu_torch." + op, 0)
        check(got == want, f"static (s): {got} {op} nodes, want {want}")
    opt = optim.AdamW(3e-4, parameters=model.named_parameters())

    def s_step():
        loss = staged_loss(ids, lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    zero_counts(fa, fc)
    g_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STATIC_STEPS):
        g_losses.append(s_step())
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t0) / STATIC_STEPS * 1e3
    launches_s = check_path(fa, fc, "static (s)", layers * STATIC_STEPS,
                            layers * STATIC_STEPS, STATIC_STEPS)
    g_losses = [x.item() for x in g_losses]
    rel_s = [abs(a - b) / abs(b) for a, b in zip(g_losses, t_losses)]
    check(all(r <= STATIC_LOSS_RTOL for r in rel_s),
          f"static (s): losses {g_losses} vs the trainer's {t_losses}")
    staged_prof = profile_calls(s_step)
    rep["s"] = {"steps": STATIC_STEPS, "losses": g_losses,
                "trainer_losses": t_losses, "rel_gap": rel_s,
                "rtol": STATIC_LOSS_RTOL,
                "bit_equal_to_trainer": g_losses == t_losses,
                "launches": launches_s, "graph_nodes": sum(snodes.values()),
                "trace_s": s_trace_s, "ms_per_step": staged_ms,
                "program_ms_per_step": static_ms,
                "trainer_ms_per_step": trainer_ms, "profile": staged_prof}
    del model, opt, staged_loss, sgraph
    torch.cuda.empty_cache()

    # (c) dy2static
    rep["c"] = static_dy2static(nn, jit)
    rep["launches"] = {k: launches_a[k] + launches_b[k] + launches_s[k]
                       for k in launches_b}
    return rep


def analysis_phase(fa, fc, pa, nn, gpt, engine, optim, framework):
    """``analysis``: the program analysis of the port on the card.
    (a) trace GPT-base's fused_b8_pallas_ce step on CUDA fakes: seconds,
    nodes, kernel nodes against one real step's launches, 0 launches and
    no allocation during the trace, ATen nodes beside the profiler's
    kernels; (b) matmul FLOPs beside 6NT + 6LSdT with each term of the
    difference, the peak live bytes beside the real peak, the overlap
    model's step at the peak FLOP/s beside the measured step
    (``step_time`` and ``planner_step_time`` drift ratios); (c) the lint
    of GPT-base, bench_resnet50 and the decode executors (0 errors); (d)
    plan_search for GPT-base and gpt_1p3b at 1 and 4 cards of this card's
    memory, the top 3 one-card plans staged and timed; (e) the schedule
    and structure fingerprints of the plain and the check step. Also the
    host cost of each registered kernel op."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.analysis import cost, lint, schedule, walker
    from paddle_tpu_torch.distributed import auto
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.telemetry import calibration
    out = {"op_host_us": op_host_us(fa, fc, pa)}
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    inputs, lbls = batch
    float(trainer.train_step(inputs, lbls))     # slots made, warm
    torch.cuda.synchronize()

    # (a) the trace
    zero_counts(fa, fc)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step, rep = trainer.compile(inputs, lbls, analyze=True)
    trace_s = time.perf_counter() - t0
    graph = rep.graph
    mem1 = torch.cuda.memory_allocated()
    during = {**fa.LAUNCHES, **fc.LAUNCHES}
    check(all(n == 0 for n in during.values()),
          f"analysis: the trace launched {during}")
    check(mem1 == mem0, f"analysis: the trace allocated {mem1 - mem0} B")
    nodes = _kernel_nodes(walker, graph)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, fc)
    float(step())
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    launches = check_path(fa, fc, "analysis", 12, 12, 1)
    check(nodes == {k: v for k, v in launches.items() if v},
          f"analysis: kernel nodes {nodes} != one step's launches "
          f"{launches}")
    kernels_per_step, _ = _step_kernels(trainer, batch)
    by_op = walker.count_by_op(graph)
    aten = sum(n for k, n in by_op.items() if k.startswith("aten."))
    out["a_trace"] = {
        "seconds": trace_s, "nodes": walker.count_nodes(graph),
        "aten_nodes": aten, "kernel_nodes": nodes, "launches": launches,
        "profiler_kernels_per_step": kernels_per_step,
        "allocated_during_trace": mem1 - mem0,
        "launches_during_trace": sum(during.values()),
        "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:8]}

    # (b) cost
    b, s = inputs[0].shape
    tokens, L, d, vocab = b * s, 12, 768, 50304
    mm = cost.matmul_flops(graph)
    model = (6 * n_params + 6 * L * s * d) * tokens
    emb = vocab * d + s * d
    # the difference from 6NT + 6LSdT, term by term: the embeddings are
    # lookups, not matmuls; biases and LayerNorms are no matmuls either;
    # the tied head runs in the CE kernels, hid.W in the forward, dh and
    # dw (the logits recomputed in each backward kernel: 10VdT); the flash
    # backward recomputes the scores in dq and in dk/dv (9 products a
    # layer where 6LSdT counts 6)
    terms = {
        "6NT": 6 * n_params * tokens, "6LSdT": 6 * L * s * d * tokens,
        "embeddings_are_lookups": -6 * emb * tokens,
        "biases_and_layernorm": -6 * (n_params - emb - L * 12 * d * d)
        * tokens,
        "ce_kernels_head_10VdT": 10 * vocab * d * tokens,
        "flash_bwd_recompute_3LSdT": 3 * L * s * d * tokens}
    named = sum(terms.values())
    peak_flops = telemetry.peak_flops_per_sec()
    plan_ = cost.overlap_plan(graph, trainer.mesh)
    pred = cost.replay_overlap(plan_, peak_flops=peak_flops)
    pred_989 = cost.replay_overlap(plan_, peak_flops=H100_BF16_FLOPS)
    measured = _timed_ms(trainer, batch)
    drift = calibration.record("planner_step_time",
                               pred_989["makespan"], measured / 1e3)
    out["b_cost"] = {
        "matmul_flops": mm, "model_flops_6NT_6LSdT": model,
        "terms": terms, "named_sum": named,
        "matmul_over_named": mm / named,
        "total_flops": rep.cost.total_flops,
        "total_bytes": rep.cost.total_bytes,
        "peak_live_bytes": rep.cost.peak_live_bytes,
        "max_memory_allocated": real_peak,
        "peak_over_real": rep.cost.peak_live_bytes / real_peak,
        "peak_flops_per_sec": peak_flops,
        "predicted_ms": pred["makespan"] * 1e3,
        "predicted_ms_at_989_tflops": pred_989["makespan"] * 1e3,
        "bytes_ms_at_3_35_tbs": rep.cost.total_bytes / H100_BYTES_PER_S * 1e3,
        "measured_ms": measured,
        "planner_step_time_drift": drift}
    check(mm > 0 and abs(mm / named - 1) < 1e-9,
          f"analysis: matmul FLOPs {mm} against the named terms {named}")
    findings = {"gpt": rep}
    del step, graph, rep
    del trainer, batch
    torch.cuda.empty_cache()

    # (c) lint: bench_resnet50, BERT at S 128 and 512, the decode
    # executors; BERT's kernel nodes against its steps' launches (text
    # phase: none at 128, 12 of each at 512) and its matmul FLOPs against
    # 6NT + 6LSdT and the named differences
    t0 = time.perf_counter()
    bert = {}
    for name in ("resnet", "bert", "decode"):
        for prog, (r, g, _) in lint.lint_model(name, False, 5,
                                               "cuda").items():
            findings[f"{name}:{prog}"] = r
            if name == "bert":
                seq = int(prog.split("-s")[1])
                want = ({"flash_fwd": 12, "flash_dq": 12, "flash_dkv": 12}
                        if seq >= 512 else {})
                nodes = _kernel_nodes(walker, g)
                check(nodes == want, f"analysis: {prog} kernel nodes "
                      f"{nodes} != {want}")
                n_bert = lint.bert_params(lint.bert_config(False))
                terms = lint.bert_matmul_terms(
                    lint.bert_config(False), n_bert, 16, seq, seq >= 512)
                mm = cost.matmul_flops(g)
                named = sum(terms.values())
                check(abs(mm / named - 1) < 1e-9, f"analysis: {prog} "
                      f"matmul FLOPs {mm} against the named terms {named}")
                bert[prog] = {"params": n_bert, "kernel_nodes": nodes,
                              "matmul_flops": mm, "terms": terms,
                              "named_sum": named,
                              "model_flops_6NT_6LSdT": terms["6NT"] +
                              terms["6LSdT"]}
                del g
                torch.cuda.empty_cache()
    lint_s = time.perf_counter() - t0
    out["c_lint"] = {
        "seconds": lint_s,
        "programs": {k: {"nodes": r.num_eqns, "counts": r.counts(),
                         "warnings": sorted({f.rule for f in r.warnings}),
                         "warning_lines": [f.render()[:160]
                                           for f in r.warnings[:6]]}
                     for k, r in findings.items()}}
    out["c_lint"]["bert"] = bert
    check(all(not r.errors for r in findings.values()),
          "analysis: error findings: " + "; ".join(
              f.render() for r in findings.values() for f in r.errors))
    torch.cuda.empty_cache()

    # (d) plans
    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    configs = {"gpt_base": dict(n=n_params, layers=12, hidden=768),
               "gpt_1p3b": dict(n=gpt_params(50304, 2048, 24, 1024),
                                layers=24, hidden=2048)}
    plans = {}
    for name, c in configs.items():
        for cards in (1, 4):
            ranked = auto.plan_search(
                c["n"], cards, layers=c["layers"], hidden=c["hidden"],
                seq_len=1024, batch_per_device=8, hbm_bytes=hbm,
                peak_flops=H100_BF16_FLOPS, top_k=3)
            plans[f"{name}@{cards}"] = [p.to_dict() for p in ranked]

    def builder(p):
        kw = {k: v for k, v in p.apply().items()
              if k in ("remat", "accumulate_steps")}
        tr, bt, _ = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                     head="pallas", layers=PLAN_LAYERS,
                                     **kw)
        return tr, bt[0], bt[1]
    staged = auto.plan_search(
        gpt_params(50304, 768, PLAN_LAYERS, 1024), 1, layers=PLAN_LAYERS,
        hidden=768, seq_len=1024, batch_per_device=8, hbm_bytes=hbm,
        peak_flops=H100_BF16_FLOPS, top_k=3, stage_top_k=3,
        builder=builder)
    rows = []
    for p in staged:
        tr, inp, lb = builder(p)
        rows.append({"plan": {k: p.to_dict()[k] for k in (
            "remat", "micro_batches", "grad_sync")},
            "tier": p.predicted.tier,
            "predicted_ms": p.predicted.total * 1e3,
            "measured_ms": _timed_ms(tr, (inp, lb)),
            "memory_gb": p.per_device.total / 1e9})
        del tr
        torch.cuda.empty_cache()
    out["d_plans"] = {"analytic": plans, "staged_depth": PLAN_LAYERS,
                      "staged": rows}

    # (e) fingerprints of the plain and the check step (depth cut)
    tr, bt, _ = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                 head="pallas", layers=2,
                                 integrity_check_every=4)
    fps = {}
    for name, check_step in (("step", False), ("step-check", True)):
        g1 = tr.staged_graph(*bt, do_check=check_step)
        g2 = tr.staged_graph(*bt, do_check=check_step)
        fps[name] = {
            "schedule": [schedule.program_fingerprint(g, tr.mesh)
                         for g in (g1, g2)],
            "structure": [schedule.program_fingerprint(
                g, tr.mesh, structure=True) for g in (g1, g2)]}
    for name, f in fps.items():
        for kind in ("schedule", "structure"):
            check(f[kind][0] == f[kind][1],
                  f"analysis: {name} {kind} fingerprint changed between "
                  "two traces")
    check(fps["step"]["structure"][0] != fps["step-check"]["structure"][0],
          "analysis: the plain and the check step fingerprint alike")
    out["e_fingerprints"] = {k: {kind: v[kind][0][:16] for kind in v}
                             for k, v in fps.items()}
    del tr
    torch.cuda.empty_cache()
    zero_counts(fa, fc)
    out["launches"] = launches
    return out


# -- text: BERT/ERNIE pretraining ----------------------------------------------

BERT_LOSS_RTOL = (1e-4, 1e-3)       # step 0, later steps (train_golden's)
BERT_GRAD_NORM_RTOL = 1e-4


def _bert_loss(model):
    return lambda outputs, labels: model.loss(*outputs, *labels)


def bert_golden(optim, engine, mesh_mod, models):
    """(t1) BERT-base widths at depth 2, float32 (TF32 off), dropout 0,
    against ``bert_golden.json``: the step-0 loss and gradient norm (rtol
    1e-4), three ``train_step``s' losses (1e-4, then 1e-3)."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "bert_golden.json")) as f:
        gold = json.load(f)
    cfg = {k: v for k, v in gold["config"].items()
           if k not in ("dtype", "batch", "seq")}
    check(gold["config"]["dtype"] == "float32" and
          cfg["hidden_size"] == 768 and cfg["vocab_size"] == 30528,
          f"golden config {gold['config']}")
    model = models.BertForPretraining(tensor_parallel=False, **cfg)
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port state names/shapes differ from the BERT golden")
    rw = gold["recipe"]["weights"]
    model.set_state_dict_from_numpy(recipes.bert_weights(
        names_shapes, rw["seed"], rw["std"]))
    model.cuda()
    ids, mlm, nsp = (torch.from_numpy(a).cuda() for a in recipes.bert_data(
        gold["recipe"]["data"]["seed"], gold["config"]["batch"],
        gold["config"]["seq"], cfg["vocab_size"]))
    loss0 = model.loss(*model(ids), mlm, nsp)
    grads = torch.autograd.grad(loss0, list(model.parameters()))
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).item()
    loss0 = loss0.item()
    del grads
    trainer = engine.ParallelTrainer(
        model, optim.AdamW(gold["optimizer"]["learning_rate"]),
        _bert_loss(model), mesh=mesh_mod.build_mesh({"data": 1}))
    losses = [trainer.train_step(ids, (mlm, nsp)).item()
              for _ in gold["losses"]]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    check(rel(loss0, gold["losses"][0]) <= BERT_LOSS_RTOL[0],
          f"t1 step-0 loss {loss0} vs golden {gold['losses'][0]}")
    check(rel(gnorm, gold["step0_grad_norm"]) <= BERT_GRAD_NORM_RTOL,
          f"t1 step-0 grad norm {gnorm} vs {gold['step0_grad_norm']}")
    check(rel(losses[0], gold["losses"][0]) <= BERT_LOSS_RTOL[0],
          f"t1 train_step 0 loss {losses[0]} vs {gold['losses'][0]}")
    for i in range(1, len(losses)):
        check(rel(losses[i], gold["losses"][i]) <= BERT_LOSS_RTOL[1],
              f"t1 loss after {i} updates {losses[i]} vs "
              f"{gold['losses'][i]}")
    check(trainer.skipped_steps() == 0, "t1: a step skipped")
    return {"loss0": loss0, "grad_norm": gnorm, "losses": losses,
            "golden_losses": gold["losses"],
            "golden_grad_norm": gold["step0_grad_norm"],
            "loss_rel_err": [rel(a, b) for a, b in
                             zip([loss0] + losses, gold["losses"][:1]
                                 + gold["losses"])],
            "grad_norm_rel_err": rel(gnorm, gold["step0_grad_norm"])}


def _group_text(name):
    low = name.lower()
    if "flash_" in low:
        return "flash kernels"
    if "gemm" in low or low.startswith("nvjet") or "cutlass" in low:
        return "GEMMs"
    if "softmax" in low:
        return "softmax (plain attention)"
    if "layer_norm" in low or "layernorm" in low:
        return "LayerNorm"
    if "reduce" in low or "logsumexp" in low:
        return "reductions (loss, norms)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    return "elementwise and the rest"


def bert_steps(fa, fc, tuner, trainer, batch, seq, warmup, iters, flash):
    """bench_bert_amp's timed loop at ``seq``: ``warmup`` + ``iters`` steps
    with the counts set to 0 just before, then three profiled steps. The
    flash kernels launch 12 times a step at S >= 512 on the mma route
    (``flash``), else never, each attention counted as a fallback."""
    ids, labels = batch
    n_steps = warmup + iters
    fb0 = tuner.FALLBACKS["flash_attention"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, fc)
    losses = [trainer.train_step(ids, labels).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step(ids, labels) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    launches = dict(fa.LAUNCHES)
    routes = dict(fa.ROUTES)
    fallbacks = tuner.FALLBACKS["flash_attention"] - fb0
    check(all(n == 0 for n in fc.LAUNCHES.values()),
          f"BERT S={seq}: CE kernel launches {fc.LAUNCHES}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per = 12 * n_steps if flash else 0
    check(launches == {"flash_fwd": per, "flash_dq": per, "flash_dkv": per},
          f"BERT S={seq}: flash launches {launches}, want {per} each")
    check(all(n == 0 for k, n in routes.items() if k.endswith("_scalar")),
          f"BERT S={seq}: routes {routes}")
    check(fallbacks == (0 if flash else 12 * n_steps),
          f"BERT S={seq}: {fallbacks} flash fallbacks over {n_steps} steps")
    check(all(np.isfinite(losses)), f"BERT S={seq}: losses {losses}")
    check(losses[-1] < losses[0], f"BERT S={seq}: losses did not fall "
          f"{losses[0]} -> {losses[-1]}")
    check(trainer.skipped_steps() == 0, f"BERT S={seq}: a step skipped")
    prof = profile_steps(trainer, batch, _group_text)
    seen = prof["by_group"].get("flash kernels", {}).get("launches_per_step",
                                                          0)
    check(seen == (36 if flash else 0),
          f"BERT S={seq}: the profiler saw {seen} flash launches a step")
    b = ids.shape[0]
    return {"batch": b, "seq": seq, "dtype": "bfloat16", "warmup": warmup,
            "iters": iters, "losses": losses, "samples_per_s": b * iters / dt,
            "ms_per_step": dt / iters * 1e3, "max_memory_allocated_gb": peak,
            "launches": launches, "routes": routes,
            "flash_fallbacks": fallbacks, "profile": prof}


def bert_flash_t4(fa, fc, rs, b=16, h=12, s=512, d=64):
    """(t4) the three flash kernels at BERT's call (bf16, non-causal, q, k,
    v the QKV split's views): held against their plain versions, then
    timed (median of 25, L2 flushed) beside the bound, the plain version
    and SDPA. These launches compare and time; the path's counts are
    t3's."""
    zero_counts(fa, fc)
    errs, route, broute = flash_parity_case(fa, rs, s, d, False, None,
                                            torch.bfloat16, b=b, h=h,
                                            split_qkv=True)
    check(route == "mma" and broute == "mma",
          f"t4: routes {route}/{broute}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fwd = flash_fwd_routes_timing(fa, flush, b, h, s, d, causal=False)
    bwd, whole = flash_bwd_routes_timing(fa, flush, b, h, s, d, causal=False)
    del flush
    timing = {"flash_fwd": fwd, **bwd}
    return {"max_abs_err": errs, "fwd_route": route, "bwd_route": broute,
            "timing": timing, "whole_bwd": whole,
            "comparison_launches": dict(fa.LAUNCHES)}


def text_phase(fa, fc, tuner, optim, engine, framework, rs):
    """``text``: (t1) the BERT golden; (t2) bench.py's ``bert_base_amp``
    (full BERT-base, whole-model bf16, batch 16 x 128, AdamW(1e-4), 8 + 20
    steps): the gate refuses every attention (S < 512), counted as
    fallbacks; (t3) the same model at 16 x 512: 12 launches a step of each
    flash kernel, non-causal, on the mma route; (t4) the flash kernels at
    BERT's shape against their plain versions, timed. Returns t3's launch
    counts as the path's."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.testdata import recipes
    from paddle_tpu_torch.text import models
    mesh_mod.set_mesh(None)
    out = {"t1_golden": bert_golden(optim, engine, mesh_mod, models)}
    torch.cuda.empty_cache()
    framework.seed(0)
    cfg = models.bert_base(vocab_size=30528)      # bench.py's bert_base_amp
    model = models.BertForPretraining(tensor_parallel=False, attn_dropout=0.0,
                                      hidden_dropout=0.0, **cfg)
    model.bfloat16()
    trainer = engine.ParallelTrainer(model, optim.AdamW(1e-4),
                                     _bert_loss(model),
                                     mesh=mesh_mod.build_mesh({"data": 1}))
    check(trainer.param_name_of(model.cls.decoder_weight) ==
          "bert.embeddings.word_embeddings.weight",
          "the tied decoder weight is not the word embedding's")
    n_params = sum(p.numel() for p in trainer.params.values())
    for key, seq, warmup, iters in (("t2_bert_base_amp", 128, 8, 20),
                                    ("t3_seq512", 512, 2, 6)):
        ids, mlm, nsp = (torch.from_numpy(a).cuda() for a in
                         recipes.bert_data(0, 16, seq, cfg["vocab_size"]))
        out[key] = bert_steps(fa, fc, tuner, trainer, (ids, (mlm, nsp)), seq,
                              warmup, iters, flash=seq >= 512)
        out[key]["params"] = n_params
    launches = out["t3_seq512"]["launches"]
    del trainer, model
    torch.cuda.empty_cache()
    out["t4_flash"] = bert_flash_t4(fa, fc, rs)
    zero_counts(fa, fc)
    out["launches"] = {**launches, "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}
    return out


# -- mt: the MT Transformer and the PTB LSTM on the card --------------------------

MT_LOSS_RTOL = BERT_LOSS_RTOL           # step 0, later steps
MT_GRAD_NORM_RTOL = BERT_GRAD_NORM_RTOL
MT_DROP_RTOL = 1e-2     # each later loss's drop from step 0, against the
#                        golden's (the PTB steps move the loss by 3e-4 of
#                        itself, below the 1e-3 bar on the losses)
MT_BEAM_SCORE_TOL = 1e-4
SEQ2SEQ_RTOL = 1e-5
MT_BASE = dict(src_vocab_size=37000, trg_vocab_size=37000, max_length=256,
               num_encoder_layers=6, num_decoder_layers=6, n_head=8,
               d_model=512, d_inner_hid=2048, dropout=0.1,
               weight_sharing=True, bos_id=0, eos_id=1)


def mt_loss(F, logits, label, vocab, eps=0.1, pad=0):
    """Label-smoothed (``eps``) soft-label cross entropy, the mean over the
    target tokens that are not ``pad``: ``tests/torch_mt_golden.py``'s."""
    soft = F.label_smooth(F.one_hot(label, vocab), epsilon=eps)
    ce = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = (label != pad).float()
    return (ce * w).sum() / w.sum()


def _golden_file():
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "mt_golden.json")) as f:
        return json.load(f)


def _hold_golden(what, loss0, gnorm, losses, gold):
    """The golden bars: the step-0 loss and gradient norm (rtol 1e-4), the
    later losses (1e-3) and their drops from step 0 (``MT_DROP_RTOL``)."""
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    g = gold["losses"]
    check(rel(loss0, g[0]) <= MT_LOSS_RTOL[0],
          f"{what}: step-0 loss {loss0} vs golden {g[0]}")
    check(rel(gnorm, gold["step0_grad_norm"]) <= MT_GRAD_NORM_RTOL,
          f"{what}: step-0 grad norm {gnorm} vs {gold['step0_grad_norm']}")
    check(rel(losses[0], g[0]) <= MT_LOSS_RTOL[0],
          f"{what}: train_step 0 loss {losses[0]} vs {g[0]}")
    for i in range(1, len(losses)):
        check(rel(losses[i], g[i]) <= MT_LOSS_RTOL[1],
              f"{what}: loss after {i} updates {losses[i]} vs {g[i]}")
        check(rel(losses[0] - losses[i], g[0] - g[i]) <= MT_DROP_RTOL,
              f"{what}: loss drop after {i} updates "
              f"{losses[0] - losses[i]} vs {g[0] - g[i]}")
    return {"loss0": loss0, "grad_norm": gnorm, "losses": losses,
            "golden_losses": g, "golden_grad_norm": gold["step0_grad_norm"],
            "loss_rel_err": [rel(a, b) for a, b in zip([loss0] + losses,
                                                       g[:1] + g)],
            "grad_norm_rel_err": rel(gnorm, gold["step0_grad_norm"])}


def _golden_train(model, opt, loss_fn, inputs, labels, engine, mesh_mod,
                  device):
    """Step-0 loss and gradient norm, then ``train_step`` per golden loss."""
    model.to(device)
    loss0 = loss_fn(model(inputs), labels)
    grads = torch.autograd.grad(loss0, list(model.parameters()))
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).item()
    loss0 = loss0.item()
    del grads
    trainer = engine.ParallelTrainer(model, opt, loss_fn,
                                     mesh=mesh_mod.build_mesh({"data": 1}),
                                     device=device)
    return loss0, gnorm, trainer


def _pair_input(nn, model):
    """``model`` behind a layer taking ``(src, trg)`` as one input, as the
    trainer hands its model one input."""
    class Wrap(nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, batch):
            return self.m(*batch)
    return Wrap(model)


def mt_golden(optim, engine, mesh_mod, models, nn, device="cuda"):
    """(m1) ``TransformerModel`` at Transformer-base widths and vocabulary,
    depth 2 + 2, float32 (TF32 off), dropout 0, batch 2 x 32, against
    ``mt_golden.json``: the step-0 loss and gradient norm, three AdamW
    ``train_step``s, then ``InferTransformerModel`` (beam 4, 16 steps) at
    the trained weights: ids equal to the golden's, scores within
    ``MT_BEAM_SCORE_TOL``; each step's smallest top-candidate gap
    printed (a near tie, where two implementations may part, is told from
    a fault by it)."""
    from paddle_tpu_torch.testdata import recipes
    gold = _golden_file()["mt"]
    cfg = {k: v for k, v in gold["config"].items()
           if k not in ("dtype", "batch", "seq", "min_len")}
    check(gold["config"]["dtype"] == "float32" and cfg["d_model"] == 512 and
          cfg["trg_vocab_size"] == 37000, f"golden config {gold['config']}")
    model = models.TransformerModel(**cfg)
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port state names/shapes differ from the MT golden")
    rw = gold["recipe"]["weights"]
    model.set_state_dict_from_numpy(recipes.bert_weights(
        names_shapes, rw["seed"], rw["std"]))
    c = gold["config"]
    src, trg, lbl = (torch.from_numpy(a).to(device) for a in recipes.mt_data(
        gold["recipe"]["data"]["seed"], c["batch"], c["seq"],
        cfg["src_vocab_size"], c["min_len"]))
    vocab = cfg["trg_vocab_size"]

    def loss_fn(out, y):
        return mt_loss(nn.functional, out, y, vocab)

    o = gold["optimizer"]
    opt = optim.AdamW(o["learning_rate"], beta1=o["beta1"], beta2=o["beta2"],
                      epsilon=o["epsilon"])
    loss0, gnorm, trainer = _golden_train(_pair_input(nn, model), opt, loss_fn, (src, trg),
                                          lbl, engine, mesh_mod, device)
    losses = [trainer.train_step((src, trg), lbl).item()
              for _ in gold["losses"]]
    check(trainer.skipped_steps() == 0, "m1: a step skipped")
    trainer.sync_to_model()
    out = _hold_golden("m1", loss0, gnorm, losses, gold)
    beam = gold["beam"]
    infer = models.InferTransformerModel(
        **cfg, beam_size=beam["beam_size"], max_out_len=beam["max_out_len"],
        alpha=beam["alpha"]).to(device)
    infer.set_state_dict(model.state_dict(True))
    infer.eval()
    with torch.no_grad():
        ids, scores = infer(src)
    margins = infer.last_margins.tolist()
    score_err = float(np.abs(scores.cpu().numpy() -
                             np.asarray(beam["scores"])).max())
    out["beam"] = {"ids_equal": ids.tolist() == beam["ids"],
                   "max_score_abs_err": score_err,
                   "step_min_margins": margins, "min_margin": min(margins)}
    print(f"m1 beam step margins {margins}", flush=True)
    check(ids.tolist() == beam["ids"], f"m1: beam ids {ids.tolist()} vs "
          f"golden {beam['ids']} (smallest step margin {min(margins)})")
    check(score_err <= MT_BEAM_SCORE_TOL, f"m1: beam scores off by "
          f"{score_err}")
    return out


def ptb_golden(optim, engine, mesh_mod, nn, port, device="cuda"):
    """(m5) the medium PTB LM at full width, float32, against
    ``mt_golden.json``'s ``ptb``: the step-0 loss and gradient norm, three
    ``SGD(1.0)`` steps under ``ClipGradByGlobalNorm(5.0)``."""
    from paddle_tpu_torch.testdata import recipes
    gold = _golden_file()["ptb"]
    c = gold["config"]
    check(c["dtype"] == "float32" and c["hidden"] == 650 and
          c["vocab"] == 10000, f"golden config {c}")
    model = recipes.ptb_lm(port, c["vocab"], c["hidden"], c["layers"])
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    check([[n, list(s)] for n, s in names_shapes] == gold["names_shapes"],
          "port state names/shapes differ from the PTB golden")
    rw = gold["recipe"]["weights"]
    model.set_state_dict_from_numpy(recipes.ptb_weights(
        names_shapes, rw["seed"], rw["scale"]))
    ids, nxt = (torch.from_numpy(a).to(device) for a in recipes.ptb_data(
        gold["recipe"]["data"]["seed"], c["batch"], c["steps"], c["vocab"]))
    o = gold["optimizer"]
    opt = optim.SGD(o["learning_rate"], grad_clip=nn.ClipGradByGlobalNorm(
        o["clip_global_norm"]))
    loss0, gnorm, trainer = _golden_train(model, opt, _ptb_loss(nn), ids,
                                          nxt, engine, mesh_mod, device)
    losses = [trainer.train_step(ids, nxt).item() for _ in gold["losses"]]
    check(trainer.skipped_steps() == 0, "m5: a step skipped")
    return _hold_golden("m5", loss0, gnorm, losses, gold)


def _ptb_loss(nn):
    def loss(logits, y):
        return nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
    return loss


def _group_mt(name):
    low = name.lower()
    if "flash_" in low:
        return "flash kernels"
    if "gemm" in low or low.startswith("nvjet") or "cutlass" in low:
        return "GEMMs"
    if "softmax" in low:
        return "softmax (attention, loss)"
    if "layer_norm" in low or "layernorm" in low:
        return "LayerNorm"
    if "reduce" in low:
        return "reductions"
    return "elementwise and the rest"


def mt_train_m2(fa, fc, tuner, optim, engine, mesh_mod, models, nn,
                framework, batch=192, seq=128, warmup=2, iters=8):
    """(m2) Transformer-base (6 + 6, d 512, 8 heads, d_ff 2048, dropout
    0.1, vocabulary 37,000, shared weights) in bf16 (``model.bfloat16()``,
    as GPT's bench path casts), ``ParallelTrainer``, AdamW(1e-4, beta2
    0.98, epsilon 1e-9), the label-smoothed loss; batch 192 x 128 source
    and target tokens, lengths 16-128 by seed, pad 0. Every attention
    has a dense mask: 0 flash launches, 18 fallbacks a forward."""
    from paddle_tpu_torch.testdata import recipes
    framework.seed(0)
    model = models.TransformerModel(**MT_BASE)
    model.bfloat16()
    n_params = sum(p.numel() for p in model.parameters())
    src, trg, lbl = (torch.from_numpy(a).cuda() for a in recipes.mt_data(
        2, batch, seq, MT_BASE["trg_vocab_size"], 16))
    vocab = MT_BASE["trg_vocab_size"]
    trainer = engine.ParallelTrainer(
        _pair_input(nn, model), optim.AdamW(1e-4, beta1=0.9, beta2=0.98,
                                            epsilon=1e-9),
        lambda out, y: mt_loss(nn.functional, out, y, vocab),
        mesh=mesh_mod.build_mesh({"data": 1}))
    n_steps = warmup + iters
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, fc)
    fb0 = tuner.FALLBACKS["flash_attention"]
    losses = [trainer.train_step((src, trg), lbl).item()
              for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step((src, trg), lbl) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    launches = dict(fa.LAUNCHES)
    fallbacks = tuner.FALLBACKS["flash_attention"] - fb0
    check(all(n == 0 for n in launches.values()) and
          all(n == 0 for n in fc.LAUNCHES.values()),
          f"m2: kernel launches {launches} {fc.LAUNCHES}")
    check(fallbacks == 18 * n_steps,
          f"m2: {fallbacks} flash fallbacks over {n_steps} steps, want "
          f"{18 * n_steps}")
    check(all(np.isfinite(losses)), f"m2: losses {losses}")
    check(losses[-1] < losses[0], f"m2: losses did not fall {losses}")
    check(trainer.skipped_steps() == 0, "m2: a step skipped")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_steps(trainer, ((src, trg), lbl), _group_mt)
    tokens = int((lbl != 0).sum())
    trainer.sync_to_model()
    rep = {"params": n_params, "batch": batch, "seq": seq,
           "dtype": "bfloat16", "warmup": warmup, "iters": iters,
           "losses": losses, "ms_per_step": dt / iters * 1e3,
           "target_tokens_per_step": tokens,
           "target_tokens_per_s": tokens * iters / dt,
           "max_memory_allocated_gb": peak, "flash_launches": launches,
           "flash_fallbacks": fallbacks,
           "fallbacks_per_forward": fallbacks / n_steps, "profile": prof}
    del trainer
    torch.cuda.empty_cache()
    return rep, model


def mt_beam_m3(models, model, rs_seed=3, n=16, src_len=64):
    """(m3) ``InferTransformerModel`` (beam 4, ``max_out_len`` 64, alpha
    0.6, the reference's defaults) at (m2)'s weights, bf16, eval, on 16
    sources of 64 tokens."""
    infer = models.InferTransformerModel(**MT_BASE)
    infer.set_state_dict(model.state_dict(True))
    infer.bfloat16().cuda().eval()
    rs = np.random.RandomState(rs_seed)
    src = torch.from_numpy(rs.randint(2, MT_BASE["src_vocab_size"],
                                      (n, src_len)).astype(np.int32)).cuda()
    with torch.no_grad():
        ids, scores = infer(src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, scores = infer(src)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    check(tuple(ids.shape) == (n, infer.beam_size, infer.max_out_len),
          f"m3: ids {tuple(ids.shape)}")
    check(bool(torch.isfinite(scores).all()) and
          bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"m3: scores not finite and sorted: {scores.tolist()}")
    steps = infer.max_out_len
    return {"sources": n, "src_len": src_len, "beam": infer.beam_size,
            "max_out_len": steps, "ms_per_call": dt * 1e3,
            "generated_tokens_per_s": n * steps / dt,
            "beam_row_tokens_per_s": n * infer.beam_size * steps / dt,
            "min_step_margin": infer.last_margins.min().item()}


def mt_copy_task(optim, models, framework, device="cuda"):
    """(m3) the reference test's copy task (``tests/test_transformer_mt.py``,
    its sizes: V 20, 1 + 1 layers, 2 heads, d 32, d_ff 64, L 6, batch 64):
    150 Adam(2e-3) steps of the eager loop, then beam 3 over 6 steps on 4
    sources: the best beam reproduces more than 90% of the tokens and the
    scores are sorted."""
    V, L = 20, 6
    kw = dict(max_length=32, num_encoder_layers=1, num_decoder_layers=1,
              n_head=2, d_model=32, d_inner_hid=64, dropout=0.0, bos_id=0,
              eos_id=1)
    framework.seed(0)
    m = models.TransformerModel(V, V, **kw).to(device)
    m.eval()
    rs = np.random.RandomState(1)

    def batch(n=64):
        body = rs.randint(2, V, (n, L)).astype(np.int32)
        trg_in = np.concatenate([np.zeros((n, 1), np.int32), body[:, :-1]],
                                1)
        return [torch.from_numpy(a).to(device) for a in (body, trg_in, body)]

    from paddle_tpu_torch import nn
    opt = optim.Adam(2e-3, parameters=m.parameters())
    t0 = time.perf_counter()
    losses = []
    for _ in range(150):
        src, trg_in, lbl = batch()
        loss = nn.functional.cross_entropy(m(src, trg_in), lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    losses = [x.item() for x in losses]
    train_s = time.perf_counter() - t0
    check(losses[-1] < 0.3, f"copy task: loss {losses[0]} -> {losses[-1]}")
    infer = models.InferTransformerModel(V, V, beam_size=3, max_out_len=L,
                                         **kw).to(device)
    infer.set_state_dict(m.state_dict(True))
    infer.eval()
    src, _, body = batch(4)
    with torch.no_grad():
        ids, scores = infer(src)
    acc = (ids[:, 0, :L] == body).float().mean().item()
    check(acc > 0.9, f"copy task: best beam reproduces {acc} of the tokens")
    check(bool((scores[:, 1:] - scores[:, :-1] <= 1e-5).all()),
          f"copy task: scores not sorted {scores.tolist()}")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "train_s": train_s, "token_accuracy": acc}


M4_ROUTE_RATIO = 1.1     # the flash route's gradient error over the plain
#                          bf16 route's, both against the float32 stack


def _relnorm(a, ref):
    return ((a.float() - ref.float()).norm() / ref.float().norm()).item()


def mt_flash_m4(fa, fc, tuner, nn, framework, b=8, s=1024, layers=6):
    """(m4) ``MultiHeadAttention`` on the flash kernels: a
    ``TransformerEncoder`` of (m2)'s widths (6 layers, 8 heads, D 64,
    dropout 0), no mask, B 8 x S 1024, bf16, forward and backward: 6
    launches a step of each flash kernel on the mma route, 0 fallbacks.
    The output within ``FLASH_TOL[bf16]`` of the same bf16 stack forced
    onto the plain route (an all-zero additive mask). The gradients (of
    the input and of the first layer's query weight) are held against the
    float32 stack on the plain route: six layers of bf16 rounding put
    either bf16 route about 5% (in norm) off float32 and some 4% off the
    other, element by element far outside ``FLASH_TOL``, so the bar is
    that the flash route is no further from float32 than the plain bf16
    route, within ``M4_ROUTE_RATIO``."""
    import copy
    framework.seed(0)
    enc32 = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        512, 8, 2048, dropout=0.0), layers).cuda()
    enc = copy.deepcopy(enc32).bfloat16()
    rs = np.random.RandomState(4)
    x0 = torch.from_numpy(rs.randn(b, s, 512).astype(np.float32)).cuda()
    w = torch.from_numpy(rs.randn(b, s, 512).astype(np.float32)).cuda()
    zero_mask = torch.zeros((b, 1, 1, s), device="cuda")

    def step(stack, mask, dtype=torch.bfloat16):
        x = x0.to(dtype).requires_grad_()
        out = stack(x, mask)
        gx, gw = torch.autograd.grad(
            (out.float() * w).sum(),
            (x, stack.layers[0].self_attn.q_proj.weight))
        return out, gx, gw

    zero_counts(fa, fc)
    fb0 = tuner.FALLBACKS["flash_attention"]
    flash = step(enc, None)
    torch.cuda.synchronize()
    fallbacks = tuner.FALLBACKS["flash_attention"] - fb0
    launches = check_path(fa, fc, "m4", layers, layers, 0)
    check(fallbacks == 0, f"m4: {fallbacks} flash fallbacks")
    plain = step(enc, zero_mask)
    ref32 = step(enc32, zero_mask, torch.float32)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    gap = (flash[0].float() - plain[0].float()).abs().max().item()
    check(torch.allclose(flash[0].float(), plain[0].float(), rtol=rtol,
                         atol=atol), f"m4: output off the plain route by "
          f"{gap}")
    errs = {"out_max_abs_vs_plain": gap}
    for name, f, p, r in zip(("out", "grad_x", "grad_wq"), flash, plain,
                             ref32):
        fe, pe = _relnorm(f, r), _relnorm(p, r)
        errs[name] = {"flash_vs_f32": fe, "plain_vs_f32": pe,
                      "flash_vs_plain": _relnorm(f, p)}
        check(fe <= M4_ROUTE_RATIO * pe,
              f"m4: {name} {fe} off float32 against the plain route's {pe}")
    del ref32, enc32
    ms = time_ms(lambda: step(enc, None), reps=5, warmup=1)
    plain_ms = time_ms(lambda: step(enc, zero_mask), reps=5, warmup=1)
    zero_counts(fa, fc)
    return {"batch": b, "seq": s, "layers": layers, "heads": 8,
            "head_dim": 64, "dtype": "bfloat16", "launches": launches,
            "fallbacks": fallbacks, "errors": errs, "tol": [rtol, atol],
            "route_ratio": M4_ROUTE_RATIO, "fwd_bwd_ms": ms,
            "plain_route_fwd_bwd_ms": plain_ms}


def ptb_m5(fa, fc, optim, engine, mesh_mod, nn, port, jit, framework,
           warmup=2, iters=8):
    """(m5) the PTB LM medium: the golden; then bf16 (dropout 0.5 between
    the layers, as Zaremba's medium regularizes), SGD(1.0) under
    ``ClipGradByGlobalNorm(5.0)``, batch 20 x 35: ms a step, words/s and
    kernels a step; then one SGD step of the dy2static tier's ``Seq2Seq``
    (hidden 512, vocabulary 10,000, f32) through ``to_static`` against its
    eager step, within ``SEQ2SEQ_RTOL``."""
    from paddle_tpu_torch.testdata import recipes
    out = {"golden": ptb_golden(optim, engine, mesh_mod, nn, port)}
    torch.cuda.empty_cache()
    framework.seed(0)
    model = recipes.ptb_lm(port, 10000, 650, 2, dropout=0.5)
    model.bfloat16()
    ids, nxt = (torch.from_numpy(a).cuda() for a in recipes.ptb_data(
        3, 20, 35, 10000))
    trainer = engine.ParallelTrainer(
        model, optim.SGD(1.0, grad_clip=nn.ClipGradByGlobalNorm(5.0)),
        _ptb_loss(nn), mesh=mesh_mod.build_mesh({"data": 1}))
    zero_counts(fa, fc)
    losses = [trainer.train_step(ids, nxt).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step(ids, nxt) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    check(all(n == 0 for n in {**fa.LAUNCHES, **fc.LAUNCHES}.values()),
          "m5: a flash or CE kernel launched")
    check(all(np.isfinite(losses)), f"m5: losses {losses}")
    check(trainer.skipped_steps() == 0, "m5: a step skipped")
    prof = profile_steps(trainer, (ids, nxt), _group_mt)
    out["bf16"] = {"batch": 20, "steps": 35, "losses": losses,
                   "ms_per_step": dt / iters * 1e3,
                   "words_per_s": 20 * 35 * iters / dt,
                   "kernels_per_step": sum(
                       g["launches_per_step"]
                       for g in prof["by_group"].values()),
                   "profile": prof}
    del trainer, model
    torch.cuda.empty_cache()
    # the seq2seq case: the staged step against the eager one
    rs = np.random.RandomState(8)
    src, trg, lbl = (torch.from_numpy(rs.randint(2, 10000, (8, n)).astype(
        np.int32)).cuda() for n in (24, 20, 20))
    framework.seed(0)
    pair = [recipes.seq2seq(port, 10000, 512).cuda() for _ in range(2)]
    pair[1].set_state_dict(pair[0].state_dict(True))
    staged = jit.to_static(pair[1])
    rows = []
    for m, call in ((pair[0], pair[0]), (pair[1], staged)):
        opt = optim.SGD(0.05, parameters=m.parameters())
        logits = call(src, trg)
        loss = nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), lbl.reshape(-1))
        loss.backward()
        opt.step()
        after = nn.functional.cross_entropy(
            m(src, trg).reshape(-1, 10000), lbl.reshape(-1))
        rows.append((loss.item(), after.item(),
                     m.head.weight.detach().clone()))
    rel = [abs(a - b) / abs(b) for a, b in zip(rows[1][:2], rows[0][:2])]
    wgap = (rows[1][2] - rows[0][2]).abs().max().item()
    check(all(r <= SEQ2SEQ_RTOL for r in rel) and
          torch.allclose(rows[1][2], rows[0][2], rtol=SEQ2SEQ_RTOL,
                         atol=1e-7),
          f"m5 seq2seq: staged {rows[1][:2]} vs eager {rows[0][:2]}, "
          f"weights {wgap}")
    out["seq2seq"] = {"hidden": 512, "vocab": 10000, "eager_losses":
                      rows[0][:2], "staged_losses": rows[1][:2],
                      "loss_rel_gap": rel, "head_weight_max_abs_gap": wgap}
    return out


def mt_phase(fa, fc, tuner, optim, engine, framework, card):
    """``mt``: (m1) the MT golden, (m2) Transformer-base training, (m3)
    beam search at (m2)'s weights and the copy task, (m4)
    ``MultiHeadAttention`` on the flash kernels, (m5) the PTB LM medium and
    the seq2seq step through ``to_static``. Returns (m4)'s launch counts
    as the path's (the only kernels the phase launches)."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.text import models
    mesh_mod.set_mesh(None)
    out = {"card": card}
    t0 = time.perf_counter()
    out["m1_golden"] = mt_golden(optim, engine, mesh_mod, models, nn)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["m2_train"], model = mt_train_m2(fa, fc, tuner, optim, engine,
                                         mesh_mod, models, nn, framework)
    t2 = time.perf_counter()
    out["m3_beam"] = mt_beam_m3(models, model)
    del model
    torch.cuda.empty_cache()
    out["m3_copy_task"] = mt_copy_task(optim, models, framework)
    t3 = time.perf_counter()
    out["m4_flash"] = mt_flash_m4(fa, fc, tuner, nn, framework)
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    out["m5_ptb"] = ptb_m5(fa, fc, optim, engine, mesh_mod, nn, port, jit,
                           framework)
    torch.cuda.empty_cache()
    out["part_seconds"] = {"m1": t1 - t0, "m2": t2 - t1, "m3": t3 - t2,
                           "m4": t4 - t3, "m5": time.perf_counter() - t4}
    out["launches"] = {**out["m4_flash"]["launches"], "ce_fwd": 0,
                       "ce_dh": 0, "ce_dw": 0}
    zero_counts(fa, fc)
    return out


# -- rec: Wide&Deep, DeepFM's tiers, the parameter server ------------------------

CTR_FIELDS = [100_000] * 26
CTR_BATCH = 4096
CTR_HIDDEN = (400, 400, 400)


def _ctr_bce(logit, y):
    return (logit.clamp(min=0) - logit * y
            + torch.log1p(torch.exp(-logit.abs()))).mean()


def widedeep_r1(optim, engine, mesh_mod, rec, framework, warmup=8,
                iters=20):
    """(r1) bench.py's ``widedeep_ctr``: WideDeep over 26 x 100,000
    fields (dense ``nn.Embedding``), 13 dense features, hidden 400-400-400,
    Adam(1e-3), batch 4096, one fixed batch from RandomState(0)."""
    framework.seed(0)
    mesh_mod.set_mesh(None)
    model = rec.WideDeep(CTR_FIELDS, dense_dim=13, embedding_dim=16,
                         hidden_sizes=CTR_HIDDEN)
    trainer = engine.ParallelTrainer(model, optim.Adam(1e-3), _ctr_bce,
                                     mesh=mesh_mod.build_mesh({"data": 1}))
    rng = np.random.RandomState(0)
    ids = np.stack([rng.randint(0, d, CTR_BATCH) for d in CTR_FIELDS], 1)
    dense = rng.randn(CTR_BATCH, 13).astype(np.float32)
    label = rng.randint(0, 2, CTR_BATCH).astype(np.float32)
    inputs = (torch.from_numpy(ids.astype(np.int64)).cuda(),
              torch.from_numpy(dense).cuda())
    y = torch.from_numpy(label).cuda()
    losses = [trainer.train_step(inputs, y).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [trainer.train_step(inputs, y) for _ in range(iters)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [x.item() for x in timed]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"r1 losses {losses}")
    prof = profile_steps(trainer, (inputs, y), _group_text)
    return {"batch": CTR_BATCH, "fields": len(CTR_FIELDS),
            "samples_per_s": CTR_BATCH * iters / dt,
            "ms_per_step": dt / iters * 1e3, "final_loss": losses[-1],
            "losses": losses, "profile": prof}


def _heter_state(model, trainer):
    emb = model.ctr_table
    name = emb._pname
    return ([trainer.get_param(name).clone()] +
            [trainer.get_opt_slot(name, sn).clone()
             for sn in trainer.opt_slot_names(name)])


def heter_r2(optim, engine, mesh_mod, rec, framework, warmup=4, steps=12,
             cap=1_000_000):
    """(r2) bench.py's ``heter_ctr``: WideDeep over 26 x 100,000 fields
    with zipf(1.3) ids, batch 4096, Adagrad(0.05, eps 1e-8), the host table
    path (``sparse=True``: ``host_ps``) and the hot tier of capacity
    1,000,000 with ``prepare_batch_async`` one batch ahead
    (``heter_overlapped``), 4 + 12 steps each; then the hot tier again
    with ``prepare_batch`` between the steps, held bit for bit against the
    overlapped run (losses, the hot rows, their accumulators, the tier's
    decisions)."""
    rng = np.random.RandomState(0)

    def draw_ids():
        u = rng.zipf(1.3, size=(CTR_BATCH, len(CTR_FIELDS)))
        return (u % np.asarray(CTR_FIELDS)[None, :]).astype(np.int64)

    batches = [(draw_ids(), rng.randn(CTR_BATCH, 13).astype(np.float32),
                rng.randint(0, 2, CTR_BATCH).astype(np.float32))
               for _ in range(steps + warmup)]
    out, runs = {}, {}
    for name, mode in (("host_ps", True), ("heter_overlapped", "heter"),
                       ("heter_serial", "heter")):
        framework.seed(0)
        mesh_mod.set_mesh(None)
        model = rec.WideDeep(CTR_FIELDS, dense_dim=13, embedding_dim=16,
                             hidden_sizes=CTR_HIDDEN, sparse=mode,
                             heter_capacity=cap)
        tr = engine.ParallelTrainer(model, optim.Adagrad(0.05, epsilon=1e-8),
                                    _ctr_bce,
                                    mesh=mesh_mod.build_mesh({"data": 1}))

        def run(bs):
            losses = []
            if name == "host_ps":
                for ids, dense, y in bs:
                    losses.append(tr.train_step((ids, dense), y))
            elif name == "heter_serial":
                for ids, dense, y in bs:
                    losses.append(tr.train_step(
                        (model.prepare_batch(ids), dense), y))
            else:
                fut = model.prepare_batch_async(bs[0][0])
                for i, (ids, dense, y) in enumerate(bs):
                    slots = fut.result()
                    losses.append(tr.train_step((slots, dense), y))
                    if i + 1 < len(bs):
                        fut = model.prepare_batch_async(bs[i + 1][0])
            return [float(x) for x in losses]

        losses = run(batches[:warmup])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += run(batches[warmup:])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(all(np.isfinite(losses)), f"r2 {name} losses {losses}")
        emit(phase="rec_part", part=f"r2_{name}", seconds=dt,
             ms_per_step=dt / steps * 1e3)
        row = {"samples_per_s": CTR_BATCH * steps / dt,
               "ms_per_step": dt / steps * 1e3, "losses": losses}
        if mode == "heter":
            st = model.ctr_table.stats
            row.update(hot_hit_rate=model.ctr_table.hit_rate,
                       stats=dict(st))
            runs[name] = (losses, _heter_state(model, tr),
                          model.ctr_table._slot2key.copy(), dict(st))
        else:
            row["table_rows"] = len(model.embedding.table)
        out[name] = row
        del model, tr
        torch.cuda.empty_cache()
    (ol, os_, ok, ost), (sl, ss, sk, sst) = (runs["heter_overlapped"],
                                            runs["heter_serial"])
    check(ol == sl, f"r2: overlapped losses {ol} != serial {sl}")
    check(all(torch.equal(a, b) for a, b in zip(os_, ss)),
          "r2: overlapped hot rows or accumulators != serial, bit for bit")
    check(np.array_equal(ok, sk) and all(
        ost[k] == sst[k] for k in ("lookups", "hits", "misses", "evicts")),
        "r2: the tier's decisions differ between overlapped and serial")
    out["overlapped_equals_serial"] = True
    out["hot_hit_rate"] = out["heter_overlapped"]["hot_hit_rate"]
    out["speedup_x"] = (out["heter_overlapped"]["samples_per_s"] /
                        out["host_ps"]["samples_per_s"])
    return out


# the child process of r3: two Adagrad tables (dims 16 and 1, the
# DistributedEmbedding's defaults), the first on its entry of
# PADDLE_PSERVER_ENDPOINTS through fleet.init_server, the second on a free
# port; serves through run_server until a stop file appears
PS_SERVER_CHILD = r'''
import faulthandler, os, sys, threading, time
faulthandler.dump_traceback_later(60)      # where a slow start stands
from paddle_tpu_torch.distributed import fleet
rdv = sys.argv[1]
served = []
for i, dim in enumerate((16, 1)):
    f = fleet.Fleet()
    assert f.is_server()
    srv = f.init_server(dim=dim, optimizer="adagrad",
                        port=None if i == 0 else 0, seed=0, init_range=0.01)
    served.append((f, srv))
with open(os.path.join(rdv, ".ep"), "w") as fh:
    fh.write("\n".join(s.endpoint for _, s in served))
os.replace(os.path.join(rdv, ".ep"), os.path.join(rdv, "ep"))
faulthandler.cancel_dump_traceback_later()
threads = [threading.Thread(target=f.run_server) for f, _ in served]
for t in threads:
    t.start()
deadline = time.time() + 300
while not os.path.exists(os.path.join(rdv, "stop")) and \
        time.time() < deadline:
    time.sleep(0.02)
for f, _ in served:
    f.stop_server()
for t in threads:
    t.join(timeout=30)
print("ps server stopped", flush=True)
'''


class _Recorded:
    """A table view that records every pull and push, in order."""

    def __init__(self, table):
        self.table, self.log = table, []
        self.dim = table.dim

    def pull(self, keys, create_missing=True):
        self.log.append(("pull", np.array(keys, np.int64), create_missing))
        return self.table.pull(keys, create_missing)

    def push(self, keys, grads, lr):
        self.log.append(("push", np.array(keys, np.int64),
                         np.array(grads, np.float32), float(lr)))
        self.table.push(keys, grads, lr)


def ps_service_r3(optim, engine, mesh_mod, rec, framework, steps=3,
                  batch=512):
    """(r3) the parameter server on the card's host: a server process
    through ``fleet.init_server``/``run_server`` on 127.0.0.1
    (``TRAINING_ROLE=PSERVER``, ``PADDLE_PSERVER_ENDPOINTS``,
    ``PADDLE_PSERVER_ID``), this process a worker through ``init_worker``;
    ``WideDeep(sparse=True)`` (26 x 100,000 fields) takes ``steps`` steps on
    the card over the served tables. The rows read back over RPC equal a
    local ``SparseTable`` given the same pulls and pushes, bit for bit;
    ``stop_worker``/``stop_server`` end cleanly."""
    import socket
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.ps import (DistributedEmbedding,
                                                 DistributedSparseTable,
                                                 SparseTable)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    endpoint = f"127.0.0.1:{port}"
    rdv = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    env = dict(os.environ, TRAINING_ROLE="PSERVER",
               PADDLE_PSERVER_ENDPOINTS=endpoint, PADDLE_PSERVER_ID="0",
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", PS_SERVER_CHILD, rdv],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        while not os.path.exists(os.path.join(rdv, "ep")):
            if child.poll() is not None or time.perf_counter() - t0 > 120:
                child.kill()
                log, _ = child.communicate()
                raise AssertionError(
                    f"r3: no PS server after {time.perf_counter() - t0:.1f}"
                    f" s (exit {child.returncode}): {log[-3000:]}")
            time.sleep(0.05)
        with open(os.path.join(rdv, "ep")) as f:
            ep16, ep1 = f.read().split("\n")
        check(ep16 == endpoint, f"r3: served on {ep16}, not {endpoint}")
        startup = time.perf_counter() - t0
        old = {k: os.environ.get(k) for k in ("TRAINING_ROLE",
                                               "PADDLE_PSERVER_ENDPOINTS")}
        os.environ.update(TRAINING_ROLE="TRAINER",
                          PADDLE_PSERVER_ENDPOINTS=ep16)
        worker = fleet.Fleet()
        try:
            check(not worker.is_server() and worker.server_num() == 1,
                  "r3: the worker's role")
            t16 = worker.init_worker()
            t1 = DistributedSparseTable([ep1])
            framework.seed(0)
            mesh_mod.set_mesh(None)
            model = rec.WideDeep(CTR_FIELDS, dense_dim=13, embedding_dim=16,
                                 hidden_sizes=CTR_HIDDEN, sparse=True)
            rec16, rec1 = _Recorded(t16), _Recorded(t1)
            model.embedding = DistributedEmbedding(16, lr=0.05, table=rec16)
            model.linear_emb = DistributedEmbedding(1, lr=0.05, table=rec1)
            tr = engine.ParallelTrainer(model, optim.Adam(1e-3), _ctr_bce,
                                        mesh=mesh_mod.build_mesh({"data": 1}))
            rng = np.random.RandomState(1)
            ms, losses = [], []
            for _ in range(steps):
                ids = np.stack([rng.randint(0, d, batch)
                                for d in CTR_FIELDS], 1).astype(np.int64)
                ids[rng.rand(batch, len(CTR_FIELDS)) < 0.05] = -1
                dense = rng.randn(batch, 13).astype(np.float32)
                y = rng.randint(0, 2, batch).astype(np.float32)
                s0 = time.perf_counter()
                losses.append(tr.train_step(
                    (torch.from_numpy(ids).cuda(),
                     torch.from_numpy(dense).cuda()),
                    torch.from_numpy(y).cuda()).item())
                ms.append((time.perf_counter() - s0) * 1e3)
            check(all(np.isfinite(losses)), f"r3 losses {losses}")
            rows = {}
            for dim, rtab in ((16, rec16), (1, rec1)):
                local = SparseTable(dim, "adagrad", seed=0, init_range=0.01)
                for entry in rtab.log:
                    if entry[0] == "pull":
                        local.pull(entry[1], entry[2])
                    else:
                        local.push(entry[1], entry[2], entry[3])
                keys = np.unique(np.concatenate(
                    [e[1] for e in rtab.log if e[0] == "pull"]))
                got = rtab.table.pull(keys, create_missing=False)
                check(np.array_equal(got, local.pull(keys, False)),
                      f"r3: dim-{dim} rows over RPC != the local table's")
                check(len(local) == keys.size and
                      sum(rtab.table.shard_sizes()) == keys.size,
                      f"r3: dim-{dim} row counts")
                rows[dim] = {"rows": int(keys.size),
                             "pushes": sum(e[0] == "push" for e in rtab.log)}
            t1.close()
            worker.stop_worker()
            check(worker._ps_client is None, "r3: stop_worker kept a client")
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    finally:
        open(os.path.join(rdv, "stop"), "w").close()
        try:
            log, _ = child.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate()
            raise
    check(child.returncode == 0 and "ps server stopped" in log,
          f"r3: the server process ended {child.returncode}: {log[-2000:]}")
    return {"endpoint": endpoint, "server_startup_s": startup,
            "batch": batch, "steps": steps, "losses": losses,
            "ms_per_step": ms, "tables": rows, "rows_equal_local": True,
            "server_exit": child.returncode}


def rec_phase(fa, fc, optim, engine, framework):
    """``rec``: (r1) ``widedeep_ctr``, (r2) ``heter_ctr`` with the
    overlapped hot tier held bit for bit against the serial one, (r3) the
    PS service through the fleet lifecycle. No kernel of the port runs on
    these paths (the reference's have no Pallas kernel): the counts stay
    0."""
    from paddle_tpu_torch import rec
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    zero_counts(fa, fc)
    out = {}
    for key, part in (("r1_widedeep_ctr", widedeep_r1),
                      ("r2_heter_ctr", heter_r2),
                      ("r3_ps_service", ps_service_r3)):
        t0 = time.perf_counter()
        out[key] = part(optim, engine, mesh_mod, rec, framework)
        out[key]["seconds"] = time.perf_counter() - t0
        emit(phase="rec_part", part=key, seconds=out[key]["seconds"])
        torch.cuda.empty_cache()
    out["launches"] = check_path(fa, fc, "rec", 0, 0, 0)
    return out


# -- onnx and the small modules --------------------------------------------------

ONNX_R50_TOL = 1e-4     # rtol; atol 1e-4 of the largest element (float32)
ONNX_GPT_TOL = 1e-4     # the same; the flash kernel against its subgraph
# (i2): losses and norms against the reference's golden, float32
INCUBATE_LOSS_RTOL = 1e-5
INCUBATE_NORM_RTOL = 1e-4
# (i3): moments of 10^6 draws within this many standard errors
DIST_SIGMAS = 5.0
DIST_DRAWS = 10 ** 6
# (i4): the masked softmax against its float64 value
MASKED_SOFTMAX_ATOL = {"float32": 2e-6, "bfloat16": 2 ** -7}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want)))
    return err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def _onnx_eval_check(onnx_eval, path, inputs, want, tol, what):
    """The file evaluated on the card against ``want``; returns the
    largest absolute error and the largest element."""
    model = onnx_eval.load(path)
    got = onnx_eval.run(model, inputs, device="cuda")[0]
    ok, err = _rel_close(got.float().cpu().numpy(),
                         want.float().cpu().numpy(), tol)
    big = float(want.abs().max())
    check(ok, f"{what}: the ONNX file's output is {err} from the eager "
          f"forward's (bar {tol} of {big})")
    return model, err, big


def onnx_phase(fa, fc, nn, gpt, framework, work, card):
    """``onnx``: (x1) ResNet-50 in float32 exported with a dynamic batch,
    53 ``Conv`` nodes, evaluated at batch 4 on the card against the eager
    forward; (x2) the GPT-base trunk in float32 at S 1024: the eager
    forward runs the flash forward 12 times, the ONNX graph maps the
    flash node to its plain subgraph and holds no custom op, its
    evaluation on the card matches the forward; (x3) a layer calling
    ``torch.sort`` warns and falls back to the ``jit.save`` artifact,
    which ``jit.load`` runs on the card."""
    import warnings

    from paddle_tpu_torch import jit, onnx
    from paddle_tpu_torch.testdata import onnx_eval
    from paddle_tpu_torch.vision.models import resnet50
    rep = {}

    # (x1) ResNet-50
    framework.seed(0)
    model = resnet50().cuda().eval()
    path = os.path.join(work, "r50.onnx")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = onnx.export(model, path, input_spec=[
            jit.InputSpec([None, 3, 224, 224], "float32")])
    seconds = time.perf_counter() - t0
    check(out == path, f"onnx x1: ResNet-50 exported {out}, not {path}")
    x = torch.from_numpy(np.random.RandomState(0).randn(
        4, 3, 224, 224).astype(np.float32)).cuda()
    with torch.no_grad():
        want = model(x)
    m, err, big = _onnx_eval_check(onnx_eval, path, [x], want, ONNX_R50_TOL,
                                   "onnx x1")
    ops = onnx_eval.op_types(m)
    check(ops.count("Conv") == 53, f"onnx x1: {ops.count('Conv')} Conv")
    check(isinstance(m.inputs[0][2][0], str) and
          isinstance(m.outputs[0][2][0], str),
          f"onnx x1: batch not dynamic: {m.inputs} -> {m.outputs}")
    rep["x1"] = {"model": "resnet50", "export_seconds": seconds,
                 "file_bytes": os.path.getsize(path), "nodes": len(ops),
                 "conv_nodes": ops.count("Conv"), "batch": 4,
                 "max_abs_err": err, "max_abs_out": big, "rtol": ONNX_R50_TOL,
                 "inputs": m.inputs, "outputs": m.outputs}
    os.remove(path)
    del model, m, want
    torch.cuda.empty_cache()

    # (x2) the GPT-base trunk, float32, S 1024
    framework.seed(0)
    model = gpt.GPTModel(tensor_parallel=False, vocab_size=50304,
                         hidden_size=768, num_layers=12, num_heads=12,
                         max_position_embeddings=1024, attn_dropout=0.0,
                         hidden_dropout=0.0).cuda().eval()
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 50304, (1, 1024)).astype(np.int32)).cuda()
    zero_counts(fa, fc)
    with torch.no_grad():
        want = model(ids)
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **fc.LAUNCHES}
    check(launches == {"flash_fwd": 12, "flash_dq": 0, "flash_dkv": 0,
                       "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0},
          f"onnx x2: the eager forward launched {launches}")
    check(fa.ROUTES["flash_fwd_scalar"] == 12,
          f"onnx x2: flash routes {fa.ROUTES}")
    path = os.path.join(work, "gpt.onnx")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = onnx.export(model, path, input_spec=[
            jit.InputSpec([1, 1024], "int32")])
    seconds = time.perf_counter() - t0
    check(out == path, f"onnx x2: GPT-base exported {out}, not {path}")
    m, err, big = _onnx_eval_check(onnx_eval, path, [ids], want,
                                   ONNX_GPT_TOL, "onnx x2")
    ops = onnx_eval.op_types(m)
    check(all(op[:1].isupper() and "::" not in op for op in ops),
          f"onnx x2: a custom op in the graph: {sorted(set(ops))}")
    rep["x2"] = {"model": "GPTModel 12 x 768, vocab 50304, S 1024",
                 "export_seconds": seconds,
                 "file_bytes": os.path.getsize(path), "nodes": len(ops),
                 "softmax_nodes": ops.count("Softmax"),
                 "max_abs_err": err, "max_abs_out": big,
                 "rtol": ONNX_GPT_TOL, "launches": launches}
    os.remove(path)
    del model, m, want
    torch.cuda.empty_cache()

    # (x3) the fallback
    class Sorty(nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = nn.Parameter(torch.full((4,), 2.0))

        def forward(self, x):
            return torch.sort(x * self.scale, dim=-1)[0]

    layer = Sorty().cuda()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4)
                         .astype(np.float32)).cuda()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        prefix = onnx.export(layer, os.path.join(work, "srt.onnx"),
                             input_spec=[jit.InputSpec([2, 4], "float32")])
    msgs = [str(w.message) for w in seen]
    check(not prefix.endswith(".onnx") and
          any("ONNX conversion not available" in s for s in msgs),
          f"onnx x3: {prefix}, warnings {msgs}")
    loaded = jit.load(prefix)
    with torch.no_grad():
        got, eager = loaded(x), layer(x)
    check(got.device.type == "cuda" and torch.equal(got, eager),
          "onnx x3: jit.load's output differs from the eager one")
    rep["x3"] = {"prefix_files": sorted(os.path.basename(p) for p in
                                        os.listdir(work)
                                        if p.startswith("srt")),
                 "warning": next(s for s in msgs if "not available" in s),
                 "equal": True}
    rep["launches"] = launches
    return rep


def incubate_golden_run(nn, gpt, engine, optim, framework, incubate,
                        device="cuda"):
    """``tests/torch_incubate_golden.py``'s two runs on the port: the
    golden file's recipe, on ``device``; the same keys as the file."""
    from paddle_tpu_torch.testdata import recipes
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "incubate_golden.json")) as f:
        gold = json.load(f)
    r = gold["recipe"]
    rs = np.random.RandomState(r["data_seed"])
    shape = (r["batch"], r["seq"])
    vocab = r["config"]["vocab_size"]
    ids = torch.from_numpy(rs.randint(0, vocab, shape).astype(np.int32))
    lbl = torch.from_numpy(rs.randint(0, vocab, shape).astype(np.int32))

    def trainer(opt):
        model = gpt.GPTForPretraining(tensor_parallel=False, **r["config"])
        names_shapes = [(n, tuple(t.shape))
                        for n, t in model.named_state().items()]
        model.set_state_dict_from_numpy(recipes.bert_weights(
            names_shapes, r["seed"], r["std"]))
        return engine.ParallelTrainer(
            model, opt, lambda logits, y: nn.functional.cross_entropy(
                logits, y), device=device)

    def params(tr):
        return {k: p.detach().float().clone() for k, p in tr.params.items()}

    def norm(tree):
        return float(torch.sqrt(sum(torch.sum(v.double() ** 2)
                                    for v in tree.values())))

    out = {"recipe": r}
    tr = trainer(incubate.LookAhead(optim.AdamW(
        r["lr"], weight_decay=r["weight_decay"]), **r["lookahead"]))
    losses, updates = [], []
    for _ in range(r["steps"]):
        before = params(tr)
        losses.append(float(tr.train_step(ids, lbl)))
        after = params(tr)
        updates.append(norm({k: after[k] - before[k] for k in after}))
    out["lookahead"] = {"losses": losses, "update_norms": updates}

    tr = trainer(optim.AdamW(r["lr"], weight_decay=r["weight_decay"]))
    ma = incubate.ModelAverage(**r["model_average"])
    state = None
    losses, avg_norms, diff_norms = [], [], []
    for _ in range(r["steps"]):
        losses.append(float(tr.train_step(ids, lbl)))
        live = params(tr)
        if state is None:
            state = ma.init_state(live)
        _, state = ma.apply_gradients(live, None, state)
        avg = ma.average(state)
        avg_norms.append(norm(avg))
        diff_norms.append(norm({k: avg[k] - live[k] for k in avg}))
    out["model_average"] = {"losses": losses, "avg_norms": avg_norms,
                            "avg_diff_norms": diff_norms}
    return out, gold


def hold_incubate_golden(got, gold, loss_rtol=INCUBATE_LOSS_RTOL,
                         norm_rtol=INCUBATE_NORM_RTOL):
    """The largest relative gap of each series; raises past its bar."""
    gaps = {}
    for run, series in (("lookahead", ("losses", "update_norms")),
                        ("model_average", ("losses", "avg_norms",
                                           "avg_diff_norms"))):
        for key in series:
            a, b = np.asarray(got[run][key]), np.asarray(gold[run][key])
            # a zero (the first step's average is the live weights) is
            # held exactly
            gap = float(np.max(np.abs(a - b) / np.where(b == 0, 1.0,
                                                        np.abs(b))))
            bar = loss_rtol if key == "losses" else norm_rtol
            check(gap <= bar, f"incubate i2 {run}.{key}: {a.tolist()} vs "
                  f"the reference's {b.tolist()} (gap {gap}, bar {bar})")
            gaps[f"{run}.{key}"] = gap
    return gaps


def _timed_steps(trainer, batch, n):
    """n train steps, each synced -> (losses, ms of each)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(*batch))
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return losses, ms


def asp_i1(fa, fc, nn, gpt, engine, optim, framework, incubate, steps=5,
           warmup=2):
    """(i1) GPT-base in fused_b8_pallas_ce's trainer, unpruned and then
    2:4-pruned (``prune_model`` with the AdamW ``decorate``d): after every
    pruned step ``check_sparsity`` holds on every pruned weight and every
    position ``prune_model`` zeroed is still zero; each pruned step
    launches 36 flash and 3 CE kernels; both steps timed."""
    asp = incubate.asp
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    dense_losses, dense_ms = _timed_steps(trainer, batch, warmup + 3)
    del trainer
    torch.cuda.empty_cache()
    opt = optim.AdamW(3e-4)
    trainer, batch, _ = gpt_base_trainer(nn, gpt, engine, optim, framework,
                                         head="pallas", opt=opt)
    asp.decorate(opt, trainer.model)
    masks = asp.prune_model(trainer.model)
    check(masks, "incubate i1: nothing was pruned")
    zeroed = {k: m == 0 for k, m in masks.items()}
    pruned_numel = sum(m.numel() for m in masks.values())
    zero_counts(fa, fc)
    losses, ms, joined = [], [], 0
    for _ in range(steps):
        l_, t_ = _timed_steps(trainer, batch, 1)
        losses += l_
        ms += t_
        for k, z in zeroed.items():
            w = trainer.params[k].detach()
            check(asp.check_sparsity(w), f"incubate i1: {k} lost 2:4")
            check(not bool(w[z].any()),
                  f"incubate i1: a pruned position of {k} came back")
        joined = sum(int((trainer.params[k].detach() == 0).sum())
                     for k in zeroed) - sum(int(z.sum())
                                            for z in zeroed.values())
    torch.cuda.synchronize()
    launches = check_path(fa, fc, "incubate i1", 12 * steps, 12 * steps,
                          steps)
    check(all(np.isfinite(losses)), f"incubate i1: losses {losses}")
    med = lambda v: float(np.median(v[warmup:]))  # noqa: E731
    return {"params": n_params, "pruned_weights": len(masks),
            "pruned_elements": pruned_numel, "losses": losses,
            "dense_losses": dense_losses, "ms_per_step": med(ms),
            "dense_ms_per_step": med(dense_ms), "ms": ms,
            "dense_ms": dense_ms,
            "pruned_over_dense": med(ms) / med(dense_ms),
            "kept_zeros_joined_mask": joined, "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()}}


def distributions_i3(distribution):
    """(i3) ``Normal``, ``Uniform`` and ``Categorical`` each draw 10^6
    samples on the card; their moments within ``DIST_SIGMAS`` standard
    errors; a seeded draw repeats; ``log_prob`` on the card equals the
    CPU's."""
    dev = "cuda"
    n = DIST_DRAWS
    out = {}
    t = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    normal = distribution.Normal(t(0.5), t(2.0))
    s = normal.sample((n,), seed=7)
    check(torch.equal(s, normal.sample((n,), seed=7)),
          "incubate i3: a seeded Normal draw did not repeat")
    se = 2.0 / n ** 0.5
    mean, std = float(s.mean()), float(s.std())
    check(abs(mean - 0.5) <= DIST_SIGMAS * se and
          abs(std - 2.0) <= DIST_SIGMAS * se,
          f"incubate i3: Normal mean {mean}, std {std}")
    out["normal"] = {"mean": mean, "std": std, "se": se}
    uniform = distribution.Uniform(t(-1.0), t(3.0))
    u = uniform.sample((n,))
    se = (16 / 12) ** 0.5 / n ** 0.5
    mean = float(u.mean())
    check(abs(mean - 1.0) <= DIST_SIGMAS * se and float(u.min()) >= -1.0
          and float(u.max()) < 3.0, f"incubate i3: Uniform mean {mean}")
    out["uniform"] = {"mean": mean, "min": float(u.min()),
                      "max": float(u.max()), "se": se}
    logits = t([0.0, 1.0, 2.0, 0.5])
    cat = distribution.Categorical(logits)
    c = cat.sample((n,))
    p = torch.softmax(logits, -1)
    freq = torch.bincount(c, minlength=4).double() / n
    se = torch.sqrt(p.double() * (1 - p.double()) / n)
    check(bool(((freq - p.double()).abs() <= DIST_SIGMAS * se).all()),
          f"incubate i3: Categorical frequencies {freq.tolist()} vs "
          f"{p.tolist()}")
    out["categorical"] = {"freq": freq.tolist(), "p": p.tolist()}
    values = torch.linspace(-3.0, 4.0, 1001)
    errs = {}
    for name, card_d, cpu_d, v in (
            ("normal", normal, distribution.Normal(0.5, 2.0), values),
            ("uniform", uniform, distribution.Uniform(-1.0, 3.0), values),
            ("categorical", cat,
             distribution.Categorical(logits.cpu()),
             torch.arange(4).repeat(5))):
        a = card_d.log_prob(v.to(dev)).cpu()
        b = cpu_d.log_prob(v)
        fin = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), fin),
              f"incubate i3: {name} log_prob's infinities differ")
        err = float((a[fin] - b[fin]).abs().max())
        check(err <= 1e-6, f"incubate i3: {name} log_prob card vs CPU {err}")
        errs[name] = err
    out["log_prob_max_abs_err"] = errs
    return out


def masked_softmax_i4(operators, shape=(8, 12, 1024, 1024)):
    """(i4) ``softmax_mask_fuse_upper_triangle`` at GPT-base's score shape
    in float32 and bfloat16 against its float64 value, timed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda")
    ref = operators.softmax_mask_fuse_upper_triangle(x.cpu().double())
    out = {"shape": list(shape)}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        xi = x.to(dtype)
        got = operators.softmax_mask_fuse_upper_triangle(xi)
        want = operators.softmax_mask_fuse_upper_triangle(
            xi.cpu().double()) if dtype != torch.float32 else ref
        err = float((got.cpu().double() - want).abs().max())
        check(err <= MASKED_SOFTMAX_ATOL[name],
              f"incubate i4: {name} masked softmax {err} from float64")
        ms = time_ms(lambda: operators.softmax_mask_fuse_upper_triangle(xi),
                     reps=10, warmup=2)
        nbytes = 2 * xi.numel() * xi.element_size()
        out[name] = {"max_abs_err": err, "atol": MASKED_SOFTMAX_ATOL[name],
                     "ms": ms, "bytes_min": nbytes,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
        del got
    del ref, x
    torch.cuda.empty_cache()
    return out


EXT_SRC = r'''
#include "paddle_ext.h"
#include <algorithm>

static void relu6_fwd(const float** ins, int, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = std::min(std::max(ins[0][i], 0.0f), 6.0f);
}
static void relu6_bwd(const float** ins, int, const float* gout,
                      float** gins, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    gins[0][i] = (ins[0][i] > 0.0f && ins[0][i] < 6.0f) ? gout[i] : 0.0f;
}
PD_EXT_REGISTER(relu6, &relu6_fwd, &relu6_bwd, 1);
'''


def host_op_i5(cpp_extension, work, calls=200, numel=4096):
    """(i5) ``cpp_extension.load`` builds a host op with g++ here; on CUDA
    tensors its forward and gradient equal the CPU's; the µs of one call's
    host round trip (the card's tensor to the host and back)."""
    src = os.path.join(work, "chip_ext.cc")
    with open(src, "w") as f:
        f.write(EXT_SRC)
    t0 = time.perf_counter()
    ext = cpp_extension.load("chip_smoke_ext", [src],
                             build_directory=os.path.join(work, "ext"))
    build_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -3.0, 9.0, numel).astype(np.float32))
    xc = x.cuda().requires_grad_(True)
    xh = x.clone().requires_grad_(True)
    yc, yh = ext.relu6(xc), ext.relu6(xh)
    check(yc.device.type == "cuda" and torch.equal(yc.detach().cpu(),
                                                   yh.detach()),
          "incubate i5: the op's card forward differs from the CPU's")
    yc.sum().backward()
    yh.sum().backward()
    check(torch.equal(xc.grad.cpu(), xh.grad),
          "incubate i5: the op's card gradient differs from the CPU's")
    check(torch.equal(yh.detach(), x.clamp(0.0, 6.0)),
          "incubate i5: relu6 is not clamp(0, 6)")
    xd = x.cuda()
    for _ in range(10):
        ext.relu6(xd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        y = ext.relu6(xd)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / calls * 1e6
    del y
    return {"build_seconds": build_s, "numel": numel,
            "us_per_call": us, "calls": calls, "equal": True}


def device_flags_i6(port):
    """(i6) ``run_check()`` on the card, ``get_device() == "gpu:0"``,
    ``CUDAPlace(0)`` the card, ``check_numerics`` naming a NaN planted on
    a card tensor."""
    loss = port.utils.run_check()
    check(np.isfinite(loss), f"incubate i6: run_check loss {loss}")
    check(port.get_device() == "gpu:0",
          f"incubate i6: get_device() is {port.get_device()}")
    check(port.CUDAPlace(0).torch_device == torch.device("cuda", 0),
          "incubate i6: CUDAPlace(0) is not the card")
    check(port.is_compiled_with_cuda(), "incubate i6: not built with CUDA")
    from paddle_tpu_torch.framework import flags
    t = torch.ones(8, device="cuda")
    t[5] = float("nan")
    port.set_flags({"FLAGS_check_nan_inf": True})
    try:
        flags.check_numerics({"w": torch.ones(3, device="cuda")}, "ok:")
        try:
            flags.check_numerics({"w": torch.ones(3, device="cuda"),
                                  "v": [t]}, "card:")
            msg = None
        except FloatingPointError as e:
            msg = str(e)
    finally:
        port.set_flags({"FLAGS_check_nan_inf": False})
    check(msg is not None and "card:['v'][0]" in msg,
          f"incubate i6: check_numerics said {msg!r}")
    return {"run_check_loss": loss, "device": port.get_device(),
            "cudnn": port.get_cudnn_version(), "check_numerics": msg}


def incubate_phase(fa, fc, nn, gpt, engine, optim, framework, work,
                   card=None):
    """``incubate``: (i1) 2:4 ASP on GPT-base in the fused CE trainer,
    (i2) LookAhead and ModelAverage against the reference's golden, (i3)
    the distributions, (i4) the masked softmax, (i5) a host custom op,
    (i6) the device queries and flags; each prints a line of its own
    (``incubate_i1`` ...). (i1) runs the six training kernels, the
    others none."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch import distribution, incubate
    from paddle_tpu_torch.incubate import operators
    from paddle_tpu_torch.utils import cpp_extension
    seconds, reps = {}, {}

    def sub(key, fn):
        t0 = time.perf_counter()
        reps[key] = fn()
        seconds[key] = time.perf_counter() - t0
        emit(phase=f"incubate_{key}", card=card, seconds=seconds[key],
             **reps[key])
        torch.cuda.empty_cache()

    sub("i1", lambda: asp_i1(fa, fc, nn, gpt, engine, optim, framework,
                             incubate))
    zero_counts(fa, fc)

    def i2():
        got, gold = incubate_golden_run(nn, gpt, engine, optim, framework,
                                        incubate)
        return {"gaps": hold_incubate_golden(got, gold),
                "loss_rtol": INCUBATE_LOSS_RTOL,
                "norm_rtol": INCUBATE_NORM_RTOL,
                "lookahead": got["lookahead"],
                "model_average": got["model_average"]}

    sub("i2", i2)
    sub("i3", lambda: distributions_i3(distribution))
    sub("i4", lambda: masked_softmax_i4(operators))
    sub("i5", lambda: host_op_i5(cpp_extension, work))
    sub("i6", lambda: device_flags_i6(port))
    check_path(fa, fc, "incubate i2-i6", 0, 0, 0)
    return {"sub_phase_seconds": seconds, "launches": reps["i1"]["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    # the tuner's overlay, the telemetry run, the calibration overlay and
    # the checkpoints live here, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.environ["PADDLE_TPU_TORCH_TUNING_DB"] = os.path.join(
            work, "tuning_db.json")
        return run(work)


def run(work) -> int:
    sys.path.insert(0, HERE)
    from paddle_tpu_torch import framework, nn, optimizer as optim
    from paddle_tpu_torch.distributed import engine
    from paddle_tpu_torch.inference import decode_model as dm
    from paddle_tpu_torch.inference import kv_cache as kvc
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.spec_decode import (
        DraftModelDrafter, NGramDrafter, SpeculativeDecodeServer)
    from paddle_tpu_torch.ops import _build, chunked_ce, tuner
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.telemetry import calibration
    from paddle_tpu_torch.text.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    emit(phase="device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # 2. build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    _build.build([os.path.splitext(os.path.basename(s))[0] for s in SOURCES])
    pa.load_kernel()
    fa.load_kernel()
    fc.load_kernel()
    emit(phase="build", seconds=time.perf_counter() - t0,
         build_seconds={n: i["seconds"] for n, i in _build.BUILD_INFO.items()},
         ptxas={n: [ln.strip() for ln in i["log"].splitlines()
                    if "registers" in ln or "spill" in ln or
                    "Compiling entry" in ln]
                for n, i in _build.BUILD_INFO.items()})

    # 2b. the tuner's sweep of the port's split counts: the rest of the run
    # resolves through what it wrote
    rs = np.random.RandomState(0)
    tuner.clear_cache()
    winners = tune_phase(tuner, fc, pa, fa, calibration, card, rs)

    # 3-4. the paged kernels: parity, repeats, timing
    max_err, timing = paged_kernel_phases(pa, card, rs)

    # 5. serving at GPT-base widths against the oracle and the golden file
    with open(os.path.join(HERE, "paddle_tpu_torch", "testdata",
                           "decode_golden.json")) as f:
        gold = json.load(f)
    cfg = gold["config"]
    check(cfg == {"vocab": 50304, "num_heads": 12, "head_dim": 64,
                  "max_len": 1024, "seed": cfg["seed"]},
          f"golden config is not GPT-base: {cfg}")
    params = dm.params_from_jax(dm.init_decode_model(**cfg), "cuda")
    prompts = [gold["prefix"] + s for s in gold["suffixes"]]
    max_new = gold["max_new"]
    check(min(min(m) for m in gold["margins"]) >= gold["min_margin"],
          "golden margins below the bar")
    oracle = [dm.dense_generate(params, pr, max_new) for pr in prompts]
    for i, (pr, toks) in enumerate(zip(prompts, oracle)):
        check(toks == gold["tokens"][i],
              f"card oracle != JAX golden tokens for prompt {i}")
        marg = oracle_margins(params, pr, toks)
        check(marg.min() >= gold["min_margin"],
              f"prompt {i}: card oracle margin {marg.min()}")
    emit(phase="oracle", prompts=len(prompts), max_new=max_new,
         matches_golden=True)

    outs, rep = serve(serving.DecodeServer, params, prompts, max_new, {},
                      pa, dm, kvc, serving, tuner)
    for i, toks in enumerate(outs):
        check(toks == oracle[i], f"served prompt {i} != dense_generate")
        check(toks == gold["tokens"][i], f"served prompt {i} != golden")
    n_follow = len(prompts) - 1
    check(rep["prefix_hit_tokens"] == 512 * n_follow,
          f"prefix hits {rep['prefix_hit_tokens']} != {512 * n_follow}")
    check(rep["launches"]["decode"] > 0 and rep["launches"]["verify"] > 0,
          f"kernel launches {rep['launches']}")
    check(rep["fallbacks"] == 0, f"{rep['fallbacks']} fallbacks")
    check_split_routes(rep)
    main_launches = rep["launches"]
    rep_main_rate = rep["decode_tokens_per_s"]
    emit(phase="serving", card=card, **rep)

    # 6. speculative decoding: the n-gram drafter as shipped, then a
    # perfect draft model (same weights) so every decode step is a full
    # 1+K verify window and uniform batches reach the kernel
    outs, rep = serve(SpeculativeDecodeServer, params, prompts, max_new,
                      dict(drafter=NGramDrafter(), spec_k=4),
                      pa, dm, kvc, serving, tuner)
    for i, toks in enumerate(outs):
        check(toks == oracle[i], f"spec (n-gram) prompt {i} != oracle")
    check(rep["fallbacks"] == 0, f"{rep['fallbacks']} fallbacks")
    check_split_routes(rep)
    emit(phase="spec_ngram", card=card, **rep)

    drafter = DraftModelDrafter(lambda hist, k: dm.dense_generate(
        params, hist, k))
    outs, rep = serve(SpeculativeDecodeServer, params, prompts[:9], max_new,
                      dict(drafter=drafter, spec_k=4), pa, dm, kvc, serving,
                      tuner)
    for i, toks in enumerate(outs):
        check(toks == oracle[i], f"spec (draft model) prompt {i} != oracle")
    check(rep["fallbacks"] == 0, f"{rep['fallbacks']} fallbacks")
    check_split_routes(rep)
    check(rep["launches"]["verify"] > 0 and
          any(s[1] == 8 for s in rep["verify_shapes"]),
          f"no 1+K=5 verify window (bucketed to 8) reached the kernel: "
          f"{rep['verify_shapes']}")
    check(rep["spec_decode"]["tokens_per_target_step"] > 1.0,
          "a perfect drafter did not raise tokens per target step")
    emit(phase="spec_draft_model", card=card, **rep)

    # 6b. the same serving run with every paged launch on the simple route,
    # then on the split route again: decode tokens/s of the two routes in
    # turns, a yardstick for the main run's
    rates = {"split": [rep_main_rate]}
    for route in ("simple", "split"):
        with paged_route_forced(pa, route):
            outs, rep = serve(serving.DecodeServer, params, prompts, max_new,
                              {}, pa, dm, kvc, serving, tuner)
        for i, toks in enumerate(outs):
            check(toks == oracle[i], f"served ({route}) prompt {i} != oracle")
        check(rep["routes"][f"decode_{route}"] == rep["launches"]["decode"],
              f"serving on the {route} route: routes {rep['routes']}")
        rates.setdefault(route, []).append(rep["decode_tokens_per_s"])
    emit(phase="serving_routes", card=card, decode_tokens_per_s=rates)

    # 6c. the host cost of resolving the split count on every paged launch:
    # the wrapper's resolution beside a plain dict, serving in turns
    rates = {}
    for variant in ("resolve", "memo", "memo", "resolve"):
        ctx = splits_memoised(pa) if variant == "memo" else \
            contextlib.nullcontext()
        with ctx:
            outs, rep = serve(serving.DecodeServer, params, prompts, max_new,
                              {}, pa, dm, kvc, serving, tuner)
        for i, toks in enumerate(outs):
            check(toks == oracle[i], f"served ({variant}) prompt {i} != "
                  "oracle")
        rates.setdefault(variant, []).append(rep["decode_tokens_per_s"])
    emit(phase="serving_resolve", card=card, decode_tokens_per_s=rates,
         **resolve_host_us(pa))

    # 7. where the time goes in a steady serving window
    emit(phase="profile", card=card,
         **profile_serving(params, prompts, max_new, dm, kvc, serving))

    # 8. flash kernels against their plain versions on the card
    flash_err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(s, d, causal, lens, f32, 0.0)
             for s in (128, 200, 1024) for d in (64, 128)
             for causal in (True, False) for lens in (None, [s, 37])]
    cases += [(200, 64, True, [0, 37], f32, 0.0),
              (200, 64, False, [0, 37], f32, 0.0)]
    cases += [(s, d, causal, [s, 37], bf16, 0.0)
              for s in (200, 1024) for d in (64, 128)
              for causal in (True, False)]
    cases += [(256, 64, True, None, f32, 0.1),
              (1024, 64, True, None, bf16, 0.1)]
    # the tensor-core forward: every bf16 case at D = 64 and 128 not above
    have = set((c[0], c[1], c[2], str(c[3])) for c in cases
               if c[4] == bf16 and c[5] == 0.0)
    cases += [(s, d, causal, lens, bf16, 0.0)
              for s in (128, 200, 1024) for d in (64, 128)
              for causal in (True, False) for lens in (None, [s, 37], [0, 37])
              if (s, d, causal, str(lens)) not in have]
    cases += [(1024, 128, True, None, bf16, 0.1)]
    cases = [c + (dict(),) for c in cases]
    # the main path's call: GPT-base, q/k/v the QKV split's strided views
    cases.append((1024, 64, True, None, bf16, 0.0,
                  dict(b=8, h=12, split_qkv=True)))
    n_mma = n_bwd_mma = 0
    mma_worst = {"out_rel": 0.0, "lse_abs": 0.0, "scalar_out_rel": 0.0}
    mma_bwd_worst = {f"{n}{r}_rel": 0.0 for n in ("dq", "dk", "dv")
                     for r in ("", "_scalar_route")}
    for s, d, causal, lens, dtype, rate, kw in cases:
        errs, route, broute = flash_parity_case(fa, rs, s, d, causal, lens,
                                                dtype, rate, **kw)
        rel = {key: errs.pop(key) for key in list(errs)
               if key.endswith("_rel")}
        if route == "mma":
            n_mma += 1
            for key, val in (("out_rel", rel["out_rel"]),
                             ("out_rel", rel["out_autograd_rel"]),
                             ("lse_abs", errs["lse"]),
                             ("scalar_out_rel", rel["out_scalar_route_rel"])):
                mma_worst[key] = max(mma_worst[key], val)
        if broute == "mma":
            n_bwd_mma += 1
            for key in mma_bwd_worst:
                mma_bwd_worst[key] = max(mma_bwd_worst[key], rel[key])
        flash_err["flash_fwd"] = max(flash_err["flash_fwd"], errs["out"],
                                     errs["lse"], errs["out_autograd"])
        flash_err["flash_dq"] = max(flash_err["flash_dq"], errs["dq"])
        flash_err["flash_dkv"] = max(flash_err["flash_dkv"], errs["dk"],
                                     errs["dv"])
        emit(phase="flash_parity", s=s, d=d, causal=causal, lens=lens,
             dtype=str(dtype).split(".")[-1], dropout=rate, **kw,
             fwd_route=route, bwd_route=broute, max_abs_err=errs, rel_err=rel,
             atol_rtol=FLASH_TOL[dtype][0])
    n_bf16 = sum(c[4] == bf16 for c in cases)
    check(n_mma == n_bf16 and n_bwd_mma == n_bf16,
          f"{n_mma} bf16 cases on the mma forward, {n_bwd_mma} on the mma "
          f"dq and dk/dv, of {n_bf16}")
    # the main path's call twice on the mma route: the same bits, forward,
    # dq and dk/dv
    q, k, v, do = _qkv_views(8, 1024, 12, 64, seed=1)
    rest = (None, 0, None, True, 0.0, fa.keying_blocks(bf16, 64, 1024, 1024))
    once = fa.flash_attention_fwd(q, k, v, *rest, route="mma")
    twice = fa.flash_attention_fwd(q, k, v, *rest, route="mma")
    check(all(torch.equal(a, b) for a, b in zip(once, twice)),
          "two mma forward launches at the main call differ")
    bwd_args = (q, k, v, do, once[1], fa._delta(once[0], do), *rest)
    dq1, dq2 = [fa._launch_dq(*bwd_args, route="mma") for _ in range(2)]
    (dk1, dv1), (dk2, dv2) = [fa._launch_dkv(*bwd_args, route="mma")
                              for _ in range(2)]
    check(torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and
          torch.equal(dv1, dv2),
          "two mma dq or dk/dv launches at the main call differ")
    emit(phase="flash_repeat", bit_identical=True, cases_on_mma=n_mma,
         cases_on_mma_bwd=n_bwd_mma, cases=len(cases), mma_worst=mma_worst,
         mma_bound=MMA_FWD_BOUND, mma_bwd_worst=mma_bwd_worst,
         mma_bwd_bound=MMA_BWD_BOUND)
    del q, k, v, do, once, twice, dq1, dq2, dk1, dv1, dk2, dv2

    # 9. flash timing at GPT-base (B=8, H=12, S=1024, D=64, bf16, causal)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ftiming, fextra = flash_timing(fa, flush)
    # gpt_1p3b's attention: 16 heads of 128 at S = 1024
    d128 = {"flash_fwd": flash_fwd_routes_timing(fa, flush, 8, 16, 1024, 128)}
    bwd_d128, bwd_d128_whole = flash_bwd_routes_timing(fa, flush, 8, 16, 1024,
                                                       128)
    d128.update(bwd_d128)
    del flush
    for name, t in ftiming.items():
        emit(phase="flash_timing", card=card, kernel=name, **t)
    emit(phase="flash_timing_library", card=card, **fextra)
    emit(phase="flash_fwd_timing", card=card, config="gpt_1p3b",
         **d128["flash_fwd"])
    for name, t in bwd_d128.items():
        emit(phase="flash_bwd_timing", card=card, config="gpt_1p3b",
             kernel=name, **t)
    emit(phase="flash_bwd_timing_library", card=card, config="gpt_1p3b",
         **bwd_d128_whole)

    # 9b. the repaired dispatch: float16 falls back, counted
    emit(phase="gates", card=card, **gates(fa, fc, nn, tuner, optim, rs))

    # 10. fused-CE kernels against their plain versions on the card
    ce_err = {k: {"abs": 0.0, "norm": 0.0} for k in ("ce_fwd", "ce_dh",
                                                     "ce_dw")}
    cases = ce_parity_cases()
    n_tiled = 0
    for shape, dtype, ignore, transposed, oor in cases:
        args = ce_main_inputs() if shape == "main path" else \
            ce_inputs(rs, *shape, dtype, ignore, transposed, oor)
        errs = ce_parity_case(fc, *args, twice=shape == "main path")
        n_tiled += errs["fwd_route"] == "tiled"
        if shape == (300, 768, 700):
            check(errs["splits"] == 1, f"V 700 took {errs['splits']} "
                  f"splits, not the one the rule leaves it")
        for key, outs in (("ce_fwd", ("lse", "tgt")), ("ce_dh", ("dh",)),
                          ("ce_dw", ("dw",))):
            for o in outs:
                for m in ("abs", "norm"):
                    ce_err[key][m] = max(ce_err[key][m], errs[o][m])
        emit(phase="ce_parity", shape=shape, dtype=str(dtype).split(".")[-1],
             ignore=ignore, transposed=transposed, out_of_range=oor,
             errors=errs, tol=CE_TOL[dtype], stat_atol=CE_STAT_ATOL)
    del args
    want = sum(c[1] == bf16 and (c[0] == "main path" or c[0][1] % 64 == 0)
               for c in cases)
    check(n_tiled == want, f"{n_tiled} cases on the tiled forward, not "
          f"every one of the {want} bf16 cases with H a multiple of 64")

    # 11. fused-CE timing at the main path's call (N = 8192, H = 768,
    # V = 50304, bf16, w the tied embedding's .T view)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ctiming, ce_h2048 = ce_timing(fc, chunked_ce, flush)
    del flush
    for name, t in ctiming.items():
        emit(phase="ce_timing", card=card, kernel=name, **t)
    emit(phase="ce_fwd_timing", card=card, config="gpt_1p3b", **ce_h2048)

    # 12. GPT-base widths, depth 2, fp32, against the JAX golden losses,
    # through the three routes of the head loss
    for head in ("chunked", "pallas", "dense"):
        emit(phase="train_golden", card=card,
             **train_golden(fa, fc, nn, gpt, engine, optim, head))

    # 13. full GPT-base training steps, bench.py fused_b8 (chunked CE)
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework)
    rep = train(fa, tuner, trainer, batch, n_params)
    train_launches = rep["launches"]
    fused_b8_losses = rep["losses"]
    fused_b8 = rep
    emit(phase="train", card=card, **rep)

    # 14. where the time of a GPT-base step goes
    emit(phase="train_profile", card=card,
         **profile_train(trainer, batch))
    del trainer, batch

    # 15. this slice's main path: bench.py fused_b8_pallas_ce, the head
    # loss on the fused CE kernels
    trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                framework, head="pallas")
    rep = train(fa, tuner, trainer, batch, n_params, fc=fc)
    ce_launches = rep["ce_launches"]
    check(rep["ce_routes"] == {"ce_fwd_tiled": 10, "ce_fwd_staged": 0,
                               "ce_dh_tiled": 10, "ce_dh_staged": 0,
                               "ce_dw_tiled": 10, "ce_dw_staged": 0},
          f"fused CE routes on the main path: {rep['ce_routes']}")
    ce_winner = winners[[k for k in winners if "h768," in k][0]]
    check(rep["ce_splits"] == {ce_winner: 10},
          f"the main path's CE forwards took {rep['ce_splits']} splits, "
          f"not the tuned {ce_winner}")
    emit(phase="train_fused_ce", card=card, **rep)
    prof = profile_train(trainer, batch)
    groups = prof["by_group"]
    check("fused CE kernels" in groups, "the profiler saw no fused CE kernel")
    seen = {k: v["launches_per_step"] for k, v in
            prof["flash_by_kernel"].items()}
    check(seen == {"flash_fwd_mma_kernel": 12, "flash_dq_mma_kernel": 12,
                   "flash_dkv_mma_kernel": 12},
          f"flash kernels by name under the profiler: {seen}")
    f32_gemm = groups.get("float32 GEMMs (chunked CE)", {}).get(
        "ms_per_step", 0.0)
    check(f32_gemm < 1.0, f"float32 GEMMs left on the fused path: "
          f"{f32_gemm} ms per step")
    emit(phase="train_fused_ce_profile", card=card, **prof)
    fused_ce_losses = rep["losses"]

    # 15a. the same trainer inside telemetry.scope with the profiler on:
    # the run's four artifacts, a calibration fit, the one-rank merge
    emit(phase="telemetry", card=card,
         **telemetry_phase(trainer, batch, n_params, work, card))
    del trainer, batch
    torch.cuda.empty_cache()

    # 15c. checkpoint: save, a torn newer step, restore, resume bit for bit
    emit(phase="checkpoint", card=card,
         **checkpoint_phase(nn, gpt, engine, optim, framework, work, card))

    # 15d. the same run with the asynchronous pipeline and the deep tier
    rep = async_checkpoint_phase(nn, gpt, engine, optim, framework, fa, fc,
                                 work)
    path_launches = {"async_checkpoint": {
        k: rep["launches"]["A"][k] + rep["launches"]["B"][k]
        for k in rep["launches"]["A"]}}
    emit(phase="async_checkpoint", card=card, **rep)

    # 15e. the resilient runtime on the main path: run_resilient with the
    # integrity check, a torn commit, a drain and a resume bit for bit,
    # fingerprints card against CPU, replay, the hang watchdog
    rep = resilient_phase(nn, gpt, engine, optim, framework, fa, fc, work)
    path_launches["resilient"] = rep["launches"]
    emit(phase="resilient", card=card, **rep)

    # 15f. the serving tier: jit.save/load, the Predictor golden, three
    # generations of full GPT-base with int8/int4 weights, the executor
    # cache, the int8 fleet rolled from checkpoints, a decode fleet, the
    # calibrated admission
    rep = serving_tier_phase(fa, fc, pa, nn, gpt, engine, optim, framework,
                             dm, kvc, serving, params, prompts, oracle,
                             max_new, work)
    path_launches["serving_tier"] = rep["launches"]
    emit(phase="serving_tier", card=card, **rep)
    torch.cuda.empty_cache()

    # 15g. ZeRO stages 0-3 through the fleet API on an NCCL mesh of one
    # rank, bit for bit stage 0's; the trainer's checkpoint saved at step
    # 3 and resumed bit for bit
    rep = zero_phase(fa, fc, nn, gpt, optim, framework, work)
    path_launches["zero"] = rep["launches"]
    emit(phase="zero", card=card, **rep)

    # 15h. tensor, pipeline and context parallelism on one card: TP at mp 1
    # against dense_b8, the pipeline at one stage (GPipe == 1F1B == the
    # gradient merge), the ring's block steps against the whole sequence
    t0 = time.perf_counter()
    rep = hybrid_phase(fa, fc, nn, gpt, optim, framework)
    path_launches["hybrid"] = rep["launches"]
    emit(phase="hybrid", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15i. ResNet-50: the golden in float32, then bench_resnet50's step at
    # batch 128 in bfloat16
    t0 = time.perf_counter()
    rep = vision_phase(fa, fc, nn, optim, engine, framework, card)
    path_launches["vision"] = rep["launches"]
    emit(phase="vision", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15i'. the high-level API: GPT-base through Model.fit against the
    # trainer, MobileNetV2 fed by DataLoader workers, LeNet's round trip
    t0 = time.perf_counter()
    rep = hapi_phase(fa, fc, nn, gpt, engine, optim, framework, work, card)
    path_launches["hapi"] = rep["launches"]
    emit(phase="hapi", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15j. experts on one card, the sharded lookup and LocalSGD at one rank
    t0 = time.perf_counter()
    rep = experts_phase(fa, fc, nn, optim, engine)
    path_launches["experts"] = rep["launches"]
    emit(phase="experts", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15k. the program analysis: GPT-base's step traced on fakes (every
    # kernel one node), its cost beside the measured step, the lint of the
    # three main programs, the planner, the fingerprints
    t0 = time.perf_counter()
    rep = analysis_phase(fa, fc, pa, nn, gpt, engine, optim, framework)
    path_launches["analysis"] = rep["launches"]
    emit(phase="analysis", card=card, seconds=time.perf_counter() - t0,
         **rep)
    torch.cuda.empty_cache()

    # 15l. BERT/ERNIE: the golden, bench.py's bert_base_amp at S 128 (the
    # gate refuses) and at S 512 (the flash kernels, non-causal), the
    # kernels at BERT's shape
    t0 = time.perf_counter()
    rep = text_phase(fa, fc, tuner, optim, engine, framework, rs)
    path_launches["text"] = rep["launches"]
    bert_timing = rep["t4_flash"]["timing"]
    emit(phase="text", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15m. Wide&Deep on the card, the heter hot tier against the host
    # table, the parameter server through the fleet lifecycle
    t0 = time.perf_counter()
    rep = rec_phase(fa, fc, optim, engine, framework)
    path_launches["rec"] = rep["launches"]
    emit(phase="rec", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15n. the MT Transformer (the golden, Transformer-base training, beam
    # search, the copy task), MultiHeadAttention on the flash kernels, the
    # PTB LSTM and the seq2seq step through to_static
    t0 = time.perf_counter()
    rep = mt_phase(fa, fc, tuner, optim, engine, framework, card)
    path_launches["mt"] = rep["launches"]
    emit(phase="mt", seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15o. ONNX export on the card: ResNet-50 with a dynamic batch and the
    # GPT-base trunk (the flash node mapped) evaluated against their eager
    # forwards, and the fallback to jit.save's artifact
    t0 = time.perf_counter()
    rep = onnx_phase(fa, fc, nn, gpt, framework, work, card)
    path_launches["onnx"] = rep["launches"]
    emit(phase="onnx", card=card, seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 15p. the small modules: GPT-base trained 2:4-pruned, LookAhead and
    # ModelAverage against the reference, the distributions, the masked
    # softmax, a host custom op, the device queries and flags
    t0 = time.perf_counter()
    rep = incubate_phase(fa, fc, nn, gpt, engine, optim, framework, work,
                         card)
    path_launches["incubate"] = rep["launches"]
    emit(phase="incubate", card=card, seconds=time.perf_counter() - t0,
         **rep)
    torch.cuda.empty_cache()

    # 15b. the same steps with dh and dw on the staged route: how far two
    # summation orders of the same gradients drift apart in bf16 training
    with staged_route(fc):
        trainer, batch, n_params = gpt_base_trainer(
            nn, gpt, engine, optim, framework, head="pallas")
        rep = train(fa, tuner, trainer, batch, n_params)
    del trainer, batch
    rel = lambda a, b: [abs(x - y) / abs(y)  # noqa: E731
                        for x, y in zip(a, b)]
    emit(phase="train_fused_ce_staged", card=card, **rep,
         tiled_vs_fused_b8=rel(fused_ce_losses, fused_b8_losses),
         staged_vs_fused_b8=rel(rep["losses"], fused_b8_losses),
         tiled_vs_staged=rel(fused_ce_losses, rep["losses"]))

    # 16. bench.py's other single-card variants, 2 warm-up + 3 timed steps
    variants = {}
    for name, kw in (("dense_b8", dict(head="dense")),
                     ("fused_b32", dict(batch=32)),
                     ("fused_b32_remat", dict(batch=32, remat=True)),
                     ("fused_b8_accumulate2", dict(accumulate_steps=2))):
        trainer, batch, n_params = gpt_base_trainer(nn, gpt, engine, optim,
                                                    framework, **kw)
        rep = train(fa, tuner, trainer, batch, n_params, iters=3)
        variants[name] = rep
        emit(phase="train_variants", card=card, variant=name, **rep)
        del trainer, batch
        torch.cuda.empty_cache()
    remat, b32 = variants["fused_b32_remat"], variants["fused_b32"]
    check(np.allclose(remat["losses"], b32["losses"], rtol=1e-2),
          f"remat losses {remat['losses']} vs {b32['losses']}")
    # the reference checkpoints the whole model call, so the backward
    # recomputes every activation before it frees any: the peak can only
    # match the plain step's, not fall below it
    check(remat["max_memory_allocated_gb"] <=
          b32["max_memory_allocated_gb"] + 0.01,
          "remat raised peak memory")
    acc = variants["fused_b8_accumulate2"]
    check(np.allclose(acc["losses"], fused_b8_losses[:3], rtol=1e-2),
          f"gradient-merge losses {acc['losses']} vs fused_b8 "
          f"{fused_b8_losses[:3]}")

    # 16b. the eager optimizer API: the golden steps of the eleven
    # optimizers, AdamW against the trainer bit for bit, Lamb, and
    # GradScaler.minimize
    from paddle_tpu_torch import amp
    rep = eager_phase(fa, fc, nn, gpt, engine, optim, framework, amp)
    path_launches["eager"] = {k: rep["adamw"]["launches"][k] +
                              rep["lamb"]["launches"][k]
                              for k in rep["adamw"]["launches"]}
    emit(phase="eager", card=card, **rep)

    # 16c. remat per block under each policy, batch 32
    rows = remat_phase(fa, fc, nn, gpt, framework)
    path_launches["remat_policies"] = {
        k: sum(r["launches"][k] for r in rows.values())
        for k in rows["no_recompute"]["launches"]}
    for policy, row in rows.items():
        emit(phase="remat_policies", card=card, policy=policy, **row)

    # 17. data parallelism over NCCL (one rank): the compressed exchange of
    # real GPT-base gradients, card against CPU, then bench.py's
    # fused_b8_int8dp / fused_b8_int4dp and int8 with four buckets
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import compressed as cm
    nccl, gloo, _ = dp_setup()
    try:
        grads, n_params = base_grads(nn, gpt, engine, optim, framework)
        for pol, row in dp_exchange(cm, nccl, gloo, grads).items():
            emit(phase="dp_exchange", card=card, params=n_params, **row)
        del grads
        torch.cuda.empty_cache()
        for name, rep in train_dp(fa, tuner, cm, nn, gpt, engine, optim,
                                  framework, nccl, fused_b8).items():
            emit(phase="train_dp", card=card, variant=name, **rep)

        # 18. loss scaling under auto_cast at GPT-base widths, depth 2
        emit(phase="amp", card=card,
             **amp_phase(amp, fa, nn, gpt, engine, optim, framework))
    finally:
        dist.destroy_process_group()

    # 18b. the declarative mode: GPT-base's forward staged by to_static,
    # its loss and gradients as a static.Program under Executor.run, and
    # converted control flow on the card
    t0 = time.perf_counter()
    rep = static_phase(fa, fc, nn, gpt, engine, optim, framework, card)
    path_launches["static"] = rep["launches"]
    emit(phase="static", seconds=time.perf_counter() - t0, **rep)
    torch.cuda.empty_cache()

    # 19. kernels
    kernels = []
    for key, tq in (("decode", 1), ("verify", 32)):
        t = timing[(tq, 8, str(torch.float32))]
        t8 = timing[(8, 8, str(torch.float32))]
        kernels.append({
            "name": f"paged_attention_{key}", "route": "cuda",
            "paged_route": "split", "source": SRC, "replaces": REPLACES[key],
            "launches": main_launches[key],
            "launches_by_path": {"serving_tier":
                                 path_launches["serving_tier"][key]},
            "max_abs_err": max_err[key],
            "ms": t["ms"], "simple_ms": t["simple_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "splits": t["splits"], "tuned_splits": t["tuned_splits"],
            "tuned_ms": t["tuned_ms"],
            **({"tq8": {k: t8[k] for k in (
                "splits", "ms", "tuned_splits", "tuned_ms", "bound_ms",
                "plain_ms", "library_ms")}} if key == "verify" else {})})
    for name, t in ftiming.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SRC,
            "replaces": REPLACES[name], "launches": train_launches[name],
            "launches_by_path": {path: n[name]
                                 for path, n in path_launches.items()},
            "max_abs_err": flash_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{key: t[key] for key in ("bwd_ms", "scalar_bwd_ms",
                                       "plain_bwd_ms", "library_bwd_ms",
                                       "bwd_over_library", "fwd_route",
                                       "bwd_route", "scalar_ms") if key in t},
            "d128": {key: d128[name][key] for key in (
                "shape", "ms", "scalar_ms", "plain_ms", "library_ms",
                "library_bwd_ms", "bound_ms", "bound_by")
                if key in d128[name]},
            "bert": {key: bert_timing[name][key] for key in (
                "shape", "ms", "scalar_ms", "plain_ms", "library_ms",
                "library_bwd_ms", "bound_ms", "bound_by")
                if key in bert_timing[name]}})
    for name, t in ctiming.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CE_SRC,
            "replaces": REPLACES[name], "launches": ce_launches[name],
            "launches_by_path": {path: n[name]
                                 for path, n in path_launches.items()},
            "max_abs_err": ce_err[name]["abs"],
            "max_norm_err": ce_err[name]["norm"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{key: t[key] for key in t if key.endswith("fwd_ms") or
               key.endswith("fwd_bwd_ms") or key.startswith("staged_") or
               key in ("fwd_route", "splits", "tuned_splits", "tuned_ms")},
            **({"h2048": {key: ce_h2048[key] for key in (
                "shape", "ms", "staged_ms", "plain_ms", "library_fwd_ms",
                "bound_ms", "bound_by", "splits", "tuned_splits",
                "tuned_ms")}}
               if name == "ce_fwd" else {})})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
