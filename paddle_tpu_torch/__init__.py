"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's module paths (``inference/kv_cache.py``,
``inference/serving.py``, ``ops/paged_attention.py`` ...) so a reader finds
each module's counterpart. It imports ``torch`` and never ``jax`` or any
module of ``paddle_tpu``; the JAX package stays the reference that the
tests hold this package against.

Every hot-path kernel is a hand-written CUDA kernel for Hopper (``sm_90a``)
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``) and
bound with ``ctypes``. Each kernel keeps a plain PyTorch version beside it;
a wrapper takes the plain version only for a tensor that lies on the CPU.

Entry points place their state on the card unless the caller passes
``device="cpu"``; without a card they raise.

Ported so far: decode serving on the paged KV cache (``inference``), with
the paged decode/verify attention kernel; GPT training on one device
(``text.models.gpt``, ``nn``, ``optimizer`` with its LR schedulers,
``regularizer``, ``distributed.engine`` with remat and gradient merge,
``framework.random``), with the flash-attention forward, dq and dk/dv
kernels and the fused LM-head cross-entropy forward, dh and dw kernels;
data-parallel training over ``torch.distributed`` (``distributed``: env,
mesh, collectives, the compressed int8/int4 gradient exchange,
``DataParallel``, ``spawn``, the data-parallel ``ParallelTrainer``) and
``amp`` (``auto_cast``, ``decorate``, ``GradScaler``); the tuning DB with
the port's split counts measured on the card (``ops.tuner``), the run's
telemetry artifacts (``telemetry.scope``, ``export``, ``aggregate``,
``calibration``), host and device profiling (``profiler``), checkpoints
(``distributed.checkpoint``, ``framework_io``, the optimizer's and the
trainer's state) and the retry policy (``resilience.retry``); the
resilient training runtime (``resilience``); and the serving tier:
export and load (``jit``: ``torch.export`` programs), the predictor API
with int8/int4 weight quantization (``inference``, ``inference.quant``),
the executor cache and the self-healing serving fleet
(``inference.executor_cache``, ``inference.fleet``); hybrid parallelism
(ZeRO, tensor, pipeline and context parallelism); the mixture of experts
with expert parallelism (``incubate``), the sharded embedding lookup
(``ops.sharded_embedding``) and LocalSGD
(``distributed.meta_parallel.localsgd``); the ResNet family
(``vision``) with the convolutions, pooling, batch norm and activations
of ``nn``; and the program analysis (``analysis``: a step traced on fake
tensors, every kernel one node, with its cost, lint rules, collective
schedules and fingerprints, and ``python -m paddle_tpu_torch.analysis.lint``)
with the planner (``distributed.auto``); BERT/ERNIE pretraining
(``text.models.bert``); and the parameter-server tier
(``distributed.ps``: the native host tables, their TCP service, the
Hogwild/Downpour trainers, the host-table embedding and the hot tier on
the card) with Wide&Deep and DeepFM (``rec``).
"""
__version__ = "0.1.0"

__all__ = ["amp", "analysis", "distributed", "framework", "framework_io",
           "incubate",
           "inference", "jit", "nn", "ops", "optimizer", "profiler",
           "rec", "regularizer", "resilience", "telemetry", "text",
           "vision"]
