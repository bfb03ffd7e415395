"""Lint the port's main programs with the graph analyzer.

``python -m paddle_tpu_torch.analysis.lint`` traces, on fake tensors
(nothing launched), the steps a user of the port runs and runs every rule
of :mod:`.rules` and the cost model over each; the port's counterpart of
the reference's ``tools/lint_program.py``:

- ``gpt``: GPT-base training as the main path runs it
  (``fused_b8_pallas_ce``: 12 layers, hidden 768, 12 heads, vocab 50304,
  batch 8 x 1024, bf16, AdamW(3e-4), the fused-CE kernels); ``--smoke``:
  1 layer, hidden 64, 2 heads, vocab 256, batch 4 x 32;
- ``resnet``: bench_resnet50's step (batch 128, 224 x 224, bf16,
  ``Momentum(0.1, 0.9)``); ``--smoke``: resnet18 at batch 4, 32 x 32;
- ``bert``: bench.py's ``bert_base_amp`` step (BERT-base, bf16, AdamW(1e-4),
  MLM + NSP through ``BertForPretraining.loss``) at batch 16 x 128 and
  16 x 512 (``bert-s128``, ``bert-s512``: the flash gate refuses the
  first and takes the second, non-causal); ``--smoke``: 1 layer, hidden
  64, 2 heads, vocab 256, batch 2 at both lengths;
- ``decode``: the decode server's mixed, decode and verify executors
  (``inference/decode_model.py``) at the serving cell's widths (12 heads
  of 64, 2048 pages of 16, 8 rows, 1024-token block tables, a verify
  window of 8); ``--smoke``: 2 heads of 32, 2 rows, a window of 4;

and the program families (the trainer's plain/check pair, the decode
router) through ``analysis.schedule.verify_family``.

Exit status: 0 when no program has an error finding, 1 otherwise; with
``--strict`` a warning fails too (infos never do). The programs are built
on the card (raising without one), or on the CPU with ``--device cpu``
(where GPT's attention takes its plain path: the flash gate needs a CUDA
tensor).

Usage::

    python -m paddle_tpu_torch.analysis.lint --smoke --strict --device cpu
    python -m paddle_tpu_torch.analysis.lint --model gpt --json
    python -m paddle_tpu_torch.analysis.lint --model decode --dump-collectives
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["MODELS", "build_gpt", "build_resnet", "build_bert",
           "bert_config", "bert_params", "bert_matmul_terms",
           "decode_programs", "lint_model",
           "verify_families", "main"]


def _device(name=None) -> torch.device:
    from .._device import resolve_device
    return resolve_device(name)


def build_gpt(smoke: bool, device=None):
    """(trainer, inputs, labels) of GPT training on the fused-CE kernels."""
    from .. import framework, nn, optimizer
    from ..distributed.engine import ParallelTrainer
    from ..distributed.mesh import build_mesh, get_mesh
    from ..text.models import GPTForPretraining
    dev = _device(device)
    if smoke:
        vocab, h, layers, heads, seq, batch = 256, 64, 1, 2, 32, 4
    else:
        vocab, h, layers, heads, seq, batch = 50304, 768, 12, 12, 1024, 8
    framework.seed(0)
    model = GPTForPretraining(
        tensor_parallel=False, vocab_size=vocab, hidden_size=h,
        num_layers=layers, num_heads=heads, max_position_embeddings=seq,
        attn_dropout=0.0, hidden_dropout=0.0).bfloat16()

    class FusedLoss(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, b):
            return self.inner.fused_head_loss(b[0], b[1], chunk=8192,
                                              ce_kernel="pallas")

    mesh = get_mesh() or build_mesh({"data": 1})
    trainer = ParallelTrainer(FusedLoss(model), optimizer.AdamW(3e-4),
                              lambda out, _l: out, mesh=mesh, device=dev)
    rs = np.random.RandomState(0)
    ids, lbl = (torch.from_numpy(rs.randint(0, vocab, (batch, seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))
    return trainer, (ids, lbl), 0.0


def build_resnet(smoke: bool, device=None):
    """(trainer, images, labels) of bench_resnet50's step (resnet18 at
    32 x 32 with ``smoke``)."""
    from .. import framework, nn, optimizer
    from ..distributed.engine import ParallelTrainer
    from ..distributed.mesh import build_mesh, get_mesh
    from ..vision import models
    dev = _device(device)
    framework.seed(0)
    if smoke:
        model, batch, size = models.resnet18(), 4, 32
    else:
        model, batch, size = models.resnet50().bfloat16(), 128, 224
    dtype = torch.float32 if smoke else torch.bfloat16
    mesh = get_mesh() or build_mesh({"data": 1})
    trainer = ParallelTrainer(
        model, optimizer.Momentum(0.1, momentum=0.9),
        lambda o, y: nn.functional.cross_entropy(o, y), mesh=mesh,
        device=dev)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(batch, 3, size, size, generator=gen).to(dtype).to(dev)
    y = torch.randint(0, 1000, (batch,), generator=gen).to(dev)
    return trainer, x, y


BERT_SEQS = (128, 512)


def bert_config(smoke: bool) -> dict:
    """bench.py's BERT-base (vocab 30528), or the smoke widths."""
    from ..text.models import bert_base
    if smoke:
        return bert_base(vocab_size=256, hidden_size=64, num_layers=1,
                         num_heads=2)
    return bert_base(vocab_size=30528)


def build_bert(smoke: bool, device=None, seq: int = 128):
    """(trainer, ids, (mlm labels, nsp labels)) of bench.py's
    ``bert_base_amp`` step at ``seq`` positions."""
    from .. import framework, optimizer
    from ..distributed.engine import ParallelTrainer
    from ..distributed.mesh import build_mesh, get_mesh
    from ..testdata import recipes
    from ..text.models import BertForPretraining
    dev = _device(device)
    cfg = bert_config(smoke)
    batch = 2 if smoke else 16
    framework.seed(0)
    model = BertForPretraining(tensor_parallel=False, attn_dropout=0.0,
                               hidden_dropout=0.0, **cfg).bfloat16()
    mesh = get_mesh() or build_mesh({"data": 1})
    trainer = ParallelTrainer(model, optimizer.AdamW(1e-4),
                              lambda o, lb: model.loss(*o, *lb), mesh=mesh,
                              device=dev)
    ids, mlm, nsp = (torch.from_numpy(a).to(dev) for a in recipes.bert_data(
        0, batch, seq, cfg["vocab_size"]))
    return trainer, ids, (mlm, nsp)


def bert_params(cfg: dict) -> int:
    """``BertForPretraining``'s parameter count (the tied weight once):
    the embeddings and their LayerNorm, 12d^2 + 13d a layer, the pooler,
    the MLM transform and its LayerNorm, the decoder bias and the NSP
    head."""
    v, d, L = cfg["vocab_size"], cfg["hidden_size"], cfg["num_layers"]
    p = cfg["max_position_embeddings"]
    return (v * d + p * d + 2 * d + 2 * d + L * (12 * d * d + 13 * d)
            + 2 * (d * d + d) + 2 * d + v + 2 * d + 2)


def bert_matmul_terms(cfg: dict, n_params: int, batch: int, seq: int,
                      flash: bool) -> Dict[str, float]:
    """BERT pretraining's matmul FLOPs a step as 6NT + 6LSdT and the
    differences from it, term by term (their sum is what the traced step's
    ``cost.matmul_flops`` must give): the embeddings are lookups, the tied
    head multiplies every position by the (vocab, d) weight, biases and
    LayerNorms are no matmuls, the pooler and NSP head see one row a
    sequence, attention is bidirectional (12LSdT, where 6LSdT counts the
    causal half), and the flash backward recomputes the scores in dq and
    in dk/dv (6LSdT more)."""
    v, d, L = cfg["vocab_size"], cfg["hidden_size"], cfg["num_layers"]
    p, tokens = cfg["max_position_embeddings"], batch * seq
    emb = v * d + p * d + 2 * d
    matmul_w = L * 12 * d * d + d * d + d * d + 2 * d
    terms = {"6NT": 6 * n_params * tokens,
             "6LSdT": 6 * L * seq * d * tokens,
             "embeddings_are_lookups": -6 * emb * tokens,
             "tied_head_6VdT": 6 * v * d * tokens,
             "biases_and_layernorm": -6 * (n_params - emb - matmul_w)
             * tokens,
             "pooler_and_nsp_on_one_row": -6 * (d * d + 2 * d)
             * (tokens - batch),
             "bidirectional_6LSdT": 6 * L * seq * d * tokens}
    if flash:
        terms["flash_bwd_recompute_6LSdT"] = 6 * L * seq * d * tokens
    return terms


def _bert_run(smoke, device, top):
    from . import AnalysisConfig
    out = {}
    for seq in BERT_SEQS:
        trainer, ids, labels = build_bert(smoke, device, seq)
        _, rep = trainer.compile(ids, labels, analyze=True,
                                 config=AnalysisConfig(top_k=top))
        out[f"bert-s{seq}"] = (rep, rep.graph, trainer.mesh)
    return out


def _decode_step(smoke: bool, device=None):
    from ..inference import decode_model
    from ..inference.kv_cache import PagedKVCache
    dev = _device(device)
    heads, hd, rows, window = (2, 32, 2, 4) if smoke else (12, 64, 8, 8)
    params = decode_model.init_decode_model(
        vocab=128, num_heads=heads, head_dim=hd, max_len=1024, seed=0)
    cache = PagedKVCache(num_pages=64 if smoke else 2048, page_size=16,
                         num_heads=heads, head_dim=hd, device=dev)
    step = decode_model.make_step_fn(params, cache, device=dev)
    args = decode_model.executor_args(cache, rows=rows, tokens=window,
                                      width=8 if smoke else 64)
    return step, args


def decode_programs(smoke: bool, device=None) -> Dict[str, Callable]:
    """{member: zero-argument tracer} of the decode executors."""
    from ..inference import decode_model
    step, args = _decode_step(smoke, device)
    return decode_model.executor_family(step, args).members


def _trainer_family(smoke: bool, device=None):
    trainer, inputs, labels = build_gpt(smoke, device)
    return trainer.program_family(inputs, labels)


def _decode_family(smoke: bool, device=None):
    from ..inference import decode_model
    step, args = _decode_step(smoke, device)
    return decode_model.executor_family(step, args)


def verify_families(smoke: bool, device=None) -> Dict[str, dict]:
    """:func:`~.schedule.verify_family` over the trainer's and the decode
    router's families."""
    from .schedule import verify_family
    return {fam.name: verify_family(fam) for fam in
            (_trainer_family(smoke, device), _decode_family(smoke, device))}


def _trainer_program(builder):
    def run(smoke, device, top):
        from . import AnalysisConfig
        trainer, inputs, labels = builder(smoke, device)
        _, rep = trainer.compile(inputs, labels, analyze=True,
                                 config=AnalysisConfig(top_k=top))
        return {"train-step": (rep, rep.graph, trainer.mesh)}
    return run


def _decode_run(smoke, device, top):
    from . import AnalysisConfig, analyze_graph
    out = {}
    for member, tracer in decode_programs(smoke, device).items():
        g = tracer()
        out[f"decode-{member}"] = (
            analyze_graph(g, config=AnalysisConfig(top_k=top)), g, None)
    return out


MODELS: Dict[str, Callable] = {
    "gpt": _trainer_program(build_gpt),
    "resnet": _trainer_program(build_resnet),
    "bert": _bert_run,
    "decode": _decode_run,
}


def lint_model(name: str, smoke: bool, top: int = 10, device=None) -> dict:
    """{program: (Report, graph, mesh)} of one model."""
    return MODELS[name](smoke, device, top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=tuple(MODELS) + ("all",),
                    default="all")
    ap.add_argument("--smoke", action="store_true",
                    help="small widths (the CPU tests' size)")
    ap.add_argument("--strict", action="store_true",
                    help="a warning fails the lint too")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--top", type=int, default=10,
                    help="rows of the most expensive nodes")
    ap.add_argument("--device", default=None,
                    help="cpu to build the programs on the CPU (default: "
                         "the card)")
    ap.add_argument("--dump-collectives", action="store_true",
                    help="print each program's collective schedule")
    args = ap.parse_args(argv)
    from .schedule import extract_schedule, format_schedule
    names = tuple(MODELS) if args.model == "all" else (args.model,)
    results, failed = {}, False
    for name in names:
        for prog, (rep, graph, mesh) in lint_model(
                name, args.smoke, args.top, args.device).items():
            bad = bool(rep.errors) or (args.strict and bool(rep.warnings))
            failed = failed or bad
            entry = {"report": rep.to_dict(), "failed": bad}
            if args.dump_collectives:
                entry["schedule"] = [s.to_dict() for s in
                                     extract_schedule(graph, mesh)]
            results[prog] = entry
            if not args.json:
                print(f"== {prog} ==")
                print(rep.to_text())
                if args.dump_collectives:
                    print(format_schedule(extract_schedule(graph, mesh)))
    fams = verify_families(args.smoke, args.device)
    failed = failed or not all(f["ok"] for f in fams.values())
    results["families"] = fams
    if not args.json:
        for name, f in fams.items():
            fps = ", ".join(f"{m}={fp[:12]}"
                            for m, fp in f["fingerprints"].items())
            print(f"== family {name}: {'ok' if f['ok'] else 'FAILED'} "
                  f"({fps})")
    if args.json:
        print(json.dumps(results, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
