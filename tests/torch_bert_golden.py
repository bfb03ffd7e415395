"""The BERT pretraining golden: the JAX package's losses for three
``AdamW(1e-4)`` steps of ``BertForPretraining`` at BERT-base widths (vocab
30528, hidden 768, 12 heads, FFN 3072, 512 positions), depth 2, float32,
dropout 0, through its ``ParallelTrainer`` with ``model.loss`` (masked-LM
cross entropy through ``ParallelCrossEntropy`` plus the NSP cross
entropy), which ``chip_smoke.py``'s ``text`` phase holds the port against
on the card.

``paddle_tpu_torch/testdata/bert_golden.json`` holds the configuration,
the weight and data recipes, the state names and shapes in ``state_dict``
order (the tied decoder weight appears once, as
``bert.embeddings.word_embeddings.weight``), the three losses
``train_step`` returns (before any update, then after 1 and 2) and the
global norm of the step-0 gradients. The recipes are
``paddle_tpu_torch/testdata/recipes.py``'s ``bert_weights`` (biases
zeros, LayerNorm weights ones, every 2-d weight normal(0, 0.02) from one
``RandomState(seed)`` in state order) and ``bert_data`` (bench.py's batch:
ids, MLM labels at every 8th position, NSP labels), batch 2 x 128.

Regenerate (CPU, about a minute)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_bert_golden.py
"""
from __future__ import annotations

import json
import os
import sys

from paddle_tpu_torch.testdata import recipes

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "bert_golden.json")

CONFIG = dict(vocab_size=30528, hidden_size=768, num_layers=2, num_heads=12,
              intermediate_size=3072, max_position_embeddings=512,
              attn_dropout=0.0, hidden_dropout=0.0)
BATCH, SEQ = 2, 128
SEED, DATA_SEED, STD = 0, 1, 0.02
LR = 1e-4
STEPS = 3


def build() -> dict:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.jit.functionalization import functional_call, state_of
    from paddle_tpu.text.models import BertForPretraining
    from tools._mesh_setup import data_mesh

    model = BertForPretraining(tensor_parallel=False, **CONFIG)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    w = recipes.bert_weights(names_shapes, SEED, STD)
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    ids, mlm, nsp = recipes.bert_data(DATA_SEED, BATCH, SEQ,
                                      CONFIG["vocab_size"])

    def loss_fn(outputs, labels):
        return model.loss(*outputs, *labels)

    params, buffers = state_of(model)
    grads = jax.jit(jax.grad(lambda p: loss_fn(functional_call(
        model, p, buffers, jnp.asarray(ids))[0], (mlm, nsp))))(params)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                               for g in jax.tree_util.tree_leaves(grads))))
    data_mesh(1)
    opt = paddle.optimizer.AdamW(LR, parameters=model.parameters())
    trainer = ParallelTrainer(model, opt, loss_fn)
    losses = []
    for i in range(STEPS):
        losses.append(float(trainer.train_step(ids, (mlm, nsp))))
        print(f"step {i}: loss {losses[-1]:.6f}", file=sys.stderr)
    return {
        "config": dict(CONFIG, dtype="float32", batch=BATCH, seq=SEQ),
        "optimizer": {"kind": "AdamW", "learning_rate": LR},
        "loss": "BertForPretraining.loss: masked-LM CE (mean over the "
                "labelled positions) + NSP CE",
        "recipe": {"weights": {"seed": SEED, "std": STD,
                               "order": "state_dict"},
                   "data": {"seed": DATA_SEED}},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "losses": losses,
        "step0_grad_norm": gnorm,
    }


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    fix = build()
    with open(FIXTURE, "w") as f:
        json.dump(fix, f, indent=1)
    print(f"wrote {FIXTURE}", file=sys.stderr)
