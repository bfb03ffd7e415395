"""The golden training fixture: the JAX package's losses for a few AdamW
steps of GPT at GPT-base widths, cut to depth 2, which ``chip_smoke.py``
holds the port against on the card.

``paddle_tpu_torch/testdata/gpt_train_golden.json`` holds the config, the
weight and data recipes, the parameter names and shapes in ``state_dict``
order, the four losses that four ``ParallelTrainer.train_step`` calls
return on one fixed batch (the loss before any update, then after 1, 2 and
3 updates) and the global norm of the step-0 gradients.

The weight recipe draws every parameter in ``state_dict`` order from one
``np.random.RandomState(seed)``: normal(0, 0.02) for matrices and
embeddings, zeros for biases, ones for LayerNorm weights. The data recipe
draws ids, then labels, as ``randint(0, vocab, (batch, seq))`` from
``RandomState(data_seed)``. ``chip_smoke.py`` keeps its own copy of both
recipes; ``tests/test_torch_gpt_train.py`` recomputes the step-0 loss with
the JAX package and with the port on the CPU, so the file cannot drift
from the reference.

Regenerate (CPU, a few minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_gpt_train_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "gpt_train_golden.json")

# GPT-base widths (bench.py's GPT-base: vocab 50304, hidden 768, 12 heads,
# 1024 positions), depth cut from 12 to 2; fp32, no dropout
CONFIG = {"vocab_size": 50304, "hidden_size": 768, "num_layers": 2,
          "num_heads": 12, "max_position_embeddings": 1024,
          "attn_dropout": 0.0, "hidden_dropout": 0.0}
BATCH, SEQ = 2, 1024
SEED, DATA_SEED = 0, 1
LR, WEIGHT_DECAY = 3e-4, 0.01
CHUNK = 8192
N_CALLS = 4      # train_step calls: losses before and after 1, 2, 3 updates


def recipe_kind(name: str, shape) -> str:
    if name.endswith(".bias"):
        return "zeros"
    if len(shape) == 1:
        return "ones"       # LayerNorm weights
    return "normal"


def weights(names_shapes, seed: int = SEED) -> dict:
    """{name: float32 array} drawn in the given (state_dict) order."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        kind = recipe_kind(name, shape)
        if kind == "zeros":
            out[name] = np.zeros(shape, np.float32)
        elif kind == "ones":
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = rs.normal(0.0, 0.02, shape).astype(np.float32)
    return out


def data(vocab: int = CONFIG["vocab_size"], seed: int = DATA_SEED):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    return ids, labels


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def reference_model():
    """The JAX package's GPTForPretraining at CONFIG with the recipe's
    weights, and its (name, shape) list."""
    from paddle_tpu.text.models import GPTForPretraining
    model = GPTForPretraining(tensor_parallel=False, **CONFIG)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    model.set_state_dict(weights(names_shapes))
    return model, names_shapes


def reference_fused_loss(model):
    """(ids, labels) -> loss Layer around ``fused_head_loss``, as bench.py
    wraps the model for ParallelTrainer."""
    from paddle_tpu import nn

    class FusedLoss(nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, chunk=CHUNK,
                                              ce_kernel="chunked")

    return FusedLoss(model)


def reference_step0_loss() -> float:
    """The reference's step-0 loss, forward only."""
    import jax

    from paddle_tpu.jit.functionalization import functional_call, state_of
    model, _ = reference_model()
    wrapped = reference_fused_loss(model)
    params, buffers = state_of(wrapped)
    loss = jax.jit(lambda p, b: functional_call(wrapped, p, b, data())[0])(
        params, buffers)
    return float(loss)


def build() -> dict:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.jit.functionalization import functional_call, state_of
    from tools._mesh_setup import data_mesh

    model, names_shapes = reference_model()
    wrapped = reference_fused_loss(model)
    batch = data()
    params, buffers = state_of(wrapped)
    grads = jax.jit(jax.grad(
        lambda p: functional_call(wrapped, p, buffers, batch)[0]))(params)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                               for g in jax.tree_util.tree_leaves(grads))))
    data_mesh(1)
    opt = paddle.optimizer.AdamW(LR, parameters=model.parameters(),
                                 weight_decay=WEIGHT_DECAY)
    trainer = ParallelTrainer(wrapped, opt, lambda out, _lbl: out)
    losses = []
    for i in range(N_CALLS):
        losses.append(float(trainer.train_step(batch, 0.0)))
        print(f"call {i}: loss {losses[-1]:.6f}", file=sys.stderr)
    return {
        "config": CONFIG, "batch": BATCH, "seq": SEQ,
        "optimizer": {"kind": "AdamW", "learning_rate": LR,
                      "weight_decay": WEIGHT_DECAY, "beta1": 0.9,
                      "beta2": 0.999, "epsilon": 1e-8},
        "loss": {"fused_head_loss_chunk": CHUNK, "ce_kernel": "chunked"},
        "recipe": {
            "weights": {"seed": SEED, "order": "state_dict",
                        "normal_std": 0.02,
                        "rule": "name ends with .bias: zeros; 1-d: ones "
                                "(LayerNorm weights); else normal(0, 0.02)"},
            "data": {"seed": DATA_SEED,
                     "rule": "ids then labels, each randint(0, vocab, "
                             "(batch, seq)) int32"}},
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
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(fix, f, indent=1)
    print(f"wrote {FIXTURE}", file=sys.stderr)
