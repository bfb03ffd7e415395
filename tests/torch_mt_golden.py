"""The machine-translation and PTB golden: the JAX package's numbers for
two models at published widths, which ``chip_smoke.py``'s ``mt`` phase
holds the port against on the card.

- **MT** (``"mt"``): ``TransformerModel`` at Transformer-base widths
  (Vaswani et al. 2017, Table 3 "base": d_model 512, 8 heads, d_ff 2048,
  a shared 37,000-token vocabulary, ``weight_sharing``), depth 2 + 2 of
  6 + 6, float32, dropout 0, batch 2 x 32 (``recipes.mt_data``, lengths
  16-32, pad 0). Three ``AdamW(1e-4, beta2 0.98, epsilon 1e-9)`` steps of
  its ``ParallelTrainer`` under the label-smoothed (epsilon 0.1)
  soft-label cross entropy, weighted by the non-pad target tokens; the
  step-0 gradient norm; then ``InferTransformerModel`` (beam 4,
  ``max_out_len`` 16, alpha 0.6) at the trained weights on the batch's
  sources: its ids and scores.
- **PTB** (``"ptb"``): the medium LSTM language model (Zaremba et al.
  2014: 2 layers of 650 units, 35 steps, batch 20, vocabulary 10,000;
  ``recipes.ptb_lm``), full width, float32, dropout 0, every weight
  uniform(-0.05, 0.05). Three ``SGD(1.0)`` steps under
  ``ClipGradByGlobalNorm(5.0)`` and the mean cross entropy; the step-0
  gradient norm.

Each part records its configuration, recipes, the state names and shapes
in ``state_dict`` order, the losses ``train_step`` returns (before any
update, then after 1 and 2) and the step-0 gradient norm.

Regenerate (CPU, a few minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_mt_golden.py
"""
from __future__ import annotations

import json
import os
import sys

from paddle_tpu_torch.testdata import recipes

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "mt_golden.json")

MT_CONFIG = dict(src_vocab_size=37000, trg_vocab_size=37000, max_length=256,
                 num_encoder_layers=2, num_decoder_layers=2, n_head=8,
                 d_model=512, d_inner_hid=2048, dropout=0.0,
                 weight_sharing=True, bos_id=0, eos_id=1)
MT_BATCH, MT_SEQ, MT_MIN_LEN = 2, 32, 16
MT_OPT = dict(learning_rate=1e-4, beta1=0.9, beta2=0.98, epsilon=1e-9)
EPS_LS = 0.1
BEAM = dict(beam_size=4, max_out_len=16, alpha=0.6)
PTB_CONFIG = dict(vocab=10000, hidden=650, layers=2)
PTB_BATCH, PTB_STEPS = 20, 35
PTB_LR, PTB_CLIP, PTB_SCALE = 1.0, 5.0, 0.05
SEED, DATA_SEED, STD = 0, 1, 0.02
STEPS = 3


def mt_loss(F, logits, label, vocab, eps=EPS_LS, pad=0):
    """Label-smoothed soft-label cross entropy, the mean over the target
    tokens that are not ``pad`` (``F``: the reference's functionals)."""
    import jax.numpy as jnp
    soft = F.label_smooth(F.one_hot(label, vocab), epsilon=eps)
    ce = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    w = (label != pad).astype(jnp.float32)
    return jnp.sum(ce * w) / jnp.sum(w)


def _grad_norm(grads):
    import jax
    import jax.numpy as jnp
    return float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree_util.tree_leaves(grads))))


def _train(paddle, model, opt, loss_fn, inputs, labels):
    """Step-0 gradient norm and ``STEPS`` trainer losses; the model holds
    the trained weights after."""
    import jax
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.jit.functionalization import functional_call, state_of

    params, buffers = state_of(model)
    grads = jax.jit(jax.grad(lambda p: loss_fn(functional_call(
        model, p, buffers, inputs)[0], labels)))(params)
    trainer = ParallelTrainer(model, opt, loss_fn)
    losses = []
    for i in range(STEPS):
        losses.append(float(trainer.train_step(inputs, labels)))
        print(f"step {i}: loss {losses[-1]:.6f}", file=sys.stderr)
    trainer.sync_to_model()
    return _grad_norm(grads), losses


def build_mt(paddle) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from paddle_tpu import nn
    from paddle_tpu.text.models import InferTransformerModel, TransformerModel

    model = TransformerModel(**MT_CONFIG)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    w = recipes.bert_weights(names_shapes, SEED, STD)
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    src, trg, lbl = recipes.mt_data(DATA_SEED, MT_BATCH, MT_SEQ,
                                    MT_CONFIG["src_vocab_size"], MT_MIN_LEN)

    class Wrap(nn.Layer):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, batch):
            return self.m(*batch)

    vocab = MT_CONFIG["trg_vocab_size"]
    gnorm, losses = _train(
        paddle, Wrap(model), paddle.optimizer.AdamW(
            parameters=model.parameters(), **MT_OPT),
        lambda out, lb: mt_loss(nn.functional, out, lb, vocab),
        (jnp.asarray(src), jnp.asarray(trg)), jnp.asarray(lbl))
    infer = InferTransformerModel(**MT_CONFIG, **BEAM)
    infer.set_state_dict(model.state_dict())
    infer.eval()
    ids, scores = infer(jnp.asarray(src))
    return {
        "config": dict(MT_CONFIG, dtype="float32", batch=MT_BATCH,
                       seq=MT_SEQ, min_len=MT_MIN_LEN),
        "source": "Vaswani et al. 2017, Attention Is All You Need, Table 3 "
                  "base (6 + 6 layers cut to 2 + 2)",
        "optimizer": dict(MT_OPT, kind="AdamW"),
        "loss": f"label-smoothed (epsilon {EPS_LS}) soft-label cross "
                "entropy, mean over the non-pad target tokens",
        "recipe": {"weights": {"seed": SEED, "std": STD,
                               "fn": "bert_weights", "order": "state_dict"},
                   "data": {"seed": DATA_SEED, "fn": "mt_data"}},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "losses": losses,
        "step0_grad_norm": gnorm,
        "beam": dict(BEAM, ids=np.asarray(ids).tolist(),
                     scores=np.asarray(scores).tolist()),
    }


def build_ptb(paddle) -> dict:
    import jax.numpy as jnp
    from paddle_tpu import nn

    model = recipes.ptb_lm(paddle, **PTB_CONFIG)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    w = recipes.ptb_weights(names_shapes, SEED, PTB_SCALE)
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    ids, nxt = recipes.ptb_data(DATA_SEED, PTB_BATCH, PTB_STEPS,
                                PTB_CONFIG["vocab"])

    def loss_fn(logits, label):
        return jnp.mean(nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), label.reshape(-1)))

    gnorm, losses = _train(
        paddle, model, paddle.optimizer.SGD(
            PTB_LR, parameters=model.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(PTB_CLIP)),
        loss_fn, jnp.asarray(ids), jnp.asarray(nxt))
    return {
        "config": dict(PTB_CONFIG, dtype="float32", batch=PTB_BATCH,
                       steps=PTB_STEPS, dropout=0.0),
        "source": "Zaremba et al. 2014, Recurrent Neural Network "
                  "Regularization, medium (dropout 0 here)",
        "optimizer": {"kind": "SGD", "learning_rate": PTB_LR,
                      "clip_global_norm": PTB_CLIP},
        "loss": "mean cross entropy over the batch's tokens",
        "recipe": {"weights": {"seed": SEED, "scale": PTB_SCALE,
                               "fn": "ptb_weights", "order": "state_dict"},
                   "data": {"seed": DATA_SEED, "fn": "ptb_data"}},
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
    import paddle_tpu as paddle
    from tools._mesh_setup import data_mesh
    data_mesh(1)
    fix = {"mt": build_mt(paddle), "ptb": build_ptb(paddle)}
    with open(FIXTURE, "w") as f:
        json.dump(fix, f, indent=1)
    print(f"wrote {FIXTURE}", file=sys.stderr)
