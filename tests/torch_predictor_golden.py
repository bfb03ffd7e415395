"""The Predictor golden fixture: what the JAX package's ``jit.save`` ->
``inference.create_predictor`` serves for GPT at GPT-base widths, cut to
depth 2, which ``chip_smoke.py`` holds the port's ``jit.save`` ->
``Predictor`` against on the card.

The served layer is :func:`reference_layer`'s: the trunk, then the tied
head on each row's last position only, so a row's answer is its 50304
next-token logits. Weights follow the training golden's recipe
(``tests/torch_gpt_train_golden.py``: every parameter in ``state_dict``
order from one ``RandomState(0)``; biases zeros, LayerNorm weights ones,
else normal(0, 0.02)); the two rows of ids are ``randint(0, vocab, (2,
1024))`` from ``RandomState(DATA_SEED)``. The artifact is exported with a
dynamic batch (``InputSpec([None, 1024], "int32")``).

``paddle_tpu_torch/testdata/predictor_golden.json`` keeps, per row, the
argmax, the gap between the two largest logits, the logsumexp (float64
over the float32 logits) and every ``STRIDE``-th logit: a few tens of KB,
where the whole answer would be 400 KB. ``tests/test_torch_jit_export.py``
holds the port's Predictor on the CPU against the file too.

Regenerate (CPU, about a minute)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_predictor_golden.py
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gpt_train_golden as train_golden  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "predictor_golden.json")

CONFIG = dict(train_golden.CONFIG)      # GPT-base widths, depth 2, fp32
ROWS, SEQ = 2, 1024
SEED, DATA_SEED = 0, 2
STRIDE = 97


def ids(vocab: int = CONFIG["vocab_size"], seed: int = DATA_SEED):
    rs = np.random.RandomState(seed)
    return rs.randint(0, vocab, (ROWS, SEQ)).astype(np.int32)


def summarize(logits: np.ndarray) -> dict:
    """The fixture's per-row summary of (rows, vocab) float32 logits."""
    logits = np.asarray(logits, np.float32)
    l64 = logits.astype(np.float64)
    m = l64.max(axis=1, keepdims=True)
    lse = (m[:, 0] + np.log(np.exp(l64 - m).sum(axis=1)))
    top2 = np.sort(logits, axis=1)[:, -2:]
    return {"argmax": [int(i) for i in logits.argmax(axis=1)],
            "top2_gap": [float(g) for g in top2[:, 1] - top2[:, 0]],
            "logsumexp": [float(v) for v in lse],
            "stride": STRIDE,
            "strided": [[float(v) for v in row[::STRIDE]]
                        for row in logits]}


def reference_layer():
    """The JAX package's served layer at CONFIG with the recipe's weights,
    and its (name, shape) list in state_dict order."""
    from paddle_tpu import nn
    from paddle_tpu.text.models import GPTForPretraining

    class LastLogits(nn.Layer):
        def __init__(self):
            super().__init__()
            self.model = GPTForPretraining(tensor_parallel=False, **CONFIG)

        def forward(self, input_ids):
            h = self.model.gpt(input_ids)
            return self.model.lm_head(h[:, -1, :])

    layer = LastLogits()
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in layer.state_dict().items()]
    layer.set_state_dict(train_golden.weights(names_shapes, SEED))
    return layer, names_shapes


def reference_serve(layer, prefix: str, x: np.ndarray) -> np.ndarray:
    """The reference's save -> create_predictor -> run on ``x``."""
    import paddle_tpu as paddle
    from paddle_tpu.jit import InputSpec

    paddle.jit.save(layer, prefix,
                    input_spec=[InputSpec([None, SEQ], "int32")])
    pred = paddle.inference.create_predictor(
        paddle.inference.Config(prefix))
    return np.asarray(pred.run([x])[0])


def build() -> dict:
    layer, names_shapes = reference_layer()
    x = ids()
    with tempfile.TemporaryDirectory() as d:
        logits = reference_serve(layer, os.path.join(d, "model"), x)
    return {
        "config": CONFIG, "rows": ROWS, "seq": SEQ,
        "served": "trunk, then the tied head on each row's last position",
        "recipe": {"weights": {"seed": SEED, "order": "state_dict",
                               "rule": "as gpt_train_golden.json"},
                   "ids": {"seed": DATA_SEED,
                           "rule": "randint(0, vocab, (rows, seq)) int32"}},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "input_spec": [[None, SEQ], "int32"],
        **summarize(logits),
    }


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


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
    print(f"wrote {FIXTURE}: argmax {fix['argmax']}, gap {fix['top2_gap']}",
          file=sys.stderr)
