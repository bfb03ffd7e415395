"""The mixture-of-experts golden: the JAX package's ``MoELayer(768, 3072,
num_experts=8)`` on 2 x 8 tokens, which ``chip_smoke.py``'s ``experts``
phase holds the port against on the card (bar 1e-5, the reference test's).

``paddle_tpu_torch/testdata/moe_golden.json`` holds the config, the weight
and data recipes, the state names and shapes in ``state_dict`` order, the
output (float32, flat, row-major) and ``aux_loss``.

The recipes are ``paddle_tpu_torch/testdata/recipes.py``'s, which
``chip_smoke.py`` calls too. The weight recipe (:func:`weights`) walks the state in order with one
``np.random.RandomState(seed)``: ``gate.weight`` (768, 8) normal with std
``1/sqrt(768)`` (logits of order 1, so both choices carry weight);
``w1`` (8, 768, 3072) and ``w2`` (8, 3072, 768) normal with std
``1/sqrt(fan_in)`` (768, 3072); the biases ``b1``, ``b2`` normal with std
0.1. The tokens are ``randn(2, 8, 768)`` float32 from
``RandomState(data_seed)``.

Regenerate (CPU, under a minute)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_moe_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from paddle_tpu_torch.testdata import recipes

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "moe_golden.json")

CONFIG = {"d_model": 768, "d_hidden": 3072, "num_experts": 8,
          "capacity_factor": 2.0}
SHAPE = (2, 8, 768)
SEED, DATA_SEED = 0, 1


def weights(names_shapes, seed: int = SEED) -> dict:
    return recipes.moe_weights(names_shapes, seed)


def data(seed: int = DATA_SEED):
    return recipes.moe_tokens(seed, SHAPE)


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def build() -> dict:
    import jax.numpy as jnp

    from paddle_tpu.incubate import MoELayer

    layer = MoELayer(**CONFIG)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in layer.state_dict().items()]
    layer.set_state_dict({k: jnp.asarray(v) for k, v in
                          weights(names_shapes).items()})
    out = np.asarray(layer(jnp.asarray(data())), dtype=np.float32)
    return {
        "config": CONFIG, "tokens": list(SHAPE),
        "recipe": {
            "weights": {"seed": SEED, "order": "state_dict",
                        "rule": "gate.weight normal(0, 1/sqrt(shape[0])); "
                                "b1, b2 normal(0, 0.1); w1, w2 normal(0, "
                                "1/sqrt(shape[1]))"},
            "data": {"seed": DATA_SEED,
                     "rule": "randn(*tokens) float32"}},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "out": [float(v) for v in out.reshape(-1)],
        "aux_loss": float(layer.aux_loss),
    }


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    fix = build()
    with open(FIXTURE, "w") as f:
        json.dump(fix, f)
    print(f"wrote {FIXTURE}", file=sys.stderr)
