"""The ResNet-50 training golden: the JAX package's losses for three
``Momentum(1e-4, 0.9)`` steps of ``resnet50()`` at full width, float32,
64x64 images, batch 8, through its ``ParallelTrainer`` with
``cross_entropy``, which ``chip_smoke.py``'s ``vision`` phase holds the
port against on the card.

The configuration is chosen so that float32 can follow the trajectory.
Measured on the CPU (the port in float32 against itself in float64, loss
after each of three steps): at batch 2 with ``Momentum(0.1)`` the
float32 run is 14-57% off float64 after one step across the weight
scales tried (batch norm over the 8 values a channel of the last stage,
at 64x64, amplifies each rounding, and a step of 0.1 against gradients
of norm ~3e3 lands far into that); at batch 2 even lr 1e-4 drifts 4.1e-4
by the third step. Batch 8 with lr 1e-4 stays within 2.1e-5 at every step,
while the loss still falls ~6% over the three steps. So the golden takes
batch 8 and lr 1e-4; bench.py's configuration (batch 128, lr 0.1, bf16)
is the phase's main path, not its golden.

``paddle_tpu_torch/testdata/resnet_golden.json`` holds the weight and data
recipes, the state names and shapes in ``state_dict`` order, the three
losses ``train_step`` returns (before any update, then after 1 and 2),
the global norm of the step-0 gradients, and, for a few parameters, the
sum after the three updates and the L2 norm of the three updates.

The weight recipe (:func:`weights`) walks the state in order with one
``np.random.RandomState(seed)``: running means zeros and variances ones;
1-d parameters ones (batch-norm weights) or, named ``.bias``, zeros; a
convolution weight normal with std 1 (batch norm follows every
convolution, so its scale only sets the step's relative size); the
linear weight ``(in, out)`` normal with std 0.01. The data recipe draws
the images ``randn(batch, 3, 64, 64)`` float32, then the labels
``randint(0, 1000, (batch,))`` int32, from ``RandomState(data_seed)``.
Both recipes are ``paddle_tpu_torch/testdata/recipes.py``'s, which
``chip_smoke.py`` calls too; ``tests/test_torch_resnet.py`` rebuilds the port's state from the file's
recipe and checks its step-0 loss and gradient norm on the CPU. The
gradient norm holds to 2e-3, not 1e-4: in float32 the early layers'
gradients cancel over the batch norms downstream (the JAX package's
norm is 3.5e-4 off the float64 one, the port's 9.4e-4, measured on the
CPU); the update norms hold to 1e-2 (this file's own float32 value of
``bn1.weight``'s is 2.9e-3 off float64).

Regenerate (CPU, a few minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_resnet_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from paddle_tpu_torch.testdata import recipes

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "resnet_golden.json")

DEPTH, CLASSES = 50, 1000
BATCH, SIZE = 8, 64
SEED, DATA_SEED = 0, 1
LR, MOMENTUM = 1e-4, 0.9
CONV_STD, LINEAR_STD = 1.0, 0.01
STEPS = 3
TRACKED = ("conv1.weight", "bn1.weight", "layer1.0.conv1.weight",
           "layer3.5.bn3.bias", "layer4.2.conv3.weight", "fc.weight",
           "fc.bias")


def weights(names_shapes, seed: int = SEED) -> dict:
    """{name: float32 array} by the recipe, in the given order."""
    return recipes.resnet_weights(names_shapes, seed, CONV_STD, LINEAR_STD)


def data(seed: int = DATA_SEED, batch: int = BATCH, size: int = SIZE):
    return recipes.resnet_data(seed, batch, size, CLASSES)


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def build() -> dict:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.jit.functionalization import functional_call, state_of
    from paddle_tpu.vision.models import resnet50
    from tools._mesh_setup import data_mesh

    model = resnet50()
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    w = weights(names_shapes)
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    images, labels = data()
    ce = lambda o, y: nn.functional.cross_entropy(o, y)  # noqa: E731
    params, buffers = state_of(model)
    grads = jax.jit(jax.grad(lambda p: ce(functional_call(
        model, p, buffers, jnp.asarray(images))[0],
        jnp.asarray(labels))))(params)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                               for g in jax.tree_util.tree_leaves(grads))))
    data_mesh(1)
    opt = paddle.optimizer.Momentum(LR, momentum=MOMENTUM,
                                    parameters=model.parameters())
    trainer = ParallelTrainer(model, opt, ce)
    losses = []
    for i in range(STEPS):
        losses.append(float(trainer.train_step(images, labels)))
        print(f"step {i}: loss {losses[-1]:.6f}", file=sys.stderr)
    after = {k: np.asarray(trainer.state["params"][k]) for k in TRACKED}
    return {
        "config": {"model": f"resnet{DEPTH}", "num_classes": CLASSES,
                   "dtype": "float32", "batch": BATCH, "image": SIZE},
        "optimizer": {"kind": "Momentum", "learning_rate": LR,
                      "momentum": MOMENTUM},
        "loss": "cross_entropy (mean over the batch)",
        "recipe": {
            "weights": {"seed": SEED, "order": "state_dict",
                        "conv_std": CONV_STD, "linear_std": LINEAR_STD,
                        "rule": "._mean and .bias zeros; ._variance and "
                                "other 1-d ones; conv weights normal(0, "
                                f"{CONV_STD}); linear (in,out) normal(0, "
                                f"{LINEAR_STD})"},
            "data": {"seed": DATA_SEED,
                     "rule": "images randn(batch, 3, image, image) "
                             "float32, then labels randint(0, 1000, "
                             "(batch,)) int32"}},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "losses": losses,
        "step0_grad_norm": gnorm,
        "after": {k: {"sum": float(np.sum(v, dtype=np.float64)),
                      "update_norm": float(np.linalg.norm(
                          (v - w[k]).astype(np.float64)))}
                  for k, v in after.items()},
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
