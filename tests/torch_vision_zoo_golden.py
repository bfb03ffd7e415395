"""The vision zoo's training golden and the detection ops' summaries: the
JAX package's numbers, which ``chip_smoke.py``'s ``vision`` phase holds
the port against on the card (sub-phases v3 and v6).

For each model (``mobilenet_v2()`` at full width, Sandler et al. 2018,
3,504,872 parameters with 1000 classes; ``vgg16()``, Simonyan &
Zisserman 2015 configuration D, 138,357,544 parameters; ``LeNet()``,
61,610 parameters) the file records:

- the state names and shapes in ``state_dict`` order;
- three losses of ``Momentum(1e-4, 0.9)`` through the reference's
  ``ParallelTrainer`` with ``cross_entropy`` (before any update, then
  after 1 and 2), in float32, every ``Dropout`` at p 0 (its mask would
  differ between the packages' generators);
- the global norm of the step-0 gradients;
- for a few parameters, the sum after the three updates and the L2 norm
  of the three updates.

Batch 8 at 64x64 (LeNet at 1x28x28), as the ResNet golden takes for
batch norm's conditioning (ROADMAP "Oracle caveats";
``tests/torch_resnet_golden.py``). The weights are
``recipes.zoo_weights`` (float32 normal draws of ``default_rng(0)``,
He's std for the convolutions, ``sqrt(1/in)`` for the linear weights,
batch norm at ones and zeros), the data ``recipes.zoo_data``.

The detection summaries are of the reference's ops on
``recipes.detection_inputs`` at the card's shapes: ``deform_conv2d``
(forward), ``yolo_box`` (its scores; the reference's boxes are
scrambled, ROADMAP "Oracle caveats"), ``yolo_loss`` (forward) and
``nms`` (the kept indices). Each tensor is summarized by its shape, sum,
sum of absolute values and a strided sample of 64 values. ``roi_align``
at its card shape is not in the file: the reference copies the feature
map of every RoI's image first (1024 x 256 x 200 x 272 float32, 57 GB),
which this CPU cannot hold; ``generate_proposals`` and
``multiclass_nms`` are held on the card against the port's CPU run only.

Regenerate (CPU, about 3 minutes)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_vision_zoo_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from paddle_tpu_torch.testdata import recipes

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "vision_zoo_golden.json")

SEED, DATA_SEED = 0, 1
LR, MOMENTUM = 1e-4, 0.9
STEPS = 3
CONV_GAIN, LINEAR_GAIN = 2.0, 1.0
MODELS = {
    # name: (constructor, batch, channels, image, classes, tracked params)
    "mobilenet_v2": ("mobilenet_v2", 8, 3, 64, 1000,
                     ("features.0.conv.weight", "features.0.bn.weight",
                      "features.9.conv.1.conv.weight",
                      "features.18.bn.bias", "classifier.1.weight",
                      "classifier.1.bias")),
    "vgg16": ("vgg16", 8, 3, 64, 1000,
              ("features.0.weight", "features.0.bias", "features.14.weight",
               "features.28.weight", "classifier.0.weight",
               "classifier.6.bias")),
    "lenet": ("LeNet", 8, 1, 28, 10,
              ("features.0.weight", "features.3.bias", "fc.0.weight",
               "fc.2.weight", "fc.2.bias")),
}
SAMPLES = 64


def weights(names_shapes, seed: int = SEED) -> dict:
    return recipes.zoo_weights(names_shapes, seed, CONV_GAIN, LINEAR_GAIN)


def data(name, seed: int = DATA_SEED, batch=None):
    _, b, c, size, classes, _ = MODELS[name]
    return recipes.zoo_data(seed, batch or b, c, size, classes)


def summary(a) -> dict:
    a = np.asarray(a)
    flat = a.reshape(-1).astype(np.float64)
    stride = max(1, flat.size // SAMPLES)
    return {"shape": list(a.shape), "sum": float(flat.sum()),
            "abs_sum": float(np.abs(flat).sum()),
            "stride": stride, "sample": flat[::stride][:SAMPLES].tolist()}


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def _train(name) -> dict:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.distributed.engine import ParallelTrainer
    from paddle_tpu.jit.functionalization import functional_call, state_of
    from paddle_tpu.vision import models
    from tools._mesh_setup import data_mesh

    ctor, batch, channels, size, classes, tracked = MODELS[name]
    model = getattr(models, ctor)(num_classes=classes)
    recipes.no_dropout(model)
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in model.state_dict().items()]
    w = weights(names_shapes)
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    images, labels = data(name)
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
        print(f"{name} step {i}: loss {losses[-1]:.6f}", file=sys.stderr)
    after = {k: np.asarray(trainer.state["params"][k]) for k in tracked}
    n_params = int(sum(np.prod(v.shape) for v in params.values()))
    return {
        "config": {"constructor": ctor, "num_classes": classes,
                   "dtype": "float32", "batch": batch, "channels": channels,
                   "image": size, "parameters": n_params},
        "names_shapes": [[n, list(s)] for n, s in names_shapes],
        "losses": losses,
        "step0_grad_norm": gnorm,
        "after": {k: {"sum": float(np.sum(v, dtype=np.float64)),
                      "update_norm": float(np.linalg.norm(
                          (v - w[k]).astype(np.float64)))}
                  for k, v in after.items()},
    }


def _ops() -> dict:
    import jax
    import jax.numpy as jnp

    from paddle_tpu.vision import ops as R
    out = {}
    d = recipes.detection_inputs("deform_conv2d")
    out["deform_conv2d"] = summary(jax.jit(
        lambda x, o, m, w, b: R.deform_conv2d(x, o, w, b, padding=1,
                                              mask=m))(
        *(jnp.asarray(d[k]) for k in ("x", "offset", "mask", "weight",
                                       "bias"))))
    d = recipes.detection_inputs("yolo_box")
    anchors = [d["anchors"][2 * i + j] for i in d["anchor_mask"]
               for j in (0, 1)]
    _, scores = jax.jit(lambda x, s: R.yolo_box(
        x, s, anchors, d["class_num"], d["conf_thresh"],
        d["downsample_ratio"]))(jnp.asarray(d["x"]),
                                jnp.asarray(d["img_size"]))
    out["yolo_box_scores"] = summary(scores)
    d = recipes.detection_inputs("yolo_loss")
    out["yolo_loss"] = summary(jax.jit(lambda x, g, lb: R.yolo_loss(
        x, g, lb, d["anchors"], d["anchor_mask"], d["class_num"],
        d["ignore_thresh"], d["downsample_ratio"]))(
        jnp.asarray(d["x"]), jnp.asarray(d["gt_box"]),
        jnp.asarray(d["gt_label"])))
    d = recipes.detection_inputs("nms")
    keep = np.asarray(R.nms(d["boxes"], d["iou_threshold"],
                            scores=d["scores"]))
    out["nms"] = {"kept": int(keep.size), "indices": keep.tolist()}
    return out


def build() -> dict:
    from paddle_tpu.nn import initializer as I
    # the recipe overwrites every weight: skip the initializers' draws
    I.set_global_initializer(I.Constant(0.0), I.Constant(0.0))
    try:
        models = {name: _train(name) for name in MODELS}
    finally:
        I.set_global_initializer(None)
    return {
        "optimizer": {"kind": "Momentum", "learning_rate": LR,
                      "momentum": MOMENTUM},
        "loss": "cross_entropy (mean over the batch)",
        "recipe": {"weights": {"seed": SEED, "order": "state_dict",
                               "conv_gain": CONV_GAIN,
                               "linear_gain": LINEAR_GAIN,
                               "fn": "recipes.zoo_weights"},
                   "data": {"seed": DATA_SEED, "fn": "recipes.zoo_data"},
                   "dropout": "every Dropout at p 0 (recipes.no_dropout)"},
        "models": models,
        "ops": {"inputs": "recipes.detection_inputs(op, seed=0)",
                **_ops()},
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
