"""The hapi golden: the JAX package's ``Model.fit`` of LeNet, which
``chip_smoke.py``'s ``hapi`` phase (a3) holds the port's fit on the card
against, and ``tests/test_torch_hapi.py`` the port's fit on the CPU.

The recipe is ``chip_smoke.HAPI_LENET``: ``LeNet()`` (61,610 parameters)
on ``recipes.zoo_weights`` of seed 0, ``Momentum(1e-2, 0.9)``,
``CrossEntropyLoss``, ``Accuracy(topk=(1, 5))``; two epochs at batch 32 of
``chip_smoke.hapi_easy_data``'s 256 samples (``FakeData`` with the label
drawn into the image), shuffled from ``np.random.seed(0)``, with the eval
set (64 samples of seed 999) evaluated after each epoch. The file records
the recipe, the state names and shapes, the 16 per-batch losses (float32
on the CPU) and ``evaluate``'s loss and accuracies after the fit.

Regenerate (CPU, about 10 seconds)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_hapi_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch", "testdata",
    "hapi_golden.json")


def build():
    import paddle_tpu as paddle
    from paddle_tpu.nn import initializer as rinit
    from paddle_tpu.vision.datasets import FakeData
    from paddle_tpu.vision.models import LeNet

    import chip_smoke
    from paddle_tpu_torch.testdata import recipes
    cfg = chip_smoke.HAPI_LENET
    rinit.set_global_initializer(rinit.Constant(0.0), rinit.Constant(0.0))
    try:
        net = LeNet()
    finally:
        rinit.set_global_initializer(None)
    names_shapes = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    net.set_state_dict(recipes.zoo_weights(names_shapes,
                                           cfg["weights_seed"]))

    class Losses(paddle.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

    easy = chip_smoke.hapi_easy_data(FakeData)
    cbs = paddle.hapi.callbacks
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(
        cfg["lr"], momentum=cfg["momentum"], parameters=net.parameters()),
        paddle.nn.CrossEntropyLoss(),
        paddle.metric.Accuracy(topk=tuple(cfg["topk"])))
    eval_ds = easy(size=cfg["eval_size"], seed=cfg["eval_seed"])
    rec = Losses()
    np.random.seed(cfg["shuffle_seed"])
    model.fit(easy(size=cfg["train_size"]), eval_data=eval_ds,
              batch_size=cfg["batch"], epochs=cfg["epochs"], verbose=0,
              callbacks=[rec, cbs.EarlyStopping(
                  monitor="acc_top1", patience=2, verbose=0,
                  save_best_model=False)])
    ev = model.evaluate(eval_ds, batch_size=cfg["batch"], verbose=0)
    return {"recipe": cfg,
            "names_shapes": [[n, list(s)] for n, s in names_shapes],
            "losses": rec.losses,
            "eval": {k: float(v) for k, v in ev.items()}}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    fix = build()
    with open(FIXTURE, "w") as f:
        json.dump(fix, f, indent=1)
    print(f"wrote {FIXTURE}", file=sys.stderr)
