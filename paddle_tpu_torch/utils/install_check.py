"""Installation self-check (port of ``paddle_tpu/utils/install_check.py``;
reference python/paddle/utils/install_check.py run_check:162: builds a
tiny linear network, runs a forward and backward step and prints a
verdict).

The step runs on the card by default (``device="cpu"`` to check the CPU),
through ``ParallelTrainer``, as the reference's does.
"""
from __future__ import annotations

__all__ = ["run_check"]


def _simple_network():
    from .. import nn

    class _Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 8)
            self.out = nn.Linear(8, 1)

        def forward(self, x):
            return self.out(nn.functional.relu(self.fc(x)))

    return _Net()


def run_check(device=None):
    """Train the simple network one step on ``device`` (the card when
    None; no card raises) and print the verdict. Returns the loss."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from .. import nn
    from .._device import resolve_device
    from ..distributed.engine import ParallelTrainer

    dev = resolve_device(device)
    print(f"Running verify paddle_tpu_torch ({paddle.__version__}) ...")
    paddle.seed(0)
    model = _simple_network()
    opt = paddle.optimizer.SGD(0.1, parameters=model.parameters())
    trainer = ParallelTrainer(model, opt,
                              lambda out, y: nn.functional.mse_loss(out, y),
                              device=dev)
    x = np.random.RandomState(0).rand(2, 4).astype("float32")
    y = np.zeros((2, 1), dtype="float32")
    loss = float(trainer.train_step(x, y))
    kind = "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
    print(f"paddle_tpu_torch works on 1 {kind} device: loss={loss:.4f}")
    print("paddle_tpu_torch is installed successfully!")
    return loss
