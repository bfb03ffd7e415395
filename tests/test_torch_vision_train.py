"""Two ``Momentum(1e-2, 0.9)`` steps of the port's LeNet through its
``ParallelTrainer`` against the JAX package's trainer, and VGG's forward
and backward against the reference's, on the CPU.

The models, weights and data are ``test_torch_vision_models.py``'s (the
narrow widths, ``recipes.zoo_weights``, every ``Dropout`` at p 0), batch
4. LeNet's losses hold within rtol 1e-4 at step 0 and 1e-3 after (the
ResNet tests' bars); the loss moves, and no step is skipped. VGG (a
short cfg with batch norm; its classifier is 102M weights whatever the
cfg, the costly build, so it has a file of its own beside the other
families' checks) is held by ``test_torch_vision_models.py``'s check.

The training of the MobileNets and of VGG against the reference's
trainer is held by their goldens (``vision_zoo_golden.json``, the
reference trainer's losses at batch 8, 64x64, where float32 follows the
trajectory): MobileNetV2's step-0 loss and gradient norm on the CPU
(``test_torch_vision_models.py``) and three steps of MobileNetV2, VGG-16
and LeNet on the card (``chip_smoke.py``, vision v3). At the batches
this CPU affords a step in seconds, the MobileNets' batch norms over a
few values a channel put float32 trajectories 6% apart after one step
(measured, MobileNetV1 at 4 x 32x32), and the reference's trainer over
VGG's classifier took 37 s of this file under six test workers.
"""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh

from paddle_tpu_torch import nn, optimizer as optim
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer

import test_torch_vision_models as models
from test_torch_vision_models import _two_threads  # noqa: F401 (autouse)

LR, STEPS = 1e-2, 2


def test_vgg_forward_and_backward_match_the_reference():
    models.check_forward_and_backward("vgg_bn", *models.pair("vgg_bn")[:2])


def test_lenet_trainer_steps_match_the_reference():
    rm, pm, _ = models.pair("lenet")
    x, y = models.data("lenet")
    rtr = RefTrainer(rm, paddle.optimizer.Momentum(
        LR, momentum=0.9, parameters=rm.parameters()),
        lambda o, t: rnn.functional.cross_entropy(o, t),
        mesh=ref_build_mesh({"data": 1}))
    want = [float(rtr.train_step(x, y)) for _ in range(STEPS)]
    ptr = ParallelTrainer(pm, optim.Momentum(LR, momentum=0.9),
                          lambda o, t: nn.functional.cross_entropy(o, t),
                          mesh=mesh_mod.build_mesh({"data": 1}),
                          device="cpu")
    got = [float(ptr.train_step(x, y.astype(np.int64)))
           for _ in range(STEPS)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    assert got[-1] != got[0] and ptr.skipped_steps() == 0
