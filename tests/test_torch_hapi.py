"""The port's ``hapi.Model`` and callbacks against the JAX package's, on
the CPU (``summary`` and ``flops``: ``test_torch_hapi_summary.py``).

- The reference's ``test_lenet_fit_learns`` setting cut to 2 epochs x 4
  batches (Adam, ``FakeData`` with the label drawn into the image,
  shuffled from one ``np.random.seed``), LeNet on the same weights
  (``recipes.zoo_weights``) in both: the per-batch losses within 1e-5
  (float32), ``evaluate``'s accuracy equal and its loss within 1e-5,
  ``predict(stack_outputs=True)`` within 1e-5 of the largest output.
- ``.pdparams``/``.pdopt`` (an MLP under Adam) saved by one package and
  loaded by the other, then 3 more steps: the losses within 1e-5 of the
  saving package's own continued run, both ways.
- The callbacks on a small MLP: ``LRScheduler`` (by step and by epoch)
  gives the reference's learning rates, ``EarlyStopping`` stops after the
  same epoch, ``ModelCheckpoint`` writes the same files (their weights
  within 1e-5), the losses equal; ``TelemetryCallback``, ``VisualDL`` and
  ``ProgBarLogger`` report each step.
- ``Model`` without a card raises; ``amp_configs`` O1/O2 run the forward
  in bfloat16.
- The card phase's LeNet fit (``chip_smoke.hapi_lenet_fit``) on the CPU
  against ``hapi_golden.json`` (the reference's fit), and the bar of its
  GPT comparison (``chip_smoke.HAPI_LOSS_RTOL``): ``Model.fit`` against
  the trainer at depth 2, bf16, narrow widths.

Both packages' LeNets are built with constant initializers (the recipe
overwrites every weight): the reference's random initializers take
seconds a model on this CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.nn import initializer as rinit
from paddle_tpu.text.models import gpt_tiny
from paddle_tpu.vision.datasets import FakeData as RFakeData
from paddle_tpu.vision.models import LeNet as RLeNet

import chip_smoke
import paddle_tpu_torch as port
from paddle_tpu_torch import framework, telemetry
from paddle_tpu_torch.distributed import engine
from paddle_tpu_torch.testdata import recipes
from paddle_tpu_torch.text.models import GPTForPretraining
from paddle_tpu_torch.vision.datasets import FakeData as PFakeData
from paddle_tpu_torch.vision.models import LeNet as PLeNet
from torch_threads import two_threads  # noqa: F401

TOL = 1e-5
REasy = chip_smoke.hapi_easy_data(RFakeData)
PEasy = chip_smoke.hapi_easy_data(PFakeData)


def _lenets():
    """(reference LeNet, port LeNet) on recipes.zoo_weights(seed 0)."""
    rinit.set_global_initializer(rinit.Constant(0.0), rinit.Constant(0.0))
    try:
        rm = RLeNet()
    finally:
        rinit.set_global_initializer(None)
    w = recipes.zoo_weights([(k, tuple(v.shape))
                             for k, v in rm.state_dict().items()], 0)
    rm.set_state_dict(w)
    pm = PLeNet()
    pm.set_state_dict_from_numpy(w)
    return rm, pm


def _mlps(seed=0):
    rs = np.random.RandomState(seed)
    rm = ref.nn.Sequential(ref.nn.Flatten(), ref.nn.Linear(16, 32),
                           ref.nn.ReLU(), ref.nn.Linear(32, 4))
    pm = port.nn.Sequential(port.nn.Flatten(), port.nn.Linear(16, 32),
                            port.nn.ReLU(), port.nn.Linear(32, 4))
    w = {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
         for k, v in rm.state_dict().items()}
    rm.set_state_dict(w)
    pm.set_state_dict_from_numpy(w)
    return rm, pm


def _recorder(cbs):
    class Rec(cbs.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.lrs, self.epochs = [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(float(self.model._optimizer.get_lr()))

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
    return Rec()


def test_lenet_fit_evaluate_predict_match_the_reference():
    rm, pm = _lenets()
    rmod = ref.Model(rm)
    rmod.prepare(ref.optimizer.Adam(1e-3, parameters=rm.parameters()),
                 ref.nn.CrossEntropyLoss(), ref.metric.Accuracy())
    pmod = port.Model(pm, device="cpu")
    pmod.prepare(port.optimizer.Adam(1e-3), port.nn.CrossEntropyLoss(),
                 port.metric.Accuracy())
    rrec, prec = _recorder(ref.hapi.callbacks), _recorder(port.hapi.callbacks)
    for mod, easy, rec in ((rmod, REasy, rrec), (pmod, PEasy, prec)):
        np.random.seed(5)
        mod.fit(easy(size=128), epochs=2, batch_size=32, verbose=0,
                callbacks=[rec])
    assert len(prec.losses) == 8 and prec.losses[-1] < prec.losses[0]
    np.testing.assert_allclose(prec.losses, rrec.losses, rtol=TOL)
    rev = rmod.evaluate(REasy(size=64, seed=999), batch_size=32, verbose=0)
    pev = pmod.evaluate(PEasy(size=64, seed=999), batch_size=32, verbose=0)
    assert pev.keys() == rev.keys() and pev["acc"] == rev["acc"]
    np.testing.assert_allclose(pev["loss"], rev["loss"], rtol=TOL)
    x = np.stack([REasy(size=8, seed=7)[i][0] for i in range(8)])
    rp = rmod.predict([x], stack_outputs=True)[0]
    pp = pmod.predict([torch.from_numpy(x)], stack_outputs=True)[0]
    assert pp.shape == rp.shape == (8, 10)
    assert np.abs(pp - rp).max() <= TOL * np.abs(rp).max()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_files_cross_packages(direction, tmp_path):
    """The saving package trains the MLP 4 steps of Adam, saves, and runs
    3 more; the other package loads the files into an MLP of other
    weights and runs the same 3 steps."""
    (rm, pm), (rm2, pm2) = _mlps(0), _mlps(1)
    rs = np.random.RandomState(3)
    data = [(rs.randn(16, 16).astype(np.float32),
             rs.randint(0, 4, 16).astype(np.int64)) for _ in range(7)]
    path = str(tmp_path / "ckpt" / "mlp")

    def model(pkg, net):
        if pkg is ref:
            m = ref.Model(net)
            m.prepare(ref.optimizer.Adam(1e-2, parameters=net.parameters()),
                      ref.nn.CrossEntropyLoss())
        else:
            m = port.Model(net, device="cpu")
            m.prepare(port.optimizer.Adam(1e-2), port.nn.CrossEntropyLoss())
        return m

    if direction == "ref_to_port":
        src, dst = model(ref, rm), model(port, pm2)
    else:
        src, dst = model(port, pm), model(ref, rm2)
    for x, y in data[:4]:
        src.train_batch([x], [y])
    src.save(path)
    dst.load(path)
    want = [src.train_batch([x], [y])[0] for x, y in data[4:]]
    got = [dst.train_batch([x], [y])[0] for x, y in data[4:]]
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert int(np.asarray(dst._optimizer_state_for_save()["state"]["step"])) \
        == 7
    for ext in ("pdparams", "pdopt"):
        assert os.path.exists(f"{path}.{ext}")


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_callbacks_match_the_reference(by, tmp_path):
    rm, pm = _mlps()
    rs = np.random.RandomState(0)
    x = rs.randn(48, 16).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64) * 3
    out = {}
    for pkg, net in ((ref, rm), (port, pm)):
        sched = pkg.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = (pkg.optimizer.SGD(sched, parameters=net.parameters())
               if pkg is ref else pkg.optimizer.SGD(sched))
        mod = pkg.Model(net) if pkg is ref else pkg.Model(net, device="cpu")
        mod.prepare(opt, pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        cbs = pkg.hapi.callbacks
        rec = _recorder(cbs)
        lr_cb = cbs.LRScheduler(by_step=by == "step", by_epoch=by == "epoch")
        save_dir = str(tmp_path / pkg.__name__)
        ds = pkg.io.TensorDataset([x, y])
        mod.fit(ds, eval_data=ds, batch_size=16, epochs=3, shuffle=False,
                verbose=0, save_dir=save_dir,
                callbacks=[rec, lr_cb, cbs.EarlyStopping(
                    monitor="acc", patience=0, verbose=0)])
        out[pkg.__name__] = (rec, sorted(os.listdir(save_dir)), mod,
                             save_dir)
    (rrec, rfiles, rmod, rdir), (prec, pfiles, pmod, pdir) = \
        out["paddle_tpu"], out["paddle_tpu_torch"]
    assert prec.lrs == rrec.lrs and len(set(prec.lrs)) > 1
    assert prec.epochs == rrec.epochs
    assert pmod.stop_training == rmod.stop_training
    np.testing.assert_allclose(prec.losses, rrec.losses, rtol=TOL)
    assert pfiles == rfiles and "final.pdparams" in pfiles
    rw = ref.load(os.path.join(rdir, "final.pdparams"))
    pw = port.load(os.path.join(pdir, "final.pdparams"))
    assert rw.keys() == pw.keys()
    for k in rw:
        np.testing.assert_allclose(pw[k], np.asarray(rw[k]), rtol=TOL,
                                   atol=TOL)


def test_early_stopping_stops_when_the_loss_stalls():
    """The reference's test_early_stopping_and_checkpoint: lr 0, the
    monitored loss never improves, patience 0 stops after the second
    evaluation in both packages."""
    rm, pm = _mlps()
    x = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    y = np.zeros(32, np.int64)
    epochs = {}
    for pkg, net in ((ref, rm), (port, pm)):
        mod = pkg.Model(net) if pkg is ref else pkg.Model(net, device="cpu")
        opt = (pkg.optimizer.SGD(0.0, parameters=net.parameters())
               if pkg is ref else pkg.optimizer.SGD(0.0))
        mod.prepare(opt, pkg.nn.CrossEntropyLoss())
        rec = _recorder(pkg.hapi.callbacks)
        ds = pkg.io.TensorDataset([x, y])
        mod.fit(ds, eval_data=ds, epochs=4, batch_size=16, verbose=0,
                callbacks=[rec, pkg.hapi.callbacks.EarlyStopping(
                    monitor="loss", patience=0, save_best_model=False,
                    verbose=0)])
        assert mod.stop_training
        epochs[pkg.__name__] = rec.epochs
    assert epochs["paddle_tpu_torch"] == epochs["paddle_tpu"] == [0, 1, 2]


def test_telemetry_visualdl_and_progress_callbacks(tmp_path, capsys):
    _, pm = _mlps()
    x = np.random.RandomState(2).randn(32, 16).astype(np.float32)
    y = np.zeros(32, np.int64)
    mod = port.Model(pm, device="cpu")
    mod.prepare(port.optimizer.SGD(0.1), port.nn.CrossEntropyLoss())
    cbs = port.hapi.callbacks

    class Times(cbs.Callback):
        times = []

        def on_train_batch_end(self, step, logs=None):
            self.times.append(logs["step_time"])

    times = Times()
    with telemetry.scope(profile=False) as tel:
        mod.fit(port.io.TensorDataset([x, y]), batch_size=8, epochs=1,
                verbose=2, log_freq=1,
                callbacks=[cbs.TelemetryCallback(), times,
                           cbs.VisualDL(str(tmp_path / "vdl"))])
        assert tel.registry.get("step_time_seconds").count() == 4
        assert tel.registry.get("dataloader_batches_total").value() == 4
    assert len(times.times) == 4 and all(t > 0 for t in times.times)
    with open(tmp_path / "vdl" / "scalars.jsonl") as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("train/loss") == 4
    printed = capsys.readouterr().out
    assert "Epoch 1/1" in printed and "step 4/4" in printed


def test_model_device_and_amp():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.Model(PLeNet())
    _, pm = _mlps()
    x = np.random.RandomState(4).randn(8, 16).astype(np.float32)
    y = np.zeros(8, np.int64)
    seen = []
    pm[1].register_forward_post_hook(lambda l, i, o: seen.append(o.dtype))
    for level, dtype in (("O0", torch.float32), ("O1", torch.bfloat16),
                         ("O2", torch.bfloat16)):
        mod = port.Model(pm, device="cpu")
        mod.prepare(port.optimizer.SGD(0.1), port.nn.CrossEntropyLoss(),
                    amp_configs=level)
        loss = mod.train_batch([x], [y])[0]
        assert np.isfinite(loss) and seen[-1] == dtype, (level, seen)
        assert pm[1].weight.dtype == torch.float32


def test_card_phase_lenet_fit_matches_the_golden(tmp_path):
    gold = chip_smoke._hapi_golden()
    assert gold["recipe"] == chip_smoke.HAPI_LENET
    m, clock, ev = chip_smoke.hapi_lenet_fit(
        port.nn, port.optimizer, port.hapi, port.metric,
        port.vision.models, port.vision.datasets, str(tmp_path / "ck"),
        device="cpu")
    np.testing.assert_allclose(clock.losses, gold["losses"],
                               rtol=chip_smoke.HAPI_GOLDEN_RTOL)
    assert {k: v for k, v in ev.items() if k != "loss"} == \
        {k: v for k, v in gold["eval"].items() if k != "loss"}
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        f"{e}.{x}" for e in ("0", "1", "final") for x in ("pdopt",
                                                          "pdparams"))


def test_gpt_model_loss_bar():
    """chip_smoke.hapi_a1's bar from the same comparison here: a bf16 GPT
    (depth 2, narrow) through Model.fit over a DataLoader against the
    trainer on the same weights and batches, 2 warm-up + 10 steps of
    AdamW and the fused CE path. The bar is at least ten times the
    largest relative loss gap read."""
    cfg = dict(tensor_parallel=False, attn_dropout=0.0, hidden_dropout=0.0,
               **gpt_tiny())

    def make():
        framework.seed(0)
        return GPTForPretraining(**cfg).bfloat16()

    ids, lbl = chip_smoke.hapi_gpt_batches(12, 8, 128, cfg["vocab_size"])
    _, t_losses, _, _ = chip_smoke.gpt_trainer_run(
        port.nn, engine, port.optimizer, make(), ids, lbl, 8, device="cpu")
    _, clock = chip_smoke.gpt_model_fit(port.nn, port.optimizer, port.io,
                                        port.hapi, make(), ids, lbl, 8,
                                        device="cpu")
    gap = max(abs(a - b) / abs(b) for a, b in zip(clock.losses, t_losses))
    print(f"hapi loss gap reading: {gap}")
    assert len(clock.losses) == 12 and clock.losses[-1] < clock.losses[0]
    assert 10 * gap <= chip_smoke.HAPI_LOSS_RTOL, gap
