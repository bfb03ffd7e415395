"""The high-level Model API (port of ``paddle_tpu/hapi/model.py``;
reference python/paddle/hapi/model.py:878 Model, prepare :1450, fit :1523,
evaluate :1753, predict :1855).

``Model(network, inputs=None, labels=None, device=None)`` moves the
network's parameters and buffers to ``device``: the card when None, and it
raises without one (``device="cpu"`` runs on the CPU). Batches come as CPU
tensors or arrays and are copied to the device here, never in a loader's
worker.

The step runs eagerly, where the reference's is one jitted function of
(params, buffers, optimizer state) with donated buffers:

- the network's parameters are trained in place, and its buffers (batch
  norm's running statistics) are updated by its own forward;
- the gradients come from ``torch.autograd.grad`` of the loss (scaled by
  the optimizer's ``scale_loss`` when it has one, as ``static.amp``'s
  decorated optimizers do);
- the optimizer's state is the functional ``init_state`` /
  ``apply_gradients`` state, ``{"step", "slots"}``, so ``.pdopt`` keeps
  the reference's layout;
- ``amp_configs`` "O1" and "O2" run the forward and the loss under
  ``amp.auto_cast`` at that level;
- a network that computes its own loss (a fused head loss) takes the
  labels among its inputs and is prepared with a ``loss`` that returns
  its output;
- ``train_batch`` ends by reading the loss on the host, as the
  reference's ``float(loss)`` does: that waits for the card, so a caller
  timing ``train_batch`` times the step on the card.

Data parallelism: under a mesh whose ``data`` axis is larger than 1 (on
an initialised ``torch.distributed`` world), each rank takes its rows of
the global batch (a tensor whose first dimension does not divide is
taken whole, as the reference replicates it), the gradients are averaged
over the data group by ``distributed.compressed``'s exact (fp32)
bucketed exchange, and the loss is averaged and the metrics' per-row
results gathered, so every rank reports the global batch's numbers.
Batch statistics (batch norm's, and its running statistics) are each
rank's own, as under the reference's dygraph ``DataParallel``; the
reference's GSPMD step computes them over the global batch.
``predict_batch`` runs the whole batch on every rank.

``save`` writes ``<path>.pdparams`` (the network's ``state_dict``) and
``<path>.pdopt`` (the optimizer's ``state_dict`` with the step's state
under ``"state"``) through ``framework_io.save``: numpy pickles in the
reference's format, so each package reads the other's files.
"""
from __future__ import annotations

import os
import warnings
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..metric import Metric
from . import callbacks as callbacks_mod

__all__ = ["Model"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._amp_level = "O0"
        self._opt_state = None
        self.stop_training = False

    # -- prepare -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
            for m in metrics:
                if not isinstance(m, Metric):
                    raise TypeError("metrics must be paddle_tpu_torch."
                                    "metric.Metric instances")
            self._metrics = list(metrics)
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
        self._opt_state = None
        return self

    # -- the step's pieces -------------------------------------------------
    def _trainable(self):
        return OrderedDict((n, p) for n, p in self.network.named_parameters()
                           if p.requires_grad)

    def _state(self):
        """The optimizer's functional state, made at the first step."""
        if self._opt_state is None:
            self._opt_state = self._optimizer.init_state(OrderedDict(
                (n, p.detach()) for n, p in self._trainable().items()))
        return self._opt_state

    def _amp(self):
        if self._amp_level in ("O1", "O2"):
            from ..amp import auto_cast
            return auto_cast(True, level=self._amp_level)
        return nullcontext()

    def _to_device(self, tree):
        def move(x):
            if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
                return torch.as_tensor(x).to(self.device, non_blocking=True)
            return x
        return _map(move, tree)

    @staticmethod
    def _pack(inputs, labels):
        ins = inputs if isinstance(inputs, (list, tuple)) else (inputs,)
        if labels is None:
            return tuple(ins)
        lbs = labels if isinstance(labels, (list, tuple)) else (labels,)
        return (*ins, *lbs)

    def _split_batch(self, data):
        data = tuple(data) if isinstance(data, (list, tuple)) else (data,)
        n_labels = (len(self._labels) if self._labels
                    else (1 if self._loss else 0))
        if n_labels == 0:
            return data, ()
        return data[:-n_labels], data[-n_labels:]

    def _compute_loss(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else (outputs,)
        if self._loss is None:
            raise RuntimeError("loss not set; call prepare(loss=...)")
        loss = self._loss(*outs, *labels)
        if isinstance(loss, (list, tuple)):
            loss = sum(torch.sum(x) for x in loss)
        return loss

    def _metric_outs(self, out, labels):
        first = out[0] if isinstance(out, (list, tuple)) else out
        return [m.compute(first, *labels) for m in self._metrics]

    def _update_metrics(self, metric_outs):
        res = []
        for m, mo in zip(self._metrics, metric_outs):
            mo = mo if isinstance(mo, tuple) else (mo,)
            if self._dp_mesh() is not None:
                mo = tuple(self._gather_rows(x) for x in mo)
            res.append(m.update(*mo))
        return res

    # -- data parallelism over the mesh's data axis ------------------------
    @staticmethod
    def _dp_mesh():
        from ..distributed.mesh import get_mesh
        mesh = get_mesh()
        if mesh is not None and mesh.shape.get("data", 1) > 1 \
                and dist.is_initialized():
            return mesh
        return None

    def _shard_batch(self, data):
        mesh = self._dp_mesh()
        if mesh is None:
            return data
        n, r = mesh.shape["data"], mesh.coord["data"]

        def rows(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] % n == 0:
                k = x.shape[0] // n
                return x[r * k:(r + 1) * k]
            return x
        return _map(rows, data)

    def _mean_over_data(self, t):
        mesh = self._dp_mesh()
        if mesh is None:
            return t
        t = t.detach().float().clone()
        dist.all_reduce(t, group=mesh.group_of("data"))
        return t / mesh.shape["data"]

    def _gather_rows(self, t):
        mesh = self._dp_mesh()
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
        dist.all_gather(parts, t.contiguous(), group=mesh.group_of("data"))
        return torch.cat(parts, 0)

    def _mean_grads(self, grads):
        mesh = self._dp_mesh()
        if mesh is None:
            return grads
        from ..distributed.compressed import compressed_tree_mean
        live = OrderedDict((k, g) for k, g in grads.items() if g is not None)
        mean, _ = compressed_tree_mean(live, "data", policy="fp32",
                                       mesh=mesh)
        return OrderedDict((k, mean.get(k)) for k in grads)

    # -- batch-level API ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step on one batch -> ``[loss]`` (and each metric's
        ``update`` result). ``update`` is the reference's signature: every
        call updates, as the reference's does."""
        if self._optimizer is None:
            raise RuntimeError("optimizer not set; call prepare(optimizer=..."
                               ")")
        self.network.train()
        data = self._shard_batch(self._to_device(self._pack(inputs, labels)))
        ins, lbls = self._split_batch(data)
        opt = self._optimizer
        state = self._state()
        params = self._trainable()
        with self._amp():
            out = self.network(*ins)
            loss = self._compute_loss(out, lbls)
        scaled = (opt.scale_loss(loss, state) if hasattr(opt, "scale_loss")
                  else loss)
        raw = torch.autograd.grad(scaled, list(params.values()),
                                  allow_unused=True)
        grads = self._mean_grads(OrderedDict(zip(params, raw)))
        lr_scales = {n: float(getattr(p, "optimize_attr", {}).get(
            "learning_rate", 1.0)) for n, p in params.items()}
        with torch.no_grad():
            new_params, self._opt_state = opt.apply_gradients(
                OrderedDict((n, p.detach()) for n, p in params.items()),
                grads, state, lr=opt.get_lr(), lr_scales=lr_scales)
            for n, p in params.items():
                p.copy_(new_params[n])
            metric_outs = self._metric_outs(out, lbls)
        metrics = self._update_metrics(metric_outs)
        loss_val = float(self._mean_over_data(loss.detach()))
        return ([loss_val] + metrics) if metrics else [loss_val]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        data = self._shard_batch(self._to_device(self._pack(inputs, labels)))
        ins, lbls = self._split_batch(data)
        with self._amp():
            out = self.network(*ins)
            loss = (self._compute_loss(out, lbls) if self._loss is not None
                    else torch.zeros((), device=self.device))
        metrics = self._update_metrics(self._metric_outs(out, lbls))
        loss_val = float(self._mean_over_data(loss))
        return ([loss_val] + metrics) if metrics else [loss_val]

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs for ``inputs``, tensors on the model's
        device."""
        self.network.eval()
        ins = inputs if isinstance(inputs, (list, tuple)) else (inputs,)
        with self._amp():
            return self.network(*self._to_device(tuple(ins)))

    # -- loops -------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader, Dataset

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            verbose=verbose, log_freq=log_freq, save_dir=save_dir,
            save_freq=save_freq, metrics=self._metrics_name())
        cbks.on_begin("train")
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train",
                                       num_iters=num_iters)
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
            if eval_loader is not None and epoch % eval_freq == 0:
                eval_logs = self._run_one_epoch(eval_loader, cbks, "eval")
                cbks.on_end("eval", eval_logs)
        cbks.on_end("train", logs)
        return self

    def _run_one_epoch(self, loader, cbks, mode, num_iters=None):
        logs = {}
        for m in self._metrics:
            m.reset()
        it = iter(loader)
        try:
            for step, data in enumerate(it):
                cbks.on_batch_begin(mode, step, logs)
                data = list(data) if isinstance(data, (list, tuple)) \
                    else [data]
                if mode == "train":
                    outs = self.train_batch(data)
                elif mode == "eval":
                    outs = self.eval_batch(data)
                else:
                    outs = [self.predict_batch(data)]
                logs = dict(zip(self._metrics_name(), _flatten_outs(outs)))
                if hasattr(data[0], "shape") and len(data[0].shape):
                    logs["batch_size"] = data[0].shape[0]
                logs["step"] = step
                cbks.on_batch_end(mode, step, logs)
                if num_iters is not None and step + 1 >= num_iters:
                    break
        finally:
            close = getattr(it, "close", None)
            if close is not None:     # a loader's prefetch and workers
                close()
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, vals):
                logs[n] = v
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        from ..io import DataLoader, Dataset
        loader = DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(eval_data, Dataset) else eval_data
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, steps=steps, verbose=verbose,
            log_freq=log_freq, metrics=self._metrics_name())
        cbks.on_begin("eval")
        logs = self._run_one_epoch(loader, cbks, "eval", num_iters=num_iters)
        cbks.on_end("eval", logs)
        return {k: v for k, v in logs.items()
                if k not in ("step", "batch_size")}

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Outputs as numpy arrays: ``[list of per-batch arrays]``, or
        ``[one array]`` with ``stack_outputs``."""
        from ..io import DataLoader, Dataset
        loader = DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(test_data, Dataset) else test_data
        outputs = []
        for data in loader:
            data = data if isinstance(data, (list, tuple)) else [data]
            outputs.append(_numpy(self.predict_batch(list(data))))
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    # -- persistence -------------------------------------------------------
    def _state_dict(self):
        from ..nn.layer import Layer
        net = self.network
        return (net.state_dict(include_sublayers=True)
                if isinstance(net, Layer) else net.state_dict())

    def save(self, path, training=True):
        from ..framework_io import save as _save
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self._state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer_state_for_save(), path + ".pdopt")

    def _optimizer_state_for_save(self):
        opt_sd = dict(self._optimizer.state_dict())
        if self._opt_state is not None:
            opt_sd["state"] = self._opt_state
        return opt_sd

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load as _load
        sd = _load(path + ".pdparams")
        missing, unexpected = self.network.set_state_dict(sd)
        if missing and not skip_mismatch:
            warnings.warn(f"missing keys on load: {missing}")
        self._opt_state = None
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt_sd = _load(path + ".pdopt")
            if "state" in opt_sd:
                self._opt_state = _map(
                    lambda x: torch.as_tensor(x).to(self.device)
                    if isinstance(x, (np.ndarray, np.generic, torch.Tensor))
                    else x, opt_sd["state"])
        return self

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size, dtypes=dtype)


def _flatten_outs(outs):
    flat = []
    for o in outs:
        if isinstance(o, (list, tuple)):
            flat.extend(o)
        else:
            flat.append(o)
    return flat
