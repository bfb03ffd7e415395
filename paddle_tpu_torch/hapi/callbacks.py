"""Callbacks (port of ``paddle_tpu/hapi/callbacks.py``; reference
python/paddle/hapi/callbacks.py: ProgBarLogger:297, ModelCheckpoint:533,
LRScheduler:598, EarlyStopping:688, VisualDL:841).

The hooks, their order and their defaults are the reference's.
``TelemetryCallback``'s ``step_time`` is the card's: ``Model.train_batch``
ends by reading the loss on the host (``float(loss)``), which waits for the
card, and the callback's window spans that wait.
"""
from __future__ import annotations

import numbers
import os
import time


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call(f"on_{mode}_begin", logs or {})

    def on_end(self, mode, logs=None):
        self._call(f"on_{mode}_end", logs or {})

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs or {})

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs or {})

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs or {})


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._step_t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _format(self, logs):
        parts = []
        for k, v in logs.items():
            if k in ("batch_size",):
                continue
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}" if isinstance(v, float)
                             else f"{k}: {v}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and step % self.log_freq == 0:
            elapsed = time.time() - self._step_t0
            ips = (step + 1) / max(elapsed, 1e-9)
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step + 1}{total} - {self._format(logs)} "
                  f"- {ips:.2f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done - {self._format(logs or {})}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._format(logs or {})}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        from ..distributed.checkpoint import attributing_stall
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            # attributed so TelemetryCallback keeps save wall out of
            # step_time/MFU whatever the callback ordering
            with attributing_stall():
                self.model.save(path)

    def on_train_end(self, logs=None):
        from ..distributed.checkpoint import attributing_stall
        if self.save_dir:
            with attributing_stall():
                self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step ^ by_epoch
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _improved(self, current):
        if self.best is None:
            return True
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            return
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self._improved(current):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} did not improve "
                          f"for {self.patience} evals")


class VisualDL(Callback):
    """Scalar logging: VisualDL itself is not a dependency, so each scalar
    is appended as a JSON line to ``<log_dir>/scalars.jsonl`` (tag, value,
    step, time), the reference's file writer."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, value, step):
        import json
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "ts": time.time()}) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._write(f"train/{k}", v, self._step)

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._write(f"eval/{k}", v, self._step)


class TelemetryCallback(Callback):
    """Folds telemetry into hapi ``logs``.

    Times each train batch from its begin hook to its end hook, across
    ``train_batch``'s host read of the loss (hapi drives its own steps, not
    ParallelTrainer, so this window is the step time on the card), and:

    - always adds ``step_time`` to the batch logs — downstream callbacks
      (ProgBarLogger, VisualDL) surface it for free;
    - when telemetry is enabled, records the time into the global
      ``step_time_seconds`` histogram and emits a ``step`` JSONL event;
    - copies trainer-level registry metrics (``mfu``, ``tokens_per_sec``,
      ``recompiles_total``) into the logs when present, so a
      ParallelTrainer run wrapped in hapi-style reporting shows them.
    """

    def __init__(self):
        super().__init__()
        self._t0 = None
        self._stall0 = 0.0

    def on_train_batch_begin(self, step, logs=None):
        from ..distributed import checkpoint as _ckpt
        self._t0 = time.perf_counter()
        self._stall0 = _ckpt.stall_seconds()

    def on_train_batch_end(self, step, logs=None):
        from .. import telemetry
        from ..distributed import checkpoint as _ckpt
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        # a checkpoint save that ran inside this window (ModelCheckpoint
        # or any caller under ``attributing_stall``) is NOT compute: it
        # goes to ckpt_step_stall_ms, not step_time/MFU — otherwise MFU
        # and tokens/sec dip on every checkpoint step
        stall = max(0.0, _ckpt.stall_seconds() - self._stall0)
        dt = max(0.0, dt - stall)
        if logs is not None:
            logs["step_time"] = dt
            if stall:
                logs["ckpt_stall_ms"] = stall * 1000.0
        if telemetry.enabled():
            telemetry.histogram(
                "step_time_seconds",
                "train_step wall time incl. device execution").observe(dt)
            telemetry.emit("step", step_time=dt, source="hapi",
                           **({"ckpt_stall_ms": stall * 1000.0}
                              if stall else {}))
        reg = telemetry.get_registry()
        if logs is not None:
            for log_key, metric in (("mfu", "mfu"),
                                    ("tokens_per_sec", "tokens_per_sec")):
                m = reg.get(metric)
                if m is not None:
                    logs[log_key] = m.value()
            c = reg.get("recompiles_total")
            if c is not None:
                logs["recompiles"] = int(c.value())


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = callbacks if callbacks is not None else []
    cbks = cbks if isinstance(cbks, (list, tuple)) else [cbks]
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + list(cbks)
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    cbk_list.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return cbk_list
