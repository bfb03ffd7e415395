"""``PipelineParallel``: GPipe and 1F1B over one process per stage.

Port of ``paddle_tpu/distributed/meta_parallel/pipeline_parallel.py``
(reference ``fleet/meta_parallel/pipeline_parallel.py:114`` ``train_batch``,
the static 1F1B of ``framework/section_worker.cc:139-183``). The reference
runs the whole pipeline as one SPMD program (a scan over ticks, the
activations moved by ``ppermute``); the port's idiom is one process per
stage, each running its own stage of a ``PipelineLayer``
(:meth:`~.parallel_layers.pp_layers.PipelineLayer.forward_stage`), the
activations and their gradients moving between neighbouring stages of the
mesh's ``pipe`` axis with ``torch.distributed.batch_isend_irecv`` (one
batch an exchange: a send and the matching receive in the other
direction go together, the pairing that keeps NCCL from deadlocking).

``accumulate_steps`` (M) and ``schedule`` (``"gpipe"`` or ``"1f1b"``)
come from ``strategy.pipeline_configs``. :meth:`train_batch` splits the
batch into M micro-batches along dim 0:

- ``"gpipe"``: all M forwards, then all M backwards;
- ``"1f1b"``: the non-interleaved schedule: ``S - s - 1`` warm-up
  forwards on stage ``s`` of ``S``, then one forward and one backward in
  turn, then the cool-down backwards. At most ``S - s`` micro-batches are
  in flight on a stage (forwarded, not yet backwarded);
  :attr:`PipelineParallel.max_in_flight` holds the last step's maximum.

Both run the backwards in micro-batch order, each with
``torch.autograd.grad`` of the stage's output (the last stage: of the
micro-batch's loss), and add the gradients in that order, so GPipe and
1F1B give the same bits. The loss and the gradients are the means over
the micro-batches (the sum, then divided by M, as the trainer's gradient
merge). The loss lives on the last stage and is summed over ``pipe`` (the
other stages add zero), so every rank returns it. A parameter that the
stacks do not split over ``pipe`` (the embedding, ``ln_f``, the tied
weight) is held on every stage: its gradient is summed over ``pipe``,
a stage that does not use it adding zeros.

The first activation a stage sends for a micro-batch shape is preceded
by a header (its dims and dtype), which the receiving stage keeps for
that shape.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ...nn.layer import Layer
from ..mesh import get_mesh

__all__ = ["PipelineParallel", "SCHEDULES"]

SCHEDULES = ("gpipe", "1f1b")
PIPE_AXIS = "pipe"
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_HEADER = 9     # ndim + up to 7 dims + dtype code


class PipelineParallel(Layer):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        from .parallel_layers.pp_layers import PipelineLayer
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel requires a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.accumulate_steps = 1
        self.schedule = "gpipe"
        if strategy is not None:
            cfg = strategy.pipeline_configs
            self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
            self.schedule = cfg.get("schedule", self.schedule)
        if self.schedule not in SCHEDULES:
            raise ValueError(f"pipeline schedule {self.schedule!r}: one of "
                             f"{SCHEDULES}")
        self.max_in_flight = 0
        self._meta = {}        # micro-batch shape -> received activation

    def forward(self, x):
        return self._layers(x)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)

    def set_state_dict_from_numpy(self, state, mesh=None):
        return self._layers.set_state_dict_from_numpy(state, mesh)

    # -- the schedule -------------------------------------------------------
    def train_batch(self, inputs, labels, loss_fn, params,
                    micro_batches: Optional[int] = None, scale=None):
        """One forward and backward of the pipeline over ``inputs`` and
        ``labels`` (this rank's batch) -> ``(loss, grads)``: the mean loss
        (every stage), and for each of ``params`` (``{name: parameter}``)
        its mean gradient over the micro-batches, summed over ``pipe``
        where the parameter is not split over it (None: unused by this
        rank and split). ``scale`` (a 0-d tensor) multiplies each loss
        before its backward (the gradients come out scaled)."""
        M = int(micro_batches or self.accumulate_steps)
        mesh = get_mesh()
        S = self.num_stages
        s = mesh.coord[PIPE_AXIS] if S > 1 else 0
        if S > 1 and (mesh.shape[PIPE_AXIS] != S
                      or self._layers.stage_id != s):
            raise ValueError(f"PipelineParallel: {S} stages, the mesh's "
                             f"pipe axis is {mesh.shape[PIPE_AXIS]}")
        if inputs.shape[0] % M:
            raise ValueError(f"batch {inputs.shape[0]} does not split into "
                             f"{M} micro-batches")
        run = _Run(self, mesh, S, s, M, loss_fn, params, scale, inputs,
                   labels)
        (run.gpipe if self.schedule == "gpipe" else run.one_f_one_b)()
        self.max_in_flight = run.max_in_flight
        return run.finish()


class _Run:
    """One step of the schedule on one stage."""

    def __init__(self, pp, mesh, S, s, M, loss_fn, params, scale, inputs,
                 labels):
        self.pp, self.S, self.s, self.M = pp, S, s, M
        self.first, self.last = s == 0, s == S - 1
        self.loss_fn, self.scale = loss_fn, scale
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        self.mesh = mesh
        if S > 1:
            self.nxt = mesh.neighbor(PIPE_AXIS, 1)
            self.prv = mesh.neighbor(PIPE_AXIS, -1)
        self.micro_in = torch.chunk(inputs, M, dim=0)
        self.micro_lb = torch.chunk(labels, M, dim=0)
        self.key = tuple(self.micro_in[0].shape)
        self.stash = {}
        self.grads = [None] * len(self.params)
        self.loss = None
        self.in_flight = self.max_in_flight = 0

    # -- point to point ----------------------------------------------------
    def _p2p(self, send_prev=None, recv_prev=False, send_next=None,
             recv_next=None):
        """One batch: the sends, and the receives (``recv_prev``: an
        activation from the previous stage; ``recv_next``: a gradient
        like it from the next) -> the received tensor or None."""
        ops, got = [], None
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, send_prev.contiguous(),
                                  self.prv))
        if recv_prev:
            shape, dtype = self._recv_meta()
            got = torch.empty(shape, dtype=dtype, device=self._device())
            ops.append(dist.P2POp(dist.irecv, got, self.prv))
        if send_next is not None:
            self._send_meta(send_next)
            ops.append(dist.P2POp(dist.isend, send_next.contiguous(),
                                  self.nxt))
        if recv_next is not None:
            got = torch.empty_like(recv_next)
            ops.append(dist.P2POp(dist.irecv, got, self.nxt))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        return got

    def _device(self):
        return self.params[0].device if self.params else torch.device("cpu")

    def _send_meta(self, t):
        sent = self.pp._meta.setdefault("sent", set())
        if self.key in sent:
            return
        if t.dim() > _HEADER - 2:
            raise ValueError(f"pipeline activation of rank {t.dim()}")
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0] = t.dim()
        h[1:1 + t.dim()] = torch.tensor(t.shape)
        h[-1] = _DTYPES.index(t.dtype)
        h = h.to(t.device)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, h,
                                                    self.nxt)]):
            r.wait()
        sent.add(self.key)

    def _recv_meta(self):
        got = self.pp._meta.setdefault("recv", {})
        if self.key not in got:
            h = torch.zeros(_HEADER, dtype=torch.int64, device=self._device())
            for r in dist.batch_isend_irecv([dist.P2POp(dist.irecv, h,
                                                        self.prv)]):
                r.wait()
            h = h.tolist()
            got[self.key] = (tuple(h[1:1 + h[0]]), _DTYPES[h[-1]])
        return got[self.key]

    def recv_fwd(self):
        return None if self.first else self._p2p(recv_prev=True)

    def send_fwd(self, out):
        if not self.last:
            self._p2p(send_next=out)

    def recv_bwd(self, like):
        return None if self.last else self._p2p(recv_next=like)

    def send_bwd(self, g):
        if not self.first:
            self._p2p(send_prev=g)

    def send_fwd_recv_bwd(self, out):
        return None if self.last else self._p2p(send_next=out,
                                                recv_next=out)

    def send_bwd_recv_fwd(self, g):
        return None if self.first else self._p2p(send_prev=g,
                                                 recv_prev=True)

    # -- compute ------------------------------------------------------------
    def fwd(self, m, x):
        """Forward of micro-batch ``m`` on this stage (``x``: the received
        activation; None on the first stage) -> the output to send."""
        if x is None:
            x = self.micro_in[m]
        else:
            x.requires_grad_(True)
        out = self.pp._layers.forward_stage(x)
        if self.last:
            out = self.loss_fn(out, self.micro_lb[m])
            part = out.detach() / self.M
            self.loss = part if self.loss is None else self.loss + part
        self.stash[m] = (x, out)
        self.in_flight += 1
        self.max_in_flight = max(self.max_in_flight, self.in_flight)
        return out

    def bwd(self, m, g):
        """Backward of micro-batch ``m`` (``g``: the output's gradient
        from the next stage; None on the last) -> the input's gradient."""
        x, out = self.stash.pop(m)
        self.in_flight -= 1
        if self.last:
            g = None if self.scale is None else self.scale.to(out.dtype)
        wrt = self.params + ([x] if x.requires_grad else [])
        got = torch.autograd.grad(out, wrt, grad_outputs=g,
                                  allow_unused=True)
        for i, gi in enumerate(got[:len(self.params)]):
            if gi is not None:
                self.grads[i] = gi if self.grads[i] is None \
                    else self.grads[i] + gi
        return got[-1] if x.requires_grad else None

    # -- schedules -----------------------------------------------------------
    def gpipe(self):
        outs = []
        for m in range(self.M):
            out = self.fwd(m, self.recv_fwd())
            self.send_fwd(out)
            outs.append(out)
        for m in range(self.M):
            self.send_bwd(self.bwd(m, self.recv_bwd(outs[m])))

    def one_f_one_b(self):
        M = self.M
        warm = min(self.S - self.s - 1, M)
        rem = M - warm
        outs = {}
        for i in range(warm):
            outs[i] = self.fwd(i, self.recv_fwd())
            self.send_fwd(outs[i])
        x = self.recv_fwd() if rem > 0 else None
        for i in range(rem):
            m = warm + i
            outs[m] = self.fwd(m, x)
            g = self.send_fwd_recv_bwd(outs[m])
            gin = self.bwd(i, g)
            if i == rem - 1:
                self.send_bwd(gin)
            else:
                x = self.send_bwd_recv_fwd(gin)
        for i in range(warm):
            m = rem + i
            self.send_bwd(self.bwd(m, self.recv_bwd(outs[m])))

    def finish(self):
        """(mean loss on every stage, mean gradients summed over pipe)."""
        M, S = self.M, self.S
        grads = [None if g is None else g / M for g in self.grads]
        dev = self._device()
        loss = self.loss if self.loss is not None else \
            torch.zeros((), dtype=torch.float32, device=dev)
        if S > 1:
            group = self.mesh.group_of(PIPE_AXIS)
            loss = loss.float().clone()
            dist.all_reduce(loss, group=group)
            for i, p in enumerate(self.params):
                if PIPE_AXIS in tuple(getattr(p, "pspec", None) or ()):
                    continue
                g = grads[i] if grads[i] is not None else torch.zeros_like(p)
                g = g.contiguous().clone()
                dist.all_reduce(g, group=group)
                grads[i] = g
        return loss, dict(zip(self.names, grads))
