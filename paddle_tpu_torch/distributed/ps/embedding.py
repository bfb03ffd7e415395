"""DistributedEmbedding: an embedding over a host parameter-server table.

Port of ``paddle_tpu/distributed/ps/embedding.py`` (reference
operators/pscore/distributed_lookup_table_op.cc, the worker-side pull, and
service/communicator.h:197, the gradient push). The lookup is a
``torch.autograd.Function``:

- the forward copies the ids to the host, pulls their rows from the table
  (ids < 0 are padding: zero rows, never pulled, so no row is made for
  them) and returns the rows on the ids' device;
- the backward copies the rows' gradient to the host and pushes
  ``(ids >= 0, grad, lr)`` to the table, whose host optimizer applies it:
  the push IS the rows' optimizer step, so the device optimizer never owns
  them. It runs once a backward, in order, before the trainer's NaN guard
  decides: a step the guard skips has already pushed, as in the reference.

The one trainable parameter is the zero ``grad_hook``: no parameter's
gradient would otherwise depend on the rows, and autograd would never run
the backward (and with it the push). The hook's gradient is zero, so it
never moves; it keeps the reference's state names.

The port runs eagerly, so the pull and the push run once each a step (the
reference's ``pure_callback`` may pull again when re-traced). A host pull
cannot be traced: under ``make_fx`` (``ParallelTrainer.compile``, the
analysis walker) the lookup raises rather than reading fakes or pushing
into the table.
"""
from __future__ import annotations

import numpy as np
import torch

from ...nn.layer import Layer
from .table import SparseTable

__all__ = ["make_lookup", "DistributedEmbedding"]


def _check_not_tracing(ids, what: str):
    """Raise when ``ids`` is a fake tensor or a ``make_fx`` trace is on: a
    host round trip to a table has no traced form."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    if is_fake(ids) or get_proxy_mode() is not None:
        raise RuntimeError(
            f"{what} pulls rows from a host parameter-server table and "
            "cannot be traced (make_fx, ParallelTrainer.compile, the "
            "analysis walker): run it eagerly with train_step")


def _host_ids(ids) -> np.ndarray:
    return np.asarray(ids.detach().cpu().numpy() if isinstance(
        ids, torch.Tensor) else ids).astype(np.int64, copy=False)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, hook, table, lr):
        ids_np = _host_ids(ids)
        flat = ids_np.reshape(-1)
        valid = flat >= 0
        dim = table.dim
        emb = np.zeros((flat.size, dim), np.float32)
        if valid.any():
            emb[valid] = np.asarray(table.pull(flat[valid])).reshape(-1, dim)
        ctx.table, ctx.lr, ctx.ids = table, float(lr), flat
        out = torch.from_numpy(emb.reshape(ids_np.shape + (dim,)))
        return out.to(ids.device) + hook.detach().to(torch.float32) * 0.0

    @staticmethod
    def backward(ctx, g):
        ids = ctx.ids
        mask = ids >= 0
        if mask.any():
            g_np = g.detach().to(torch.float32).cpu().numpy().reshape(
                ids.size, ctx.table.dim)
            ctx.table.push(ids[mask], g_np[mask], ctx.lr)
        return None, torch.zeros((), dtype=torch.float32,
                                 device=g.device), None, None


def make_lookup(table: SparseTable):
    """``lookup(ids, lr, hook) -> (..., dim)`` float32 rows on the ids'
    device, whose backward pushes the rows' gradient to ``table``."""

    def lookup(ids, lr, hook):
        _check_not_tracing(ids, "a parameter-server lookup")
        return _Lookup.apply(ids, hook, table, lr)
    return lookup


class DistributedEmbedding(Layer):
    """Embedding over an unbounded sparse vocabulary kept in host memory.

    The table's rows are not parameters: the table's host optimizer updates
    them at push time (``lr`` here), the parameter server's division of
    labour. ``table`` may be a ``DistributedSparseTable`` (``service.py``):
    the lookups then route to the owning servers. ``entry``: an admission
    policy (``distributed.entry``). ``pooling``: None, ``"sum"`` or
    ``"mean"`` over the second-to-last dim, padding excluded."""

    def __init__(self, dim: int, optimizer: str = "adagrad", lr: float = 0.05,
                 seed: int = 0, init_range: float = 0.01, pooling=None,
                 table=None, entry=None):
        super().__init__()
        from ...nn.initializer import Constant
        self.dim = dim
        self.lr = lr
        self.pooling = pooling
        self.table = table if table is not None else SparseTable(
            dim, optimizer=optimizer, seed=seed, init_range=init_range)
        assert self.table.dim == dim
        if entry is not None:
            from ..entry import _AdmissionTable
            self.table = _AdmissionTable(self.table, entry)
        self.grad_hook = self.create_parameter((), initializer=Constant(0.0))
        self._lookup = make_lookup(self.table)

    def forward(self, ids):
        ids = torch.as_tensor(ids)
        emb = self._lookup(ids, self.lr, self.grad_hook)
        if self.pooling is None:
            return emb
        # a pooled bag of ids: (B, L) -> (B, dim), padding excluded
        mask = (ids >= 0).to(torch.float32)[..., None]
        s = (emb * mask).sum(dim=-2)
        if self.pooling == "sum":
            return s
        return s / mask.sum(dim=-2).clamp(min=1.0)

    def save(self, path: str):
        self.table.save(path)

    def load(self, path: str):
        self.table.load(path)
