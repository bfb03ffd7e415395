"""Mixture of experts with expert parallelism over a mesh axis.

Port of ``paddle_tpu/incubate/moe.py``: top-2 gating with the GShard
load-balancing loss, capacity-based dispatch, experts stacked along a
leading ``(E, ...)`` axis and split over ``axis_name``.

What the port keeps of the reference:

- ``top2_gating``: softmax in float32; first choice the first maximum
  (``argmax``), second the first maximum with the first masked out; the
  two gates renormalized by their sum (at least 1e-9); the aux loss
  ``E · sum(mean(probs) · fraction routed first)``; a token's slot in an
  expert is its rank among the tokens choosing it, the second choices
  queued behind every first choice of that expert; a choice is kept
  where its slot is under the capacity and its gate is positive;
- the capacity ``int(capacity_factor · T · 2 / E) or 1`` rounded up to a
  multiple of 8, at least 8, with T this rank's tokens;
- the experts' math (``x @ w1 + b1``, tanh GELU, ``@ w2 + b2`` in the
  tokens' dtype) and, where each rank brings its own tokens, the tiled
  ``all_to_all`` there and back over the axis: rank r receives every
  rank's buffers of its E/n experts and returns their outputs.

What the port does differently:

- dispatch and combine go by (expert, slot) index, not through the dense
  ``(T, E, C)`` one-hot tensors (``top2_gating`` still builds them for
  its callers): each slot holds at most one token, so gathering the
  token is what the dispatch einsum computes, and the combine adds the
  same two gated terms (in float32, then cast, as a float32-accumulated
  dot does); for the same reason both backwards gather or write each
  slot once, with no scatter-add (``_Dispatch``, ``_Combine``);
- a rank holds only its E/n experts (``w1``, ``b1``, ``w2``, ``b2`` are
  this rank's chunk of the stacked whole, ``pspec`` naming the axis, as
  the Megatron layers' slices), where the reference keeps all E and
  slices the local ones; ``Layer.set_state_dict_from_numpy`` cuts a whole
  state by the rank's coordinate. The axis must be ``model`` or ``pipe``
  when it has more than one rank: ``ParallelTrainer`` exchanges no
  gradient of a leaf split over them;
- where the ranks of the axis hold the same tokens (``split_tokens=False``,
  the default, and what ``ParallelTrainer`` gives: it splits no batch
  over ``model``), every rank computes the same dispatch buffer, runs its
  own E/n experts on their rows and all-gathers the outputs (the
  backward keeps this rank's chunk of the cotangent, and all-gathers the
  buffer's): every gradient is the single layer's, as the reference's
  trainer gives on one device. The reference's trainer at ``{"model":
  n}`` runs the layer inside its ``shard_map`` with the batch replicated
  over ``model``, so n identical copies cross its ``all_to_all``, whose
  transpose makes the experts' gradients n times the single layer's
  (ROADMAP Oracle caveats);
- where each rank brings its own tokens (``split_tokens=True``), the
  tokens cross ranks in the tiled ``all_to_all`` as in the reference; it
  is a library op whose backward is the reverse ``all_to_all``,
  so each expert's gradient sums the cotangents of every rank's tokens
  routed to it: the gradient of the sum of the ranks' losses, as the
  reference's ``shard_map`` transpose gives. ``ParallelTrainer`` refuses
  such a layer on a live axis (``token_axis``), since it would hand every
  rank the same batch.

The exchanges, the dispatch and the combine are library ops
(``torch.ops.paddle_tpu_torch.moe_*``) with their autograd registered:
a ``jit.to_static`` graph holds each as one node and keeps its backward.

``aux_loss`` is a non-persistent buffer, replaced by each forward with the
loss of that forward's routing (differentiable, so it can join the loss).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.mesh import (OWN_AXES, get_mesh, group_handle,
                                handle_group)
from ..nn import functional as F
from ..nn.initializer import XavierUniform
from ..nn.layer import Layer
from ..nn.layers.common import Linear
from ..ops._library import library_op

__all__ = ["EXPERT_AXIS", "top2_gating", "ExpertFFN", "MoELayer",
           "expert_parallel"]

EXPERT_AXIS = "model"


def expert_parallel(axis: str = EXPERT_AXIS):
    """``(group, degree, rank)`` of the current mesh's ``axis``;
    ``(None, 1, 0)`` without a mesh or at degree 1."""
    mesh = get_mesh()
    if mesh is None or mesh.shape[axis] == 1:
        return None, 1, 0
    if axis not in OWN_AXES:
        raise ValueError(f"experts split over {axis!r}: the trainer would "
                         f"average their gradients over it; split them over "
                         f"one of {OWN_AXES}")
    return mesh.group_of(axis), mesh.shape[axis], mesh.coord[axis]


def _route(logits, capacity):
    """The reference's top-2 routing, by index: ``(expert (T, 2), slot
    (T, 2), keep (T, 2), gate (T, 2) float32, aux_loss)``."""
    T, E = logits.shape
    x = logits.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    # argmax takes the first maximum, as jnp.argmax does
    g1, e1 = probs.amax(dim=-1), probs.argmax(dim=-1)
    oh1 = torch.nn.functional.one_hot(e1, E)
    wo1 = probs * (1.0 - oh1.to(probs.dtype))
    g2, e2 = wo1.amax(dim=-1), wo1.argmax(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    aux = torch.sum(probs.mean(dim=0) * oh1.to(probs.dtype).mean(dim=0)) * E
    oh2 = torch.nn.functional.one_hot(e2, E)
    pos1 = torch.cumsum(oh1, dim=0) - 1
    pos2 = torch.cumsum(oh2, dim=0) - 1 + oh1.sum(dim=0, keepdim=True)
    s1 = pos1.gather(1, e1[:, None])[:, 0]
    s2 = pos2.gather(1, e2[:, None])[:, 0]
    expert = torch.stack([e1, e2], dim=1)
    slot = torch.stack([s1, s2], dim=1)
    gate = torch.stack([g1, g2], dim=1)
    keep = (slot < capacity) & (gate > 0)
    return expert, slot, keep, gate, aux


def top2_gating(logits, capacity):
    """Top-2 gating with the load-balancing aux loss. logits: (T, E).
    Returns (combine (T, E, C) float32, dispatch bool (T, E, C),
    aux_loss), the reference's dense form of :func:`_route`."""
    T, E = logits.shape
    expert, slot, keep, gate, aux = _route(logits, capacity)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32,
                          device=logits.device)
    t = torch.arange(T, device=logits.device)[:, None].expand(T, 2)
    combine[t[keep], expert[keep], slot[keep]] = gate[keep]
    dispatch = torch.zeros((T, E, capacity), dtype=torch.bool,
                           device=logits.device)
    dispatch[t[keep], expert[keep], slot[keep]] = True
    return combine, dispatch, aux


def _all_to_all(x, group):
    """Chunk j of dim 0 goes to rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=handle_group(group))
    return out


def _all_to_all_setup(ctx, inputs, output):
    ctx.group = inputs[1]


def _all_to_all_backward(ctx, g):
    """The cotangents go back the same way."""
    return _AllToAll(g, ctx.group), None


_AllToAll = library_op("moe_all_to_all(Tensor x, int group) -> Tensor",
                       _all_to_all, lambda x, group: torch.empty_like(x),
                       _all_to_all_backward, _all_to_all_setup)


def _gather_chunks(x, group, n, rank):
    """The ranks' dim-0 chunks concatenated (all-gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=handle_group(group))
    return torch.cat(parts)


def _chunk_args_setup(ctx, inputs, output):
    ctx.group, ctx.n, ctx.rank = inputs[1:]


def _gather_chunks_backward(ctx, g):
    """This rank's chunk of the cotangent (every rank's is the same)."""
    return g.chunk(ctx.n, dim=0)[ctx.rank].contiguous(), None, None, None


_GatherChunks = library_op(
    "moe_gather_chunks(Tensor x, int group, int n, int rank) -> Tensor",
    _gather_chunks,
    lambda x, group, n, rank: x.new_empty((x.shape[0] * n,)
                                          + tuple(x.shape[1:])),
    _gather_chunks_backward, _chunk_args_setup)


def _own_chunk_backward(ctx, g):
    """The ranks' cotangent chunks all-gathered, so the replicated
    input's gradient is whole on every rank."""
    return _GatherChunks(g, ctx.group, ctx.n, ctx.rank), None, None, None


_OwnChunk = library_op(
    "moe_own_chunk(Tensor x, int group, int n, int rank) -> Tensor",
    lambda x, group, n, rank: x.chunk(n, dim=0)[rank].clone(),
    lambda x, group, n, rank: x.new_empty(
        (-(-x.shape[0] // n),) + tuple(x.shape[1:])),
    _own_chunk_backward, _chunk_args_setup)


def _dispatch(tokens, src, slots):
    """``buf[s] = tokens[src[s]]`` (``src[s] == T``: a zero row)."""
    padded = torch.cat([tokens, tokens.new_zeros((1, tokens.shape[1]))])
    return padded[src]


def _dispatch_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[2])


def _dispatch_backward(ctx, g):
    """Each slot holds at most one token, so the backward gathers: a
    token's gradient is the sum of its (up to two) slots' gradients, read
    at ``slots`` (T, 2; the sink ``n_slots`` for a dropped choice), with
    no scatter-add."""
    (slots,) = ctx.saved_tensors
    gpad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
    return gpad[slots].sum(dim=1), None, None


_Dispatch = library_op(
    "moe_dispatch(Tensor tokens, Tensor src, Tensor slots) -> Tensor",
    _dispatch,
    lambda tokens, src, slots: tokens.new_empty((src.shape[0],
                                                 tokens.shape[1])),
    _dispatch_backward, _dispatch_setup)


def _picked(out, slots):
    """(T, 2, D): each token's two slots' rows (the sink a zero row)."""
    return torch.cat([out, out.new_zeros((1, out.shape[1]))])[slots]


def _combine(out, w, slots):
    """``y[t] = sum_k w[t, k] · out[slots[t, k]]`` in float32, cast to
    ``out``'s dtype (``slots`` the sink row for a dropped choice, whose
    ``w`` is 0)."""
    return (w[..., None] * _picked(out, slots).float()).sum(dim=1).to(
        out.dtype)


def _combine_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _combine_backward(ctx, gy):
    """Writes each slot's gradient once (a slot has one token: a plain
    index write, not an accumulation) and reduces the weights' over the
    width."""
    out, w, slots = ctx.saved_tensors
    picked = _picked(out, slots)
    g32 = gy.float()
    gout = None
    if ctx.needs_input_grad[0]:
        gout = picked.new_zeros((out.shape[0] + 1, picked.shape[2]))
        gout[slots.reshape(-1)] = (w[..., None] * g32[:, None, :]).reshape(
            -1, picked.shape[2]).to(gout.dtype)
        gout = gout[:-1]
    gw = (g32[:, None, :] * picked.float()).sum(dim=-1)
    return gout, gw, None


_Combine = library_op(
    "moe_combine(Tensor out, Tensor w, Tensor slots) -> Tensor",
    _combine,
    lambda out, w, slots: out.new_empty((slots.shape[0], out.shape[1])),
    _combine_backward, _combine_setup)


class ExpertFFN(Layer):
    def __init__(self, d_model, d_hidden):
        super().__init__()
        self.fc1 = Linear(d_model, d_hidden)
        self.fc2 = Linear(d_hidden, d_model)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class MoELayer(Layer):
    """Top-2 MoE over ``num_experts`` stacked experts, E/n of them on each
    of the n ranks of the current mesh's ``axis_name`` (all of them
    without a mesh or at degree 1). Build the mesh before the layer.
    ``split_tokens``: each rank of the axis brings its own tokens (the
    ``all_to_all`` route); by default they all bring the same ones
    (module docstring)."""

    def __init__(self, d_model, d_hidden, num_experts, capacity_factor=2.0,
                 axis_name=EXPERT_AXIS, gate_weight_attr=None,
                 split_tokens=False):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.gate = Linear(d_model, num_experts, bias_attr=False)
        E = num_experts
        self._group, self._n, self._rank = expert_parallel(axis_name)
        rank = self._rank
        # the axis whose ranks bring their own tokens (None: the same)
        self.token_axis = axis_name if split_tokens and self._n > 1 else None
        if E % self._n:
            raise ValueError(f"{E} experts do not split over {self._n} "
                             f"ranks of {axis_name!r}")
        self.local_experts = E // self._n
        shapes = {"w1": ((E, d_model, d_hidden),
                         XavierUniform(fan_in=d_model, fan_out=d_hidden)),
                  "b1": ((E, d_hidden), None),
                  "w2": ((E, d_hidden, d_model),
                         XavierUniform(fan_in=d_hidden, fan_out=d_model)),
                  "b2": ((E, d_model), None)}
        for name, (shape, init) in shapes.items():
            full = self.create_parameter(shape, initializer=init,
                                         is_bias=init is None)
            p = torch.nn.Parameter(
                full.detach().chunk(self._n, dim=0)[rank].clone())
            p.pspec = (axis_name,) + (None,) * (len(shape) - 1)
            setattr(self, name, p)
        self.register_buffer("aux_loss", torch.zeros(()), persistent=False)

    def _run_experts(self, buf):
        """buf: (e, C, D) through this rank's e experts -> (e, C, D)."""
        dt = buf.dtype
        h = torch.einsum("ecd,edh->ech", buf, self.w1.to(dt)) + \
            self.b1.to(dt)[:, None, :]
        h = F.gelu(h, approximate=True)
        return torch.einsum("ech,ehd->ecd", h, self.w2.to(dt)) + \
            self.b2.to(dt)[:, None, :]

    def capacity(self, tokens: int) -> int:
        cap = int(self.capacity_factor * tokens * 2 / self.num_experts) or 1
        return max(8, ((cap + 7) // 8) * 8)

    def forward(self, x):
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        T, E, n = tokens.shape[0], self.num_experts, self._n
        cap = self.capacity(T)
        expert, slot, keep, gate, aux = _route(self.gate(tokens), cap)
        self.aux_loss = aux
        # dispatch: slot (e, c) takes its one token, or a zero row; a
        # dropped choice points at the sink slot E * cap
        slots = torch.where(keep, expert * cap + slot, E * cap)   # (T, 2)
        src = torch.full((E * cap + 1,), T, dtype=torch.long,
                         device=x.device)
        src[slots] = torch.arange(T, device=x.device)[:, None].expand(T, 2)
        buf = _Dispatch(tokens, src[:E * cap], slots).reshape(
            E, cap, d)
        e = self.local_experts
        if n > 1 and self.token_axis is not None:
            # (E, C, D) -> this rank's E/n experts' buffers of every rank,
            # (E/n, n*C, D), and back
            group = group_handle(self._group)
            recv = _AllToAll(buf, group).reshape(n, e, cap, d)
            out = self._run_experts(recv.transpose(0, 1).reshape(
                e, n * cap, d))
            out = out.reshape(e, n, cap, d).transpose(0, 1).reshape(
                E, cap, d)
            out = _AllToAll(out, group)
        elif n > 1:
            # every rank holds this buffer: its own experts' rows, their
            # outputs all-gathered
            group = group_handle(self._group)
            own = _OwnChunk(buf, group, n, self._rank)
            out = _GatherChunks(self._run_experts(own), group, n,
                                self._rank)
        else:
            out = self._run_experts(buf)
        # combine: the two kept choices' outputs, gated, summed in float32
        w = torch.where(keep, gate.to(x.dtype).float(), 0.0)
        y = _Combine(out.reshape(E * cap, d), w, slots)
        return y.reshape(b, s, d)
