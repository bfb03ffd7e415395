"""Pipeline layer description: ``LayerDesc``, ``SharedLayerDesc``,
``SegmentLayers`` and ``PipelineLayer``.

Port of ``paddle_tpu/distributed/meta_parallel/parallel_layers/
pp_layers.py`` (reference ``fleet/meta_parallel/parallel_layers/
pp_layers.py``: ``SegmentLayers:23``, ``SharedLayerDesc:62``,
``PipelineLayer:76``). ``PipelineLayer`` partitions a LayerDesc list into
``num_stages`` stages and keeps the reference's plan and state names:

- contiguous runs of structurally identical plain descs whose members
  spread evenly over the stages (the transformer body) are ``stack{g}``:
  one parameter per member parameter, named ``_escape(name)``
  (``attn.qkv_proj.weight`` -> ``attn__qkv_proj__weight``), with a leading
  member dim split over ``pipe`` (``pspec`` ``("pipe", *member_spec)``).
  One process runs each stage, so a rank holds only its own stage's
  members of each stack: a leading dim of ``N / num_stages``;
- every other desc is ``mod{i}``, held on every pipe rank as in the
  reference (the embedding, ``ln_f``, the head); the pipeline sums its
  gradient over ``pipe``, the stages that do not use it adding zeros;
- a ``SharedLayerDesc``'s later occurrences hold no parameter: they apply
  ``forward_func(x, owner weight)`` (or the owner layer) against the first
  occurrence's ``mod{i}``, the tied weight.

The layers are built in desc order on every rank from the same seed, so a
stage's members are the ones a one-process build holds at those indices.
A stage applies its members with ``torch.func.functional_call`` of one
member (the template) on the stacked parameters' rows. On a mesh whose
``pipe`` axis is 1 (or without a mesh) the layer holds every member and
:meth:`PipelineLayer.forward` runs the whole plan, the reference's dense
semantics; with ``pipe`` > 1 the degree must be ``num_stages`` and
``PipelineParallel`` drives :meth:`PipelineLayer.forward_stage`.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ....nn.layer import Layer
from ...mesh import get_mesh

__all__ = ["PIPE_AXIS", "LayerDesc", "SharedLayerDesc", "SegmentLayers",
           "PipelineLayer"]

PIPE_AXIS = "pipe"


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_cls, Layer):
            raise TypeError(f"{layer_cls} must be a Layer subclass")

    def build_layer(self) -> Layer:
        return self.layer_cls(*self.inputs, **self.kwargs)

    def signature(self):
        """Structural identity: two descs with equal signatures build
        structurally identical layers (stackable)."""
        return (self.layer_cls, self.inputs,
                tuple(sorted(self.kwargs.items())))

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """Tied layers across stages (reference ``pp_layers.py:62``): the
    first occurrence builds and owns the parameters; later ones apply
    ``forward_func(x, owner_weight)`` (or the owner layer itself)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr

    def signature(self):
        return ("shared", self.layer_name)


class SegmentLayers:
    """Partition N descs into ``num_parts`` stages (reference
    ``pp_layers.py:23``): ``"uniform"`` or ``"layer:<ClassName>"`` (equal
    counts of that layer type a stage)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError(f"{len(layers_desc)} layers < {num_parts} "
                             f"stages")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(len(self.layers_desc), self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.layers_desc)
                     if d.layer_cls.__name__ == name]
            per = len(marks) // self.num_parts
            if per <= 0:
                raise ValueError(f"{len(marks)} {name} layers < "
                                 f"{self.num_parts} stages")
            bounds = [0]
            for p in range(1, self.num_parts):
                bounds.append(marks[p * per])
            bounds.append(len(self.layers_desc))
            return bounds
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts) -> List[int]:
        return [int(np.round(i * num_items / num_parts))
                for i in range(num_parts + 1)]


def _escape(name: str) -> str:
    return name.replace(".", "__")


class _StackedStage(Layer):
    """Members ``[lo, hi)`` of N structurally identical layers, stored as
    stacked parameters (and buffers) of leading dim ``hi - lo``."""

    def __init__(self, members: List[Layer], lo: int, hi: int):
        super().__init__()
        self.size = len(members)
        self.offset = lo
        self.local = hi - lo
        # the skeleton functional_call applies; not a sublayer (its own
        # tensors are replaced at every call)
        object.__setattr__(self, "_template", members[0])
        self.param_names = [n for n, _ in members[0].named_parameters()]
        self.buffer_names = [n for n, _ in members[0].named_buffers()]
        local = members[lo:hi]
        for name, p0 in members[0].named_parameters():
            vals = [dict(m.named_parameters())[name].detach()
                    for m in local]
            sp = torch.nn.Parameter(torch.stack(vals),
                                    requires_grad=p0.requires_grad)
            spec = tuple(getattr(p0, "pspec", None) or (None,) * p0.dim())
            sp.pspec = (PIPE_AXIS,) + spec
            self.register_parameter(_escape(name), sp)
        for name, b0 in members[0].named_buffers():
            self.register_buffer(_escape(name), torch.stack(
                [dict(m.named_buffers())[name] for m in local]))

    def train(self, mode: bool = True):
        self._template.train(mode)
        return super().train(mode)

    def apply_member(self, j: int, x):
        """Local member ``j`` (global member ``offset + j``) on ``x``."""
        state = {n: getattr(self, _escape(n))[j]
                 for n in self.param_names + self.buffer_names}
        return functional_call(self._template, state, (x,))

    def forward(self, x):
        for j in range(self.local):
            x = self.apply_member(j, x)
        return x


class PipelineLayer(Layer):
    """The full desc list and its stage plan (the module docstring).
    ``self.plan[i]`` describes desc ``i``:
    ``("layer", i)`` applies ``mod{i}``; ``("stacked", gid, m)`` member
    ``m`` (global) of ``stack{gid}``; ``("shared", owner_i, fw, attr)``
    ``fw(x, owner weight)`` or the owner."""

    def __init__(self, layers: List[LayerDesc], num_stages: int,
                 loss_fn: Optional[Callable] = None, seg_method="uniform",
                 topology=None, **kwargs):
        super().__init__()
        mesh = get_mesh()
        pipe = mesh.shape[PIPE_AXIS] if mesh is not None else 1
        if pipe not in (1, num_stages):
            raise ValueError(f"PipelineLayer: {num_stages} stages on a mesh "
                             f"whose pipe axis is {pipe}")
        self.stage_id = mesh.coord[PIPE_AXIS] if pipe > 1 else None
        self.descs = layers
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.segment = SegmentLayers(layers, num_stages,
                                     seg_method).do_segment()
        owners = {}
        built: List[Optional[Layer]] = []
        plan = []
        for i, d in enumerate(layers):
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in owners:
                    built.append(None)
                    plan.append(("shared", owners[d.layer_name],
                                 d.forward_func, d.shared_weight_attr))
                    continue
                owners[d.layer_name] = i
            built.append(d.build_layer())
            plan.append(("layer", i))
        self.shared_keys = set(owners)
        self.groups = []           # [(a, b, k)]
        for a, b in self._identical_runs(layers, plan):
            counts = [max(0, min(b, self.segment[s + 1]) -
                          max(a, self.segment[s]))
                      for s in range(num_stages)]
            if min(counts) >= 1 and len(set(counts)) == 1 \
                    and sum(counts) == b - a:
                k = counts[0]
                gid = len(self.groups)
                self.groups.append((a, b, k))
                lo, hi = ((self.stage_id * k, (self.stage_id + 1) * k)
                          if self.stage_id is not None else (0, b - a))
                self.add_module(f"stack{gid}",
                                _StackedStage(built[a:b], lo, hi))
                for i in range(a, b):
                    plan[i] = ("stacked", gid, i - a)
        for i, ent in enumerate(plan):
            if ent[0] == "layer":
                self.add_module(f"mod{i}", built[i])
        self.plan = plan

    @staticmethod
    def _identical_runs(layers, plan):
        """Maximal contiguous runs (a, b) of >1 identical plain descs."""
        runs, a = [], 0
        n = len(layers)
        while a < n:
            b = a + 1
            if plan[a][0] == "layer" and \
                    not isinstance(layers[a], SharedLayerDesc):
                sig = layers[a].signature()
                while b < n and plan[b][0] == "layer" and \
                        not isinstance(layers[b], SharedLayerDesc) and \
                        layers[b].signature() == sig:
                    b += 1
            if b - a > 1:
                runs.append((a, b))
            a = b
        return runs

    # -- stage structure ----------------------------------------------------
    def stage_items(self, stage_id: int):
        lo, hi = self.segment[stage_id], self.segment[stage_id + 1]
        return [(i, self.plan[i]) for i in range(lo, hi)]

    def uniform_split(self):
        """``(pre_items, stack_gid, post_items)`` when the plan is a
        first-stage prologue, ONE stacked group over every stage and a
        last-stage epilogue (the reference's collective-safe shape), else
        None."""
        if len(self.groups) != 1:
            return None
        a, b, _ = self.groups[0]
        if a > self.segment[1] or b < self.segment[self.num_stages - 1]:
            return None
        pre = [(i, self.plan[i]) for i in range(a)]
        post = [(i, self.plan[i]) for i in range(b, len(self.plan))]
        return pre, 0, post

    def owner_weight_key(self, owner_i: int, attr: str) -> str:
        """The parameter name of a shared owner's weight."""
        return f"mod{owner_i}.{attr}"

    def _apply_item(self, i, ent, x):
        kind = ent[0]
        if kind == "layer":
            return getattr(self, f"mod{i}")(x)
        if kind == "stacked":
            _, gid, m = ent
            stack = getattr(self, f"stack{gid}")
            return stack.apply_member(m - stack.offset, x)
        _, owner_i, fw, attr = ent
        owner = getattr(self, f"mod{owner_i}")
        if fw is None:
            return owner(x)
        w = owner
        for part in attr.split("."):
            w = getattr(w, part)
        return fw(x, w)

    def forward_stage(self, x, stage_id: Optional[int] = None):
        """This rank's stage (or ``stage_id``'s, which must be held here)
        on ``x``."""
        s = self.stage_id if stage_id is None else stage_id
        if s is None:
            s = 0 if self.num_stages == 1 else None
        if s is None or (self.stage_id is not None and s != self.stage_id):
            raise ValueError(f"PipelineLayer: stage {stage_id} is not held "
                             f"by this rank (stage {self.stage_id})")
        for i, ent in self.stage_items(s):
            x = self._apply_item(i, ent, x)
        return x

    def forward(self, x):
        """The whole plan (one process holds every member)."""
        if self.stage_id is not None:
            raise RuntimeError("PipelineLayer: this rank holds one stage; "
                               "PipelineParallel drives the pipeline")
        for i, ent in enumerate(self.plan):
            x = self._apply_item(i, ent, x)
        return x
