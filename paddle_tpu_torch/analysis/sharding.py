"""Layouts of a traced step's inputs, and (no) implicit resharding.

Port of ``paddle_tpu/analysis/sharding.py``. The reference seeds a jaxpr's
inputs with their ``PartitionSpec``s and runs GSPMD's transfer rules to
predict the collectives the SPMD partitioner will insert where layouts
conflict. The port has no partitioner: a rank holds the tensors its
trainer gives it (a parameter's ``pspec`` split over ``model`` or
``pipe``, a ZeRO slice over ``sharding``, a residual row), and every
collective is written in the source, so it is a node of the traced graph
(``walker.py``) and priced there. So :func:`propagate` reads the layout
the trainer states for each graph input (``ParallelTrainer.
staged_in_specs``) into :class:`ASpec`s and a per-input table, and
predicts no site; :func:`resharding_table` returns no rows, and
``distributed.auto.resharding_cost`` prices every candidate's implicit
resharding at 0.

:class:`ASpec`, :func:`from_pspec` and :func:`spec_str` are the
reference's, copied (they import no JAX); a layout may be an ``ASpec``, a
tuple with one entry a dim (None, an axis name or a tuple of names), or
None (whole).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

__all__ = ["ASpec", "from_pspec", "spec_str", "ShardingInfo", "propagate",
           "resharding_table"]


@dataclass(frozen=True)
class ASpec:
    """Array layout: per-dim mesh-axis tuples + partial-sum axes."""
    dims: Tuple[Tuple[str, ...], ...] = ()
    partial: frozenset = frozenset()
    constrained: bool = False

    @property
    def replicated(self) -> bool:
        return not self.partial and all(not d for d in self.dims)

    def axis_map(self) -> Dict[str, int]:
        return {ax: d for d, axes in enumerate(self.dims) for ax in axes}


def spec_str(a: ASpec) -> str:
    parts = []
    for axes in a.dims:
        if not axes:
            parts.append("None")
        elif len(axes) == 1:
            parts.append(repr(axes[0]))
        else:
            parts.append("(" + ",".join(repr(x) for x in axes) + ")")
    s = "P(" + ", ".join(parts) + ")"
    if a.partial:
        s += "+sum{" + ",".join(sorted(a.partial)) + "}"
    return s


def from_pspec(spec, ndim: int, sizes: Dict[str, int]) -> ASpec:
    """A layout (ASpec, a tuple a dim, or None) as an ASpec of rank
    ``ndim``, dropping mesh axes of size <= 1."""
    if isinstance(spec, ASpec):
        dims = tuple(spec.dims[:ndim]) + ((),) * max(0, ndim - len(spec.dims))
        return ASpec(dims, spec.partial, spec.constrained)
    dims: List[Tuple[str, ...]] = []
    entries = tuple(spec) if spec is not None else ()
    seen = set()
    for d in range(ndim):
        e = entries[d] if d < len(entries) else None
        if e is None:
            dims.append(())
            continue
        if isinstance(e, str):
            e = (e,)
        axes = tuple(ax for ax in e if isinstance(ax, str)
                     and sizes.get(ax, 1) > 1 and ax not in seen)
        seen.update(axes)
        dims.append(axes)
    return ASpec(tuple(dims))


@dataclass
class ShardingInfo:
    """Result of one :func:`propagate`: ``sites`` (implicit collectives: none
    in the port), ``out_specs`` the inputs' layouts, ``table`` one row per
    graph input."""
    sites: List[dict]
    out_specs: List[ASpec]
    table: List[dict]


def propagate(graph, mesh, in_specs) -> ShardingInfo:
    """The layouts of ``graph``'s inputs under ``mesh`` (module
    docstring): one :class:`ASpec` and one table row per input, no
    resharding site."""
    import torch
    g = getattr(graph, "graph", graph)
    sizes = dict(getattr(mesh, "shape", {}) or {})
    specs, table = [], []
    ins = [n for n in g.nodes if n.op == "placeholder"]
    for i, n in enumerate(ins):
        v = n.meta.get("val")
        ndim = v.dim() if isinstance(v, torch.Tensor) else 0
        spec = in_specs[i] if i < len(in_specs) else None
        a = from_pspec(spec, ndim, sizes)
        specs.append(a)
        table.append({"input": i, "name": n.name, "spec": spec_str(a),
                      "replicated": a.replicated})
    return ShardingInfo(sites=[], out_specs=specs, table=table)


def resharding_table(graph, mesh, in_specs) -> List[dict]:
    """Planner-ready rows of predicted implicit resharding: none in the
    port (module docstring)."""
    return list(propagate(graph, mesh, in_specs).sites)
