"""The graph walker: one step of the port traced, node by node.

Port of ``paddle_tpu/analysis/walker.py``. The reference's IR is the
jaxpr; the port runs eagerly, launch by launch, so its "program" is the
sequence of ATen ops, registered kernel ops and c10d collectives that one
call issues. :func:`trace_program` records exactly that with
``torch.fx.experimental.proxy_tensor.make_fx(tracing_mode="fake")``: the
function runs on fake tensors (shapes, dtypes and devices, no storage),
so nothing is allocated on the card and nothing is launched, and the
graph holds:

- each ATen op the call dispatches, forward and (where the function calls
  ``torch.autograd.grad``) backward alike;
- each of the port's kernels as ONE node (:data:`KERNEL_OPS`: the flash
  forward, dq and dk/dv, the fused-CE forward, dh and dw, the paged
  decode/verify call), since each is a registered custom op whose fake
  implementation gives its shapes alone;
- each collective as a ``c10d`` node (``allreduce_``, ``_allgather_base_``,
  ...) whose process group is a graph attribute, mapped back here to the
  mesh axes it spans.

The reference walks scan/while/cond bodies and multiplies by their trip
counts. The port has no such nodes: its loops (the gradient merge's
chunks, the pipeline's micro-batches, ring attention's hops) run in
Python and are unrolled in the graph, and a Python branch is resolved at
trace time. So a site has no trip count and no loop or branch context:
every node runs once a call.

Entry points: :func:`trace_program`, :func:`walk` (a :class:`NodeSite`
for every call node), :func:`count_nodes` (``count_eqns``'s
counterpart), :func:`linear_schedule` (the issue order with dataflow
edges, in-place writes included) and :func:`source_summary`.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "KERNEL_OPS", "COLLECTIVE_OPS", "TensorMeta", "NodeSite", "SchedNode",
    "trace_program", "op_name", "is_call", "arg_metas", "node_metas", "walk",
    "count_nodes", "count_by_op", "linear_schedule", "source_summary",
    "process_group_of", "group_axes", "written_args",
]

#: the port's kernels as registered ops -> the ``LAUNCHES`` key each
#: counts under (``ops/flash_attention.py``, ``ops/fused_ce.py``,
#: ``ops/paged_attention.py``)
KERNEL_OPS: Dict[str, str] = {
    "paddle_tpu_torch.flash_attention_fwd": "flash_fwd",
    "paddle_tpu_torch.flash_attention_dq": "flash_dq",
    "paddle_tpu_torch.flash_attention_dkv": "flash_dkv",
    "paddle_tpu_torch.fused_ce_fwd": "ce_fwd",
    "paddle_tpu_torch.fused_ce_dh": "ce_dh",
    "paddle_tpu_torch.fused_ce_dw": "ce_dw",
    "paddle_tpu_torch.paged_attention": "paged",
}

#: collective ops -> (kind, the arguments each writes in place). The kind
#: names follow ``torch.distributed``; the reference's psum is
#: ``all_reduce``, its psum_scatter ``reduce_scatter``
COLLECTIVE_OPS: Dict[str, Tuple[str, Tuple[int, ...]]] = {
    "c10d.allreduce_": ("all_reduce", (0,)),
    "c10d.allreduce_coalesced_": ("all_reduce", (0,)),
    "c10d._allgather_base_": ("all_gather", (0,)),
    "c10d.allgather_": ("all_gather", (0,)),
    "c10d.allgather_into_tensor_coalesced_": ("all_gather", (0,)),
    "c10d._reduce_scatter_base_": ("reduce_scatter", (0,)),
    "c10d.reduce_scatter_": ("reduce_scatter", (0,)),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce_scatter", (0,)),
    "c10d.alltoall_": ("all_to_all", (0,)),
    "c10d.alltoall_base_": ("all_to_all", (0,)),
    "c10d.broadcast_": ("broadcast", (0,)),
    "c10d.send": ("send", ()),
    "c10d.recv_": ("recv", (0,)),
    "c10d.barrier": ("barrier", ()),
}


@dataclass(frozen=True)
class TensorMeta:
    """dtype and shape of one tensor of a node (from its fake value)."""
    dtype: torch.dtype
    shape: Tuple[int, ...]

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> float:
        return float(self.numel * self.dtype.itemsize)

    def sig(self) -> str:
        name = str(self.dtype).replace("torch.", "")
        return f"{name}[{','.join(str(d) for d in self.shape)}]"


def trace_program(fn, *args, **kwargs) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="fake")(*args)``: the graph of every op
    ``fn`` issues. Tensor arguments become fakes of themselves (their
    device included: a CUDA tensor's fake says ``cuda``); tensors ``fn``
    closes over are taken as fake constants, never read. Nothing is
    allocated on a device and nothing is launched; a Python branch on a
    tensor's value fails here, as it would fail any trace. Each node
    keeps the stack it was issued from (:func:`source_summary`)."""
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx
    if kwargs:
        call = fn
        fn = lambda *a: call(*a, **kwargs)  # noqa: E731
    # preserve_node_meta: annotations (``fx.traceback.annotate``) reach
    # the nodes' ``meta["custom"]``
    with fx_traceback.preserve_node_meta():
        return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True,
                       record_stack_traces=True)(*args)


def is_call(node) -> bool:
    """A node that issues work: a call that is not a tuple ``getitem``."""
    return (node.op == "call_function"
            and node.target is not operator.getitem)


def op_name(node) -> str:
    """``"aten.mm"``, ``"paddle_tpu_torch.flash_attention_fwd"``,
    ``"c10d.allreduce_"``: the op's namespace and name, no overload."""
    t = node.target
    packet = getattr(t, "_overloadpacket", None)
    if packet is not None:
        ns = getattr(packet, "_qualified_op_name", "").replace("::", ".")
        if ns:
            return ns
    return getattr(t, "__name__", str(t))


def _metas(v) -> List[TensorMeta]:
    if isinstance(v, torch.Tensor):
        return [TensorMeta(v.dtype, tuple(int(d) for d in v.shape))]
    if isinstance(v, (list, tuple)):
        return [m for x in v for m in _metas(x)]
    return []


def arg_metas(a) -> List[TensorMeta]:
    """Tensor metas of a node argument (a node, or a list of them)."""
    if isinstance(a, torch.fx.Node):
        return _metas(a.meta.get("val"))
    if isinstance(a, (list, tuple)):
        return [m for x in a for m in arg_metas(x)]
    return []


def node_metas(node) -> Tuple[Tuple[TensorMeta, ...], Tuple[TensorMeta, ...]]:
    """(inputs, outputs) tensor metas of a call node, flattened."""
    ins = [m for a in node.args for m in arg_metas(a)]
    ins += [m for a in node.kwargs.values() for m in arg_metas(a)]
    return tuple(ins), tuple(_metas(node.meta.get("val")))


def _script_type(obj) -> str:
    try:
        return obj._type().qualified_name()
    except Exception:
        return repr(obj)


def process_group_of(node):
    """The ``ProcessGroup`` a collective node runs over, or None."""
    gm = node.graph.owning_module
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            if isinstance(obj, torch.ScriptObject) and \
                    "ProcessGroup" in _script_type(obj):
                try:
                    return dist.ProcessGroup.unbox(obj)
                except Exception:
                    continue
    return None


def group_axes(group, mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes a process group spans: a group of ``mesh`` (its
    per-axes groups, or the whole mesh's) -> those live axes; any other
    group -> None (not a group of this mesh)."""
    if mesh is None or group is None:
        return None
    for axes, g in getattr(mesh, "_groups", {}).items():
        if g is group:
            return tuple(axes)
    whole = mesh.group if mesh.group is not None else (
        dist.group.WORLD if dist.is_initialized() else None)
    if group is whole or (whole is not None and dist.is_initialized()
                          and group.group_name == whole.group_name):
        return mesh.live(mesh.axis_names)
    return None


def written_args(node) -> Tuple[int, ...]:
    """Positions of the arguments a node writes in place: from the op's
    schema (``Tensor(a!)``), and for c10d collectives (whose schemas do
    not mark it) from :data:`COLLECTIVE_OPS`."""
    name = op_name(node)
    if name in COLLECTIVE_OPS:
        return COLLECTIVE_OPS[name][1]
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return ()
    return tuple(i for i, a in enumerate(schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write
                 and i < len(node.args))


def source_summary(node) -> Optional[str]:
    """``"file.py:42 (fn)"`` of the innermost frame the tracer recorded
    for a node, or None."""
    st = node.meta.get("stack_trace")
    if not st:
        return None
    lines = [ln.strip() for ln in st.strip().splitlines()
             if ln.strip().startswith("File ")]
    if not lines:
        return None
    try:
        parts = lines[-1].split(",")
        fname = parts[0].split('"')[1].rsplit("/", 1)[-1]
        lineno = parts[1].strip().split()[-1]
        fn = parts[2].strip().split()[-1] if len(parts) > 2 else "?"
        return f"{fname}:{lineno} ({fn})"
    except Exception:
        return None


@dataclass(frozen=True)
class NodeSite:
    """One call node in issue order (the reference's ``EqnSite``)."""
    node: object
    index: int                       # position among the call nodes
    op: str                          # :func:`op_name`
    ins: Tuple[TensorMeta, ...]
    outs: Tuple[TensorMeta, ...]
    group: object = None             # a collective's ProcessGroup
    axes: Optional[Tuple[str, ...]] = None   # mesh axes of ``group``

    @property
    def is_kernel(self) -> bool:
        return self.op in KERNEL_OPS

    @property
    def is_collective(self) -> bool:
        return self.op in COLLECTIVE_OPS


def walk(graph, mesh=None) -> Iterator[NodeSite]:
    """A :class:`NodeSite` for every call node, in issue order.
    ``mesh`` maps each collective's process group to its axes
    (``site.axes``; None where the group is no group of the mesh)."""
    g = getattr(graph, "graph", graph)
    i = 0
    for node in g.nodes:
        if not is_call(node):
            continue
        ins, outs = node_metas(node)
        name = op_name(node)
        group = axes = None
        if name in COLLECTIVE_OPS:
            group = process_group_of(node)
            axes = group_axes(group, mesh)
        yield NodeSite(node=node, index=i, op=name, ins=ins, outs=outs,
                       group=group, axes=axes)
        i += 1


def count_nodes(graph) -> int:
    """Call nodes of the graph (``count_eqns``'s counterpart)."""
    g = getattr(graph, "graph", graph)
    return sum(1 for n in g.nodes if is_call(n))


def count_by_op(graph) -> Dict[str, int]:
    """Call nodes by :func:`op_name`."""
    out: Dict[str, int] = {}
    g = getattr(graph, "graph", graph)
    for n in g.nodes:
        if is_call(n):
            k = op_name(n)
            out[k] = out.get(k, 0) + 1
    return out


@dataclass(frozen=True)
class SchedNode:
    """One step of the issue order (the reference's ``SchedNode``):
    ``in_ids``/``out_ids`` are the dataflow identities it reads and
    writes. An op that writes an argument in place (``copy_``, a c10d
    collective) writes a new version of it, so a later reader depends on
    the writer, not on the tensor's first producer."""
    site: NodeSite
    in_ids: Tuple
    out_ids: Tuple


def _root(node, roots):
    return roots.get(node, node)


def linear_schedule(graph, mesh=None) -> List[SchedNode]:
    """The call nodes in issue order with dataflow edges. Identities are
    (storage root, version): a view or an in-place result shares its
    input's root, and every in-place write bumps the root's version."""
    roots: Dict[object, object] = {}
    version: Dict[object, int] = {}
    out: List[SchedNode] = []
    g = getattr(graph, "graph", graph)
    sites = {s.node: s for s in walk(graph, mesh)}
    for node in g.nodes:
        if node.op == "call_function" and node.target is operator.getitem:
            src = node.args[0]
            roots[node] = _root(src, roots)
            continue
        if node not in sites:
            continue
        site = sites[node]
        reads = []
        for a in node.all_input_nodes:
            r = _root(a, roots)
            reads.append((r, version.get(r, 0)))
        writes = []
        for i in written_args(node):
            arg = node.args[i]
            targets = arg if isinstance(arg, (list, tuple)) else [arg]
            for t in targets:
                if isinstance(t, torch.fx.Node):
                    r = _root(t, roots)
                    version[r] = version.get(r, 0) + 1
                    writes.append((r, version[r]))
        schema = getattr(node.target, "_schema", None)
        aliased = (schema is not None and schema.returns
                   and schema.returns[0].alias_info is not None
                   and node.args and isinstance(node.args[0],
                                                torch.fx.Node))
        if aliased:
            roots[node] = _root(node.args[0], roots)
            r = roots[node]
            outs = tuple(writes) or ((r, version.get(r, 0)),)
        else:
            outs = tuple(writes) + ((node, 0),)
        out.append(SchedNode(site=site, in_ids=tuple(reads), out_ids=outs))
    return out
