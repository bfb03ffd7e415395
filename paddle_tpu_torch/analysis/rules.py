"""The rule registry of the graph analyzer.

Port of ``paddle_tpu/analysis/rules.py`` (and the rule half of
``schedule.py``). A rule is a generator taking a :class:`RuleContext` and
yielding :class:`~.report.Finding`s through ``ctx.finding(...)``; the
runner stamps the rule id and its severity. Register with::

    @register_rule("my-rule", "warning")
    def my_rule(ctx):
        for site in ctx.sites:
            if looks_wrong(site):
                yield ctx.finding(site, "why it is wrong")

Severity contract, as the reference's: "error" findings fail the lint
(``python -m paddle_tpu_torch.analysis.lint`` exits 1), "warning" is a
likely cost or correctness hazard a shipped model may carry, "info" is
advice.

Every rule id of the reference is either in :data:`RULES` under the same
id and severity, with the meaning below for one eagerly traced CUDA step,
or in :data:`NOT_APPLICABLE` with the reason it has no counterpart:

- ``fp64-leak`` (error): a node producing float64/complex128. The H100
  runs float64 at 1/30 of its bfloat16 tensor rate; a float64 value in a
  step is almost always a numpy double or a Python-float tensor.
- ``amp-fp32-leak`` (warning): a float32 matmul (``mm``/``addmm``/
  ``bmm``/``baddbmm``) with an operand that a cast made from bfloat16 or
  float16 (``_to_copy``): the tensor cores' low-precision rate is lost.
- ``collective-unbound-axis`` (error): a collective over a process group
  that no mesh built (``mesh.build_mesh``), nor the default group: a
  stray ``new_group`` that the mesh's ranks do not all share.
- ``collective-axis-not-in-mesh`` (error): a collective over a group of
  ANOTHER mesh than the one under analysis (one built before a remesh):
  the step was written for another layout.
- ``host-callback`` (warning): a host round trip in the step: a scalar
  read (``_local_scalar_dense``) or a copy from the card to the CPU.
  (The fake tracer refuses a Python branch on a value outright.)
- ``non-donated-large-arg`` (warning): an input of at least
  ``donate_min_bytes`` whose old value stays live beside the new one:
  with the caller's ``donated`` set (``ParallelTrainer.compile`` passes
  its state: parameters written back in place, the slots, residuals and
  guard it replaces and releases) any large input outside it; without
  one, any large input the graph rebuilds out of place and copies back.
- ``recompile-scalar-const`` (info): a 0-d tensor constant baked into the
  graph (an exported program keeps its value; changing it needs a new
  export).
- ``dead-equation`` (info): a node no output, in-place write or
  collective depends on, grouped by source line as the reference groups.
- ``int4-grad-sync-overflow`` (error): an int16 sum over n elements, or an
  int16 all-reduce over n ranks, with 7·n past the int16 range.
- ``compressed-collective-link-mismatch`` (warning): an int8/uint8-wire
  collective over NVLink-only ("ici") axes, or a float32 one of at least
  ``dcn_uncompressed_min_bytes`` crossing a "dcn" axis; active when the
  mesh's links were set or one axis crosses hosts.
- ``oversized-allgather`` (warning): an all-gather whose gathered tensor
  reaches ``allgather_warn_bytes``.
- ``pallas-config-untuned`` (warning; the reference's id kept): a kernel
  node on a CUDA tensor whose launch configuration has no tuning-DB row
  (``ops/tuner.py``) for its shape bucket, dtype and device kind: the
  flash forward's keying blocks (``flash_attention``), the fused-CE
  forward's vocab splits (``fused_ce_fwd_tiled``, bfloat16) or blocks
  (``fused_ce``), the paged call's splits (``paged_split``).
- ``exchange-not-overlapped`` (warning): ``grad_sync_buckets >= 2`` but
  every gradient collective clusters after the last compute-heavy node.
- ``replicated-large-param`` (warning): a large state input whole on
  every rank while a ``sharding`` axis of the mesh is larger than 1
  (needs the trainer's layout, ``in_specs``).
- ``collective-order-divergence`` (error): the graphs traced on the
  ranks of a world issue different collective sequences (the per-rank
  schedules, ``RuleContext.peer_schedules``): the first differing
  collective hangs every peer. The port's branches run on the host at
  trace time, so a rank-dependent branch shows here.
- ``program-family-schedule-drift`` (error): as the reference's, over a
  :class:`~.schedule.ProgramFamily` of traced graphs.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, List, Optional

import torch

from .report import SEVERITIES, Finding
from .walker import (COLLECTIVE_OPS, KERNEL_OPS, NodeSite, linear_schedule,
                     source_summary, walk)

__all__ = [
    "AnalysisConfig", "RuleContext", "Rule", "RULES", "NOT_APPLICABLE",
    "register_rule", "run_rules", "collective_kind", "collective_axes",
]

#: the reference's rule ids with no counterpart in an eager CUDA step
NOT_APPLICABLE: Dict[str, str] = {
    "ppermute-non-permutation":
        "the port has no ppermute: a pipeline or ring hop is a send/recv "
        "pair whose peer is Mesh.neighbor along one axis, a permutation by "
        "construction, and a rank's graph holds only its own pairs",
    "implicit-resharding":
        "no partitioner inserts collectives: every collective of the port "
        "is written in its source and is a node of the graph",
    "sharding-constraint-dropped":
        "the port has no sharding constraints: a layout is the tensors a "
        "rank holds, never a hint that a later op can erase",
    "resharding-in-scan-body":
        "there is no implicit resharding, and no scan: loops are unrolled "
        "in the graph",
    "collective-in-data-dependent-while":
        "a traced graph has no while loop: Python loops are unrolled, and "
        "one whose trip count depends on a tensor's value needs a host "
        "read that the fake-tensor trace refuses",
    "rank-dependent-collective-schedule":
        "a branch on the rank is resolved on the host when each rank "
        "traces, so it shows as ranks whose graphs differ: "
        "collective-order-divergence over the per-rank schedules",
}


@dataclass(frozen=True)
class AnalysisConfig:
    """Thresholds and knobs shared by all rules (the reference's)."""
    donate_min_bytes: float = 1 << 20      # 1 MiB: smaller args are cheap
    allgather_warn_bytes: float = 64 << 20  # 64 MiB gathered output
    top_k: int = 10                        # cost-table length
    check_fp64: bool = True
    dcn_uncompressed_min_bytes: float = 1 << 20
    # exchange-not-overlapped: the caller's bucket count (0 = unknown,
    # silent; 1 = monolithic by design; >= 2 = bucketed);
    # ParallelTrainer.compile injects its own
    grad_sync_buckets: int = 0
    overlap_min_flops: float = 1e5
    replicated_param_min_bytes: float = 8 << 20
    shardable_axes: tuple = ("sharding",)
    disabled_rules: frozenset = frozenset()


class RuleContext:
    """Everything a rule may inspect about one traced graph.

    sites    -- every call node (:func:`~.walker.walk`), collectives
                mapped to ``mesh``'s axes.
    graph    -- the ``GraphModule``.
    mesh     -- the mesh the step runs on (None: skip the membership and
                link rules).
    donated  -- indices of the graph's inputs that hold state (the
                trainer's parameters, slots, residuals, guard), or None.
    in_specs -- one layout (:class:`~.sharding.ASpec`, a tuple of axis
                names a dim, or None) per graph input, or None.
    peer_schedules -- {rank: [collective keys]} of the graphs the other
                ranks of a world traced, or None.
    """

    def __init__(self, graph, mesh=None, donated=None,
                 config: Optional[AnalysisConfig] = None, in_specs=None,
                 peer_schedules=None, rank: Optional[int] = None):
        self.graph = graph
        self.closed = graph
        self.mesh = mesh
        self.donated = frozenset(donated) if donated is not None else None
        self.config = config or AnalysisConfig()
        self.in_specs = list(in_specs) if in_specs is not None else None
        self.peer_schedules = peer_schedules
        self.rank = rank
        self.family = None
        self.sites: List[NodeSite] = list(walk(graph, mesh))
        g = getattr(graph, "graph", graph)
        self.placeholders = [n for n in g.nodes if n.op == "placeholder"]
        self._sharding = False

    def sharding(self):
        """The layout pass (``sharding.propagate``) over the inputs, or None
        without a mesh and ``in_specs``."""
        if self._sharding is False:
            self._sharding = None
            if self.mesh is not None and self.in_specs is not None:
                from .sharding import propagate
                self._sharding = propagate(self.graph, self.mesh,
                                           self.in_specs)
        return self._sharding

    def finding(self, site: Optional[NodeSite], message: str,
                severity: str = "") -> Finding:
        if site is None:
            return Finding(rule="", severity=severity, message=message)
        return Finding(rule="", severity=severity, message=message,
                       primitive=site.op, eqn_index=site.index,
                       source=source_summary(site.node))

    def finding_at(self, message: str, *, primitive: str = "", path=(),
                   eqn_index: int = -1, source: Optional[str] = None,
                   severity: str = "") -> Finding:
        if not isinstance(path, str):
            path = "/".join(path)
        return Finding(rule="", severity=severity, message=message,
                       primitive=primitive, path=path or "<top>",
                       eqn_index=eqn_index, source=source)


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    fn: Callable[[RuleContext], Iterable[Finding]]
    doc: str = ""


RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str):
    """Decorator adding a rule to the registry."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}, "
                         f"got {severity!r}")

    def deco(fn):
        if rule_id in RULES or rule_id in NOT_APPLICABLE:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, severity, fn,
                              (fn.__doc__ or "").strip())
        return fn
    return deco


def run_rules(graph, mesh=None, donated=None,
              config: Optional[AnalysisConfig] = None,
              rules: Optional[Iterable[str]] = None, in_specs=None,
              ctx: Optional[RuleContext] = None) -> List[Finding]:
    """Run (a subset of) the registry over one graph. A finding whose rule
    set a valid severity keeps it (escalation); otherwise the rule's
    registered severity is stamped."""
    cfg = config or AnalysisConfig()
    if ctx is None:
        ctx = RuleContext(graph, mesh=mesh, donated=donated, config=cfg,
                          in_specs=in_specs)
    out: List[Finding] = []
    selected = RULES.keys() if rules is None else rules
    for rid in selected:
        rule = RULES[rid]
        if rid in cfg.disabled_rules:
            continue
        for f in rule.fn(ctx):
            sev = f.severity if f.severity in SEVERITIES else rule.severity
            out.append(replace(f, rule=rule.id, severity=sev))
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def collective_kind(site: NodeSite) -> Optional[str]:
    """``all_reduce``, ``all_gather``, ... of a collective node, else None."""
    entry = COLLECTIVE_OPS.get(site.op)
    return entry[0] if entry else None


def collective_axes(site: NodeSite) -> tuple:
    """The mesh axes a collective node spans (``()`` when unknown)."""
    return tuple(site.axes or ())


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0:
            return f"{n:.4g}{unit}"
        n /= 1024.0
    return f"{n:.4g}TiB"


def _val(a):
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else None


def _dt(m) -> str:
    return str(m.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

_F64 = (torch.float64, torch.complex128)


@register_rule("fp64-leak", "error")
def fp64_leak(ctx):
    """float64/complex128 values in the step: the card runs them at a
    fraction of its rate; almost always a numpy double or a Python-float
    tensor sneaking in."""
    if not ctx.config.check_fp64:
        return
    for site in ctx.sites:
        bad = [m for m in site.outs if m.dtype in _F64]
        if bad:
            yield ctx.finding(
                site, f"{site.op} produces {_dt(bad[0])}; the card runs "
                      "float64 at a fraction of its rate (check numpy "
                      "float64 arrays and torch.float64 tensors)")


_LOW = (torch.bfloat16, torch.float16)
_MATMULS = {"aten.mm": (0, 1), "aten.addmm": (1, 2), "aten.bmm": (0, 1),
            "aten.baddbmm": (1, 2)}
_CASTS = ("aten._to_copy", "aten.to")


@register_rule("amp-fp32-leak", "warning")
def amp_fp32_leak(ctx):
    """A float32 matmul on an operand cast up from bfloat16/float16: the
    low-precision region pays the float32 rate anyway."""
    from .walker import op_name
    for site in ctx.sites:
        pos = _MATMULS.get(site.op)
        if pos is None or not site.outs or \
                site.outs[0].dtype != torch.float32:
            continue
        for i in pos:
            a = site.node.args[i]
            src = a
            while isinstance(src, torch.fx.Node) and op_name(src) in (
                    "aten.view", "aten._unsafe_view", "aten.t",
                    "aten.transpose", "aten.permute", "aten.expand",
                    "aten.reshape"):
                src = src.args[0]
            if (isinstance(src, torch.fx.Node) and src.op == "call_function"
                    and op_name(src) in _CASTS
                    and isinstance(src.args[0], torch.fx.Node)
                    and getattr(_val(src.args[0]), "dtype", None) in _LOW
                    and getattr(_val(src), "dtype", None) == torch.float32):
                yield ctx.finding(
                    site, f"float32 matmul on an operand cast up from "
                          f"{str(_val(src.args[0]).dtype)[6:]}: the step "
                          "pays the float32 rate (keep the matmul in bf16 "
                          "and upcast its result)")
                break


def _mesh_groups():
    from ..distributed import mesh as _mesh
    return _mesh.known_groups()


@register_rule("collective-unbound-axis", "error")
def collective_unbound_axis(ctx):
    """A collective over a process group no mesh built (nor the default
    group): ranks outside the step's mesh would have to join it."""
    import torch.distributed as dist
    known = _mesh_groups()
    for site in ctx.sites:
        if not site.is_collective or site.group is None:
            continue
        g = site.group
        if id(g) in known:
            continue
        if dist.is_initialized() and g.group_name == \
                dist.group.WORLD.group_name:
            continue
        yield ctx.finding(
            site, f"{collective_kind(site)} over process group "
                  f"{g.group_name!r} ({g.size()} ranks), which no mesh "
                  "built: build the step's groups with build_mesh")


@register_rule("collective-axis-not-in-mesh", "error")
def collective_axis_not_in_mesh(ctx):
    """A collective over a group of another mesh than the one the step
    runs on: the step was written for another layout."""
    if ctx.mesh is None:
        return
    known = _mesh_groups()
    for site in ctx.sites:
        if not site.is_collective or site.group is None:
            continue
        if site.axes is not None:
            continue
        other = known.get(id(site.group))
        if other is None:
            continue
        shape, axes = other
        yield ctx.finding(
            site, f"{collective_kind(site)} over the {list(axes)} group of "
                  f"a mesh {shape}, not of the step's mesh "
                  f"{ctx.mesh.shape}")


@register_rule("host-callback", "warning")
def host_callback(ctx):
    """A host round trip inside the step: the card waits for the host."""
    for site in ctx.sites:
        if site.op == "aten._local_scalar_dense":
            yield ctx.finding(site, "a scalar read (.item()) forces a host "
                                    "round trip on the hot path")
            continue
        if site.op in _CASTS + ("aten.copy_",):
            out = _val(site.node)
            src = _val(site.node.args[1] if site.op == "aten.copy_"
                       else site.node.args[0])
            if isinstance(out, torch.Tensor) and \
                    isinstance(src, torch.Tensor) and \
                    src.device.type == "cuda" and out.device.type == "cpu":
                yield ctx.finding(site, "a copy from the card to the host "
                                        "stalls the step until it lands")


@register_rule("non-donated-large-arg", "warning")
def non_donated_large_arg(ctx):
    """A large input the step neither writes in place nor releases: its
    old value stays live beside the new one (the reference's missing
    donation). With the caller's ``donated`` set (the trainer's state:
    parameters written back in place, slots, residuals and guard replaced
    and released) every large input outside it is reported; without one,
    every large input the graph rebuilds out of place and copies back."""
    thresh = ctx.config.donate_min_bytes
    if ctx.donated is not None:
        for i, n in enumerate(ctx.placeholders):
            v = _val(n)
            if not isinstance(v, torch.Tensor):
                continue
            nb = float(v.numel() * v.dtype.itemsize)
            if i not in ctx.donated and nb >= thresh:
                yield ctx.finding_at(
                    f"input #{i} ({_human_bytes(nb)}) is not donated: its "
                    "old value stays live beside the step's new one",
                    primitive="<input>", eqn_index=-1)
        return
    index = {n: i for i, n in enumerate(ctx.placeholders)}
    seen = set()
    for site in ctx.sites:
        if site.op != "aten.copy_":
            continue
        i = index.get(site.node.args[0])
        if i is None or i in seen:
            continue
        nb = float(sum(m.nbytes for m in site.ins[:1]))
        if nb < thresh:
            continue
        seen.add(i)
        yield ctx.finding(
            site, f"input #{i} ({_human_bytes(nb)}) is rebuilt out of "
                  "place and copied back: two copies are live (update it "
                  "in place to keep one)")


@register_rule("recompile-scalar-const", "info")
def recompile_scalar_const(ctx):
    """0-d tensor constants baked into the graph: an exported program
    keeps the value; changing it needs a new export."""
    g = getattr(ctx.graph, "graph", ctx.graph)
    gm = ctx.graph
    for n in g.nodes:
        if n.op != "get_attr":
            continue
        v = getattr(gm, n.target, None)
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            yield ctx.finding_at(
                f"0-d {str(v.dtype)[6:]} constant {n.target} baked into the "
                "graph; an exported program keeps its value — pass it as "
                "an argument", primitive="<constant>")


@register_rule("dead-equation", "info")
def dead_equation(ctx):
    """Nodes no output, in-place write or collective depends on: compute
    the step does for nothing (a metric that never reached the outputs)."""
    from .walker import op_name, written_args
    g = getattr(ctx.graph, "graph", ctx.graph)
    nodes = list(g.nodes)
    live = set()
    for n in reversed(nodes):
        if n.op == "output":
            live.update(n.all_input_nodes)
            continue
        if n.op != "call_function":
            continue
        effect = op_name(n) in COLLECTIVE_OPS or bool(written_args(n))
        if n in live or effect:
            live.add(n)
            live.update(n.all_input_nodes)
    by_node = {s.node: s for s in ctx.sites}
    groups: dict = {}
    for n in nodes:
        if n in live or n not in by_node:
            continue
        site = by_node[n]
        if not site.outs:
            continue
        groups.setdefault(source_summary(n), []).append(site)
    for _, sites in groups.items():
        first = sites[0]
        extra = (f" (+{len(sites) - 1} more in its dead chain)"
                 if len(sites) > 1 else "")
        yield ctx.finding(first, f"{first.op} output is never used{extra}; "
                                 "dead compute or a value that was meant "
                                 "to be returned")


_INT16_MAX = 2 ** 15 - 1


@register_rule("int4-grad-sync-overflow", "error")
def int4_grad_sync_overflow(ctx):
    """An int16 accumulation of int4-range values (|q| <= 7) too narrow
    for its count: a sum over n elements or an all-reduce over n ranks
    with 7·n past the int16 range wraps."""
    for site in ctx.sites:
        n = 0
        if site.op == "aten.sum" and site.ins and site.outs and \
                site.ins[0].dtype == torch.int16 and \
                site.outs[0].dtype == torch.int16:
            shape = site.ins[0].shape
            dims = site.node.args[1] if len(site.node.args) > 1 else None
            dims = range(len(shape)) if not dims else dims
            n = 1
            for d in dims:
                n *= int(shape[d])
        elif collective_kind(site) == "all_reduce" and site.ins and \
                site.ins[0].dtype == torch.int16 and site.group is not None:
            n = int(site.group.size())
        if n * 7 > _INT16_MAX:
            yield ctx.finding(
                site, f"int16 sum over {n} terms: int4-range values can "
                      f"reach {n * 7} > {_INT16_MAX} and wrap — accumulate "
                      "in int32")


_COMPRESSED_WIRE = (torch.int8, torch.uint8)


@register_rule("compressed-collective-link-mismatch", "warning")
def compressed_collective_link_mismatch(ctx):
    """int8/uint8-wire collectives over NVLink-only axes (the quantizer
    costs more than NVLink saves) and large float32 ones crossing a host
    ("dcn") axis; active when links were set or one axis crosses hosts."""
    if ctx.mesh is None:
        return
    from ..distributed.mesh import axis_links, explicit_axis_links
    explicit = explicit_axis_links(ctx.mesh)
    links = axis_links(ctx.mesh)
    if explicit is None and "dcn" not in links.values():
        return
    min_bytes = ctx.config.dcn_uncompressed_min_bytes
    from .cost import collective_payload
    for site in ctx.sites:
        kind = collective_kind(site)
        if kind not in ("all_reduce", "all_to_all", "all_gather",
                        "reduce_scatter") or not site.ins:
            continue
        axes = [ax for ax in collective_axes(site) if ax in links]
        if not axes:
            continue
        dt = site.ins[0].dtype
        nbytes = collective_payload(site)
        if dt in _COMPRESSED_WIRE:
            if all(links[ax] == "ici" for ax in axes):
                yield ctx.finding(
                    site, f"compressed ({str(dt)[6:]}-wire) {kind} over "
                          f"NVLink-only axes {axes!r}: the quantizer costs "
                          "more than the link saves — gate the policy to "
                          "dcn axes (grad_sync_dcn_only)")
        elif dt == torch.float32 and nbytes >= min_bytes:
            dcn = [ax for ax in axes if links[ax] == "dcn"]
            if dcn:
                yield ctx.finding(
                    site, f"uncompressed float32 {kind} "
                          f"({_human_bytes(nbytes)}) crosses host axis "
                          f"{dcn[0]!r}: use the compressed exchange "
                          "(grad_sync=\"int8\"/\"int4\") on it")


@register_rule("oversized-allgather", "warning")
def oversized_allgather(ctx):
    """An all-gather whose gathered tensor reaches the threshold: every
    rank materializes it whole."""
    thresh = ctx.config.allgather_warn_bytes
    from .cost import _payload
    for site in ctx.sites:
        if collective_kind(site) != "all_gather":
            continue
        out_b = _payload(site, "out")
        if out_b >= thresh:
            n = int(site.group.size()) if site.group is not None else 1
            yield ctx.finding(
                site, f"all_gather materializes {_human_bytes(out_b)} "
                      f"({n}x {_human_bytes(out_b / max(n, 1))}) on every "
                      f"rank (threshold {_human_bytes(thresh)}); keep the "
                      "tensor split")


def tuning_key(site: NodeSite):
    """(kernel, dtype, dims) of the tuning-DB row a kernel node's launch
    configuration resolves through, or None (a backward kernel: its
    forward's row covers the call)."""
    from ..ops import tuner
    key = KERNEL_OPS.get(site.op)
    node = site.node
    if key == "flash_fwd":
        q, k = _val(node.args[0]), _val(node.args[1])
        return ("flash_attention", q.dtype,
                tuner.flash_dims(q.shape[3], q.shape[1], k.shape[1]))
    if key == "ce_fwd":
        hid, w = _val(node.args[0]), _val(node.args[1])
        n, h = hid.shape
        v = w.shape[1]
        from ..ops.fused_ce import fwd_route
        kernel = (tuner.CE_SPLIT_KERNEL if fwd_route(hid.dtype, h) == "tiled"
                  else "fused_ce")
        return kernel, hid.dtype, tuner.ce_dims(h, v, n)
    if key == "paged":
        q, pool, tables = (_val(node.args[0]), _val(node.args[1]),
                           _val(node.args[3]))
        b, tq, h, d = q.shape
        return (tuner.PAGED_SPLIT_KERNEL, pool.dtype,
                tuner.paged_split_dims(b, h, d, pool.shape[1],
                                       tables.shape[1], tq))
    return None


@register_rule("pallas-config-untuned", "warning")
def pallas_config_untuned(ctx):
    """A kernel traced at a (shape bucket, dtype, device kind) with no
    tuning-DB row: its launch takes the compiled-in default (``python -m
    paddle_tpu_torch.ops.tuner`` on the card persists one)."""
    from ..ops import tuner
    db = tuner.get_db()
    dev = tuner.device_kind()
    seen = set()
    for site in ctx.sites:
        # a CPU tensor takes the plain version: no launch to configure
        if not site.is_kernel or _val(site.node.args[0]).device.type \
                != "cuda":
            continue
        tk = tuning_key(site)
        if tk is None:
            continue
        kernel, dtype, dims = tk
        keys = [tuner.make_key(kernel, d, dtype, dims)
                for d in (dev, tuner.GENERIC_DEVICE)]
        if any(db.lookup(k) for k in keys) or keys[0] in seen:
            continue
        seen.add(keys[0])
        yield ctx.finding(
            site, f"kernel {site.op.split('.')[-1]} runs with its default "
                  f"launch configuration: no tuning-DB row for {keys[0]!r} "
                  "(python -m paddle_tpu_torch.ops.tuner persists one)")


_GRAD_SYNC_KINDS = ("all_reduce", "all_to_all", "all_gather",
                    "reduce_scatter")
_GRAD_SYNC_AXES = frozenset(("data", "sharding", "sep"))
_GRAD_SYNC_MIN_BYTES = 4096.0


@register_rule("exchange-not-overlapped", "warning")
def exchange_not_overlapped(ctx):
    """A bucketed (K >= 2) gradient exchange whose collectives all cluster
    with no compute-heavy node between the first and the last: the
    backward finished before any bucket left, so the bucketing bought
    nothing. Silent when ``grad_sync_buckets`` is 0 or 1."""
    cfg = ctx.config
    if cfg.grad_sync_buckets < 2:
        return
    from .cost import collective_payload, node_flops
    nodes = linear_schedule(ctx.graph, ctx.mesh)
    sync, heavy, first = [], [], None
    for pos, node in enumerate(nodes):
        s = node.site
        if collective_kind(s) in _GRAD_SYNC_KINDS:
            axes = collective_axes(s)
            if axes and set(axes) <= _GRAD_SYNC_AXES and \
                    (s.group is None or s.group.size() > 1) and \
                    collective_payload(s) >= _GRAD_SYNC_MIN_BYTES:
                sync.append(pos)
                first = first or s
            continue
        if node_flops(s) >= cfg.overlap_min_flops:
            heavy.append(pos)
    if not sync or not heavy:
        return
    lo, hi = min(sync), max(sync)
    if any(lo < p < hi for p in heavy):
        return
    yield ctx.finding(
        first, f"grad_sync_buckets={cfg.grad_sync_buckets} but all "
               f"{len(sync)} gradient collectives cluster with no "
               "compute-heavy node between them: the exchange runs after "
               "the backward instead of under it (check the bucket hooks)")


@register_rule("replicated-large-param", "warning")
def replicated_large_param(ctx):
    """A large state input whole on every rank while a shardable axis of
    the mesh is larger than 1: ZeRO over it would cut its memory."""
    if ctx.mesh is None or ctx.in_specs is None:
        return
    cfg = ctx.config
    sizes = dict(ctx.mesh.shape)
    idle = [ax for ax in cfg.shardable_axes if sizes.get(ax, 1) > 1]
    if not idle:
        return
    from .sharding import from_pspec
    for i, n in enumerate(ctx.placeholders):
        if i >= len(ctx.in_specs):
            break
        if ctx.donated is not None and i not in ctx.donated:
            continue
        v = _val(n)
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            continue
        nbytes = float(v.numel() * v.dtype.itemsize)
        if nbytes < cfg.replicated_param_min_bytes:
            continue
        if from_pspec(ctx.in_specs[i], v.dim(), sizes).replicated:
            yield ctx.finding_at(
                f"input {i} ({_human_bytes(nbytes)}, {str(v.dtype)[6:]}"
                f"{list(v.shape)}) is whole on every rank while mesh axis "
                f"{idle[0]!r} (size {sizes[idle[0]]}) is shardable: ZeRO "
                f"would cut it {sizes[idle[0]]}x",
                primitive="<input>", path="<top>", eqn_index=-1)


@register_rule("collective-order-divergence", "error")
def collective_order_divergence(ctx):
    """The ranks' graphs issue different collective sequences: at the
    first difference every peer waits forever."""
    peers = ctx.peer_schedules
    if not peers:
        return
    from .schedule import _fmt_seq, extract_schedule, norm_key
    mine = [norm_key(s.key()) for s in extract_schedule(ctx.graph, ctx.mesh)]
    for rank in sorted(peers):
        theirs = [norm_key(k) for k in peers[rank]]
        if theirs == mine:
            continue
        i = 0
        while i < min(len(mine), len(theirs)) and mine[i] == theirs[i]:
            i += 1
        yield ctx.finding_at(
            f"rank {rank} issues another collective sequence than this "
            f"rank ({ctx.rank}): they part at collective #{i} "
            f"(here {_fmt_seq(tuple(mine[i:i + 2]))}, there "
            f"{_fmt_seq(tuple(theirs[i:i + 2]))}) and every peer of it "
            "hangs", primitive="<schedule>", path="<ranks>", eqn_index=i)
        return


@register_rule("program-family-schedule-drift", "error")
def program_family_schedule_drift(ctx):
    """Members of a registered ProgramFamily issue different collective
    schedules while the selector is not declared rank-invariant; reported
    once, on the primary member, during ``verify_family``."""
    fam = ctx.family
    if fam is None or fam.member != fam.primary:
        return
    fps = dict(fam.fingerprints)
    if len(set(fps.values())) <= 1 or fam.rank_invariant:
        return
    per = ", ".join(f"{m}={fp[:12]}" for m, fp in fps.items())
    yield ctx.finding_at(
        f"program family {fam.name!r} members issue different collective "
        f"schedules ({per}) but its selector ({fam.selector!r}) is not "
        "declared rank-invariant: a rank picking another member deadlocks "
        "every peer", primitive="<family>", path="<family>")
