"""Per-node FLOPs / bytes / peak live bytes over traced graphs, and the
compute/collective overlap model.

Port of ``paddle_tpu/analysis/cost.py``. Conventions, as the reference's:

- a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``): 2*B*M*N*K; a
  convolution 2 * out elements * (kernel window * in channels / groups);
  ``convolution_backward`` as the reference prices the two transposed
  convolutions JAX stages for it: the weight gradient as the forward, the
  input gradient as a convolution over the stride-dilated output gradient
  (2 * input elements * kernel window * out channels / groups, the
  dilation's zeros included), each only where its output is asked for.
- each of the port's kernels (``walker.KERNEL_OPS``): the FLOPs and bytes
  of :func:`kernel_work`, the formulas behind the kernel table's bound
  (``PERF.md`` §6) that ``chip_smoke.py`` computes its ``bound_ms`` from.
  A paged call's work depends on the rows' lengths, which a graph does not
  hold: it is priced at the block table's capacity.
- reductions: one FLOP per input element; pure data movement (views,
  copies, casts, gathers, ``where``, fills): 0; every other op one FLOP
  per output element. Collectives: 0 FLOPs (they are priced on the wire).
- bytes: operands + results of each node (a lower bound on memory
  traffic that ignores fusion, as the reference's).
- peak live bytes: a liveness scan over the issue order. A view or an
  in-place result takes no bytes of its own and keeps its input's storage
  live; the graph's inputs (the state: parameters, slots, residuals) and
  outputs stay live throughout; every other value is freed after its last
  use. An estimate of the working set, not the caching allocator.

Graphs are unrolled (``walker``): every node runs once a call, so the
reference's ``while_trips`` has no counterpart.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .report import CostRow, CostSummary
from .walker import (COLLECTIVE_OPS, KERNEL_OPS, NodeSite, arg_metas,
                     linear_schedule, source_summary, walk)

__all__ = [
    "kernel_work", "flash_fwd_work", "flash_bwd_work", "ce_fwd_work",
    "ce_bwd_work", "paged_work", "node_flops", "node_bytes",
    "matmul_node_flops", "conv_node_flops", "total_flops", "matmul_flops",
    "conv_flops", "total_bytes", "peak_live_bytes", "top_equations",
    "summarize", "collective_wire_bytes", "overlap_plan", "replay_overlap",
    "overlap_summary",
]

_F32 = 4


# ---------------------------------------------------------------------------
# the kernels' work (one formula, shared with chip_smoke.py's bound)
# ---------------------------------------------------------------------------

def flash_fwd_work(b, h, sq, sk, d, elem, causal=True) -> Tuple[float, float]:
    """The flash forward's (FLOPs, bytes): two products over the visible
    scores (half of them when causal and square), q, k, v read and out
    written once, lse written once."""
    prod = 2.0 * b * h * sq * sk * d * (0.5 if causal and sq == sk else 1.0)
    flops = 2.0 * prod
    moved = (2.0 * b * sq * h * d + 2.0 * b * sk * h * d) * elem + \
        b * h * sq * _F32
    return flops, moved


def flash_bwd_work(which, b, h, sq, sk, d, elem, causal=True
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of the dq (``which="dq"``: 3 products: the scores,
    dp, dq) or the dk/dv kernel (``"dkv"``: 4: the scores, dp, dk, dv);
    each reads q, k, v, do, lse and delta once and writes its gradients
    once."""
    prod = 2.0 * b * h * sq * sk * d * (0.5 if causal and sq == sk else 1.0)
    q_t = b * sq * h * d * elem
    k_t = b * sk * h * d * elem
    stat = b * h * sq * _F32
    read = 2 * q_t + 2 * k_t + 2 * stat
    if which == "dq":
        return 3.0 * prod, read + q_t
    return 4.0 * prod, read + 2 * k_t


def ce_fwd_work(n, h, v, elem) -> Tuple[float, float]:
    """The fused-CE forward's (FLOPs, bytes): hid·W once, hid and W read
    once, lse and tgt written once, labels read once."""
    return 2.0 * n * h * v, (n * h + h * v) * elem + 3.0 * n * _F32


def ce_bwd_work(which, n, h, v, elem) -> Tuple[float, float]:
    """The dh (``"dh"``) or dw (``"dw"``) kernel's (FLOPs, bytes): the
    logits recomputed and one more product (4·N·H·V), hid and W read once,
    lse, scale and labels read once, the gradient written once."""
    out = n * h * elem if which == "dh" else h * v * elem
    return 4.0 * n * h * v, (n * h + h * v) * elem + 3.0 * n * _F32 + out


def paged_work(b, h, tq, ctx, d, pool_elem, table_numel, q_elem=_F32
               ) -> Tuple[float, float]:
    """A paged decode/verify call's (FLOPs, bytes) over ``ctx`` cached
    tokens a row: QKᵀ and PV, the context's K and V read once, q, the
    table and the lengths read once, acc, m and l written once."""
    flops = 2.0 * 2.0 * b * h * tq * ctx * d
    moved = (2.0 * b * ctx * h * d * pool_elem + b * tq * h * d * q_elem
             + table_numel * 4 + b * 4 + b * h * tq * (d + 2) * _F32)
    return flops, moved


def kernel_work(site: NodeSite) -> Tuple[float, float]:
    """(FLOPs, bytes) of a kernel node from its input shapes."""
    key = KERNEL_OPS[site.op]
    node = site.node
    if key.startswith("flash"):
        q, k = node.args[0].meta["val"], node.args[1].meta["val"]
        b, sq, h, d = q.shape
        sk = k.shape[1]
        causal = bool(node.args[6] if key == "flash_fwd" else node.args[10])
        elem = q.dtype.itemsize
        if key == "flash_fwd":
            return flash_fwd_work(b, h, sq, sk, d, elem, causal)
        return flash_bwd_work(key[6:], b, h, sq, sk, d, elem, causal)
    if key.startswith("ce"):
        hid, w = node.args[0].meta["val"], node.args[1].meta["val"]
        n, h = hid.shape
        v = w.shape[1]
        if key == "ce_fwd":
            return ce_fwd_work(n, h, v, hid.dtype.itemsize)
        return ce_bwd_work(key[3:], n, h, v, hid.dtype.itemsize)
    q, pool, tables = (node.args[0].meta["val"], node.args[1].meta["val"],
                       node.args[3].meta["val"])
    b, tq, h, d = q.shape
    ctx = tables.shape[1] * pool.shape[1]
    return paged_work(b, h, tq, ctx, d, pool.dtype.itemsize,
                      tables.numel(), q.dtype.itemsize)


# ---------------------------------------------------------------------------
# per-node prices
# ---------------------------------------------------------------------------

_MATMUL = {"aten.mm": (0, 1), "aten.addmm": (1, 2), "aten.bmm": (0, 1),
           "aten.baddbmm": (1, 2)}
_REDUCE = frozenset({
    "aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.max",
    "aten.min", "aten.prod", "aten.argmax", "aten.argmin", "aten.any",
    "aten.all", "aten.var", "aten.std", "aten.var_mean", "aten.std_mean",
    "aten.logsumexp", "aten.norm", "aten.linalg_vector_norm",
    "aten.cumsum"})
_FREE = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
    "aten.permute", "aten.t", "aten.transpose", "aten.squeeze",
    "aten.unsqueeze", "aten.slice", "aten.select", "aten.as_strided",
    "aten.alias", "aten.detach", "aten._to_copy", "aten.to", "aten.clone",
    "aten.copy_", "aten.copy", "aten.cat", "aten.stack", "aten.index",
    "aten.index_select", "aten.gather", "aten.scatter", "aten.index_put",
    "aten.index_put_", "aten.embedding", "aten.where", "aten.arange",
    "aten.full", "aten.zeros", "aten.ones", "aten.empty",
    "aten.empty_like", "aten.zeros_like", "aten.ones_like",
    "aten.full_like", "aten.new_empty", "aten.new_zeros", "aten.new_ones",
    "aten.new_full", "aten.lift_fresh_copy", "aten.split",
    "aten.split_with_sizes", "aten.unbind", "aten.constant_pad_nd",
    "aten.fill_", "aten.fill", "aten.zero_", "aten._unsafe_index",
    "aten.narrow", "aten.flip", "aten.roll", "aten.repeat",
    "aten.masked_fill", "aten.scalar_tensor", "aten.empty_strided",
    "aten.contiguous", "aten.unfold", "aten.diagonal", "aten.tril",
    "aten.triu", "aten.embedding_dense_backward", "aten.slice_backward",
    "aten.select_backward", "aten.detach_", "aten.set_",
    "aten._local_scalar_dense", "aten.lift_fresh", "aten.view_as",
    "aten.expand_as", "aten.chunk", "aten.split_copy", "aten.resize_",
    "aten.masked_fill_", "aten.index_add", "aten.index_add_",
    "aten.scatter_add", "aten.scatter_add_", "aten.index_copy",
    "aten.rand", "aten.randn", "aten.randint", "aten.rand_like",
    "aten.bernoulli", "aten.randperm", "aten.uniform_", "aten.normal_",
})


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def matmul_node_flops(site: NodeSite) -> float:
    """2*B*M*N*K of a matmul node (0 for any other)."""
    pos = _MATMUL.get(site.op)
    if pos is None:
        return 0.0
    a = site.node.args[pos[0]].meta["val"].shape
    b = site.node.args[pos[1]].meta["val"].shape
    batch = _numel(a[:-2])
    return 2.0 * batch * a[-2] * a[-1] * b[-1]


def conv_node_flops(site: NodeSite) -> float:
    """A convolution's FLOPs (forward and backward) as the reference's
    ``_conv_flops`` prices the convolutions JAX stages (module docstring);
    0 for any other node."""
    node = site.node
    if site.op == "aten.convolution":
        out = node.meta["val"]
        w = node.args[1].meta["val"].shape
        transposed, groups = bool(node.args[6]), int(node.args[8])
        in_ch = w[0] // groups if transposed else w[1]
        return 2.0 * out.numel() * _numel(w[2:]) * in_ch
    if site.op == "aten.convolution_backward":
        gout = node.args[0].meta["val"]
        x = node.args[1].meta["val"]
        w = node.args[2].meta["val"].shape
        transposed, groups = bool(node.args[7]), int(node.args[9])
        mask = node.args[10]
        window = _numel(w[2:])
        tot = 0.0
        if transposed:     # the forward's roles swapped
            in_ch = w[0] // groups
            if mask[1]:
                tot += 2.0 * gout.numel() * window * in_ch
            if mask[0]:
                tot += 2.0 * x.numel() * window * w[1]
            return tot
        if mask[1]:        # dW: the forward's product
            tot += 2.0 * gout.numel() * window * w[1]
        if mask[0]:        # dX: over the stride-dilated output gradient
            tot += 2.0 * x.numel() * window * w[0] / groups
        return tot
    return 0.0


def node_flops(site: NodeSite) -> float:
    """FLOPs of one node (module docstring)."""
    if site.op in KERNEL_OPS:
        return kernel_work(site)[0]
    if site.op in _MATMUL:
        return matmul_node_flops(site)
    if site.op in ("aten.convolution", "aten.convolution_backward"):
        return conv_node_flops(site)
    if site.op in COLLECTIVE_OPS or site.op in _FREE:
        return 0.0
    if site.op in _REDUCE:
        return float(sum(m.numel for m in site.ins[:1]))
    return float(sum(m.numel for m in site.outs))


def node_bytes(site: NodeSite) -> float:
    """Operand + result bytes of one node (a kernel: :func:`kernel_work`)."""
    if site.op in KERNEL_OPS:
        return kernel_work(site)[1]
    return float(sum(m.nbytes for m in site.ins) +
                 sum(m.nbytes for m in site.outs))


# ---------------------------------------------------------------------------
# totals
# ---------------------------------------------------------------------------

def _sites(graph):
    return graph if isinstance(graph, list) else list(walk(graph))


def total_flops(graph) -> float:
    """Every node's FLOPs."""
    return float(sum(node_flops(s) for s in _sites(graph)))


def matmul_flops(graph) -> float:
    """Matmul FLOPs: the ATen matmuls' (the reference's dot_general-only
    metric) and the kernel nodes', whose work is matmuls (the flash
    kernels' products, the CE kernels' hid·W)."""
    return float(sum(matmul_node_flops(s) if s.op in _MATMUL else
                     kernel_work(s)[0] if s.op in KERNEL_OPS else 0.0
                     for s in _sites(graph)))


def conv_flops(graph) -> float:
    """Convolution FLOPs, forward and backward (the reference's
    ``conv_general_dilated`` total)."""
    return float(sum(conv_node_flops(s) for s in _sites(graph)))


def total_bytes(graph) -> float:
    return float(sum(node_bytes(s) for s in _sites(graph)))


def _val_bytes(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.numel() * v.dtype.itemsize)
    if isinstance(v, (list, tuple)):
        return float(sum(_val_bytes(x) for x in v))
    return 0.0


def peak_live_bytes(graph) -> float:
    """The liveness peak over the issue order (module docstring)."""
    import operator
    g = getattr(graph, "graph", graph)
    nodes = list(g.nodes)
    root: Dict[object, object] = {}
    size: Dict[object, float] = {}
    last: Dict[object, int] = {}
    pinned = set()
    for i, n in enumerate(nodes):
        if n.op in ("placeholder", "get_attr"):
            root[n] = n
            size[n] = _val_bytes(n.meta.get("val"))
            pinned.add(n)
            continue
        if n.op == "output":
            for a in n.all_input_nodes:
                pinned.add(root.get(a, a))
            continue
        schema = getattr(n.target, "_schema", None)
        alias = (n.target is operator.getitem
                 or (schema is not None and schema.returns
                     and schema.returns[0].alias_info is not None)
                 or n.target.__class__.__name__ == "OpOverload"
                 and str(n.target).startswith("c10d."))
        if alias and n.args and isinstance(n.args[0], torch.fx.Node):
            root[n] = root.get(n.args[0], n.args[0])
        else:
            root[n] = n
            size[n] = _val_bytes(n.meta.get("val"))
        for a in n.all_input_nodes:
            last[root.get(a, a)] = i
    cur = sum(size[r] for r in pinned if r in size)
    peak = cur
    freed = set()
    for i, n in enumerate(nodes):
        if n.op in ("placeholder", "get_attr", "output"):
            continue
        if root.get(n) is n:
            cur += size.get(n, 0.0)
            peak = max(peak, cur)
            if n not in last and n not in pinned:
                cur -= size.get(n, 0.0)
                freed.add(n)
        for a in n.all_input_nodes:
            r = root.get(a, a)
            if r in pinned or r in freed or last.get(r) != i:
                continue
            cur -= size.get(r, 0.0)
            freed.add(r)
    return float(peak)


# ---------------------------------------------------------------------------
# the compute/collective overlap model
# ---------------------------------------------------------------------------

# ring-model wire cost per rank, as a multiple of the payload: all-reduce
# 2(n-1)/n, all-gather / reduce-scatter / all-to-all (n-1)/n, a broadcast
# or a point-to-point hop one payload. "out": the payload is the result
# (an all-gather's gathered tensor)
_COLL_RING = {
    "all_reduce": ("in", 2.0),
    "all_gather": ("out", 1.0),
    "reduce_scatter": ("in", 1.0),
    "all_to_all": ("in", 1.0),
    "broadcast": ("in", None),
    "send": ("in", None),
    "recv": ("in", None),
    "barrier": ("in", 0.0),
}


def _payload(site: NodeSite, side: str) -> float:
    node = site.node
    kind = COLLECTIVE_OPS[site.op][0]
    if kind in ("all_gather", "reduce_scatter", "all_to_all"):
        arg = node.args[0] if side == "out" else node.args[1]
    else:
        arg = node.args[0]
    return float(sum(m.nbytes for m in arg_metas(arg)))


def collective_wire_bytes(site: NodeSite, n: int) -> float:
    """Ring-model bytes one rank moves for a collective node over an
    ``n``-rank group, from the traced dtypes (an int8 payload is visibly
    4x cheaper than a float32 one)."""
    side, factor = _COLL_RING[COLLECTIVE_OPS[site.op][0]]
    payload = _payload(site, side)
    if factor is None:
        return payload
    return factor * (n - 1) / max(n, 1) * payload


def collective_payload(site: NodeSite) -> float:
    """A collective's operand bytes (the reference's invars)."""
    return _payload(site, "in")


def _group_size(site: NodeSite) -> int:
    g = site.group
    try:
        return int(g.size()) if g is not None else 1
    except Exception:
        return 1


def overlap_plan(graph, mesh) -> dict:
    """The staged half of :func:`overlap_summary`: each node of the issue
    order classified as compute (FLOPs) or collective (ring wire bytes and
    link class, over its group's size), and the dataflow edges. Pure data:
    :func:`replay_overlap` re-prices it under other constants without a
    new trace. The port has no implicit resharding (``sharding.py``): the
    plan's ``reshard`` is empty."""
    from ..distributed.mesh import axis_links
    links = axis_links(mesh) if mesh is not None else {}
    nodes = linear_schedule(graph, mesh)
    entries = []
    for node in nodes:
        s = node.site
        entry = {"primitive": s.op, "path": "<top>", "index": s.index}
        n_g = _group_size(s) if s.op in COLLECTIVE_OPS else 1
        if s.op in COLLECTIVE_OPS and n_g > 1:
            axes = s.axes or ()
            entry["coll"] = True
            entry["link"] = ("dcn" if any(links.get(ax) == "dcn"
                                          for ax in axes) else "ici")
            entry["wire"] = collective_wire_bytes(s, n_g)
            entry["trips"] = 1.0
            entry["axes"] = list(axes)
        else:
            entry["coll"] = False
            entry["flops"] = node_flops(s)
        entries.append(entry)
    producer = {}
    for j, node in enumerate(nodes):
        for o in node.out_ids:
            producer[o] = j
    consumers = [[] for _ in nodes]
    indeg = [0] * len(nodes)
    for j, node in enumerate(nodes):
        deps = {producer[i] for i in node.in_ids
                if i in producer and producer[i] < j}
        indeg[j] = len(deps)
        for d in deps:
            consumers[d].append(j)
    return {"nodes": entries, "consumers": consumers, "indeg": indeg,
            "reshard": {}}


def replay_overlap(plan: dict, peak_flops=None, bandwidths=None,
                   latencies=None, include_timeline: bool = False) -> dict:
    """The reference's two-stream list scheduling over a staged
    :func:`overlap_plan` (``cost.py:245``, copied): one compute stream at
    ``peak_flops``, one wire stream a link class, each collective issued
    as soon as its operands exist; ``bandwidths``/``latencies`` (by link
    class) re-price it without a new trace. Returns ``compute_time``,
    ``collective_time``, ``stalled_time``, ``overlap_efficiency`` (None
    without collectives), ``n_collectives``, ``n_reshard``,
    ``reshard_time``, ``makespan``, ``peak_flops`` (and ``timeline``)."""
    import heapq
    from ..distributed.mesh import link_bandwidth, link_latency
    if peak_flops is None:
        from .. import telemetry as _telemetry
        peak_flops = _telemetry.peak_flops_per_sec()
    peak_flops = max(float(peak_flops), 1.0)

    def _bw(link):
        if bandwidths and link in bandwidths:
            return float(bandwidths[link])
        return link_bandwidth(link)

    def _lat(link):
        if latencies and link in latencies:
            return float(latencies[link])
        return link_latency(link)

    entries = plan["nodes"]
    consumers = plan["consumers"]
    indeg = list(plan["indeg"])
    node_ready = [0.0] * len(entries)
    heap = [(0.0, j) for j in range(len(entries)) if indeg[j] == 0]
    heapq.heapify(heap)
    wire_free: Dict[str, float] = {}
    t = 0.0
    coll_total = compute_total = 0.0
    n_coll = 0
    timeline = [] if include_timeline else None
    while heap:
        rt, j = heapq.heappop(heap)
        e = entries[j]
        if e["coll"]:
            link = e["link"]
            dur = e["wire"] / _bw(link) + _lat(link) * e["trips"]
            start = max(rt, wire_free.get(link, 0.0))
            done = start + dur
            wire_free[link] = done
            coll_total += dur
            n_coll += 1
            if timeline is not None:
                timeline.append({
                    "kind": "collective", "primitive": e["primitive"],
                    "path": e["path"], "eqn_index": e["index"],
                    "axes": e["axes"], "link": link, "bytes": e["wire"],
                    "start": start, "end": done})
        else:
            dur = e["flops"] / peak_flops
            start = max(t, rt)
            idle = start - t
            done = start + dur
            t = done
            compute_total += dur
            if timeline is not None and (e["flops"] > 0 or idle > 0):
                timeline.append({
                    "kind": "compute", "primitive": e["primitive"],
                    "path": e["path"], "eqn_index": e["index"],
                    "flops": e["flops"], "start": start, "end": done,
                    "stall": idle})
        for c in consumers[j]:
            if done > node_ready[c]:
                node_ready[c] = done
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(heap, (node_ready[c], c))
    end = max([t] + list(wire_free.values()))
    stall = max(0.0, end - compute_total)
    shadowed = max(0.0, coll_total - stall)
    eff = (None if coll_total <= 0.0
           else max(0.0, min(1.0, shadowed / coll_total)))
    if timeline is not None:
        timeline.sort(key=lambda e: (e["start"], e["eqn_index"]))
    out = {"compute_time": compute_total, "collective_time": coll_total,
           "stalled_time": stall, "overlap_efficiency": eff,
           "n_collectives": n_coll, "n_reshard": 0, "reshard_time": 0.0,
           "makespan": end, "peak_flops": peak_flops}
    if timeline is not None:
        out["timeline"] = timeline
    return out


def overlap_summary(graph, mesh, peak_flops=None,
                    include_timeline: bool = False) -> dict:
    """:func:`overlap_plan` then :func:`replay_overlap` (the reference's
    ``overlap_summary``): the predicted step of one traced graph."""
    return replay_overlap(overlap_plan(graph, mesh), peak_flops=peak_flops,
                          include_timeline=include_timeline)


# ---------------------------------------------------------------------------
# the top-k table and the summary
# ---------------------------------------------------------------------------

def top_equations(graph, k: int = 10) -> List[CostRow]:
    """The k most expensive nodes by FLOPs (bytes break ties, so large
    data movers surface even at 0 FLOPs)."""
    rows = []
    for s in _sites(graph):
        f, b = node_flops(s), node_bytes(s)
        if f <= 0 and b <= 0:
            continue
        rows.append(CostRow(
            primitive=s.op, path="<top>", eqn_index=s.index, flops=f,
            bytes=b,
            out=" ".join(m.sig() for m in s.outs), trips=1.0,
            source=source_summary(s.node)))
    rows.sort(key=lambda r: (-r.flops, -r.bytes))
    return rows[:k]


def summarize(graph, k: int = 10) -> CostSummary:
    sites = list(walk(graph))
    g = getattr(graph, "graph", graph)
    arg_bytes = float(sum(_val_bytes(n.meta.get("val")) for n in g.nodes
                          if n.op == "placeholder"))
    return CostSummary(
        total_flops=total_flops(sites), matmul_flops=matmul_flops(sites),
        total_bytes=total_bytes(sites), peak_live_bytes=peak_live_bytes(g),
        arg_bytes=arg_bytes, top=top_equations(sites, k))
