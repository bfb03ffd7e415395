"""Auto-parallel planning: search the parallelism space on the cost model.

Port of ``paddle_tpu/distributed/auto.py``; the arithmetic is the
reference's, copied. :func:`plan_search` searches mesh degree
factorizations over data / sharding / pipe / model / sep, the per-axis
``grad_sync`` policy, the exchange's bucket count, remat and the
micro-batch count, and ranks the candidates by predicted step time:

1. *analytic tier*: every candidate is pruned by static bounds and the
   memory model (fit in ``headroom * hbm_bytes``), then priced in closed
   form: compute at ``telemetry.peak_flops_per_sec()``, the gradient
   exchange's wire seconds (``compressed.wire_bytes_per_rank``) over
   ``mesh.link_bandwidth``/``link_latency`` (an H100 box's NVLink and
   InfiniBand, or the calibration DB's fitted constants), the
   tensor/sep/pipeline collectives, the GPipe bubble and what the bucketed
   exchange hides under the backward.
2. *staged tier*: the analytic top ``stage_top_k`` are built for real by
   the caller's ``builder(plan) -> (trainer, inputs, labels)``, their
   ``ParallelTrainer.staged_graph`` traced on fake tensors and re-priced
   by ``analysis.cost.overlap_plan`` + ``replay_overlap`` (the makespan of
   the traced step); their memory takes ``cost.peak_live_bytes`` of it.

:func:`plan` keeps the memory-first choice (the cheapest-communication
layout that fits). ``hbm_bytes`` defaults to the card's memory
(``torch.cuda.get_device_properties(0).total_memory``) when a card is
present; without one the caller passes it (there is no default memory
size for a machine without a card).

Estimates use the standard transformer accounting:
  params/device    = P * b_param / (tp * pp * zshard)
  grads/device     = P * b_param / (tp * pp * zshard_g)
  opt state/device = P * 8 bytes (adam m+v fp32) / (tp * pp * zshard_o)
  activations      ~ L/pp * B * S * H * c_act * b_act / (tp * sep)
                     (remat / ~L/pp; B = per-device per-microbatch)

A planner, not a profiler: its numbers rank layouts; ``chip_smoke.py``'s
``analysis`` phase holds the prediction against the measured step
(``calibration_drift_ratio{key=planner_step_time}``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["MemoryEstimate", "Plan", "TimeBreakdown", "plan",
           "plan_search", "score_plan", "resharding_cost",
           "GRAD_SYNC_POLICIES"]

_ADAM_BYTES = 8          # m + v, fp32 each
_ACT_COEFF = 18          # bytes-ish per (B,S,H) element across a block's
                         # live set with flash attention (no S^2 term).
                         # FALLBACK ONLY: when a candidate is staged, the
                         # activation term defers to analysis/cost.py
                         # peak-live-bytes over the traced step (see
                         # MemoryEstimate.source).

# grad_sync wire policies in preference order (ties break toward the
# earlier, simpler policy): exact fp32, bf16 halved, EQuARX-style int8
# (~4x fewer bytes), nibble-packed int4 (~7x).
GRAD_SYNC_POLICIES = ("fp32", "bf16", "int8", "int4")


@dataclass
class MemoryEstimate:
    params: float
    grads: float
    opt_state: float
    activations: float
    #: which model produced the ACTIVATION term: ``"act-coefficient"``
    #: is the hand-rolled ``_ACT_COEFF * B*S*H`` sizing (no traced step
    #: available — the pre-staging fallback); ``"peak-live-bytes/chip"``
    #: means the candidate was staged and ``analysis.cost
    #: .peak_live_bytes`` over its traced step (divided across cards)
    #: replaced the coefficient estimate.
    source: str = "act-coefficient"

    @property
    def total(self) -> float:
        return self.params + self.grads + self.opt_state + self.activations


@dataclass
class TimeBreakdown:
    """Per-candidate predicted step-time rationale (seconds).

    ``total`` is stored, not derived: the analytic tier sums its terms;
    the staged tier uses the overlap model's makespan (where the bubble
    lives inside ``compute`` and the reshard share of the stall is
    inside ``exposed_collective``)."""
    total: float
    compute: float
    bubble: float
    exposed_collective: float
    reshard: float
    collective: float = 0.0      # total collective seconds incl. hidden
    tier: str = "analytic"       # "analytic" | "staged"

    def to_dict(self) -> dict:
        return {"total_s": self.total, "compute_s": self.compute,
                "bubble_s": self.bubble,
                "exposed_collective_s": self.exposed_collective,
                "reshard_s": self.reshard,
                "collective_s": self.collective, "tier": self.tier}


@dataclass
class Plan:
    degrees: Dict[str, int]
    per_device: MemoryEstimate
    hbm_bytes: float
    rationale: List[str] = field(default_factory=list)
    remat: bool = False
    grad_sync: str = "fp32"
    grad_sync_dcn_only: bool = False
    grad_sync_buckets: int = 1
    micro_batches: int = 1
    zero_stage: int = 1
    predicted: Optional[TimeBreakdown] = None

    @property
    def fits(self) -> bool:
        return self.per_device.total <= self.hbm_bytes

    def build_mesh(self):
        from .mesh import build_mesh
        return build_mesh({k: v for k, v in self.degrees.items() if v > 1}
                          or {"data": 1})

    def apply(self, *, mesh=None, build_mesh: bool = False) -> dict:
        """A ready ``ParallelTrainer`` kwargs dict for this plan.

        Microbatch mapping: with a pipe degree the count is the pipeline
        ``micro_batches``; without one a searched microbatch count > 1
        becomes ``accumulate_steps`` (GradientMerge — same per-device
        activation footprint win, no pipeline schedule). Pass
        ``build_mesh=True`` to build (and install) the plan's mesh and
        include it, or ``mesh=`` to use an existing one."""
        pp = self.degrees.get("pipe", 1)
        kw = {
            "micro_batches": self.micro_batches if pp > 1 else 1,
            "accumulate_steps": (1 if pp > 1
                                 else max(1, self.micro_batches)),
            "remat": self.remat,
            "zero_stage": self.zero_stage,
            "grad_sync": self.grad_sync,
            "grad_sync_buckets": self.grad_sync_buckets,
            "grad_sync_dcn_only": self.grad_sync_dcn_only,
        }
        if build_mesh:
            kw["mesh"] = self.build_mesh()
        elif mesh is not None:
            kw["mesh"] = mesh
        return kw

    def to_dict(self) -> dict:
        """JSON-stable summary (determinism tests)."""
        return {
            "degrees": {k: self.degrees[k]
                        for k in sorted(self.degrees)},
            "remat": self.remat, "grad_sync": self.grad_sync,
            "grad_sync_dcn_only": self.grad_sync_dcn_only,
            "grad_sync_buckets": self.grad_sync_buckets,
            "micro_batches": self.micro_batches,
            "zero_stage": self.zero_stage,
            "memory": {"params": self.per_device.params,
                       "grads": self.per_device.grads,
                       "opt_state": self.per_device.opt_state,
                       "activations": self.per_device.activations,
                       "total": self.per_device.total,
                       "source": self.per_device.source},
            "predicted": (self.predicted.to_dict()
                          if self.predicted else None),
            "rationale": list(self.rationale),
        }


def _factorizations(n: int):
    """All (data, sharding, model, pipe, sep) with product n; model and
    sep powers of 2 (TP wants even head splits, sep the even ring
    splits). Deterministic enumeration order — the planner's candidate
    list must be reproducible across processes."""
    out = []
    def divs(x):
        return [d for d in range(1, x + 1) if x % d == 0]
    for pipe in divs(n):
        for model in divs(n // pipe):
            if model & (model - 1):      # non-power-of-2 TP: skip
                continue
            for sep in divs(n // (pipe * model)):
                if sep & (sep - 1):      # non-power-of-2 sep: skip
                    continue
                rest = n // (pipe * model * sep)
                for shard in divs(rest):
                    out.append({"data": rest // shard, "sharding": shard,
                                "model": model, "pipe": pipe, "sep": sep})
    return out


def _estimate(n_params: float, deg: Dict[str, int], *, layers, hidden,
              seq_len, batch_per_device, param_bytes, zero_stage,
              remat) -> MemoryEstimate:
    tp, pp, z = deg["model"], deg["pipe"], deg["sharding"]
    sep = deg.get("sep", 1)
    shard_p = z if zero_stage >= 3 else 1
    shard_g = z if zero_stage >= 2 else 1
    shard_o = z if zero_stage >= 1 else 1
    mp = tp * pp
    params = n_params * param_bytes / (mp * shard_p)
    grads = n_params * param_bytes / (mp * shard_g)
    opt = n_params * _ADAM_BYTES / (mp * shard_o)
    act = (layers / pp) * batch_per_device * seq_len * hidden \
        * _ACT_COEFF / (tp * sep)
    if remat:
        act = act / max(1.0, layers / pp) + \
            batch_per_device * seq_len * hidden * _ACT_COEFF / (tp * sep)
    return MemoryEstimate(params, grads, opt, act)


def _comm_cost(deg: Dict[str, int]) -> tuple:
    """Sort key: prefer fewer model/pipe/sep degrees (TP and sep pay
    per-layer collectives, PP pays bubble + schedule complexity), then
    less ZeRO resharding, then more plain DP."""
    return (deg["pipe"], deg["model"], deg.get("sep", 1),
            deg["sharding"], -deg["data"])


def _card_bytes(hbm_bytes: Optional[float]) -> float:
    """``hbm_bytes``, else the card's memory; ValueError without a card."""
    if hbm_bytes is not None:
        return float(hbm_bytes)
    import torch
    if not torch.cuda.is_available():
        raise ValueError("hbm_bytes: no card to read its memory from; pass "
                         "the memory of the card you plan for")
    return float(torch.cuda.get_device_properties(0).total_memory)


def _links() -> Dict[str, str]:
    """The current mesh's axis links; every axis "ici" without a mesh."""
    from . import mesh as _mesh
    return _mesh.axis_links(None) if _mesh.get_mesh() is not None else {}


def plan(n_params: float, n_devices: int, *, layers: int = 24,
         hidden: int = 2048, seq_len: int = 2048,
         batch_per_device: int = 8, hbm_bytes: Optional[float] = None,
         param_bytes: int = 2, zero_stage: int = 1,
         remat: Optional[bool] = None, max_model: int = 8,
         headroom: float = 0.9) -> Plan:
    """Propose mesh degrees for training an n_params transformer on
    n_devices chips. Searches (data, sharding, model, pipe, sep)
    factorizations and returns the cheapest-communication Plan that fits
    ``headroom * hbm_bytes``; raises ValueError if nothing fits (with
    the closest layout's numbers in the message). Memory-first: for a
    predicted-step-TIME ranking over the same space (plus grad_sync
    policy / buckets / microbatches), use :func:`plan_search`."""
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    hbm_bytes = _card_bytes(hbm_bytes)
    budget = headroom * hbm_bytes
    candidates = []
    for deg in _factorizations(n_devices):
        if deg["model"] > max_model or deg["model"] > max(1, hidden // 128):
            continue
        if deg["pipe"] > max(1, layers):
            continue
        if seq_len % deg["sep"]:
            continue
        for use_remat in ((remat,) if remat is not None else (False, True)):
            est = _estimate(n_params, deg, layers=layers, hidden=hidden,
                            seq_len=seq_len,
                            batch_per_device=batch_per_device,
                            param_bytes=param_bytes,
                            zero_stage=zero_stage, remat=use_remat)
            candidates.append((deg, use_remat, est))
    fitting = [(d, r, e) for d, r, e in candidates if e.total <= budget]
    if not fitting:
        best = min(candidates, key=lambda t: t[2].total)
        raise ValueError(
            f"no layout fits: closest is {best[0]} "
            f"(remat={best[1]}) at {best[2].total / 1e9:.1f} GB/device vs "
            f"budget {budget / 1e9:.1f} GB — add devices, raise "
            f"zero_stage, or shrink the per-device batch")
    deg, use_remat, est = min(
        fitting, key=lambda t: (_comm_cost(t[0]), t[1]))
    why = [
        f"{n_devices} devices -> data={deg['data']} sharding="
        f"{deg['sharding']} model={deg['model']} pipe={deg['pipe']} "
        f"sep={deg['sep']}",
        f"per-device: params {est.params/1e9:.2f} GB + grads "
        f"{est.grads/1e9:.2f} GB + opt {est.opt_state/1e9:.2f} GB + act "
        f"{est.activations/1e9:.2f} GB = {est.total/1e9:.2f} GB "
        f"(budget {budget/1e9:.1f} GB, act via {est.source})",
        f"zero_stage={zero_stage}, remat={use_remat}",
    ]
    if deg["model"] > 1:
        why.append("TP engaged: params exceed what DP+ZeRO fits alone")
    if deg["pipe"] > 1:
        why.append("PP engaged: per-layer state exceeds TP ceiling")
    if deg["sep"] > 1:
        why.append("sep engaged: context parallelism splits the "
                   "sequence-sized activation term")
    p = Plan(degrees=deg, per_device=est, hbm_bytes=hbm_bytes,
             rationale=why, zero_stage=zero_stage)
    p.remat = use_remat
    return p


# ---------------------------------------------------------------------------
# predicted-step-time search (the planner)
# ---------------------------------------------------------------------------

def _axis_link(links: Dict[str, str], axis: str) -> str:
    return links.get(axis, "ici")


def _predict_time(n_params: float, deg: Dict[str, int], *, layers, hidden,
                  seq_len, global_batch, param_bytes, policy, dcn_only,
                  buckets, remat, micro, zero_stage, links, peak_flops,
                  bw: Callable[[str], float],
                  lat: Callable[[str], float]) -> TimeBreakdown:
    """Closed-form per-step time for one candidate (the analytic tier).

    First-order transformer accounting at a FIXED global batch so every
    candidate prices the same optimization work: compute = 6*P*tokens /
    (chips * peak) (+1/3 re-forward under remat), gpipe bubble
    (pp-1)/M, ring-model wire seconds for the DP/ZeRO gradient exchange
    (``compressed.wire_bytes_per_rank`` — compression priced as TIME on
    the axis's calibrated link), per-layer TP and sep (ring-attention
    K/V) collectives, pipeline boundary p2p, and the ZeRO-3 parameter
    all-gather. K>=2 exchange buckets hide wire time under the
    remaining backward compute (engine's per-bucket custom_vjp hooks);
    K=1 is fully exposed after the backward."""
    from . import compressed
    d, z = deg["data"], deg["sharding"]
    tp, pp, sep = deg["model"], deg["pipe"], deg.get("sep", 1)
    n = d * z * tp * pp * sep
    tokens = float(global_batch) * seq_len
    flops = 6.0 * n_params * tokens
    if remat:
        flops *= 4.0 / 3.0           # re-forward during backward
    compute = flops / (n * peak_flops)
    bubble = compute * (pp - 1) / max(1, micro) if pp > 1 else 0.0

    # gradient exchange over the data (all-reduce) and sharding
    # (reduce-scatter + all-gather) axes; dcn_only gates compression to
    # DCN-linked axes (ICI hops stay fp32), mirroring the engine knob.
    numel_local = n_params / (tp * pp)
    exch = 0.0
    for axis, g in (("data", d), ("sharding", z)):
        if g <= 1:
            continue
        link = _axis_link(links, axis)
        pol = policy if (not dcn_only or link == "dcn") else "fp32"
        wire = compressed.wire_bytes_per_rank(int(numel_local), g, pol)
        exch += wire / bw(link) + buckets * lat(link)
    bwd = compute * 2.0 / 3.0
    hidden_t = 0.0 if buckets <= 1 else min(exch,
                                            bwd * (buckets - 1) / buckets)
    exch_exposed = exch - hidden_t

    # per-layer activation collectives. Activations are bf16 (2 bytes);
    # per-device activation elements at the full local batch:
    act_elems = (global_batch / (d * z)) * (seq_len / sep) * hidden
    act_bytes = act_elems * 2.0
    tp_t = sep_t = p2p_t = 0.0
    if tp > 1:
        link = _axis_link(links, "model")
        wire = 4.0 * (layers / pp) * act_bytes * 2.0 * (tp - 1) / tp
        tp_t = wire / bw(link) + 4.0 * (layers / pp) * lat(link)
    if sep > 1:
        link = _axis_link(links, "sep")
        wire = 2.0 * (layers / pp) * act_bytes * (sep - 1)
        sep_t = wire / bw(link) + (sep - 1) * (layers / pp) * lat(link)
    if pp > 1:
        link = _axis_link(links, "pipe")
        wire = 2.0 * (pp - 1) * act_bytes
        p2p_t = wire / bw(link) + 2.0 * (pp - 1) * max(1, micro) \
            * lat(link)
    z3_t = 0.0
    if zero_stage >= 3 and z > 1:
        link = _axis_link(links, "sharding")
        wire = 2.0 * n_params * param_bytes / (tp * pp) * (z - 1) / z
        z3_t = wire / bw(link) + 2.0 * lat(link)

    exposed = exch_exposed + tp_t + sep_t + p2p_t + z3_t
    coll = exch + tp_t + sep_t + p2p_t + z3_t
    total = compute + bubble + exposed
    return TimeBreakdown(total=total, compute=compute, bubble=bubble,
                         exposed_collective=exposed, reshard=0.0,
                         collective=coll, tier="analytic")


def _policy_rank(policy: str) -> int:
    try:
        return GRAD_SYNC_POLICIES.index(policy)
    except ValueError:
        return len(GRAD_SYNC_POLICIES)


def _tiebreak(p: Plan) -> tuple:
    """Deterministic total order below the predicted time: simplest
    config first (fewer exotic degrees, exact policy, fewer buckets /
    microbatches, no remat)."""
    return (_comm_cost(p.degrees), _policy_rank(p.grad_sync),
            p.grad_sync_dcn_only, p.grad_sync_buckets, p.micro_batches,
            p.remat)


def score_plan(p: Plan, n_params: float, *, layers, hidden, seq_len,
               global_batch, param_bytes=2, peak_flops=None) -> Plan:
    """Analytically (re-)price one plan in place — the scorer
    plan_search uses, exposed so baselines (all-DP, ``plan()``'s
    memory-first pick) can be priced with the SAME calibrated model the
    acceptance comparison needs."""
    from . import mesh as _mesh
    if peak_flops is None:
        from .. import telemetry as _telemetry
        peak_flops = _telemetry.peak_flops_per_sec()
    links = _links()
    p.predicted = _predict_time(
        n_params, p.degrees, layers=layers, hidden=hidden,
        seq_len=seq_len, global_batch=global_batch,
        param_bytes=param_bytes, policy=p.grad_sync,
        dcn_only=p.grad_sync_dcn_only, buckets=p.grad_sync_buckets,
        remat=p.remat, micro=p.micro_batches, zero_stage=p.zero_stage,
        links=links, peak_flops=max(float(peak_flops), 1.0),
        bw=_mesh.link_bandwidth, lat=_mesh.link_latency)
    return p


def _stage_score(p: Plan, builder: Callable, peak_flops) -> Plan:
    """Exact tier: trace the candidate's real trainer step
    (``staged_graph``) and score it with the overlap list scheduler,
    priced by the calibrated constants. Also refines the memory estimate:
    the activation term defers to ``cost.peak_live_bytes`` over the traced
    step (per card) instead of the ``_ACT_COEFF`` coefficient."""
    from ..analysis import cost as _cost
    trainer, inputs, labels = builder(p)
    graph = trainer.staged_graph(inputs, labels)
    oplan = _cost.overlap_plan(graph, trainer.mesh)
    s = _cost.replay_overlap(oplan, peak_flops=peak_flops)
    p.predicted = TimeBreakdown(
        total=s["makespan"], compute=s["compute_time"], bubble=0.0,
        exposed_collective=s["stalled_time"], reshard=s["reshard_time"],
        collective=s["collective_time"], tier="staged")
    # the traced step is one rank's: its peak is this card's already
    peak_live = _cost.peak_live_bytes(graph)
    m = p.per_device
    act = max(0.0, peak_live - (m.params + m.grads + m.opt_state))
    p.per_device = MemoryEstimate(m.params, m.grads, m.opt_state, act,
                                  source="peak-live-bytes/chip")
    p.rationale.append(
        f"staged: makespan {s['makespan']:.3e}s = compute "
        f"{s['compute_time']:.3e}s + exposed collective "
        f"{s['stalled_time']:.3e}s (reshard {s['reshard_time']:.3e}s of "
        f"{s['n_reshard']} implicit sites; "
        f"{s['n_collectives']} collectives)")
    return p


def plan_search(n_params: float, n_devices: int, *, layers: int = 24,
                hidden: int = 2048, seq_len: int = 2048,
                global_batch: Optional[int] = None,
                batch_per_device: int = 8,
                hbm_bytes: Optional[float] = None,
                param_bytes: int = 2, zero_stage: int = 1,
                max_model: int = 8, max_pipe: Optional[int] = None,
                max_sep: int = 4, headroom: float = 0.9,
                policies: Sequence[str] = GRAD_SYNC_POLICIES,
                dcn_only_choices: Sequence[bool] = (False, True),
                buckets_choices: Sequence[int] = (1, 2, 4),
                micro_choices: Sequence[int] = (1, 2, 4),
                remat: Optional[bool] = None, top_k: int = 8,
                stage_top_k: int = 0,
                builder: Optional[Callable] = None,
                peak_flops: Optional[float] = None) -> List[Plan]:
    """Search the parallelism space and return plans ranked by predicted
    end-to-end step time (fastest first).

    The candidate space is the cross product of mesh degree
    factorizations of ``n_devices`` over (data, sharding, model, pipe,
    sep), grad-sync policy x ``grad_sync_dcn_only``, exchange bucket
    count, remat, and microbatch count — pruned by static bounds and
    the HBM memory model BEFORE any staging, scored analytically, and
    (optionally) the top ``stage_top_k`` survivors re-scored exactly
    from their staged step via ``builder(plan) -> (trainer, inputs,
    labels)``. Enumeration and every sort are deterministic: the same
    spec + chip count + calibration DB yields the same ranked list in
    any process.

    ``global_batch`` fixes the per-step optimization work across
    candidates (defaults to ``batch_per_device * n_devices`` — the
    all-DP reading of the :func:`plan` sizing). Each plan carries its
    ``predicted`` :class:`TimeBreakdown` and human-readable rationale;
    ``Plan.apply()`` turns the winner into ParallelTrainer kwargs.
    Raises ValueError when no candidate fits HBM (same contract as
    :func:`plan`)."""
    from .. import telemetry as _telemetry
    t0 = time.perf_counter()
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if global_batch is None:
        global_batch = batch_per_device * n_devices
    if peak_flops is None:
        peak_flops = _telemetry.peak_flops_per_sec()
    peak_flops = max(float(peak_flops), 1.0)
    links = _links()
    has_dcn = "dcn" in set(links.values())
    hbm_bytes = _card_bytes(hbm_bytes)
    budget = headroom * hbm_bytes

    n_enum = n_pruned_bounds = n_pruned_memory = 0
    candidates: List[Plan] = []
    best_overweight = None   # closest-to-fitting, for the error message
    for deg in _factorizations(n_devices):
        n_enum += 1
        d, z = deg["data"], deg["sharding"]
        tp, pp, sep = deg["model"], deg["pipe"], deg["sep"]
        # tier-0 static bounds: cheap, before any estimate
        if tp > max_model or tp > max(1, hidden // 128) \
                or pp > max(1, layers) \
                or (max_pipe is not None and pp > max_pipe) \
                or sep > max_sep or seq_len % sep \
                or global_batch % (d * z) \
                or global_batch < d * z:
            n_pruned_bounds += 1
            continue
        local_batch = global_batch // (d * z)
        for micro in micro_choices:
            if local_batch % micro:
                continue
            if pp > 1 and micro < pp:
                continue      # bubble-dominated; never worth staging
            for use_remat in ((remat,) if remat is not None
                              else (False, True)):
                est = _estimate(
                    n_params, deg, layers=layers, hidden=hidden,
                    seq_len=seq_len,
                    batch_per_device=local_batch / micro,
                    param_bytes=param_bytes, zero_stage=zero_stage,
                    remat=use_remat)
                if est.total > budget:
                    n_pruned_memory += 1
                    if best_overweight is None or \
                            est.total < best_overweight[2].total:
                        best_overweight = (deg, use_remat, est)
                    continue
                # wire-policy knobs only matter when a gradient
                # exchange exists; collapse the degenerate rows so the
                # ranked list has no duplicate-config aliases
                has_exchange = d > 1 or z > 1
                pols = policies if has_exchange else policies[:1]
                for pol in pols:
                    dcn_choices = ((False,) if pol == "fp32"
                                   or not has_exchange or not has_dcn
                                   else dcn_only_choices)
                    for dcn_only in dcn_choices:
                        bks = (buckets_choices if has_exchange
                               else buckets_choices[:1])
                        for k in bks:
                            candidates.append(Plan(
                                degrees=dict(deg), per_device=est,
                                hbm_bytes=hbm_bytes, remat=bool(use_remat),
                                grad_sync=pol,
                                grad_sync_dcn_only=bool(dcn_only),
                                grad_sync_buckets=int(k),
                                micro_batches=int(micro),
                                zero_stage=zero_stage))
    if not candidates:
        if best_overweight is not None:
            deg, use_remat, est = best_overweight
            raise ValueError(
                f"no layout fits: closest is {deg} (remat={use_remat}) "
                f"at {est.total / 1e9:.1f} GB/device vs budget "
                f"{budget / 1e9:.1f} GB — add devices, raise zero_stage, "
                f"or shrink the per-device batch")
        raise ValueError("no layout fits: no candidate passed the "
                         "static bounds — relax max_model/max_pipe/"
                         "max_sep or fix the batch divisibility")

    for p in candidates:
        score_plan(p, n_params, layers=layers, hidden=hidden,
                   seq_len=seq_len, global_batch=global_batch,
                   param_bytes=param_bytes, peak_flops=peak_flops)
    candidates.sort(key=lambda p: (p.predicted.total, _tiebreak(p)))
    ranked = candidates[:max(1, top_k)]

    n_staged = 0
    if builder is not None and stage_top_k > 0:
        staged, rest = [], []
        for i, p in enumerate(ranked):
            if i < stage_top_k:
                try:
                    staged.append(_stage_score(p, builder, peak_flops))
                    n_staged += 1
                    continue
                except Exception as e:   # candidate fails to stage:
                    p.rationale.append(   # drop to analytic, keep rank
                        f"staging failed ({type(e).__name__}: {e}); "
                        "analytic score kept")
            rest.append(p)
        staged.sort(key=lambda p: (p.predicted.total, _tiebreak(p)))
        ranked = staged + rest     # exactly-scored plans outrank the
        #                            analytic tail (tiers don't share a
        #                            scale: staged makespans price the
        #                            whole staged program)

    for rank, p in enumerate(ranked):
        b = p.predicted
        deg = p.degrees
        p.rationale[:0] = [
            f"#{rank + 1}: data={deg['data']} sharding={deg['sharding']} "
            f"model={deg['model']} pipe={deg['pipe']} sep={deg['sep']} "
            f"grad_sync={p.grad_sync}"
            + (" (dcn-only)" if p.grad_sync_dcn_only else "")
            + f" buckets={p.grad_sync_buckets} micro={p.micro_batches} "
            f"remat={p.remat}",
            f"predicted {b.total:.3e}s/step [{b.tier}] = compute "
            f"{b.compute:.3e}s + bubble {b.bubble:.3e}s + exposed "
            f"collective {b.exposed_collective:.3e}s + reshard "
            f"{b.reshard:.3e}s",
            f"per-device {p.per_device.total / 1e9:.2f} GB "
            f"(act via {p.per_device.source}, budget "
            f"{budget / 1e9:.1f} GB)",
        ]

    if _telemetry.enabled():
        c = _telemetry.counter(
            "planner_candidates_total",
            "plan_search candidates per processing tier")
        c.inc(n_enum, tier="enumerated")
        c.inc(n_pruned_bounds, tier="pruned_bounds")
        c.inc(n_pruned_memory, tier="pruned_memory")
        c.inc(len(candidates), tier="scored_analytic")
        c.inc(n_staged, tier="scored_staged")
        _telemetry.histogram(
            "planner_search_ms",
            "plan_search wall time (enumeration + pruning + scoring)"
        ).observe((time.perf_counter() - t0) * 1e3)
    return ranked


def resharding_cost(graph, mesh, in_specs) -> dict:
    """A candidate layout's predicted implicit-resharding traffic
    (``analysis.sharding.resharding_table``) folded into planner totals:
    ``{"n_sites", "time_s", "wire_bytes", "dcn_bytes", "sites"}``. The
    port has no partitioner to insert collectives (every collective is a
    node of the traced step, priced by the overlap model), so every total
    is 0."""
    from ..analysis.sharding import resharding_table
    rows = resharding_table(graph, mesh, in_specs)
    return {
        "n_sites": len(rows),
        "time_s": sum(r["time_s"] * max(r["trips"], 1.0) for r in rows),
        "wire_bytes": sum(r["wire_bytes"] * max(r["trips"], 1.0)
                          for r in rows),
        "dcn_bytes": sum(r["bytes"] for r in rows if r["link"] == "dcn"),
        "sites": rows,
    }
