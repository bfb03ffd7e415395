"""Program analysis of the port: traced graphs, rules, cost, schedules.

Port of ``paddle_tpu/analysis/``. The reference runs IR passes over the
jaxpr of a step; the port's IR is the graph of one eager step, traced on
fake tensors with ``make_fx`` (:mod:`.walker`): its ATen ops, each of the
port's kernels as one node, and its ``c10d`` collectives. :func:`analyze`
traces a function and :func:`analyze_graph` takes a traced graph; both
run every registered rule (:mod:`.rules`) and the cost model
(:mod:`.cost`) and return a :class:`~.report.Report` that renders as text
or JSON.

Entry points around the port: ``ParallelTrainer.compile(...,
analyze=True)`` / ``staged_graph`` / ``program_family``,
``LocalSGDTrainer.step_graph`` / ``program_family``, the serving
``executor_family`` (``inference/decode_model.py``), the planner
(``distributed/auto.py``), and the lint CLI (``python -m
paddle_tpu_torch.analysis.lint``).
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import cost, report, rules, schedule, sharding, walker
from .report import CostRow, CostSummary, Finding, Report
from .rules import (NOT_APPLICABLE, RULES, AnalysisConfig, RuleContext,
                    register_rule, run_rules)
from .schedule import (FAMILIES, CollectiveSite, ProgramFamily,
                       ScheduleMismatch, crossrank_verify, extract_schedule,
                       program_fingerprint, register_family, verify_family)
from .sharding import ShardingInfo, propagate, resharding_table
from .walker import count_nodes, trace_program, walk

__all__ = [
    "analyze", "analyze_graph", "AnalysisConfig", "Report", "Finding",
    "CostRow", "CostSummary", "RULES", "NOT_APPLICABLE", "register_rule",
    "run_rules", "RuleContext", "walker", "rules", "cost", "report",
    "sharding", "schedule", "ShardingInfo", "propagate",
    "resharding_table", "CollectiveSite", "ProgramFamily", "FAMILIES",
    "ScheduleMismatch", "crossrank_verify", "extract_schedule",
    "program_fingerprint", "register_family", "verify_family",
    "trace_program", "count_nodes", "walk",
]


def analyze_graph(graph, mesh=None, donated=None,
                  config: Optional[AnalysisConfig] = None,
                  rule_ids: Optional[Iterable[str]] = None,
                  in_specs=None, peer_schedules=None,
                  rank: Optional[int] = None) -> Report:
    """Analyze a traced graph (``analyze_jaxpr``'s counterpart). With a
    mesh the summary carries the overlap model of its collectives."""
    cfg = config or AnalysisConfig()
    ctx = RuleContext(graph, mesh=mesh, donated=donated, config=cfg,
                      in_specs=in_specs, peer_schedules=peer_schedules,
                      rank=rank)
    findings = run_rules(graph, config=cfg, rules=rule_ids, ctx=ctx)
    summary = cost.summarize(graph, k=cfg.top_k)
    if mesh is not None:
        try:
            summary.overlap = cost.overlap_summary(graph, mesh)
        except Exception:
            pass  # the overlap model must never sink an analysis run
    return Report(findings=findings, cost=summary,
                  num_eqns=count_nodes(graph))


def analyze(target, *args, mesh=None, donated=None,
            config: Optional[AnalysisConfig] = None,
            rule_ids: Optional[Iterable[str]] = None, in_specs=None,
            **kwargs) -> Report:
    """Analyze a traced graph, or trace ``target(*args, **kwargs)`` on fake
    tensors (:func:`~.walker.trace_program`) and analyze that."""
    graph = target
    if not hasattr(target, "graph"):
        graph = trace_program(target, *args, **kwargs)
    return analyze_graph(graph, mesh=mesh, donated=donated, config=config,
                         rule_ids=rule_ids, in_specs=in_specs)
