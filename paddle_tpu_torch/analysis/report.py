"""Structured findings and cost output of the graph analyzer.

Port of ``paddle_tpu/analysis/report.py`` (copied: it imports no JAX). A
:class:`Finding` pins one rule violation to one node of a traced graph
(rule id, severity, the node's module path, its position among the
graph's call nodes, the source line when the tracer kept it). A
:class:`Report` is the full result of one analysis run: all findings plus
the cost summary (total/matmul FLOPs, memory-traffic bytes, peak live
bytes, the top-k most expensive nodes), rendered as text (the lint CLI)
or JSON. The field names keep the reference's (``eqn_index``,
``num_eqns``), so a reader finds the counterpart; in the port an
"equation" is a call node of the graph.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["SEVERITIES", "Finding", "CostRow", "CostSummary", "Report"]

SEVERITIES = ("error", "warning", "info")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass
class Finding:
    rule: str
    severity: str          # "error" | "warning" | "info"
    message: str
    primitive: str = ""
    path: str = "<top>"    # module path of the node, "/"-joined
    eqn_index: int = -1    # position among the graph's call nodes
    source: Optional[str] = None  # "file.py:42 (fn)" when available

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "primitive": self.primitive,
                "path": self.path, "eqn_index": self.eqn_index,
                "source": self.source}

    def render(self) -> str:
        loc = f"{self.path}#{self.eqn_index}" if self.eqn_index >= 0 \
            else self.path
        src = f" [{self.source}]" if self.source else ""
        return (f"{self.severity.upper():7s} {self.rule}: {self.message} "
                f"(at {loc}{src})")


@dataclass
class CostRow:
    primitive: str
    path: str
    eqn_index: int
    flops: float           # times the trip count (1: graphs are unrolled)
    bytes: float           # operand + result traffic, times the trips
    out: str = ""          # "f32[8,128,512]" result signature
    trips: float = 1.0
    source: Optional[str] = None

    def to_dict(self) -> dict:
        return {"primitive": self.primitive, "path": self.path,
                "eqn_index": self.eqn_index, "flops": self.flops,
                "bytes": self.bytes, "out": self.out, "trips": self.trips,
                "source": self.source}


@dataclass
class CostSummary:
    total_flops: float = 0.0
    matmul_flops: float = 0.0
    total_bytes: float = 0.0
    peak_live_bytes: float = 0.0
    arg_bytes: float = 0.0
    top: List[CostRow] = field(default_factory=list)
    # overlap-model output (analysis/cost.py overlap_summary): present
    # when the analysis ran with a mesh; overlap_efficiency is None for
    # collective-free graphs
    overlap: Optional[dict] = None

    def to_dict(self) -> dict:
        return {"total_flops": self.total_flops,
                "matmul_flops": self.matmul_flops,
                "total_bytes": self.total_bytes,
                "peak_live_bytes": self.peak_live_bytes,
                "arg_bytes": self.arg_bytes,
                "top": [r.to_dict() for r in self.top],
                "overlap": self.overlap}


def _human(n: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000.0:
            return f"{n:.4g}{unit}"
        n /= 1000.0
    return f"{n:.4g}E"


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    cost: CostSummary = field(default_factory=CostSummary)
    num_eqns: int = 0

    def __post_init__(self):
        self.findings.sort(
            key=lambda f: (_RANK.get(f.severity, len(SEVERITIES)),
                           f.rule, f.path, f.eqn_index))

    # -- selection ----------------------------------------------------------
    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    @property
    def infos(self) -> List[Finding]:
        return self.by_severity("info")

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    @property
    def ok(self) -> bool:
        """No error-severity findings (the CI gate)."""
        return not self.errors

    def counts(self) -> Dict[str, int]:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def summary(self) -> str:
        c = self.counts()
        return (f"{c['error']} errors, {c['warning']} warnings, "
                f"{c['info']} info")

    # -- rendering ----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"ok": self.ok, "num_eqns": self.num_eqns,
                "counts": self.counts(),
                "findings": [f.to_dict() for f in self.findings],
                "cost": self.cost.to_dict()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_text(self, max_findings: Optional[int] = None) -> str:
        lines = [f"program analysis: {self.num_eqns} nodes, "
                 f"{self.summary()}"]
        shown = self.findings if max_findings is None \
            else self.findings[:max_findings]
        for f in shown:
            lines.append("  " + f.render())
        hidden = len(self.findings) - len(shown)
        if hidden > 0:
            lines.append(f"  ... and {hidden} more")
        c = self.cost
        lines.append(
            f"cost: {_human(c.total_flops)}FLOPs total "
            f"({_human(c.matmul_flops)} matmul), "
            f"{_human(c.total_bytes)}B traffic, "
            f"peak live {_human(c.peak_live_bytes)}B")
        if c.overlap and c.overlap.get("overlap_efficiency") is not None:
            o = c.overlap
            lines.append(
                f"overlap: {o['overlap_efficiency']:.2f} of "
                f"{o['collective_time'] * 1e6:.4g}us collective time "
                f"hidden under compute "
                f"({o['n_collectives']} collectives)")
        if c.top:
            lines.append(f"top {len(c.top)} most expensive nodes:")
            lines.append(f"  {'flops':>10s} {'bytes':>10s} {'trips':>6s} "
                         f"op @ path")
            for r in c.top:
                lines.append(
                    f"  {_human(r.flops):>10s} {_human(r.bytes):>10s} "
                    f"{r.trips:>6g} {r.primitive} -> {r.out} "
                    f"@ {r.path}#{r.eqn_index}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.to_text()

    def __repr__(self) -> str:
        return (f"<Report nodes={self.num_eqns} {self.summary()} "
                f"flops={_human(self.cost.total_flops)}>")
