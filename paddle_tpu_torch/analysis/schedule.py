"""Collective schedules and their fingerprints, program families, and the
cross-rank agreement check.

Port of ``paddle_tpu/analysis/schedule.py``. From a traced graph
(``walker.trace_program``) :func:`extract_schedule` lists every collective
node in issue order with its canonical identity: kind (``all_reduce``,
``all_gather``, ``reduce_scatter``, ``all_to_all``, ``broadcast``,
``send``/``recv``), the mesh axes of its process group, the dtype on the
wire, the payload bucket (the next power of two of its operand bytes) and
the link class (``mesh.axis_links``). :func:`fingerprint` hashes the
ordered keys: two ranks whose graphs fingerprint alike issue the same
collectives in the same order. The context field of a key (the
reference's enclosing scan/while/cond stack) is always empty: the port's
graphs are unrolled.

:class:`ProgramFamily` (a host-side choice between graphs: the trainer's
plain and integrity-check steps, LocalSGD's sync and local steps, the
decode server's mixed/decode/verify executors) with :func:`verify_family`
and :func:`verify_all_families`, :class:`ScheduleMismatch` and
:func:`crossrank_verify` are the reference's host logic, copied
(``schedule.py:238-384``); a member is a zero-argument callable returning
a traced graph. :func:`peer_schedules` gathers every rank's schedule over
the default group, for the ``collective-order-divergence`` rule.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .rules import collective_axes, collective_kind
from .walker import source_summary, walk

__all__ = [
    "SCHEDULE_RULE_IDS", "CollectiveSite", "extract_schedule", "fingerprint",
    "program_fingerprint", "format_schedule", "schedule_rows", "norm_key",
    "ProgramFamily", "FamilyContext", "FAMILIES", "register_family",
    "verify_family", "verify_all_families", "ScheduleMismatch",
    "crossrank_verify", "peer_schedules",
]

#: the reference's four schedule rules; two are ported (``rules.py``), two
#: are ``rules.NOT_APPLICABLE``
SCHEDULE_RULE_IDS = (
    "collective-order-divergence",
    "collective-in-data-dependent-while",
    "rank-dependent-collective-schedule",
    "program-family-schedule-drift",
)
_PORTED_SCHEDULE_RULES = ("collective-order-divergence",
                          "program-family-schedule-drift")


def _bucket(nbytes: float) -> int:
    """Next power of two >= nbytes (0 for empty)."""
    n = int(nbytes)
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b <<= 1
    return b


def _links_for(mesh) -> Dict[str, str]:
    if mesh is None:
        return {}
    from ..distributed.mesh import axis_links
    return dict(axis_links(mesh))


@dataclass(frozen=True)
class CollectiveSite:
    """One collective in issue order, with its schedule identity;
    path/eqn_index/source are provenance, outside the fingerprint."""
    kind: str
    axes: Tuple[str, ...]
    wire_dtype: str
    payload_bucket: int
    link: str
    context: Tuple[str, ...]
    trips: float
    in_loop: bool
    in_branch: bool
    path: str
    eqn_index: int
    source: Optional[str]

    def key(self) -> tuple:
        return (self.kind, self.axes, self.wire_dtype, self.payload_bucket,
                self.link, self.context)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "axes": list(self.axes),
                "wire_dtype": self.wire_dtype,
                "payload_bucket": self.payload_bucket, "link": self.link,
                "context": list(self.context), "trips": self.trips,
                "in_loop": self.in_loop, "in_branch": self.in_branch,
                "path": self.path, "eqn_index": self.eqn_index,
                "source": self.source}


def extract_schedule(graph, mesh=None) -> List[CollectiveSite]:
    """The ordered collective schedule of one traced graph. A collective
    whose group is no group of ``mesh`` keys its axes as ``("?<n>",)``
    with n its group's size."""
    from .cost import collective_payload
    links = _links_for(mesh)
    out: List[CollectiveSite] = []
    for site in walk(graph, mesh):
        kind = collective_kind(site)
        if kind is None:
            continue
        axes = collective_axes(site)
        if site.axes is None and site.group is not None:
            axes = (f"?{site.group.size()}",)
        axes = tuple(sorted(axes))
        link = "dcn" if any(links.get(a) == "dcn" for a in axes) else "ici"
        wire = (str(site.ins[0].dtype).replace("torch.", "")
                if site.ins else "?")
        out.append(CollectiveSite(
            kind=kind, axes=axes, wire_dtype=wire,
            payload_bucket=_bucket(collective_payload(site)), link=link,
            context=(), trips=1.0, in_loop=False, in_branch=False,
            path="<top>", eqn_index=site.index,
            source=source_summary(site.node)))
    return out


def norm_key(key) -> str:
    """A schedule key as JSON (what crosses processes compares alike); a
    key already in that form is returned as it is."""
    if isinstance(key, str):
        return key
    return json.dumps(list(key), separators=(",", ":"), default=str)


def fingerprint(schedule: List[CollectiveSite]) -> str:
    """sha256 over the ordered canonical keys."""
    blob = json.dumps([list(s.key()) for s in schedule],
                      separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def program_fingerprint(graph, mesh=None, structure: bool = False) -> str:
    """:func:`fingerprint` of the graph's collective schedule. With
    ``structure=True`` the hash also covers every node's op and output
    shapes and dtypes in issue order: for ranks that must run the same
    program whole (replicas, such as one-rank hosts whose steps issue no
    collective at all), not only the same collectives."""
    fp = fingerprint(extract_schedule(graph, mesh=mesh))
    if not structure:
        return fp
    nodes = [[s.op] + [m.sig() for m in s.outs] for s in walk(graph)]
    blob = json.dumps([fp, nodes], separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def schedule_rows(schedule: List[CollectiveSite]) -> List[dict]:
    return [s.to_dict() for s in schedule]


def format_schedule(schedule: List[CollectiveSite]) -> str:
    """The ``--dump-collectives`` table."""
    if not schedule:
        return "  (no collectives)"
    lines = [f"  {'#':>3s} {'kind':<14s} {'axes':<16s} {'wire':<9s} "
             f"{'payload':>10s} {'link':<4s} context"]
    for i, s in enumerate(schedule):
        ctx = "/".join(s.context) or "-"
        lines.append(
            f"  {i:>3d} {s.kind:<14s} {','.join(s.axes) or '-':<16s} "
            f"{s.wire_dtype:<9s} {s.payload_bucket:>10d} {s.link:<4s} "
            f"{ctx}")
    return "\n".join(lines)


def _fmt_seq(keys, limit: int = 4) -> str:
    if not keys:
        return "none"
    ks = [json.loads(k) if isinstance(k, str) else list(k) for k in keys]
    parts = [f"{k[0]}({','.join(k[1]) or '-'}:{k[2]})" for k in ks[:limit]]
    if len(ks) > limit:
        parts.append(f"+{len(ks) - limit} more")
    return " ".join(parts)


def peer_schedules(graph, mesh=None, group=None) -> Dict[int, List[str]]:
    """Every rank's schedule keys (:func:`norm_key`) of its own traced
    ``graph``, gathered over ``group`` (the default group): a collective
    of that group, which every rank calls once."""
    import torch.distributed as dist
    mine = [norm_key(s.key()) for s in extract_schedule(graph, mesh)]
    if not dist.is_initialized():
        return {0: mine}
    got: List[Optional[list]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    return {r: v for r, v in enumerate(got)}


# ---------------------------------------------------------------------------
# program families (host logic, copied)
# ---------------------------------------------------------------------------

@dataclass
class ProgramFamily:
    """A host-side choice between graphs, declared for verification.
    ``members``: name -> zero-argument callable returning the member's
    traced graph (traced lazily, in :func:`verify_family`)."""
    name: str
    selector: str
    rank_invariant: bool
    members: Dict[str, Callable]
    mesh: object = None

    @property
    def primary(self) -> str:
        return next(iter(self.members))


FAMILIES: Dict[str, ProgramFamily] = {}


def register_family(family: ProgramFamily,
                    replace: bool = False) -> ProgramFamily:
    if not family.members:
        raise ValueError(f"family {family.name!r} has no members")
    if family.name in FAMILIES and not replace:
        raise ValueError(f"duplicate program family {family.name!r}")
    FAMILIES[family.name] = family
    return family


@dataclass(frozen=True)
class FamilyContext:
    """Attached to a RuleContext (``ctx.family``) while a member is under
    analysis."""
    name: str
    member: str
    primary: str
    selector: str
    rank_invariant: bool
    fingerprints: Tuple[Tuple[str, str], ...]


def verify_family(family: ProgramFamily, config=None) -> dict:
    """Trace every member, fingerprint it and run the schedule rules over
    each with the family attached; ``ok`` is False when a member carries
    an error finding."""
    from .rules import RuleContext, run_rules
    graphs = {name: fn() for name, fn in family.members.items()}
    mesh = family.mesh
    fps = {name: program_fingerprint(g, mesh=mesh)
           for name, g in graphs.items()}
    members_out, ok = {}, True
    for name, g in graphs.items():
        ctx = RuleContext(g, mesh=mesh, config=config)
        ctx.family = FamilyContext(
            name=family.name, member=name, primary=family.primary,
            selector=family.selector, rank_invariant=family.rank_invariant,
            fingerprints=tuple(fps.items()))
        findings = run_rules(g, config=config, rules=_PORTED_SCHEDULE_RULES,
                             ctx=ctx)
        errors = [f for f in findings if f.severity == "error"]
        ok = ok and not errors
        members_out[name] = {
            "ok": not errors, "fingerprint": fps[name],
            "num_collectives": len(extract_schedule(g, mesh=mesh)),
            "findings": [f.to_dict() for f in findings]}
    return {"family": family.name, "selector": family.selector,
            "rank_invariant": family.rank_invariant, "ok": ok,
            "fingerprints": fps, "members": members_out}


def verify_all_families(config=None) -> Dict[str, dict]:
    return {name: verify_family(fam, config=config)
            for name, fam in FAMILIES.items()}


class ScheduleMismatch(RuntimeError):
    """Hosts disagree on a program's schedule fingerprint; ``diff`` maps
    program name -> {host: fingerprint}."""

    def __init__(self, message: str, diff: Optional[dict] = None):
        super().__init__(message)
        self.diff = dict(diff or {})


def crossrank_verify(coordinator, fingerprints: Dict[str, str], hosts_fn,
                     timeout: float = 60.0,
                     name: str = "schedule_fp") -> dict:
    """All-gather every host's {program: fingerprint} through the
    coordinator (``allgather(name, value, hosts_fn, timeout)``) and raise
    :class:`ScheduleMismatch` with a per-host diff on any disagreement;
    counts ``schedule_verify_total`` and
    ``collective_schedule_mismatch_total``."""
    from .. import telemetry
    expected = sorted(set(hosts_fn()) | {coordinator.host})
    got = coordinator.allgather(name, dict(fingerprints),
                                lambda: expected, timeout=timeout)
    if telemetry.enabled():
        telemetry.counter(
            "schedule_verify_total",
            "cross-rank schedule-fingerprint verifications").inc()
    programs = set()
    for fps in got.values():
        programs |= set((fps or {}).keys())
    diff = {}
    for prog in sorted(programs):
        vals = {h: (got[h] or {}).get(prog) for h in sorted(got)}
        if len(set(vals.values())) > 1:
            diff[prog] = vals
    if diff:
        if telemetry.enabled():
            telemetry.counter(
                "collective_schedule_mismatch_total",
                "programs whose schedule fingerprints diverged "
                "across hosts").inc(len(diff))
        lines = []
        for prog, vals in diff.items():
            per = ", ".join(f"{h}={str(v)[:12]}" for h, v in vals.items())
            lines.append(f"{prog}: {per}")
        raise ScheduleMismatch(
            "collective schedule fingerprints diverge across hosts — "
            "refusing to start (one rank would issue a different "
            "collective sequence and hang every peer): "
            + "; ".join(lines), diff)
    return got
