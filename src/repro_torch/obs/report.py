"""Critical-path attribution over a finished span tree.

The port's own copy of ``repro/obs/report.py``.  Given the spans of one
run, answer where the wall-clock went, which spans were on the critical
path, and how close achieved parallelism came to the optimum the recorded
dependency graph permits.

Algorithm (backward interval walk): starting from the last span end,
repeatedly find the spans covering the current instant and attribute the
segment back to the latest-started (i.e. innermost) one, then jump to its
start; instants nothing covers are attributed to ``idle``.  Every moment
of the run is attributed to exactly one span or to idle, so the segment
durations sum to the wall time by construction.

Ideal parallelism uses the recorded external DAG: each ``external`` span
carries its effect class and domains, so the longest per-effect-domain
dependency chain — sequential calls serialize, consecutive read-only
calls overlap, unordered calls are independent — lower-bounds the
makespan any scheduler could reach.  A serving-only trace (the engine's
``serving`` spans, no ``external``) counts its external-like leaf work as
busy time and has an ideal makespan of 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from .spans import Span, Tracer

__all__ = ["Segment", "Component", "RunReport", "report"]

#: Categories counted as "external work" when checking how much of the
#: critical path the traced external calls explain.
EXTERNAL_CAT_PREFIXES = ("external", "dispatch", "backend", "offload",
                         "batch", "serving")

_EPS = 1e-9


@dataclass
class Segment:
    """One critical-path interval, attributed to a span (or idle)."""

    t0: float
    t1: float
    name: str = "idle"
    cat: str = ""
    track: str = ""
    span_id: int = 0

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    @property
    def external(self) -> bool:
        return self.cat.startswith(EXTERNAL_CAT_PREFIXES)


@dataclass
class Component:
    """Aggregate for one ``(cat, name)`` across the run."""

    cat: str
    name: str
    count: int = 0
    inclusive_s: float = 0.0
    exclusive_s: float = 0.0
    critical_s: float = 0.0      # time attributed on the critical path
    critical_segments: int = 0


@dataclass
class RunReport:
    wall_s: float
    t0: float
    t1: float
    path: list[Segment]
    components: dict[tuple[str, str], Component]
    busy_external_s: float       # summed duration of external spans
    ideal_makespan_s: float
    n_spans: int
    n_externals: int
    meta: dict[str, Any] = field(default_factory=dict)

    # -- derived -------------------------------------------------------------

    @property
    def attributed_external_s(self) -> float:
        """Critical-path time attributed to external work — the headline
        check: for an external-bound run this approaches ``wall_s``."""
        return sum(seg.dur for seg in self.path if seg.external)

    @property
    def idle_s(self) -> float:
        return sum(seg.dur for seg in self.path if seg.span_id == 0)

    @property
    def achieved_parallelism(self) -> float:
        return self.busy_external_s / self.wall_s if self.wall_s else 0.0

    @property
    def ideal_parallelism(self) -> float:
        if not self.ideal_makespan_s:
            return 0.0
        return self.busy_external_s / self.ideal_makespan_s

    @property
    def parallel_efficiency(self) -> float:
        """Achieved ÷ ideal (1.0 = the run hit the DAG's optimum)."""
        if not self.ideal_parallelism:
            return 0.0
        return self.achieved_parallelism / self.ideal_parallelism

    def top_blockers(self, n: int = 8) -> list[Component]:
        """Components ranked by critical-path time — what to speed up."""
        comps = [c for c in self.components.values() if c.critical_s > 0]
        comps.sort(key=lambda c: -c.critical_s)
        return comps[:n]

    def render(self, top: int = 8) -> str:
        ext, wall = self.attributed_external_s, self.wall_s
        lines = [
            f"run: wall {wall * 1e3:.1f}ms, {self.n_spans} spans "
            f"({self.n_externals} externals)",
            f"critical path: {ext * 1e3:.1f}ms external work "
            f"({ext / wall:.0%} of wall), {self.idle_s * 1e3:.1f}ms idle",
            f"parallelism: achieved {self.achieved_parallelism:.2f}x "
            f"(busy {self.busy_external_s * 1e3:.1f}ms / wall "
            f"{wall * 1e3:.1f}ms), ideal {self.ideal_parallelism:.2f}x "
            f"(dependency-chain makespan "
            f"{self.ideal_makespan_s * 1e3:.1f}ms) -> "
            f"{self.parallel_efficiency:.0%} of optimum",
            f"top blockers (critical-path time):",
        ]
        blockers = self.top_blockers(top)
        if not blockers:
            lines.append("  (none)")
        for i, c in enumerate(blockers, 1):
            label = f"{c.cat}:{c.name}" if c.cat else c.name
            lines.append(
                f"  {i}. {label:<32} {c.critical_s * 1e3:9.2f}ms on path "
                f"({c.critical_segments} segments; inclusive "
                f"{c.inclusive_s * 1e3:.2f}ms over {c.count} spans)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------


def _critical_path(spans: list[Span], t0: float, t1: float) -> list[Segment]:
    """Backward walk: attribute every instant of [t0, t1] to the innermost
    (latest-started) span covering it, or to idle."""
    segs: list[Segment] = []
    t = t1
    while t > t0 + _EPS:
        cover = [s for s in spans if s.t0 < t - _EPS and s.t1 >= t - _EPS]
        if cover:
            s = max(cover, key=lambda s: (s.t0, s.span_id))
            # walk back only until a more-inner span (started later than
            # s) ends — below that instant *it* is the innermost cover
            a = max(s.t0, t0)
            for s2 in spans:
                if (s2.t0 > s.t0 + _EPS and s2.t1 <= t - _EPS
                        and s2.t1 > a):
                    a = s2.t1
            segs.append(Segment(t0=a, t1=t, name=s.name, cat=s.cat,
                                track=s.track, span_id=s.span_id))
            t = a
        else:
            prev = max((s.t1 for s in spans if s.t1 <= t - _EPS),
                       default=t0)
            prev = max(prev, t0)
            segs.append(Segment(t0=prev, t1=t))
            t = prev
    segs.reverse()
    return segs


def _interval_union(ivs: list[tuple[float, float]]) -> float:
    if not ivs:
        return 0.0
    ivs.sort()
    total, (a, b) = 0.0, ivs[0]
    for x, y in ivs[1:]:
        if x > b:
            total += b - a
            a, b = x, y
        elif y > b:
            b = y
    return total + (b - a)


def _components(spans: list[Span],
                path: list[Segment]) -> dict[tuple[str, str], Component]:
    children: dict[int, list[Span]] = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    comps: dict[tuple[str, str], Component] = {}

    def comp(cat: str, name: str) -> Component:
        c = comps.get((cat, name))
        if c is None:
            c = comps[(cat, name)] = Component(cat=cat, name=name)
        return c

    for s in spans:
        c = comp(s.cat, s.name)
        c.count += 1
        c.inclusive_s += s.dur
        kid_ivs = [(max(k.t0, s.t0), min(k.t1, s.t1))
                   for k in children.get(s.span_id, ())
                   if k.t1 > s.t0 and k.t0 < s.t1]
        c.exclusive_s += max(0.0, s.dur - _interval_union(kid_ivs))
    for seg in path:
        if seg.span_id == 0:
            c = comp("", "idle")
        else:
            c = comp(seg.cat, seg.name)
        c.critical_s += seg.dur
        c.critical_segments += 1
    return comps


def _call_times(spans: list[Span]) -> dict[int, float]:
    """Per-external actual *call* time: the durations of its
    ``external.call`` / ``external.batch`` children (dispatch through
    resolve), or the span's own duration for inline externals that have
    no call child.  An ``external`` span's full extent also covers
    dependency waits and lock waits — using it raw would count waiting as
    work and overstate busy time."""
    ext_ids = {s.span_id for s in spans if s.cat == "external"}
    call_s = {i: 0.0 for i in ext_ids}
    for s in spans:
        if s.cat in ("external.call", "external.batch") \
                and s.parent_id in ext_ids:
            call_s[s.parent_id] += s.dur
    for s in spans:
        if s.cat == "external" and call_s[s.span_id] == 0.0:
            call_s[s.span_id] = s.dur
    return call_s


def _ideal_makespan(externals: list[Span],
                    call_s: dict[int, float]) -> float:
    """Longest dependency chain the recorded external DAG forces.

    Per effect domain, replay that domain's ordered calls in recorded
    dispatch order: a run of consecutive read-only calls overlaps (costs
    its max), sequential calls serialize (cost their sum).  Unordered
    calls never order with anything and bound the makespan only by their
    own duration.
    """
    best = max((call_s[s.span_id] for s in externals), default=0.0)
    domains: dict[str, list[Span]] = {}
    for s in externals:
        if s.attrs.get("cls") not in ("sequential", "readonly"):
            continue
        for d in s.attrs.get("effects") or ():
            domains.setdefault(str(d), []).append(s)
    for chain in domains.values():
        chain.sort(key=lambda s: (s.attrs.get("seq", 0), s.t0))
        total, ro_window = 0.0, 0.0
        for s in chain:
            if s.attrs.get("cls") == "readonly":
                ro_window = max(ro_window, call_s[s.span_id])
            else:
                total += ro_window + call_s[s.span_id]
                ro_window = 0.0
        total += ro_window
        best = max(best, total)
    return best


def report(run: Tracer | Iterable[Span]) -> RunReport:
    """Build a :class:`RunReport` from a tracer or a span list (e.g. from
    :func:`~.export.load_spans`)."""
    if isinstance(run, Tracer):
        spans = run.closed_spans()
    else:
        spans = sorted((s for s in run if not s.open), key=lambda s: s.t0)
    if not spans:
        return RunReport(wall_s=0.0, t0=0.0, t1=0.0, path=[],
                         components={}, busy_external_s=0.0,
                         ideal_makespan_s=0.0, n_spans=0, n_externals=0)
    t0 = min(s.t0 for s in spans)
    t1 = max(s.t1 for s in spans)
    path = _critical_path(spans, t0, t1)
    comps = _components(spans, path)
    externals = [s for s in spans if s.cat == "external"]
    call_s = _call_times(spans)
    busy = sum(call_s.values())
    if not externals:
        # serving-only traces: fall back to any external-ish leaf work
        ext_like = [s for s in spans if s.cat.startswith(
            EXTERNAL_CAT_PREFIXES)]
        busy = sum(s.dur for s in ext_like)
    return RunReport(
        wall_s=t1 - t0, t0=t0, t1=t1, path=path, components=comps,
        busy_external_s=busy,
        ideal_makespan_s=_ideal_makespan(externals, call_s),
        n_spans=len(spans), n_externals=len(externals))
