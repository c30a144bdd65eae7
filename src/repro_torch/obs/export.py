"""Trace exporters: Chrome ``trace_event`` JSON and a text timeline.

The JSON output loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  Mapping:

* every span becomes a ``ph: "X"`` complete event with microsecond
  ``ts``/``dur`` relative to the tracer origin;
* every :class:`~.spans.Span` *track* (effect domain, backend replica,
  decode slot, offload worker) becomes its own thread row via ``tid`` plus
  a ``thread_name`` metadata event, so domains/replicas/slots render as
  separate lanes;
* span ids and parent links ride in ``args`` (``span_id``/``parent_id``)
  together with the span's attrs, so :func:`load_spans` round-trips a file
  back into ``Span`` objects for offline analysis.

The port's own copy of ``repro/obs/export.py``.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

from .spans import Span, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "load_spans",
           "render_timeline"]

_PID = 1


def _track_ids(spans: Iterable[Span]) -> dict[str, int]:
    """Stable track → tid assignment: "main" first, then by first use."""
    tids: dict[str, int] = {}
    for s in spans:
        if s.track not in tids:
            tids[s.track] = len(tids) + 1
    if "main" in tids and tids["main"] != 1:
        order = ["main"] + [t for t in tids if t != "main"]
        tids = {t: i + 1 for i, t in enumerate(order)}
    return tids


def chrome_trace(tracer: Tracer) -> dict[str, Any]:
    """Chrome trace_event representation of every closed span + instant."""
    spans = tracer.closed_spans()
    instants = sorted(tracer.instants, key=lambda s: s.t0)
    tids = _track_ids([*spans, *instants])
    events: list[dict[str, Any]] = [
        {"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
         "args": {"name": tracer.name}},
    ]
    for track, tid in tids.items():
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": tid}})
    for s in spans:
        events.append({
            "ph": "X", "pid": _PID, "tid": tids[s.track],
            "name": s.name, "cat": s.cat or "span",
            "ts": round(s.t0 * 1e6, 3), "dur": round(s.dur * 1e6, 3),
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     **s.attrs},
        })
    for s in instants:
        events.append({
            "ph": "i", "pid": _PID, "tid": tids[s.track],
            "name": s.name, "cat": s.cat or "event", "s": "t",
            "ts": round(s.t0 * 1e6, 3),
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     **s.attrs},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"tracer": tracer.name, "epoch_s": tracer.epoch},
    }


def write_chrome_trace(path: str, tracer: Tracer) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return path


def load_spans(path: str) -> list[Span]:
    """Round-trip a :func:`write_chrome_trace` file back into spans
    (complete events only — instants carry no duration to attribute)."""
    with open(path) as f:
        doc = json.load(f)
    tracks: dict[int, str] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev["tid"]] = ev["args"]["name"]
    spans: list[Span] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        t0 = ev["ts"] / 1e6
        spans.append(Span(
            name=ev["name"], cat=ev.get("cat", ""),
            t0=t0, t1=t0 + ev.get("dur", 0) / 1e6,
            span_id=int(args.pop("span_id", 0)),
            parent_id=int(args.pop("parent_id", 0)),
            track=tracks.get(ev["tid"], f"tid:{ev['tid']}"),
            attrs=args,
        ))
    spans.sort(key=lambda s: s.t0)
    return spans


def render_timeline(spans: list[Span], *, width: int = 72,
                    max_rows: int = 60) -> str:
    """ASCII timeline: one row per span (longest first when truncating),
    bars positioned on a shared relative-time axis."""
    spans = [s for s in spans if not s.open]
    if not spans:
        return "(no spans)"
    t0 = min(s.t0 for s in spans)
    t1 = max(s.t1 for s in spans)
    total = max(t1 - t0, 1e-9)
    shown = sorted(spans, key=lambda s: s.t0)
    dropped = 0
    if len(shown) > max_rows:
        keep = set(id(s) for s in
                   sorted(spans, key=lambda s: -s.dur)[:max_rows])
        dropped = len(shown) - max_rows
        shown = [s for s in shown if id(s) in keep]
    label_w = max(len(f"{s.track}:{s.name}") for s in shown)
    label_w = min(label_w, 34)
    lines = [f"timeline: {total * 1e3:.1f}ms total, {len(spans)} spans"
             + (f" ({dropped} shorter rows hidden)" if dropped else "")]
    for s in shown:
        a = int((s.t0 - t0) / total * width)
        b = max(a + 1, int((s.t1 - t0) / total * width))
        bar = " " * a + "█" * (b - a)
        label = f"{s.track}:{s.name}"[:label_w]
        lines.append(f"{label:<{label_w}} |{bar:<{width}}| "
                     f"{s.dur * 1e3:8.2f}ms")
    return "\n".join(lines)
