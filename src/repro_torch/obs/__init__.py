"""``repro_torch.obs`` — span tracing and metrics for the port.

The port's own copies of ``repro.obs``'s spans, metrics, exporters and
critical-path report.  Off by default::

    from repro_torch import obs

    with obs.tracing() as trz:
        asyncio.run(serve(engine))
    print(obs.report(trz).render())
    obs.write_chrome_trace("run.json", trz)   # load in ui.perfetto.dev

Offline: ``python -m repro_torch.obs run.json [--timeline]``.

The engine reads :func:`current_tracer` where a request is submitted and,
in its loop, a request's own tracer or else :func:`process_tracer`;
:func:`set_process_tracer` switches tracing on for every context of the
process, an engine loop already running among them.  To record
the PopPy runtime (``repro.obs``) and the port's engine into one trace,
enter both packages' ``tracing(trz)`` with the same tracer.
"""

from .export import (chrome_trace, load_spans, render_timeline,
                     write_chrome_trace)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .report import Component, RunReport, Segment, report
from .spans import (Span, Tracer, current_span, current_tracer, maybe_span,
                    process_tracer, set_process_tracer, tracing)

__all__ = [
    "Span", "Tracer", "tracing", "current_tracer", "current_span",
    "maybe_span", "process_tracer", "set_process_tracer",
    "chrome_trace", "write_chrome_trace", "load_spans", "render_timeline",
    "report", "RunReport", "Segment", "Component",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
]
