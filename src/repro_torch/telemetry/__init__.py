"""End-to-end telemetry for the serving fabric.

``Tracer`` produces per-invocation span trees (route/queue/acquire/
boot_process/boot_init/warm_to/run/release phases) and freshen-lifecycle
spans linked to the arrivals they anchored; ``MetricsRegistry`` holds
typed counters/gauges/histograms behind the components' existing
``stats()`` views; ``export_chrome`` writes traces loadable in
chrome://tracing / Perfetto.  Everything is zero-overhead when disabled
(``NULL_TRACER``).  See docs/architecture.md "Observability".
"""
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.telemetry.tracer import (NULL_SPAN, NULL_TRACER, PHASES,
                                    FreshenSpan, InvocationSpan,
                                    PhaseSpan, Tracer, current_span)
from repro_torch.telemetry.export import chrome_trace_events

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "InvocationSpan", "FreshenSpan", "PhaseSpan",
    "NULL_TRACER", "NULL_SPAN", "PHASES", "current_span",
    "chrome_trace_events",
]
