"""Observability (port of ``repro.obs``): the metrics registry and the span
tracer. The flight recorder waits (ROADMAP Queue 1, item 2e).

``repro_torch.core`` is loaded first: its clients import
``repro_torch.obs.registry``, which imports ``repro_torch.core.stats``, so
the core package must be the one whose initialisation is in progress when
the registry loads (as in the reference, whose ``obs`` package reaches
``repro.core`` through the recorder first).
"""
import repro_torch.core  # noqa: F401  (import order; see above)
from repro_torch.obs.registry import (COUNTER, GAUGE, HISTOGRAM, Counter,
                                      Gauge, Histogram, Metric,
                                      MetricsRegistry, StatsView,
                                      default_registry, set_default_registry)
from repro_torch.obs.tracer import (TRACER, Span, Tracer, disable_tracing,
                                    enable_tracing, trace_span)

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM", "Counter", "Gauge", "Histogram",
    "Metric", "MetricsRegistry", "StatsView", "default_registry",
    "set_default_registry", "Span", "TRACER", "Tracer", "disable_tracing",
    "enable_tracing", "trace_span",
]
