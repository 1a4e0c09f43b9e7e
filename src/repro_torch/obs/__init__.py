"""Observability (port of ``repro.obs``): the metrics registry, the span
tracer and the flight recorder (``FlightRecorder`` publishing per-component
registry snapshots to ``<run>/obs/<component>/<seq>.snap``).

``repro_torch.core`` is loaded first: its clients import
``repro_torch.obs.registry``, which imports ``repro_torch.core.stats``, so
the core package must be the one whose initialisation is in progress when
the registry loads (as in the reference, whose ``obs`` package reaches
``repro.core`` through the recorder first).
"""
import repro_torch.core  # noqa: F401  (import order; see above)
from repro_torch.obs.recorder import (FlightRecorder, OBS_DIR, SNAP_SCHEMA,
                                      component_dirs, latest_snapshot,
                                      list_snaps, prune_snaps, read_snapshots)
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
    "FlightRecorder", "OBS_DIR", "SNAP_SCHEMA", "component_dirs",
    "latest_snapshot", "list_snaps", "prune_snaps", "read_snapshots",
]
