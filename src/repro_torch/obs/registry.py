"""Process-wide metrics registry (the port's own copy of ``repro.obs.registry``).

Each stats object declares a metric spec and registers its fields under a
stable dotted name (``serve.0.tokens_out``), so one ``registry.snapshot()``
captures the whole process. ``StatsView`` keeps ``stats.field += 1`` call
sites working: counters/gauges live in a ``Metric`` cell read and written
through attribute access. The JAX registry's histograms have no copy here
yet: no ported stats object declares one.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["Counter", "Gauge", "Metric", "MetricsRegistry", "StatsView",
           "default_registry"]

#: metric kinds a ``StatsView`` spec may declare
COUNTER = "counter"
GAUGE = "gauge"


class Metric:
    """One registered scalar metric cell (counter or gauge)."""

    __slots__ = ("name", "kind", "value")

    def __init__(self, name: str, kind: str, value=0):
        self.name = name
        self.kind = kind
        self.value = value

    def __repr__(self) -> str:
        return f"Metric({self.name!r}, {self.kind}, {self.value!r})"


class Counter(Metric):
    def __init__(self, name: str):
        super().__init__(name, COUNTER, 0)


class Gauge(Metric):
    def __init__(self, name: str):
        super().__init__(name, GAUGE, 0.0)


class MetricsRegistry:
    """Dotted-name metric namespace for one process.

    ``scope(prefix)`` hands out unique instance prefixes (``serve.0``,
    ``serve.0#2``), so re-created components never alias each other's
    counters.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._scopes: Dict[str, int] = {}
        self._lock = threading.Lock()

    def scope(self, prefix: str) -> str:
        """Claim a unique instance prefix (appends ``#N`` on collision)."""
        with self._lock:
            n = self._scopes.get(prefix, 0) + 1
            self._scopes[prefix] = n
            return prefix if n == 1 else f"{prefix}#{n}"

    def counter(self, name: str) -> Counter:
        return self._register(Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._register(Gauge(name))

    def _register(self, m: Metric) -> Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"metric {m.name!r} already registered")
            self._metrics[m.name] = m
            return m

    def get(self, name: str):
        """The value of a counter or gauge."""
        with self._lock:
            return self._metrics[name].value

    def snapshot(self, prefix: str = "") -> Dict[str, object]:
        """Flat ``{dotted.name: value}`` dict, optionally filtered by prefix."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.value for m in metrics if m.name.startswith(prefix)}


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every ``StatsView`` lands in by default."""
    return _default


class StatsView:
    """Base class turning a stats object into a registry view.

    Subclasses declare ``_FAMILY`` (metric family prefix) and ``_SPEC``
    (field -> metric kind). Attribute access on spec'd fields is
    write-through to the registered cells; other attributes behave normally.
    """

    _FAMILY = "stats"
    _SPEC: Dict[str, str] = {}

    def __init__(self, instance: str = "0",
                 registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else default_registry()
        scope = reg.scope(f"{self._FAMILY}.{instance}")
        cells: Dict[str, object] = {}
        for field, kind in self._SPEC.items():
            name = f"{scope}.{field}"
            if kind == COUNTER:
                cells[field] = reg.counter(name)
            elif kind == GAUGE:
                cells[field] = reg.gauge(name)
            else:
                raise ValueError(f"unknown metric kind {kind!r} for {name}")
        object.__setattr__(self, "_cells", cells)
        object.__setattr__(self, "_registry", reg)
        object.__setattr__(self, "_scope", scope)

    def __getattr__(self, field):
        try:
            cell = object.__getattribute__(self, "_cells")[field]
        except (AttributeError, KeyError):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {field!r}")
        return cell.value

    def __setattr__(self, field, value):
        cells = getattr(self, "_cells", None)
        if cells is not None and field in cells:
            cells[field].value = value
        else:
            object.__setattr__(self, field, value)

    @property
    def metric_scope(self) -> str:
        """This instance's dotted registry prefix."""
        return self._scope

    def snapshot(self) -> dict:
        """Field -> value dict."""
        return {field: cell.value for field, cell in self._cells.items()}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._scope}: {self.snapshot()})"
