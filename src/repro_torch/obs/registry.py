"""Process-wide metrics registry (the port's own copy of ``repro.obs.registry``).

Each stats object declares a metric spec and registers its fields under a
stable dotted name (``consumer.d0c0.steps_consumed``, ``serve.0.tokens_out``,
``fused.loop.compute_s``), so one ``registry.snapshot()`` captures the whole
process. ``StatsView`` keeps ``stats.field += 1`` and
``stats.read_latencies.append(dt)`` call sites working: counters/gauges live
in a ``Metric`` cell read and written through attribute access, and
histograms ARE ``LatencyWindow`` objects (``Histogram`` subclasses it).

Import discipline: this module may import only concrete ``repro_torch.core.*``
submodules (never the ``repro_torch.core`` package facade) because core
clients import ``repro_torch.obs`` while ``repro_torch.core.__init__`` is
still executing.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.stats import LatencyWindow, percentiles

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "StatsView", "default_registry", "set_default_registry"]

#: metric kinds a ``StatsView`` spec may declare
COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: histogram tail length for registry-backed windows (matches the stats
#: surfaces the Histogram replaces)
DEFAULT_WINDOW = 1024


class Metric:
    """One registered scalar metric cell (counter or gauge).

    A plain mutable box: the owning ``StatsView`` reads/writes ``value``
    through attribute access, and ``snapshot()`` reads it — no locking on
    the hot path (int/float stores are atomic under the GIL; the snapshot
    is a statistical read, same contract the old dataclasses had).
    """

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


class Histogram(LatencyWindow):
    """A ``LatencyWindow`` that lives in the registry.

    Subclassing keeps the exact semantics every call site and test relies
    on — bounded tail, exact running count/sum, list-compatible iteration —
    while ``summary()`` adds the shared percentile read used by snapshots.
    """

    __slots__ = ("name",)

    def __init__(self, name: str, maxlen: int = DEFAULT_WINDOW):
        super().__init__(maxlen=maxlen)
        self.name = name

    def summary(self) -> dict:
        """JSON-stable summary: exact count/sum + tail percentiles."""
        ps = percentiles(self, (50.0, 95.0, 99.0))
        out = {"count": self.count, "sum": self.total}
        for p, v in ps.items():
            out[f"p{int(p)}"] = None if v != v else v  # NaN -> null
        return out


class MetricsRegistry:
    """Dotted-name metric namespace for one process.

    ``scope(prefix)`` hands out unique instance prefixes (two consumers that
    both ask for ``consumer.d0c0`` get ``consumer.d0c0`` and
    ``consumer.d0c0#2``), so re-created components never silently alias each
    other's counters. ``snapshot()`` returns a flat JSON-stable dict — the
    flight recorder's payload.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._scopes: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------
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

    def histogram(self, name: str, maxlen: int = DEFAULT_WINDOW) -> Histogram:
        with self._lock:
            if name in self._metrics or name in self._histograms:
                raise ValueError(f"metric {name!r} already registered")
            h = Histogram(name, maxlen=maxlen)
            self._histograms[name] = h
            return h

    def _register(self, m: Metric) -> Metric:
        with self._lock:
            if m.name in self._metrics or m.name in self._histograms:
                raise ValueError(f"metric {m.name!r} already registered")
            self._metrics[m.name] = m
            return m

    # -- read surface -----------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted(list(self._metrics) + list(self._histograms))

    def get(self, name: str):
        """Current value: scalar for counters/gauges, summary dict for
        histograms. KeyError on unknown names."""
        with self._lock:
            if name in self._metrics:
                return self._metrics[name].value
            return self._histograms[name].summary()

    def snapshot(self, prefix: str = "") -> Dict[str, object]:
        """Flat ``{dotted.name: value}`` dict (histograms as summary dicts),
        optionally filtered to one instance prefix."""
        with self._lock:
            metrics = list(self._metrics.values())
            hists = list(self._histograms.values())
        out: Dict[str, object] = {}
        for m in metrics:
            if m.name.startswith(prefix):
                out[m.name] = m.value
        for h in hists:
            if h.name.startswith(prefix):
                out[h.name] = h.summary()
        return out

    def components(self) -> List[str]:
        """Distinct instance prefixes (first two dotted segments) seen so
        far — the flight recorder's component list."""
        seen = set()
        for name in self.names():
            parts = name.split(".")
            seen.add(".".join(parts[:2]) if len(parts) > 2 else parts[0])
        return sorted(seen)


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every ``StatsView`` lands in by default."""
    return _default


def set_default_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process default (tests isolate themselves with a fresh
    registry). Passing None installs a new empty registry. Returns the
    previous default so callers can restore it."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg if reg is not None else MetricsRegistry()
        return prev


class StatsView:
    """Base class turning a legacy stats dataclass into a registry view.

    Subclasses declare::

        _FAMILY = "consumer"                 # metric family prefix
        _SPEC = {"steps_consumed": COUNTER,  # field -> metric kind
                 "read_latencies": HISTOGRAM, ...}

    ``__init__`` claims a unique ``<family>.<instance>`` scope in the
    registry and registers one metric per spec'd field. Attribute access is
    then write-through: ``view.steps_consumed += 1`` bumps the registered
    counter, ``view.read_latencies`` IS the registered ``Histogram`` (a
    ``LatencyWindow``). Fields outside the spec behave like normal instance
    attributes, so subclasses keep helper state and properties unchanged.
    """

    _FAMILY = "stats"
    _SPEC: Dict[str, str] = {}
    #: per-field histogram tail override, e.g. {"gap_samples": 4096}
    _WINDOWS: Dict[str, int] = {}

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
            elif kind == HISTOGRAM:
                cells[field] = reg.histogram(
                    name, maxlen=self._WINDOWS.get(field, DEFAULT_WINDOW))
            else:
                raise ValueError(f"unknown metric kind {kind!r} for {name}")
        # bypass our own __setattr__ while installing the machinery
        object.__setattr__(self, "_cells", cells)
        object.__setattr__(self, "_registry", reg)
        object.__setattr__(self, "_scope", scope)

    # -- attribute plumbing ----------------------------------------------
    def __getattr__(self, field):
        # only called when normal lookup fails => spec'd fields land here
        try:
            cell = object.__getattribute__(self, "_cells")[field]
        except (AttributeError, KeyError):
            raise AttributeError(
                f"{type(self).__name__} has no attribute {field!r}")
        return cell if isinstance(cell, Histogram) else cell.value

    def __setattr__(self, field, value):
        cells = getattr(self, "_cells", None)
        if cells is not None and field in cells:
            cell = cells[field]
            if isinstance(cell, Histogram):
                raise AttributeError(
                    f"{self._scope}.{field} is a histogram; append to it "
                    f"instead of assigning")
            cell.value = value
        else:
            object.__setattr__(self, field, value)

    # -- read surface ------------------------------------------------------
    @property
    def metric_scope(self) -> str:
        """This instance's dotted registry prefix."""
        return self._scope

    def snapshot(self) -> dict:
        """Field -> value dict (histograms as summary dicts); same shape the
        old ``dict(self.__dict__)``-style snapshots had for scalar fields."""
        out = {}
        for field, cell in self._cells.items():
            out[field] = (cell.summary() if isinstance(cell, Histogram)
                          else cell.value)
        return out

    def __repr__(self) -> str:
        scalars = {f: c.value for f, c in self._cells.items()
                   if not isinstance(c, Histogram)}
        return f"{type(self).__name__}({self._scope}: {scalars})"
