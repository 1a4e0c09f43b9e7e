"""Twin of ``tests/test_obs.py:54-175`` on the port: the metrics registry
(scopes, duplicate names, snapshots, histogram summaries) and ``StatsView``
write-through of ``repro_torch.obs.registry``, with ``percentile`` from
``repro_torch.core.stats``. The rest of ``tests/test_obs.py`` is twinned in
``tests/test_torch_faults.py`` (tracer), ``tests/test_torch_recorder.py``
(flight recorder) and ``tests/test_torch_ops.py`` (``obs`` / ``top``).
Imports neither jax nor msgpack.
"""
import json

import pytest

pytest.importorskip("torch")

from repro_torch.core.stats import percentile  # noqa: E402
from repro_torch.obs.registry import (COUNTER, GAUGE,  # noqa: E402
                                      HISTOGRAM, MetricsRegistry, StatsView,
                                      default_registry, set_default_registry)


@pytest.fixture
def reg():
    """Isolate the process default registry per test and restore it after."""
    fresh = MetricsRegistry()
    prev = set_default_registry(fresh)
    yield fresh
    set_default_registry(prev)


class VStats(StatsView):
    """Minimal spec'd view for registry plumbing tests."""

    _FAMILY = "vtest"
    _SPEC = {"n": COUNTER, "level": GAUGE, "lat": HISTOGRAM}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_scope_collision_gets_suffixed():
    r = MetricsRegistry()
    assert r.scope("producer.p0") == "producer.p0"
    assert r.scope("producer.p0") == "producer.p0#2"
    assert r.scope("producer.p0") == "producer.p0#3"
    assert r.scope("producer.p1") == "producer.p1"


def test_duplicate_metric_name_rejected():
    r = MetricsRegistry()
    r.counter("a.b.c")
    with pytest.raises(ValueError, match="already registered"):
        r.counter("a.b.c")
    with pytest.raises(ValueError, match="already registered"):
        r.histogram("a.b.c")
    r.histogram("a.b.h")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("a.b.h")


def test_snapshot_prefix_filter_and_components():
    r = MetricsRegistry()
    r.counter("consumer.d0c0.steps").value = 3
    r.counter("consumer.d1c0.steps").value = 5
    r.histogram("producer.p0.lat").append(0.5)
    snap = r.snapshot("consumer.d0c0.")
    assert snap == {"consumer.d0c0.steps": 3}
    assert r.components() == ["consumer.d0c0", "consumer.d1c0", "producer.p0"]
    full = r.snapshot()
    assert full["producer.p0.lat"]["count"] == 1
    json.dumps(full)  # the recorder payload must be JSON-stable


def test_histogram_summary_matches_shared_percentiles():
    r = MetricsRegistry()
    h = r.histogram("x.y.lat", maxlen=64)
    vals = [float(i) for i in range(50)]
    for v in vals:
        h.append(v)
    s = h.summary()
    assert s["count"] == 50 and s["sum"] == pytest.approx(sum(vals))
    for p in (50, 95, 99):
        assert s[f"p{p}"] == pytest.approx(percentile(vals, float(p)))


def test_histogram_exact_count_beyond_bounded_tail():
    r = MetricsRegistry()
    h = r.histogram("x.y.lat", maxlen=8)
    for v in range(100):
        h.append(float(v))
    s = h.summary()
    # count/sum are exact over everything ever appended; percentiles are
    # over the bounded tail (the newest 8 samples: 92..99)
    assert s["count"] == 100
    assert s["sum"] == pytest.approx(sum(range(100)))
    assert s["p50"] == pytest.approx(percentile(list(range(92, 100)), 50.0))


def test_empty_histogram_summary_is_null_not_nan():
    r = MetricsRegistry()
    s = r.histogram("x.y.lat").summary()
    assert s == {"count": 0, "sum": 0.0, "p50": None, "p95": None,
                 "p99": None}
    json.dumps(s)


# ---------------------------------------------------------------------------
# StatsView write-through
# ---------------------------------------------------------------------------

def test_statsview_write_through():
    r = MetricsRegistry()
    v = VStats("a", registry=r)
    v.n += 1
    v.n += 1
    v.level = 7.5
    v.lat.append(0.25)
    assert v.n == 2 and v.level == 7.5
    assert r.get("vtest.a.n") == 2
    assert r.get("vtest.a.level") == 7.5
    assert r.get("vtest.a.lat")["count"] == 1
    assert v.metric_scope == "vtest.a"
    assert v.snapshot()["n"] == 2


def test_statsview_histogram_assignment_rejected():
    v = VStats("b", registry=MetricsRegistry())
    with pytest.raises(AttributeError, match="histogram"):
        v.lat = [1, 2, 3]
    v.lat.append(1.0)  # the supported mutation
    assert len(v.lat) == 1


def test_statsview_unknown_attribute_raises():
    v = VStats("c", registry=MetricsRegistry())
    with pytest.raises(AttributeError):
        v.no_such_field
    v.helper = "ok"  # non-spec'd attributes behave normally
    assert v.helper == "ok"


def test_statsview_instances_never_alias():
    r = MetricsRegistry()
    a = VStats("same", registry=r)
    b = VStats("same", registry=r)
    a.n += 1
    assert b.n == 0
    assert a.metric_scope != b.metric_scope
    assert b.metric_scope == "vtest.same#2"


def test_statsview_uses_default_registry(reg):
    v = VStats("d")
    v.n += 1
    assert reg.get("vtest.d.n") == 1
    assert default_registry() is reg
