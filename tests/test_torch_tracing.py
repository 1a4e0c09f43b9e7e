"""The port's tracer inside the program: parent links, device time and
device counters read late, the train step's phase spans, the MoE dispatch
spans and slot counts, the WKV6 forward and backward spans, the consumer's
per-GET latencies and the fused loop's host-sync count, and the benchmark's
readers of them.

CPU only (no CUDA here: ``device_s`` is None and the host-sync count is
driven through torch's warning text); the card's half is
``tests/test_torch_gpu.py::test_train_step_device_spans_on_the_card``.
"""
import importlib.util
import threading
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import rwkv6_3b  # noqa: E402
from repro_torch.core import (Consumer, ManifestStore,  # noqa: E402
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer)
from repro_torch.models import ModelConfig, init_params, param_specs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.obs import registry as obs_registry  # noqa: E402
from repro_torch.obs import tracer as obs_tracer  # noqa: E402
from repro_torch.obs.tracer import (TRACER, Span, Tracer,  # noqa: E402
                                    disable_tracing, enable_tracing,
                                    trace_span)
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, make_train_step)

METRICS = Path(__file__).resolve().parents[1] / "weavebench" / "metrics"

#: a 2-layer MoE model whose capacity (factor 0.5) drops choices, with remat
MOE = ModelConfig(name="moe-trace", family="moe", num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64,
                  moe_num_experts=4, moe_top_k=2, moe_d_ff=16,
                  moe_capacity_factor=0.5, remat=True)
#: rwkv6-3b's 2-layer smoke model, with remat
RWKV = rwkv6_3b.SMOKE_CONFIG


@pytest.fixture
def tracing():
    disable_tracing()
    TRACER.clear()
    enable_tracing()
    try:
        yield TRACER
    finally:
        disable_tracing()
        TRACER.clear()


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_parent_links_on_one_thread(tracing):
    with trace_span("a", cat="compute"):
        with trace_span("b", cat="compute"):
            with trace_span("c", cat="read"):
                pass
        with trace_span("d", cat="compute"):
            pass
    with trace_span("e"):
        pass
    s = {x.name: x for x in TRACER.spans()}
    assert s["a"].parent is None and s["e"].parent is None
    assert s["b"].parent == s["d"].parent == s["a"].id
    assert s["c"].parent == s["b"].id
    assert len({x.id for x in s.values()}) == 5


@pytest.mark.parametrize("in_backward", [True, False])
def test_a_span_on_a_thread_running_a_backward_hangs_under_the_open_device_span(
        tracing, monkeypatch, in_backward):
    """The autograd engine runs a CUDA backward's recompute on its own
    thread, where nothing is open: a span there hangs under the innermost
    device span open elsewhere (the trainer's ``train.backward``). A thread
    that runs no backward (a data-plane thread) opens roots."""
    monkeypatch.setattr(torch._C, "_current_graph_task_id",
                        lambda: 0 if in_backward else -1)
    opened = threading.Event()

    def engine_thread():
        with trace_span("moe.dispatch", cat="compute", device=True):
            with trace_span("moe.experts", cat="compute", device=True):
                pass
        opened.set()

    with trace_span("train.step", cat="compute", device=True):
        with trace_span("train.backward", cat="compute", device=True):
            t = threading.Thread(target=engine_thread)
            t.start()
            t.join(timeout=10)
            assert opened.is_set()
        with trace_span("train.optimizer", cat="compute", device=True):
            pass
    s = {x.name: x for x in TRACER.spans()}
    assert s["moe.dispatch"].tid != s["train.backward"].tid
    want = s["train.backward"].id if in_backward else None
    assert s["moe.dispatch"].parent == want
    assert s["moe.experts"].parent == s["moe.dispatch"].id
    assert s["train.optimizer"].parent == s["train.step"].id


def test_device_span_on_the_cpu_has_no_device_time_and_reads_its_counters(tracing):
    hits = []
    real = torch.profiler.record_function

    def recording(name):
        hits.append(name)
        return real(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", recording)
        mp.setattr(obs_tracer.Tracer, "_cuda", lambda self, torch: False)
        with trace_span("moe.dispatch", cat="compute", device=True,
                        choices=8) as span:
            span.annotate(kept=torch.tensor([True, False, True]).sum(),
                          slots=8)
        with trace_span("host", cat="read") as span:
            span.annotate(bytes=4)
    dispatch, host = TRACER.spans()
    assert hits == ["moe.dispatch"]
    assert dispatch.device_s is None and host.device_s is None
    assert dispatch.args == {"choices": 8, "kept": 2, "slots": 8}
    assert type(dispatch.args["kept"]) is int
    assert host.args == {"bytes": 4}
    ev = {e["name"]: e for e in TRACER.chrome_trace()}
    assert ev["moe.dispatch"]["args"]["kept"] == 2


def test_stall_report_splits_by_self_time():
    """``train.*`` inside ``pipeline.compute``, ``consumer.get`` inside
    ``consumer.fetch``: the split counts each span's own time once; the
    per-name table keeps whole durations."""
    spans = [Span("consumer.get", "read", 0.010, 0.020, 1, None, 3, 2),
             Span("consumer.fetch", "read", 0.005, 0.030, 1, None, 2, 1),
             Span("train.forward", "compute", 0.040, 0.030, 0, None, 5, 4),
             Span("train.backward", "compute", 0.070, 0.050, 0, None, 6, 4),
             Span("pipeline.compute", "compute", 0.035, 0.100, 0, None, 4,
                  None),
             Span("pipeline.data_wait", "read", 0.000, 0.035, 0, None, 1,
                  None)]
    t = Tracer()
    t.spans = lambda: spans
    assert [round(x, 6) for x in obs_tracer.self_times(spans)] == \
        [0.020, 0.010, 0.030, 0.050, 0.020, 0.005]
    report = t.stall_report()
    cats = {ln.split()[1]: ln.split()[2] for ln in report.splitlines()
            if ln.startswith("category ")}
    assert cats == {"compute": "100.00", "read": "35.00"}
    assert "data-plane wait 35.00 ms vs compute 100.00 ms (25.9% data-plane)" \
        in report
    assert [ln.split()[:3] for ln in report.splitlines()[1:4]] == \
        [["pipeline.compute", "1", "100.00"], ["train.backward", "1", "50.00"],
         ["pipeline.data_wait", "1", "35.00"]]


# ---------------------------------------------------------------------------
# the train step and the MoE layer
# ---------------------------------------------------------------------------

def _moe_step(microbatches):
    params = init_params(param_specs(MOE), seed=0, device="cpu")
    step = make_train_step(MOE, OptimizerConfig(),
                           StepConfig(microbatches=microbatches))
    batch = {"tokens": torch.arange(4 * 16).reshape(4, 16) * 7 % 64}
    return step, params, init_opt_state(params), batch


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans_nest_in_order(tracing, microbatches):
    step, params, opt, batch = _moe_step(microbatches)
    for _ in range(2):
        params, opt, _m = step(params, opt, batch)
    spans = TRACER.spans()
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for st in steps:
        kids = sorted((s for s in spans if s.parent == st.id),
                      key=lambda s: s.t0)
        assert [s.name for s in kids] == \
            ["train.forward", "train.backward"] * microbatches + \
            ["train.optimizer"]
        for s in kids:
            assert st.t0 <= s.t0 and s.t0 + s.dur <= st.t0 + st.dur + 1e-6
        for s in kids[:-1]:
            # each MoE layer's dispatch, in the forward and the remat's
            # recompute inside the backward
            inner = [x for x in spans if x.parent == s.id]
            assert [x.name for x in inner] == ["moe.dispatch"] * MOE.num_layers
            for x in inner:
                assert [y.name for y in spans if y.parent == x.id] == \
                    ["moe.experts"]
    assert all(s.device_s is None for s in spans)


def test_train_optimizer_span_counts_elements_and_launches(tracing):
    """The ``train.optimizer`` span's args: every parameter element
    updated, none by K5 and no K5 launch on CPU tensors (the card's half:
    ``tests/test_torch_gpu.py::test_train_step_device_spans_on_the_card``)."""
    step, params, opt, batch = _moe_step(1)
    n = sum(p.numel() for p in tree_leaves(params))
    step(params, opt, batch)
    [s] = [s for s in TRACER.spans() if s.name == "train.optimizer"]
    assert s.args == {"elems": n, "kernel_elems": 0, "launches": 0}


def test_moe_dispatch_counts_kept_choices_by_hand(tracing):
    """``kept`` equals a hand count of the plan's ``keep`` on a layer whose
    capacity drops choices; ``slots`` is E·cap, ``choices`` T·K."""
    params = init_params(param_specs(MOE), seed=0, device="cpu")
    p = {k: v[0] for k, v in params["layers"].items() if k in
         ("router", "w_gate", "w_up", "w_down")}
    x = torch.randn((2, 16, MOE.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        moe.moe_ffn(MOE, p, x)
        *_, keep, cap = moe._routing(MOE, p, x.reshape(32, MOE.d_model))
    (span,) = [s for s in TRACER.spans() if s.name == "moe.dispatch"]
    hand = sum(bool(k) for k in keep.flatten().tolist())
    assert span.args == {"choices": 32 * 2, "kept": hand,
                         "slots": MOE.moe_num_experts * cap}
    assert hand < 32 * 2          # this capacity drops choices


def test_disabled_tracer_adds_no_event_no_op_and_no_sync(monkeypatch):
    """With the tracer disabled every span is the shared no-op: the step
    makes no CUDA event, opens no profiler range, sets no sync mode and runs
    no ``keep.sum()``; its aten operators are the enabled step's less the
    one bool sum of each dispatch span."""
    from torch.utils._python_dispatch import TorchDispatchMode

    disable_tracing()
    TRACER.clear()
    assert trace_span("train.step", cat="compute", device=True) is \
        obs_tracer._NULL_SPAN

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "aten":
                first = args[0] if args else None
                bool_sum = func.overloadpacket is torch.ops.aten.sum and \
                    isinstance(first, torch.Tensor) and first.dtype == torch.bool
                self.ops.append("bool_sum" if bool_sum else str(func))
            return func(*args, **(kwargs or {}))

    def run(enabled):
        step, params, opt, batch = _moe_step(1)
        (enable_tracing if enabled else disable_tracing)()
        try:
            with Ops() as mode:
                step(params, opt, batch)
        finally:
            disable_tracing()
            TRACER.clear()
        return mode.ops

    def refuse(*a, **k):
        raise AssertionError("the disabled step touched the device tracing")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("Event", "set_sync_debug_mode", "synchronize"):
            mp.setattr(torch.cuda, name, refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        off = run(False)
    on = run(True)
    assert "bool_sum" not in off
    assert on.count("bool_sum") == 2 * MOE.num_layers   # forward + recompute
    assert [o for o in on if o != "bool_sum"] == off


def _rwkv_step():
    params = init_params(param_specs(RWKV), seed=0, device="cpu")
    step = make_train_step(RWKV, OptimizerConfig(), StepConfig())
    batch = {"tokens": torch.arange(2 * 16).reshape(2, 16) * 7 % RWKV.vocab_size}
    return step, params, init_opt_state(params), batch


def test_wkv6_spans_in_a_train_step(tracing):
    """Each layer's WKV6 forward opens ``wkv6.forward`` twice under remat
    (in ``train.forward``, then as the recompute in ``train.backward``) and
    its backward rule ``wkv6.backward`` once, in ``train.backward``; each
    carries B·S tokens, the heads and the chunk."""
    assert RWKV.remat
    step, params, opt, batch = _rwkv_step()
    step(params, opt, batch)
    spans = TRACER.spans()
    by_id = {s.id: s for s in spans}
    fwd = sorted((s for s in spans if s.name == "wkv6.forward"), key=lambda s: s.t0)
    bwd = [s for s in spans if s.name == "wkv6.backward"]
    L = RWKV.num_layers
    assert len(fwd) == 2 * L and len(bwd) == L
    args = {"tokens": 2 * 16, "heads": RWKV.d_model // RWKV.rwkv_head_dim,
            "chunk": RWKV.rwkv_chunk}
    assert all(s.args == args and s.cat == "compute" for s in fwd + bwd)
    assert [by_id[s.parent].name for s in fwd] == \
        ["train.forward"] * L + ["train.backward"] * L
    assert [by_id[s.parent].name for s in bwd] == ["train.backward"] * L
    assert all(s.device_s is None for s in fwd + bwd)


def test_disabled_tracer_leaves_the_wkv6_spans_out(monkeypatch):
    """With the tracer disabled an RWKV step records nothing and touches no
    CUDA event, sync or profiler range."""
    disable_tracing()
    TRACER.clear()

    def refuse(*a, **k):
        raise AssertionError("the disabled step touched the device tracing")

    for name in ("Event", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step, params, opt, batch = _rwkv_step()
    step(params, opt, batch)
    assert len(TRACER) == 0


# ---------------------------------------------------------------------------
# the consumer's GETs and the fused loop's host syncs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["direct", "prefetch", "cp_span"])
def test_consumer_get_latencies_count_the_stores_gets(tracing, mode):
    """Every footer, slice and vectored GET of the read path lands in
    ``get_latencies`` and a ``consumer.get`` span with its bytes."""
    store = MemoryObjectStore()
    ns = Namespace(store, "runs/g")
    p = Producer(ns, "p0", dp=2, cp=2, manifests=ManifestStore(ns))
    for _ in range(6):
        p.write_tgb(uniform_slice_bytes=4096)
        p.maybe_commit(force=True)
    p.finalize()
    st0 = store.stats.snapshot()
    cp = 1 if mode == "cp_span" else 2
    c = Consumer(ns, MeshPosition(0, 0, 2, cp), speculative_tail=0)
    if mode == "prefetch":
        c.start_prefetch()
    try:
        for _ in range(6 // (2 // cp)):
            c.next_batch(timeout_s=5.0)
    finally:
        c.stop_prefetch()
    st = store.stats.snapshot()
    d = {k: st[k] - st0[k] for k in ("range_gets", "coalesced_requests",
                                      "vectored_gets")}
    gets = d["range_gets"] - d["coalesced_requests"] + d["vectored_gets"]
    assert gets > 0 and c.stats.get_latencies.count == gets
    assert (d["vectored_gets"] > 0) == (mode == "cp_span")
    spans = [s for s in TRACER.spans() if s.name == "consumer.get"]
    assert len(spans) == gets
    assert all(s.cat == "read" and s.args["bytes"] > 0 for s in spans)
    assert sum(s.args["bytes"] for s in spans) == c.stats.bytes_fetched
    name = f"{c.stats.metric_scope}.get_latencies"
    assert name in obs_registry.default_registry().histograms("consumer.")


def test_host_sync_count_counts_this_threads_sync_warnings(tracing, monkeypatch):
    """The sync debug mode is set to "warn" inside the block and restored
    after; each of its warnings on this thread counts, another thread's are
    dropped (the mode is process-wide), other warnings pass, and the count
    lands in the span's ``host_syncs``."""
    from repro_torch.train import pipeline
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    msg = pipeline._HostSyncCount.MESSAGE

    def other():
        warnings.warn(msg + " (other thread)")
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with trace_span("pipeline.compute", cat="compute") as span, \
                pipeline._HostSyncCount(span) as count:
            for _ in range(3):
                warnings.warn(msg)
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            warnings.warn("unrelated")
    assert count.n == 3 and modes == ["default", "warn", "default"]
    assert [str(w.message) for w in shown] == ["unrelated"]
    (s,) = TRACER.spans()
    assert s.args == {"host_syncs": 3}


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"tracing_reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _fake_spans():
    """Two steps of 100 ms of device time: forward 20, backward 50 (its
    recompute dispatch 5 of which experts 2), optimizer 28 (1000 elements,
    through K5 in the first step only); the forward's dispatch 8 of which
    experts 3; host syncs 1 and 3."""
    out = []

    def span(name, sid, parent, device_s, args=None, cat="compute"):
        s = Span(name, cat, 0.0, 1.0, 0, args, sid, parent)
        s.device_s = device_s
        out.append(s)

    for k in (0, 100):
        span("pipeline.compute", k + 1, None, None, {"step": k,
                                                     "host_syncs": 1 + k // 50})
        span("train.step", k + 2, k + 1, 0.100)
        span("train.forward", k + 3, k + 2, 0.020)
        span("moe.dispatch", k + 4, k + 3, 0.008,
             {"choices": 64, "kept": 40, "slots": 64})
        span("moe.experts", k + 5, k + 4, 0.003)
        span("train.backward", k + 6, k + 2, 0.050)
        span("moe.dispatch", k + 7, k + 6, 0.005,
             {"choices": 64, "kept": 40, "slots": 64})
        span("moe.experts", k + 8, k + 7, 0.002)
        span("train.optimizer", k + 9, k + 2, 0.028,
             {"elems": 1000, "kernel_elems": 1000 if k == 0 else 0,
              "launches": 3 if k == 0 else 0})
        span("consumer.get", k + 10, None, None, {"bytes": 4096}, cat="read")
    return out


@pytest.mark.parametrize("name,want", [
    ("train.optimizer_share", 28.0),
    ("train.backward_share", 50.0),
    ("train.host_syncs_per_step", 2.0),
    ("moe.dispatch_share", 8.0),          # (5 + 3) of 100 ms a step
    ("moe.slot_use", 62.5),
    ("consumer.get_ms_p95", 18.8),        # 1..20 ms and 1..5 ms, 25 GETs
    ("train.optimizer_kernel_share", 50.0),
])
def test_each_new_reader_reads_spans_and_registry(monkeypatch, name, want):
    read = _reader(name)
    reg = obs_registry.MetricsRegistry()
    for inst, n in (("d0c0", 20), ("d1c0", 5)):
        h = reg.histogram(f"consumer.{inst}.get_latencies")
        for i in range(1, n + 1):
            h.append(i * 1e-3)
    reg.histogram("consumer.d0c0.read_latencies").append(9.0)
    monkeypatch.setattr(obs_registry, "_default", reg)
    monkeypatch.setattr(TRACER, "spans", _fake_spans)
    run = SimpleNamespace(trace={"busy_s": 1.0}, timings=[], profiled=None)
    assert read(run) == pytest.approx(want)
    assert read(SimpleNamespace(trace=None)) is None
    # a program without the spans and histograms (the parent commit's)
    monkeypatch.setattr(obs_registry, "_default", obs_registry.MetricsRegistry())
    monkeypatch.setattr(TRACER, "spans", lambda: [
        s for s in _fake_spans() if s.name == "pipeline.data_wait"])
    assert read(run) is None
