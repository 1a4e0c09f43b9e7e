"""The reader of ``wkv6.backward_kernel_share`` on planted spans, on the
CPU: the share of the WKV6 backward's tokens that K4's backward kernel
took, and nothing to read without a trace or from a program whose spans
carry no ``kernel_tokens``."""
from types import SimpleNamespace

import pytest

from wb.spec import Spec, metric_reader

METRIC = "wkv6.backward_kernel_share"
CELL = "rwkv6-3b.pretrain-s1k"


def _spans(kernel_tokens):
    from repro_torch.obs.tracer import Span
    spans = []
    for k, sid in enumerate(range(1, 7)):   # 3 steps of 2 layers
        s = Span("wkv6.backward", "compute", 0.0, 1.0, 0, None, sid, None)
        s.args = {"tokens": 4096, "heads": 40, "chunk": 64}
        if kernel_tokens is not None:
            s.args["kernel_tokens"] = kernel_tokens[k % len(kernel_tokens)]
        spans.append(s)
    other = Span("wkv6.forward", "compute", 0.0, 1.0, 0, None, 9, None)
    other.args = {"tokens": 4096, "heads": 40, "chunk": 64, "kernel_tokens": 0}
    return spans + [other]


@pytest.mark.parametrize("kernel_tokens,want", [
    ([4096], 100.0),          # every layer's backward through the kernel
    ([0], 0.0),               # the plain rule everywhere
    ([4096, 0], 50.0),        # one layer in two
])
def test_reads_the_share_of_the_backwards_tokens(monkeypatch, kernel_tokens, want):
    pytest.importorskip("torch")
    from repro_torch.obs.tracer import TRACER
    read = metric_reader(METRIC)
    monkeypatch.setattr(TRACER, "spans", lambda: _spans(kernel_tokens))
    assert read(SimpleNamespace(trace={"busy_s": 1.0})) == pytest.approx(want)
    assert read(SimpleNamespace(trace=None)) is None


def test_reads_nothing_from_spans_without_the_arg(monkeypatch):
    """A program whose ``wkv6.backward`` spans carry no ``kernel_tokens``
    (the parent commit's) gives nothing to read."""
    pytest.importorskip("torch")
    from repro_torch.obs.tracer import TRACER
    read = metric_reader(METRIC)
    monkeypatch.setattr(TRACER, "spans", lambda: _spans(None))
    assert read(SimpleNamespace(trace={"busy_s": 1.0})) is None


def test_the_rwkv_cell_alone_lists_it():
    (entry,) = [p for p in Spec().data["per_layer"] if p["name"] == METRIC]
    assert entry["workloads"] == [CELL] and entry["moves"] == "tokens_per_s"
    assert entry["source"] == "program_counter" and entry["layer"] == "train step"
