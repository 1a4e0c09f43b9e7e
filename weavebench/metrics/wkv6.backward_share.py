"""K4's backward rule's share of the step's device time: Σ ``device_s`` of
the program's ``wkv6.backward`` spans (the rule of ``_WKV6.backward``,
which differentiates the chunked plain form, a layer each) over Σ
``device_s`` of its ``train.step`` spans, over the steps of the first
traced slice (the tracer is enabled there only). The ``wkv6.forward``
spans, the kernel's calls, are not counted: under per-layer remat each runs
twice a layer, in the forward and again as the recompute inside
``train.backward``."""

NAME = "wkv6.backward"


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    dev = {}
    for s in TRACER.spans():
        d = getattr(s, "device_s", None)
        if d is not None:
            dev[s.name] = dev.get(s.name, 0.0) + d
    if NAME not in dev or dev.get("train.step", 0.0) <= 0:
        return None
    return 100.0 * dev[NAME] / dev["train.step"]
