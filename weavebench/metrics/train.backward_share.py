"""The backward's share of the step's device time: Σ ``device_s`` of the
program's ``train.backward`` spans (the grads with the remat's recompute,
their cast to fp32 or accumulation) over Σ ``device_s`` of its ``train.step``
spans, over the steps of the first traced slice (the tracer is enabled there
only)."""

NAME = "train.backward"


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
