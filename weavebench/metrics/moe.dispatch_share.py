"""The MoE dispatch's share of the step's device time: Σ of the
``moe.dispatch`` spans' own device time (their ``device_s`` less that of
the ``moe.experts`` span inside each: router, top-k, ``plan``, the
``index_add`` scatter, the gather back and the combine bmm; the remat's
recompute inside the backward included) over Σ ``device_s`` of the
``train.step`` spans, over the steps of the first traced slice."""


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    spans = [s for s in TRACER.spans() if getattr(s, "device_s", None) is not None]
    experts = {}
    for s in spans:
        if s.name == "moe.experts":
            experts[s.parent] = experts.get(s.parent, 0.0) + s.device_s
    step = sum(s.device_s for s in spans if s.name == "train.step")
    own = [s.device_s - experts.get(s.id, 0.0) for s in spans if s.name == "moe.dispatch"]
    if not own or step <= 0:
        return None
    return 100.0 * sum(own) / step
