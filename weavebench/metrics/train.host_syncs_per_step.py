"""Device-to-host syncs a step: the mean of ``host_syncs`` over the fused
loop's ``pipeline.compute`` spans of the first traced slice (torch's sync
debug mode counts each ``.item()``, ``float()`` of a device tensor,
``nonzero`` or boolean index inside the step and its loss read)."""


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    counts = [s.args["host_syncs"] for s in TRACER.spans()
              if s.name == "pipeline.compute" and s.args and "host_syncs" in s.args]
    return sum(counts) / len(counts) if counts else None
