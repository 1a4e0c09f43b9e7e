"""Share of the expert bmms' rows that carry a kept choice: Σ ``kept`` over
Σ ``slots`` (E · capacity) of the ``moe.dispatch`` spans of the first
traced slice. A choice past its expert's capacity is dropped; ``choices``
less ``kept`` counts the drops."""


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    kept = slots = 0
    for s in TRACER.spans():
        if s.name == "moe.dispatch" and s.args and "kept" in s.args and "slots" in s.args:
            kept += s.args["kept"]
            slots += s.args["slots"]
    return 100.0 * kept / slots if slots else None
