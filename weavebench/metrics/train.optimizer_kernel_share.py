"""Share of the parameter elements AdamW updated that were in the tables of
K5, the hand-written multi-tensor kernel: Σ ``kernel_elems`` over Σ
``elems`` of the program's ``train.optimizer`` spans in the first traced
slice (the span's args, host-known integers). 100 where every element took
the kernel; nothing where the program writes no such args."""


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    done = total = 0
    for s in TRACER.spans():
        if s.name == "train.optimizer" and s.args and "kernel_elems" in s.args:
            done += s.args["kernel_elems"]
            total += s.args["elems"]
    return 100.0 * done / total if total else None
