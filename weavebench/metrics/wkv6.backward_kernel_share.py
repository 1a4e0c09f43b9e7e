"""Share of the tokens whose WKV6 backward K4's backward kernel took: Σ
``kernel_tokens`` over Σ ``tokens`` of the program's ``wkv6.backward``
spans in the first traced slice (the span's args, host-known integers; a
layer's span counts B·S tokens, and its ``kernel_tokens`` are those tokens
where the kernel ran and 0 where the plain rule did). 100 where every
layer's backward took the kernel; nothing where the program writes no such
arg."""

NAME = "wkv6.backward"


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.tracer import TRACER
    done = total = 0
    for s in TRACER.spans():
        if s.name == NAME and s.args and "kernel_tokens" in s.args:
            done += s.args["kernel_tokens"]
            total += s.args["tokens"]
    return 100.0 * done / total if total else None
