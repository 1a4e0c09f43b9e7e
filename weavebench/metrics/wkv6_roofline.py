"""K4's share of its roofline: the least time every
``repro_torch::wkv6_fwd`` call in the traced slice needs, over the device
time of every kernel launched inside those calls. Under per-layer remat the
calls are the forward's and the recompute's inside the backward, one of
each a layer.

A call's work, from its input shapes r, k, v, w (B, S, H, dh) and u (H,
dh): FLOPs 4·B·S·H·dh², the recurrence's k^T v and r·S a token and head;
bytes r, k, v, w read and y written at the configuration's compute dtype,
u read and the final state (B, H, dh, dh) written in fp32. Bytes bound it
on the H100."""
from wb.flops import least_seconds

OP = "repro_torch::wkv6_fwd"
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def wkv6_op_work(r_shape, u_shape, itemsize: int):
    """(FLOPs, bytes) of one WKV6 forward call."""
    B, S, H, dh = r_shape
    n = B * S * H * dh
    return 4 * n * dh, 5 * n * itemsize + 4 * (u_shape[0] * u_shape[1] + B * H * dh * dh)


def read(run):
    calls = (run.trace or {}).get("calls", {}).get(OP)
    if not calls:
        return None
    itemsize = ITEMSIZE[run.model["compute_dtype"]]
    need = spent = 0.0
    for dims, seconds in calls:
        if not dims or seconds <= 0:
            continue
        need += least_seconds(*wkv6_op_work(dims[0], dims[4], itemsize), run.peaks)
        spent += seconds
    return 100.0 * need / spent if spent > 0 else None
