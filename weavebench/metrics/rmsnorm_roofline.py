"""K2's share of its roofline: the least time every
``repro_torch::rmsnorm_fwd`` call in the traced slice needs
(``wb.flops.rmsnorm_op_work``: x and the output once, bytes-bound), over the
device time of every kernel launched inside those calls."""
from wb.flops import least_seconds, rmsnorm_op_work

OP = "repro_torch::rmsnorm_fwd"


def read(run):
    calls = (run.trace or {}).get("calls", {}).get(OP) or []
    need = spent = 0.0
    for dims, seconds in calls:
        if not dims or seconds <= 0:
            continue
        need += least_seconds(*rmsnorm_op_work(dims[0], dims[1]), run.peaks)
        spent += seconds
    return 100.0 * need / spent if spent > 0 else None
