"""K1's share of its roofline: the least time the work of every
``repro_torch::flash_attention_fwd`` call in the traced slice needs
(``wb.flops.attention_op_work``: causal pairs, q, k, v and o once), over the
device time of every kernel launched inside those calls."""
from wb.flops import attention_op_work, least_seconds

OP = "repro_torch::flash_attention_fwd"


def read(run):
    calls = (run.trace or {}).get("calls", {}).get(OP) or []
    need = spent = 0.0
    for dims, seconds in calls:
        if not dims or seconds <= 0:
            continue
        need += least_seconds(*attention_op_work(dims[0], dims[1], True), run.peaks)
        spent += seconds
    return 100.0 * need / spent if spent > 0 else None
