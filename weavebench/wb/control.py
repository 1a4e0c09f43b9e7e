"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one precision below the
configuration's (fp8 operands for its bf16), and the same with half of
each batch left out. Each is read against the reference at the
configuration's precision by ``check.readings``, on the cell's own inputs:
the weights, frame embeddings and first batches a run of that seed gets;
for an MoE model the reference follows the control's routing choices, as it
follows the program's in a run.
The benchmark's own runs never run this; each control's reading also
gives its gap at every checked step and every leaf.
"""
from __future__ import annotations

import time

from wb import check
from wb.spec import Spec, reference
from wb.weights import draw_leaf, frame_embeddings, token_stream

CONTROLS = ("fp8", "half_batch")


def control_readings(spec: Spec, name: str, seed: int, device: str = "cuda",
                     overrides=None, controls=CONTROLS) -> dict:
    """{control: {number: reading}} for cell ``name`` at ``seed``."""
    import torch

    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    m = dict(cfg["model"])
    if overrides:
        m.update(overrides.get("model", {}))
        traffic.update(overrides.get("traffic", {}))
    GB, S, P = traffic["global_batch"], traffic["seq_len"], traffic["frontend_prefix"]
    n = traffic["checked_steps"]
    ref_mod = reference(cfg["reference"])
    lay = ref_mod.layout(m)
    tokens = token_stream(seed, traffic["backlog_steps"], GB * S, m["vocab_size"])
    batches = [torch.from_numpy(tokens[i * GB * S:(i + 1) * GB * S].reshape(GB, S)).to(device)
               for i in range(n)]
    fe = frame_embeddings(seed, (GB, P, m["d_model"]), device) if P else None

    moe = bool(m.get("moe_num_experts"))

    def readings(**kw):
        t0 = time.perf_counter()
        r = ref_mod.train_readings(m, traffic["optimizer"],
                                   lambda i: draw_leaf(seed, i, lay[i], device), batches,
                                   frontend=fe, **kw)
        r["seconds"] = time.perf_counter() - t0
        return r

    out = {}
    kwargs = {"fp8": {"numerics": "fp8"}, "half_batch": {"rows": GB // 2}}
    for c in controls:
        if c == "half_batch" and GB < 2:
            continue    # a batch of one row has no half to leave out
        # the control in the program's place: as with the program, the
        # reference follows its routing choices
        own = ref_mod.Routes() if moe else None
        r = readings(routes=own, **kwargs[c])
        followed = ref_mod.Routes(own.own) if moe else None
        ref = readings(routes=followed)
        out["reference_s"] = ref["seconds"]
        out[c] = check.readings(r, ref, followed)
        out[c]["loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(r["losses"], ref["losses"])]
        out[c]["grad_gaps"] = dict(zip(ref["grad1"], check.leaf_gaps(r["grad1"], ref["grad1"])))
    return out
