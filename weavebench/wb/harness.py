"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

The window drives the program's main training path: the data plane's
readers (``open_dataplane``, one ``TGBBatchReader`` a mesh position)
fanned in by ``ReaderFanInSource`` into ``FusedTrainLoop`` at the
traffic's ring depth, which runs ``make_train_step``'s step (the model's
forward and backward through the kernel operators, then AdamW).

Set-up builds that one loop, with the weights drawn on the device from the
seed, and drives it through the traffic's ``checked_steps`` first steps:
the same ``run`` call and feed as the window. The reference follows those
steps once the window has closed and the program's state is freed.

What belongs to a model family (the parameter layout the weights are drawn
in, the reference's readings, the step's model FLOPs) comes from the
reference module the configuration names; nothing here names a family.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Optional

import numpy as np

from wb import check
from wb.flops import PEAKS
from wb.spec import Spec, metric_reader, reference
from wb.traffic import fan_in, open_feed
from wb.weights import draw_leaf, frame_embeddings, nest

#: steps of a traced window under the profiler: without the operators'
#: input shapes, then with them
TRACE_STEPS, OP_STEPS = 6, 3
#: the program's operators, whose calls in the second traced slice reach the
#: metric readers (``run.trace["calls"]``, by operator name)
OPS = "repro_torch::"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"weavebench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class _AlteredSource:
    """A fault: the fan-in source with one token of every grid altered."""

    def __init__(self, inner, vocab):
        self.inner, self.vocab, self.topology = inner, vocab, inner.topology

    def next_tokens(self, timeout_s=None):
        g = self.inner.next_tokens(timeout_s=timeout_s).copy()
        g[0, 1] = (g[0, 1] + 1) % self.vocab
        return g

    def __getattr__(self, name):
        return getattr(self.inner, name)


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", fault: Optional[str] = None,
             overrides: Optional[dict] = None, feed=None) -> dict:
    """Run cell ``name`` once; returns the result line's object (with
    ``checks`` last). ``device``, ``fault`` and ``overrides`` (of the
    traffic and model) serve the CPU tests."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.obs.tracer import TRACER
    from repro_torch.train import OptimizerConfig, StepConfig, init_opt_state, make_train_step
    from repro_torch.train.pipeline import FusedTrainLoop
    from repro_torch.train.step import make_eval_step

    cell = spec.cell(name)
    cfg, traffic, limits = spec.config(cell), spec.traffic(cell), spec.limits(cell)
    m = dict(cfg["model"])
    if overrides:
        m.update(overrides.get("model", {}))
        traffic.update(overrides.get("traffic", {}))
    GB, S, P = traffic["global_batch"], traffic["seq_len"], traffic["frontend_prefix"]
    if feed is None:
        feed = open_feed(traffic, m["vocab_size"], seed)
    try:
        ref_mod = reference(cfg["reference"])
        lay = ref_mod.layout(m)
        flat = {spec_[0]: draw_leaf(seed, i, spec_, device) for i, spec_ in enumerate(lay)}
        params = nest(flat)
        opt_d = traffic["optimizer"]
        opt = init_opt_state(params, opt_d["state_dtype"])
        model_cfg = ModelConfig(**m)
        step_fn = make_train_step(model_cfg, OptimizerConfig(**opt_d),
                                  StepConfig(microbatches=1, frontend_prefix=P))
        fe = frame_embeddings(seed, (GB, P, m["d_model"]), device) if P else None
        log(f"weights, optimizer state and inputs drawn at {time.perf_counter() - t_start:.2f} s")
        eval_fn = make_eval_step(model_cfg) if fault == "state_unchanged" else None
        dev_tokens = []

        def step(p, o, batch):
            t = batch["tokens"]
            dev_tokens.append(t.clone())
            b = {"tokens": t}
            if fe is not None:
                b["frontend_embeds"] = fe
            if fault == "half_batch":
                b = {k: v[:GB // 2] for k, v in b.items()}
            if eval_fn is not None:
                loss, _ = eval_fn(p, b)
                return p, o, {"loss": loss}
            return step_fn(p, o, b)

        src = fan_in(feed, traffic)
        readers = src.readers
        if fault == "token_altered":
            src = _AlteredSource(src, m["vocab_size"])
        loop = FusedTrainLoop(src, step, params, opt, topology=feed.topology,
                              depth=traffic["depth"], timeout_s=traffic["loop_timeout_s"],
                              device=device)
        grids = []

        def on_batch(_i, host):
            grids.append(host)

        b1 = opt_d["b1"]
        prog = {"losses": [], "grad1": {}, "change": {}}
        routes = record_routing(m) if m.get("moe_num_experts") else None
        loop.start()
        for i in range(traffic["checked_steps"]):
            with routes.step(i) if routes else contextlib.nullcontext():
                rep = loop.run(1, on_batch=on_batch)
            prog["losses"] += rep.losses
            log(f"checked step {i}: wall {rep.timings[0].wall_s:.3f} s, data_wait "
                f"{rep.timings[0].data_wait_s:.3f} s")
            if i == 0:
                with torch.no_grad():
                    prog["grad1"] = {k: float(v.norm()) / (1 - b1) for k, v in
                                     flat_leaves(loop.opt_state["m"]).items()}
        with torch.no_grad():
            for i, spec_ in enumerate(lay):
                p0 = draw_leaf(seed, i, spec_, device)
                prog["change"][spec_[0]] = float((flat[spec_[0]] - p0).norm())
                del p0
        log(f"{traffic['checked_steps']} checked steps done at {time.perf_counter() - t_start:.2f} s")
        feed.join_backlog()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        # -- the window ---------------------------------------------------------
        lat0 = [r.stats.read_latencies.count for r in readers]
        limit_steps = feed.steps - traffic["depth"] - 1
        timings, profiled, traced = [], None, None
        log(f"set-up {setup_s:.2f} s; window of {seconds} s")
        feed.arm(seconds)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and loop.consumed < limit_steps:
            if trace and profiled is None and time.perf_counter() - t0 >= seconds / 3 \
                    and loop.consumed + TRACE_STEPS + OP_STEPS < limit_steps:
                from wb.trace import TracedSlice
                first = len(timings)
                TRACER.clear()
                TRACER.enable()
                with TracedSlice(torch) as traced:
                    lo = time.perf_counter()
                    for _ in range(TRACE_STEPS):
                        timings += loop.run(1, on_batch=on_batch).timings
                    hi = time.perf_counter()
                TRACER.disable()
                with TracedSlice(torch, ops=True) as traced_ops:
                    lo_ops = time.perf_counter()
                    for _ in range(OP_STEPS):
                        timings += loop.run(1, on_batch=on_batch).timings
                    hi_ops = time.perf_counter()
                profiled = (first, len(timings))
                log(f"traced steps {first}-{len(timings) - 1}")
                continue
            timings += loop.run(1, on_batch=on_batch).timings
        window_s = time.perf_counter() - t0
        lat_new = []
        for r, c0 in zip(readers, lat0):
            n = r.stats.read_latencies.count - c0
            lat_new += list(r.stats.read_latencies)[-n:] if n > 0 else []
        loop.stop()
        feed.close()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        host_tokens = torch.stack(dev_tokens).cpu().numpy() if dev_tokens else None
        del loop, params, opt, flat, step_fn, fe, eval_fn, dev_tokens, step
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # -- the check ---------------------------------------------------------
        grids_wrong = sum(not np.array_equal(g, feed.expected_grid(i)) for i, g in enumerate(grids))
        tokens_wrong = sum(not np.array_equal(host_tokens[i], g) for i, g in enumerate(grids)) \
            if host_tokens is not None and len(host_tokens) == len(grids) else len(grids) or 1
        n_check = traffic["checked_steps"]
        batches = [torch.from_numpy(feed.expected_grid(i)).to(device) for i in range(n_check)]
        fe_ref = frame_embeddings(seed, (GB, P, m["d_model"]), device) if P else None
        log(f"window: {len(timings)} steps in {window_s:.2f} s; peak {peak / 2**30:.2f} GiB")
        t_ref = time.perf_counter()
        followed = ref_mod.Routes(routes.choices) if routes else None
        ref = ref_mod.train_readings(m, opt_d, lambda i: draw_leaf(seed, i, lay[i], device),
                                     batches, frontend=fe_ref, routes=followed)
        log(f"reference: {time.perf_counter() - t_ref:.2f} s")
        numbers = {"grids_wrong": grids_wrong, "tokens_wrong": tokens_wrong,
                   **check.readings(prog, ref, followed)}
        correct = bool(timings) and check.judge(numbers, limits)
        losses = [t.loss for t in timings]
        failed = grids_wrong + tokens_wrong + sum(not math.isfinite(x) for x in losses)

        # -- the metrics -------------------------------------------------------
        tokens_per_step = GB * S
        run = SimpleNamespace(
            cell=cell, model=m, traffic=traffic, timings=timings, window_s=window_s,
            profiled=profiled, read_latencies=lat_new, peaks=PEAKS, trace=None,
            step_flops=ref_mod.step_model_flops(m, GB, S, P), tokens_per_step=tokens_per_step)
        if trace:
            if traced is None:
                raise RuntimeError("the window ended before its traced slice")
            from wb.trace import summarize
            run.trace = summarize(traced.events(), traced.t_clock, lo, hi, TRACER.spans())
            run.trace["calls"] = summarize(traced_ops.events(), traced_ops.t_clock, lo_ops,
                                           hi_ops, ops=OPS)["calls"]
            metrics = {}
            for mt in spec.metrics(cell, "per_layer"):
                v = metric_reader(mt["name"])(run)
                if v is not None:
                    metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
        else:
            walls = [t.wall_s for t in timings]
            e2e = {"tokens_per_s": len(timings) * tokens_per_step / window_s,
                   "setup_s": setup_s}
            if walls:
                e2e["step_ms_p90"] = (statistics.quantiles(walls, n=10, method="inclusive")[8]
                                      if len(walls) > 1 else walls[0]) * 1e3
            metrics = {mt["name"]: {"value": e2e[mt["name"]], "unit": mt["unit"]}
                       for mt in spec.metrics(cell, "end_to_end")}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
        out = {"correct": correct, "attempted": len(grids), "failed": int(failed),
               "metrics": metrics, "device": dev}
        if trace:
            dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
            out["breakdown"] = {"device_ops": run.trace["device_ops"],
                                "idle_gaps": run.trace["idle_gaps"]}
        walls_ms = sorted(t.wall_s * 1e3 for t in timings)
        out["info"] = {"window_steps": len(timings), "window_s": window_s,
                       "step_ms_min_med_max": [walls_ms[0], walls_ms[len(walls_ms) // 2],
                                               walls_ms[-1]] if walls_ms else None,
                       "losses_first_last": [losses[0], losses[-1]] if losses else None,
                       "prog": prog, "ref": ref}
        out["info"]["readings"] = numbers
        if followed is not None:
            out["info"]["route_flips"] = followed.flips
        out["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
        return out
    finally:
        feed.stop.set()
        for t in feed.threads:
            t.join(timeout=120.0)


class record_routing:
    """The program's MoE routing choices during the checked steps, by (step,
    layer): the first ``num_layers`` calls of ``repro_torch.models.moe.top_k``
    in a step are the forward's (the rest, the backward's recompute, repeat
    them in reverse). Recorded, never changed; the window runs without it."""

    def __init__(self, m: dict):
        self.layers, self.choices, self.calls = m["num_layers"], {}, []

    @contextlib.contextmanager
    def step(self, i: int):
        from repro_torch.models import moe
        top_k = moe.top_k

        def recording(probs, k):
            out = top_k(probs, k)
            self.calls.append(out[1].detach().cpu())
            return out
        moe.top_k = recording
        try:
            yield
        finally:
            moe.top_k = top_k
            for layer, idx in enumerate(self.calls[:self.layers]):
                self.choices[(i, layer)] = idx
            self.calls = []


def flat_leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def finite(x):
    """``x`` with every infinite or NaN float written as a string, so the
    result line is strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(args, t_start: float) -> int:
    """The benchmark's command: exit 0 with one result line on standard
    output, or non-zero with none."""
    import json

    spec = Spec()
    cell = spec.cell(args.workload)
    # the data plane needs no torch: its writer starts before torch loads
    feed = open_feed(spec.traffic(cell), spec.config(cell)["model"]["vocab_size"], args.seed)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        feed.close()
        print(f"weavebench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                       feed=feed)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"weavebench: the run loaded {bad}; nothing of the port may load JAX or the "
              f"JAX package", file=sys.stderr)
        return 3
    out = finite(out)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    return 0
