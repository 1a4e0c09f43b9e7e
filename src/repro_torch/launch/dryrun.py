"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (architecture
x input shape) on the production meshes, as the program a mesh of H100s
would run, with no card and no data.

Per cell:

  1. the ``"fake"`` process group is initialised at the mesh's world size
     (256 or 512) and the mesh built over it (``launch/mesh.py``);
  2. parameters, optimizer state, batch and decode state are fake CUDA
     DTensors (``FakeTensorMode``: shapes only, no memory), placed by
     ``sharding.specs.param_shardings`` and ``train.step.input_specs``;
  3. the train, prefill or decode step runs under the cost reader
     (``launch/hlo_analysis.py``), which counts what one device runs.

The reference compiles each cell and reads XLA's memory analysis and the
post-SPMD HLO; its layer scan is one loop the HLO reader multiplies by its
trip count. The port's layers are a Python loop, so each cell is traced at
two depths (the hybrid: one and two groups of Mamba2 layers and their
shared block, and one tail layer) and the costs extrapolated linearly to
the config's depth; a train step of more than four microbatches is traced
at two and four and extrapolated the same way. Each record keeps the
reference's keys: ``memory`` (argument, output, temp and alias bytes from
the traced run's live storages, ``peak_per_device_bytes = arg + temp + out
- alias``), ``hlo`` (``launch/hlo_analysis.HLOCosts``) and ``timing``; XLA's
``cost_analysis``, the reference's ``xla_cost``, has no counterpart and is
left out.

The fake device ``"cuda"`` needs no card: it models the card's program (the
kernel operators trace through their fake implementations). A mesh of one
device runs the plain program on plain fake tensors, the program a card
runs; its FLOPs are what ``FlopCounterMode`` counts over a real run. ``--device
cpu`` models the same program on the CPU's fake tensors, where a CPU-only
torch refuses some fake CUDA operators (tests).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.registry import ARCH_IDS, canonical, get_config
from repro_torch.configs.shapes import SHAPES, InputShape, shape_applicable
from repro_torch.launch import hlo_analysis
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.specs import (axis_sizes, make_rules,
                                        param_shardings, use_rules)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (StepConfig, input_specs,
                                    make_decode_step, make_prefill_step,
                                    make_train_step)

#: logical axes of each family's decode state (the reference's
#: ``decode_state_specs`` axes)
_KV_AXES = ("layers", "batch", "cache_seq", "kv", None)
STATE_AXES = {
    "k": _KV_AXES, "v": _KV_AXES,
    "wkv": ("layers", "batch", None, None, None),
    "tm_shift": ("layers", "batch", "embed"),
    "cm_shift": ("layers", "batch", "embed"),
    "conv": ("layers", "batch", None, None),
    "ssd": ("layers", "batch", None, None, None),
    "attn_k": (None, "batch", "cache_seq", "kv", None),
    "attn_v": (None, "batch", "cache_seq", "kv", None),
}


def default_microbatches(cfg: ModelConfig, global_batch: int, dp: int) -> int:
    """Largest power-of-two microbatch count keeping (GB/n) % dp == 0 and
    per-device microbatch around 1-2 sequences for big models."""
    n = 1
    target = 8 if cfg.d_model >= 4096 else 2
    while n < target and (global_batch // (n * 2)) % dp == 0 \
            and global_batch // (n * 2) >= dp:
        n *= 2
    return n


def _shape(shape) -> InputShape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _fake_dtensor(mesh, shape, dtype, placements, device: str):
    """A DTensor of global ``shape`` over ``mesh`` whose local tensor is an
    empty tensor of the current fake mode (the first shard's size where a
    dim does not divide)."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=tuple(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _local_bytes(tree) -> int:
    return sum((t.to_local() if hasattr(t, "placements") else t).numel()
               * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               microbatches: Optional[int] = None,
               seq_res: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               opt_overrides: Optional[Dict[str, Any]] = None,
               grad_accum_dtype: str = "float32",
               device: str = "cuda"):
    """Returns (fn, args, meta): ``fn(*args)`` runs the cell's step on fake
    DTensors; call it inside the ``FakeTensorMode`` this was built in.
    ``meta`` holds dp, the rules, the microbatches and, for the memory
    analysis, ``argument_bytes`` and the bytes of the outputs that are new
    (``new_output_bytes``) and written in place (``alias_bytes``).
    ``shape_name`` names an assigned shape, or is an ``InputShape``."""
    shape = _shape(shape_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    rules = make_rules(mesh, cfg.num_heads, cfg.num_kv_heads)
    if seq_res:
        rules.mapping["seq_res"] = ("model",)
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)

    # one device runs the plain program: nothing to shard, no DTensor
    one = mesh.size() == 1

    def fake(shape_, dtype, pl):
        if one:
            return torch.empty(shape_, dtype=dtype, device=device)
        return _fake_dtensor(mesh, shape_, dtype, pl, device)

    def place(shape_, dtype, axes):
        return fake(shape_, dtype, rules.sharding(axes, shape_))

    specs = M.param_specs(cfg)
    params = tree_unflatten(specs, [
        fake(s.shape, s.dtype, pl) for s, pl in
        zip(tree_leaves(specs), tree_leaves(param_shardings(rules, specs)))])
    run_rules = None if one else rules
    binputs = input_specs(cfg, shape.global_batch, shape.seq_len, shape.kind)
    batch = {k: place(tuple(m.shape), m.dtype, a)
             for k, (m, a) in binputs.items()}
    meta: Dict[str, Any] = {
        "dp": dp, "rules": {k: list(v) if v else None
                            for k, v in rules.mapping.items()}}

    if shape.kind == "train":
        n_micro = microbatches or default_microbatches(
            cfg, shape.global_batch, dp)
        meta["microbatches"] = n_micro
        opt_cfg = OptimizerConfig(**(opt_overrides or {}))
        meta["opt_state_dtype"] = opt_cfg.state_dtype
        opt_dt = getattr(torch, opt_cfg.state_dtype)
        mom = lambda: tree_map(lambda s: place(s.shape, opt_dt,  # noqa: E731
                                               s.logical_axes), specs)
        opt = {"m": mom(), "v": mom(),
               "step": place((), torch.int32, ())}
        step = make_train_step(cfg, opt_cfg, StepConfig(
            microbatches=n_micro, grad_accum_dtype=grad_accum_dtype))
        state_bytes = _local_bytes(params) + _local_bytes(opt)
        meta.update(argument_bytes=state_bytes + _local_bytes(batch),
                    alias_bytes=state_bytes, new_output_bytes=4 * 4)

        def fn(params, opt, batch):
            with use_rules(run_rules), _replicate_plain():
                return step(params, opt, batch)

        return fn, (params, opt, batch), meta

    # a prefill's cache also holds the frontend prefix's positions
    T = shape.seq_len + (batch["frontend_embeds"].shape[1]
                         if "frontend_embeds" in batch else 0)
    state = {k: place(s, dt, STATE_AXES[k]) for k, (s, dt) in
             M.decode_state_specs(cfg, shape.global_batch, T).items()}
    V = cfg.vocab_size
    logits = (place((shape.global_batch, cfg.num_codebooks, V), cfg.cdtype,
                    ("batch", None, "vocab")) if cfg.family == "audio" else
              place((shape.global_batch, V), cfg.cdtype, ("batch", "vocab")))
    meta.update(argument_bytes=_local_bytes(params) + _local_bytes(batch)
                + _local_bytes(state), alias_bytes=_local_bytes(state),
                new_output_bytes=_local_bytes(logits))

    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg)

        def fn(params, batch, state):
            with use_rules(run_rules), _replicate_plain():
                return prefill(params, batch, cache=state)

        return fn, (params, batch, state), meta

    decode = make_decode_step(cfg)
    pos = shape.seq_len - 1

    def fn(params, state, tokens):
        with use_rules(run_rules), _replicate_plain():
            return decode(params, state, tokens, pos)

    return fn, (params, state, batch["tokens"]), meta


def _replicate_plain():
    """Plain tensors made inside the model (RoPE angles, masks, the aux
    loss's zero) take part as replicated DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _depth_plan(cfg: ModelConfig) -> Tuple[int, List[Tuple[int, float]]]:
    """(base depth, [(depth, weight)]): the costs at ``cfg.num_layers`` are
    c(base) + sum weight·(c(depth) - c(base))."""
    L = cfg.num_layers
    if cfg.family == "hybrid" and cfg.attn_every:
        P = cfg.attn_every
        groups, tail = L // P, L % P
        plan = [(2 * P, groups - 1), (P + 1, tail)]
        return P, [(d, w) for d, w in plan if w]
    return 1, [(2, L - 1)]


def _trace(cfg, shape_name, mesh, device, microbatches, **kw):
    """(HLOCosts, meta) of one traced cell at ``cfg``'s depth."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, meta = build_cell(cfg, shape_name, mesh,
                                    microbatches=microbatches,
                                    device=device, **kw)
        costs = hlo_analysis.analyze(fn, *args)
    return costs, meta


def trace_costs(cfg: ModelConfig, shape_name: str, mesh, device: str = "cuda",
                microbatches: Optional[int] = None, **kw):
    """(HLOCosts at full depth and microbatches, meta at full depth, number
    of traces): the depth plan's traces, each train trace at the cell's
    microbatches, or at two and four of them extrapolated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():          # the full-depth arguments' bytes
        meta = build_cell(cfg, shape_name, mesh, microbatches=microbatches,
                          device=device, **kw)[2]
    n_micro = meta.get("microbatches")
    counts = [n_micro] if n_micro is None or n_micro <= 4 else [2, 4]
    base, plan = _depth_plan(cfg)
    by_count = []
    for m in counts:
        at = {d: _trace(cfg.replace(num_layers=d), shape_name, mesh, device,
                        m, **kw)[0] for d in [base] + [d for d, _w in plan]}
        by_count.append(hlo_analysis.combine(
            at[base], [(at[d], w) for d, w in plan],
            loop="layers", trips=cfg.num_layers))
    costs = by_count[0]
    if len(by_count) == 2:
        costs = hlo_analysis.combine(
            by_count[0], [(by_count[1], (n_micro - 2) / 2)],
            loop="microbatches", trips=n_micro)
        # live bytes fall as the microbatches shrink: four's peak bounds
        # the step's from above
        costs.peak_live_bytes = by_count[1].peak_live_bytes
    return costs, meta, len(counts) * (1 + len(plan))


def cost_record(costs, meta) -> Dict[str, Any]:
    """The record's ``memory`` and ``hlo`` entries from a cell's costs and
    the meta ``build_cell`` gave: the arguments and outputs at full depth,
    the traced run's live storages beside them as ``temp_bytes``."""
    arg, alias = meta["argument_bytes"], meta["alias_bytes"]
    out = alias + meta["new_output_bytes"]
    temp = max(0, int(costs.peak_live_bytes) - meta["new_output_bytes"])
    return {
        "memory": {"argument_bytes": int(arg), "output_bytes": int(out),
                   "temp_bytes": temp, "alias_bytes": int(alias),
                   "peak_per_device_bytes": int(arg + temp + out - alias)},
        "hlo": {"flops": costs.flops,
                "bytes_accessed": costs.bytes_accessed,
                "collective_bytes": costs.collective_bytes,
                "collective_count": costs.collective_count,
                "total_collective_bytes": costs.total_collective_bytes,
                "dot_count": costs.dot_count,
                "while_loops": costs.while_loops[:16]}}


def _init_fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: Optional[int] = None, seq_res: bool = False,
             overrides: Optional[Dict[str, Any]] = None,
             opt_overrides: Optional[Dict[str, Any]] = None,
             grad_accum_dtype: str = "float32",
             device: str = "cuda", verbose: bool = True) -> Dict[str, Any]:
    import torch.distributed as dist
    from repro_torch.kernels.common import register_shardings
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "family": cfg.family,
    }
    ok, reason = shape_applicable(shape, cfg)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        return record
    register_shardings()
    t0 = time.time()
    try:
        _init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        if overrides:
            cfg = cfg.replace(**overrides)
        costs, meta, traces = trace_costs(
            cfg, shape_name, mesh, device=device, microbatches=microbatches,
            seq_res=seq_res, opt_overrides=opt_overrides,
            grad_accum_dtype=grad_accum_dtype)
        for k in ("dp", "rules", "microbatches", "opt_state_dtype"):
            if k in meta:
                record[k] = meta[k]
        record.update(cost_record(costs, meta))
        record["timing"] = {"trace_s": time.time() - t0, "traces": traces}
        record["status"] = "ok"
        if verbose:
            mem = record["memory"]
            print(f"[dryrun] OK {arch} x {shape_name} mesh={record['mesh']} "
                  f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
                  f"flops={costs.flops:.3e} "
                  f"coll={costs.total_collective_bytes:.3e}B "
                  f"({traces} traces, {record['timing']['trace_s']:.1f}s)")
    except Exception as e:  # a failure here is a fault of the port
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] FAIL {arch} x {shape_name}: {record['error']}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return record


def _kv(items: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-res", action="store_true",
                    help="shard the residual stream's seq dim over 'model'")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides k=v (e.g. remat=False)")
    ap.add_argument("--opt-override", action="append", default=[],
                    help="optimizer overrides k=v (e.g. state_dtype=bfloat16)")
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda: the card's "
                         "program; no card is needed)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [canonical(a) for a in
                                                 args.arch.split(",")]
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = _kv(args.override)
    opt_overrides = _kv(args.opt_override)

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp,
                               microbatches=args.microbatches,
                               seq_res=args.seq_res,
                               overrides=overrides or None,
                               opt_overrides=opt_overrides or None,
                               grad_accum_dtype=args.grad_accum_dtype,
                               device=args.device)
                mesh_tag = "multi" if mp else "single"
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_tag}__{args.tag}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "failed":
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
