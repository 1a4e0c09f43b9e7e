"""Per-device costs of a dispatched program for the roofline (port of
``repro.launch.hlo_analysis``): FLOPs, bytes, collectives; and the reader of
a profiled run on the card.

The reference parses the post-SPMD HLO of a compiled step. The port has no
compiler between its code and the card, so its counterpart reads the
program as it is dispatched: ``analyze(fn, *args)`` runs ``fn`` under a
dispatch mode (``CostMode``) that sees every ATen and kernel operator a
device runs. Over DTensors it lets DTensor turn each operator into the
local operator and the functional collectives it issues, and counts those,
so every number is **per device**, as the reference's:

  * FLOPs from ``torch.utils.flop_counter``'s formulas on the local shapes
    (matrix products, attention and the port's kernel operators, whose
    formulas ``kernels/*/ops.py`` register); ``dot_count`` counts the
    operators with a formula;
  * bytes: each dispatched operator's tensor operands plus its outputs. An
    eager program has no fusion, so that is its device-memory traffic; views
    cost nothing, so a slice is charged as the slice its consumer reads;
  * collective link-bytes per kind, with the reference's link-cost models
    and the group size the collective names:
        all-gather          out·(g-1)/g
        reduce-scatter      out·(g-1)
        all-reduce          2·out·(g-1)/g
        all-to-all          out·(g-1)/g
  * live bytes: the largest sum of the storages that the run allocated and
    that were still referenced, the dry run's memory analysis.

The reference multiplies a scanned layer's costs by the loop's trip count;
the port's layers are a Python loop, so the dry run traces a stack at two
depths and extrapolates linearly (``combine``).

``analyze_profile`` reads a ``torch.profiler`` trace of a real run instead:
launches and device ms per kernel name, and the device's busy share.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    # DTensor's Shard(i) -> Shard(j) on a CUDA mesh (a CPU mesh takes an
    # all-gather and a chunk instead)
    "shard_dim_alltoall": "all-to-all",
}
#: allocations without traffic, and the wait that completes a collective
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "detach", "lift_fresh",
             "_local_scalar_dense"}


@dataclass
class HLOCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    dot_count: int = 0
    #: (name, trip count) of each loop the costs were extrapolated over
    while_loops: List[Tuple[str, int]] = field(default_factory=list)
    #: the largest sum of live storages the run allocated
    peak_live_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def combine(base: HLOCosts, terms, loop: str = "layers",
            trips: int = 0) -> HLOCosts:
    """``base + sum k·(c - base)`` over ``terms`` [(c, k)], field by field:
    the costs of a loop traced at its base count and at one more body of
    each kind (``k`` more bodies of that kind at the full count)."""
    out = HLOCosts()
    for f in ("flops", "bytes_accessed", "peak_live_bytes"):
        setattr(out, f, getattr(base, f) + sum(
            k * (getattr(c, f) - getattr(base, f)) for c, k in terms))
    out.dot_count = int(round(base.dot_count + sum(
        k * (c.dot_count - base.dot_count) for c, k in terms)))
    for f in ("collective_bytes", "collective_count"):
        keys = set(getattr(base, f)).union(*(getattr(c, f) for c, _ in terms))
        for key in sorted(keys):
            b0 = getattr(base, f).get(key, 0)
            v = b0 + sum(k * (getattr(c, f).get(key, 0) - b0)
                         for c, k in terms)
            getattr(out, f)[key] = (float(v) if f == "collective_bytes"
                                    else int(round(v)))
    out.while_loops = base.while_loops + [(loop, trips)]
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(func, args) -> int:
    name = func._schema.name.split("::")[-1]
    if name.startswith(("all_gather", "reduce_scatter")):
        return int(args[2] if name.startswith("reduce_scatter") else args[1])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def link_bytes(kind: str, out_bytes: float, g: int) -> float:
    """The reference's link-cost model of one collective."""
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / max(1, g)
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    return out_bytes * (g - 1) / max(1, g)


class CostMode(TorchDispatchMode):
    """Counts the local operators a device runs (see the module doc).

    DTensor decides each new operator signature's sharding once, running
    it on global-shape fake tensors to learn its output's metadata and
    decompositions on a stand-in mesh (``ShardingPropagator``'s
    ``*propagate*`` methods); no device runs those calls, so the mode passes
    over everything dispatched inside them."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self._depth = 0
        self._patched: List[tuple] = []
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.costs = HLOCosts()
        self.live = 0
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self.known: set = set()

    def ignore(self, tensors) -> None:
        """Storages allocated before the run (the arguments): never
        counted as the run's allocations."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self.known.add(_storage_key(t))

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.known:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live += self._sizes[key]
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def __enter__(self):
        self._depth += 1
        if self._depth > 1:     # re-entered to decompose an operator
            return super().__enter__()
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
        except ImportError:          # a torch without distributed
            ShardingPropagator = None
        for name in dir(ShardingPropagator) if ShardingPropagator else ():
            if "propagate" in name and callable(
                    getattr(ShardingPropagator, name)):
                orig = getattr(ShardingPropagator, name)
                self._patched.append((ShardingPropagator, name, orig))
                setattr(ShardingPropagator, name, self._pausing(orig))
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            for owner, name, orig in self._patched:
                setattr(owner, name, orig)
            self._patched.clear()
        return super().__exit__(*exc)

    def _pausing(self, fn):
        def run(*args, **kwargs):
            self.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.paused -= 1
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented        # let DTensor issue the local ops
        if isinstance(func, torch._ops.OpOverload) and func.namespace == \
                "aten" and func._overloadpacket not in self.flop_registry:
            # a composite operator that reaches the mode (``matmul`` on some
            # builds) is counted as the operators it decomposes into, as
            # ``FlopCounterMode`` counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = func._schema.name.split("::")[-1]
        c = self.costs
        packet = func._overloadpacket
        if packet in self.flop_registry:
            n = self.flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += n
            c.dot_count += int(n > 0)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            ob = sum(_nbytes(t) for t in outs)
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + \
                link_bytes(kind, ob, _group_size(func, args))
            c.collective_count[kind] = c.collective_count.get(kind, 0) + 1
        if outs and name not in _NO_BYTES and not _is_view(func):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            c.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def analyze(fn: Callable, *args, **kwargs) -> HLOCosts:
    """Per-device costs of ``fn(*args, **kwargs)``, run under ``CostMode``."""
    with CostMode() as mode:
        mode.ignore(_locals(args, kwargs))
        fn(*args, **kwargs)
    return mode.costs


def _locals(*trees) -> List[torch.Tensor]:
    out = []
    for t in tree_flatten(trees)[0]:
        if isinstance(t, torch.Tensor):
            out.append(t.to_local() if hasattr(t, "placements") else t)
    return out


# ---------------------------------------------------------------------------
# A profiled run on the card
# ---------------------------------------------------------------------------

@dataclass
class ProfileCosts:
    #: kernel name -> (launches, device ms)
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ms: float = 0.0
    wall_ms: float = 0.0

    @property
    def busy(self) -> float:
        """Share of the traced window's wall clock the device was busy."""
        return self.device_ms / self.wall_ms if self.wall_ms > 0 else 0.0

    def launches(self, fragment: str) -> int:
        return sum(n for k, (n, _ms) in self.kernels.items() if fragment in k)


def analyze_profile(prof) -> ProfileCosts:
    """Launches and device ms per kernel name of a finished
    ``torch.profiler.profile`` over CUDA activity, and the device's busy
    share of the traced window (kernel time over the span from the first
    event's start to the last one's end; overlapping kernels count twice)."""
    out = ProfileCosts()
    t0, t1 = None, None
    for e in prof.events():
        start = e.time_range.start
        end = e.time_range.end
        t0 = start if t0 is None else min(t0, start)
        t1 = end if t1 is None else max(t1, end)
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        n, ms = out.kernels.get(e.name, (0, 0.0))
        out.kernels[e.name] = (n + 1, ms + (end - start) / 1e3)
        out.device_ms += (end - start) / 1e3
    if t0 is not None:
        out.wall_ms = (t1 - t0) / 1e3
    return out


__all__ = [
    "CostMode", "HLOCosts", "ProfileCosts", "analyze",
    "analyze_profile", "combine", "link_bytes"]
