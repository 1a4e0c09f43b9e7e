"""Logical-axis sharding rules over the production mesh (pod, data, model),
port of ``repro.sharding.specs`` onto ``DeviceMesh`` and DTensor placements.

Physical strategy (MaxText-style 2D/3D sharding), as the reference's:

  * batch                 -> ("pod", "data")          pure DP
  * weight "embed" dims   -> ("pod", "data")          FSDP (ZeRO-3)
  * "heads"/"kv"/"mlp"/"vocab"/"experts" -> "model"   TP / EP
  * "seq_sp"              -> "model"                  sequence-parallel q
                                                      (only when heads are not
                                                      TP-shardable: 40H, 24H)
  * "cache_seq"           -> "model"                  decode KV caches shard
                                                      the sequence dim

Every mapping entry degrades to ``None`` (replicated) when the dimension is
not divisible by the mesh axis size.

``spec`` gives the port's ``PartitionSpec``, a tuple whose entries are the
reference's (the trailing-``None`` trim, the divisibility degradation and
the dedup of a repeated axis included). ``sharding`` turns it into DTensor
placements over a ``DeviceMesh``: ``Shard(dim)`` on each mesh dim a tensor
dim maps to, ``Replicate()`` on the others; a dim mapped to ("pod", "data")
is sharded on both in mesh order, which is JAX's row-major layout. The
rules read only axis names and sizes, so a ``DeviceMesh``
(``mesh_dim_names``, ``shape``) and a stand-in with ``axis_names`` and a
``shape`` dict both work.

``constrain`` takes the place of ``with_sharding_constraint``: it
redistributes a DTensor to the rules' placements (``sharding.dtensor``; a
plain tensor is returned as it is). Without the reference's pins DTensor's
own propagation left partial sums pending and sharded the sequence dim,
whose merge with the batch dim in a reshape gave strided layouts its
product rule fails on.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

Physical = Optional[Tuple[str, ...]]

#: the active rules, one for the process: the reference keeps them in a
#: context variable, which the autograd engine's device threads (they run a
#: CUDA tensor's backward and its rematerialized forward) would not see
_active: List[Optional["ShardingRules"]] = [None]


def current_rules() -> Optional["ShardingRules"]:
    return _active[0]


class PartitionSpec(tuple):
    """One entry per tensor dim (trailing replicated dims trimmed): ``None``
    (replicated), a mesh axis name, or a tuple of names sharded in order."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``shape`` a tuple) or of a
    stand-in whose ``shape`` is already that dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


@dataclass
class ShardingRules:
    mesh: object
    mapping: Dict[str, Physical]
    constrain_activations: bool = True

    def axis_size(self, axes: Physical) -> int:
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in axes or ():
            n *= sizes[a]
        return n

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """PartitionSpec for the given logical axes; if ``shape`` is given,
        non-divisible dims degrade to replicated."""
        sizes = axis_sizes(self.mesh)
        entries = []
        used: set = set()
        for i, ax in enumerate(logical_axes):
            phys = self.mapping.get(ax) if ax is not None else None
            if phys:
                # an axis name may appear only once in a PartitionSpec
                phys = tuple(p for p in phys if p not in used)
            if not phys:
                entries.append(None)
                continue
            if shape is not None:
                n = 1
                for p in phys:
                    n *= sizes[p]
                if shape[i] % n != 0:
                    entries.append(None)
                    continue
            used.update(phys)
            entries.append(phys if len(phys) > 1 else phys[0])
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None):
        """DTensor placements over ``self.mesh``, one per mesh dim."""
        return placements(self.mesh, self.spec(logical_axes, shape))

    def constrain(self, x, logical_axes: Sequence[Optional[str]]):
        if not (self.constrain_activations and hasattr(x, "placements")):
            return x
        from repro_torch.sharding.dtensor import redistribute
        return redistribute(x, self.sharding(logical_axes, x.shape))


def placements(mesh, spec: PartitionSpec):
    """``Shard(dim)`` on each mesh dim that ``spec`` maps a tensor dim to,
    ``Replicate()`` elsewhere. A dim sharded over several mesh axes must
    name them in mesh order (JAX's row-major device order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} is sharded over {axes}, not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def make_rules(mesh, num_heads: int, num_kv_heads: int,
               seq_parallel: bool = True,
               fsdp: bool = True,
               experts_ep: bool = True) -> ShardingRules:
    """Build the logical->physical mapping for one architecture on one mesh."""
    dax = data_axes(mesh)
    model = ("model",) if "model" in axis_names(mesh) else None
    msize = axis_sizes(mesh)["model"] if model else 1
    heads_tp = model if (model and num_heads % msize == 0) else None
    kv_tp = model if (model and num_kv_heads % msize == 0) else None
    mapping: Dict[str, Physical] = {
        "batch": dax or None,
        "embed": dax if fsdp else None,
        "heads": heads_tp,
        "kv": kv_tp,
        "mlp": model,
        "vocab": model,
        "experts": model if experts_ep else None,
        "layers": None,
        "state": None,
        "cache_seq": model,
        # sequence-parallel q when heads cannot be TP-sharded; otherwise the
        # head dim carries TP and seq stays unsharded.
        "seq_sp": model if (seq_parallel and heads_tp is None) else None,
        # residual-stream sequence sharding (classic SP), off by default
        "seq_res": None,
    }
    return ShardingRules(mesh=mesh, mapping=mapping)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev, _active[0] = _active[0], rules
    try:
        yield rules
    finally:
        _active[0] = prev


def param_shardings(rules: ShardingRules, specs):
    """Placements tree for a ParamSpec tree."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda s: rules.sharding(s.logical_axes, s.shape), specs)
