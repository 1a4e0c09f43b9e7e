"""The DTensor counterparts of the port's layout-sensitive steps: what the
models run instead where a tensor is a DTensor (the dry run,
``launch/dryrun.py``), each computing on one device what the plain step
computes.

- ``redistribute``: the layout pins (``ShardingRules.constrain``), whose
  gradient settles partial sums;
- ``gather_data_axes``: FSDP's gather of a weight over the data axes;
- ``heads_ready`` and ``repeat_kv``: a head dim a mesh dim cannot split;
- ``vocab_parallel_cross_entropy``: the loss over vocab-sharded logits;
- ``cache_update_local``: a decode step's write into a position-sharded
  cache;
- ``run_local``: a kernel's backward rule, or the SSD scan, on each
  device's shard.

This module imports ``torch.distributed.tensor`` when it is imported: the
models import it only on a DTensor.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.specs import axis_names, current_rules


def redistribute(x, pl):
    """``x.redistribute(pl)`` whose gradient goes back to ``x``'s layout
    with a pending sum settled as replicated: the gradient of an
    all-reduced activation is the same on every device (DTensor's own rule
    leaves it partial, and the next product then gathers a weight rather
    than reduce it). A partial gradient arriving at a pinned layout is
    settled there too."""
    back = tuple(Replicate() if p.is_partial() else p for p in x.placements)

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.redistribute(t.device_mesh, pl)

        @staticmethod
        def backward(ctx, g):
            return g.redistribute(g.device_mesh, back)

    return _Fn.apply(x)


def gather_data_axes(w):
    """``w`` (a DTensor) replicated over the data axes ("pod", "data"):
    FSDP's gather of a weight sharded on its "embed" dims (identity
    without active rules)."""
    if current_rules() is None:
        return w
    names = axis_names(w.device_mesh)
    pl = tuple(Replicate() if names[i] in ("pod", "data") and p.is_shard()
               else p for i, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def cache_update_local(cache, new, pos: int) -> None:
    """``cache[:, pos] = new[:, 0]`` on a DTensor cache (B, T, G, dh) whose
    positions may be sharded: each device writes its own shard at
    ``pos mod T_local``, the write the shard holding ``pos`` makes (the
    dry run charges every device the owner's costs)."""
    pl = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else
               Replicate() if p.is_shard(1) else p for p in cache.placements)
    row = new[:, 0].to(cache.dtype).redistribute(cache.device_mesh, pl)
    local = cache.to_local()
    local[:, pos % local.shape[1]] = row.to_local()


class _AllReduceSum:
    """Sum over mesh dims whose result every device uses alike: forward
    an all-reduce, backward the identity (each device's share of a
    replicated result gets the same gradient)."""

    @staticmethod
    def apply(x, mesh, dims):
        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                for d in dims:
                    t = funcol.all_reduce(t, "sum", (mesh, d))
                return funcol.wait_tensor(t) if dims else t.clone()

            @staticmethod
            def backward(ctx, g):
                return g

        return _Fn.apply(x)


def vocab_parallel_cross_entropy(logits, labels, mask=None):
    """Mean token CE of a DTensor ``logits`` (..., V) whose vocab dim may be
    sharded, without gathering it: each device takes its rows' max, sum of
    exponentials and label logit over its vocab shard, three all-reduces
    over the vocab mesh dims combine them (Megatron's vocab-parallel CE), and
    one over the row mesh dims takes the mean. On one device it computes
    what ``models.common.softmax_cross_entropy`` computes."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    vdims = [i for i, p in enumerate(pl) if p.is_shard(last)]
    rdims = [i for i, p in enumerate(pl) if p.is_shard() and i not in vdims]
    labels = labels.redistribute(mesh, tuple(
        Replicate() if i in vdims else p for i, p in enumerate(pl)))
    lf = logits.to_local().float()
    v_loc = lf.shape[-1]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    offset = 0
    for d in vdims:
        offset = offset * mesh.size(d) + coord[d]
    offset *= v_loc

    m = lf.detach().amax(-1)
    for d in vdims:
        m = funcol.all_reduce(m, "max", (mesh, d))
    m = funcol.wait_tensor(m) if vdims else m
    se = _AllReduceSum.apply(torch.exp(lf - m[..., None]).sum(-1), mesh, vdims)
    lse = torch.log(se) + m
    idx = labels.to_local().long() - offset
    inside = (idx >= 0) & (idx < v_loc)
    pick = torch.gather(lf, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
    label_logit = _AllReduceSum.apply(pick * inside, mesh, vdims)
    nll = lse - label_logit
    if mask is not None:
        mk = mask.redistribute(mesh, labels.placements).to_local().float()
        total = _AllReduceSum.apply(torch.sum(nll * mk), mesh, rdims)
        count = _AllReduceSum.apply(torch.sum(mk), mesh, rdims).detach()
        loss = total / torch.clamp_min(count, 1.0)
    else:
        loss = _AllReduceSum.apply(torch.sum(nll), mesh, rdims) / labels.numel()
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def run_local(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` over the local shards of ``args`` (DTensors), each first
    redistributed to its ``in_placements`` entry (``None``: not a tensor);
    its outputs wrapped as DTensors with ``out_placements``. The backward
    rules of the kernel operators run so: they are local to a batch or
    head shard, as the forward's sharding strategy is. Where ``fn`` is
    differentiated through, ``grad_placements`` says how each argument's
    local gradient lies (``Partial`` where a replicated argument meets
    sharded work); by default as the argument itself."""
    mesh = next(a for a in args if hasattr(a, "placements")).device_mesh
    grad_placements = grad_placements or in_placements
    local = [a.redistribute(mesh, p).to_local(grad_placements=g)
             if p is not None else a
             for a, p, g in zip(args, in_placements, grad_placements)]
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, p, run_check=False)
                 for o, p in zip(outs, out_placements))


def heads_ready(y, n: int):
    """``y`` (..., n·dh) ready to be viewed as (..., n, dh): replicated
    over each mesh dim that shards its last dim and does not divide n
    (DTensor's product rule shards the output of a replicated weight; a
    device cannot keep a fraction of a head); its gradient the same way."""
    return _HeadsReady.apply(y, n)


def _heads_ready(y: torch.Tensor, n: int) -> torch.Tensor:
    last = y.ndim - 1
    mesh = y.device_mesh
    pl = tuple(Replicate() if p.is_shard(last) and n % mesh.size(i) else p
               for i, p in enumerate(y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(mesh, pl)


class _HeadsReady(torch.autograd.Function):
    """``_heads_ready`` forward, and of the gradient backward."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        return _heads_ready(y, n)

    @staticmethod
    def backward(ctx, g):
        return _heads_ready(g, ctx.n), None


def repeat_kv_for(q, k, v):
    """(k, v) for attention with ``q`` (B, S, H, dh): repeated to H heads
    where a mesh dim shards q's heads and does not divide the KV heads, as
    the reference's dense attention repeats them, so a query shard finds
    its KV heads on its own device; else as they are."""
    if _heads_shard_together(q, k):
        return k, v
    return _RepeatKV.apply(k, q.shape[2]), _RepeatKV.apply(v, q.shape[2])


class _RepeatKV(torch.autograd.Function):
    """The KV heads repeated to the query heads (``models.common.repeat_kv``)
    on a DTensor whose heads are not sharded; its gradient is gathered back
    to that layout before the query groups are summed (a shard of the
    repeated heads cannot be viewed as whole groups)."""

    @staticmethod
    def forward(ctx, x, n_heads):
        ctx.placements, ctx.rep = x.placements, n_heads // x.shape[2]
        return x.repeat_interleave(ctx.rep, dim=2)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.placements)
        B, T, H, dh = g.shape
        return g.view(B, T, H // ctx.rep, ctx.rep, dh).sum(3), None


def _heads_shard_together(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True unless a mesh dim shards q's heads and does not divide the KV
    heads (DTensors q (B, S, H, dh), k (B, T, G, dh))."""
    mesh = q.device_mesh
    return all(not p.is_shard(2) or k.shape[2] % mesh.size(i) == 0
               for i, p in enumerate(q.placements))
