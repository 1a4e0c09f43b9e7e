"""The DTensor counterparts of the port's layout-sensitive steps: what the
models run instead where a tensor is a DTensor (the dry run,
``launch/dryrun.py``), each computing on one device what the plain step
computes.

- ``redistribute``: the layout pins (``ShardingRules.constrain``), whose
  gradient settles partial sums;
- ``gather_data_axes``: FSDP's gather of a weight over the data axes;
- ``heads_ready`` and ``repeat_kv``: a head dim a mesh dim cannot split;
- ``whole_heads_product``: a K/V projection whose heads a mesh dim cannot
  split, computed whole on each device as the reference computes it;
- ``vocab_parallel_cross_entropy``: the loss over vocab-sharded logits;
- ``cache_update_local``: a decode step's write into a position-sharded
  cache;
- ``flash_decode``: K3 over a position-sharded cache, the shards combined
  by all-reduces (the reference's flash-decode);
- ``rms_norm_sharded_rows``: K2 on rows sharded across devices, their sum
  of squares all-reduced;
- ``run_local``: a kernel's backward rule, or the SSD scan, on each
  device's shard.

This module imports ``torch.distributed.tensor`` when it is imported: the
models import it only on a DTensor.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def position_start(cache) -> int:
    """This device's first position of a DTensor cache (B, T, G, dh) whose
    positions (dim 1) may be sharded: DTensor's shards are ``torch.chunk``'s,
    nested in mesh-dim order."""
    mesh = cache.device_mesh
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    start, size = 0, cache.shape[1]
    for d, p in enumerate(cache.placements):
        if p.is_shard(1):
            step = -(-size // mesh.size(d))
            start += min(coord[d] * step, size)
            size = max(0, min(step, size - coord[d] * step))
    return start


def cache_update_local(cache, new, pos: int) -> None:
    """``cache[:, pos] = new[:, 0]`` on a DTensor cache (B, T, G, dh) whose
    positions may be sharded: the device whose shard holds ``pos`` writes
    it there, the others write nothing. On fake tensors (the dry run, which
    charges every device the owner's costs) each device writes its own
    shard at ``pos mod T_local``."""
    from torch._subclasses.fake_tensor import FakeTensor
    pl = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else
               Replicate() if p.is_shard(1) else p for p in cache.placements)
    row = new[:, 0].to(cache.dtype).redistribute(cache.device_mesh, pl)
    local = cache.to_local()
    at = pos - position_start(cache)
    if isinstance(local, FakeTensor):
        at %= local.shape[1]
    if 0 <= at < local.shape[1]:
        local[:, at] = row.to_local()


def flash_decode(q, k_cache, v_cache, cur_index: int):
    """Single-token attention of ``q`` (B, H, dh) over DTensor caches (B, T,
    G, dh) whose positions are sharded: the reference's flash-decode
    (``repro.models.common.decode_attention``, whose softmax over sharded
    positions XLA lowers to all-reduces). The cache never moves: each device
    runs K3's partial form on its own positions, ``[0, n_valid)`` with
    ``n_valid = clamp(cur_index + 1 - start, 0, T_local)``, and three
    all-reduces over the position mesh dims combine the shards: the max of
    the log-sum-exps, the sum of ``w = exp(lse - max)`` and the sum of
    ``w·o``. q follows the cache's batch and head layout and is gathered
    over the position dims (a few MB, the reference's trade). Serving only,
    no gradient. Returns (B, H, dh) in q's dtype, replicated over the
    position dims."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_partial
    mesh = k_cache.device_mesh
    kpl = tuple(k_cache.placements)
    seq = [i for i, p in enumerate(kpl) if p.is_shard(1)]
    qpl = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
                else Replicate() for p in kpl)
    start = position_start(k_cache)

    def local(ql, kl, vl):
        n_valid = min(max(cur_index + 1 - start, 0), kl.shape[1])
        o, lse = decode_attention_partial(ql, kl, vl, n_valid)
        m = lse
        for d in seq:
            m = funcol.all_reduce(m, "max", (mesh, d))
        w = torch.exp(lse - funcol.wait_tensor(m))
        num, den = w[..., None] * o.float(), w
        for d in seq:
            num = funcol.all_reduce(num, "sum", (mesh, d))
            den = funcol.all_reduce(den, "sum", (mesh, d))
        num, den = funcol.wait_tensor(num), funcol.wait_tensor(den)
        return ((num / den[..., None]).to(ql.dtype),)

    return run_local(local, (q, k_cache, v_cache), (qpl, kpl, kpl),
                     (qpl,))[0]


def rms_norm_sharded_rows(x, scale, eps: float, fwd):
    """``fwd`` (K2's forward, ``kernels/rmsnorm/ops.rmsnorm_fwd``) on a
    DTensor ``x`` whose rows (last dim) are sharded: each device's sum of
    squares over its columns, all-reduced over those mesh dims ((B·S) fp32
    a device), gives each row's mean square, and K2 normalises the local
    columns with it. The reference's ``rms_norm`` reduces the same partial
    sums; nothing gathers the rows. ``scale`` follows the row's layout."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xpl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    dims = [i for i, p in enumerate(xpl) if p.is_shard(last)]
    spl = tuple(Shard(0) if i in dims else Replicate()
                for i in range(mesh.ndim))
    width = x.shape[-1]

    def local(xl, sl):
        ss = xl.float().pow(2).sum(-1)
        for d in dims:
            ss = funcol.all_reduce(ss, "sum", (mesh, d))
        return (fwd(xl, sl, eps, funcol.wait_tensor(ss) / width),)

    return run_local(local, (x, scale), (xpl, spl), (xpl,))[0]


def whole_heads_product(x, w, n: int):
    """``x @ w`` for a head projection ``w`` (D, n·dh) whose n heads a mesh
    dim that ``x`` does not shard cannot split (a GQA K/V projection, KV
    heads fewer than "model"): computed whole on every device of that dim,
    as the reference computes it (its "kv" axis maps to no mesh axis there),
    with no collective and the redundant FLOPs. ``x`` keeps its batch or
    sequence sharding; ``w``'s columns stay sharded only over a dim that
    divides n and shards nothing of ``x``. The gradients are partial where
    the other operand's shard splits the work."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xpl = tuple(Replicate() if p.is_partial() or p.is_shard(last) else p
                for p in x.placements)
    wpl = tuple(Shard(1) if p.is_shard(1) and n % mesh.size(i) == 0
                and not xpl[i].is_shard() else Replicate()
                for i, p in enumerate(w.placements))
    ypl = tuple(xp if xp.is_shard() else Shard(last) if wp.is_shard()
                else Replicate() for xp, wp in zip(xpl, wpl))
    grads = (tuple(Partial() if wp.is_shard() else xp
                   for xp, wp in zip(xpl, wpl)),
             tuple(Partial() if xp.is_shard() else wp
                   for xp, wp in zip(xpl, wpl)))
    return run_local(lambda a, b: (a @ b,), (x, w), (xpl, wpl), (ypl,),
                     grads)[0]


def splits_heads(x, n: int) -> bool:
    """True if a mesh dim that shards nothing of the DTensor ``x`` does not
    divide ``n`` heads (a product's output would be sharded there and
    gathered back into whole heads)."""
    mesh = x.device_mesh
    return any(n % mesh.size(i) and not p.is_shard()
               for i, p in enumerate(x.placements))


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
