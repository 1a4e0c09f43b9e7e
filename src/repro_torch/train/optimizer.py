"""AdamW + schedule + global-norm clipping (port of ``repro.train.optimizer``).

Hand-written, no ``torch.optim``: the update is the JAX one, op for op, in
fp32, in place under ``torch.no_grad()``. The optimizer state ``{"m", "v",
"step"}`` mirrors the parameter tree.

Two paths, chosen by what ``adamw_update`` is given. Real CUDA tensors take
K5 (``kernels/adamw``, ``csrc/adamw.cu``): one multi-tensor pass for the
gradients' norm and one for the update, 32 B of HBM traffic a parameter,
bit-identical to the plain loop given the same clip scale; what it does not
take raises, DTensors with shards on the card too. CPU tensors and fake
tensors (the dry run's), and DTensors over either, take the plain loop
``adamw_plain``, leaf by leaf and over each leaf's flat elements in pieces
of ``PIECE``, so a stacked leaf's fp32 temporaries stay a piece in size
(rwkv6-3b's ``cm_k`` is 2.9 GB).

Decay follows the reference's rule: every stored leaf with ``ndim >= 2``,
which includes the per-layer norm scales, ``u``, ``w0`` and the token-shift
mixes, all stacked as (L, ...); only 1-d leaves such as ``final_norm`` escape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.adamw.ops import adamw_fused
from repro_torch.kernels.common import on_cpu, require
from repro_torch.models.common import tree_leaves, tree_map

#: elements of a leaf updated at once (fp32 temporaries of 64 MB each)
PIECE = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"   # cosine | constant
    # Adam moment storage dtype: float32 (the default) or bfloat16, which
    # halves the state's memory; the moments are computed in fp32 either way.
    state_dtype: str = "float32"


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or int tensor) as an fp32 0-d
    tensor: linear warmup, then cosine to ``min_lr_frac`` or constant."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp((s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.learning_rate * warm
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.learning_rate * warm * frac


def init_opt_state(params, state_dtype: str = "float32") -> Dict[str, Any]:
    """Zero moments of ``state_dtype`` (a torch dtype's name) beside each
    parameter, and step 0 as an int32 0-d tensor on the parameters'
    device."""
    dt = getattr(torch, state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _pieces(t: torch.Tensor):
    if hasattr(t, "placements"):
        # a DTensor (the dry run): elementwise over the whole leaf keeps its
        # layout; a flat view of a sharded leaf would gather it
        return (t,)
    if not t.is_contiguous():
        raise ValueError("the optimizer updates contiguous tensors in place")
    return t.view(-1).split(PIECE)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for leaf in tree_leaves(tree)
                          for c in _pieces(leaf)))


def clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor):
    """min(clip / max(gnorm, 1e-9), 1), or 1.0 where clipping is off."""
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if cfg.clip_norm > 0 else 1.0


def decays(cfg: OptimizerConfig, p: torch.Tensor) -> bool:
    """Whether leaf ``p`` takes weight decay (the reference's rule)."""
    return cfg.weight_decay > 0 and p.dim() >= 2  # the stored leaf's ndim


def adamw_plain(cfg: OptimizerConfig, leaves, scale, lr, bc1, bc2) -> None:
    """The plain update of each (p, g, m, v) of ``leaves`` in place, with
    the clip ``scale`` given (a 0-d tensor or 1.0)."""
    b1, b2 = cfg.b1, cfg.b2
    for p, g, m, v in leaves:
        decay = decays(cfg, p)
        for pc, gc, mc, vc in zip(*map(_pieces, (p, g, m, v))):
            gf = gc.float() * scale
            # .float() of an fp32 tensor is the tensor itself: fp32 moments
            # and parameters are updated in place, others through a copy
            mf = mc.float().mul_(b1).add_(gf * (1 - b1))
            vf = vc.float().mul_(b2).add_(torch.square(gf).mul_(1 - b2))
            delta = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(cfg.eps))
            if decay:
                delta.add_(pc.float() * cfg.weight_decay)
            pf = pc.float().sub_(delta.mul_(lr))
            for dst, src in ((mc, mf), (vc, vf), (pc, pf)):
                if src is not dst:
                    dst.copy_(src)


def takes_kernel(tensors) -> bool:
    """True if K5 updates these: real tensors on one CUDA device. CPU
    tensors and fake tensors (the dry run's), and DTensors whose shards are
    either, take the plain loop; a DTensor with real shards on the card and
    a mix of devices raise."""
    from torch._subclasses.fake_tensor import FakeTensor
    shards = [t.to_local() if hasattr(t, "placements") else t for t in tensors]
    if any(isinstance(t, FakeTensor) for t in shards) \
            or all(t.device.type != "cuda" for t in shards):
        return False
    require(not any(hasattr(t, "placements") for t in tensors),
            "the adamw kernel does not take DTensors with shards on the card: "
            "their grads' norm needs the sum of squares of every shard")
    return not on_cpu(*tensors)


def optimizer_counts(params, launched: int, tabled: int) -> Dict[str, int]:
    """The ``train.optimizer`` span's args, host-known integers: parameter
    elements updated, those in K5's update tables (``tabled``) and K5's
    launches."""
    return {"elems": sum(p.numel() for p in tree_leaves(params)),
            "kernel_elems": tabled, "launches": launched}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, opt_state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping. Updates ``params`` and the
    moments in place and returns (params, new opt_state, {"grad_norm",
    "lr"}), as the JAX version returns its new trees. No host sync."""
    step = opt_state["step"]
    lr = lr_at(cfg, step)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    leaves = list(zip(*(tree_leaves(x) for x in
                        (params, grads, opt_state["m"], opt_state["v"]))))
    if takes_kernel([x for leaf in leaves for x in leaf]):
        gnorm, _scale = adamw_fused(
            *zip(*leaves), [decays(cfg, p) for p, *_ in leaves],
            lr, bc1, bc2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
        adamw_plain(cfg, leaves, clip_scale(cfg, gnorm), lr, bc1, bc2)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
