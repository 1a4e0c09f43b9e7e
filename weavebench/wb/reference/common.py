"""What every family's plain reference shares: the numerics of its products,
AdamW with global-norm clipping, and the training loop that reads what the
benchmark compares.

A family's module (``wb/reference/<reference>.py``) writes its parameter
``layout`` and its ``loss_fn(m, params, tokens, frontend, numerics,
routes)``, and hands both to ``train_readings`` here. Like the families'
modules, this one imports nothing of the program under test.

``numerics`` picks the precision of the products' operands and of the
activations between them: by default the configuration's ``compute_dtype``
(``"bf16"``, or ``"fp32"`` for a float32 configuration), and ``"fp8"`` is
the control, every product one precision step below the configuration's:
e4m3 operands with one scale a tensor for the bf16 products (bf16
activations).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8_e4m3fn with one scale for the tensor, back
    in bf16; the gradient passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    xb = x.to(torch.bfloat16)
    return xb + (q.to(torch.bfloat16) - xb).detach()


def stated(m: dict) -> str:
    """The numerics the configuration states."""
    return {"bfloat16": "bf16", "float32": "fp32"}[m.get("compute_dtype", "bfloat16")]


def act(numerics: str) -> torch.dtype:
    """The activations' dtype under ``numerics``."""
    return torch.float32 if numerics == "fp32" else torch.bfloat16


def operand(x: torch.Tensor, numerics: str) -> torch.Tensor:
    if numerics == "fp32":
        return x.float()
    if numerics == "bf16":
        return x.to(torch.bfloat16)
    if numerics == "fp8":
        return _fp8(x)
    raise ValueError(f"numerics {numerics!r}")


def mm(a: torch.Tensor, b: torch.Tensor, numerics: str) -> torch.Tensor:
    return operand(a, numerics) @ operand(b, numerics)


# ---------------------------------------------------------------------------
# AdamW with global-norm clipping, warmup and cosine decay
# ---------------------------------------------------------------------------

PIECE = 1 << 24


def lr_at(opt: dict, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    if opt.get("schedule", "cosine") == "constant":
        return opt["learning_rate"] * warm
    t = min(1.0, max(0.0, (step - opt["warmup_steps"])
                     / max(1, opt["total_steps"] - opt["warmup_steps"])))
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["learning_rate"] * warm * frac


@torch.no_grad()
def adamw(opt: dict, step: int, params, grads, mom, vel, scale) -> None:
    """One AdamW step in place (fp32), leaf by leaf in pieces; leaves of two
    or more dimensions decay."""
    b1, b2 = opt["b1"], opt["b2"]
    lr, bc1, bc2 = lr_at(opt, step), 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for path, p in params.items():
        decay = opt["weight_decay"] if p.dim() >= 2 else 0.0
        for pc, gc, mc, vc in zip(*(t.view(-1).split(PIECE) for t in
                                    (p, grads[path], mom[path], vel[path]))):
            g = gc * scale
            mc.mul_(b1).add_(g, alpha=1 - b1)
            vc.mul_(b2).addcmul_(g, g, value=1 - b2)
            d = (mc / bc1).div_((vc / bc2).sqrt_().add_(opt["eps"]))
            if decay:
                d.add_(pc, alpha=decay)
            pc.sub_(d, alpha=lr)


def train_readings(layout, loss_fn, m: dict, opt: dict, make_leaf, batches, frontend=None,
                   numerics: Optional[str] = None, rows: Optional[int] = None,
                   routes=None) -> dict:
    """Train a family's model (its ``layout`` and ``loss_fn``) from the
    seeded weights on ``batches`` (one (GB, S) int tensor a step) and read
    what the benchmark compares: each step's loss, each leaf's norm of the
    first step's clipped gradient, and each leaf's norm of the change of its
    weights over the steps. ``make_leaf(i)`` returns leaf i of ``layout(m)``,
    fp32, freshly drawn from the seed. ``routes`` goes to ``loss_fn``, which
    routes an MoE model as it says. ``rows`` keeps the first ``rows`` rows
    of each batch (a fault: half the batch left out)."""
    numerics = numerics or stated(m)
    lay = layout(m)
    params = {path: make_leaf(i) for i, (path, *_r) in enumerate(lay)}
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    vel = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad1 = [], {}
    for step, tokens in enumerate(batches):
        fe = frontend
        if rows is not None:
            tokens = tokens[:rows]
            fe = None if fe is None else fe[:rows]
        live = {k: p.detach().requires_grad_() for k, p in params.items()}
        if routes is not None:
            routes.step = step
        loss = loss_fn(m, live, tokens, fe, numerics, routes)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        del live
        gnorm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())).item()
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        if step == 0:
            grad1 = {k: float(g.norm()) * scale for k, g in grads.items()}
        adamw(opt, step, params, grads, mom, vel, scale)
        del grads
        losses.append(float(loss.detach()))
    del mom, vel
    change = {}
    for i, (path, *_r) in enumerate(lay):
        p0 = make_leaf(i)
        change[path] = math.sqrt(sum(float((a - b).double().pow(2).sum()) for a, b in
                                     zip(params[path].view(-1).split(PIECE),
                                         p0.view(-1).split(PIECE))))
        del p0
    return {"losses": losses, "grad1": grad1, "change": change}
