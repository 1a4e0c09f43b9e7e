"""Plain PyTorch reference of the decoder-only transformer family (dense
SwiGLU or capacity-routed MoE FFN, GQA attention with RoPE, RMSNorm, an
optional prefix of precomputed frame embeddings), its loss and AdamW.

A frozen copy written for the benchmark: it imports nothing of the program
under test. It follows the published layer equations at the configuration's
stated numerics: fp32 master weights, bf16 operands for every product with
fp32 accumulation, fp32 RMSNorm, softmax, router and cross-entropy. Where
the program has its own conventions the reference keeps them as the
configuration file states them (half-split RoPE, the MoE capacity
``ceil(T * top_k / E * capacity_factor)`` rounded up to 4, choice-major
slots, a load-balance loss of ``E * sum(frac * mean_prob) * aux_coef``).

``numerics`` picks the precision of the products' operands and of the
activations between them: by default the configuration's ``compute_dtype``
(``"bf16"``, or ``"fp32"`` for a float32 configuration), and ``"fp8"``
is the control, every product one precision step below the
configuration's: e4m3 operands with one scale a tensor for the bf16
products (bf16 activations), bf16 operands for the fp32 router. ``rows`` keeps the first ``rows`` rows of each batch
(a fault: half the batch left out).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def layout(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """The parameter leaves as (path, shape, init, std), in the sorted-key
    order of the nested tree: ``init`` is ``normal`` (std from the fan-in of
    the product), ``embed`` (std 0.02) or ``ones``."""
    L, D, H, G = m["num_layers"], m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh, V = m["head_dim"], m["vocab_size"]
    layer = {
        "attn_norm": ((L, D), "ones", 0.0),
        "mlp_norm": ((L, D), "ones", 0.0),
        "wq": ((L, D, H, dh), "normal", D ** -0.5),
        "wk": ((L, D, G, dh), "normal", D ** -0.5),
        "wv": ((L, D, G, dh), "normal", D ** -0.5),
        "wo": ((L, H, dh, D), "normal", (H * dh) ** -0.5),
    }
    if m.get("moe_num_experts"):
        E, Fe = m["moe_num_experts"], m["moe_d_ff"]
        layer.update({
            "router": ((L, D, E), "normal", D ** -0.5),
            "w_gate": ((L, E, D, Fe), "normal", D ** -0.5),
            "w_up": ((L, E, D, Fe), "normal", D ** -0.5),
            "w_down": ((L, E, Fe, D), "normal", Fe ** -0.5),
        })
    else:
        Ff = m["d_ff"]
        layer.update({
            "w_gate": ((L, D, Ff), "normal", D ** -0.5),
            "w_up": ((L, D, Ff), "normal", D ** -0.5),
            "w_down": ((L, Ff, D), "normal", Ff ** -0.5),
        })
    top = {"embed": ((V, D), "embed", 0.02), "final_norm": ((D,), "ones", 0.0),
           "unembed": ((D, V), "normal", D ** -0.5)}
    out = []
    for k in sorted(top.keys() | {"layers"}):
        if k == "layers":
            out += [(f"layers.{n}",) + layer[n] for n in sorted(layer)]
        else:
            out.append((k,) + top[k])
    return out


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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, n, dh): the two halves of each head rotated by position."""
    S, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def attention(q, k, v, numerics: str) -> torch.Tensor:
    """Causal GQA: q (B, S, H, dh), k/v (B, S, G, dh) -> (B, S, H, dh); the
    scores, softmax and the weighted sum in fp32 of the rounded operands."""
    B, S, H, dh = q.shape
    G = k.shape[2]
    qf = operand(q, numerics).float().view(B, S, G, H // G, dh)
    kf, vf = operand(k, numerics).float(), operand(v, numerics).float()
    s = torch.einsum("bsgrd,btgd->bgrst", qf, kf) / math.sqrt(dh)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, NEG), dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", p, vf)
    return o.reshape(B, S, H, dh).to(act(numerics))


def swiglu_ffn(x, wg, wu, wd, numerics: str) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, numerics)) * mm(x, wu, numerics), wd, numerics)


def capacity(m: dict, T: int) -> int:
    E, K = m["moe_num_experts"], m["moe_top_k"]
    cap = math.ceil(T * K / E * m["moe_capacity_factor"])
    return max(4, -(-cap // 4) * 4)


class Routes:
    """An MoE model's routing choices, (T, K) expert ids by (step, layer).

    Routing is discontinuous: a choice near a tie can flip under rounding
    alone, and one flip moves the router's gradient and, through the
    capacity, other tokens' slots. So the reference can follow ``given``
    choices (those another run made: the program's, or a control's) with its
    own probabilities, gates and slots, and checks the stage it skips by
    itself: each token whose given choices are not the reference's own must
    be a near tie. ``margin`` is the largest such departure, the reference's
    probability of its own best left-out choice over the given worst one,
    less 1 (0 where all agree). The reference's own choices are recorded."""

    def __init__(self, given=None):
        self.given, self.own, self.step = given, {}, 0
        self.flips, self.margin = 0, 0.0

    def choose(self, layer: int, probs: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        key = (self.step, layer)
        first = key not in self.own
        if first:
            self.own[key] = own.detach().cpu()
        given = None if self.given is None else self.given.get(key)
        if given is None:
            return own
        if tuple(given.shape) != tuple(own.shape):
            self.margin = math.inf
            return own
        given = given.to(own.device)
        if first:
            with torch.no_grad():
                self._compare(probs.detach(), given, own)
        return given

    def _compare(self, probs, given, own) -> None:
        differ = (given.sort(-1)[0] != own.sort(-1)[0]).any(-1)
        if differ.any():
            pr = probs[differ]
            g_min = pr.gather(1, given[differ]).min(-1)[0]
            left_out = pr.scatter(1, given[differ], 0.0).max(-1)[0]
            self.flips += int(differ.sum())
            self.margin = max(self.margin, float((left_out / g_min - 1).max()))


def moe(m: dict, p: Dict[str, torch.Tensor], x: torch.Tensor, numerics: str,
        routes: Optional[Routes] = None, layer: int = 0):
    """x (B, S, D) -> (y, load-balance loss). Each token's top-k
    experts by fp32 router probability (ties to the lower index), gates
    renormalised over the k; choices fill each expert's ``capacity`` slots
    in choice-major order (every token's first choice, then every second
    choice, ...) and the rest are dropped."""
    B, S, D = x.shape
    T, E, K = B * S, m["moe_num_experts"], m["moe_top_k"]
    xt = x.reshape(T, D)
    if numerics == "fp8":     # the control: the fp32 router one step down too
        logits = (xt.to(torch.bfloat16) @ p["router"].to(torch.bfloat16)).float()
    else:
        logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]
    if routes is not None:
        idx = routes.choose(layer, probs, idx)
    top = probs.gather(1, idx)
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.t().reshape(-1)            # choice-major: j = k * T + t
    flat_g = gates.t().reshape(-1)
    order = torch.sort(flat_e, stable=True)[1]
    counts = torch.bincount(flat_e, minlength=E)
    cap = capacity(m, T)
    y = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        j = order[start:start + min(n, cap)]
        start += n
        if j.numel() == 0:
            continue
        tok = j % T
        out = swiglu_ffn(xt[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], numerics)
        y = y.index_add(0, tok, out.float() * flat_g[j].to(x.dtype).float()[:, None])
    aux = E * torch.sum(counts.float() / T * probs.mean(0)) * m["moe_aux_coef"]
    return y.to(x.dtype).view(B, S, D), aux


def layer_fn(m: dict, numerics: str, routes, layer: int, h: torch.Tensor, *leaves):
    p = dict(zip(_LAYER_KEYS[m.get("moe_num_experts", 0) > 0], leaves))
    B, S, D = h.shape
    H, G, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    x = rms_norm(h, p["attn_norm"], m["norm_eps"])
    q = rope(mm(x, p["wq"].reshape(D, H * dh), numerics).view(B, S, H, dh), m["rope_theta"])
    k = rope(mm(x, p["wk"].reshape(D, G * dh), numerics).view(B, S, G, dh), m["rope_theta"])
    v = mm(x, p["wv"].reshape(D, G * dh), numerics).view(B, S, G, dh)
    o = attention(q, k, v, numerics)
    h = h + mm(o.reshape(B, S, H * dh), p["wo"].reshape(H * dh, D), numerics)
    x = rms_norm(h, p["mlp_norm"], m["norm_eps"])
    if m.get("moe_num_experts"):
        y, aux = moe(m, p, x, numerics, routes, layer)
    else:
        y, aux = swiglu_ffn(x, p["w_gate"], p["w_up"], p["w_down"], numerics), \
            torch.zeros((), device=h.device)
    return h + y, aux


_LAYER_KEYS = {
    False: ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
    True: ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
           "router"),
}


def loss_fn(m: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            frontend: Optional[torch.Tensor], numerics: str,
            routes: Optional[Routes] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the token positions (the prefix
    excluded) plus the layers' load-balance losses. Each layer is
    recomputed in the backward (activation checkpointing), so the
    reference fits beside its own optimizer state."""
    h = F.embedding(tokens.long(), params["embed"]).to(act(numerics))
    P = 0
    if frontend is not None:
        P = frontend.shape[1]
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
    keys = _LAYER_KEYS[m.get("moe_num_experts", 0) > 0]
    aux = torch.zeros((), device=h.device)
    for i in range(m["num_layers"]):
        leaves = [params[f"layers.{k}"][i] for k in keys]
        h, a = checkpoint(layer_fn, m, numerics, routes, i, h, *leaves, use_reentrant=False)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], m["norm_eps"])
    logits = mm(h[:, P:-1], params["unembed"], numerics).float()
    labels = tokens[:, 1:].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    return nll.mean() + aux


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


def train_readings(m: dict, opt: dict, make_leaf, batches, frontend=None,
                   numerics: Optional[str] = None, rows: Optional[int] = None,
                   routes: Optional[Routes] = None) -> dict:
    """Train from the seeded weights on ``batches`` (one (GB, S) int tensor a
    step) and read what the benchmark compares: each step's loss, each
    leaf's norm of the first step's clipped gradient, and each leaf's norm
    of the change of its weights over the steps. ``make_leaf(i)`` returns
    leaf i of ``layout(m)``, fp32, freshly drawn from the seed. An MoE
    model routes as ``routes`` says (its own choices are recorded there)."""
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
