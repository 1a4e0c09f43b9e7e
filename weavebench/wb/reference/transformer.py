"""Plain PyTorch reference of the decoder-only transformer family (dense
SwiGLU or capacity-routed MoE FFN, GQA attention with RoPE, RMSNorm, an
optional prefix of precomputed frame embeddings) and its loss; AdamW and
the training loop are ``common``'s.

A frozen copy written for the benchmark: it imports nothing of the program
under test. It follows the published layer equations at the configuration's
stated numerics: fp32 master weights, bf16 operands for every product with
fp32 accumulation, fp32 RMSNorm, softmax, router and cross-entropy. Where
the program has its own conventions the reference keeps them as the
configuration file states them (half-split RoPE, the MoE capacity
``ceil(T * top_k / E * capacity_factor)`` rounded up to 4, choice-major
slots, a load-balance loss of ``E * sum(frac * mean_prob) * aux_coef``).

``numerics`` is ``common``'s (the configuration's by default, ``"fp8"``
the control), and for the fp32 router the control takes bf16 operands.
``rows`` keeps the first ``rows`` rows of each batch (a fault: half the
batch left out). The module gives what the harness and the tests ask of a
family: ``layout``, ``train_readings``, ``step_model_flops``, the tests'
sizes ``tiny`` and ``small``, and, for MoE, ``Routes``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from wb.flops import causal_attention_flops
from wb.reference import common
from wb.reference.common import act, mm, operand

NEG = -1e30


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


def train_readings(m: dict, opt: dict, make_leaf, batches, frontend=None,
                   numerics: Optional[str] = None, rows: Optional[int] = None,
                   routes: Optional[Routes] = None) -> dict:
    """``common.train_readings`` of this family: each step's loss, each
    leaf's first clipped gradient norm and each leaf's change. An MoE model
    routes as ``routes`` says (its own choices are recorded there)."""
    return common.train_readings(layout, loss_fn, m, opt, make_leaf, batches, frontend,
                                 numerics, rows, routes)


# ---------------------------------------------------------------------------
# the work a step is credited with
# ---------------------------------------------------------------------------

def matmul_params(m: dict) -> int:
    """Weights a position multiplies by, in one forward."""
    D, H, G, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = D * H * dh + 2 * D * G * dh + H * dh * D
    if m.get("moe_num_experts"):
        ffn = m["moe_top_k"] * 3 * D * m["moe_d_ff"] + D * m["moe_num_experts"]
    else:
        ffn = 3 * D * m["d_ff"]
    return m["num_layers"] * (attn + ffn) + D * m["vocab_size"]


def step_model_flops(m: dict, global_batch: int, seq_len: int, prefix: int = 0) -> int:
    """Model FLOPs of one training step over (global_batch, prefix + seq_len)
    positions: 6 x the matmul parameters a position uses x the positions,
    plus the causal attention products (forward and backward = 3 x
    forward). The token embedding is a lookup and counts nothing; an MoE
    layer counts its router and its top-k experts; recomputation (remat,
    the backward rules' recompute) is not counted."""
    S = prefix + seq_len
    dense = 6 * matmul_params(m) * global_batch * S
    attn = 3 * m["num_layers"] * causal_attention_flops(global_batch, m["num_heads"], S,
                                                         m["head_dim"])
    return dense + attn


# ---------------------------------------------------------------------------
# the CPU tests' sizes
# ---------------------------------------------------------------------------

# float32 on both sides: at these widths bf16 rounding alone would read
# above limits set for the cells' widths; the faults read far above them
TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "d_ff": 160, "vocab_size": 257, "compute_dtype": "float32"}
TINY_MOE = dict(TINY, moe_num_experts=8, moe_top_k=2, moe_d_ff=32)
SMALL = {"num_layers": 2, "d_model": 128, "num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
         "d_ff": 256, "vocab_size": 512}
SMALL_MOE = dict(SMALL, moe_num_experts=8, moe_top_k=2, moe_d_ff=32)


def tiny(m: dict) -> dict:
    """The model overrides of a whole run in the CPU faults tests."""
    return TINY_MOE if m.get("moe_num_experts") else TINY


def small(m: dict) -> dict:
    """The model overrides of the controls read in the CPU tests."""
    return SMALL_MOE if m.get("moe_num_experts") else SMALL
