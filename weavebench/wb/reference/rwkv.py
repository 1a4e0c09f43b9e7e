"""Plain PyTorch reference of the RWKV-6 "Finch" family (data-dependent
token shift, per-channel data-dependent decay, a matrix-valued WKV state a
head, squared-ReLU channel mix) and its loss; AdamW and the training loop
are ``common``'s.

A frozen copy written for the benchmark: it imports nothing of the program
under test. It follows the published block (Peng et al., arXiv:2404.05892;
RWKV-LM's ``RWKV_Tmix_x060`` / ``RWKV_CMix_x060``) at the configuration's
stated numerics: fp32 master weights, bf16 operands for every product with
fp32 accumulation, fp32 norms, decay and cross-entropy. r, k, v and the
decay w enter the WKV rounded to the operand precision; the WKV itself is
the published recurrence in fp32 from a zero state and a zero shift, with u
in fp32:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

``wkv_per_token`` writes it one token at a time; ``wkv``, which the loss
runs, is the same equations in blocks of 16 tokens (the CPU tests hold the
two together). Each layer is recomputed in the backward (activation
checkpointing). TF32 is off while the reference runs (and restored after),
so its fp32 products are fp32.

Departures from the published block, as the configuration file states them
(``assumed``), kept because the program has them:

* RMSNorm (no bias, no mean) in place of LayerNorm for ln1, ln2 and ln_out,
  and no ln0 on the embeddings;
* ``ln_x`` one RMSNorm over D in place of the per-head GroupNorm;
* the decay's exponent w0 + LoRA(x) clamped to [-8, 4];
* one LoRA rank, ``rwkv_lora_rank``, for the token-shift and decay LoRAs;
* the starting weights, drawn from the seed at RWKV-LM's x060 scales with
  every leaf live: ones for the norm scales; N(0, std^2) for the rest, std
  from the fan-in of each product (D^-1/2 or F^-1/2; 0.02 for the
  embedding), times ``SMALL_GAIN`` 0.1 for ``w_k`` and ``w_g`` (RWKV-LM's
  gain 0.1) and for ``w_o``, ``cm_v`` and ``cm_r`` (RWKV-LM's zeros);
  ``mix_w2`` and ``decay_w2`` at ``LORA_STD`` = 0.01 / sqrt(3), the std of
  RWKV-LM's uniform(-0.01, 0.01); the leaves that the program and RWKV-LM
  start at zero or at a fixed ramp drawn too, so that the shift mixing, the
  decay spread and the bonus carry weight: ``mix_w1`` and ``decay_w1`` at
  their fan-in std, ``mu_base``, ``mu_rkvgw``, ``cm_mu_k``, ``cm_mu_r`` at
  ``MU_STD`` 0.5, ``w0`` at ``W0_STD`` 1.0 (decays over about (0.07,
  0.9)), ``u`` at ``U_STD`` 0.5. Every product at its full fan-in std makes
  the 32-layer model chaotic: an fp32 rounding inside the WKV moves the
  reference's own bf16 loss as much as fp8 operands do.

``numerics`` is ``common``'s (the configuration's by default, ``"fp8"``
the control). ``rows`` keeps the first ``rows`` rows of each batch (a
fault: half the batch left out). The module gives what the harness and the
tests ask of a family: ``layout``, ``train_readings``,
``step_model_flops`` and the tests' sizes ``tiny`` and ``small``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from wb.reference import common
from wb.reference.common import act, mm, operand
from wb.reference.transformer import rms_norm

MU_STD, W0_STD, U_STD = 0.5, 1.0, 0.5
SMALL_GAIN, LORA_STD = 0.1, 0.01 / 3 ** 0.5
#: the bounds of the decay's exponent, w = exp(-exp(clamp(w0 + LoRA(x))))
DECAY_LOG_MIN, DECAY_LOG_MAX = -8.0, 4.0
MIXES = 5   # the token-shift interpolations: r, k, v, g, w
#: tokens a block of the WKV's chunked form; decays below MIN_DECAY count as
#: MIN_DECAY there (a decay that small already zeroes what it multiplies)
WKV_CHUNK, MIN_DECAY = 16, 1e-30


def layout(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """The parameter leaves as (path, shape, init, std), in the sorted-key
    order of the nested tree: ``init`` is ``normal``, ``embed`` (std 0.02)
    or ``ones``."""
    L, D, Ff, V = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    r, dh = m["rwkv_lora_rank"], m["rwkv_head_dim"]
    H = D // dh
    proj, small = ((L, D, D), "normal", D ** -0.5), ((L, D, D), "normal", SMALL_GAIN * D ** -0.5)
    layer = {
        "tm_norm": ((L, D), "ones", 0.0),
        "mu_base": ((L, D), "normal", MU_STD),
        "mix_w1": ((L, D, MIXES * r), "normal", D ** -0.5),
        "mix_w2": ((L, MIXES, r, D), "normal", LORA_STD),
        "mu_rkvgw": ((L, MIXES, D), "normal", MU_STD),
        "w_r": proj, "w_k": small, "w_v": proj, "w_g": small, "w_o": small,
        "w0": ((L, D), "normal", W0_STD),
        "decay_w1": ((L, D, r), "normal", D ** -0.5),
        "decay_w2": ((L, r, D), "normal", LORA_STD),
        "u": ((L, H, dh), "normal", U_STD),
        "ln_x": ((L, D), "ones", 0.0),
        "cm_norm": ((L, D), "ones", 0.0),
        "cm_mu_k": ((L, D), "normal", MU_STD),
        "cm_mu_r": ((L, D), "normal", MU_STD),
        "cm_k": ((L, D, Ff), "normal", D ** -0.5),
        "cm_v": ((L, Ff, D), "normal", SMALL_GAIN * Ff ** -0.5),
        "cm_r": small,
    }
    top = {"embed": ((V, D), "embed", 0.02), "final_norm": ((D,), "ones", 0.0),
           "unembed": ((D, V), "normal", D ** -0.5)}
    out = []
    for k in sorted(top.keys() | {"layers"}):
        if k == "layers":
            out += [(f"layers.{n}",) + layer[n] for n in sorted(layer)]
        else:
            out.append((k,) + top[k])
    return out


def wkv_per_token(r, k, v, w, u) -> torch.Tensor:
    """The recurrence one token at a time, fp32, from a zero state. r, k, v,
    w: (B, S, H, dh); u: (H, dh). Returns y (B, S, H, dh) fp32."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    B, S, H, dh = r.shape
    bonus = (r * u.float() * k).sum(-1, keepdim=True)        # r_t diag(u) k_t^T
    state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    ys = []
    for rt, kt, vt, wt, bt in zip(r.unbind(1), k.unbind(1), v.unbind(1), w.unbind(1),
                                  bonus.unbind(1)):
        ys.append(torch.addcmul((rt[..., None, :] @ state)[..., 0, :], bt, vt))
        state = torch.addcmul(wt[..., None] * state, kt[..., :, None], vt[..., None, :])
    return torch.stack(ys, dim=1)


def wkv(r, k, v, w, u, chunk: int = WKV_CHUNK) -> torch.Tensor:
    """``wkv_per_token`` in blocks of ``chunk`` tokens, the same equations
    in fp32 (the per-token loop takes ~40 s a step at the cell's size on an
    H100). In a
    block, with L_t the sum of log w over the block's tokens before t and
    L'_t that through t, the state y_t reads is
        S_{t-1} = sum_{s<t} k_s^T v_s * exp(L_t - L'_s)  +  S_0 * exp(L_t),
    S_0 the state the block starts from, and the block hands on
        S_last = S_0 * exp(L'_last) + sum_s k_s^T v_s * exp(L'_last - L'_s).
    Every exponent is a sum of log w <= 0, so nothing overflows; a ragged
    end is padded with k = v = 0 and w = 1."""
    B, S, H, dh = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = r.shape[1] // chunk

    def blocks(x):  # (B, H, n, chunk, dh)
        return x.float().reshape(B, n, chunk, H, dh).permute(0, 3, 1, 2, 4)

    rb, kb, vb = blocks(r), blocks(k), blocks(v)
    lw = torch.log(blocks(w).clamp_min(MIN_DECAY))
    incl = lw.cumsum(-2)                                       # L'_t
    excl = incl - lw                                           # L_t
    before = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)[..., None]
    expo = (excl[..., :, None, :] - incl[..., None, :, :]).masked_fill(~before, -torch.inf)
    scores = torch.einsum("bhntd,bhnsd,bhntsd->bhnts", rb, kb, expo.exp())
    y = scores @ vb + (rb * u.float()[:, None, None] * kb).sum(-1, keepdim=True) * vb
    state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    carried = []
    for c in range(n):
        carried.append((rb[:, :, c] * excl[:, :, c].exp()) @ state)
        last = incl[:, :, c, -1:]                              # (B, H, 1, dh)
        state = last.exp().transpose(-1, -2) * state \
            + (kb[:, :, c] * (last - incl[:, :, c]).exp()).transpose(-1, -2) @ vb[:, :, c]
    y = y + torch.stack(carried, dim=2)
    return y.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, dh)[:, :S]


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, with a zero before the first token."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(m: dict, p: Dict[str, torch.Tensor], h: torch.Tensor, numerics: str):
    B, S, D = h.shape
    r_, dh = m["rwkv_lora_rank"], m["rwkv_head_dim"]
    x = rms_norm(h, p["tm_norm"], m["norm_eps"]).float()
    dx = _shift(x) - x
    a = torch.tanh(mm(x + dx * p["mu_base"], p["mix_w1"], numerics).float())
    offs = torch.einsum("bsfr,frd->bsfd", operand(a.view(B, S, MIXES, r_), numerics),
                        operand(p["mix_w2"], numerics)).float()
    xr, xk, xv, xg, xw = (x[:, :, None] + dx[:, :, None] * (p["mu_rkvgw"] + offs)).unbind(2)
    rr, kk, vv = (mm(xi, p[n], numerics) for xi, n in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = mm(xg, p["w_g"], numerics).float()
    dw = mm(torch.tanh(mm(xw, p["decay_w1"], numerics).float()), p["decay_w2"], numerics)
    w = torch.exp(-torch.exp(torch.clamp(p["w0"] + dw.float(), DECAY_LOG_MIN, DECAY_LOG_MAX)))
    shp = (B, S, D // dh, dh)
    y = wkv(*(operand(t, numerics).reshape(shp) for t in (rr, kk, vv, w)), p["u"])
    y = rms_norm(y.reshape(B, S, D).to(act(numerics)), p["ln_x"], m["norm_eps"])
    return mm(y.float() * F.silu(g), p["w_o"], numerics)


def channel_mix(m: dict, p: Dict[str, torch.Tensor], h: torch.Tensor, numerics: str):
    x = rms_norm(h, p["cm_norm"], m["norm_eps"]).float()
    dx = _shift(x) - x
    kk = torch.relu(mm(x + dx * p["cm_mu_k"], p["cm_k"], numerics).float()).square()
    rr = mm(x + dx * p["cm_mu_r"], p["cm_r"], numerics).float()
    return torch.sigmoid(rr) * mm(kk, p["cm_v"], numerics).float()


_LAYER_KEYS = ("cm_k", "cm_mu_k", "cm_mu_r", "cm_norm", "cm_r", "cm_v", "decay_w1",
               "decay_w2", "ln_x", "mix_w1", "mix_w2", "mu_base", "mu_rkvgw", "tm_norm",
               "u", "w0", "w_g", "w_k", "w_o", "w_r", "w_v")


def layer_fn(m: dict, numerics: str, h: torch.Tensor, *leaves):
    p = dict(zip(_LAYER_KEYS, leaves))
    h = h + time_mix(m, p, h, numerics).to(h.dtype)
    return h + channel_mix(m, p, h, numerics).to(h.dtype)


def loss_fn(m: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            frontend: Optional[torch.Tensor], numerics: str, routes=None) -> torch.Tensor:
    """Mean next-token cross-entropy; RWKV takes no prefix and no routes."""
    if frontend is not None:
        raise ValueError("the RWKV family takes no frontend prefix")
    h = F.embedding(tokens.long(), params["embed"]).to(act(numerics))
    for i in range(m["num_layers"]):
        leaves = [params[f"layers.{k}"][i] for k in _LAYER_KEYS]
        h = checkpoint(layer_fn, m, numerics, h, *leaves, use_reentrant=False)
    h = rms_norm(h, params["final_norm"], m["norm_eps"])
    logits = mm(h[:, :-1], params["unembed"], numerics).float()
    labels = tokens[:, 1:].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    return nll.mean()


@contextlib.contextmanager
def _no_tf32():
    """fp32 products in fp32: TF32 off inside, the caller's settings after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def train_readings(m: dict, opt: dict, make_leaf, batches, frontend=None,
                   numerics: Optional[str] = None, rows: Optional[int] = None,
                   routes=None) -> dict:
    """``common.train_readings`` of this family, TF32 off: each step's loss,
    each leaf's first clipped gradient norm and each leaf's change."""
    with _no_tf32():
        return common.train_readings(layout, loss_fn, m, opt, make_leaf, batches, frontend,
                                     numerics, rows, routes)


# ---------------------------------------------------------------------------
# the work a step is credited with
# ---------------------------------------------------------------------------

def token_flops(m: dict) -> int:
    """Model FLOPs of one token's forward: per layer the projections r, k,
    v, g, o and cm_r (D x D each), cm_k and cm_v (D x F), the token-shift
    LoRA (D x 5r and 5r x D), the decay LoRA (D x r and r x D) and the WKV's
    k^T v and r S (4 dh^2 a head); then the unembedding (D x V)."""
    D, Ff, r, dh = m["d_model"], m["d_ff"], m["rwkv_lora_rank"], m["rwkv_head_dim"]
    layer = 2 * (6 * D * D + 2 * D * Ff) + 2 * (2 * MIXES * r * D) + 2 * (2 * r * D) \
        + 4 * D * dh
    return m["num_layers"] * layer + 2 * D * m["vocab_size"]


def step_model_flops(m: dict, global_batch: int, seq_len: int, prefix: int = 0) -> int:
    """Model FLOPs of one training step over (global_batch, prefix + seq_len)
    positions: 3 x the forward's (forward and backward); the token
    embedding is a lookup and counts nothing; recomputation (remat, the WKV
    backward rule's recompute) is not counted."""
    return 3 * token_flops(m) * global_batch * (prefix + seq_len)


# ---------------------------------------------------------------------------
# the CPU tests' sizes
# ---------------------------------------------------------------------------

# the port's rwkv6-3b smoke widths; float32 on both sides for the whole runs:
# at these widths bf16 rounding alone would read above limits set for the
# cell's widths, and the faults read far above them
SMOKE = {"d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 160, "vocab_size": 257,
         "rwkv_head_dim": 16, "rwkv_lora_rank": 8, "rwkv_chunk": 8}


def tiny(m: dict) -> dict:
    """The model overrides of a whole run in the CPU faults tests."""
    return dict(SMOKE, num_layers=1, compute_dtype="float32")


def small(m: dict) -> dict:
    """The model overrides of the controls read in the CPU tests."""
    return dict(SMOKE, num_layers=2)
