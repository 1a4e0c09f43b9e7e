"""RWKV6 "Finch" (port of ``repro.models.rwkv6``): attention-free decoder with
data-dependent decay.

Time mixing is a linear-attention-like recurrence per head with a (dh x dh)
state S:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with per-channel decay w_t = exp(-exp(w0 + lora_w(x_t))) and a low-rank,
data-dependent token-shift interpolation; channel mixing is a token shift
and a squared-ReLU FFN.

Weights keep the JAX layouts and leaf paths with the leading "layers" axis;
the layer scan becomes a Python loop over layer slices (under
``torch.utils.checkpoint`` when a training forward has ``cfg.remat``). The
weight products stay ``torch.matmul``. Every RMSNorm goes through
``common.rms_norm`` (K2 on CUDA) and the recurrence over a sequence through ``wkv6`` (K4 on CUDA; its
plain version is the JAX ``wkv6_chunked``). Decode steps one token with
``wkv6_step`` as plain tensor code, as the JAX decode does: it reaches no
Pallas kernel.

``time_mix`` takes no ``shift_prev``/``state0``: nothing in the JAX package
passes them, and the Pallas kernel takes no initial state, so every
sequence starts from a zero state and a zero shift.

The decode state ``{"wkv", "tm_shift", "cm_shift"}`` is O(1) in sequence
length; ``decode_step`` updates it in place (the JAX version returns a new
one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.common import (ParamSpec, layer_slices, remat,
                                       rms_norm)
from repro_torch.models.config import ModelConfig


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def layer_param_specs(cfg: ModelConfig, L: Optional[int] = None
                      ) -> Dict[str, ParamSpec]:
    if L is None:
        L = cfg.num_layers
    D, F_, r = cfg.d_model, cfg.d_ff, cfg.rwkv_lora_rank
    H, dh = num_heads(cfg), cfg.rwkv_head_dim
    return {
        # -- time mixing ---------------------------------------------------
        "tm_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        "mu_base": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        # data-dependent shift interpolation (5 targets: r,k,v,g,w)
        "mix_w1": ParamSpec((L, D, 5 * r), ("layers", "embed", None)),
        "mix_w2": ParamSpec((L, 5, r, D), ("layers", None, None, "embed")),
        "mu_rkvgw": ParamSpec((L, 5, D), ("layers", None, "embed"), init="zeros"),
        "w_r": ParamSpec((L, D, D), ("layers", "embed", None)),
        "w_k": ParamSpec((L, D, D), ("layers", "embed", None)),
        "w_v": ParamSpec((L, D, D), ("layers", "embed", None)),
        "w_g": ParamSpec((L, D, D), ("layers", "embed", None)),
        "w_o": ParamSpec((L, D, D), ("layers", None, "embed")),
        # decay: w0 + tanh(x @ dw1) @ dw2
        "w0": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "decay_w1": ParamSpec((L, D, r), ("layers", "embed", None)),
        "decay_w2": ParamSpec((L, r, D), ("layers", None, "embed")),
        "u": ParamSpec((L, H, dh), ("layers", None, None), init="zeros"),
        "ln_x": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        # -- channel mixing -------------------------------------------------
        "cm_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        "cm_mu_k": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "cm_mu_r": ParamSpec((L, D), ("layers", "embed"), init="zeros"),
        "cm_k": ParamSpec((L, D, F_), ("layers", "embed", "mlp")),
        "cm_v": ParamSpec((L, F_, D), ("layers", "mlp", "embed")),
        "cm_r": ParamSpec((L, D, D), ("layers", "embed", None)),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed",
                           init_scale=0.02),
        "layers": layer_param_specs(cfg),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        "unembed": ParamSpec((D, V), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# WKV6 single step (decode)
# ---------------------------------------------------------------------------

def wkv6_step(r, k, v, w, u, state: torch.Tensor) -> torch.Tensor:
    """Single-token recurrence. r/k/v/w: (B, H, dh); u: (H, dh); state:
    (B, H, dh, dh) fp32, updated in place. Returns y (B, H, dh) in r's
    dtype."""
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = kf[..., :, None] * vf[..., None, :]
    y = (rf[..., None, :] @ (state + u.float()[None, :, :, None] * kv))[..., 0, :]
    state.mul_(w.float()[..., None]).add_(kv)
    return y.to(r.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """xx_t = x_{t-1}; x_{-1} = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _mix_inputs(cfg: ModelConfig, lp, x: torch.Tensor, xx: torch.Tensor):
    """Data-dependent token-shift interpolation -> (x_r, x_k, x_v, x_g, x_w)."""
    cd = cfg.cdtype
    dx = xx - x
    base = x + dx * lp["mu_base"].to(cd)
    a = torch.tanh(base @ lp["mix_w1"].to(cd))
    B, S = x.shape[:2]
    a = a.view(B, S, 5, cfg.rwkv_lora_rank)
    offs = torch.einsum("bsfr,frd->bsfd", a, lp["mix_w2"].to(cd))
    mixed = x[:, :, None] + dx[:, :, None] * (lp["mu_rkvgw"].to(cd) + offs)
    return mixed.unbind(2)


def _decay(lp, dw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), fp32: exp(-exp(clip(w0 + dw, -8, 4)))."""
    return torch.exp(-torch.exp(torch.clamp(lp["w0"].float() + dw.float(),
                                            -8.0, 4.0)))


def _time_mix_proj(cfg: ModelConfig, lp, x, xx):
    """Normed input and its shift -> (r, k, v, g, w) of shape (B, S, D)."""
    cd = cfg.cdtype
    x_r, x_k, x_v, x_g, x_w = _mix_inputs(cfg, lp, x, xx)
    r = x_r @ lp["w_r"].to(cd)
    k = x_k @ lp["w_k"].to(cd)
    v = x_v @ lp["w_v"].to(cd)
    g = x_g @ lp["w_g"].to(cd)
    dw = torch.tanh(x_w @ lp["decay_w1"].to(cd)) @ lp["decay_w2"].to(cd)
    return r, k, v, g, _decay(lp, dw)


def _time_mix_out(cfg: ModelConfig, lp, y: torch.Tensor, g: torch.Tensor):
    y = rms_norm(y, lp["ln_x"], cfg.norm_eps)  # group-norm surrogate
    return (y * F.silu(g)) @ lp["w_o"].to(cfg.cdtype)


def time_mix(cfg: ModelConfig, lp, h: torch.Tensor,
             return_state: bool = False):
    """Full time-mixing block over a sequence. h: (B, S, D)."""
    H, dh = num_heads(cfg), cfg.rwkv_head_dim
    B, S, D = h.shape
    x = rms_norm(h, lp["tm_norm"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_proj(cfg, lp, x, _token_shift(x))
    shp = (B, S, H, dh)
    y, state = wkv6(r.view(shp), k.view(shp), v.view(shp),
                    w.to(cfg.cdtype).view(shp), lp["u"].float(),
                    cfg.rwkv_chunk)
    out = _time_mix_out(cfg, lp, y.view(B, S, D), g)
    if return_state:
        return out, (x[:, -1], state)
    return out


def _channel_mix(cfg: ModelConfig, lp, x: torch.Tensor, xx: torch.Tensor):
    """Normed input and its shift -> the channel-mix output."""
    cd = cfg.cdtype
    dx = xx - x
    x_k = x + dx * lp["cm_mu_k"].to(cd)
    x_r = x + dx * lp["cm_mu_r"].to(cd)
    kk = torch.square(torch.relu(x_k @ lp["cm_k"].to(cd)))
    kv = kk @ lp["cm_v"].to(cd)
    return torch.sigmoid(x_r @ lp["cm_r"].to(cd)) * kv


def channel_mix(cfg: ModelConfig, lp, h: torch.Tensor,
                return_state: bool = False):
    x = rms_norm(h, lp["cm_norm"], cfg.norm_eps)
    out = _channel_mix(cfg, lp, x, _token_shift(x))
    if return_state:
        return out, x[:, -1]
    return out


def rwkv_layer(cfg: ModelConfig, lp, h: torch.Tensor) -> torch.Tensor:
    h = h + time_mix(cfg, lp, h)
    return h + channel_mix(cfg, lp, h)


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.cdtype)


def _unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    return h @ params["unembed"].to(cfg.cdtype)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward pass. Returns (logits, aux_loss = 0). tokens:
    (B, S)."""
    h = _embed(cfg, params, tokens)
    layer = remat(cfg, rwkv_layer)
    for lp in layer_slices(params, cfg.num_layers):
        h = layer(cfg, lp, h)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def state_specs(cfg: ModelConfig, batch: int, max_seq: Optional[int] = None):
    """Recurrent decode state, O(1) in sequence length (``max_seq`` is
    unused): name -> (shape, dtype)."""
    L, D = cfg.num_layers, cfg.d_model
    H, dh = num_heads(cfg), cfg.rwkv_head_dim
    return {
        "wkv": ((L, batch, H, dh, dh), torch.float32),
        "tm_shift": ((L, batch, D), cfg.cdtype),
        "cm_shift": ((L, batch, D), cfg.cdtype),
    }


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, state=None):
    """Forward over the prompt. Returns (last-position logits, decode state).

    Without ``state`` one is allocated; with one (of batch B) it is written
    in place and the same dict is returned. Prefill writes every leaf whole.
    """
    h = _embed(cfg, params, tokens)
    if state is None:
        state = {k: torch.empty(shape, dtype=dt, device=h.device)
                 for k, (shape, dt) in state_specs(cfg, h.shape[0]).items()}
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        out, (tm_last, wkv_state) = time_mix(cfg, lp, h, return_state=True)
        h = h + out
        out, cm_last = channel_mix(cfg, lp, h, return_state=True)
        h = h + out
        state["wkv"][i] = wkv_state
        state["tm_shift"][i] = tm_last
        state["cm_shift"][i] = cm_last
    # RMSNorm is per row, so only the last position is normed and unembedded
    h = rms_norm(h[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], state


def decode_step(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                pos: int):
    """One-token decode with the recurrent state, updated in place.

    tokens: (B,) int; ``pos`` is unused (the state carries the position), as
    in the JAX version. Returns (logits, state).
    """
    H, dh = num_heads(cfg), cfg.rwkv_head_dim
    h = _embed(cfg, params, tokens[:, None])  # (B, 1, D)
    B, _, D = h.shape
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        # time mix (S = 1, with the carried shift and WKV state)
        x = rms_norm(h, lp["tm_norm"], cfg.norm_eps)
        r, k, v, g, w = _time_mix_proj(cfg, lp, x, state["tm_shift"][i][:, None])
        shp = (B, H, dh)
        y = wkv6_step(r.view(shp), k.view(shp), v.view(shp), w.view(shp),
                      lp["u"], state["wkv"][i])
        h = h + _time_mix_out(cfg, lp, y.view(B, 1, D), g)
        state["tm_shift"][i] = x[:, -1]
        # channel mix
        x = rms_norm(h, lp["cm_norm"], cfg.norm_eps)
        h = h + _channel_mix(cfg, lp, x, state["cm_shift"][i][:, None])
        state["cm_shift"][i] = x[:, -1]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], state
