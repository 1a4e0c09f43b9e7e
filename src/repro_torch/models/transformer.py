"""Dense decoder-only transformer (GQA + SwiGLU), port of the dense family of
``repro.models.transformer``.

Weights keep the JAX layouts and leaf paths — ``wq`` (L, D, H, dh), ``wo``
(L, H, dh, D), ... — with the leading "layers" axis; the layer scan becomes a
Python loop over layer slices (under ``torch.utils.checkpoint`` when a
training forward has ``cfg.remat``). The weight products stay ``torch.matmul``;
RMSNorm, prefill attention and decode attention go through the kernel
wrappers (K2, K1, K3), which launch the Hopper kernels on CUDA tensors.

The KV cache ``{"k", "v"}`` of shape (L, B, T, G, dh) is written in place:
``decode_step`` writes the new token's K/V at ``pos`` and then attends over
``[0, pos]``, which is the function both JAX ``decode_cache_mode``s compute.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import (ParamSpec, apply_rope, attention,
                                       cache_update, decode_attention,
                                       layer_slices, remat, rms_norm,
                                       rope_angles, swiglu)
from repro_torch.models.config import ModelConfig

MOE_NOT_PORTED = ("the MoE family is not ported yet "
                  "(ROADMAP.md, Queue 1 item 3: MoE)")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def layer_param_specs(cfg: ModelConfig, L: Optional[int] = None
                      ) -> Dict[str, ParamSpec]:
    """Specs for a stack of L transformer layers (leading 'layers' axis)."""
    if cfg.family == "moe":
        raise NotImplementedError(MOE_NOT_PORTED)
    if L is None:
        L = cfg.num_layers
    D, H, G, dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    specs: Dict[str, ParamSpec] = {
        "attn_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        "wq": ParamSpec((L, D, H, dh), ("layers", "embed", "heads", None)),
        "wk": ParamSpec((L, D, G, dh), ("layers", "embed", "kv", None)),
        "wv": ParamSpec((L, D, G, dh), ("layers", "embed", "kv", None)),
        "wo": ParamSpec((L, H, dh, D), ("layers", "heads", None, "embed")),
        "mlp_norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        "w_gate": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
        "w_up": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
        "w_down": ParamSpec((L, F, D), ("layers", "mlp", "embed")),
    }
    if cfg.qkv_bias:
        specs.update({
            "bq": ParamSpec((L, H, dh), ("layers", "heads", None), init="zeros"),
            "bk": ParamSpec((L, G, dh), ("layers", "kv", None), init="zeros"),
            "bv": ParamSpec((L, G, dh), ("layers", "kv", None), init="zeros"),
        })
    return specs


def param_specs(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed",
                           init_scale=0.02),
        "layers": layer_param_specs(cfg),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((D, V), ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor
                  ) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.cdtype)


def _unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    table = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = h @ table.to(cfg.cdtype)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, n, dh) -> (B, S, n, dh)."""
    D, n, dh = w.shape
    return (x @ w.reshape(D, n * dh)).view(*x.shape[:-1], n, dh)


def _qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
         cos: torch.Tensor, sin: torch.Tensor):
    """Normed input -> (q, k, v) with RoPE applied to q and k."""
    cd = cfg.cdtype
    q = _proj_heads(x, p["wq"].to(cd))
    k = _proj_heads(x, p["wk"].to(cd))
    v = _proj_heads(x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out(cfg: ModelConfig, p, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) x wo (H, dh, D) -> (B, S, D)."""
    H, dh, D = p["wo"].shape
    return out.reshape(*out.shape[:-2], H * dh) @ p["wo"].to(
        cfg.cdtype).reshape(H * dh, D)


def dense_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype
    g = x @ p["w_gate"].to(cd)
    u = x @ p["w_up"].to(cd)
    return swiglu(g, u) @ p["w_down"].to(cd)


def _layer(cfg: ModelConfig, lp, h: torch.Tensor, cos, sin):
    """One pre-norm residual layer. Returns (h, k, v); k/v feed the cache."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    out = attention(q, k, v, causal=True)
    h = h + _attn_out(cfg, lp, out)
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    return h + dense_ffn(cfg, lp, x), k, v


def decoder_layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                  h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm residual layer. Returns (h, aux_loss)."""
    h, _k, _v = _layer(cfg, lp, h, cos, sin)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _embed_and_rope(cfg, params, tokens):
    h = _embed_tokens(cfg, params, tokens)
    S = h.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=h.device), cfg.head_dim,
                           cfg.rope_theta)
    return h, cos[None], sin[None]  # (1, S, dh/2)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward pass. Returns (logits, aux_loss). tokens: (B, S)
    int."""
    h, cos, sin = _embed_and_rope(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layer = remat(cfg, decoder_layer)
    for lp in layer_slices(params, cfg.num_layers):
        h, a = layer(cfg, lp, h, cos, sin)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), aux


def state_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """KV-cache structure: {"k", "v"} -> ((L, B, T, G, dh), dtype)."""
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.cdtype), "v": (shape, cfg.cdtype)}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache=None):
    """Forward pass that also fills the KV cache. Returns (logits_last, cache).

    Without ``cache`` a (L, B, S, G, dh) cache is allocated; with one (of any
    length T >= S, e.g. preallocated for serving) positions [0, S) are
    written in place and the same dict is returned.
    """
    h, cos, sin = _embed_and_rope(cfg, params, tokens)
    B, S = h.shape[:2]
    if cache is None:
        cache = {k: torch.empty(shape, dtype=dt, device=h.device)
                 for k, (shape, dt) in state_specs(cfg, B, S).items()}
    if cache["k"].shape[2] < S:
        raise ValueError(f"cache holds {cache['k'].shape[2]} positions, "
                         f"prompt has {S}")
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        h, k, v = _layer(cfg, lp, h, cos, sin)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    # RMSNorm is per row, so only the last position is normed and unembedded
    h = rms_norm(h[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int):
    """One-token decode against the KV cache, updated in place.

    tokens: (B,) int; pos: host int — the current position. Returns
    (logits, cache).
    """
    pos = int(pos)
    h = _embed_tokens(cfg, params, tokens[:, None])  # (B, 1, D)
    cos, sin = rope_angles(torch.full((1,), pos, device=h.device),
                           cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None], sin[None]  # (1, 1, dh/2)
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        cache_update(kc, k, pos)
        cache_update(vc, v, pos)
        out = decode_attention(q[:, 0], kc, vc, pos)[:, None]
        h = h + _attn_out(cfg, lp, out)
        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + dense_ffn(cfg, lp, x)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache
