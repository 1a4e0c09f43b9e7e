"""Decoder-only transformer (GQA + SwiGLU), port of ``repro.models.transformer``
for the dense, moe, vlm and audio families (moe swaps the FFN for
``repro_torch.models.moe``; vlm and audio are the dense backbone). A
modality frontend enters as precomputed embeddings, ``frontend_embeds``
(B, P, D), put before the token embeddings. Audio reads tokens (B, S, K)
over K codebooks: its input is the sum of the K tables' embeddings and its
output K heads, logits (B, S, K, V).

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
                                       embed_lookup, gather_weights,
                                       layer_slices, remat,
                                       rms_norm, rope_angles,
                                       split_heads_ready, swiglu,
                                       with_logical_constraint)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_ffn, moe_param_specs


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def layer_param_specs(cfg: ModelConfig, L: Optional[int] = None
                      ) -> Dict[str, ParamSpec]:
    """Specs for a stack of L transformer layers (leading 'layers' axis)."""
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
    }
    if cfg.qkv_bias:
        specs.update({
            "bq": ParamSpec((L, H, dh), ("layers", "heads", None), init="zeros"),
            "bk": ParamSpec((L, G, dh), ("layers", "kv", None), init="zeros"),
            "bv": ParamSpec((L, G, dh), ("layers", "kv", None), init="zeros"),
        })
    if cfg.family == "moe":
        specs.update(moe_param_specs(cfg, L))
    else:
        specs.update({
            "w_gate": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
            "w_up": ParamSpec((L, D, F), ("layers", "embed", "mlp")),
            "w_down": ParamSpec((L, F, D), ("layers", "mlp", "embed")),
        })
    return specs


def param_specs(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        embed = ParamSpec((cfg.num_codebooks, V, D), (None, "vocab", "embed"),
                          init="embed", init_scale=0.02)
        unembed = ParamSpec((cfg.num_codebooks, D, V), (None, "embed", "vocab"))
    else:
        embed = ParamSpec((V, D), ("vocab", "embed"), init="embed",
                          init_scale=0.02)
        unembed = ParamSpec((D, V), ("embed", "vocab"))
    specs = {
        "embed": embed,
        "layers": layer_param_specs(cfg),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = unembed
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor
                  ) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens (B, S, K): the K codebook rows summed in the tables' dtype,
        # then cast
        return sum(embed_lookup(table, tokens[..., k]) for k, table in enumerate(
            params["embed"].unbind(0))).to(cfg.cdtype)
    return embed_lookup(params["embed"], tokens).to(cfg.cdtype)


def _unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        # K heads, no softcap: (B, S, K, V), the reference's "bsd,kdv->bskv";
        # one product a head over the unbound (D, V) tables, so the table's
        # gradient is stacked contiguous (the optimizer updates in place)
        return torch.stack([h @ w.to(cfg.cdtype) for w in gather_weights(
            params["unembed"]).unbind(0)], dim=2)
    table = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = h @ gather_weights(table).to(cfg.cdtype)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _proj_heads(x: torch.Tensor, w: torch.Tensor,
                kv: bool = False) -> torch.Tensor:
    """(B, S, D) x (D, n, dh) -> (B, S, n, dh). ``kv``: a K/V projection,
    which on a DTensor whose KV heads a mesh dim cannot split is computed
    whole on each device of that dim, as the reference computes it."""
    D, n, dh = w.shape
    w = w.reshape(D, n * dh)
    if kv and hasattr(x, "placements"):
        from repro_torch.sharding.dtensor import (splits_heads,
                                                  whole_heads_product)
        if splits_heads(x, n):
            return whole_heads_product(x, w, n).view(*x.shape[:-1], n, dh)
    y = split_heads_ready(x @ split_heads_ready(w, n), n)
    return y.view(*x.shape[:-1], n, dh)


def _qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
         cos: torch.Tensor, sin: torch.Tensor):
    """Normed input -> (q, k, v) with RoPE applied to q and k."""
    cd = cfg.cdtype
    q = _proj_heads(x, p["wq"].to(cd))
    k = _proj_heads(x, p["wk"].to(cd), kv=True)
    v = _proj_heads(x, p["wv"].to(cd), kv=True)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = with_logical_constraint(apply_rope(q, cos, sin),
                                ("batch", "seq_sp", "heads", None))
    k = with_logical_constraint(apply_rope(k, cos, sin),
                                ("batch", None, "kv", None))
    return q, k, with_logical_constraint(v, ("batch", None, "kv", None))


def _attn_out(cfg: ModelConfig, p, out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) x wo (H, dh, D) -> (B, S, D)."""
    H, dh, D = p["wo"].shape
    return out.reshape(*out.shape[:-2], H * dh) @ p["wo"].to(
        cfg.cdtype).reshape(H * dh, D)


def dense_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.cdtype
    g = x @ p["w_gate"].to(cd)
    u = x @ p["w_up"].to(cd)
    mid = with_logical_constraint(swiglu(g, u), ("batch", None, "mlp"))
    return mid @ p["w_down"].to(cd)


def _ffn(cfg: ModelConfig, p, x: torch.Tensor):
    """The family's FFN: (y, aux_loss); the dense FFN's aux loss is None."""
    if cfg.family == "moe":
        return moe_ffn(cfg, p, x)
    return dense_ffn(cfg, p, x), None


def _layer(cfg: ModelConfig, lp, h: torch.Tensor, cos, sin):
    """One pre-norm residual layer. Returns (h, k, v, aux_loss); k/v feed
    the cache."""
    lp = gather_weights(lp)
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    out = attention(q, k, v, causal=True)
    # the partial sums of the heads' products settle before the norm (the
    # reference leaves the choice to GSPMD; DTensor would shard the rows)
    h = with_logical_constraint(h + _attn_out(cfg, lp, out),
                                ("batch", "seq_res", None))
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    y, aux = _ffn(cfg, lp, x)
    h = with_logical_constraint(h + y, ("batch", "seq_res", None))
    return h, k, v, aux


def decoder_layer(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                  h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm residual layer. Returns (h, aux_loss)."""
    h, _k, _v, aux = _layer(cfg, lp, h, cos, sin)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def _embed_and_rope(cfg, params, tokens, frontend_embeds=None):
    """Token embeddings, after the frontend prefix if one is given, and the
    RoPE angles of all P + S positions."""
    h = _embed_tokens(cfg, params, tokens)
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    h = with_logical_constraint(h, ("batch", None, None))
    S = h.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=h.device), cfg.head_dim,
                           cfg.rope_theta)
    return h, cos[None], sin[None]  # (1, S, dh/2)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward pass. Returns (logits, aux_loss), the aux loss
    summed over the layers. tokens: (B, S) int, or (B, S, K) for audio;
    frontend_embeds: (B, P, D) precomputed modality embeddings, prepended
    (logits cover P + S positions)."""
    h, cos, sin = _embed_and_rope(cfg, params, tokens, frontend_embeds)
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


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache=None,
            frontend_embeds: Optional[torch.Tensor] = None):
    """Forward pass that also fills the KV cache. Returns (logits_last, cache),
    logits (B, V), or (B, K, V) for audio.

    S counts the frontend prefix's P positions and the tokens. Without
    ``cache`` a (L, B, S, G, dh) cache is allocated; with one (of any length
    T >= S, e.g. preallocated for serving) positions [0, S) are written in
    place and the same dict is returned.
    """
    h, cos, sin = _embed_and_rope(cfg, params, tokens, frontend_embeds)
    B, S = h.shape[:2]
    if cache is None:
        cache = {k: torch.empty(shape, dtype=dt, device=h.device)
                 for k, (shape, dt) in state_specs(cfg, B, S).items()}
    if cache["k"].shape[2] < S:
        raise ValueError(f"cache holds {cache['k'].shape[2]} positions, "
                         f"prompt (with its prefix) has {S}")
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        h, k, v, _aux = _layer(cfg, lp, h, cos, sin)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    # RMSNorm is per row, so only the last position is normed and unembedded
    h = rms_norm(h[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int):
    """One-token decode against the KV cache, updated in place.

    tokens: (B,) int, or (B, K) for audio; pos: host int — the current
    position. Returns (logits, cache).
    """
    pos = int(pos)
    h = with_logical_constraint(  # (B, 1[, K]) -> (B, 1, D)
        _embed_tokens(cfg, params, tokens[:, None]), ("batch", None, None))
    cos, sin = rope_angles(torch.full((1,), pos, device=h.device),
                           cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None], sin[None]  # (1, 1, dh/2)
    for i, lp in enumerate(layer_slices(params, cfg.num_layers)):
        lp = gather_weights(lp)
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, x, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        cache_update(kc, k, pos)
        cache_update(vc, v, pos)
        out = decode_attention(q[:, 0], kc, vc, pos)[:, None]
        h = with_logical_constraint(h + _attn_out(cfg, lp, out),
                                    ("batch", "seq_res", None))
        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = with_logical_constraint(h + _ffn(cfg, lp, x)[0],
                                    ("batch", "seq_res", None))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache
