"""Plain PyTorch single-token GQA decode attention: the CPU path and the
kernel's oracle."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cur_index: int) -> torch.Tensor:
    """q: (B, H, dh); caches: (B, T, G, dh); positions [0, cur_index] valid."""
    B, H, dh = q.shape
    T, G = k_cache.shape[1], k_cache.shape[2]
    kh = k_cache.repeat_interleave(H // G, dim=2).float()
    vh = v_cache.repeat_interleave(H // G, dim=2).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), kh) / math.sqrt(dh)
    valid = torch.arange(T, device=q.device)[None, None, :] <= cur_index
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, vh)
    return out.to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, n_valid: int):
    """Positions [0, n_valid) of a (local) cache: (o in q's dtype, lse fp32
    (B, H), natural log); n_valid == 0 gives o = 0 and lse = -inf."""
    B, H, dh = q.shape
    if n_valid == 0:
        return (torch.zeros_like(q),
                torch.full((B, H), -math.inf, device=q.device))
    G = k_cache.shape[2]
    kh = k_cache[:, :n_valid].repeat_interleave(H // G, dim=2).float()
    vh = v_cache[:, :n_valid].repeat_interleave(H // G, dim=2).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), kh) / math.sqrt(dh)
    out = torch.einsum("bht,bthd->bhd", torch.softmax(s, dim=-1), vh)
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def combine_partials(outs, lses) -> torch.Tensor:
    """The pieces' outputs (each (B, H, dh)) and log-sum-exps (each (B, H))
    merged: sum_i w_i o_i / sum_i w_i, w_i = exp(lse_i - max lse), in fp32,
    out in the pieces' dtype. An empty piece (lse -inf) weighs 0; at least
    one piece must hold a position."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))
    num = (w[..., None] * torch.stack(outs).float()).sum(0)
    return (num / w.sum(0)[..., None]).to(outs[0].dtype)
