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
