"""Plain PyTorch causal GQA attention: the CPU path and the kernel's oracle."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, T, G, dh) with H % G == 0 -> (B, S, H, dh)."""
    B, S, H, dh = q.shape
    T, G = k.shape[1], k.shape[2]
    rep = H // G
    kh = k.repeat_interleave(rep, dim=2).float()
    vh = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bshd,bthd->bhst", q.float(), kh) / math.sqrt(dh)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, vh)
    return out.to(q.dtype)
