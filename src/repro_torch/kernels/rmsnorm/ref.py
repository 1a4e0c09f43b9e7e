"""Plain PyTorch RMSNorm: the CPU path and the oracle for the CUDA kernel."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                mean_sq=None) -> torch.Tensor:
    """``mean_sq`` (fp32, ``x.shape[:-1]``), if given, stands in for each
    row's own mean square."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True) if mean_sq is None else \
        mean_sq.float()[..., None]
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
