"""RMSNorm wrapper: CUDA tensor -> ``csrc/rmsnorm.cu``; CPU tensor -> plain.

Forward only: the training slice adds the backward as an autograd Function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import aligned16, launch, load, on_cpu, require
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"rmsnorm_fwd": [_P, _P, _P, _I, _I, ctypes.c_float, _P]}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Per row of the last axis: fp32 ``x * rsqrt(mean(x^2) + eps) * scale``,
    output in ``x.dtype``. ``scale`` is fp32 of shape ``(D,)``."""
    if on_cpu(x, scale):
        return rmsnorm_ref(x, scale, eps)
    D = x.shape[-1]
    require(x.dtype == torch.bfloat16,
            f"rmsnorm kernel takes bfloat16, got {x.dtype}")
    require(scale.dtype == torch.float32 and tuple(scale.shape) == (D,),
            f"rmsnorm scale must be float32 of shape ({D},), got "
            f"{scale.dtype} {tuple(scale.shape)}")
    require(x.is_contiguous() and scale.is_contiguous(),
            "rmsnorm kernel takes contiguous tensors")
    require(D % 8 == 0 and aligned16(x, scale),
            f"rmsnorm kernel loads 16 bytes at a time: D={D} must be a "
            f"multiple of 8 and x and scale 16-byte aligned")
    out = torch.empty_like(x)
    lib = load("rmsnorm", _ARGTYPES)
    launch("rmsnorm", lib.rmsnorm_fwd, x.device, x.data_ptr(),
           scale.data_ptr(), out.data_ptr(), x.numel() // D, D, float(eps))
    return out
