"""RMSNorm as an autograd Function: CUDA tensor -> ``csrc/rmsnorm.cu``; CPU
tensor -> plain. The forward is the operator ``repro_torch::rmsnorm_fwd``
(``kernels/common.define_op``): fake tensors get its output's shape, DTensors
shard it on rows, and ``FlopCounterMode`` counts it as 0 FLOPs (no product:
the reference's HLO reader counts dots only; its ~4 elementwise operations
an element run on no tensor core).

The backward is the reference's own rule (``src/repro/kernels/rmsnorm/ops.py``
``_bwd``): recompute the plain version and differentiate it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (aligned16, define_op, launch, load,
                                        on_cpu, require)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"rmsnorm_fwd": [_P, _P, _P, _I, _I, ctypes.c_float, _P]}


def _rmsnorm_impl(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
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


def _rmsnorm_sharding(x, scale, eps):
    from torch.distributed.tensor import Replicate, Shard
    rows = [([Shard(d)], [Shard(d), Replicate(), None])
            for d in range(len(x.shape) - 1)]
    return [([Replicate()], [Replicate(), Replicate(), None])] + rows


_rmsnorm_op = define_op(
    "rmsnorm_fwd", "(Tensor x, Tensor scale, float eps) -> Tensor",
    _rmsnorm_impl, lambda x, scale, eps: torch.empty_like(x),
    lambda *args, out_shape=None, **kw: 0, _rmsnorm_sharding)


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The forward alone: K2 on CUDA tensors, ``rmsnorm_ref`` on CPU ones."""
    return _rmsnorm_op(x, scale, float(eps))


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                g: torch.Tensor):
    """(dx in x's dtype, dscale in scale's dtype): the vjp of
    ``rmsnorm_ref`` at (x, scale) against the cotangent ``g``."""
    with torch.enable_grad():
        x_, s_ = (t.detach().requires_grad_() for t in (x, scale))
        return torch.autograd.grad(rmsnorm_ref(x_, s_, eps), (x_, s_), g)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_bwd(x, scale, ctx.eps, g), None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Per row of the last axis: fp32 ``x * rsqrt(mean(x^2) + eps) * scale``,
    output in ``x.dtype``. ``scale`` is fp32 of shape ``(D,)``.
    Differentiable in x and scale."""
    return _RMSNorm.apply(x, scale, eps)
