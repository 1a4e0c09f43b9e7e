"""RMSNorm as an autograd Function: CUDA tensor -> ``csrc/rmsnorm.cu``; CPU
tensor -> plain. The forward is the operator ``repro_torch::rmsnorm_fwd``
(``kernels/common.define_op``): fake tensors get its output's shape, DTensors
shard it on rows, and ``FlopCounterMode`` counts it as 0 FLOPs (no product:
the reference's HLO reader counts dots only; its ~4 elementwise operations
an element run on no tensor core). It takes an optional per-row mean square
(fp32, ``x.shape[:-1]``) in place of its own row reduction: a DTensor whose
rows are sharded (the hybrid's ``out_norm`` over d_inner, sharded by "mlp")
all-reduces each device's sum of squares and normalises its own columns
with it (``sharding/dtensor.rms_norm_sharded_rows``), as the reference's
``rms_norm`` reduces the shards' partial sums.

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
_ARGTYPES = {"rmsnorm_fwd": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _P]}


def _rmsnorm_impl(x: torch.Tensor, scale: torch.Tensor, eps: float,
                  mean_sq=None) -> torch.Tensor:
    given = () if mean_sq is None else (mean_sq,)
    if on_cpu(x, scale, *given):
        return rmsnorm_ref(x, scale, eps, mean_sq)
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
    require(mean_sq is None or (
        mean_sq.dtype == torch.float32 and mean_sq.is_contiguous()
        and tuple(mean_sq.shape) == tuple(x.shape[:-1])),
        f"rmsnorm mean_sq must be contiguous float32 of shape "
        f"{tuple(x.shape[:-1])}")
    out = torch.empty_like(x)
    lib = load("rmsnorm", _ARGTYPES)
    launch("rmsnorm", lib.rmsnorm_fwd, x.device, x.data_ptr(),
           scale.data_ptr(), None if mean_sq is None else mean_sq.data_ptr(),
           out.data_ptr(), x.numel() // D, D, float(eps))
    return out


def _rmsnorm_sharding(x, scale, eps, mean_sq=None):
    """Rows. A given mean square comes only with local tensors
    (``sharding/dtensor.rms_norm_sharded_rows``)."""
    from torch.distributed.tensor import Replicate, Shard
    rows = [([Shard(d)], [Shard(d), Replicate(), None])
            for d in range(len(x.shape) - 1)]
    return [([Replicate()], [Replicate(), Replicate(), None])] + rows


_rmsnorm_op = define_op(
    "rmsnorm_fwd",
    "(Tensor x, Tensor scale, float eps, Tensor? mean_sq=None) -> Tensor",
    _rmsnorm_impl, lambda x, scale, eps, mean_sq=None: torch.empty_like(x),
    lambda *args, out_shape=None, **kw: 0, _rmsnorm_sharding)


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
                mean_sq=None) -> torch.Tensor:
    """The forward alone: K2 on CUDA tensors, ``rmsnorm_ref`` on CPU ones.
    ``mean_sq`` (fp32, ``x.shape[:-1]``), if given, is each row's mean
    square, used in place of the row's own."""
    if mean_sq is None:
        return _rmsnorm_op(x, scale, float(eps))
    return _rmsnorm_op(x, scale, float(eps), mean_sq)


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
        if hasattr(x, "placements") and any(
                p.is_shard(x.ndim - 1) for p in x.placements):
            from repro_torch.sharding.dtensor import rms_norm_sharded_rows
            return rms_norm_sharded_rows(x, scale, eps, rmsnorm_fwd)
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_bwd(x, scale, ctx.eps, g), None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Per row of the last axis: fp32 ``x * rsqrt(mean(x^2) + eps) * scale``,
    output in ``x.dtype``. ``scale`` is fp32 of shape ``(D,)``.
    Differentiable in x and scale. The backward recomputes ``rmsnorm_ref``
    (on a DTensor too, whose mean over sharded rows DTensor all-reduces)."""
    return _RMSNorm.apply(x, scale, eps)
