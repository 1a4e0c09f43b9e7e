"""Flash attention as an autograd Function: CUDA tensor ->
``csrc/flash_attention.cu``; CPU tensor -> plain.

The forward is the operator ``repro_torch::flash_attention_fwd``
(``kernels/common.define_op``). Its FLOPs are counted as the reference's
dense attention counts them: two products over the full S x T scores,
4·B·H·S·T·dh; a causal kernel needs about half of that (the tiles above
the diagonal are skipped). DTensors shard it on batch, and on heads where
every mesh dim divides both the query and the KV heads.

The kernel's persistent blocks walk the work items (q tile, head, batch) in
sections of (batch, kv head) pairs whose K and V take about half the
card's L2 (``l2_section``, ``work_item``: the same map the kernel's
``item_of`` computes), so the items in flight share K and V through L2.

The backward is the reference's own rule
(``src/repro/kernels/flash_attention/ops.py`` ``_bwd``): recompute the plain
version and differentiate it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels.common import (aligned16, cdiv, define_op, launch,
                                        load, mesh_divides, on_cpu, require)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, ctypes.c_float, _I, _P]}
#: 112 (zamba2-7b's shared block) runs the dh-128 kernel over a zero pad
HEAD_DIMS = (64, 112, 128)
#: rows of a q tile; must equal kBlockQ in csrc/flash_attention.cu
BLOCK_Q = 128


def l2_section(B: int, G: int, T: int, dh: int, l2_bytes: int) -> int:
    """(batch, kv head) pairs a section of the work order holds: as many as
    keep their K and V (2 x T x dh bf16 each) within half of ``l2_bytes``,
    at least one, then evened out over the sections that makes."""
    most = max(1, l2_bytes // 2 // (4 * T * dh))
    return cdiv(B * G, cdiv(B * G, most))


def work_item(item: int, B: int, S: int, H: int, G: int,
              sec: int) -> Tuple[int, int, int]:
    """Work item -> (first q row, head, batch), as the kernel's ``item_of``
    maps it: sections of ``sec`` pairs in turn (the last may hold fewer);
    within one, the q tiles heaviest first (the last first), then the
    pairs, then the query heads of a kv head."""
    rep, n_qt = H // G, cdiv(S, BLOCK_Q)
    first = item // (sec * rep * n_qt) * sec
    j = item % (sec * rep * n_qt)
    per_qt = min(sec, B * G - first) * rep
    pair = first + j % per_qt // rep
    return ((n_qt - 1 - j // per_qt) * BLOCK_Q, pair % G * rep + j % rep,
            pair // G)


@functools.lru_cache(maxsize=None)
def _l2_bytes(device: torch.device) -> int:
    """The card's L2 size (``cudaDevAttrL2CacheSize``)."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def _flash_attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    if on_cpu(q, k, v):
        # contiguous, as the fake implementation promises
        return flash_attention_ref(q, k, v, causal).contiguous()
    B, S, H, dh = q.shape
    T, G = k.shape[1], k.shape[2]
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            f"flash_attention kernel takes bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    require(tuple(k.shape) == tuple(v.shape) == (B, T, G, dh) and H % G == 0,
            f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    require(dh in HEAD_DIMS, f"flash_attention kernel takes head_dim in "
                             f"{HEAD_DIMS}, got {dh}")
    require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v),
            "flash_attention kernel takes contiguous 16-byte aligned tensors")
    require(T > 0, "flash_attention needs at least one key")
    out = torch.empty_like(q)
    sec = l2_section(B, G, T, dh, _l2_bytes(q.device))
    lib = load("flash_attention", _ARGTYPES)
    launch("flash_attention", lib.flash_attention_fwd, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, S, T, H, G, dh, sec, 1.0 / math.sqrt(dh), int(causal))
    return out


def flash_attention_flops(q_shape, k_shape, v_shape, causal, out_shape=None,
                          **kw) -> int:
    """QK^T and PV over the full S x T, as the reference's dense attention
    counts them."""
    B, S, H, dh = q_shape
    return 4 * B * H * S * k_shape[1] * dh


def _flash_attention_sharding(q, k, v, causal):
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate()] * 3 + [None]),
           ([Shard(0)], [Shard(0)] * 3 + [None])]
    if mesh_divides(q, q.shape[2], k.shape[2]):
        out.append(([Shard(2)], [Shard(2)] * 3 + [None]))
    return out


_flash_attention_op = define_op(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    _flash_attention_impl, lambda q, k, v, causal: torch.empty_like(q),
    flash_attention_flops, _flash_attention_sharding)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The forward alone: K1 on CUDA tensors, ``flash_attention_ref`` on CPU
    ones."""
    return _flash_attention_op(q, k, v, bool(causal))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, g: torch.Tensor):
    """(dq, dk, dv) in the inputs' dtype: the vjp of ``flash_attention_ref``
    against the cotangent ``g``. dk and dv sum over each KV head's query
    heads."""
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(flash_attention_ref(q_, k_, v_, causal),
                                   (q_, k_, v_), g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        out = flash_attention_fwd(q, k, v, causal)
        ctx.placements = getattr(out, "placements", None)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.placements is not None:
            # DTensors: the rule runs on the shards the forward ran on
            from repro_torch.sharding.dtensor import run_local
            pl = ctx.placements
            return (*run_local(
                lambda *t: flash_attention_bwd(*t[:3], ctx.causal, t[3]),
                (q, k, v, g), (pl,) * 4, (pl,) * 3), None)
        return (*flash_attention_bwd(q, k, v, ctx.causal, g), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, T, G, dh), H % G == 0 -> (B, S, H, dh).

    Query row i sees keys j <= i when ``causal``. Ragged S and T are masked
    inside the kernel (no divisibility requirement). Differentiable in q, k
    and v.
    """
    return _FlashAttention.apply(q, k, v, causal)
