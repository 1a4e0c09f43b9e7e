"""WKV6 as an autograd Function: CUDA tensor -> ``csrc/wkv6.cu``; CPU tensor
-> plain.

The forward is the operator ``repro_torch::wkv6_fwd``
(``kernels/common.define_op``). Its FLOPs are the recurrence's two
products a step and head, the state update k^T v and the readout r S:
4·B·S·H·dh². DTensors shard it on batch, and on heads where every mesh
dim divides them.

From a zero state, as the Pallas kernel. The backward, ``wkv6_bwd``, is
K4's backward kernel (``wkv6_bwd`` in ``csrc/wkv6.cu``, the chunked form on
the tensor cores) on real CUDA tensors, counted under ``launches["wkv6_bwd"]``,
and on CPU tensors, fake tensors and DTensors over them the plain rule
``wkv6_bwd_plain``, which differentiates ``wkv6_chunked`` at the caller's
chunk: the function the JAX model differentiates
(``src/repro/models/rwkv6.py``). The reference's ``_bwd``
(``src/repro/kernels/wkv6/ops.py``) takes the vjp of the per-step
``wkv6_ref``, the same function. DTensors with shards on the card run the
kernel on the shards.

While the tracer is on, the kernel's call and the backward are device
spans, ``wkv6.forward`` and ``wkv6.backward`` (args ``tokens`` = B·S,
``heads``, ``chunk``; the backward's ``kernel_tokens`` is the B·S K4's
backward took, 0 where the plain rule ran); under per-layer remat
``wkv6.forward`` opens twice a layer, in the forward and in the recompute
inside the backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (aligned16, cdiv, define_op, launch,
                                        load, mesh_divides, on_cpu, require)
from repro_torch.kernels.wkv6.ref import wkv6_chunked
from repro_torch.obs.tracer import trace_span

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"wkv6_fwd": [_P] * 7 + [_I] * 5 + [_P],
             "wkv6_bwd": [_P] * 15 + [_I] * 5 + [_P]}
CHUNK = 64  # the kernels' chunk of tokens (csrc/wkv6.cu kC)
HEAD_DIMS = (16, 64)  # rwkv6-3b's smoke and full heads
DTYPES = (torch.bfloat16, torch.float32)


def _wkv6_impl(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, chunk: int):
    if on_cpu(r, k, v, w, u):
        return wkv6_chunked(r, k, v, w, u, chunk)
    _require_takes(r, k, v, w, u)
    B, S, H, dh = r.shape
    require(all(t.is_contiguous() for t in (r, k, v, w, u)),
            "wkv6 kernel takes contiguous tensors")
    require(aligned16(r, k, v, w),
            "wkv6 kernel copies 16 bytes at a time: r, k, v, w must be "
            "16-byte aligned")
    y = torch.empty_like(r)
    state = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    lib = load("wkv6", _ARGTYPES)
    launch("wkv6", lib.wkv6_fwd, r.device, r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
           state.data_ptr(), B, S, H, dh, int(r.dtype == torch.bfloat16))
    return y, state


def wkv6_flops(r_shape, k_shape, v_shape, w_shape, u_shape, chunk,
               out_shape=None, **kw) -> int:
    B, S, H, dh = r_shape
    return 4 * B * S * H * dh * dh


def _wkv6_fake(r, k, v, w, u, chunk):
    B, S, H, dh = r.shape
    return torch.empty_like(r), r.new_empty((B, H, dh, dh),
                                            dtype=torch.float32)


def _wkv6_sharding(r, k, v, w, u, chunk):
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate(), Replicate()], [Replicate()] * 5 + [None]),
           ([Shard(0), Shard(0)], [Shard(0)] * 4 + [Replicate(), None])]
    if mesh_divides(r, r.shape[2]):
        out.append(([Shard(2), Shard(1)], [Shard(2)] * 4 + [Shard(0), None]))
    return out


_wkv6_op = define_op(
    "wkv6_fwd",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, int chunk) "
    "-> (Tensor, Tensor)",
    _wkv6_impl, _wkv6_fake, wkv6_flops, _wkv6_sharding)


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, chunk: int):
    """The forward alone: K4 on CUDA tensors, ``wkv6_chunked`` on CPU ones."""
    return _wkv6_op(r, k, v, w, u, int(chunk))


def _require_takes(r, k, v, w, u):
    """Refuse what K4 (forward or backward) does not take."""
    B, S, H, dh = r.shape
    require(r.dtype in DTYPES and r.dtype == k.dtype == v.dtype == w.dtype,
            f"wkv6 kernel takes r, k, v, w all bfloat16 or all float32, got "
            f"{r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}")
    require(tuple(k.shape) == tuple(v.shape) == tuple(w.shape) == (B, S, H, dh)
            and S >= 1, f"wkv6 shapes: r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, w {tuple(w.shape)}")
    require(u.dtype == torch.float32 and tuple(u.shape) == (H, dh),
            f"wkv6 u must be float32 of shape ({H}, {dh}), got {u.dtype} "
            f"{tuple(u.shape)}")
    require(dh in HEAD_DIMS, f"wkv6 kernel takes head_dim in {HEAD_DIMS}, "
                             f"got {dh}")


def takes_kernel(*tensors: torch.Tensor) -> bool:
    """True if K4's backward runs on these: real tensors on one CUDA device.
    CPU and fake tensors (the dry run's), and DTensors whose shards are
    either, take the plain rule; a mix of devices raises."""
    from torch._subclasses.fake_tensor import FakeTensor
    shards = [t.to_local() if hasattr(t, "placements") else t for t in tensors]
    if any(isinstance(t, FakeTensor) for t in shards):
        return False
    return not on_cpu(*shards)


def wkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, chunk: int,
                   g: torch.Tensor):
    """(dr, dk, dv, dw, du), each in its input's dtype: the vjp of
    ``wkv6_chunked``'s y at ``chunk`` against the cotangent ``g``."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (r, k, v, w, u))
        return torch.autograd.grad(wkv6_chunked(*ins, chunk)[0], ins, g)


def wkv6_bwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """K4's backward on CUDA tensors: (dr, dk, dv, dw, du) as
    ``wkv6_bwd_plain`` returns them, from one ``wkv6_bwd`` call (four
    launches, no host sync). ``g`` must be in r's dtype and shape, and is
    made contiguous; the rest must be as the forward takes them."""
    _require_takes(r, k, v, w, u)
    B, S, H, dh = r.shape
    require(tuple(g.shape) == (B, S, H, dh) and g.dtype == r.dtype,
            f"wkv6 cotangent must be {r.dtype} of shape {(B, S, H, dh)}, got "
            f"{g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    require(all(t.is_contiguous() for t in (r, k, v, w, u)),
            "wkv6 kernel takes contiguous tensors")
    require(aligned16(r, k, v, w, g),
            "wkv6 kernel copies 16 bytes at a time: r, k, v, w and the "
            "cotangent must be 16-byte aligned")
    nc = cdiv(S, CHUNK)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    states, dstates = (torch.empty((B, H, nc, dh, dh), dtype=torch.float32,
                                   device=r.device) for _ in range(2))
    cross, du_part = (torch.empty((B, H, nc, dh), dtype=torch.float32,
                                  device=r.device) for _ in range(2))
    lib = load("wkv6", _ARGTYPES)
    launch("wkv6_bwd", lib.wkv6_bwd, r.device,
           *(t.data_ptr() for t in (r, k, v, w, g, u, dr, dk, dv, dw, du, states,
                                    dstates, cross, du_part)),
           B, S, H, dh, int(r.dtype == torch.bfloat16))
    return dr, dk, dv, dw, du


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, chunk: int, g: torch.Tensor):
    """(dr, dk, dv, dw, du), each in its input's dtype, of y against the
    cotangent ``g``: K4's backward on real CUDA tensors (it ignores
    ``chunk``: the same function at any chunk, up to rounding), the plain
    rule on the rest."""
    if takes_kernel(r, k, v, w, u, g):
        return wkv6_bwd_kernel(r, k, v, w, u, g)
    return wkv6_bwd_plain(r, k, v, w, u, chunk, g)


def _span(name: str, r: torch.Tensor, chunk: int, **args):
    """The device span of one call or rule over r (B, S, H, dh)."""
    B, S, H, _ = r.shape
    return trace_span(name, cat="compute", device=True, tokens=B * S, heads=H,
                      chunk=chunk, **args)


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        with _span("wkv6.forward", r, chunk):
            y, state = wkv6_fwd(r, k, v, w, u, chunk)
        ctx.mark_non_differentiable(state)
        ctx.placements = getattr(y, "placements", None)
        return y, state

    @staticmethod
    def backward(ctx, g, _g_state):
        saved = ctx.saved_tensors
        B, S = saved[0].shape[:2]
        kernel = takes_kernel(*saved, g)
        with _span("wkv6.backward", saved[0], ctx.chunk,
                   kernel_tokens=B * S if kernel else 0):
            if ctx.placements is None:
                return (*wkv6_bwd(*saved, ctx.chunk, g), None)
            # DTensors: the rule runs on the shards the forward ran on; u's
            # gradient sums over the batch, partial where the batch shards
            from torch.distributed.tensor import Partial, Replicate, Shard
            from repro_torch.sharding.dtensor import run_local
            pl = ctx.placements
            u_pl = tuple(Shard(0) if p.is_shard(2) else Replicate()
                         for p in pl)
            du_pl = tuple(Partial() if p.is_shard(0) else q
                          for p, q in zip(pl, u_pl))
            return (*run_local(
                lambda *t: wkv6_bwd(*t[:5], ctx.chunk, t[5]),
                (*saved, g), (pl,) * 4 + (u_pl, pl),
                (pl,) * 4 + (du_pl,)), None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int):
    """r/k/v/w: (B, S, H, dh), w the per-step decay in (0, 1); u: (H, dh)
    fp32. Returns (y (B, S, H, dh) in r's dtype, state (B, H, dh, dh) fp32).

    ``chunk`` sets the plain version's blocks of steps; the kernel's chunk
    (64 tokens) and sub-chunk (16) are fixed in ``csrc/wkv6.cu``, the same
    function up to its TF32 products' rounding. y is differentiable in r, k,
    v, w and u; the final state is not (no caller trains through it).
    """
    return _WKV6.apply(r, k, v, w, u, chunk)
