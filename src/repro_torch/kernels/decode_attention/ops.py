"""Flash-decode wrapper: CUDA tensor -> ``csrc/decode_attention.cu`` (one
launch: a cluster of CTAs per (batch, kv head) that merge in distributed
shared memory); CPU tensor -> plain. Serving only, no gradient.

Two operators (``kernels/common.define_op``) over the one kernel:

- ``repro_torch::decode_attention``: the whole cache, positions
  ``[0, cur_index]``. Its FLOPs are the reference's dense decode products
  over the whole cache, 4·B·H·T·dh; the kernel reads only the
  ``cur_index + 1`` valid positions. DTensors shard it on batch, and on
  heads where every mesh dim divides both the query and the KV heads.
- ``repro_torch::decode_attention_partial``: positions ``[0, n_valid)`` of a
  (local) cache, returning the normalised output and each head's
  log-sum-exp, 4·B·H·T_local·dh FLOPs. A cache sharded on its positions
  takes it on each device's shard, and the shards are combined by
  all-reduces (``sharding/dtensor.flash_decode``), the reference's
  flash-decode: the cache never moves.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.common import (aligned16, cdiv, define_op, launch,
                                        load, mesh_divides, on_cpu, require)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partial_ref, decode_attention_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"decode_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, ctypes.c_float, _P]}
#: 112 (zamba2-7b's shared block) runs the dh-128 kernel over a zero pad
HEAD_DIMS = (64, 112, 128)
#: query heads a KV head serves: 1, 2 and 4 on the CUDA cores, 8 and 16 as
#: the 16 rows of the tensor cores' mma.sync.m16n8k16 (rows 8-15 zero at 8)
REPS = (1, 2, 4, 8, 16)
#: keys per copy stage; must equal kTile in csrc/decode_attention.cu
TILE = 32
#: CTAs per (batch, kv head) cluster; must equal kMaxCluster there
MAX_CLUSTER = 8


def decode_plan(n_valid: int) -> Tuple[int, int]:
    """``(n_tiles, cluster)`` for ``n_valid`` cache positions: the positions
    cut into tiles of ``TILE`` keys, shared by ``cluster`` CTAs per (batch,
    kv head), each CTA taking at least one tile."""
    n_tiles = cdiv(n_valid, TILE)
    return n_tiles, min(MAX_CLUSTER, n_tiles)


def _check(q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor) -> None:
    """Refuse, by name, what the kernel does not take."""
    B, H, dh = q.shape
    T, G = k_cache.shape[1], k_cache.shape[2]
    require(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
            f"decode_attention kernel takes bfloat16, got {q.dtype}/"
            f"{k_cache.dtype}/{v_cache.dtype}")
    require(tuple(k_cache.shape) == tuple(v_cache.shape) == (B, T, G, dh)
            and H % G == 0 and H // G in REPS,
            f"decode_attention shapes: q {tuple(q.shape)}, cache "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} (H/G in {REPS})")
    require(dh in HEAD_DIMS, f"decode_attention kernel takes head_dim in "
                             f"{HEAD_DIMS}, got {dh}")
    require(q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and aligned16(q, k_cache, v_cache),
            "decode_attention kernel takes contiguous 16-byte aligned tensors")
    require(T > 0, "decode_attention needs a cache of at least one position")


def _launch(q, k_cache, v_cache, n_valid: int, out, lse) -> None:
    """One launch over positions ``[0, n_valid)``, 1 <= n_valid <= T;
    ``lse`` None for the whole-cache form."""
    B, H, dh = q.shape
    T, G = k_cache.shape[1], k_cache.shape[2]
    n_tiles, cluster = decode_plan(n_valid)
    lib = load("decode_attention", _ARGTYPES)
    launch("decode_attention", lib.decode_attention_fwd, q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           out.data_ptr(), None if lse is None else lse.data_ptr(),
           B, T, H, G, dh, n_valid, n_tiles, cluster, 1.0 / math.sqrt(dh))


def _decode_attention_impl(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_index: int
                           ) -> torch.Tensor:
    if on_cpu(q, k_cache, v_cache):
        return decode_attention_ref(q, k_cache, v_cache, cur_index).contiguous()
    _check(q, k_cache, v_cache)
    require(0 <= cur_index, f"cur_index {cur_index} must be >= 0")
    out = torch.empty_like(q)
    _launch(q, k_cache, v_cache, min(cur_index + 1, k_cache.shape[1]), out,
            None)
    return out


def _decode_attention_partial_impl(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor, n_valid: int):
    if on_cpu(q, k_cache, v_cache):
        o, lse = decode_attention_partial_ref(q, k_cache, v_cache, n_valid)
        return o.contiguous(), lse
    _check(q, k_cache, v_cache)
    require(0 <= n_valid <= k_cache.shape[1],
            f"n_valid {n_valid} must lie in [0, {k_cache.shape[1]}]")
    if n_valid == 0:  # no valid position on this shard: no CTA to launch
        return (torch.zeros_like(q),
                torch.full(q.shape[:2], -math.inf, device=q.device))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(q, k_cache, v_cache, n_valid, out, lse)
    return out, lse


def decode_attention_flops(q_shape, k_shape, v_shape, cur_index,
                           out_shape=None, **kw) -> int:
    """q.K and p.V over the whole cache, as the reference's dense decode
    counts them."""
    B, H, dh = q_shape
    return 4 * B * H * k_shape[1] * dh


def decode_attention_partial_flops(q_shape, k_shape, v_shape, n_valid,
                                   out_shape=None, **kw) -> int:
    """q.K and p.V over the whole local cache, as the whole-cache form
    counts them."""
    B, H, dh = q_shape
    return 4 * B * H * k_shape[1] * dh


def _decode_attention_sharding(q, k_cache, v_cache, cur_index):
    """Batch, and heads where each device keeps whole query groups. A
    cache sharded on its positions never reaches this operator: the models
    route it to ``sharding/dtensor.flash_decode``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()], [Replicate()] * 3 + [None]),
           ([Shard(0)], [Shard(0)] * 3 + [None])]
    if mesh_divides(q, q.shape[1], k_cache.shape[2]):
        out.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), None]))
    return out


def _decode_attention_partial_sharding(q, k_cache, v_cache, n_valid):
    """Batch only: ``flash_decode`` calls it on local shards."""
    from torch.distributed.tensor import Replicate, Shard
    return [([Replicate()] * 2, [Replicate()] * 3 + [None]),
            ([Shard(0)] * 2, [Shard(0)] * 3 + [None])]


_decode_attention_op = define_op(
    "decode_attention",
    "(Tensor q, Tensor k_cache, Tensor v_cache, int cur_index) -> Tensor",
    _decode_attention_impl,
    lambda q, k_cache, v_cache, cur_index: torch.empty_like(q),
    decode_attention_flops, _decode_attention_sharding)


_decode_attention_partial_op = define_op(
    "decode_attention_partial",
    "(Tensor q, Tensor k_cache, Tensor v_cache, int n_valid) "
    "-> (Tensor, Tensor)",
    _decode_attention_partial_impl,
    lambda q, k_cache, v_cache, n_valid: (
        torch.empty_like(q),
        q.new_empty(q.shape[:2], dtype=torch.float32)),
    decode_attention_partial_flops, _decode_attention_partial_sharding)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int) -> torch.Tensor:
    """q: (B, H, dh); caches: (B, T, G, dh); cache positions
    ``[0, cur_index]`` are valid (``cur_index`` a host int)."""
    return _decode_attention_op(q, k_cache, v_cache, int(cur_index))


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, n_valid: int):
    """q: (B, H, dh); caches: (B, T, G, dh), positions ``[0, n_valid)``
    attended, ``0 <= n_valid <= T`` (a host int). Returns (o (B, H, dh) in
    q's dtype, lse (B, H) fp32, natural log); ``n_valid == 0`` gives o = 0,
    lse = -inf and launches nothing. ``ref.combine_partials`` merges
    pieces."""
    return _decode_attention_partial_op(q, k_cache, v_cache, int(n_valid))
