"""Flash-decode wrapper: CUDA tensor -> ``csrc/decode_attention.cu`` (one
launch: a cluster of CTAs per (batch, kv head) that merge in distributed
shared memory); CPU tensor -> plain. Serving only, no gradient."""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels.common import (aligned16, cdiv, launch, load, on_cpu,
                                        require)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"decode_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, ctypes.c_float, _P]}
HEAD_DIMS = (64, 128)
REPS = (1, 2, 4, 8)
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int) -> torch.Tensor:
    """q: (B, H, dh); caches: (B, T, G, dh); cache positions
    ``[0, cur_index]`` are valid (``cur_index`` a host int)."""
    cur_index = int(cur_index)
    if on_cpu(q, k_cache, v_cache):
        return decode_attention_ref(q, k_cache, v_cache, cur_index)
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
    require(0 <= cur_index and T > 0, f"cur_index {cur_index} must be >= 0")
    n_valid = min(cur_index + 1, T)
    n_tiles, cluster = decode_plan(n_valid)
    out = torch.empty_like(q)
    lib = load("decode_attention", _ARGTYPES)
    launch("decode_attention", lib.decode_attention_fwd, q.device,
           q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           out.data_ptr(), B, T, H, G, dh, n_valid, n_tiles, cluster,
           1.0 / math.sqrt(dh))
    return out
