"""Shared model substrate (port of ``repro.models.common``): parameter specs,
init, norms, RoPE, attention, the loss, remat.

Conventions follow the JAX package: parameters are nested dicts of tensors
whose leaves are first declared as ``ParamSpec``s; per-layer parameters
carry a leading "layers" axis; compute runs in ``cfg.compute_dtype`` and
parameters are stored in ``cfg.param_dtype``. Layouts at every public
function are the JAX ones — q ``(B, S, H, dh)``, k/v ``(B, T, G, dh)`` — so
the two packages compare like with like.

``with_logical_constraint`` returns a plain tensor as it is; under
``sharding.specs.use_rules`` it redistributes a DTensor (the dry run) to the
rules' placements, where the reference pins GSPMD's layout. ``cache_update``
is an in-place write.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another one. Raises when CUDA is asked for (or defaulted to)
    and no card is present — there is no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"        # normal | zeros | ones | embed
    init_scale: float = 1.0     # multiplies the fan-in init stddev

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes {self.logical_axes}")


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List:
    """Leaves of a nested dict in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: List):
    """The nested dict of ``like``'s structure holding ``leaves``, given in
    ``tree_leaves`` order."""
    return _unflatten(like, iter(leaves))


def _unflatten(tree, it):
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, and one holding ``it`` kept the
    # leaves (a step's gradients) alive until the cycle collector ran
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def init_param(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if spec.init == "embed":
        return (x * spec.init_scale).to(spec.dtype)
    # fan-in scaled normal: fan-in = product of all dims but the last (output)
    # one, not counting the scan ("layers") dim
    dims = [s for s, a in zip(spec.shape, spec.logical_axes) if a != "layers"]
    fan_in = int(np.prod(dims[:-1])) if len(dims) > 1 else max(1, dims[0])
    std = spec.init_scale / np.sqrt(max(1, fan_in))
    return (x * std).to(spec.dtype)


def init_params(specs, seed: int = 0, device=None):
    """Materialize a ParamSpec tree from one seeded ``torch.Generator``.

    The same fan-in scaled normals as the JAX package, but not its random
    stream: parity tests hand JAX weights over through ``repro_torch.convert``.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return init_param(tree, gen, dev)

    return build(specs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in x.dtype (kernel K2 on CUDA)."""
    return rms_ops.rmsnorm(x, scale, eps)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]``, as ``F.embedding``: the one lookup DTensor
    shards as a vocab-parallel table (an index of a sharded table would be
    gathered first)."""
    out = F.embedding(tokens, gather_weights(table))
    # a vocab-sharded table's rows arrive as partial sums: settle them
    return with_logical_constraint(out, ("batch",) + (None,) * (out.ndim - 1))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., n_heads, head_dim); cos/sin broadcastable to (..., 1, head_dim//2).
    Rotates the two halves (half-split), not interleaved pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, G, dh) -> (B, T, H, dh) by repeating each KV head H//G times."""
    G = x.shape[2]
    if G == n_heads:
        return x
    return x.repeat_interleave(n_heads // G, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Plain attention; materializes (S, T) scores. The CPU path of
    ``attention``, rounding where the JAX ``dense_attention`` rounds."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    kh = repeat_kv(k, H)
    vh = repeat_kv(v, H)
    scores = torch.einsum("bshd,bthd->bhst", q, kh).float()
    scores = scores * (1.0 / math.sqrt(dh))
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where((qpos >= kpos)[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """GQA attention: the flash-attention kernel (K1) on CUDA tensors and
    on DTensors (the dry run models the card's program on any device),
    ``dense_attention`` on CPU tensors. ``cfg.attention_impl`` picks nothing
    here: each device has one attention."""
    if hasattr(q, "placements"):
        from repro_torch.sharding.dtensor import repeat_kv_for
        k, v = repeat_kv_for(q, k, v)
    if q.is_cuda or hasattr(q, "placements"):
        return fa_ops.flash_attention(q, k, v, causal=causal)
    return dense_attention(q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int) -> torch.Tensor:
    """Single-token attention against a KV cache (kernel K3 on CUDA).

    q: (B, H, dh); caches: (B, T, G, dh); cur_index: host int (tokens valid
    in [0, cur_index]). A DTensor cache sharded on its positions takes the
    reference's flash-decode (``sharding.dtensor.flash_decode``: K3's
    partial form on each shard, combined by all-reduces)."""
    if hasattr(k_cache, "placements") and any(
            p.is_shard(1) for p in k_cache.placements):
        from repro_torch.sharding.dtensor import flash_decode
        return flash_decode(q, k_cache, v_cache, cur_index)
    return decode_ops.decode_attention(q, k_cache, v_cache, cur_index)


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write ``new`` (B, 1, G, dh) into ``cache`` (B, T, G, dh) at sequence
    position ``pos``, in place (the JAX version returns a new cache)."""
    if hasattr(cache, "placements"):
        from repro_torch.sharding.dtensor import cache_update_local
        return cache_update_local(cache, new, pos)
    cache[:, pos] = new[:, 0].to(cache.dtype)


def split_heads_ready(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y`` (..., n·dh) ready to be viewed as (..., n, dh): a plain tensor
    as it is, a DTensor through ``sharding.dtensor.heads_ready``."""
    if not hasattr(y, "placements"):
        return y
    from repro_torch.sharding.dtensor import heads_ready
    return heads_ready(y, n)


def gather_weights(tree):
    """FSDP's all-gather of a layer's weights before they are used: under
    active rules each DTensor leaf is gathered over the data axes (the
    reference's GSPMD does so inside the layer scan, and again in the
    rematerialized backward); a plain tensor or dict is returned as is.
    Takes a tensor or a dict of them."""
    leaf = next(iter(tree.values())) if isinstance(tree, dict) else tree
    if not hasattr(leaf, "placements"):
        return tree
    from repro_torch.sharding.dtensor import gather_data_axes
    return tree_map(gather_data_axes, tree)


def with_logical_constraint(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """The reference's sharding constraint: a DTensor under active rules
    is redistributed to their placements; anything else is returned as is."""
    if not hasattr(x, "placements"):
        return x
    from repro_torch.sharding.specs import current_rules
    rules = current_rules()
    return x if rules is None else rules.constrain(x, logical_axes)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE. logits (..., V); labels (...) int; fp32 logsumexp.

    The label logit is a ``gather``, where the JAX version sums a one-hot:
    the same function, without a (tokens, V) fp32 one-hot on the card.
    """
    if hasattr(logits, "placements"):
        from repro_torch.sharding.dtensor import vocab_parallel_cross_entropy
        return vocab_parallel_cross_entropy(logits, labels, mask)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def remat(cfg, layer: Callable) -> Callable:
    """``layer`` run under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    set and grad is enabled (the counterpart of ``jax.checkpoint`` with
    ``nothing_saveable``): its activations, the bf16 weight casts included,
    are recomputed in the backward instead of kept."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer
    return functools.partial(torch.utils.checkpoint.checkpoint, layer,
                             use_reentrant=False)


def layer_slices(params, n: int) -> List[Dict[str, torch.Tensor]]:
    """The first ``n`` layers' parameters: views into the stacked "layers"
    leaves, each leaf unbound once. (Indexing each leaf per layer would make
    the backward write a zero-filled leaf-sized gradient per layer and leaf;
    ``unbind``'s backward stacks the slices in one pass.)"""
    names = sorted(params["layers"])
    cols = [params["layers"][k].unbind(0)[:n] for k in names]
    return [dict(zip(names, vals)) for vals in zip(*cols)]


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up
