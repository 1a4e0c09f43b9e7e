"""Mamba2 (SSD) blocks + Zamba2-style hybrid assembly (port of
``repro.models.mamba2``).

SSD recurrence per head (state N x P, N = ssm_state, P = head dim):

    H_t = a_t * H_{t-1} + (dt_t * B_t) outer x_t        a_t = exp(-dt_t * A_h)
    y_t = C_t^T H_t + D_h * x_t

computed with the chunked algorithm (within-chunk decay-weighted attention via
the scalar-decay matrix, cross-chunk state scan); all exponents <= 0.

Zamba2 hybrid: ``num_layers`` Mamba2 blocks with ONE shared transformer block
(GQA attention + SwiGLU, single weight copy) invoked after every
``attn_every``-th Mamba2 block — 81 = 13 x 6 + 3 for zamba2-7b. The shared
block's per-invocation LoRA adapters are omitted, as in the reference; each
invocation keeps its own KV cache during decode.

Weights keep the JAX layouts and leaf paths: ``mamba`` leaves carry the
leading "layers" axis, ``shared_attn`` leaves have none. The scans become
Python loops over layer slices; with ``cfg.remat`` a training forward runs
each Mamba2 layer under ``torch.utils.checkpoint`` and each group of
``attn_every`` layers plus the shared block under another, nested as the
reference nests ``jax.checkpoint``. The SSD scan and the causal conv are
plain tensor code, as the reference leaves them to XLA (no Pallas kernel);
every RMSNorm goes through ``common.rms_norm`` (K2 on CUDA), the shared
block's prefill and training attention through ``common.attention`` (K1)
and its decode attention through ``common.decode_attention`` (K3).

Decode runs ``mamba_block`` on one token, which pads it to a whole chunk in
``ssd_chunked``, as the reference does; ``ssd_step`` is the single-token
recurrence beside it. The decode state is updated in place: the shared
block writes the new token's K/V at ``pos`` and then attends over
``[0, pos]``, the function both JAX ``decode_cache_mode``s compute.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ParamSpec, attention, cache_update,
                                       decode_attention, embed_lookup,
                                       gather_weights, layer_slices, remat,
                                       resolve_device, rms_norm, rope_angles,
                                       with_logical_constraint)
from repro_torch.models.config import ModelConfig


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg: ModelConfig) -> int:
    # channels passing through the causal depthwise conv: x, B, C
    return d_inner(cfg) + 2 * cfg.ssm_state


def mamba_param_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    Din = d_inner(cfg)
    N = cfg.ssm_state
    Hs = n_ssm_heads(cfg)
    Dc = conv_dim(cfg)
    return {
        "norm": ParamSpec((L, D), ("layers", "embed"), init="ones"),
        # projections: z (gate), x, B, C, dt
        "in_proj": ParamSpec((L, D, 2 * Din + 2 * N + Hs),
                             ("layers", "embed", "mlp")),
        "conv_w": ParamSpec((L, cfg.ssm_conv, Dc), ("layers", None, None),
                            init="normal", init_scale=0.5),
        "conv_b": ParamSpec((L, Dc), ("layers", None), init="zeros"),
        "A_log": ParamSpec((L, Hs), ("layers", None), init="zeros"),
        "D_skip": ParamSpec((L, Hs), ("layers", None), init="ones"),
        "dt_bias": ParamSpec((L, Hs), ("layers", None), init="zeros"),
        "out_norm": ParamSpec((L, Din), ("layers", "mlp"), init="ones"),
        "out_proj": ParamSpec((L, Din, D), ("layers", "mlp", "embed")),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    specs = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed",
                           init_scale=0.02),
        "mamba": mamba_param_specs(cfg, L),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        "unembed": ParamSpec((D, V), ("embed", "vocab")),
    }
    if cfg.attn_every:
        # one shared transformer block (single copy, L=1 then squeezed)
        shared = tfm.layer_param_specs(cfg, L=1)
        specs["shared_attn"] = {
            k: ParamSpec(v.shape[1:], v.logical_axes[1:], v.dtype, v.init,
                         v.init_scale)
            for k, v in shared.items()
        }
    return specs


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, a_log, Bc, Cc, D_skip, chunk: int, state0=None):
    """Chunked SSD scan, fp32 math.

    x: (B, S, Hs, P); dt: (B, S, Hs); a_log = log a_t = -dt * A (B, S, Hs);
    Bc/Cc: (B, S, N); D_skip: (Hs,). Returns (y in x's dtype, contiguous;
    state (B, Hs, N, P) fp32). S is padded to a whole number of chunks
    (zero dt and a_log: the padding neither adds to the state nor decays
    it). The within-chunk terms of all chunks are computed at once; only
    the state carried from chunk to chunk is a loop, as the reference's
    ``lax.scan`` carries it.
    """
    if hasattr(x, "placements"):
        return _ssd_sharded(x, dt, a_log, Bc, Cc, D_skip, chunk, state0)
    B, S, Hs, P = x.shape
    N = Bc.shape[-1]
    xf, dtf, laf = x.float(), dt.float(), a_log.float()
    Bf, Cf = Bc.float(), Cc.float()
    pad = (-S) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf, laf = (F.pad(t, (0, 0, 0, pad)) for t in (dtf, laf))
        Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    n = (S + pad) // chunk
    xc = xf.view(B, n, chunk, Hs, P).transpose(2, 3)             # (B,n,H,C,P)
    dtc = dtf.view(B, n, chunk, Hs).transpose(2, 3)              # (B,n,H,C)
    ca = laf.view(B, n, chunk, Hs).transpose(2, 3).cumsum(-1)    # inclusive
    Bcc = Bf.view(B, n, chunk, N)                                # (B,n,C,N)
    Ccc = Cf.view(B, n, chunk, N)

    # within a chunk: the s-th input reaches t (s <= t) decayed by
    # prod_{j=s+1..t} a_j = exp(ca_t - ca_s)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = (ca[..., :, None] - ca[..., None, :]).masked_fill(~mask, -torch.inf)
    cb = Ccc @ Bcc.transpose(-1, -2)                             # (B,n,C,C)
    M = cb[:, :, None] * torch.exp(diff) * dtc[..., None, :]     # (B,n,H,C,C)
    y = M @ xc                                                   # (B,n,H,C,P)
    # each chunk's own contribution to the state it passes on:
    # sum_s exp(ca_C - ca_s) dt_s B_s x_s^T
    kdec = torch.exp(ca[..., -1:] - ca) * dtc                    # (B,n,H,C)
    contrib = (Bcc[:, :, None] * kdec[..., None]).transpose(-1, -2) @ xc
    decay = torch.exp(ca[..., -1])                               # (B,n,H)
    state = (torch.zeros(B, Hs, N, P, dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    entering = []
    for c in range(n):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + contrib[:, c]
    # across chunks: y_t += C_t^T (exp(ca_t) * S_entering)
    y = y + (Ccc[:, :, None] @ torch.stack(entering, 1)) * torch.exp(ca)[..., None]
    y = y.transpose(2, 3).reshape(B, n * chunk, Hs, P)[:, :S]
    y = y + D_skip[None, None, :, None] * xf[:, :S]
    return y.to(x.dtype).contiguous(), state


def _ssd_sharded(x, dt, a_log, Bc, Cc, D_skip, chunk, state0):
    """``ssd_chunked`` of DTensors, on each device's shard: the batch as
    the data axes split it, the heads over "model" where it divides them
    (else replicated there). B and C, shared by the heads, and D_skip get
    partial gradients where their work is split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.dtensor import run_local
    from repro_torch.sharding.specs import axis_names
    mesh = x.device_mesh
    Hs = x.shape[2]
    batch = [p.is_shard(0) for p in x.placements]
    heads = [not batch[i] and name == "model" and Hs % mesh.size(i) == 0
             for i, name in enumerate(axis_names(mesh))]

    def pl(on_batch, on_heads, other=Replicate()):
        return tuple(on_batch if batch[i] else on_heads if heads[i] else other
                     for i in range(mesh.ndim))

    R = Replicate()
    ins = [pl(Shard(0), Shard(2)), pl(Shard(0), Shard(2)),
           pl(Shard(0), Shard(2)), pl(Shard(0), R), pl(Shard(0), R),
           pl(R, Shard(0))]
    grads = ins[:3] + [pl(Shard(0), Partial()), pl(Shard(0), Partial()),
                       pl(Partial(), Shard(0))]
    args = [x, dt, a_log, Bc, Cc, D_skip]
    if state0 is not None:
        args.append(state0)
        ins.append(pl(Shard(0), Shard(1)))
        grads.append(ins[-1])
    return run_local(lambda *t: ssd_chunked(*t[:6], chunk, *t[6:]), args,
                     ins, (pl(Shard(0), Shard(2)), pl(Shard(0), Shard(1))),
                     grads)


def ssd_step(x, dt, a_log, Bc, Cc, D_skip, state):
    """Single-token SSD recurrence. x: (B,Hs,P); dt/a_log: (B,Hs); Bc/Cc:
    (B,N); state: (B,Hs,N,P). Returns (y in x's dtype, the new state)."""
    xf, dtf = x.float(), dt.float()
    a = torch.exp(a_log.float())                                 # (B,Hs)
    upd = torch.einsum("bh,bn,bhp->bhnp", dtf, Bc.float(), xf)
    new_state = a[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", Cc.float(), new_state)
    y = y + D_skip[None, :, None] * xf
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(cfg, proj):
    Din, N = d_inner(cfg), cfg.ssm_state
    z = proj[..., :Din]
    xin = proj[..., Din:2 * Din]
    Bc = proj[..., 2 * Din:2 * Din + N]
    Cc = proj[..., 2 * Din + N:2 * Din + 2 * N]
    dt = proj[..., 2 * Din + 2 * N:]
    return z, xin, Bc, Cc, dt


def _causal_conv(seq, w, b):
    """Depthwise causal conv along time. seq: (B, S, Dc); w: (K, Dc)."""
    K, S = w.shape[0], seq.shape[1]
    # zeros before the sequence by a concatenation: DTensor's rule for
    # ``F.pad`` in torch 2.11 gives a one-dim layout on a 2-D mesh
    pad = torch.cat([torch.zeros_like(seq[:, :1])] * (K - 1) + [seq], dim=1)
    out = sum(pad[:, i:i + S] * w[i][None, None] for i in range(K))
    return out + b[None, None]


def mamba_block(cfg: ModelConfig, lp, h, conv_state=None, ssd_state=None,
                return_state: bool = False):
    """h: (B, S, D) -> block output; optionally carries decode states.

    The new conv state is the last ``ssm_conv - 1`` conv inputs, zeros
    before the sequence standing in where S is shorter (the reference
    slices what there is)."""
    cd = cfg.cdtype
    B, S, _ = h.shape
    Hs, P, N, K = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    lp = gather_weights(lp)
    x = rms_norm(h, lp["norm"], cfg.norm_eps)
    proj = x @ lp["in_proj"].to(cd)
    z, xin, Bc, Cc, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    w, b = lp["conv_w"].to(cd), lp["conv_b"].to(cd)
    if conv_state is not None:
        full = torch.cat([conv_state.to(cd), conv_in], dim=1)
        conv_out = _causal_conv(full, w, b)[:, -S:]
    else:
        full = conv_in
        conv_out = _causal_conv(conv_in, w, b)
    if return_state and full.shape[1] < K - 1:
        full = F.pad(full, (0, 0, K - 1 - full.shape[1], 0))
    conv_out = F.silu(conv_out)
    Din = d_inner(cfg)
    xs = conv_out[..., :Din].reshape(B, S, Hs, P)
    Bc = conv_out[..., Din:Din + N]
    Cc = conv_out[..., Din + N:]
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float()[None, None])
    A = torch.exp(lp["A_log"].float())                           # (Hs,)
    a_log = -dt * A[None, None]
    y, new_ssd = ssd_chunked(xs, dt, a_log, Bc, Cc, lp["D_skip"].float(),
                             cfg.ssm_chunk, state0=ssd_state)
    # a row sharded over "mlp" stays sharded: K2 takes its all-reduced mean
    # square, as the reference's norm reduces the shards' partial sums
    y = rms_norm(y.view(B, S, Din), lp["out_norm"], cfg.norm_eps) * F.silu(z)
    out = y @ lp["out_proj"].to(cd)
    if return_state:
        return out, (full[:, -(K - 1):], new_ssd)
    return out


# ---------------------------------------------------------------------------
# Zamba2 hybrid forward
# ---------------------------------------------------------------------------

def _hybrid_schedule(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, per_group, tail): L = groups * per_group + tail; the shared
    attention block runs after each full group."""
    if not cfg.attn_every:
        return 0, 0, cfg.num_layers
    g = cfg.num_layers // cfg.attn_every
    return g, cfg.attn_every, cfg.num_layers - g * cfg.attn_every


def _invocation(cfg: ModelConfig, i: int):
    """The index of the shared block's invocation that follows Mamba2 layer
    ``i``, or None (the tail layers, or no shared block)."""
    groups, per_group, _tail = _hybrid_schedule(cfg)
    if groups and (i + 1) % per_group == 0:
        return (i + 1) // per_group - 1
    return None


def _mamba_slices(cfg: ModelConfig, params):
    """Each Mamba2 layer's parameters: views into the stacked leaves."""
    return layer_slices({"layers": params["mamba"]}, cfg.num_layers)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return cos[None], sin[None]                                  # (1, S, dh/2)


def _shared_attn_block(cfg: ModelConfig, sp, h, cos, sin):
    """The shared transformer block over a sequence: (h, k, v); k/v feed
    the invocation's KV cache."""
    sp = gather_weights(sp)
    x = rms_norm(h, sp["attn_norm"], cfg.norm_eps)
    q, k, v = tfm._qkv(cfg, sp, x, cos, sin)
    h = _settle(h + tfm._attn_out(cfg, sp, attention(q, k, v, causal=True)))
    x = rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
    return _settle(h + tfm.dense_ffn(cfg, sp, x)), k, v


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(cfg.cdtype)


def _unembed(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ gather_weights(params["unembed"]).to(cfg.cdtype)


def _settle(h: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout between blocks (the reference pins it
    after each Mamba2 layer and the shared block; the port also after the
    shared attention, where DTensor would leave partial sums pending)."""
    return with_logical_constraint(h, ("batch", "seq_res", None))


def _mamba_layer(cfg: ModelConfig, lp, h):
    return _settle(h + mamba_block(cfg, lp, h))


def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval forward pass. Returns (logits, aux_loss = 0). tokens:
    (B, S)."""
    h = _embed(cfg, params, tokens)
    groups, per_group, _tail = _hybrid_schedule(cfg)
    layers = _mamba_slices(cfg, params)
    layer = remat(cfg, _mamba_layer)
    if groups:
        cos, sin = _rope(cfg, torch.arange(h.shape[1], device=h.device))

        def group_body(hh, *gp):
            for lp in gp:
                hh = layer(cfg, lp, hh)
            return _shared_attn_block(cfg, params["shared_attn"], hh, cos, sin)[0]

        group = remat(cfg, group_body)
        for g in range(groups):
            h = group(h, *layers[g * per_group:(g + 1) * per_group])
        layers = layers[groups * per_group:]
    for lp in layers:
        h = layer(cfg, lp, h)
    return _unembed(cfg, params, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# Decode state, prefill, decode
# ---------------------------------------------------------------------------

def init_state_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """name -> (shape, dtype): each Mamba2 layer's conv and SSD states and,
    with a shared block, each invocation's KV cache of ``max_seq``
    positions."""
    L = cfg.num_layers
    Hs, P, N, Dc = (n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state,
                    conv_dim(cfg))
    groups, _pg, _tail = _hybrid_schedule(cfg)
    specs = {
        "conv": ((L, batch, cfg.ssm_conv - 1, Dc), cfg.cdtype),
        "ssd": ((L, batch, Hs, N, P), torch.float32),
    }
    if groups:
        shape = (groups, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        specs["attn_k"] = (shape, cfg.cdtype)
        specs["attn_v"] = (shape, cfg.cdtype)
    return specs


#: the name the family dispatch (``models.model``) reads
state_specs = init_state_specs


def init_state(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt)
            in init_state_specs(cfg, batch, max_seq).items()}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, state=None):
    """Forward over the prompt. Returns (last-position logits, decode state):
    Mamba2 conv/SSD states per layer + per-invocation KV caches for the
    shared block.

    Without ``state`` one is allocated with caches of S positions (the
    reference's); with one (caches of any length T >= S, e.g. preallocated
    for serving) it is written in place — every conv and SSD state whole,
    cache positions [0, S) — and the same dict is returned.
    """
    h = _embed(cfg, params, tokens)
    B, S = tokens.shape
    if state is None:
        state = {k: torch.empty(shape, dtype=dt, device=h.device)
                 for k, (shape, dt) in init_state_specs(cfg, B, S).items()}
    if "attn_k" in state and state["attn_k"].shape[2] < S:
        raise ValueError(f"cache holds {state['attn_k'].shape[2]} positions, "
                         f"prompt has {S}")
    cos, sin = _rope(cfg, torch.arange(S, device=h.device))
    for i, lp in enumerate(_mamba_slices(cfg, params)):
        out, (conv_s, ssd_s) = mamba_block(cfg, lp, h, return_state=True)
        h = _settle(h + out)
        state["conv"][i] = conv_s
        state["ssd"][i] = ssd_s
        g = _invocation(cfg, i)
        if g is not None:
            h, k, v = _shared_attn_block(cfg, params["shared_attn"], h, cos, sin)
            state["attn_k"][g, :, :S] = k
            state["attn_v"][g, :, :S] = v
    # RMSNorm is per row, so only the last position is normed and unembedded
    return _unembed(cfg, params, h[:, -1:].contiguous())[:, 0], state


def decode_step(cfg: ModelConfig, params, state, tokens: torch.Tensor,
                pos: int):
    """One-token decode: Mamba2 recurrent states + shared-attn KV caches,
    all updated in place.

    tokens: (B,) int; pos: host int — the current position. Returns
    (logits, state).
    """
    pos = int(pos)
    h = _embed(cfg, params, tokens[:, None])                     # (B, 1, D)
    cos, sin = _rope(cfg, torch.full((1,), pos, device=h.device))
    sp = params.get("shared_attn")
    for i, lp in enumerate(_mamba_slices(cfg, params)):
        out, (conv_s, ssd_s) = mamba_block(
            cfg, lp, h, conv_state=state["conv"][i],
            ssd_state=state["ssd"][i], return_state=True)
        h = _settle(h + out)
        state["conv"][i] = conv_s
        state["ssd"][i] = ssd_s
        g = _invocation(cfg, i)
        if g is not None:
            # shared attention with this invocation's KV cache
            sp = gather_weights(sp)
            x = rms_norm(h, sp["attn_norm"], cfg.norm_eps)
            q, k, v = tfm._qkv(cfg, sp, x, cos, sin)
            kc, vc = state["attn_k"][g], state["attn_v"][g]
            cache_update(kc, k, pos)
            cache_update(vc, v, pos)
            out = decode_attention(q[:, 0], kc, vc, pos)[:, None]
            h = _settle(h + tfm._attn_out(cfg, sp, out))
            x = rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
            h = _settle(h + tfm.dense_ffn(cfg, sp, x))
    return _unembed(cfg, params, h)[:, 0], state
