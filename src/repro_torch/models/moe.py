"""Fine-grained Mixture-of-Experts FFN (DeepSeekMoE / Qwen3-MoE style), port
of ``repro.models.moe``.

Capacity-based dispatch, as the reference computes it:

  router (fp32) -> top-k -> renormalise -> position-in-expert (choice-major
  cumulative counts) -> drop past capacity -> experts -> combine

Two dispatch modes (``cfg.moe_dispatch``):

* ``"scatter"`` — each kept (token, choice) is added into its own row of an
  (E * cap + 1, D) buffer with ``index_add`` and gathered back with
  ``index_select``; dropped choices all go to the last row, which is
  discarded. Kept rows are unique, so the scatter is exact and deterministic,
  forward and backward.
* ``"einsum"`` — GShard's dense (T, E, cap) dispatch and combine tensors.

``"local"``, the configs' default, is the reference's expert-data-local
dispatch (``_moe_ffn_local``): under sharding rules with a "model" axis
each (data, model) shard routes its own tokens through its own E / TP
experts with no dispatch collective, and the partial outputs are summed
over "model". Without such rules (a plain tensor on one device) it falls
back to ``"scatter"``, as the reference does without a mesh.

Shared (always-on) experts are a plain dense SwiGLU added to the routed
output. Aux load-balance loss: E * sum_e(f_e * p_e) * ``moe_aux_coef``.

While the tracer is enabled, ``moe_ffn`` on one device records the device
span ``moe.dispatch`` (router, top-k, ``plan``, dispatch, gather back and
combine) around ``moe.experts`` (``_expert_compute``); the dispatch's args
are ``choices`` (T·K), ``slots`` (E·cap, the expert bmms' rows) and
``kept`` (the choices within capacity, a device count read later). A
remat's recompute records both again inside the backward.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.common import ParamSpec, swiglu
from repro_torch.models.config import ModelConfig
from repro_torch.obs.tracer import TRACER, trace_span


def moe_param_specs(cfg: ModelConfig, L: int) -> Dict[str, ParamSpec]:
    D, E, F = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    specs = {
        "router": ParamSpec((L, D, E), ("layers", "embed", None)),
        "w_gate": ParamSpec((L, E, D, F), ("layers", "experts", "embed", "mlp")),
        "w_up": ParamSpec((L, E, D, F), ("layers", "experts", "embed", "mlp")),
        "w_down": ParamSpec((L, E, F, D), ("layers", "experts", "mlp", "embed")),
    }
    if cfg.moe_num_shared:
        Fs = cfg.moe_d_ff * cfg.moe_num_shared
        specs.update({
            "sh_gate": ParamSpec((L, D, Fs), ("layers", "embed", "mlp")),
            "sh_up": ParamSpec((L, D, Fs), ("layers", "embed", "mlp")),
            "sh_down": ParamSpec((L, Fs, D), ("layers", "mlp", "embed")),
        })
    return specs


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: the reference's expression, rounded up
    to a multiple of 4, at least 4."""
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    cap = int(np.ceil(T * K / E * cfg.moe_capacity_factor))
    return max(4, ((cap + 3) // 4) * 4)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, in ``jax.lax.top_k``'s order: descending,
    and among equal values the lower index first. (``torch.topk`` orders ties
    otherwise, and the order decides position-in-expert and the drops.)"""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """(T, D) -> (T, E) routing probabilities, in fp32 from fp32 inputs."""
    return torch.softmax(xt.float() @ p["router"].float(), dim=-1)


def _routing(cfg: ModelConfig, p, xt: torch.Tensor):
    """Router + top-k + position-in-expert (shared by both dispatch modes).
    Returns (probs, onehot, gate_idx, gate_vals, pos_in_e, keep, cap)."""
    probs = router_probs(p, xt)
    return plan(cfg, probs, top_k(probs, cfg.moe_top_k)[1])


def plan(cfg: ModelConfig, probs: torch.Tensor, gate_idx: torch.Tensor):
    """The dispatch of given choices ``gate_idx`` (T, K), the k-th column
    each token's k-th choice: renormalised gates, position-in-expert, kept
    choices and capacity, as ``_routing`` returns them."""
    T, E = probs.shape
    K = gate_idx.shape[1]
    gate_vals = probs.gather(1, gate_idx)                        # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)               # renormalise
    cap = capacity(cfg, T)
    onehot = torch.nn.functional.one_hot(gate_idx, E)            # (T, K, E)
    # position-in-expert: counts of earlier choices, choice-major (all
    # tokens' first choices, then all second choices, ...). The counts run
    # along each expert's contiguous row of K * T choices: a scan along the
    # outer axis of (K * T, E) took 449 of deepseek-moe-16b's 612 ms prefill
    # on an H100.
    flat = onehot.permute(2, 1, 0).reshape(E, K * T)
    before = torch.cumsum(flat, dim=1) - flat
    pos_in_e = before.gather(0, gate_idx.t().reshape(1, K * T))
    pos_in_e = pos_in_e.view(K, T).t().to(torch.int32)           # (T, K)
    keep = pos_in_e < cap                                        # drop overflow
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return probs, onehot.float(), gate_idx, gate_vals, pos_in_e, keep, cap


def _expert_compute(cfg: ModelConfig, p, expert_in: torch.Tensor
                    ) -> torch.Tensor:
    """(E, cap, D) -> (E, cap, D) through each expert's SwiGLU."""
    cd = cfg.cdtype
    g = torch.bmm(expert_in, p["w_gate"].to(cd))
    u = torch.bmm(expert_in, p["w_up"].to(cd))
    return torch.bmm(swiglu(g, u), p["w_down"].to(cd))


def _local_tokens_ffn(cfg: ModelConfig, xt: torch.Tensor, router, wg, wu,
                      wd, e0: int, E_loc: int):
    """Route LOCAL tokens xt (T, D) through LOCAL experts [e0, e0 + E_loc)
    (``wg``/``wu`` (E_loc, D, F), ``wd`` (E_loc, F, D)); returns (the partial
    output (T, D), the aux loss). Choices of remote experts contribute zero
    here: their owning model shard computes them, and the caller sums."""
    cd = cfg.cdtype
    T, D = xt.shape
    E = cfg.moe_num_experts
    probs = router_probs({"router": router}, xt)
    _p, onehot, gate_idx, gate_vals, pos_in_e, keep, cap = plan(
        cfg, probs, top_k(probs, cfg.moe_top_k)[1])
    K = gate_idx.shape[1]
    keep = keep & (gate_idx >= e0) & (gate_idx < e0 + E_loc)
    slot = torch.where(keep, (gate_idx - e0) * cap + pos_in_e,
                       E_loc * cap).reshape(T * K)
    upd = xt.to(cd)[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = torch.zeros((E_loc * cap + 1, D), dtype=cd, device=xt.device)
    buf = torch.index_add(buf, 0, slot, upd)
    out = _expert_compute(cfg, {"w_gate": wg, "w_up": wu, "w_down": wd},
                          buf[:-1].view(E_loc, cap, D))
    flat_out = torch.cat([out.reshape(E_loc * cap, D),
                          torch.zeros((1, D), dtype=cd, device=xt.device)])
    y_tk = flat_out.index_select(0, slot).view(T, K, D)
    gates = (gate_vals * keep.to(gate_vals.dtype)).to(cd)
    y = torch.bmm(gates[:, None, :], y_tk).view(T, D)
    # aux load-balance terms from local tokens (the same on every model shard)
    frac = onehot.sum(dim=1).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.moe_aux_coef
    return y, aux


def _moe_ffn_local(cfg: ModelConfig, p, x: torch.Tensor, rules):
    """Expert-data-local dispatch over DTensors: every (data, model) shard
    routes its own tokens (replicated over "model") through its own E / TP
    experts, with no dispatch collective; the routed output leaves as a
    partial sum over "model" (the caller's layout constraint all-reduces
    it, the reference's psum) and aux as a mean over all shards. The
    layer's weights arrive gathered over the data axes (FSDP), so each
    weight's gradient is partial over them, and over "model" where the
    shard saw only its own experts' share."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding.specs import axis_names
    mesh = x.device_mesh
    names = axis_names(mesh)
    m = names.index("model")
    data = [i for i, n in enumerate(names) if n in ("pod", "data")]
    E = cfg.moe_num_experts
    E_loc = E // mesh.size(m)
    cd = cfg.cdtype

    def pl(model, other):
        return [model if i == m else other(i) for i in range(len(names))]

    rows = pl(Replicate(), lambda i: Shard(0) if i in data else Replicate())
    x = x.to(cd).redistribute(mesh, rows)
    x_loc = x.to_local(grad_placements=pl(
        Partial(), lambda i: Shard(0) if i in data else Replicate()))
    weights = []
    for name in ("router", "w_gate", "w_up", "w_down"):
        w = p[name]
        model = Replicate() if name == "router" else Shard(0)
        w = w.redistribute(mesh, pl(model, lambda i: Replicate()))
        weights.append(w.to_local(grad_placements=pl(
            Partial() if name == "router" else Shard(0),
            lambda i: Partial() if i in data else Replicate())))
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    B_loc, S, D = x_loc.shape
    y, aux = _local_tokens_ffn(cfg, x_loc.reshape(B_loc * S, D), *weights,
                               coord[m] * E_loc, E_loc)
    y = DTensor.from_local(y.view(B_loc, S, D), mesh, pl(
        Partial(), lambda i: Shard(0) if i in data else Replicate()),
        run_check=False, shape=tuple(x.shape),
        stride=tuple(x.stride()))
    aux = DTensor.from_local(aux, mesh, [Partial("avg")] * mesh.ndim,
                             run_check=False)
    if cfg.moe_num_shared:
        y = y + swiglu(x @ p["sh_gate"].to(cd),
                       x @ p["sh_up"].to(cd)) @ p["sh_down"].to(cd)
    return y, aux


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Router math in fp32."""
    if cfg.moe_dispatch not in ("scatter", "einsum", "local"):
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    if cfg.moe_dispatch == "local" and hasattr(x, "placements"):
        from repro_torch.sharding.specs import axis_names, current_rules
        rules = current_rules()
        if rules is not None and "model" in axis_names(rules.mesh):
            return _moe_ffn_local(cfg, p, x, rules)
    B, S, D = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    cd = cfg.cdtype
    with trace_span("moe.dispatch", cat="compute", device=True,
                    choices=T * K) as span:
        probs, onehot, gate_idx, gate_vals, pos_in_e, keep, cap = \
            _routing(cfg, p, xt)
        if TRACER.enabled:
            span.annotate(kept=keep.sum(), slots=E * cap)

        if cfg.moe_dispatch in ("scatter", "local"):  # "local" without a mesh
            slot = gate_idx * cap + pos_in_e                         # (T, K)
            slot = torch.where(keep, slot, E * cap).reshape(T * K)   # drop bucket
            upd = xt.to(cd)[:, None, :].expand(T, K, D).reshape(T * K, D)
            buf = torch.zeros((E * cap + 1, D), dtype=cd, device=x.device)
            buf = torch.index_add(buf, 0, slot, upd)
            with trace_span("moe.experts", cat="compute", device=True):
                out = _expert_compute(cfg, p, buf[:-1].view(E, cap, D))
            flat_out = torch.cat([out.reshape(E * cap, D),
                                  torch.zeros((1, D), dtype=cd,
                                              device=x.device)])
            y_tk = flat_out.index_select(0, slot).view(T, K, D)  # gather back
            # einsum("tkd,tk->td"): a product that accumulates in fp32
            y = torch.bmm(gate_vals.to(cd)[:, None, :], y_tk).view(B, S, D)
        else:
            slots = torch.arange(cap, device=x.device)
            pos_oh = (pos_in_e[..., None] == slots).float()      # (T, K, cap)
            dispatch = torch.einsum(
                "tke,tkc->tec", onehot * keep[..., None].float(), pos_oh)
            combine = torch.einsum("tke,tkc->tec",
                                   onehot * gate_vals[..., None], pos_oh)
            expert_in = torch.einsum("td,tec->ecd", xt.to(cd),
                                     dispatch.to(cd))
            with trace_span("moe.experts", cat="compute", device=True):
                out = _expert_compute(cfg, p, expert_in)
            y = torch.einsum("ecd,tec->td", out,
                             combine.to(cd)).reshape(B, S, D)

    if cfg.moe_num_shared:  # shared experts (dense path)
        xs = x.to(cd)
        y = y + swiglu(xs @ p["sh_gate"].to(cd),
                       xs @ p["sh_up"].to(cd)) @ p["sh_down"].to(cd)

    # aux load-balance loss: E * sum_e(mean_t route_frac_e * mean_t prob_e);
    # route_frac counts every choice, dropped ones included
    frac = onehot.sum(dim=1).mean(dim=0)                         # (E,)
    mean_prob = probs.mean(dim=0)                                # (E,)
    aux = E * torch.sum(frac * mean_prob) * cfg.moe_aux_coef
    return y.to(x.dtype), aux
