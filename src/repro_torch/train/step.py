"""Step functions (port of ``repro.train.step``): train (microbatched grad
accumulation), prefill, decode and eval, plus the input specs of the dry run.

``make_train_step`` builds (params, opt_state, batch) -> (params, opt_state,
metrics):

  * batch (GB, S) is cut into ``microbatches`` of GB / n rows; each one's
    grads are summed into an accumulator of ``grad_accum_dtype`` (with one
    microbatch the grads are only cast to fp32);
  * the AdamW update runs once on the accumulated grads, in place.

While the tracer is enabled the step records device spans (category
``compute``): ``train.step`` over the call, and inside it
``train.forward`` (``loss_fn``), ``train.backward`` (the grads, their cast
to fp32 or their accumulation) for each microbatch, then
``train.optimizer`` (``adamw_update``, the global norm included; its args
``elems``, ``kernel_elems`` and ``launches`` count the parameter elements
updated, those in K5's update tables and K5's launches).

The step runs where the parameters and the batch lie: on the card every
RMSNorm, attention and WKV6 forward launches its kernel (K2, K1, K4), their
backward is the reference's recompute-and-differentiate rule, and AdamW is
K5.

The same step runs over DTensors in the dry run (``launch/dryrun.py``): a
DTensor batch sharded on its rows gives each device the same share of every
microbatch, the rows of its own shard (the reference's reshape to
(n_micro, GB / n_micro) keeps the data axes on the rows the same way).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.adamw.ops import counts as adamw_counts
from repro_torch.kernels.common import launches
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.obs.tracer import TRACER, trace_span
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         optimizer_counts)


@dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    frontend_prefix: int = 0   # P positions of precomputed embeddings
    # Gradient accumulation dtype across microbatches: float32 is the
    # faithful default; bfloat16 halves the accumulator (an accuracy trade)
    grad_accum_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Input specs (meta tensors; the dry run's only "data")
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                kind: str, frontend_prefix: int = 0) -> Dict[str, Any]:
    """Abstract model inputs for (arch x shape): {name: (meta tensor,
    logical axes)}, the reference's shapes, dtypes and axes."""
    B, S = global_batch, seq_len
    out: Dict[str, Any] = {}
    tok_shape = (B, S, cfg.num_codebooks) if cfg.family == "audio" else (B, S)
    if kind == "decode":
        tok_shape = (B, cfg.num_codebooks) if cfg.family == "audio" else (B,)
    out["tokens"] = (torch.empty(tok_shape, dtype=torch.int32, device="meta"),
                     ("batch",) + (None,) * (len(tok_shape) - 1))
    if cfg.frontend != "none" and kind != "decode":
        P = frontend_prefix or max(16, min(256, S // 8))
        out["frontend_embeds"] = (
            torch.empty((B, P, cfg.d_model), dtype=torch.float32,
                        device="meta"),
            ("batch", None, None))
    return out


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows [i·GB/n, (i+1)·GB/n) of ``x``; of a DTensor sharded on its rows,
    the i-th n-th of each device's own rows."""
    if not hasattr(x, "placements"):
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    rows = local.shape[0] // n
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return DTensor.from_local(
        local[i * rows:(i + 1) * rows], x.device_mesh, x.placements,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _forward(cfg: ModelConfig, params, batch: Dict):
    """(leaves requiring grad, loss, loss metrics) of ``loss_fn`` at
    ``params``; the parameters' own ``requires_grad`` is left alone."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = M.loss_fn(cfg, live, batch)
    return tree_leaves(live), loss, metrics


def loss_and_grads(cfg: ModelConfig, params, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """(loss, loss metrics, grads tree) of ``loss_fn`` at ``params``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)``; the parameters' own
    ``requires_grad`` is left alone."""
    leaves, loss, metrics = _forward(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    step_cfg: StepConfig = StepConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` as
    0-d tensors (no host sync). ``params`` and the moments are updated in
    place."""
    n_micro = step_cfg.microbatches
    acc_dt = getattr(torch, step_cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        GB = batch["tokens"].shape[0]
        if GB % n_micro:
            raise ValueError(f"global batch {GB} does not split into "
                             f"{n_micro} microbatches")
        with trace_span("train.step", cat="compute", device=True):
            micro = [{k: _microbatch(v, i, n_micro) for k, v in batch.items()}
                     for i in range(n_micro)]

            if n_micro > 1:
                grads = None
                loss_sum = aux_sum = 0.0
                for mb in micro:
                    with trace_span("train.forward", cat="compute", device=True):
                        leaves, loss, metrics = _forward(cfg, params, mb)
                    with trace_span("train.backward", cat="compute",
                                    device=True):
                        g_mb = torch.autograd.grad(loss, leaves)
                        if grads is None:
                            grads = tree_map(
                                lambda p: torch.zeros_like(p, dtype=acc_dt),
                                params)
                        for acc, g in zip(tree_leaves(grads), g_mb):
                            acc.add_(g.to(acc_dt))
                        del g_mb
                        if mb is micro[-1]:
                            for acc in tree_leaves(grads):
                                acc.div_(n_micro)
                    loss_sum = loss_sum + loss.detach()
                    aux_sum = aux_sum + metrics["aux_loss"].detach()
            else:
                with trace_span("train.forward", cat="compute", device=True):
                    leaves, loss_sum, metrics = _forward(cfg, params, micro[0])
                with trace_span("train.backward", cat="compute", device=True):
                    grads = tree_map(
                        lambda g: g.float(),
                        tree_unflatten(params, torch.autograd.grad(loss_sum,
                                                                   leaves)))
                loss_sum = loss_sum.detach()
                aux_sum = metrics["aux_loss"].detach()

            with trace_span("train.optimizer", cat="compute",
                            device=True) as span:
                launched, tabled = launches["adamw"], adamw_counts["elems"]
                params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                     opt_state)
                if TRACER.enabled:
                    span.annotate(**optimizer_counts(
                        params, launches["adamw"] - launched,
                        adamw_counts["elems"] - tabled))
            metrics = {"loss": loss_sum / n_micro,
                       "aux_loss": aux_sum / n_micro, **om}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch, cache=None):
        return M.prefill(cfg, params, batch, cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, state, tokens, pos):
        return M.decode_step(cfg, params, state, tokens, pos)
    return decode_step


# ---------------------------------------------------------------------------
# Eval step
# ---------------------------------------------------------------------------

def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(cfg, params, batch)
    return eval_step

