"""Step functions (port of ``repro.train.step``): train (microbatched grad
accumulation) and eval.

``make_train_step`` builds (params, opt_state, batch) -> (params, opt_state,
metrics):

  * batch (GB, S) is cut into ``microbatches`` of GB / n rows; each one's
    grads are summed into an fp32 accumulator (with one microbatch the grads
    are only cast to fp32);
  * the AdamW update runs once on the accumulated grads, in place.

The step runs where the parameters and the batch lie: on the card every
RMSNorm, attention and WKV6 forward launches its kernel (K2, K1, K4), and
their backward is the reference's recompute-and-differentiate rule.
``input_specs``, the GSPMD dry run's stand-in, waits for the sharding port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptimizerConfig, adamw_update


@dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1


def loss_and_grads(cfg: ModelConfig, params, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """(loss, loss metrics, grads tree) of ``loss_fn`` at ``params``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)``; the parameters' own
    ``requires_grad`` is left alone."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = M.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    step_cfg: StepConfig = StepConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``loss``, ``aux_loss``, ``grad_norm`` and ``lr`` as
    0-d tensors (no host sync). ``params`` and the moments are updated in
    place."""
    n_micro = step_cfg.microbatches

    def train_step(params, opt_state, batch):
        GB = batch["tokens"].shape[0]
        if GB % n_micro:
            raise ValueError(f"global batch {GB} does not split into "
                             f"{n_micro} microbatches")
        micro = [{k: v[i * (GB // n_micro):(i + 1) * (GB // n_micro)]
                  for k, v in batch.items()} for i in range(n_micro)]

        if n_micro > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = aux_sum = 0.0
            for mb in micro:
                loss, metrics, g_mb = loss_and_grads(cfg, params, mb)
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_mb)):
                    acc.add_(g)
                del g_mb
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + metrics["aux_loss"]
            for acc in tree_leaves(grads):
                acc.div_(n_micro)
        else:
            loss_sum, metrics, grads = loss_and_grads(cfg, params, micro[0])
            grads = tree_map(lambda g: g.float(), grads)
            aux_sum = metrics["aux_loss"]

        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss_sum / n_micro, "aux_loss": aux_sum / n_micro,
                   **om}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Eval step
# ---------------------------------------------------------------------------

def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(cfg, params, batch)
    return eval_step

