"""Training (port of ``repro.train``): AdamW and the train step."""
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         global_norm, init_opt_state, lr_at)
from repro_torch.train.step import (StepConfig, loss_and_grads,
                                    make_eval_step, make_train_step)

__all__ = [
    "OptimizerConfig", "lr_at", "init_opt_state", "global_norm",
    "adamw_update", "StepConfig", "loss_and_grads", "make_train_step",
    "make_eval_step",
]
