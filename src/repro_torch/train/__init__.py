"""Training (port of ``repro.train``): AdamW and the train step.

Its names load on first use: the host modules that import
``repro_torch.train.checkpoint`` (the RunManifest, fsck, the ops CLI, the
chaos harness) so start without torch.
"""
import importlib

_EXPORTS = {
    "OptimizerConfig": "optimizer", "lr_at": "optimizer",
    "init_opt_state": "optimizer", "global_norm": "optimizer",
    "adamw_update": "optimizer", "StepConfig": "step",
    "loss_and_grads": "step", "make_train_step": "step",
    "make_eval_step": "step", "make_prefill_step": "step",
    "make_decode_step": "step", "input_specs": "step",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
