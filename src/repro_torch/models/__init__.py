from repro_torch.models.common import ParamSpec, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_state_specs, decode_step, forward,
                                      init_decode_state, loss_fn, param_specs,
                                      prefill)

__all__ = [
    "ModelConfig", "ParamSpec", "init_params", "param_specs",
    "forward", "loss_fn", "prefill", "decode_step", "decode_state_specs",
    "init_decode_state",
]
