from repro_torch.models.common import ParamSpec, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, forward, param_specs, prefill
from repro_torch.models.transformer import init_cache

__all__ = [
    "ModelConfig", "ParamSpec", "init_params", "init_cache", "param_specs",
    "forward", "prefill", "decode_step",
]
