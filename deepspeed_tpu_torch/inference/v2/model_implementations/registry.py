"""Inference-v2 model policy registry.

Port of ``deepspeed_tpu/inference/v2/model_implementations/registry.py`` for
the llama family (llama, mistral, qwen2). Mixtral and the generic decoder
models are ROADMAP A9.
"""

from typing import Dict, Tuple

from deepspeed_tpu_torch.inference.v2.model_implementations.llama_v2 import (LlamaV2Model, MistralV2Model,
                                                                             Qwen2V2Model)
from deepspeed_tpu_torch.models.llama import LlamaConfig

_BY_CONFIG: Dict[type, type] = {}
_BY_NAME: Dict[str, Tuple[type, type]] = {}


def register_policy(model_type: str, config_cls, model_cls) -> None:
    _BY_NAME[model_type] = (config_cls, model_cls)
    # config-class dispatch falls back on model_type when one config class
    # serves several model types (llama family)
    _BY_CONFIG.setdefault(config_cls, model_cls)


def model_cls_for(model_config) -> type:
    mt = getattr(model_config, "model_type", None)
    if mt in _BY_NAME:
        return _BY_NAME[mt][1]
    for cfg_cls, model_cls in _BY_CONFIG.items():
        if isinstance(model_config, cfg_cls):
            return model_cls
    raise ValueError(f"no inference-v2 policy for {type(model_config).__name__} "
                     f"(model_type={mt!r}); known: {sorted(_BY_NAME)}")


register_policy("llama", LlamaConfig, LlamaV2Model)
register_policy("mistral", LlamaConfig, MistralV2Model)
register_policy("qwen2", LlamaConfig, Qwen2V2Model)
