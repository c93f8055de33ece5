"""Inference-v2 model policy registry.

Port of ``deepspeed_tpu/inference/v2/model_implementations/registry.py``:
the llama family (llama, mistral, qwen2), mixtral, and the decoder family
(opt, falcon, phi, gptj, gpt_neox), registered by config class and by
``model_type``. Bloom (ALiBi) is not registered: ``DecoderV2Model`` refuses
it rather than serve wrong logits, and GPT-Neo, which reaches it through
the config class, too (C23).
"""

from typing import Dict, Tuple

from deepspeed_tpu_torch.inference.v2.model_implementations.decoder_v2 import DecoderV2Model
from deepspeed_tpu_torch.inference.v2.model_implementations.llama_v2 import (LlamaV2Model, MistralV2Model,
                                                                             Qwen2V2Model)
from deepspeed_tpu_torch.inference.v2.model_implementations.mixtral_v2 import MixtralV2Model
from deepspeed_tpu_torch.models.decoder import DecoderConfig
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig

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
register_policy("mixtral", MixtralConfig, MixtralV2Model)
for _model_type in ("opt", "falcon", "phi", "gptj", "gpt_neox"):
    register_policy(_model_type, DecoderConfig, DecoderV2Model)


def supported_model_types():
    return sorted(_BY_NAME)
