"""ZeRO: the config, the placement rule, the parameter partitioner and
``TiledLinear`` (``runtime/zero/tiling.py``)."""

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (GatheredParameters, Init, ZeroPartitioner,
                                                                   register_external_parameter,
                                                                   unregister_external_parameter)
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

__all__ = ["DeepSpeedZeroConfig", "GatheredParameters", "Init", "TiledLinear", "ZeroPartitioner",
           "ZeroShardingPolicy", "register_external_parameter", "unregister_external_parameter"]

