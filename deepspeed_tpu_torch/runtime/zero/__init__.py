"""ZeRO: the config, the placement rule and the parameter partitioner.
``TiledLinear`` (``runtime/zero/tiling.py``) comes with the second half of
ROADMAP A8."""

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (GatheredParameters, Init, ZeroPartitioner,
                                                                   register_external_parameter,
                                                                   unregister_external_parameter)
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy

__all__ = ["DeepSpeedZeroConfig", "GatheredParameters", "Init", "ZeroPartitioner", "ZeroShardingPolicy",
           "register_external_parameter", "unregister_external_parameter"]


def __getattr__(name):
    if name == "TiledLinear":
        raise NotImplementedError("runtime/zero/tiling.py (TiledLinear) is not ported to deepspeed_tpu_torch yet "
                                  "(see ROADMAP.md A8, second half)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
