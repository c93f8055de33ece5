"""ZeRO configuration.

Port of ``deepspeed_tpu/runtime/zero/config.py`` (``DeepSpeedZeroConfig`` and
the offload blocks) as dataclasses, with the same field names, defaults and
aliases. The engine partitions stages 1-3 over the data-parallel ranks
(``runtime/zero/policy.py``, ``partition_parameters.py``); with one rank
every stage runs the same math. ``offload_optimizer`` (``runtime/zero/
offload.py``) and the ZeRO++ knobs (qwZ, qgZ, hpZ, MiCS) are read as the
reference reads them: ``ratio`` lies in [0, 1], and the deprecated
``cpu_offload`` / ``cpu_offload_param`` only warn (the reference's
``set_new_param`` is False for both: they set nothing).
"""

import enum
from dataclasses import dataclass
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field


class OffloadDeviceEnum(str, enum.Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = config_field(5, ge=0)
    buffer_size: int = config_field(int(1e8), ge=0)
    max_in_cpu: int = config_field(int(1e9), ge=0)
    pin_memory: bool = False


@dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = config_field(4, ge=0)
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = config_field(1.0, ge=0.0, le=1.0)


@dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: int = config_field(0, ge=0)
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = config_field(int(5e8), ge=0)
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = config_field(int(5e8), ge=0)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None

    sub_group_size: int = config_field(int(1e9), ge=0)
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    cpu_offload: Optional[bool] = None

    prefetch_bucket_size: int = config_field(int(5e7), ge=0, alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = config_field(int(1e5), ge=0, alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = config_field(int(9223372036854775807), ge=0,
                                                    alias="stage3_model_persistence_threshold")
    max_live_parameters: int = config_field(int(1e9), ge=0, alias="stage3_max_live_parameters")
    max_reuse_distance: int = config_field(int(1e9), ge=0, alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = config_field(False,
                                                            alias="stage3_gather_16bit_weights_on_model_save")

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    zero_hpz_partition_size: int = config_field(1, ge=0)
    zero_quantized_weights: bool = False
    zero_quantized_weights_bits: int = 8
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False

    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    def __post_init__(self):
        super().__post_init__()
        from deepspeed_tpu_torch.utils.logging import logger
        for old, new in (("cpu_offload", "offload_optimizer"), ("cpu_offload_param", "offload_param"),
                         ("cpu_offload_use_pin_memory", None)):
            if getattr(self, old) is not None:
                logger.warning(f"Config parameter {old} is deprecated" + (f" use {new} instead" if new else ""))
        if self.stage > 3:
            raise ValueError(f"DeepSpeedZeroConfig.stage={self.stage} must be <= 3")
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3
