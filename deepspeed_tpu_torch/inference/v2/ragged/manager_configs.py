"""Ragged engine configs.

Port of ``deepspeed_tpu/inference/v2/ragged/manager_configs.py`` (KVCacheConfig,
DSStateManagerConfig, AllocationMode) as plain dataclasses with the same
fields, defaults and bounds.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field


class AllocationMode(Enum):
    RESERVE = "reserve"
    ALLOCATE = "allocate"


@dataclass
class KVCacheConfig(DeepSpeedConfigModel):
    block_size: int = 128
    num_allocation_groups: int = config_field(1, gt=0)
    cache_shape: Tuple[int, int, int] = (0, 0, 0)  # (num_layers, num_heads, head_size)
    cache_dtype: str = "bfloat16"
    max_blocks_per_allocation_group: int = config_field(0, ge=0)


@dataclass
class MemoryConfig(DeepSpeedConfigModel):
    mode: AllocationMode = AllocationMode.RESERVE
    size: int = config_field(int(1e9), gt=0)  # bytes reserved / blocks allocated


@dataclass
class DSStateManagerConfig(DeepSpeedConfigModel):
    max_tracked_sequences: int = config_field(2048, gt=0)
    max_ragged_batch_size: int = config_field(768, gt=0)
    max_ragged_sequence_count: int = config_field(512, gt=0)
    max_context: int = config_field(8192, gt=0)
    memory_config: MemoryConfig = config_field(default_factory=MemoryConfig)
    # KV offload to host or disk is ROADMAP A5; the engine refuses it for now
    offload: bool = False
    offload_path: Optional[str] = None
