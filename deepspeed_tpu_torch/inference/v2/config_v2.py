"""Ragged inference engine config.

Port of ``deepspeed_tpu/inference/v2/config_v2.py`` as dataclasses with the
same fields, defaults and aliases (``tp``, ``weight_quantization``, ``ep``,
``manager``; the aliases apply in :meth:`from_dict`). ``trace_enabled`` builds the per-layer tracer
(``tracer.py``). ``telemetry`` is the telemetry block of
``telemetry/config.py``.
"""

from dataclasses import dataclass
from typing import Optional

from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig


@dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    tp_size: int = 1


@dataclass
class DeepSpeedEPConfig(DeepSpeedConfigModel):
    enabled: bool = False
    replica_num: int = 1
    capacity_factor: float = 2.0


@dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    bits: int = 8
    min_size: int = 4096


@dataclass
class RaggedInferenceEngineConfig(DeepSpeedConfigModel):
    """Top-level FastGen engine config."""

    tensor_parallel: DeepSpeedTPConfig = config_field(default_factory=DeepSpeedTPConfig, alias="tp")
    quantization: QuantizationConfig = config_field(default_factory=QuantizationConfig,
                                                    alias="weight_quantization")
    expert_parallel: DeepSpeedEPConfig = config_field(default_factory=DeepSpeedEPConfig, alias="ep")
    state_manager: DSStateManagerConfig = config_field(default_factory=DSStateManagerConfig,
                                                       alias="manager")

    kv_block_size: int = 64
    # CUDA paged-attention kernel: True/False force it; None = auto (CUDA
    # cache, decode buckets; modules/heuristics.py)
    use_paged_kernel: Optional[bool] = None

    simulated_gating: bool = False
    simulated_gating_temperature: float = 1.0
    trace_enabled: bool = False
    max_trace_batches: int = 1024
    """Tracer ring-buffer capacity (batches); beyond it the oldest unconsumed
    trace is dropped — drain via ``engine.tracer.drain_summaries()``."""

    telemetry: TelemetryConfig = config_field(default_factory=TelemetryConfig)
