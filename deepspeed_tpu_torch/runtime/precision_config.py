"""fp16 / bf16 config blocks (port of deepspeed_tpu/runtime/precision_config.py)."""

from dataclasses import dataclass

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field


@dataclass
class BF16Config(DeepSpeedConfigModel):
    """bf16 compute over f32 master weights; no loss scaling."""
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclass
class FP16Config(DeepSpeedConfigModel):
    """fp16 + (dynamic) loss scaling, reference fp16/loss_scaler.py semantics."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = config_field(0.0, ge=0.0)  # 0 = dynamic
    initial_scale_power: int = config_field(16, ge=0)
    loss_scale_window: int = config_field(1000, gt=0)
    hysteresis: int = config_field(2, ge=0)
    consecutive_hysteresis: bool = False
    min_loss_scale: float = config_field(1.0, ge=0.0)
    fp16_master_weights_and_grads: bool = False
