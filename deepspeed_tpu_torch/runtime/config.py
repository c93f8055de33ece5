"""Master JSON config.

Port of ``deepspeed_tpu/runtime/config.py``: ``DeepSpeedConfig`` parses a
dict or a JSON path, fills the batch-size triangle
(``train_batch_size = micro_batch * gradient_accumulation_steps * dp``),
refuses bf16 together with fp16, and exposes the optimizer, scheduler,
gradient-clipping, ZeRO and ``data_types.grad_accum_dtype`` settings under
the JAX package's attribute names. The port trains on one device, so the
data-parallel size is 1. Keys this port does not read are kept in
``_param_dict`` (as the pydantic models keep extra keys); the engine refuses
the features it does not run.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Union

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime.precision_config import BF16Config, FP16Config
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


@dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "adamw"
    params: dict = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: dict = field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass
class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


def _no_duplicate_keys(pairs):
    d = {}
    for k, v in pairs:
        if k in d:
            raise ValueError(f"Duplicate key in DeepSpeed config: {k}")
        d[k] = v
    return d


class DeepSpeedConfig:
    """Parse and validate a config dict or path (see the module doc)."""

    def __init__(self, config: Union[str, dict]):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Expected a string path to an existing deepspeed config, got {config}")
            with open(config) as f:
                self._param_dict = json.load(f, object_pairs_hook=_no_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = config
        else:
            raise DeepSpeedConfigError(f"Expected a string path or dict, got {type(config)}")
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize_params(self, pd: dict):
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(C.GRADIENT_ACCUMULATION_STEPS)
        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get(C.ZERO_OPTIMIZATION, {}))
        self.bfloat16_config = BF16Config.from_dict(pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})))
        self.fp16_config = FP16Config.from_dict(pd.get(C.FP16, {}))
        if self.fp16_config.enabled and self.bfloat16_config.enabled:
            raise DeepSpeedConfigError("bf16 and fp16 modes cannot be simultaneously enabled")

        opt = pd.get(C.OPTIMIZER)
        self.optimizer_config = OptimizerConfig.from_dict(opt) if opt else None
        sched = pd.get(C.SCHEDULER)
        self.scheduler_config = SchedulerConfig.from_dict(sched) if sched else None
        self.optimizer_name = self.optimizer_config.type.lower() if self.optimizer_config else None
        self.optimizer_params = self.optimizer_config.params if self.optimizer_config else None
        self.scheduler_name = self.scheduler_config.type if self.scheduler_config else None
        self.scheduler_params = self.scheduler_config.params if self.scheduler_config else None

        self.activation_checkpointing_config = ActivationCheckpointingConfig.from_dict(
            pd.get("activation_checkpointing", {}))
        self.data_types_config = DataTypesConfig.from_dict(pd.get(C.DATA_TYPES, {}))
        self.grad_accum_dtype = self.data_types_config.grad_accum_dtype

        self.pipeline_parallel_size = pd.get(C.PIPELINE_PARALLEL_SIZE, 1)
        self.sequence_parallel_size = pd.get(C.SEQUENCE_PARALLEL_SIZE, 1)
        self.tensor_parallel_size = pd.get(C.TENSOR_PARALLEL_SIZE, 1)
        self.expert_parallel_size = pd.get(C.EXPERT_PARALLEL_SIZE, 1)

    def _configure_train_batch_size(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = 1  # one device

        if all(v is not None for v in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            grad_acc = max(1, train_batch // micro_batch // dp)
        elif train_batch is not None and grad_acc is not None:
            micro_batch = max(1, train_batch // dp // grad_acc)
        elif micro_batch is not None and grad_acc is not None:
            train_batch = micro_batch * grad_acc * dp
        elif train_batch is not None:
            grad_acc = 1
            micro_batch = max(1, train_batch // dp)
        elif micro_batch is not None:
            train_batch = micro_batch * dp
            grad_acc = 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        self.train_batch_size = train_batch
        self.train_micro_batch_size_per_gpu = micro_batch
        self.gradient_accumulation_steps = grad_acc

    def _do_sanity_check(self):
        train_batch, micro_batch, grad_acc = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                                              self.gradient_accumulation_steps)
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per gpu: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc, (
            f"Check batch related parameters. train_batch_size is not equal to micro_batch_per_gpu * "
            f"gradient_acc_step * world_size {train_batch} != {micro_batch} * {grad_acc} * 1")
        if self.zero_config.stage > 0 and not (self.fp16_config.enabled or self.bfloat16_config.enabled):
            logger.warning("ZeRO enabled without fp16/bf16; running f32 state")
