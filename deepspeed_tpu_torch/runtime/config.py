"""Master JSON config.

Port of ``deepspeed_tpu/runtime/config.py``: ``DeepSpeedConfig`` parses a
dict or a JSON path, fills the batch-size triangle
(``train_batch_size = micro_batch * gradient_accumulation_steps * dp``, dp
the data-parallel ranks),
refuses bf16 together with fp16, and exposes the optimizer, scheduler,
gradient-clipping, ZeRO, ``data_types.grad_accum_dtype``, ``checkpoint``,
``nebula``, ``anomaly_sentinel`` and ``telemetry`` settings, the timers'
``steps_per_print`` and ``wall_clock_breakdown``, and the raw
``compression_training``, ``data_efficiency``, ``curriculum_learning``,
``eigenvalue`` and ``progressive_layer_drop`` blocks (their owners parse
them) and the ``comms_logger`` block under the JAX package's attribute names
and defaults. The data-parallel size is the rank mesh's
(``utils/groups.py``), or the process group's before the engine builds the
mesh, or 1 without one. Keys this port does not read are kept in
``_param_dict`` (as the pydantic models keep extra keys); the engine refuses
the features it does not run.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Union

from deepspeed_tpu_torch.comm.config import CommsConfig
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.runtime.precision_config import BF16Config, FP16Config
from deepspeed_tpu_torch.runtime.sentinel import AnomalySentinelConfig
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig
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
class CheckpointConfig(DeepSpeedConfigModel):
    tag_validation: str = C.CHECKPOINT_TAG_VALIDATION_DEFAULT
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = field(default_factory=dict)

    keep_last_k: int = config_field(0, ge=0)
    """Retention: keep the newest K tags after each commit (0: all). The
    newest manifest-sealed tag is never deleted."""

    array_checksums: bool = True
    """Record a CRC32 of every saved tensor in the manifest."""

    verify_on_load: bool = True
    """Verify the manifest (file sizes and CRC32s) before restoring; with
    ``tag=None`` a torn or corrupt tag falls back loudly to the newest good
    one."""

    verify_arrays_on_load: bool = False
    """Also re-checksum every restored tensor against the manifest."""

    preemption_grace_s: float = config_field(30.0, gt=0)
    """Budget between a preemption signal and exit: finish the step, drain
    an async save, write the final synchronous checkpoint."""

    gang_seal_timeout_s: float = config_field(60.0, gt=0)
    """How long rank 0 waits for every rank's shard seal (accepted; unused
    with one rank)."""


@dataclass
class NebulaConfig(DeepSpeedConfigModel):
    """``nebula`` block: ``enabled`` makes ``save_checkpoint`` asynchronous."""
    enabled: bool = False


@dataclass
class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


@dataclass
class AioConfig(DeepSpeedConfigModel):
    """``aio`` block: the native async-IO engine that NVMe offload swaps
    through (``ops/aio``)."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


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
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = pd.get(C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)

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

        self.checkpoint_config = CheckpointConfig.from_dict(pd.get(C.CHECKPOINT, {}))
        self.checkpoint_tag_validation_enabled = self.checkpoint_config.tag_validation != "Ignore"
        self.checkpoint_tag_validation_fail = self.checkpoint_config.tag_validation == "Fail"
        self.nebula_config = NebulaConfig.from_dict(pd.get(C.NEBULA, {}))
        self.anomaly_sentinel_config = AnomalySentinelConfig.from_dict(pd.get(C.ANOMALY_SENTINEL, {}))
        self.telemetry_config = TelemetryConfig.from_dict(pd.get(C.TELEMETRY, {}))
        self.comms_config = CommsConfig.from_dict(pd.get("comms_logger", {}))
        self.aio_config = AioConfig.from_dict(pd.get("aio", {}))

        # blocks their owners parse (compression/, runtime/data_pipeline/,
        # runtime/eigenvalue.py, runtime/progressive_layer_drop.py)
        self.compression_config = pd.get(C.COMPRESSION_TRAINING, {})
        self.data_efficiency_config = pd.get(C.DATA_EFFICIENCY, {})
        self.curriculum_enabled_legacy = bool(pd.get(C.CURRICULUM_LEARNING, {}).get("enabled", False))
        self.curriculum_params_legacy = pd.get(C.CURRICULUM_LEARNING, {})
        self.eigenvalue_enabled = bool(pd.get(C.EIGENVALUE, {}).get("enabled", False))
        self.progressive_layer_drop = pd.get(C.PROGRESSIVE_LAYER_DROP, {})
        self.pld_enabled = bool(self.progressive_layer_drop.get("enabled", False))

        self.pipeline_parallel_size = pd.get(C.PIPELINE_PARALLEL_SIZE, 1)
        self.sequence_parallel_size = pd.get(C.SEQUENCE_PARALLEL_SIZE, 1)
        self.tensor_parallel_size = pd.get(C.TENSOR_PARALLEL_SIZE, 1)
        self.expert_parallel_size = pd.get(C.EXPERT_PARALLEL_SIZE, 1)

    def _data_parallel_size(self):
        """The data-parallel degree: the rank mesh's when it exists, else the
        world's ranks over the model-parallel degrees (the reference's
        ``_data_parallel_size``, with ranks for devices)."""
        from deepspeed_tpu_torch.utils import groups
        if groups.mesh_is_initialized():
            return groups.get_data_parallel_world_size()
        import torch.distributed as tdist
        n = tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1
        return max(1, n // (self.tensor_parallel_size * self.pipeline_parallel_size * self.sequence_parallel_size))

    def _configure_train_batch_size(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = self._data_parallel_size()

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
        dp = self._data_parallel_size()
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per gpu: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * dp, (
            f"Check batch related parameters. train_batch_size is not equal to micro_batch_per_gpu * "
            f"gradient_acc_step * world_size {train_batch} != {micro_batch} * {grad_acc} * {dp}")
        if self.zero_config.stage > 0 and not (self.fp16_config.enabled or self.bfloat16_config.enabled):
            logger.warning("ZeRO enabled without fp16/bf16; running f32 state")
