"""The training engine.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``), on one
GPU or over data-parallel ranks (below). The public API and the arithmetic
are the JAX engine's:

- f32 master weights (``engine.params``, a name -> tensor dict), an
  optimizer state, a loss-scale state and the lr schedule, set up as
  ``__init__`` does there (a schedule with ``last_batch_iteration == -1`` is
  stepped once at init);
- the micro-step API ``forward`` / ``backward`` / ``step``, and the fused
  ``train_batch``: the global batch is split into ``[gas, micro, ...]``, each
  micro-batch's gradients of ``loss * scale`` are summed in the accumulation
  dtype, and one apply divides by ``scale * gas``, checks finiteness (fp16,
  or any precision with the anomaly sentinel on), takes the global norm,
  clips, runs the optimizer and updates the scale; ``train_batch`` returns
  the mean of the micro losses;
- a step that is not finite (an fp16 overflow, or a NaN/inf step under the
  sentinel) changes neither the weights, the optimizer state nor the
  schedule, and counts as skipped;
- checkpoint save and load (``runtime/checkpoint_engine``: a manifest sealed
  last, keep-last-K retention, a loud fallback past torn or corrupt tags,
  async commit under ``nebula.enabled``), preemption handling
  (``install_preemption_handler``: a final checkpoint, ``PREEMPTED.json``,
  then :class:`TrainingPreempted`), the anomaly sentinel and the training
  fault injector (``DSTPU_TRAIN_FAULTS``);
- progressive layer drop (θ advanced at each boundary), the compression
  scheduler (its transforms applied to the masters at their offsets, behind
  the eigenvalue gate where asked), the eigenvalue probe
  (``loss_curvature``), legacy curriculum learning (sequence truncation),
  the data-efficiency accessors and random-LTD's scheduler, training
  telemetry (step gauges and events, a span a ``train_batch``, the timers'
  spans) and ``stage_train_batch`` for ``runtime.dataloader.PrefetchingLoader``.

The model runs in the compute dtype (bf16, fp16 or f32): its parameters are
the master weights cast once per optimizer step, and each micro-step's
gradients with respect to them are cast to the accumulation dtype. That is
the JAX engine's gradient of the loss through the master -> compute cast
(whose backward casts the cotangent to f32), without a cast per micro-step.

Data parallelism: the engine joins the gang (``comm.init_distributed``,
from the launcher's environment), lays the ranks out as the rank mesh
(``utils/groups.py``), and takes the global batch, as the reference does:
each data rank trains on its contiguous dim-0 chunk of every micro-batch
(where ``_batch_sharding`` places it there), the gradients are averaged over
the ranks, and the reported loss and the clipping norm are the gang's. The
ZeRO stages partition the state over the ranks by the reference's placement
rule (``runtime/zero/policy.py``), moved by hand over ``comm``'s collectives
(``runtime/zero/partition_parameters.py``): stage 1 the optimizer state,
stage 2 also the gradient-accumulation buffer (reduce-scattered each
micro-step), stage 3 also the parameters (gathered layer by layer). With one
rank nothing is partitioned and every stage runs the same math.

ZeRO-Offload (``zero_optimization.offload_optimizer``, or the
``cpuadam`` optimizer): the optimizer state rests in pinned host memory or
on a local disk between steps and its update runs on the host
(``runtime/zero/offload.py``, ``runtime/swap_tensor``); ``stage_in`` and
``stage_out`` wrap every update. ZeRO++: qgZ reduces each micro-step's
gradients as int8 blocks (``runtime/comm/quantized_grads.py``), qwZ
all-gathers stage-3 weights as int8 or int4 (``runtime/zero/qwz.py``), and
hpZ / MiCS split the data dimension into ``(data, hpz)`` and partition
within the secondary group (``utils/groups.py``). Pipeline parallelism is
``runtime/pipe/engine.py``'s ``PipelineEngine``, one process a stage.

Model, sequence and expert ranks (the rest of the mesh's axes, reference
``engine.py:166-190``): ``tensor_parallel_size`` builds the ``model`` axis
and ``initialize(param_specs=...)`` (``module_inject/auto_tp.py``'s
placements) swaps the module's linears and embeddings for this rank's
shards (``module_inject/layers.py``); ``sequence_parallel_size`` builds the
``seq`` axis, each batch leaf's dim 1 is chunked over it (a leaf the ranks
do not divide stays whole, as ``_batch_sharding`` replicates it), and the
gradients are summed over data × seq; ``expert_parallel_size`` builds the
``expert`` axis, carved from the data ranks: each rank holds its experts'
banks, whose gradients are summed (and whose ZeRO state is partitioned)
over the expert-data group only (the data and sequence ranks:
``groups.EXPERT_ZERO_AXES``). The axes compose: one mesh holds all of them
at once (TP with Ulysses, TP or Ulysses of a MoE model, expert ranks at
ZeRO 3), and ZeRO partitions a tensor-parallel shard or an expert bank on
top of its placement, never on its placed dimension (reference
``zero/policy.py::_add_zero_axes``). Replicated parameters are never
summed over ``model``, and no token is counted twice across model ranks:
they hold the same tokens, and the loss, the token count and the MoE gate
span data x expert x seq only.

A checkpoint taken across model, sequence or expert ranks holds every
array in its global layout, as a world-1 checkpoint does (rank 0 writes
what the ranks gather), so it loads at any other mesh or at world 1.

The loss of a step across data or sequence ranks is the reference's global
token mean: the count of valid labels of each micro-batch is summed over
the ranks that average their losses before the forward, and
``models/llama.py::cross_entropy_loss`` returns this rank's share of the
whole batch's mean (``global_token_mean``); a loss term that is global
already (Mixtral's router loss) is left alone.

What still raises ``NotImplementedError`` names ROADMAP A8 item 5 (model,
sequence or expert ranks with the pipeline, hpZ, MiCS, qgZ or offload;
checkpoints of hpZ/MiCS partitions and pipeline stages). The monitor and the
flops profiler are A9: where the JAX engine calls them, this one does
nothing.
"""

import contextlib
import itertools
import json
import os
import signal
import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.compression.compress import init_compression
from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler
from deepspeed_tpu_torch.models.convert import reference_names
from deepspeed_tpu_torch.models.llama import IGNORE_INDEX, LlamaModel, global_token_mean
from deepspeed_tpu_torch.module_inject.layers import apply_tensor_parallel
from deepspeed_tpu_torch.moe.layer import ExpertFFN, MoE
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import DeepSpeedCPUAdam, FusedAdam
from deepspeed_tpu_torch.ops.adam.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.ops.adam.zero_one_adam import ZeroOneAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.lamb.onebit_lamb import OnebitLamb
from deepspeed_tpu_torch.ops.lion.fused_lion import FusedLion
from deepspeed_tpu_torch.ops.sgd.sgd import SGD
from deepspeed_tpu_torch.runtime import sentinel as _sentinel_mod
from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (PREEMPT_MARKER, CheckpointCorruptionError,
                                                                  checkpoint_barrier, close_async_checkpointer,
                                                                  list_tags, load_engine_state, save_engine_state)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import recompute_disabled
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import RandomLTDScheduler
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, FusedHostBatch, StagedBatch
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, block_hvp
from deepspeed_tpu_torch.runtime.faults import injector_from_env
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (dynamic_loss_scale_state, static_loss_scale_state,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule_class
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.utils import cast_tree, clip_grads_by_global_norm, tree_all_finite
from deepspeed_tpu_torch.runtime.comm.quantized_grads import QuantizedGradReducer, qgz_supported
from deepspeed_tpu_torch.runtime.zero.offload import NvmeOffloadPlan, OptimizerOffloadPlan
from deepspeed_tpu_torch.runtime.zero.partition_parameters import ZeroPartitioner, snapshot_and_clear_init_demand
from deepspeed_tpu_torch.runtime.zero.qwz import QuantizedWeightGather, qwz_supported
from deepspeed_tpu_torch.elasticity.gang import GangHeartbeat
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_MICRO_TIMER, FORWARD_MICRO_TIMER, STEP_MICRO_TIMER,
                                             TRAIN_BATCH_TIMER, NoopTimer, SynchronizedWallClockTimer,
                                             ThroughputTimer)

_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


class TrainingPreempted(SystemExit):
    """Raised after a preemption's final checkpoint committed: exits with
    code 143 (the SIGTERM convention), so a supervisor can tell a clean
    preemption from a crash. Carries the final checkpoint's ``tag`` (None
    when no save directory was known) and the ``step``."""

    EXIT_CODE = 143

    def __init__(self, tag, step):
        super().__init__(self.EXIT_CODE)
        self.tag = tag
        self.step = step


def _make_optimizer(name, params_cfg):
    """The reference's names (``engine.py:69-105``). Type Adam means AdamW
    unless ``adam_w_mode`` is false; type AdamW always decouples."""
    name = (name or "adamw").lower()
    cfg = dict(params_cfg or {})
    cfg.pop("torch_adam", None)
    if name in ("adam", "adamw", "fusedadam"):
        awm = cfg.pop("adam_w_mode", True)
        if name == "adamw":
            awm = True
        return FusedAdam(adam_w_mode=awm, **cfg)
    classes = {"cpuadam": DeepSpeedCPUAdam, "onebitadam": OnebitAdam, "onebitlamb": OnebitLamb,
               "zerooneadam": ZeroOneAdam, "lamb": FusedLamb, "fusedlamb": FusedLamb, "lion": FusedLion,
               "fusedlion": FusedLion, "adagrad": DeepSpeedCPUAdagrad, "sgd": SGD}
    if name not in classes:
        raise ValueError(f"Unknown optimizer {name!r}")
    return classes[name](**cfg)


def _unsupported(cfg: DeepSpeedConfig, stages: int):
    """Configured features this engine does not run, each with the ROADMAP
    queue item that ports it (A8 item 5). ``stages`` is the engine's
    pipeline stage count: a ``pipeline_parallel_size`` above 1 runs only as
    a ``PipelineModule``'s stages (the reference also replicates a plain
    module over its mesh's pipe axis; the port does not)."""
    found = []
    zc = cfg.zero_config
    tp, sp, ep = cfg.tensor_parallel_size, cfg.sequence_parallel_size, cfg.expert_parallel_size
    if cfg.pipeline_parallel_size > 1 and stages == 1:
        found.append(f"pipeline_parallel_size {cfg.pipeline_parallel_size} on a module that is not a PipelineModule "
                     "(A8)")
    offload = (zc.offload_optimizer is not None and zc.offload_optimizer.device.value != "none") or \
        (cfg.optimizer_name or "").lower() == "cpuadam"
    combos = (("the pipeline", stages > 1), ("hpZ/MiCS", _secondary_partition_size(zc) > 1),
              ("qgZ", zc.zero_quantized_gradients), ("offload", offload))
    for what, size in (("tensor parallelism", tp), ("sequence parallelism", sp), ("expert parallelism", ep)):
        if size > 1:
            found.extend(f"{what} with {other} (A8 item 5)" for other, on in combos if on)
    return found


def _secondary_partition_size(zc) -> int:
    """hpZ's or MiCS's secondary group size (1: no secondary partition)."""
    if zc.zero_hpz_partition_size > 1:
        return zc.zero_hpz_partition_size
    if zc.mics_shard_size > 0:
        return zc.mics_shard_size
    return 1


class DeepSpeedEngine:
    """Config-driven training engine (see the module doc)."""

    def __init__(self, model, model_parameters=None, optimizer=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device=None, param_specs=None):
        if model is None or not isinstance(model, torch.nn.Module):
            raise ValueError("model must be a torch.nn.Module whose forward(batch) returns the loss")
        # the zero.Init demand governs this engine only
        zero_init_demanded = snapshot_and_clear_init_demand()
        self.device = resolve_device(device)
        # join the gang the launcher described (a world of one without one)
        dist.init_distributed(device=self.device)
        self._config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        missing = _unsupported(self._config, self._pipeline_stages())
        if missing:
            raise NotImplementedError(f"not ported yet, each with the ROADMAP item that ports it: {', '.join(missing)}")
        # the rank mesh: the pipeline stages (PipelineEngine), then the data
        # ranks, split into (data, hpz) for hpZ / MiCS (reference
        # engine.py:166-190)
        zc = self._config.zero_config
        secondary = _secondary_partition_size(zc)
        pipe = self._pipeline_stages()
        axes = {groups.MODEL_AXIS: self._config.tensor_parallel_size,
                groups.SEQ_AXIS: self._config.sequence_parallel_size,
                groups.EXPERT_AXIS: self._config.expert_parallel_size}
        mesh = groups.get_mesh() if groups.mesh_is_initialized() else None
        if mesh is None or mesh.size != dist.get_world_size() or mesh.shape.get(groups.PIPE_AXIS, 1) != pipe or \
                (secondary > 1 and mesh.shape.get(groups.HPZ_AXIS, 1) != secondary) or \
                any(mesh.shape.get(ax, 1) != n for ax, n in axes.items()):
            groups.initialize_mesh(pipe_parallel_size=pipe, secondary_partition_size=secondary,
                                   model_parallel_size=axes[groups.MODEL_AXIS],
                                   sequence_parallel_size=axes[groups.SEQ_AXIS],
                                   expert_parallel_size=axes[groups.EXPERT_AXIS], force=True)
        self.mesh = groups.get_mesh()
        if secondary > 1 and self.mesh.shape.get(groups.HPZ_AXIS, 1) != secondary:
            raise groups.TopologyError(f"hpZ/MiCS partition size {secondary} requires a mesh with an 'hpz' axis of "
                                       f"that size (got {dict(self.mesh.shape)})")
        self._dp_group = groups.get_group(groups.get_data_parallel_axes())
        # the ranks that average their losses: data x seq (the ZeRO group)
        self._loss_group = groups.get_group(groups.SEQ_DATA_PARALLEL_AXES)
        self._sp_group = groups.get_group(groups.SEQ_AXIS)
        self._mp_group = groups.get_group(groups.MODEL_AXIS)
        self._ep_group = groups.get_group(groups.EXPERT_AXIS)
        self._edp_group = groups.get_group(groups.EXPERT_ZERO_AXES)
        if zero_init_demanded:
            logger.info("zero.Init was requested: the engine partitions the parameters of the module it was given")
        dist.configure(self._config)

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.training = True
        self.collate_fn = collate_fn
        self._global_grad_norm = None
        self._cached_loss = None
        self.acc_grads = None

        # precision: f32 master weights, the model in the compute dtype
        if self._config.bfloat16_config.enabled:
            self.compute_dtype = torch.bfloat16
        elif self._config.fp16_config.enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.master_dtype = torch.float32
        self._fp16 = self._config.fp16_config.enabled
        self._dynamic_scale = self._fp16 and self._config.fp16_config.loss_scale == 0.0
        self._grad_accum_dtype = _ACCUM_DTYPES[self._config.grad_accum_dtype]

        # parameters: the user's state_dict (if any) into the module, then f32
        # masters on the device and the module's own tensors in the compute dtype
        if model_parameters is not None:
            # a module built on the meta device takes copies of the user's
            # tensors (assigned, so they must not alias what the engine writes)
            assign = any(p.is_meta for p in model.parameters())
            model.load_state_dict({k: torch.as_tensor(v).clone() if assign else torch.as_tensor(v)
                                   for k, v in model_parameters.items()}, assign=assign)
        # model ranks: this rank's shards of the placed linears and embeddings
        # (reference initialize(param_specs=...)); expert ranks: its experts
        self._tp_dims = {}
        if self._mp_group.size > 1 and param_specs is not None:
            apply_tensor_parallel(model, param_specs, self._mp_group)
            self._tp_dims = {n: spec[1] for n, spec in param_specs.items()
                             if spec is not None and spec[0] == groups.MODEL_AXIS}
        self._expert_names = set()
        for mod_name, mod in model.named_modules():
            if isinstance(mod, ExpertFFN):
                _keep_local_experts(mod, self._ep_group)
                self._expert_names.update(f"{mod_name}.{p}" if mod_name else p for p in ("wi", "wo"))
        self.module = model.to(self.device)
        self._moe_layers = [m for m in self.module.modules() if isinstance(m, MoE)]
        self._gating_draws = 0
        self.params = {n: p.detach().to(self.master_dtype, copy=True) for n, p in self.module.named_parameters()}
        self.module.to(self.compute_dtype)
        self._module_params = dict(self.module.named_parameters())
        # ZeRO placement: the masters this rank holds (its chunks at stage 3).
        # hpZ shards the parameters over the secondary group only; MiCS
        # shards everything within it (reference engine.py:202-216)
        part_kw = {}
        if zc.mics_shard_size > 0:
            part_kw["zero_axes"] = groups.SECONDARY_PARTITION_AXES
        elif zc.zero_hpz_partition_size > 1:
            part_kw["param_axes"] = groups.SECONDARY_PARTITION_AXES
        if self._ep_group.size > 1:
            part_kw["expert_names"] = self._expert_names
        # placements the ZeRO axes partition on top of: this rank's
        # tensor-parallel shards, and banks placed on the expert axis
        taken = {n: (d, self._mp_group.size) for n, d in self._tp_dims.items()}
        for n in self._expert_names:
            spec = (param_specs or {}).get(n)
            if self._ep_group.size > 1 or (spec is not None and spec[0] == groups.EXPERT_AXIS):
                taken[n] = (0, self._ep_group.size)
        part_kw["taken"] = taken
        self._zero = ZeroPartitioner(self.module, zc.stage,
                                     persistence_threshold=zc.param_persistence_threshold if zc.stage >= 3 else 0,
                                     **part_kw)
        self._partition_params = self._zero.params_partitioned
        if self._partition_params:
            self.params = {n: self._zero.shard_param(p, n) for n, p in self.params.items()}
        # qwZ: stage-3 weight gathers move int8 or int4 (reference
        # engine.py:218-234); unsupported combinations raise
        self._qwz = False
        if zc.zero_quantized_weights:
            if not qwz_supported(zc.stage):
                raise ValueError("zero_quantized_weights (qwZ) requires ZeRO stage 3 (parameters are not sharded at "
                                 f"stage {zc.stage}, so there is no weight all-gather to quantize)")
            self._zero.qwz = QuantizedWeightGather(self._zero, self.compute_dtype,
                                                   bits=zc.zero_quantized_weights_bits)
            self._qwz = True
            logger.info("qwZ enabled: ZeRO-3 weight all-gathers move int8")
        if zc.zero_quantized_nontrainable_weights:
            raise NotImplementedError("zero_quantized_nontrainable_weights: the engine has no frozen-parameter tier "
                                      "to keep quantized at rest; use inference/v2 weight quantization for frozen "
                                      "deployments, or zero_quantized_weights for the comm path")
        # qgZ: int8 gradient reduction (reference engine.py:236-246)
        self._qgz = None
        if zc.zero_quantized_gradients:
            if qgz_supported(self.mesh, zc.stage):
                self._qgz = QuantizedGradReducer(self.module, self._dp_group)
                logger.info("qgZ enabled: data-parallel gradients reduce as int8 blocks")
            else:
                logger.warning("zero_quantized_gradients requested but unsupported on this mesh/stage (needs "
                               "ZeRO<=2 and a pure-DP mesh); using exact psum")
        if zc.offload_param is not None and zc.offload_param.device.value != "none":
            logger.warning("offload_param: the parameters stay on the device (the reference reads the block and "
                           "offloads only the optimizer state)")
        self._sync_module()

        # optimizer and its state (over this rank's part at stages 1-3)
        if optimizer is not None:
            self.optimizer = optimizer
        else:
            self.optimizer = _make_optimizer(self._config.optimizer_name, self._config.optimizer_params)
        # ZeRO-Offload: the optimizer state at rest off the card (reference
        # engine.py:324-340; the cpuadam optimizer implies it)
        offload_cfg = zc.offload_optimizer
        offload_enabled = getattr(self.optimizer, "offload", False)
        if offload_cfg is not None and offload_cfg.device.value != "none":
            offload_enabled = True
        if offload_cfg is not None and offload_cfg.device.value == "nvme":
            self._offload = NvmeOffloadPlan(self.device, offload_cfg.nvme_path, aio_config=self._config.aio_config,
                                            buffer_count=offload_cfg.buffer_count, rank=dist.get_rank())
        else:
            # an optimizer that reads whole tensors gathers its partitioned
            # state over the ranks: on the device (the choreography path)
            host = getattr(self.optimizer, "elementwise", False) or not self._zero.partitioned
            self._offload = OptimizerOffloadPlan(offload_enabled, self.device, host_compute=host)
        self.opt_state = self._offload.stage_out(self.optimizer.init(self._opt_view(self.params)))

        # loss scaling state, on the device
        fp16_cfg = self._config.fp16_config
        if self._dynamic_scale:
            self.scale_state = dynamic_loss_scale_state(fp16_cfg.initial_scale_power,
                                                        delayed_shift=fp16_cfg.hysteresis, device=self.device)
        else:
            self.scale_state = static_loss_scale_state(fp16_cfg.loss_scale if self._fp16 else 1.0,
                                                       device=self.device)
        self._overflow_count = torch.zeros([], dtype=torch.int32, device=self.device)
        self._last_step_applied = torch.ones([], dtype=torch.bool, device=self.device)

        # lr schedule (stepped once at init, as the reference does)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self._current_lr = float(self.optimizer.get_lr())
        if self.lr_scheduler is not None:
            if self.lr_scheduler.last_batch_iteration == -1:
                self.lr_scheduler.step()
            self._current_lr = self.lr_scheduler.get_last_lr()[0]

        self.training_dataloader = self.deepspeed_io(training_data) if training_data is not None else None

        # progressive layer drop, the compression scheduler and the
        # eigenvalue probe (each None unless configured)
        self.progressive_layer_drop = None
        if self._config.pld_enabled:
            pld_cfg = self._config.progressive_layer_drop
            self.progressive_layer_drop = ProgressiveLayerDrop(theta=pld_cfg.get("theta", 0.5),
                                                               gamma=pld_cfg.get("gamma", 0.001))
        self.compression_scheduler = None
        csched = CompressionScheduler(self._config._param_dict)
        if csched.enabled:
            self.compression_scheduler = csched
        self.eigenvalue = None
        if self._config.eigenvalue_enabled:
            ev = dict(self._config._param_dict.get("eigenvalue", {}))
            ev.pop("enabled", None)
            self.eigenvalue = Eigenvalue(**ev)
        self._last_batch = None  # one micro-batch kept for the curvature probes
        self._eig_state = None
        self._reference_names = None  # the JAX package's names, for compression patterns

        # telemetry: with a session active the wall-clock timers run (wrapped
        # so that every fwd/bwd/step start and stop records a span); without
        # one each instrumented site below is one `is not None` check
        self.wall_clock_breakdown = self._config.wall_clock_breakdown
        self._telemetry = None
        self._tel_metrics = None
        self._tel_last_step_time = None
        if self._config.telemetry_config.enabled:
            self._telemetry = telemetry.configure(self._config.telemetry_config)
        timed = self.wall_clock_breakdown or self._telemetry is not None
        self.timers = SynchronizedWallClockTimer(self.device) if timed else NoopTimer()
        if self._telemetry is not None:
            self.timers = telemetry.wrap_timers(self.timers)
        # synchronizing only with real timers: the JAX engine's barrier waits
        # for no computation, so its throughput timer never holds the host
        self.tput_timer = ThroughputTimer(config=type("cfg", (), {"enabled": True, "synchronized": timed})(),
                                          batch_size=self.train_batch_size(),
                                          steps_per_output=self._config.steps_per_print, device=self.device)
        # the monitor (ROADMAP A9) is not ported: the JAX engine's
        # _write_monitor calls have no counterpart here

        # legacy curriculum learning ("curriculum_learning" block)
        self.curriculum_scheduler = None
        if self._config.curriculum_enabled_legacy:
            self.curriculum_scheduler = CurriculumScheduler(self._config.curriculum_params_legacy)
        self.random_ltd_scheduler = None
        self._staging_stream = None

        # training fault tolerance: the anomaly sentinel (all-precision finite
        # gate, rollback to the last good checkpoint), preemption-safe exit and
        # the training fault injector; disabled, each costs one check a hook
        sent_cfg = self._config.anomaly_sentinel_config
        self._anomaly_guard = sent_cfg.enabled
        self._sentinel = _sentinel_mod.LossAnomalySentinel(sent_cfg) if sent_cfg.enabled else None
        self._train_faults = injector_from_env(os.environ.get("DSTPU_TRAIN_FAULTS"))
        # gang liveness: under the elastic agent's watchdog (DSTPU_GANG_DIR)
        # every rank heartbeats from the train loop; unarmed, one env read
        self._gang_rank = dist.get_rank()
        self._gang_hb = GangHeartbeat.from_env(rank=self._gang_rank)
        self._ckpt_save_dir = None
        self._sentinel_good_step = None
        self._preempt_event = None
        self._preempt_cfg = None
        self._preempt_at = None
        self._last_loss = None

    # ------------------------------------------------------------------ setup --
    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler(self.optimizer) if callable(client_scheduler) else client_scheduler
        if self._config.scheduler_name is not None:
            cls = get_lr_schedule_class(self._config.scheduler_name)
            return cls(optimizer=self.optimizer, **(self._config.scheduler_params or {}))
        return None

    def _sync_module(self):
        """The module's parameters become the masters cast to the compute
        dtype (at stage 3 over several ranks: the chunks the units gather)."""
        if self._partition_params:
            self._zero.set_leaves(self.params, self.compute_dtype)
        with torch.no_grad():
            for name, p in self._module_params.items():
                if not (self._partition_params and name in self._zero.leaves):
                    p.copy_(self.params[name])

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A loader of global micro-batches (``micro * dp`` rows each, as the
        reference sizes them); each rank trains on its chunk."""
        return DeepSpeedDataLoader(dataset,
                                   batch_size=batch_size or self.train_micro_batch_size_per_gpu() * self.dp_world_size,
                                   collate_fn=collate_fn or self.collate_fn, drop_last=True)

    # ------------------------------------------------------------- the ranks --
    @property
    def dp_world_size(self):
        return self._dp_group.size

    @property
    def dp_rank(self):
        return self._dp_group.rank

    def _opt_view(self, params):
        """What this rank's optimizer state covers: each tensor's chunk where
        the rule shards its optimizer state, else the whole (stage 3's
        masters are chunks already)."""
        if self._partition_params:
            if not self._zero.relayout:
                return dict(params)
            return {n: self._zero.param_to_opt(p, n) for n, p in params.items()}
        return {n: self._zero.shard(p, self._zero.opt_dim[n], name=n) for n, p in params.items()}

    def _spread(self, name):
        """Where the rest of parameter ``name`` lies beyond this rank (ZeRO
        aside): ``(group, dim)`` for a tensor-parallel shard (the model
        group) or an expert bank (the expert group, on its expert dim), else
        None."""
        if name in self._tp_dims:
            return self._mp_group, self._tp_dims[name]
        if name in self._expert_names and self._ep_group.size > 1:
            return self._ep_group, 0
        return None

    def full_params(self):
        """The whole f32 masters (gathered from every rank at stage 3, and
        across the model and expert ranks: a collective, every rank calls
        it)."""
        return {n: self._gather_entry("params", n, p) for n, p in self.params.items()}

    def _localize_params(self, full):
        """Whole masters to what this rank holds."""
        dims = self._zero.param_dim if self._partition_params else {}
        return {n: self._localize_entry("params", n, p, dims.get(n)).clone() for n, p in full.items()}

    def state_bytes(self):
        """Bytes this rank holds of the training state: ``params`` (the f32
        masters and the compute-dtype copy the module or the units use),
        ``grads`` (the gradient-accumulation buffer as a step allocates it)
        and ``optimizer`` (the optimizer state)."""
        z = self._zero
        comp = torch.finfo(self.compute_dtype).bits // 8
        acc = torch.finfo(self._grad_accum_dtype).bits // 8
        masters = sum(p.numel() * p.element_size() for p in self.params.values())
        compute = sum(z.local_numel(n, z.param_dim) * comp for n in self.params)
        grads = sum(z.local_numel(n, z.grad_dim) * acc for n in self.params)
        # wherever the state rests: on the card, on the host (of which
        # "pinned" is a part) or in its files on disk
        opt = sum(v for k, v in self._offload.resting_bytes(self.opt_state).items() if k != "pinned")
        return {"params": masters + compute, "grads": grads, "optimizer": opt}

    def _pipeline_stages(self) -> int:
        """The pipeline's stage count (``PipelineEngine`` overrides)."""
        return 1

    def _grad_group(self, name):
        """The ranks whose gradients of ``name`` sum to the batch's: the
        expert-data group for an expert bank, else data x seq."""
        return self._edp_group if name in self._expert_names else self._loss_group

    def _dp_all_reduce(self, t, name=None):
        """``t`` summed over the ranks that hold parameter ``name`` for
        other rows (or positions) of the batch."""
        group = self._grad_group(name)
        return dist.all_reduce(t, group=group) if group.size > 1 else t

    def _checkpoint_layout(self):
        """For each flat entry of the saved state trees, the dimension this
        engine chunks it on over the ranks (None: whole on every rank)."""
        z = self._zero
        opt = {}
        for field, value in (self.opt_state._asdict() if hasattr(self.opt_state, "_asdict")
                             else dict(self.opt_state or {})).items():
            if isinstance(value, dict):
                opt.update({f"{field}/{n}": z.opt_dim[n] for n in value})
            elif value is not None:
                opt[field] = None
        return {"params": dict(z.param_dim), "opt_state": opt,
                "scale_state": {k: None for k in self.scale_state._asdict()}}

    def _dp_chunk(self, x, dim=0, group=None):
        """This rank's contiguous chunk of a global batch leaf along ``dim``
        over ``group`` (default: the data-parallel ranks); a leaf whose size
        there the ranks do not divide stays whole, as the reference
        replicates it."""
        group = self._dp_group if group is None else group
        n = group.size
        if n == 1 or not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim <= dim or x.shape[dim] % n:
            return x
        k = x.shape[dim] // n
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(group.rank * k, (group.rank + 1) * k)
        return x[tuple(sl)]

    def _rank_slice(self, x, dim=0):
        """This rank's part of a global micro-batch leaf whose batch dim is
        ``dim``: its data rank's rows, and under sequence parallelism its
        sequence rank's positions of the next dim (reference
        ``_batch_sharding``)."""
        return self._dp_chunk(self._dp_chunk(x, dim), dim + 1, self._sp_group)

    def _global_mean(self, value):
        """The gang's mean of a per-rank scalar (each rank's loss over its
        part of the batch)."""
        if self._loss_group.size == 1:
            return value
        return dist.all_reduce(value.detach().float().clone(), op=ReduceOp.AVG, group=self._loss_group)

    # ------------------------------------------------------- config accessors --
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_config.stage

    # -- offload and ZeRO++ (reference engine.py:1439, :1647-1663, :1728) --
    def swap_tensor_config(self):
        return self._config.aio_config

    def aio_config(self):
        return self._config.aio_config

    def zero_use_cpu_optimizer(self):
        return self._offload.enabled

    def zero_cpu_offload(self):
        return self._offload.enabled and not hasattr(self._offload, "swapper")

    def zero_has_nvme_offload(self):
        return hasattr(self._offload, "swapper")

    def zero_partial_offload(self):
        zc = self._config.zero_config
        return zc.offload_optimizer.ratio if zc.offload_optimizer else 1.0

    def zero_offload_optimizer(self):
        return self._config.zero_config.offload_optimizer

    def zero_offload_param(self):
        return self._config.zero_config.offload_param

    def zero_hpz_partition_size(self):
        return self._config.zero_config.zero_hpz_partition_size

    def mics_shard_size(self):
        return self._config.zero_config.mics_shard_size

    def zero_quantized_weights(self):
        return self._config.zero_config.zero_quantized_weights

    def zero_quantized_gradients(self):
        return self._config.zero_config.zero_quantized_gradients

    def communication_data_type(self):
        return torch.int8 if self._qgz is not None else self._grad_accum_dtype

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def get_lr(self):
        return [self._current_lr]

    def get_global_grad_norm(self):
        return None if self._global_grad_norm is None else float(self._global_grad_norm)

    @property
    def loss_scale(self):
        return float(self.scale_state.cur_scale)

    @property
    def skipped_steps(self):
        return int(self._overflow_count)

    def get_skipped_steps(self):
        return int(self._overflow_count)

    def was_step_applied(self) -> bool:
        return bool(self._last_step_applied)

    # -- progressive layer drop, eigenvalue, curriculum and data efficiency --
    def get_pld_theta(self):
        return self.progressive_layer_drop.get_theta() if self.progressive_layer_drop else 1.0

    def pld_enabled(self):
        return self._config.pld_enabled

    def pld_params(self):
        return self._config.progressive_layer_drop

    def pld_theta(self):
        return self.pld_params().get("theta", 0.5)

    def pld_gamma(self):
        return self.pld_params().get("gamma", 0.001)

    def eigenvalue_enabled(self):
        return self._config.eigenvalue_enabled

    def eigenvalue_verbose(self):
        return self.eigenvalue.verbose if self.eigenvalue else False

    def eigenvalue_max_iter(self):
        return self.eigenvalue.max_iter if self.eigenvalue else 0

    def eigenvalue_tol(self):
        return self.eigenvalue.tol if self.eigenvalue else 0.0

    def eigenvalue_stability(self):
        return self.eigenvalue.stability if self.eigenvalue else 0.0

    def eigenvalue_gas_boundary_resolution(self):
        return self.eigenvalue.gas_boundary_resolution if self.eigenvalue else 1

    def eigenvalue_layer_name(self):
        return self.eigenvalue.layer_name if self.eigenvalue else ""

    def eigenvalue_layer_num(self):
        return self.eigenvalue.layer_num if self.eigenvalue else 0

    def curriculum_enabled_legacy(self):
        return self._config.curriculum_enabled_legacy

    def curriculum_params_legacy(self):
        return self._config.curriculum_params_legacy

    def curriculum_learning_enabled(self):
        return self._config.curriculum_enabled_legacy or bool(
            self.data_sampling_config().get("curriculum_learning", {}).get("enabled", False))

    def curriculum_learning_config(self):
        return self.data_sampling_config().get("curriculum_learning", {})

    def set_custom_curriculum_learning_schedule(self, schedule_func_dict):
        if self.curriculum_scheduler is not None:
            self.curriculum_scheduler.set_custom_get_difficulty(schedule_func_dict.get("get_difficulty"))

    def data_efficiency_enabled(self):
        return bool(self._config.data_efficiency_config.get("enabled", False))

    def data_efficiency_config(self):
        return self._config.data_efficiency_config

    def data_sampling_enabled(self):
        return bool(self.data_sampling_config().get("enabled", False))

    def data_sampling_config(self):
        return self._config.data_efficiency_config.get("data_sampling", {})

    def random_ltd_enabled(self):
        return bool(self.random_ltd_config().get("enabled", False))

    def random_ltd_config(self):
        return self._config.data_efficiency_config.get("data_routing", {}).get("random_ltd", {})

    def random_ltd_initialize(self):
        c = self.random_ltd_config()
        sched = c.get("random_ltd_schedule", {})
        self.random_ltd_scheduler = RandomLTDScheduler(
            min_value=sched.get("min_value", 128), max_value=sched.get("max_value", 2048),
            require_steps=sched.get("schedule_config", {}).get("require_steps", 1000),
            total_layer_num=c.get("total_layer_num", 0), random_ltd_layer_num=c.get("random_ltd_layer_num", 0))
        return self.random_ltd_scheduler

    def quantize_training(self):
        return self._config.compression_config

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)

    def eval(self):
        self.train(False)

    def module_state_dict(self, exclude_frozen_parameters=False):
        """Host copy of the whole f32 master weights (a collective at
        stage 3 over several ranks)."""
        return {k: v.detach().cpu() for k, v in self.full_params().items()}

    def load_module_state_dict(self, state_dict, strict=True, custom_load_fn=None):
        """The masters become ``state_dict`` (cast to f32, on the device), and
        the module follows. ``custom_load_fn(src=..., dst=...)`` returns the
        dict to load, as the reference's does."""
        if custom_load_fn is not None:
            state_dict = custom_load_fn(src=state_dict, dst=self.params)
            if state_dict is None:
                raise ValueError("custom_load_fn must return the parameter dict")
        if strict and set(state_dict) != set(self.params):
            raise KeyError(f"state_dict does not fit the model: missing {sorted(set(self.params) - set(state_dict))}, "
                           f"unexpected {sorted(set(state_dict) - set(self.params))}")
        new = cast_tree({k: torch.as_tensor(v).to(self.device) for k, v in state_dict.items()}, self.master_dtype)
        new = self._localize_params({k: v for k, v in new.items() if k in self.params})
        self.params = {k: new.get(k, p) for k, p in self.params.items()}
        self._sync_module()

    def zero_grad(self):
        self.acc_grads = None
        self._cached_loss = None

    def destroy(self):
        """Release the engine's resources: the last async save commits (or its
        failure is logged) first."""
        try:
            close_async_checkpointer(self)
        except Exception:
            logger.exception("async checkpoint drain at destroy failed (the checkpoint is absent, never torn)")
        if self._telemetry is not None:
            self._telemetry.close()  # flushes the Chrome trace and the JSONL sink
            self._telemetry = None
        self._eig_state = None
        self._last_batch = None
        self.zero_grad()
        self._zero.detach()  # the module's units get their own forward back
        self._offload.close()  # the NVMe swapper's last writes land (reference engine.py:1278)

    # ------------------------------------------------------------- data path --
    def _to_device(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(x) for x in batch)
        if isinstance(batch, dict):
            return {k: self._to_device(x) for k, x in batch.items()}
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    @staticmethod
    def _tree_map(fn, batch, *rest):
        if isinstance(batch, (tuple, list)):
            return type(batch)(DeepSpeedEngine._tree_map(fn, *xs) for xs in zip(batch, *rest))
        if isinstance(batch, dict):
            return {k: DeepSpeedEngine._tree_map(fn, x, *(r[k] for r in rest)) for k, x in batch.items()}
        return fn(batch, *rest)

    def _apply_curriculum(self, batch):
        """Truncate the sequence dimension to the curriculum's difficulty at
        the step about to be taken (the ``seqlen`` type only, as the JAX
        engine). Tensors are sliced where they are."""
        if self.curriculum_scheduler is None:
            return batch
        if self._config.curriculum_params_legacy.get("curriculum_type", "seqlen") != "seqlen":
            return batch
        diff = self.curriculum_scheduler.update_difficulty(self.global_steps + 1)

        def trunc(x):
            if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 2 and x.shape[1] > diff:
                return x[:, :diff]
            return x

        return self._tree_map(trunc, batch)

    def stage_train_batch(self, data_iter=None, batch=None):
        """One global batch staged for ``train_batch``: curriculum
        truncation, the ``[gas, micro, ...]`` stacking and the copy to the
        device. Safe to call from a background thread (``PrefetchingLoader``
        does). On a CUDA device the host leaves are pinned and copied on a
        staging stream; the returned :class:`StagedBatch` holds an event that
        ``train_batch`` waits on."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            assert data_iter is not None, "stage_train_batch needs data_iter or batch"
            micro = list(itertools.islice(data_iter, gas))
            if len(micro) != gas:
                raise StopIteration(f"data_iter ran out after {len(micro)} of {gas} micro-batches")
            micro = [self._apply_curriculum(m) for m in micro]
            batch = self._tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs])
                                   if isinstance(xs[0], torch.Tensor) else np.stack(xs), *micro)
        else:
            batch = self._apply_curriculum(batch)
            batch = self._tree_map(lambda x: x.reshape((gas, -1) + tuple(x.shape[1:])), batch)
        # [gas, micro * dp, ...] global micro-batches: this rank's rows
        batch = self._tree_map(lambda x: self._rank_slice(x, dim=1), batch)
        if self.device.type != "cuda":
            return StagedBatch(self._to_device(batch))
        if self._staging_stream is None:
            self._staging_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._staging_stream):
            staged = self._tree_map(self._stage_leaf, batch)
            event = torch.cuda.Event()
            event.record(self._staging_stream)
        return StagedBatch(staged, event)

    def _stage_leaf(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor) or x.device.type != "cpu":
            return x
        return x.pin_memory().to(self.device, non_blocking=True)


    # ---------------------------------------------------------------- the step --
    def _forward_module(self, batch):
        """The module's loss on this rank's chunk. At stage 3 over several
        ranks the units gather and recompute per layer, which stands in for
        ``remat``'s recomputation, so ``remat`` stores instead. Across the
        ranks that average their losses, a ``(input_ids, labels)`` batch's
        loss is this rank's share of the global token mean (C18): the count
        of valid labels is summed over them first."""
        if self._moe_layers:
            self._seed_gates()
        with self._token_mean(batch), (recompute_disabled() if self._partition_params else contextlib.nullcontext()):
            return self.module(batch)

    def _token_mean(self, batch):
        group = self._loss_group
        labels = batch[1] if isinstance(batch, (tuple, list)) and len(batch) == 2 else None
        if group.size == 1 or not isinstance(labels, torch.Tensor) or labels.is_floating_point():
            return contextlib.nullcontext()
        count = dist.all_reduce((labels != IGNORE_INDEX).sum().reshape(1), group=group)[0]
        return global_token_mean(count, group.size)

    def _seed_gates(self):
        """The MoE layers' noise for this forward (C16): the reference engine
        hands a flax MoE a fresh ``gating`` rng each training micro-step
        (its noisy gates, random token selection, top-2's sampled second
        expert) and none in evaluation. Here each layer gets a seed from
        the engine's count of training forwards and the layer's index; in
        evaluation none. The count is the same on every rank, so a gate
        that is global over the ranks draws the same noise on each."""
        for i, m in enumerate(self._moe_layers):
            m.gating_seed = (self._gating_draws * len(self._moe_layers) + i) if self.training else None
        if self.training:
            self._gating_draws += 1

    def _micro_grads(self, loss):
        """Gradients of ``loss * scale`` with respect to what this rank
        differentiates (the module's parameters; at stage 3 over several
        ranks each unit parameter's chunk, its gradient already
        reduce-scattered), in the accumulation dtype. At stage 2 the sharded
        gradients are reduce-scattered here, each micro-step, into the
        partitioned accumulation buffer."""
        scaled = loss.float() * self.scale_state.cur_scale
        names = list(self._module_params)
        leaves = self._zero.leaves if self._partition_params else {}
        grads = torch.autograd.grad(scaled, [leaves.get(n, self._module_params[n]) for n in names],
                                    allow_unused=True, materialize_grads=True)
        return self._reduce_micro(dict(zip(names, grads)))

    def _reduce_micro(self, grads):
        """One micro-step's gradients as the accumulation buffer holds them:
        in the accumulation dtype, reduce-scattered at stage 2, and under
        qgZ summed over the ranks as int8 blocks."""
        z = self._zero
        if self._qgz is not None:
            # at stage 2 this rank keeps its chunks of the qgZ sum
            summed = self._qgz.reduce(grads)
            return {n: (z.shard(g, z.grad_dim[n]) if z.stage == 2 else g).to(self._grad_accum_dtype)
                    for n, g in summed.items()}
        out = {n: g.to(self._grad_accum_dtype) for n, g in grads.items()}
        if z.partitioned and z.stage == 2:
            out = {n: g if z.grad_dim[n] is None else z.reduce_scatter(g, z.grad_dim[n], name=n)
                   for n, g in out.items()}
        return out

    def _accumulate(self, grads):
        if self.acc_grads is None:
            self.acc_grads = grads
        else:
            for name, g in grads.items():
                self.acc_grads[name].add_(g)

    def _reduced(self, name):
        """Whether ``name``'s accumulated gradient already is the sum over
        the ranks (a reduce-scattered chunk)."""
        z = self._zero
        if not z.partitioned or self._qgz is not None:
            return True
        if self._partition_params:
            return z.param_dim[name] is not None
        return z.stage == 2 and z.grad_dim[name] is not None

    def _boundary_grads(self):
        """The accumulated gradients summed over the ranks, over what this
        rank's optimizer state covers (``_opt_view``), in f32. A chunk
        reduced within its group is summed across the groups that repeat
        it (MiCS, hpZ), and hpZ's parameter chunks become optimizer
        chunks."""
        z = self._zero
        out = {}
        for name, g in self.acc_grads.items():
            g = g.float()
            if self._partition_params and z.param_dim[name] is not None:
                g = z.replica_all_reduce(g, param=True)
                if z.relayout:
                    g = z.param_to_opt(g, name)
            elif z.partitioned and z.stage == 2 and z.grad_dim[name] is not None:  # a reduce-scattered chunk
                if self._qgz is None:
                    g = z.replica_all_reduce(g)
            else:
                if self._qgz is None:
                    g = self._dp_all_reduce(g, name)
                g = z.shard(g, z.opt_dim[name], name=name)
            out[name] = g
        return out

    def _gang_finite(self, finite):
        """Whether every rank's gradients are finite (a 0-d bool tensor)."""
        if self._zero.partitioned:
            finite = self._zero.all_reduce(finite.float(), op=ReduceOp.MIN) > 0
        if self._mp_group.size > 1 or self._ep_group.size > 1:
            finite = dist.all_reduce(finite.float(), op=ReduceOp.MIN, group=groups.world_group()) > 0
        return finite

    def _gang_norm(self, grads):
        """The global L2 norm of the gradients (over ``_opt_view``): chunked
        ones summed over the ranks, whole ones counted once; the squares of
        tensor-parallel shards and expert banks are then summed over the
        model or expert group (their ZeRO chunks first over theirs)."""
        dims = self._zero.opt_dim
        spread = {n: self._spread(n) for n in grads}
        whole = [g.float().square().sum() for n, g in grads.items() if dims[n] is None and spread[n] is None]
        chunked = [g.float().square().sum() for n, g in grads.items() if dims[n] is not None and spread[n] is None]
        total = torch.stack(whole).sum() if whole else torch.zeros([], device=self.device)
        if chunked:
            total = total + self._zero.all_reduce(torch.stack(chunked).sum())
        for group in (self._mp_group, self._ep_group):
            names = [n for n in grads if spread[n] is not None and spread[n][0] is group]
            if not names:
                continue
            part = torch.zeros([], device=self.device)
            for n in names:
                sq = grads[n].float().square().sum()
                if dims[n] is not None:  # a ZeRO chunk: first summed over its own group
                    zgroup = self._zero._of(False, n)[0]
                    sq = dist.all_reduce(sq, group=zgroup) if zgroup is not None else sq
                part = part + sq
            total = total + dist.all_reduce(part, group=group)
        return total.sqrt()

    def _optimizer_update(self, grads, opt_state, params):
        """The optimizer over this rank's part. An optimizer whose update
        reads whole tensors (LAMB's trust ratio, the 1-bit family's scales)
        runs on the gathered tensors when the state is partitioned, and its
        results are cut back to this rank's part."""
        z = self._zero
        if not z.partitioned or getattr(self.optimizer, "elementwise", False):
            return self.optimizer.update(grads, opt_state, params, self._current_lr)
        gather = lambda tree: {n: z.gather(t, z.opt_dim[n], name=n) for n, t in tree.items()}
        shard = lambda tree: {n: z.shard(t, z.opt_dim[n], name=n) for n, t in tree.items()}
        full_state = _map_state(opt_state, params, gather)
        new_p, new_state = self.optimizer.update(gather(grads), full_state, gather(params), self._current_lr)
        return shard(new_p), _map_state(new_state, new_p, shard)

    def _apply(self):
        """One optimizer step over the accumulated gradients; returns the
        overflow flag (0-d bool tensor). Over several ranks the gradients are
        averaged over them, the finite check, the norm and the clip are the
        gang's, and each rank updates its part of the state (then, at stages
        1 and 2, the updated parameters are all-gathered)."""
        gas = float(self.gradient_accumulation_steps())
        inv = 1.0 / (self.scale_state.cur_scale * gas * self._loss_group.size)
        grads = {k: g * inv for k, g in self._boundary_grads().items()}
        self.acc_grads = None
        # fp16 always gates on finite gradients (overflow skip); the anomaly
        # sentinel arms the same gate in every precision (skip-step)
        finite = None
        if self._fp16 or self._anomaly_guard:
            finite = self._gang_finite(tree_all_finite(grads).to(self.device))
        norm = self._gang_norm(grads)
        clip = self._config.gradient_clipping
        if clip > 0.0:
            grads, norm = clip_grads_by_global_norm(grads, clip, norm=norm)
        view = self._opt_view(self.params)
        # offload: the state comes in from its resting place, the update runs
        # where the plan says (the host), and the state goes back to rest
        opt_in = self._offload.stage_in(self.opt_state)
        new_view, new_opt = self._offload.run_update(self._optimizer_update, grads, opt_in, view, finite)
        self.opt_state = self._offload.stage_out(new_opt)
        z = self._zero
        if z.partitioned and not self._partition_params:
            new_view = {n: z.gather(p, z.opt_dim[n], name=n) for n, p in new_view.items()}
        elif self._partition_params and z.relayout:
            new_view = {n: z.opt_to_param(p, n) for n, p in new_view.items()}
        self.params = new_view
        self._sync_module()
        overflow = ~finite if finite is not None else torch.zeros([], dtype=torch.bool, device=self.device)
        if self._fp16:
            fp16 = self._config.fp16_config
            self.scale_state = update_scale(self.scale_state, overflow, scale_window=fp16.loss_scale_window,
                                            min_scale=fp16.min_loss_scale, delayed_shift=fp16.hysteresis,
                                            consecutive_hysteresis=fp16.consecutive_hysteresis,
                                            dynamic=self._dynamic_scale)
        self._global_grad_norm = norm
        self._overflow_count = self._overflow_count + overflow.to(torch.int32)
        self._last_step_applied = ~overflow
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        return overflow

    def _step_lr_scheduler(self, overflow):
        """Advance the schedule unless this step was skipped (the host reads
        the flag only under fp16 or with the sentinel's gate armed)."""
        if (self._fp16 or self._anomaly_guard) and bool(overflow):
            return
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
            self._current_lr = self.lr_scheduler.get_last_lr()[0]

    # --------------------------------------------------------- train-step API --
    def forward(self, batch):
        """The loss of one global micro-batch. In eval mode a plain pass
        without gradients, returning the gang's mean loss; in training mode
        ``backward`` follows, and the loss returned is this rank's (its
        chunk's), the one its gradients come from."""
        self.timers(FORWARD_MICRO_TIMER).start()
        if self.training:
            batch = self._apply_curriculum(batch)
        batch = self._to_device(self._tree_map(self._rank_slice, batch))
        if not self.training:
            self._cached_loss = None
            try:
                with torch.no_grad():
                    return self._global_mean(self._forward_module(batch))
            finally:
                self.timers(FORWARD_MICRO_TIMER).stop()
        self._last_batch = batch  # the eigenvalue gate's and the curvature probes' batch
        # the flops profiler (ROADMAP A9) is not ported
        loss = self._forward_module(batch)
        self._cached_loss = loss
        self.timers(FORWARD_MICRO_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the gradients of the last ``forward``'s loss."""
        loss = self._cached_loss if loss is None else loss
        assert loss is not None, "backward() must follow forward()"
        self.timers(BACKWARD_MICRO_TIMER).start()
        self._accumulate(self._micro_grads(loss))
        self._cached_loss = None
        self._last_loss = loss.detach()
        self.timers(BACKWARD_MICRO_TIMER).stop()
        return loss

    def step(self):
        """Optimizer step at gradient-accumulation boundaries."""
        self.timers(STEP_MICRO_TIMER).start()
        boundary = self.is_gradient_accumulation_boundary()
        if boundary:
            assert self.acc_grads is not None, "step() with no accumulated gradients"
            self._step_lr_scheduler(self._apply())
            self._boundary_schedules()
            if self._telemetry is not None:
                self._write_telemetry(loss=self._last_loss)
        self.micro_steps += 1
        if boundary:
            # after the count, so a preemption checkpoint taken here resumes
            # on the next accumulation window
            self._after_boundary_step(self._last_loss)
        self.timers(STEP_MICRO_TIMER).stop()

    def _boundary_schedules(self):
        """Progressive layer drop's θ and the compression scheduler, after an
        optimizer step (the compression gate probes ``_last_batch``)."""
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.compression_scheduler is not None:
            self.compression_scheduler.step(self)

    def train_batch(self, data_iter=None, batch=None):
        """One global batch: accumulate over its ``gas`` micro-batches, then
        one optimizer step. ``batch`` is the global ``[gas * micro * dp, ...]``
        per leaf, a :class:`StagedBatch` or a :class:`FusedHostBatch`;
        ``data_iter`` yields global micro-batches or either of those
        (``PrefetchingLoader``). Returns the gang's mean micro-batch loss
        (0-d tensor on the device)."""
        # a preemption notice that arrived between steps exits before paying
        # for another one (one that arrives mid-step finalizes at its end)
        self._maybe_finalize_preemption()
        self._pre_step_fault_hooks()
        gas = self.gradient_accumulation_steps()
        if isinstance(batch, StagedBatch):
            staged = batch
        elif isinstance(batch, FusedHostBatch):
            staged = self.stage_train_batch(batch=batch.tree)
        elif data_iter is not None and batch is None:
            nxt = next(data_iter)
            if isinstance(nxt, StagedBatch):
                staged = nxt
            elif isinstance(nxt, FusedHostBatch):
                staged = self.stage_train_batch(batch=nxt.tree)
            else:
                staged = self.stage_train_batch(data_iter=itertools.chain([nxt], data_iter))
        else:
            assert batch is not None, "train_batch needs data_iter or batch"
            staged = self.stage_train_batch(batch=batch)
        stacked = staged.wait()
        micro = [self._tree_map(lambda x, i=i: x[i], stacked) for i in range(gas)]
        poison_loss = False
        if self._train_faults is not None and self._train_faults.fire_step("nan_inject", self.global_steps) is not None:
            logger.error(f"chaos: NaN injected into the batch for step {self.global_steps}")
            poisoned = [self._train_faults.poison_batch(mb) for mb in micro]
            # a batch of token ids has no floating tensor to poison: the
            # step's losses carry the NaN instead
            poison_loss = all(p is mb for p, mb in zip(poisoned, micro))
            micro = poisoned
        # the flops profiler (ROADMAP A9) is not ported
        if self._telemetry is not None:
            tel_t0 = telemetry.now_us()
        self.tput_timer.start()
        losses = []
        for mb in micro:
            loss = self._forward_module(mb)
            if poison_loss:
                loss = loss * float("nan")
            self._accumulate(self._micro_grads(loss))
            losses.append(loss.detach().float())
        self.micro_steps += gas
        self._step_lr_scheduler(self._apply())
        loss = self._global_mean(torch.stack(losses).mean())
        if self.compression_scheduler is not None:
            self._last_batch = micro[0]  # one micro-batch for the eigenvalue gate's probes
        self._boundary_schedules()
        self.tput_timer.stop(global_step=True)
        if self._telemetry is not None:
            # the throughput timer synchronized the device (real timers run
            # under telemetry), so the span is the step's device time too
            self._telemetry.spans.record(TRAIN_BATCH_TIMER, cat="engine", ts_us=tel_t0,
                                         dur_us=telemetry.now_us() - tel_t0)
            self._write_telemetry(loss=loss)
        self._after_boundary_step(loss)
        return loss

    def _write_telemetry(self, loss=None):
        """Step metrics into the registry (gauges to scrape) and the JSONL
        event stream: loss, lr, samples/s, gradient norm, skipped steps. The
        ``float()``/``int()`` reads wait for the device: telemetry, like
        tracing, is opt-in."""
        if self._tel_metrics is None:
            reg = self._telemetry.registry
            self._tel_metrics = {
                "loss": reg.gauge("train_loss", "Last boundary-step training loss"),
                "lr": reg.gauge("train_lr", "Current learning rate"),
                "sps": reg.gauge("train_samples_per_sec", "Boundary-to-boundary throughput"),
                "norm": reg.gauge("train_grad_norm", "Global gradient norm at the last step"),
                "skipped": reg.gauge("train_skipped_steps", "Overflow-skipped optimizer steps"),
                "steps": reg.gauge("train_global_steps", "Optimizer steps taken"),
                "samples": reg.counter("train_samples_total", "Samples consumed"),
            }
        m = self._tel_metrics
        now = time.time()
        sps = self.train_batch_size() / (now - self._tel_last_step_time) \
            if self._tel_last_step_time is not None and now > self._tel_last_step_time else None
        self._tel_last_step_time = now
        norm = self.get_global_grad_norm()
        skipped = self.skipped_steps
        m["lr"].set(self._current_lr)
        m["steps"].set(self.global_steps)
        m["skipped"].set(skipped)
        m["samples"].inc(self.train_batch_size())
        fields = {"step": self.global_steps, "samples": self.global_samples, "lr": self._current_lr,
                  "skipped_steps": skipped}
        if loss is not None:
            fields["loss"] = float(loss)
            m["loss"].set(fields["loss"])
        if sps is not None:
            fields["samples_per_sec"] = sps
            m["sps"].set(sps)
        if norm is not None:
            fields["grad_norm"] = norm
            m["norm"].set(norm)
        if self._fp16:
            fields["loss_scale"] = self.loss_scale
        self._telemetry.registry.event("train_step", **fields)

    # ----------------------------------------- compression and the curvature --
    def apply_compression_transform(self, sub_config: dict) -> None:
        """Apply compression transforms to the live f32 masters (the
        compression scheduler's hook), each tensor under the JAX package's
        name and in its layout; the module follows."""
        if self._reference_names is None:
            self._reference_names = reference_names(self.module)
        full = self.full_params()  # a transform reads whole tensors
        new = self._localize_params(init_compression(full, sub_config, layout=self._reference_names))
        with torch.no_grad():
            for name, p in self.params.items():
                if new[name] is not p:
                    p.copy_(new[name])
        self._sync_module()

    def _eigenvalue_blocks(self, params):
        """The masters grouped as the JAX package's top-level tree entries:
        one ``model`` block for a Llama (the JAX tree nests everything under
        ``model``), else one block for each first component of a name."""
        blocks = {}
        for name, t in params.items():
            head = "model" if isinstance(self.module, LlamaModel) else name.partition(".")[0]
            blocks.setdefault(head, {})[name] = t
        return blocks

    def loss_curvature(self):
        """Top Hessian eigenvalue of the last kept micro-batch's loss (power
        iteration, ``runtime/eigenvalue.py``), as the largest of the blocks'
        values after the reference's scaling (so 1.0 when finite): the
        compression scheduler's eigenvalue gate. None before any batch.
        Over several ranks each Hessian product is averaged over them (each
        holds its chunk of the batch), so every rank finds the global
        batch's value.

        The loss is differentiated through the master -> compute-dtype cast,
        with activation recomputation off (a second derivative does not
        compose with ``torch.utils.checkpoint``); the ``Eigenvalue`` and its
        HVP closures are kept across probes."""
        if self._last_batch is None:
            return None
        if self._eig_state is None:

            def loss_fn(blocks, batch):
                flat = {n: t.to(self.compute_dtype) for block in blocks.values() for n, t in block.items()}
                with recompute_disabled(), self._zero.gathered_module(flat):
                    return functional_call(self.module, flat, (batch, ))

            self._eig_state = (Eigenvalue(max_iter=8, tol=1e-2), loss_fn, {})
        eig, loss_fn, cache = self._eig_state
        blocks = self._eigenvalue_blocks(self.full_params())
        if self.dp_world_size > 1:
            # each rank's chunk gives its own Hessian product: the gang's
            # average is the global batch's, so every rank iterates alike
            for name in blocks:
                if name not in cache:
                    cache[name] = _gang_mean_hvp(block_hvp(loss_fn, name), self._dp_group)
        vals = eig.compute_eigenvalue(loss_fn, blocks, self._last_batch,
                                      generator=torch.Generator(self.device).manual_seed(0), hvp_cache=cache)
        return max(vals.values()) if vals else None


    # ------------------------------------------------------- fault tolerance --
    def _pre_step_fault_hooks(self):
        """Step entry: the gang heartbeat (this rank is alive and making
        progress), then the ``hang_rank_at_step`` chaos point, a sleep
        inside the step: the wedged collective's shape, a live process whose
        heartbeat goes stale while its peers block."""
        if self._gang_hb is not None:
            self._gang_hb.beat(step=self.global_steps, phase="step")
        inj = self._train_faults
        if inj is not None and inj.fire_step_rank("hang_rank_at_step", self.global_steps,
                                                  self._gang_rank) is not None:
            logger.error(f"chaos: rank {self._gang_rank} hanging {inj.config.hang_seconds:.0f}s at step "
                         f"{self.global_steps}")
            time.sleep(inj.config.hang_seconds)

    def _after_boundary_step(self, loss):
        """At a completed optimizer step: the sentinel's observation
        (anomaly count, rollback), the chaos SIGTERM and SIGKILL points, and
        the preemption finalizer: the step finishes, then the engine acts."""
        if self._gang_hb is not None:
            self._gang_hb.beat(step=self.global_steps, phase="idle")
        if self._sentinel is not None and loss is not None:
            self._observe_loss(loss)
        inj = self._train_faults
        if inj is not None:
            if inj.fire_step("sigterm_at_step", self.global_steps) is not None:
                logger.error(f"chaos: SIGTERM at step {self.global_steps}")
                os.kill(os.getpid(), signal.SIGTERM)
            if inj.fire_step("kill_at_step", self.global_steps) is not None:
                logger.error(f"chaos: SIGKILL at step {self.global_steps}")
                os.kill(os.getpid(), signal.SIGKILL)
            if inj.fire_step_rank("kill_rank_at_step", self.global_steps, self._gang_rank) is not None:
                logger.error(f"chaos: SIGKILL rank {self._gang_rank} at step {self.global_steps}")
                os.kill(os.getpid(), signal.SIGKILL)
        self._maybe_finalize_preemption()

    def _observe_loss(self, loss):
        verdict = self._sentinel.observe(float(loss))  # a device sync; the sentinel is opt-in
        if verdict == _sentinel_mod.OK:
            # the rollback horizon: checkpoints at or before this step hold
            # weights from before the anomaly (a spike applies its update, so
            # a loop that saves every step checkpoints the divergence too)
            self._sentinel_good_step = self.global_steps
        elif verdict == _sentinel_mod.ROLLBACK:
            self._sentinel_rollback()

    def _sentinel_rollback(self):
        """M anomalies in a row: reload the newest committed checkpoint taken
        at or before the last healthy step (a later save holds the diverged
        state). ``load_checkpoint`` verifies; a tag it rejects moves on to the
        next older one."""
        cfg = self._sentinel.config
        save_dir = self._ckpt_save_dir
        if not cfg.rollback or save_dir is None:
            logger.error(f"anomaly sentinel: escalation without rollback (rollback={cfg.rollback}, checkpoint dir "
                         f"known={save_dir is not None}); training continues on the anomalous state")
            return
        horizon = self._sentinel_good_step
        for entry in list_tags(save_dir):
            step = (entry["manifest"] or {}).get("global_steps")
            if entry["status"] != "committed":
                continue
            if horizon is not None and (step is None or step > horizon):
                continue  # saved after the divergence started
            logger.error(f"anomaly sentinel: rolling back to {entry['tag']} under {save_dir} "
                         f"(last healthy step: {horizon})")
            self.zero_grad()
            try:
                path, _ = self.load_checkpoint(save_dir, tag=entry["tag"])
            except CheckpointCorruptionError as e:
                logger.error(f"anomaly sentinel: rollback target bad ({e}); trying the next older tag")
                continue
            logger.warning(f"anomaly sentinel: resumed from {path} (step {self.global_steps})")
            return
        logger.error(f"anomaly sentinel: no usable checkpoint at or before the last healthy step {horizon} "
                     f"under {save_dir}; NOT rolling back, training continues")

    def install_preemption_handler(self, save_dir=None, grace_s=None, signals=(signal.SIGTERM, )):
        """Turn a preemption notice (SIGTERM by default) into a clean exit:
        the step in flight finishes, an async save drains, a final
        synchronous checkpoint commits within ``grace_s``
        (``checkpoint.preemption_grace_s`` when unset), ``PREEMPTED.json``
        lands beside ``latest``, and :class:`TrainingPreempted` (code 143) is
        raised. ``save_dir`` defaults to the last ``save_checkpoint``
        directory. Call from the main thread (a constraint of ``signal``)."""
        self._preempt_cfg = {"save_dir": os.path.abspath(save_dir) if save_dir else None,
                             "grace_s": float(grace_s) if grace_s is not None
                             else self._config.checkpoint_config.preemption_grace_s}
        self._preempt_event = threading.Event()

        def _on_preempt(signum, frame):
            # async-signal-safe: a flag and a time; the log comes at the step
            # boundary, on the training thread
            self._preempt_at = time.monotonic()
            self._preempt_event.set()

        for sig in signals:
            signal.signal(sig, _on_preempt)
        return self

    @property
    def preemption_requested(self) -> bool:
        """True once a preemption signal arrived (the finalizer runs at the
        next step boundary; a loop with long gaps between steps can poll this
        and call :meth:`finalize_preemption` itself)."""
        return self._preempt_event is not None and self._preempt_event.is_set()

    def _maybe_finalize_preemption(self):
        if self.preemption_requested:
            self.finalize_preemption()

    def finalize_preemption(self):
        """The preemption exit (does not return): drain an async save, write
        the final synchronous checkpoint and the resume marker, raise
        :class:`TrainingPreempted`."""
        cfg = self._preempt_cfg or {}
        grace = cfg.get("grace_s") or self._config.checkpoint_config.preemption_grace_s
        started = self._preempt_at or time.monotonic()
        save_dir = cfg.get("save_dir") or self._ckpt_save_dir
        tag = f"preempt_step{self.global_steps}"
        logger.warning(f"preemption: draining async saves, final checkpoint {tag} (grace {grace:.0f}s)")
        if save_dir is not None:
            # save_engine_state takes the barrier: a commit in flight lands first
            save_engine_state(self, save_dir, tag, {"preempted": True}, save_latest=True, async_save=False)
            used = time.monotonic() - started
            with open(os.path.join(save_dir, PREEMPT_MARKER), "w") as f:
                json.dump({"tag": tag, "global_steps": self.global_steps, "grace_s": grace, "used_s": round(used, 3),
                           "resume_dir": save_dir}, f)
            level = logger.error if used > grace else logger.warning
            level(f"preemption: final checkpoint {tag} committed in {used:.1f}s (grace budget {grace:.0f}s"
                  f"{' EXCEEDED' if used > grace else ''})")
        else:
            logger.error("preemption: no checkpoint directory known (pass save_dir to install_preemption_handler, "
                         "or save_checkpoint once first); exiting WITHOUT a final checkpoint")
        from deepspeed_tpu_torch import telemetry
        if telemetry.is_active():
            telemetry.get_registry().counter("train_preemptions_total",
                                             "Preemption notices turned into a final checkpoint and a clean exit").inc()
        raise TrainingPreempted(tag if save_dir is not None else None, self.global_steps)

    # ------------------------------------------------------------- checkpoints --
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save as ``tag`` (default ``global_step<N>``) under ``save_dir``,
        sealed by a manifest written last (``runtime/checkpoint_engine``);
        asynchronous under ``nebula.enabled``."""
        tag = str(tag) if tag is not None else f"global_step{self.global_steps}"
        self._check_checkpointable()
        self._checkpoint_tag_validation(tag)
        save_engine_state(self, save_dir, tag, client_state or {}, save_latest,
                          async_save=self._config.nebula_config.enabled)
        # the sentinel's rollback source and the preemption handler's default
        self._ckpt_save_dir = os.path.abspath(save_dir)
        return True

    def checkpoint_wait(self):
        """Wait for an async save in flight (raises if its commit failed)."""
        checkpoint_barrier(self)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True, load_optimizer_states=True,
                        load_lr_scheduler_states=True, load_module_only=False, custom_load_fn=None):
        """Verified restore; returns ``(path, client_state)``, or ``(None,
        None)`` where nothing was ever committed. With ``tag=None`` a torn or
        corrupt tag falls back loudly to the newest verified-good one; an
        explicit bad tag raises ``CheckpointCorruptionError``."""
        # deliberately leaves _ckpt_save_dir alone: a load source may be
        # read-only; only a save marks where the finalizer and rollback write
        self._check_checkpointable()
        return load_engine_state(self, load_dir, tag, load_optimizer_states=load_optimizer_states,
                                 load_lr_scheduler_states=load_lr_scheduler_states,
                                 load_module_only=load_module_only)

    def _check_checkpointable(self):
        """The gang checkpoint puts the ranks' chunks back together in rank
        order; chunks that repeat across groups (hpZ's parameters, MiCS) or
        differ by pipeline stage have no such layout yet (ROADMAP A8 item
        5)."""
        z = self._zero
        if z.zrep is not None or z.prep is not None or self._pipeline_stages() > 1:
            raise NotImplementedError("checkpoints of hpZ/MiCS partitions and of pipeline stages are not ported "
                                      "yet (A8 item 5)")

    def _checkpoint_global(self) -> bool:
        """Whether a save writes every array in its global layout (rank 0
        alone, from what the ranks gather): across model, sequence or
        expert ranks, whose shards no rank-order concatenation joins."""
        return any(g.size > 1 for g in (self._mp_group, self._sp_group, self._ep_group))

    def _gather_entry(self, tree, key, t):
        """A saved entry whole: its ZeRO chunks, then its tensor-parallel
        or expert shards, gathered (a collective)."""
        name = key.partition("/")[2] if tree == "opt_state" else key
        if name not in self.params:
            return t
        z = self._zero
        if tree == "params":
            t = z.gather_param(t, name)
        else:
            t = z.gather(t, z.opt_dim[name], name=name)
        spread = self._spread(name)
        if spread is not None:
            group, dim = spread
            t = dist.all_gather_into_tensor(t.movedim(dim, 0).contiguous(), group=group).movedim(0, dim)
        return t.contiguous()

    def _localize_entry(self, tree, key, t, dim):
        """A whole saved entry as this rank holds it: its tensor-parallel or
        expert shard, then its ZeRO chunk along ``dim``."""
        name = key.partition("/")[2] if tree == "opt_state" else key
        if name not in self.params:
            return t
        spread = self._spread(name)
        if spread is not None:
            group, sdim = spread
            k = t.shape[sdim] // group.size
            t = t.narrow(sdim, group.rank * k, k)
        return self._zero.shard(t, dim, param=tree == "params", name=name).contiguous()

    def _checkpoint_tag_validation(self, tag):
        """Every rank must save the same tag (reference ``engine.py:3035``):
        rank 0's tag hash is broadcast to the world and compared;
        ``checkpoint.tag_validation`` says what a mismatch does (Warn logs,
        Fail raises, Ignore skips the check)."""
        if not self._config.checkpoint_tag_validation_enabled or dist.get_world_size() == 1:
            return
        import zlib
        h = zlib.crc32(str(tag).encode()) & 0x7FFFFFFF
        mine = torch.tensor([h], dtype=torch.int64, device=self.device)
        agreed = int(dist.broadcast(mine.clone(), src=0, group=groups.world_group()).item())
        if agreed != h:
            msg = f"checkpoint tag {tag!r} is not consistent across all ranks"
            if self._config.checkpoint_tag_validation_fail:
                raise RuntimeError(msg)
            logger.warning(msg)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin", exclude_frozen_parameters=False):
        """The whole weights in the compute dtype as ``<save_filename>.npz``,
        one array per ``state_dict`` name (bf16 as its raw uint16 bits: numpy
        has no bf16), written by rank 0 (every rank calls it)."""
        full = self.full_params()
        if dist.get_rank() != 0:
            return True
        os.makedirs(save_dir, exist_ok=True)
        out = {}
        for name, p in full.items():
            t = p.detach().to(self.compute_dtype).cpu()
            out[name] = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
        np.savez(os.path.join(save_dir, save_filename + ".npz"), **out)
        return True

    def save_fp16_model(self, save_dir, save_filename="pytorch_model.bin"):
        return self.save_16bit_model(save_dir, save_filename)


def _keep_local_experts(experts: ExpertFFN, group):
    """An :class:`ExpertFFN`'s banks cut to the experts ``group``'s rank
    holds (``[E/ep, ...]``), as ``models/convert.py::expert_slice`` cuts a
    state dict; raises when the experts do not divide over the ranks."""
    if group.size == 1:
        return
    for name in ("wi", "wo"):
        bank = getattr(experts, name)
        E = bank.shape[0]
        if E % group.size:
            raise ValueError(f"{E} experts do not divide over {group.size} expert-parallel ranks")
        per = E // group.size
        local = torch.nn.Parameter(bank.detach()[group.rank * per:(group.rank + 1) * per].clone())
        local.allreduce = False
        setattr(experts, name, local)


def _gang_mean_hvp(hvp, group):
    """``hvp`` averaged over the ranks of ``group``."""

    def mean_hvp(params, batch, v):
        return [dist.all_reduce(t.detach().clone(), op=ReduceOp.AVG, group=group) for t in hvp(params, batch, v)]

    return mean_hvp


def _map_state(state, params, fn):
    """``fn`` over the parameter-keyed dicts of an optimizer state (its
    per-parameter fields); other fields (a step count) are left as they are."""
    if state is None:
        return None
    if isinstance(state, dict):
        return fn(state) if set(state) == set(params) else state
    if isinstance(state, tuple):
        return type(state)(*(_map_state(v, params, fn) for v in state))
    return state
