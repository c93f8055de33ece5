"""The training engine, on one device.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``) for one
GPU. The public API and the arithmetic are the JAX engine's:

- f32 master weights (``engine.params``, a name -> tensor dict), an
  optimizer state, a loss-scale state and the lr schedule, set up as
  ``__init__`` does there (a schedule with ``last_batch_iteration == -1`` is
  stepped once at init);
- the micro-step API ``forward`` / ``backward`` / ``step``, and the fused
  ``train_batch``: the global batch is split into ``[gas, micro, ...]``, each
  micro-batch's gradients of ``loss * scale`` are summed in the accumulation
  dtype, and one apply divides by ``scale * gas``, checks finiteness (fp16),
  takes the global norm, clips, runs the optimizer and updates the scale;
  ``train_batch`` returns the mean of the micro losses;
- an fp16 step that overflowed changes neither the weights nor the schedule.

The model runs in the compute dtype (bf16, fp16 or f32): its parameters are
the master weights cast once per optimizer step, and each micro-step's
gradients with respect to them are cast to the accumulation dtype. That is
the JAX engine's gradient of the loss through the master -> compute cast
(whose backward casts the cotangent to f32), without a cast per micro-step.

On one device every ZeRO stage runs the same math: nothing is partitioned
with one rank. Offload, ZeRO++ (qwZ, qgZ, hpZ, MiCS), pipeline, sequence and
tensor parallelism, progressive layer drop, compression, eigenvalue,
curriculum, telemetry, the anomaly sentinel, preemption handling and
checkpoint save/load raise ``NotImplementedError``.
"""

import itertools

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (dynamic_loss_scale_state, static_loss_scale_state,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule_class
from deepspeed_tpu_torch.runtime.utils import clip_grads_by_global_norm, global_norm, tree_all_finite
from deepspeed_tpu_torch.utils.device import resolve_device

_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}


def _make_optimizer(name, params_cfg):
    """Type Adam means AdamW unless ``adam_w_mode`` is false; type AdamW
    always decouples (the reference rule, ``engine.py:79-85``)."""
    name = (name or "adamw").lower()
    cfg = dict(params_cfg or {})
    cfg.pop("torch_adam", None)
    if name in ("adam", "adamw", "fusedadam"):
        awm = cfg.pop("adam_w_mode", True)
        if name == "adamw":
            awm = True
        return FusedAdam(adam_w_mode=awm, **cfg)
    raise NotImplementedError(f"optimizer {name!r}: the port has Adam/AdamW only so far (ROADMAP A7)")


def _unsupported(cfg: DeepSpeedConfig):
    """The names of configured features this engine does not run."""
    zc, pd = cfg.zero_config, cfg._param_dict
    found = []
    for block in (zc.offload_optimizer, zc.offload_param):
        if block is not None and block.device.value != "none":
            found.append(f"ZeRO offload to {block.device.value}")
    if zc.cpu_offload or zc.cpu_offload_param:
        found.append("ZeRO CPU offload")
    if zc.zero_quantized_weights or zc.zero_quantized_nontrainable_weights:
        found.append("qwZ (zero_quantized_weights)")
    if zc.zero_quantized_gradients:
        found.append("qgZ (zero_quantized_gradients)")
    if zc.zero_hpz_partition_size > 1 or zc.mics_shard_size > 0:
        found.append("hpZ/MiCS secondary partitioning")
    for key, what in ((cfg.pipeline_parallel_size, "pipeline parallelism"),
                      (cfg.sequence_parallel_size, "sequence parallelism"),
                      (cfg.tensor_parallel_size, "tensor parallelism"),
                      (cfg.expert_parallel_size, "expert parallelism")):
        if key > 1:
            found.append(what)
    for key, what in (("progressive_layer_drop", "progressive layer drop"), ("eigenvalue", "eigenvalue"),
                      ("curriculum_learning", "curriculum learning"), ("telemetry", "telemetry"),
                      ("anomaly_sentinel", "the anomaly sentinel")):
        if pd.get(key, {}).get("enabled", False):
            found.append(what)
    if pd.get("compression_training"):
        found.append("compression training")
    return found


class DeepSpeedEngine:
    """Config-driven training engine for one device (see the module doc)."""

    def __init__(self, model, model_parameters=None, optimizer=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device=None):
        if model is None or not isinstance(model, torch.nn.Module):
            raise ValueError("model must be a torch.nn.Module whose forward(batch) returns the loss")
        self.device = resolve_device(device)
        self._config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        missing = _unsupported(self._config)
        if missing:
            raise NotImplementedError(f"not ported yet (ROADMAP A7/A8): {', '.join(missing)}")

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
        self.module = model.to(self.device)
        self.params = {n: p.detach().to(self.master_dtype, copy=True) for n, p in self.module.named_parameters()}
        self.module.to(self.compute_dtype)
        self._module_params = dict(self.module.named_parameters())
        self._sync_module()

        # optimizer and its state
        if optimizer is not None:
            self.optimizer = optimizer
        else:
            self.optimizer = _make_optimizer(self._config.optimizer_name, self._config.optimizer_params)
        self.opt_state = self.optimizer.init(self.params)

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

    # ------------------------------------------------------------------ setup --
    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler(self.optimizer) if callable(client_scheduler) else client_scheduler
        if self._config.scheduler_name is not None:
            cls = get_lr_schedule_class(self._config.scheduler_name)
            return cls(optimizer=self.optimizer, **(self._config.scheduler_params or {}))
        return None

    def _sync_module(self):
        """The module's parameters become the masters cast to the compute dtype."""
        with torch.no_grad():
            for name, p in self._module_params.items():
                p.copy_(self.params[name])

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
                                   collate_fn=collate_fn or self.collate_fn, drop_last=True)

    # ------------------------------------------------------- config accessors --
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_config.stage

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

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)

    def eval(self):
        self.train(False)

    def module_state_dict(self):
        """Host copy of the f32 master weights."""
        return {k: v.detach().cpu() for k, v in self.params.items()}

    def zero_grad(self):
        self.acc_grads = None
        self._cached_loss = None

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
    def _tree_map(fn, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(DeepSpeedEngine._tree_map(fn, x) for x in batch)
        if isinstance(batch, dict):
            return {k: DeepSpeedEngine._tree_map(fn, x) for k, x in batch.items()}
        return fn(batch)

    # ---------------------------------------------------------------- the step --
    def _micro_grads(self, loss):
        """Gradients of ``loss * scale`` with respect to the module's
        parameters, in the accumulation dtype."""
        scaled = loss.float() * self.scale_state.cur_scale
        names = list(self._module_params)
        grads = torch.autograd.grad(scaled, [self._module_params[n] for n in names], allow_unused=True,
                                    materialize_grads=True)
        return {n: g.to(self._grad_accum_dtype) for n, g in zip(names, grads)}

    def _accumulate(self, grads):
        if self.acc_grads is None:
            self.acc_grads = grads
        else:
            for name, g in grads.items():
                self.acc_grads[name].add_(g)

    def _apply(self):
        """One optimizer step over the accumulated gradients; returns the
        overflow flag (0-d bool tensor)."""
        gas = float(self.gradient_accumulation_steps())
        inv = 1.0 / (self.scale_state.cur_scale * gas)
        grads = {k: g.float() * inv for k, g in self.acc_grads.items()}
        self.acc_grads = None
        finite = tree_all_finite(grads).to(self.device) if self._fp16 else None
        norm = global_norm(grads)
        clip = self._config.gradient_clipping
        if clip > 0.0:
            grads, norm = clip_grads_by_global_norm(grads, clip, norm=norm)
        new_params, new_opt = self.optimizer.update(grads, self.opt_state, self.params, self._current_lr)
        if finite is not None:
            new_params = {k: torch.where(finite, new_params[k], p) for k, p in self.params.items()}
            new_opt = _tree_select(finite, new_opt, self.opt_state)
        self.params, self.opt_state = new_params, new_opt
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
        """Advance the schedule unless this fp16 step overflowed (the host
        reads the flag only under fp16)."""
        if self._fp16 and bool(overflow):
            return
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
            self._current_lr = self.lr_scheduler.get_last_lr()[0]

    # --------------------------------------------------------- train-step API --
    def forward(self, batch):
        """The loss of one micro-batch. In eval mode a plain pass without
        gradients; in training mode ``backward`` follows."""
        batch = self._to_device(batch)
        if not self.training:
            self._cached_loss = None
            with torch.no_grad():
                return self.module(batch)
        loss = self.module(batch)
        self._cached_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Accumulate the gradients of the last ``forward``'s loss."""
        loss = self._cached_loss if loss is None else loss
        assert loss is not None, "backward() must follow forward()"
        self._accumulate(self._micro_grads(loss))
        self._cached_loss = None
        return loss

    def step(self):
        """Optimizer step at gradient-accumulation boundaries."""
        if self.is_gradient_accumulation_boundary():
            assert self.acc_grads is not None, "step() with no accumulated gradients"
            self._step_lr_scheduler(self._apply())
        self.micro_steps += 1

    def train_batch(self, data_iter=None, batch=None):
        """One global batch (``[gas * micro, ...]`` per leaf, or ``gas``
        micro-batches from ``data_iter``): accumulate, then one optimizer
        step. Returns the mean micro-batch loss (0-d tensor on the device)."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            assert data_iter is not None, "train_batch needs data_iter or batch"
            micro = [self._to_device(b) for b in itertools.islice(data_iter, gas)]
            if len(micro) != gas:
                raise StopIteration(f"data_iter ran out after {len(micro)} of {gas} micro-batches")
        else:
            batch = self._to_device(batch)
            stacked = self._tree_map(lambda x: x.reshape((gas, -1) + tuple(x.shape[1:])), batch)
            micro = [self._tree_map(lambda x, i=i: x[i], stacked) for i in range(gas)]
        losses = []
        for mb in micro:
            loss = self.module(mb)
            self._accumulate(self._micro_grads(loss))
            losses.append(loss.detach().float())
        self.micro_steps += gas
        self._step_lr_scheduler(self._apply())
        return torch.stack(losses).mean()

    # ----------------------------------------------------------- not ported --
    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpoint save is not ported yet (ROADMAP A7: runtime/checkpoint_engine)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpoint load is not ported yet (ROADMAP A7: runtime/checkpoint_engine)")

    def install_preemption_handler(self, *args, **kwargs):
        raise NotImplementedError("preemption handling is not ported yet (ROADMAP A7)")


def _tree_select(pred, new, old):
    """Per-tensor ``where(pred, new, old)`` over (named) tuples and dicts."""
    if isinstance(new, dict):
        return {k: torch.where(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_tree_select(pred, a, b) for a, b in zip(new, old)))
    return torch.where(pred, new, old)
