"""Pipeline-parallel training engine: one process a stage.

Port of ``deepspeed_tpu/runtime/pipe/engine.py`` (``PipelineEngine``). The
reference compiles the whole pipeline into one program, a scan over ticks
that moves activations between neighbouring stages with ``ppermute``; its
instruction streams (``schedule.py``) are the semantic spec of a fallback
executor that simulates every stage in lock step. The port runs that spec
for real: each process is one stage of the ``pipe`` mesh axis, builds only
its stage's layers, and walks its own ``TrainSchedule`` stream
(``executor.py``), exchanging activations and their gradients with its
neighbours over ``comm.send`` / ``comm.recv``.

What the reference's engine gives, this one gives: ``train_batch`` takes
``gradient_accumulation_steps`` micro-batches and one optimizer step and
returns the mean of the micro-batch losses (the last stage's, broadcast over
the pipeline, averaged over the data-parallel ranks); ``eval_batch`` runs
the forward-only ``InferenceSchedule``; every call is a gradient
accumulation boundary; ``forward``, ``backward`` and ``step`` raise
:class:`PipelineError`. ``initialize`` returns this engine for a
``PipelineModule``.

Model contract: a :class:`PipelineModule` of ``torch.nn.Module`` layers
whose first takes the batch's inputs and whose last stage's output feeds
``loss_fn(outputs, labels)``; the batch is ``(inputs, labels)``. The stages
are the module's uniform partition (``partition_layers(method="uniform")``,
which the reference's engine sets too). ``TiedLayerSpec`` layers of one
``key`` share one module on a stage; stages that each hold a copy start from
the first one's weights (broadcast) and all-reduce their gradients at
``ReduceTiedGrads`` (reference ``executor.py:145``), so their optimizer
steps keep them equal. Parameters are named ``layers.<i>.<name>`` (layer
``i`` of the whole module) and ``tied.<key>.<name>``; ``model_parameters``
is a state dict of the whole module in those names
(``models/convert.py`` makes one from the reference's pipeline tree or from
a ``LlamaModel``), and each stage takes its own entries.

The DeepSpeed machinery of the base engine runs per stage: the optimizer,
loss scaling, the ZeRO stages over the stage's ZeRO group (at stage 3 each
layer's parameters are gathered for its forward and its backward, as the
base engine's units do; a tied module that a ``forward_fn`` reads stays
whole on every holder), hpZ / MiCS and ZeRO-Offload; the finite check and
the gradient norm are the whole pipeline's.

The pipeline composes with the mesh's other axes as the reference's does
(its ``shard_map`` splits the batch over ``DATA_PARALLEL_AXES`` only, and
places the stage stack ``P(pipe, ...)``): model and sequence ranks hold the
same stage and run the same micro-batches (no tensor or sequence
parallelism inside a stage), and expert ranks are data ranks of the stage
(its experts whole on each, every MoE gate over its own rank's tokens).
The ZeRO group stays the base engine's (data, hpz, expert, seq), whose
sequence ranks hold equal gradients. ``param_specs`` are dropped at
``initialize``, as the reference drops them.

A checkpoint holds the whole module in the names a one-stage engine saves
(``layers.<i>.<name>``, ``tied.<key>.<name>``), every array whole: each
stage's first rank writes its stage's entries under ``state/stage<s>/``
(a tied key by its first holder; the loss scale and the optimizer's step
by stage 0), and a load takes the entries its own stage holds, so a tag
loads at another stage count, on another mesh or in a one-stage engine.
"""

import json

import numpy as np
import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine, _secondary_partition_size
from deepspeed_tpu_torch.runtime.pipe.executor import StageExecutor
from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import logger


class PipelineError(Exception):
    ...


class PipelineStage(torch.nn.Module):
    """One stage's layers in order (see the module doc for the names)."""

    def __init__(self, specs, first: int, read_keys=()):
        super().__init__()
        self.layers = torch.nn.ModuleDict()
        self.tied = torch.nn.ModuleDict()
        self.calls = []  # ("layers", index) or ("tied", key, forward_fn)
        for i, spec in enumerate(specs, start=first):
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in self.tied:
                    self.tied[spec.key] = spec.build()
                    if spec.key in read_keys:
                        # a forward_fn reads its weights outside its forward:
                        # ZeRO 3 keeps them whole (no unit gathers them)
                        self.tied[spec.key]._dstpu_whole = True
                self.calls.append(("tied", spec.key, spec.forward_fn))
            else:
                self.layers[str(i)] = spec.build() if isinstance(spec, LayerSpec) else spec
                self.calls.append(("layers", str(i), None))

    def forward(self, x):
        for call in self.calls:
            if call[0] == "tied":
                module = self.tied[call[1]]
                x = call[2](module, x) if call[2] is not None else module(x)
            else:
                x = self.layers[call[1]](x)
        return x


def stage_bounds(module: PipelineModule):
    """The first layer of each stage, and the end: the module's uniform
    partition."""
    return module.partition_layers(method="uniform")


class PipelineEngine(DeepSpeedEngine):
    """Pipeline-parallel engine, one process a stage (see the module doc)."""

    def __init__(self, model, model_parameters=None, optimizer=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device=None):
        if not isinstance(model, PipelineModule):
            raise PipelineError("model must be a PipelineModule")
        self.pipeline_module = model
        self._num_stages = model.num_stages
        device = resolve_device(device)
        dist.init_distributed(device=device)
        # the ZeRO block and the axes alone: the whole config's batch sizes
        # need the mesh
        if isinstance(config, DeepSpeedConfig):
            zc = config.zero_config
            axes = (config.tensor_parallel_size, config.sequence_parallel_size, config.expert_parallel_size)
        else:
            raw = config
            if isinstance(raw, str):
                with open(raw) as f:
                    raw = json.load(f)
            zc = DeepSpeedZeroConfig.from_dict(raw.get("zero_optimization", {}))
            axes = tuple(raw.get(k, 1) for k in (C.TENSOR_PARALLEL_SIZE, C.SEQUENCE_PARALLEL_SIZE,
                                                 C.EXPERT_PARALLEL_SIZE))
        secondary = _secondary_partition_size(zc)
        if dist.get_world_size() % self._num_stages:
            raise PipelineError(f"{dist.get_world_size()} ranks do not divide into {self._num_stages} stages")
        mesh = groups.get_mesh() if groups.mesh_is_initialized() else None
        want = {groups.PIPE_AXIS: self._num_stages, groups.MODEL_AXIS: axes[0], groups.SEQ_AXIS: axes[1],
                groups.EXPERT_AXIS: axes[2]}
        if mesh is None or mesh.size != dist.get_world_size() or \
                any(mesh.shape.get(ax, 1) != n for ax, n in want.items()) or \
                (secondary > 1 and mesh.shape.get(groups.HPZ_AXIS, 1) != secondary):
            groups.initialize_mesh(pipe_parallel_size=self._num_stages, secondary_partition_size=secondary,
                                   model_parallel_size=axes[0], sequence_parallel_size=axes[1],
                                   expert_parallel_size=axes[2], force=True)
        mesh = groups.get_mesh()
        self._pipe_group = groups.get_group(groups.PIPE_AXIS)
        self.stage_id = self._pipe_group.rank if self._num_stages > 1 else 0
        # this stage's first rank (every other coordinate 0) writes its
        # entries of a checkpoint
        coords = np.argwhere(mesh.devices == mesh.rank)[0]
        self._stage_writer = not coords[1:].any()
        self.bounds = stage_bounds(model)
        lo, hi = self.bounds[self.stage_id], self.bounds[self.stage_id + 1]
        specs = model._layer_specs
        read_keys = {spec.key for spec in specs if isinstance(spec, TiedLayerSpec) and spec.forward_fn is not None}
        stage = PipelineStage(specs[lo:hi], lo, read_keys)
        self._tied_groups = self._make_tied_groups(specs)
        state = None
        if model_parameters is not None:
            names = set(n for n, _ in stage.named_parameters())
            state = {k: v for k, v in model_parameters.items() if k in names}
            missing = names - set(state)
            if missing:
                raise KeyError(f"model_parameters lack stage {self.stage_id}'s {sorted(missing)[:4]}")
        self.loss_fn = model.loss_fn or (lambda out, labels: out.float().mean())
        super().__init__(stage, model_parameters=state, optimizer=optimizer, training_data=training_data,
                         lr_scheduler=lr_scheduler, collate_fn=collate_fn, config=config, device=device)
        self._micro_batches = self.gradient_accumulation_steps()
        self._sync_tied_weights()
        self._executor = StageExecutor(self)
        logger.info(f"pipeline stage {self.stage_id}/{self._num_stages}: layers {lo}..{hi - 1}, "
                    f"{sum(p.numel() for p in self.params.values())} parameters")

    # ------------------------------------------------------------ the stages --
    def _pipeline_stages(self) -> int:
        return self._num_stages

    # -- checkpoints: each stage's entries, whole ------------------------------
    def _checkpoint_writer(self) -> bool:
        return self._stage_writer if self._num_stages > 1 else super()._checkpoint_writer()

    def _checkpoint_keeps(self, tree, key) -> bool:
        """A parameter's entries by the stage that owns it (a tied key's
        first holder); the rest (the loss scale, the step) by stage 0."""
        name = key.partition("/")[2] if tree == "opt_state" else key
        if name in self.params:
            return self._owned(name)
        return self.stage_id == 0

    def _checkpoint_subdir(self):
        return f"stage{self.stage_id}" if self._num_stages > 1 else None

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self._num_stages - 1

    @property
    def prev_rank(self):
        return self._pipe_group.ranks[self.stage_id - 1]

    @property
    def next_rank(self):
        return self._pipe_group.ranks[self.stage_id + 1]

    def _make_tied_groups(self, specs):
        """For each tied key held by several stages: the group of this
        pipeline's ranks that hold it (every rank makes every such group,
        in one order), if this rank is one of them."""
        holders = {}
        for s in range(self._num_stages):
            for spec in specs[self.bounds[s]:self.bounds[s + 1]]:
                if isinstance(spec, TiedLayerSpec):
                    holders.setdefault(spec.key, [])
                    if s not in holders[spec.key]:
                        holders[spec.key].append(s)
        out = {}
        mesh = groups.get_mesh()
        for key in sorted(holders):
            stages = holders[key]
            if len(stages) < 2:
                continue
            grp = mesh.subgroup((groups.PIPE_AXIS, ), stages)
            if self.stage_id in stages:
                out[key] = grp
        return out

    def _tied_names(self, key):
        return [n for n in self.params if n.startswith(f"tied.{key}.")]

    def _sync_tied_weights(self):
        """Every holder of a tied key starts from the first holder's
        weights."""
        for key, grp in self._tied_groups.items():
            for name in self._tied_names(key):
                self.params[name] = dist.broadcast(self.params[name].contiguous(), src=0, group=grp)
        if self._tied_groups:
            self._sync_module()

    def reduce_tied_grads(self):
        """The tied keys' accumulated gradients summed over the stages that
        hold them."""
        if self.acc_grads is None:
            return
        for key, grp in self._tied_groups.items():
            for name in self._tied_names(key):
                self.acc_grads[name] = dist.all_reduce(self.acc_grads[name].contiguous(), group=grp)

    def _accumulate_stage_grads(self, grads):
        """One micro-batch's parameter gradients into the accumulation
        buffer (reduce-scattered at stage 2, as the base engine's)."""
        self._accumulate(self._reduce_micro(grads))

    def _pipeline_step(self):
        """``OptimizerStep``: the base engine's step over the accumulated
        micro-batches."""
        self.micro_steps += self._micro_batches
        self._step_lr_scheduler(self._apply())
        self._boundary_schedules()

    # -- the whole pipeline's finite check and norm -----------------------------
    def _owned(self, name):
        """Whether this stage counts ``name`` in the norm (a tied copy is
        counted by its first holder only)."""
        if not name.startswith("tied."):
            return True
        key = name.split(".")[1]
        grp = self._tied_groups.get(key)
        return grp is None or grp.rank == 0

    def _gang_finite(self, finite):
        finite = super()._gang_finite(finite)
        if self._num_stages > 1:
            finite = dist.all_reduce(finite.float(), op=ReduceOp.MIN, group=self._pipe_group) > 0
        return finite

    def _gang_norm(self, grads):
        dims = self._zero.opt_dim
        zero = torch.zeros([], device=self.device)
        whole = sum((g.float().square().sum() for n, g in grads.items() if dims[n] is None and self._owned(n)), zero)
        chunked = sum((g.float().square().sum() for n, g in grads.items() if dims[n] is not None and self._owned(n)),
                      zero)
        total = whole + self._zero.all_reduce(chunked)
        if self._num_stages > 1:
            total = dist.all_reduce(total, group=self._pipe_group)
        return total.sqrt()

    # ------------------------------------------------------------- train API --
    def _stacked(self, data_iter, batch):
        if batch is None:
            if data_iter is None:
                raise PipelineError("train_batch needs data_iter or batch")
            micro = [next(data_iter) for _ in range(self._micro_batches)]
            batch = tuple(np.concatenate([np.asarray(m[i]) for m in micro]) for i in range(len(micro[0])))
        return self.stage_train_batch(batch=batch).wait()

    def train_batch(self, data_iter=None, batch=None):
        """One global batch through the 1F1B schedule, then one optimizer
        step; returns the mean micro-batch loss on every rank."""
        self._maybe_finalize_preemption()
        self._pre_step_fault_hooks()
        stacked = self._stacked(data_iter, batch)
        self.tput_timer.start()
        losses = self._executor.train(stacked)
        loss = self._pipeline_loss(losses)
        self.tput_timer.stop(global_step=True)
        self._after_boundary_step(loss)
        return loss

    def eval_batch(self, data_iter=None, batch=None, compute_loss=True, reduce_output="avg"):
        """The mean micro-batch loss of one global batch through the
        forward-only ``InferenceSchedule``, on every rank."""
        stacked = self._stacked(data_iter, batch)
        with torch.no_grad():
            losses = self._executor.evaluate(stacked)
        return self._pipeline_loss(losses)

    def _pipeline_loss(self, losses):
        """The last stage's mean loss, broadcast over the pipeline and
        averaged over the data-parallel ranks."""
        loss = torch.stack(losses).mean() if losses else torch.zeros([], device=self.device)
        if self._num_stages > 1:
            loss = dist.broadcast(loss.float().contiguous(), src=self._num_stages - 1, group=self._pipe_group)
        return self._global_mean(loss)

    def forward(self, *a, **kw):
        raise PipelineError("Only train_batch() is accessible when using pipeline parallelism (reference "
                            "PipelineEngine raises the same)")

    __call__ = forward

    def backward(self, *a, **kw):
        raise PipelineError("Only train_batch() is accessible when using pipeline parallelism")

    def step(self, *a, **kw):
        raise PipelineError("Only train_batch() is accessible when using pipeline parallelism")

    def is_gradient_accumulation_boundary(self):
        """Every ``train_batch`` is one whole accumulation window."""
        return True
