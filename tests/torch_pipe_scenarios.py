"""Scenarios for the pipeline composed with the mesh's other axes, that the
gloo gangs of ``tests/torch_gang.py`` run, one call a rank (no jax here):
a ``PipelineModule`` trained over pipe x model, pipe x seq, pipe x expert
and pipe x data ranks at any ZeRO stage, its checkpoints saved on one mesh
and loaded on another. Inputs and results are numpy arrays and plain
values; the tests hold them against the JAX package."""

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.utils import groups
from tests.torch_composed_scenarios import whole_state
from tests.torch_gang_scenarios import pipeline_module


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class MoEBlock(torch.nn.Module):
    """``x + MoE(x)``: the reference tests' MoE block (top-1 over 4 experts,
    capacity factor 1, 2 slots at least), its output alone."""

    def __init__(self, hidden):
        super().__init__()
        from deepspeed_tpu_torch.moe.layer import MoE
        self.moe = MoE(hidden, num_experts=4, ffn_hidden_size=2 * hidden, k=1, capacity_factor=1.0, min_capacity=2)

    def forward(self, x):
        return x + self.moe(x)[0]


def _module(kind, stages, hidden, n_blocks=4):
    if kind != "moe":
        return pipeline_module(kind, stages, hidden, n_blocks=n_blocks)
    from deepspeed_tpu_torch.runtime.pipe import LayerSpec, PipelineModule
    from tests.torch_gang_scenarios import InProj, OutProj, mse
    layers = [LayerSpec(InProj, hidden, hidden)] + [LayerSpec(MoEBlock, hidden) for _ in range(n_blocks)] + \
        [LayerSpec(OutProj, hidden)]
    return PipelineModule(layers=layers, num_stages=stages, loss_fn=mse)


def pipe_engine(kind, stages, hidden, state, ds_config, param_specs=None, n_blocks=4):
    """The ``kind`` pipeline (``"mlp"``, ``"tied"`` or ``"moe"``) over the
    gang's mesh."""
    groups.destroy_mesh()
    module = _module(kind, stages, hidden, n_blocks=n_blocks)
    kw = {} if param_specs is None else {"param_specs": param_specs}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=module, config=ds_config, device="cpu",
                                                     model_parameters={k: _t(v) for k, v in state.items()}, **kw)
    return engine


def pipe_train(kind, stages, hidden, state, ds_config, batches, param_specs=None, save_dir=None, load=None):
    """A ``PipelineEngine`` of ``stages`` stages over the gang's mesh (its
    axes from ``ds_config``): given ``load`` (``(dir, tag)``), the tag
    loaded first and the whole state as loaded; ``train_batch`` on each
    global batch (losses, norms); given ``save_dir``, a save as
    ``trained`` after.
    Returns the stage, its whole masters, this rank's state bytes and
    masters' shapes, and the whole state after."""
    engine = pipe_engine(kind, stages, hidden, state, ds_config, param_specs)
    out = dict(stage=engine.stage_id, rank=groups.get_mesh().rank)
    if load is not None:
        engine.load_checkpoint(load[0], tag=load[1])
        out["loaded"] = whole_state(engine)
        out["loaded_steps"] = engine.global_steps
        out["loaded_scale"] = engine.loss_scale
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(batch=tuple(_t(x) for x in b))))
        norms.append(engine.get_global_grad_norm())
    out.update(losses=losses, norms=norms, bytes=engine.state_bytes(),
               shapes={k: tuple(v.shape) for k, v in engine.params.items()},
               full={k: v.detach().numpy() for k, v in engine.full_params().items()},
               state=whole_state(engine), steps=engine.global_steps)
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag="trained")
    engine.destroy()
    groups.destroy_mesh()
    return out
