"""Scenarios for the composed model-parallel axes that the gloo gangs of
``tests/torch_gang.py`` run, one call a rank (no jax here): training with
tensor and sequence ranks at once, tensor or sequence ranks of a MoE model
and expert ranks at ZeRO 3, checkpoints of their shards saved on one mesh
and loaded on another, and a Mixtral served at TP x EP. Inputs and results
are numpy arrays and plain values; the tests hold them against the JAX
package."""

import contextlib

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.moe import layer as moe_layer
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.runtime.checkpoint_engine import engine as ckpt
from deepspeed_tpu_torch.utils import groups


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy(tree):
    return {k: v.detach().float().numpy() for k, v in tree.items()}


def model_for(kind, cfg_fields, sequence_parallel=False):
    """A Llama or a Mixtral (``kind``) in f32 from its config fields."""
    fields = dict(cfg_fields, sequence_parallel=sequence_parallel)
    if kind == "llama":
        from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
        return LlamaForCausalLM(LlamaConfig(dtype=torch.float32, **fields))
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    return MixtralForCausalLM(MixtralConfig(dtype=torch.float32, **fields))


@contextlib.contextmanager
def counted_drops(local_gate=False):
    """Within the context every gating call of a forward appends the
    assignments its capacity dropped (``exp_counts`` less the kept ones,
    over the tokens it gates) to the list it yields (a call that recomputes
    a forward inside the backward, as ZeRO 3's units do, is not counted);
    ``local_gate`` (the control) gates each rank's own tokens instead of
    the global batch's."""
    drops = []
    keep = sharded_moe.top1gating, sharded_moe.top2gating, moe_layer.moe_groups

    def counting(fn):

        def gate(*args, **kwargs):
            out = fn(*args, **kwargs)
            if torch._C._current_graph_task_id() == -1:
                drops.append(int(out[3].sum()) - int(out[2].sum()))
            return out

        return gate

    sharded_moe.top1gating, sharded_moe.top2gating = counting(keep[0]), counting(keep[1])
    if local_gate:
        moe_layer.moe_groups = lambda: (None, ) + keep[2]()[1:3] + (None, )
    try:
        yield drops
    finally:
        sharded_moe.top1gating, sharded_moe.top2gating, moe_layer.moe_groups = keep


def training_engine(kind, cfg_fields, state, ds_config):
    from deepspeed_tpu_torch.module_inject import auto_tp_specs
    groups.destroy_mesh()
    model = model_for(kind, cfg_fields, ds_config.get("sequence_parallel_size", 1) > 1)
    specs = auto_tp_specs(model) if ds_config.get("tensor_parallel_size", 1) > 1 else None
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=ds_config, device="cpu",
                                                     model_parameters={k: _t(v) for k, v in state.items()},
                                                     param_specs=specs)
    engine._seed_gates = lambda: None  # no gating noise (C16), as the reference side
    return engine


def _step(engine, batch):
    return float(engine.train_batch(batch=tuple(_t(x).long() for x in batch)))


def whole_state(engine):
    """The engine's three state trees with every array whole (a collective)."""
    trees = ckpt._global_trees(engine, ckpt._state_trees(engine), keep=True)
    return {name: {k: v.float().numpy() for k, v in ckpt._flatten(tree).items()} for name, tree in trees.items()}


def train(kind, cfg_fields, state, ds_config, batches, local_gate=False, save_dir=None, tag="composed"):
    """``train_batch`` on each global batch over the gang's mesh, counting
    the gates' drops; then, given ``save_dir``, a save as ``tag``. Returns
    the losses, the drops, the whole masters and this rank's masters'
    shapes (and the whole state after the save)."""
    engine = training_engine(kind, cfg_fields, state, ds_config)
    with counted_drops(local_gate) as drops:
        losses = [_step(engine, b) for b in batches]
    out = dict(losses=losses, drops=drops, full=_numpy(engine.full_params()),
               shapes={k: tuple(v.shape) for k, v in engine.params.items()})
    if save_dir is not None:
        engine.save_checkpoint(save_dir, tag=tag)
        out["state"] = whole_state(engine)
        out["steps"] = engine.global_steps
    engine.destroy()
    groups.destroy_mesh()
    return out


def resume(kind, cfg_fields, state, ds_config, load_dir, tag, batch):
    """A fresh engine on the gang's mesh that loads ``tag``: its whole state
    as loaded, its step count, then one more step's loss."""
    engine = training_engine(kind, cfg_fields, state, ds_config)
    engine.load_checkpoint(load_dir, tag=tag)
    out = dict(state=whole_state(engine), steps=engine.global_steps)
    with counted_drops():
        out["loss"] = _step(engine, batch)
    out["full"] = _numpy(engine.full_params())
    engine.destroy()
    groups.destroy_mesh()
    return out


# ------------------------------------------------------------ TP x EP serving --
def _tp_ep_engine(cfg_fields, state, tp, ep):
    from deepspeed_tpu_torch.inference.v2.config_v2 import (DeepSpeedEPConfig, DeepSpeedTPConfig,
                                                            RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    groups.destroy_mesh()
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode="allocate", size=64), max_context=512)
    ecfg = RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16,
                                       tensor_parallel=DeepSpeedTPConfig(tp_size=tp),
                                       expert_parallel=DeepSpeedEPConfig(enabled=ep > 1, replica_num=ep,
                                                                         capacity_factor=4.0))
    return build_engine({k: _t(v) for k, v in state.items()}, MixtralConfig(dtype=torch.float32, **cfg_fields),
                        ecfg, device="cpu")


def tp_ep_serve(cfg_fields, state, tp, ep, requests, new_tokens):
    """A Mixtral at ``tp`` x ``ep`` over the gang: the leader (model rank 0)
    of expert rank ``e`` puts ``requests[e]`` (``{uid: tokens}``) in one
    forward, then serves the same prompts again through greedy ``generate``
    for ``new_tokens`` tokens, then leaves the expert group; the other model
    ranks follow it. Returns, on a leader, the put's logits, the generated
    tokens, the drops and the heads and banks it holds; on a follower, its
    count of repeated calls and what it holds."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import generate
    engine = _tp_ep_engine(cfg_fields, state, tp, ep)
    model = engine.model
    held = dict(heads=(model.num_heads, model.num_kv_heads),
                bank=tuple(model._params["layers.0.block_sparse_moe.experts.wi"].shape),
                ep_rank=engine.expert_parallel_group.rank if engine.expert_parallel_group is not None else 0)
    tp_group = engine.tensor_parallel_group
    try:
        if tp_group is not None and tp_group.rank != 0:
            return dict(held, follows=engine.follow())
        seqs = requests[held["ep_rank"]]
        logits = engine.put(list(seqs), [np.asarray(t) for t in seqs.values()]).numpy()
        engine.flush_all()
        tokens = generate(engine, [list(t) for t in seqs.values()], max_new_tokens=new_tokens)
        dropped = sum(int(m.dropped) for m in model.moes)
        runs = engine.leave_expert_group()
        return dict(held, logits=logits, tokens=tokens, dropped=dropped, empty_runs=runs)
    finally:
        engine.close()
        groups.destroy_mesh()
