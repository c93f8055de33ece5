"""Scenarios for model, sequence and expert ranks that the gloo gangs of
``tests/torch_gang.py`` run, one call a rank (no jax here): the global
token mean across data ranks (C18), Ulysses, tensor parallelism in training
and in the ragged engine, and MoE with its global gate. Inputs and results
are numpy arrays and plain values; the tests hold them against the JAX
package."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import groups


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy(tree):
    return {k: v.detach().float().numpy() for k, v in tree.items()}


# ---------------------------------------------------------------- training --
def _train(model, state, ds_config, batches, param_specs=None, seed_gates=True):
    groups.destroy_mesh()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=ds_config, device="cpu",
                                                     model_parameters={k: _t(v) for k, v in state.items()} or None,
                                                     param_specs=param_specs(model) if param_specs else None)
    if not seed_gates:
        engine._seed_gates = lambda: None
    losses = [float(engine.train_batch(batch=tuple(_t(x).long() for x in b))) for b in batches]
    out = dict(losses=losses, full=_numpy(engine.full_params()), local=_numpy(engine.params),
               norm=engine.get_global_grad_norm(), rank=comm.get_rank())
    engine.destroy()
    groups.destroy_mesh()
    return out


def _llama(cfg_fields):
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig(dtype=torch.float32, **cfg_fields))


def _mixtral(cfg_fields):
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    return MixtralForCausalLM(MixtralConfig(dtype=torch.float32, **cfg_fields))


def train_llama(cfg_fields, state, ds_config, batches, token_mean=True, local_rope=False):
    """``train_batch`` of a Llama on each global batch; ``token_mean=False``
    runs each rank's loss as its own chunk's mean (the port before C18's
    repair) for the bitwise comparison, and ``local_rope=True`` takes RoPE
    at each sequence slice's local positions (a control)."""
    from deepspeed_tpu_torch.models.llama import LlamaModel, rotary_embedding
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    keep, rope = engine_mod.global_token_mean, LlamaModel.rope
    if not token_mean:
        engine_mod.global_token_mean = lambda count, size: contextlib.nullcontext()
    if local_rope:
        LlamaModel.rope = lambda self, n, device: rotary_embedding(n, self.cfg.head_dim, self.cfg.rope_theta,
                                                                   device=device)
    try:
        return _train(_llama(cfg_fields), state, ds_config, batches)
    finally:
        engine_mod.global_token_mean, LlamaModel.rope = keep, rope


def train_llama_tp(cfg_fields, state, ds_config, batches):
    """As :func:`train_llama` with ``auto_tp_specs`` placing the model on
    the ``model`` axis; also each parameter's placement."""
    from deepspeed_tpu_torch.module_inject import auto_tp_specs
    out = _train(_llama(cfg_fields), state, ds_config, batches, param_specs=auto_tp_specs)
    out["specs"] = auto_tp_specs(_llama(cfg_fields))
    return out


def train_mixtral(cfg_fields, state, ds_config, batches):
    """A Mixtral through the engine, its gates' noise off (C16)."""
    return _train(_mixtral(cfg_fields), state, ds_config, batches, seed_gates=False)


# ------------------------------------------------------------------ Ulysses --
def _attn(q, k, v, scale=1.0):
    """The reference test's attention: unmasked softmax(q·k) v, in f32."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ulysses_attention(q, k, v, w, causal=False):
    """``DistributedAttention`` over the world as the ``seq`` group, on this
    rank's sequence slice of ``q``/``k``/``v`` ``[B, S, H, D]``, around the
    reference test's attention (or, ``causal``, the Llama's causal GQA
    attention at scale ``D**-0.5``); the output slice and the gradients of
    ``sum(out * w)`` with respect to the slices."""
    from deepspeed_tpu_torch.models.llama import causal_attention
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention
    groups.initialize_mesh(sequence_parallel_size=comm.get_world_size(), force=True)
    g = groups.get_group(groups.SEQ_AXIS)
    s = q.shape[1] // g.size
    rows = slice(g.rank * s, (g.rank + 1) * s)
    ql, kl, vl = (_t(x[:, rows]).requires_grad_(True) for x in (q, k, v))
    if causal:
        out = DistributedAttention(causal_attention)(ql, kl, vl, scale=q.shape[-1]**-0.5)
    else:
        out = DistributedAttention(_attn)(ql, kl, vl)
    (out * _t(w[:, rows])).sum().backward()
    groups.destroy_mesh()
    return dict(out=out.detach().numpy(), dq=ql.grad.numpy(), dk=kl.grad.numpy(), dv=vl.grad.numpy())


# -------------------------------------------------------------------- MoE --
def moe_layer(mesh_kw, moe_kw, state, x, w, used, aux_weight, training):
    """The port's ``MoE`` on this rank's data-parallel rows of the global
    tokens ``x [S, M]`` with its experts of the whole banks ``state``; the
    loss is its rows' ``sum(out * w)`` plus its share of ``aux_weight ·
    l_aux``. Returns its rows of the output and of the input's gradient,
    ``l_aux``, ``exp_counts``, its parameters' gradients and its ranks."""
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.runtime.engine import _keep_local_experts
    groups.initialize_mesh(force=True, **mesh_kw)
    dp, ep = groups.get_group(groups.DATA_PARALLEL_AXES), groups.get_group(groups.EXPERT_AXIS)
    kw = dict(moe_kw)
    if kw.pop("silu", False):
        kw["activation"] = F.silu
    mod = MoE(**kw)
    mod.load_state_dict({k: _t(v) for k, v in state.items()})
    _keep_local_experts(mod.experts, ep)
    n = dp.size
    s = x.shape[0] // n
    rows = slice(dp.rank * s, (dp.rank + 1) * s)
    xs = _t(x[rows]).requires_grad_(True)
    out, l_aux, counts = mod(xs, used_token=None if used is None else _t(used[rows]), training=training)
    ((out * _t(w[rows])).sum() + aux_weight * l_aux / n).backward()
    groups.destroy_mesh()
    return dict(out=out.detach().numpy(), x_grad=xs.grad.numpy(), l_aux=float(l_aux), counts=counts.detach().numpy(),
                grads={k: p.grad.numpy() for k, p in mod.named_parameters()}, dp_rank=dp.rank, ep_rank=ep.rank)


# ---------------------------------------------------------- the TP engine --
def _tp_engine(cfg_fields, state, tp_kw=None, blocks=64):
    from deepspeed_tpu_torch.inference.v2.config_v2 import DeepSpeedTPConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine
    from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, MemoryConfig
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    groups.destroy_mesh()
    mgr = DSStateManagerConfig(memory_config=MemoryConfig(mode="allocate", size=blocks), max_context=512)
    ecfg = RaggedInferenceEngineConfig(state_manager=mgr, kv_block_size=16,
                                       tensor_parallel=DeepSpeedTPConfig(tp_size=comm.get_world_size()),
                                       **(tp_kw or {}))
    return build_engine({k: _t(v) for k, v in state.items()}, LlamaConfig(dtype=torch.float32, **cfg_fields), ecfg,
                        device="cpu")


def _lead_or_follow(engine, lead):
    """Rank 0 runs ``lead(engine)`` and closes the engine (releasing the
    followers); the other ranks follow. Returns rank 0's result, or the
    count of calls a follower repeated."""
    try:
        if engine.tensor_parallel_group.rank == 0:
            return lead(engine)
        return engine.follow()
    finally:
        engine.close()
        groups.destroy_mesh()


def tp_put(cfg_fields, state, uids, seqs):
    """One ``put`` of the sequences on a TP engine over the world; rank 0's
    logits, the local KV cache's shape and the heads a rank holds."""
    engine = _tp_engine(cfg_fields, state)
    shape = tuple(engine._state_manager.kv_cache.cache.shape)
    heads = (engine.model.num_heads, engine.model.num_kv_heads)
    got = _lead_or_follow(engine, lambda e: e.put(uids, [np.asarray(s) for s in seqs]).numpy())
    return dict(logits=got, cache_shape=shape, heads=heads)


def tp_generate(cfg_fields, state, prompts, new_tokens, blocks=64, decode_chunk=1):
    """Greedy ``generate`` through the serving scheduler on rank 0, the other
    ranks following, over a pool of ``blocks`` KV blocks; rank 0's tokens
    (or a follower's count of calls)."""
    from deepspeed_tpu_torch.inference.v2.engine_factory import generate
    engine = _tp_engine(cfg_fields, state, blocks=blocks)
    return _lead_or_follow(engine, lambda e: generate(e, prompts, max_new_tokens=new_tokens,
                                                      decode_chunk=decode_chunk))


def tp_refusal(cfg_fields, state, key, value):
    """A TP engine with ``key`` set (``expert_parallel``, ``quantization``):
    the ``NotImplementedError``'s message, or None."""
    from deepspeed_tpu_torch.inference.v2 import config_v2
    cls = {"expert_parallel": config_v2.DeepSpeedEPConfig, "quantization": config_v2.QuantizationConfig}[key]
    try:
        _tp_engine(cfg_fields, state, {key: cls(**value)}).close()
    except NotImplementedError as e:
        return str(e)
    finally:
        groups.destroy_mesh()
    return None
