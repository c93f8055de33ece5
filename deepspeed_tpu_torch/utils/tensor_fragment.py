"""``safe_get`` / ``safe_set`` accessors for ZeRO-partitioned state.

Port of ``deepspeed_tpu/utils/tensor_fragment.py``: read or write the whole
f32 master, optimizer-state slot or accumulated gradient of one parameter,
however ZeRO partitioned it. The key is the parameter's ``state_dict`` name
(``"layers.0.mlp.up_proj.weight"``; the reference keys its tree path). Over
several ranks a partitioned tensor is put back together from every rank's
chunk, so the ``full`` accessors are collectives: every rank calls them with
the same name. A ``set`` takes the whole value on every rank and keeps this
rank's part. The ``local`` accessor returns this rank's part.
"""

import numpy as np
import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp


def _check(engine, name):
    if name not in engine.params:
        raise KeyError(f"no parameter {name!r} (available: {sorted(engine.params)[:8]}...)")


def _opt_dim(engine, name):
    return engine._zero.opt_dim[name]


def safe_get_full_fp32_param(engine, name):
    """The whole f32 master of ``name`` (a numpy array)."""
    _check(engine, name)
    return engine._zero.gather_param(engine.params[name], name).detach().cpu().numpy()


def safe_set_full_fp32_param(engine, name, value) -> None:
    """Replace the f32 master of ``name`` with the whole ``value``; the
    module follows."""
    _check(engine, name)
    t = torch.as_tensor(np.asarray(value), dtype=engine.master_dtype, device=engine.device)
    if tuple(t.shape) != engine._zero.shapes[name]:
        raise ValueError(f"value shape {tuple(t.shape)} != param shape {engine._zero.shapes[name]}")
    engine.params = dict(engine.params)
    engine.params[name] = engine._zero.shard_param(t, name)
    engine._sync_module()


def _opt_field(engine, optim_state_key):
    state = engine.opt_state
    if not hasattr(state, optim_state_key):
        raise KeyError(f"optimizer state has no {optim_state_key!r} (available: {list(getattr(state, '_fields', ()))})")
    field = getattr(state, optim_state_key)
    if not isinstance(field, dict):
        raise KeyError(f"optimizer state {optim_state_key!r} is not kept per parameter")
    return field


def safe_get_full_optimizer_state(engine, name, optim_state_key):
    """The whole value of one optimizer-state slot (``exp_avg``,
    ``exp_avg_sq``, ...) of ``name``."""
    _check(engine, name)
    t = _opt_field(engine, optim_state_key)[name]
    return engine._zero.gather(t, _opt_dim(engine, name)).detach().cpu().numpy()


def safe_set_full_optimizer_state(engine, name, value, optim_state_key) -> None:
    """Replace one optimizer-state slot of ``name`` with the whole ``value``."""
    _check(engine, name)
    field = dict(_opt_field(engine, optim_state_key))
    like = field[name]
    t = torch.as_tensor(np.asarray(value), dtype=like.dtype, device=like.device)
    if tuple(t.shape) != engine._zero.shapes[name]:
        raise ValueError(f"value shape {tuple(t.shape)} != param shape {engine._zero.shapes[name]}")
    field[name] = engine._zero.shard(t, _opt_dim(engine, name))
    engine.opt_state = engine.opt_state._replace(**{optim_state_key: field})


def safe_get_full_grad(engine, name):
    """The whole accumulated gradient of ``name`` (scaled by the loss scale,
    averaged over the ranks as the step averages it), or None outside the
    accumulation window (the engine drops its buffer at the step)."""
    _check(engine, name)
    if getattr(engine, "acc_grads", None) is None:
        return None
    g = engine.acc_grads[name].float()
    z = engine._zero
    if not engine._reduced(name):
        g = z.all_reduce(g.clone())
    elif z.partitioned:
        g = z.gather_param(g, name) if engine._partition_params else z.gather(g, z.grad_dim[name])
    return (g / engine.dp_world_size).cpu().numpy()


def safe_get_local_fp32_param(engine, name):
    """This rank's part of the f32 master of ``name`` (the whole tensor
    where it is not partitioned)."""
    _check(engine, name)
    return engine.params[name].detach().cpu().numpy()


def safe_get_local_optimizer_state(engine, name, optim_state_key):
    """This rank's part of one optimizer-state slot of ``name``."""
    _check(engine, name)
    return _opt_field(engine, optim_state_key)[name].detach().cpu().numpy()
