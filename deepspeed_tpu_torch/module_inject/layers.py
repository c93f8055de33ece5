"""Tensor-parallel layers.

Port of ``deepspeed_tpu/module_inject/layers.py``. The reference declares
each layer's sharding and lets XLA insert the collective; the port runs
one process a rank, so each layer holds this rank's shard and calls its
collective over the ``model`` group itself, as upstream DeepSpeed's
Megatron-style layers do, each collective with its adjoint as the backward:

- :class:`LinearLayer`, column-parallel: the weight is split on its output
  dimension; the input is copied in (identity forward, all-reduce
  backward); ``gather_output`` all-gathers the output features (the
  vocab-sharded unembedding, so the loss sees whole logits);
- :class:`LinearAllreduce`, row-parallel: the weight is split on its input
  dimension; the local product's partial sums are all-reduced (copy
  backward), then the bias is added once;
- :class:`EmbeddingLayer`: the table is split on its feature dimension;
  each rank looks up its features and the output is all-gathered;
- :class:`Normalize`: a replicated LayerNorm (norms never shard).

The all-reduce of 16-bit partial sums upcasts: the partials are summed in
f32 and rounded to the compute dtype once. The comms logger names the
collectives ``tp_row``, ``tp_input_grad`` and ``tp_gather``.

:func:`apply_tensor_parallel` swaps a module's ``nn.Linear`` and
``nn.Embedding`` children for these, by the placements of
``auto_tp.auto_tp_specs``, with each rank's shard sliced from the whole
weights; :func:`tp_slice` cuts a whole ``state_dict`` the same way (the
ragged engine's weights). The new layers subclass ``nn.Linear`` / ``nn.Embedding``, so the
``state_dict`` names and the converter's layout map are unchanged.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import groups


def _all_reduce(x, group, name):
    if x.dtype in (torch.bfloat16, torch.float16):
        return comm.all_reduce(x.float(), group=group, log_name=name).to(x.dtype)
    return comm.all_reduce(x.contiguous().clone(), group=group, log_name=name)


def _gather_last(x, group):
    """The ranks' ``x`` concatenated along the last dimension, in rank order."""
    return comm.all_gather_into_tensor(x.movedim(-1, 0), group=group, log_name="tp_gather").movedim(0, -1)


def _split_last(x, group):
    n = x.shape[-1] // group.size
    return x.narrow(-1, group.rank * n, n).contiguous()


class _CopyToModelParallel(torch.autograd.Function):
    """Identity forward, all-reduce backward (a column-parallel input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, "tp_input_grad"), None


class _ReduceFromModelParallel(torch.autograd.Function):
    """All-reduce forward, identity backward (a row-parallel output)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "tp_row")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModelParallel(torch.autograd.Function):
    """All-gather of the last dimension forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _split_last(grad, ctx.group), None


def copy_to_model_parallel(x, group):
    return x if group.size == 1 else _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x, group):
    return x if group.size == 1 else _ReduceFromModelParallel.apply(x, group)


def gather_from_model_parallel(x, group):
    return x if group.size == 1 else _GatherFromModelParallel.apply(x, group)


def _param(t):
    return nn.Parameter(t.detach().clone(), requires_grad=True) if t is not None else None


class LinearLayer(nn.Linear):
    """Column-parallel linear over this rank's output features."""

    def __init__(self, weight, bias=None, group=None, gather_output=False):
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight.shape
        self.weight = _param(weight)
        self.bias = _param(bias)
        self.mp_group = group if group is not None else groups.get_group(groups.MODEL_AXIS)
        self.gather_output = gather_output

    def forward(self, x):
        y = F.linear(copy_to_model_parallel(x, self.mp_group), self.weight, self.bias)
        return gather_from_model_parallel(y, self.mp_group) if self.gather_output else y


class LinearAllreduce(nn.Linear):
    """Row-parallel linear over this rank's input features."""

    def __init__(self, weight, bias=None, group=None):
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight.shape
        self.weight = _param(weight)
        self.bias = _param(bias)
        self.mp_group = group if group is not None else groups.get_group(groups.MODEL_AXIS)

    def forward(self, x):
        y = reduce_from_model_parallel(F.linear(x, self.weight), self.mp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class EmbeddingLayer(nn.Embedding):
    """An embedding over this rank's features, all-gathered."""

    def __init__(self, weight, group=None):
        nn.Module.__init__(self)
        self.num_embeddings, self.embedding_dim = weight.shape
        self.padding_idx = None
        self.max_norm = None
        self.norm_type = 2.0
        self.scale_grad_by_freq = False
        self.sparse = False
        self.weight = _param(weight)
        self.mp_group = group if group is not None else groups.get_group(groups.MODEL_AXIS)

    def forward(self, ids):
        return gather_from_model_parallel(F.embedding(ids, self.weight), self.mp_group)


class Normalize(nn.LayerNorm):
    """A LayerNorm, replicated on every rank."""


def shard(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Chunk ``rank`` of ``size`` of ``t`` along ``dim``."""
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over {size} ranks")
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def tp_slice(state_dict, specs: Dict[str, Optional[Tuple[str, int]]], rank: int, size: int,
             whole: Tuple[str, ...] = ()) -> dict:
    """The weights tensor-parallel rank ``rank`` of ``size`` holds, from
    whole ones: each tensor that ``specs`` (``auto_tp_specs``) places on the
    ``model`` axis cut to its :func:`shard`, a column-parallel linear's
    bias cut with its weight's rows, and everything else, and the names in
    ``whole``, kept whole (as :func:`apply_tensor_parallel` cuts them)."""
    out = {}
    for name, t in state_dict.items():
        owner, _, leaf = name.rpartition(".")
        spec = specs.get(f"{owner}.weight" if leaf == "bias" else name)
        if spec is not None and spec[0] == groups.MODEL_AXIS and name not in whole:
            if leaf != "bias":
                t = shard(t, spec[1], rank, size)
            elif spec[1] == 0:
                t = shard(t, 0, rank, size)
        out[name] = t
    return out


def apply_tensor_parallel(module: nn.Module, specs: Dict[str, Optional[Tuple[str, int]]], group=None) -> nn.Module:
    """Swap ``module``'s ``nn.Linear``/``nn.Embedding`` children placed on
    the ``model`` axis by ``specs`` (``auto_tp_specs``) for the layers
    above, each holding this rank's shard of the whole weight it replaces.
    A column-parallel linear that is its parent's only linear (the
    unembedding: AutoTP's single-kernel block) gathers its output. Raises where a sharded dimension
    does not divide over the group."""
    group = group if group is not None else groups.get_group(groups.MODEL_AXIS)
    if group.size == 1:
        return module
    for m in module.modules():
        for field in ("num_attention_heads", "num_key_value_heads"):
            n = getattr(getattr(m, "cfg", None), field, None)
            if n is not None and n % group.size:
                raise ValueError(f"tensor parallelism over {group.size} ranks needs {field} ({n}) to divide "
                                 "over them")
    for owner_name, owner in list(module.named_modules()):
        alone = sum(isinstance(c, nn.Linear) for c in owner.children()) == 1
        for child_name, child in list(owner.named_children()):
            full = f"{owner_name}.{child_name}" if owner_name else child_name
            spec = specs.get(f"{full}.weight")
            if spec is None or spec[0] != groups.MODEL_AXIS:
                continue
            dim = spec[1]
            if isinstance(child, nn.Embedding):
                new = EmbeddingLayer(shard(child.weight, dim, group.rank, group.size), group)
            elif isinstance(child, nn.Linear) and dim == 0:
                bias = shard(child.bias, 0, group.rank, group.size) if child.bias is not None else None
                new = LinearLayer(shard(child.weight, 0, group.rank, group.size), bias, group,
                                  gather_output=alone)
            elif isinstance(child, nn.Linear):
                new = LinearAllreduce(shard(child.weight, 1, group.rank, group.size), child.bias, group)
            else:
                continue
            setattr(owner, child_name, new.to(child.weight.device))
    return module
