"""Ulysses sequence parallelism.

Port of ``deepspeed_tpu/sequence/layer.py``. The reference flips the
sharding of a global ``[B, S, H, D]`` array between the sequence and the
head dimension over the ``seq`` mesh axis, and GSPMD lowers each flip to
one all-to-all. The port runs one process a rank, so the flips are written
out as ``all_to_all_single`` over this rank's ``seq`` group, each wrapped in
:class:`_SeqAllToAll` (upstream DeepSpeed's autograd function, whose
backward is the opposite flip):

- :func:`seq_to_head_sharding`: ``[B, S/sp, H, D]`` (this rank's slice of
  the sequence, every head) to ``[B, S, H/sp, D]`` (the whole sequence, this
  rank's heads);
- :func:`head_to_seq_sharding`: the inverse.

:class:`DistributedAttention` runs a local attention between the two, so
the attention sees the whole sequence at a share of the heads.

Heads that the ranks do not divide: GSPMD pads such a dimension. The port
repeats K/V to the query heads when the KV heads do not divide over the
ranks (grouped-query attention then runs as multi-head attention, the same
function), and raises when the query heads do not.

16-bit tensors move as int32 pairs (``comm.all_to_all_single``: gloo has
no 16-bit all-to-all; the bytes are the same).
"""

from typing import Callable

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import groups


def _seq_to_head(x: torch.Tensor, group) -> torch.Tensor:
    B, s, H, D = x.shape
    sp = group.size
    if H % sp:
        raise ValueError(f"Ulysses: {H} heads do not divide over {sp} sequence-parallel ranks")
    # head chunk j goes to rank j; rank i's sequence chunk comes back from it
    send = x.reshape(B, s, sp, H // sp, D).permute(2, 0, 1, 3, 4)
    # got: [sp (source rank = sequence chunk), B, s, H/sp, D]
    got = comm.all_to_all_single(send, group=group, log_name="ulysses")
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp * s, H // sp, D)


def _head_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    B, S, h, D = x.shape
    sp = group.size
    # sequence chunk i goes to rank i; head chunk j comes back from rank j
    send = x.reshape(B, sp, S // sp, h, D).permute(1, 0, 2, 3, 4)
    # got: [sp (source rank = head chunk), B, S/sp, h, D]
    got = comm.all_to_all_single(send, group=group, log_name="ulysses")
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // sp, sp * h, D)


class _SeqAllToAll(torch.autograd.Function):
    """One Ulysses flip with the opposite flip as its backward."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return _seq_to_head(x, group) if to_heads else _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        flip = _head_to_seq if ctx.to_heads else _seq_to_head
        return flip(grad.contiguous(), ctx.group), None, None


def sequence_group(group=None):
    """``group`` as a ``RankGroup`` (default: this rank's ``seq`` group)."""
    if group is None or isinstance(group, str):
        return groups.get_group(group or groups.SEQ_AXIS)
    return group


def seq_to_head_sharding(x, group=None):
    """``[B, S/sp, H, D]`` → ``[B, S, H/sp, D]`` (reference ``single_all_to_all``)."""
    group = sequence_group(group)
    return x if group.size == 1 else _SeqAllToAll.apply(x, group, True)


def head_to_seq_sharding(x, group=None):
    """``[B, S, H/sp, D]`` → ``[B, S/sp, H, D]``."""
    group = sequence_group(group)
    return x if group.size == 1 else _SeqAllToAll.apply(x, group, False)


class DistributedAttention:
    """Reference ``DistributedAttention``: ``local_attention(q, k, v, *args,
    **kwargs)`` over ``[B, S, H, D]`` tensors, run on the whole sequence at
    this rank's share of the heads. Inputs and output are this rank's
    sequence slice ``[B, S/sp, H, D]``. ``sequence_process_group``: a
    ``RankGroup`` or a mesh axis name (default ``seq``)."""

    def __init__(self, local_attention: Callable, sequence_process_group=None, scatter_idx: int = 2,
                 gather_idx: int = 1):
        if (scatter_idx, gather_idx) != (2, 1):
            raise ValueError("DistributedAttention scatters the head dim (2) and gathers the sequence dim (1)")
        self.local_attn = local_attention
        self.group = sequence_process_group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def __call__(self, query, key, value, *args, **kwargs):
        group = sequence_group(self.group)
        if group.size == 1:
            return self.local_attn(query, key, value, *args, **kwargs)
        H, KVH = query.shape[2], key.shape[2]
        if KVH % group.size:
            # the KV heads do not divide over the ranks: run GQA as MHA
            key = key.repeat_interleave(H // KVH, dim=2)
            value = value.repeat_interleave(H // KVH, dim=2)
        q = seq_to_head_sharding(query, group)
        k = seq_to_head_sharding(key, group)
        v = seq_to_head_sharding(value, group)
        return head_to_seq_sharding(self.local_attn(q, k, v, *args, **kwargs), group)
