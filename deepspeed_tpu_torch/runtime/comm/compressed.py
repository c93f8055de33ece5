"""Compressed collectives: the 1-bit error-feedback all-reduce and the
blockwise int8 reduce-scatter (ZeRO++ qgZ).

Port of ``deepspeed_tpu/runtime/comm/compressed.py``. The reference runs
each as the body of a ``shard_map`` over a mesh axis; the port runs one
process a rank, and each rank passes its own tensor to the functions below,
which move the quantized payloads over ``comm``'s collectives (int8 on the
wire, one byte an element where the exact collective moves four):

- :func:`compressed_allreduce` (reference ``:26-100``): sign compression
  with a per-tensor L1 scale, the worker error feedback (full size, per
  rank) and the server error feedback (one chunk, per rank); the signs go
  by all-to-all, the scales by all-gather, and the server's compressed
  chunks come back by all-gather;
- :func:`quantized_reduce_scatter` (reference ``:103-152``): each rank's
  chunk of the tensor is padded to whole blocks of ``block`` (512), each
  block quantized to int8 with an f32 scale ``max|x| / 127``; the int8
  blocks and their scales go by all-to-all, and each rank dequantizes and
  sums what it received: its chunk of the sum over the ranks.

These are plain torch ops over the collectives, as the reference's are XLA
ops outside any kernel (ROADMAP's North star: a hand kernel comes when a
profile on the card asks for one).
"""

import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm.comm import _resolve_group


def _sign_compress(x):
    """Per-tensor L1 scale and int8 signs (``sign(0) == 0``)."""
    return x.abs().mean(), torch.sign(x).to(torch.int8)


def compressed_allreduce(x, worker_error, server_error, group=None):
    """The 1-bit all-reduce of this rank's ``x [N]`` (N divisible by the
    group size n) with its ``worker_error [N]`` and ``server_error
    [N // n]``. Returns ``(average [N], new_worker_error,
    new_server_error)``, as the reference's per-rank body does."""
    g = _resolve_group(group)
    n = g.size
    if n <= 1:
        return x, worker_error, server_error
    N = x.shape[0]
    if N % n:
        raise ValueError(f"compressed_allreduce: length {N} must divide into {n} chunks")
    chunk = N // n
    compensated = x + worker_error
    w_scale, w_sign = _sign_compress(compensated)
    new_worker_error = compensated - w_scale * w_sign.to(x.dtype)
    # every rank receives every rank's signs for its own chunk (int8)
    my_signs = dist.all_to_all_single(w_sign.reshape(n, chunk), group=g)
    scales = dist.all_gather_into_tensor(w_scale.reshape(1), group=g)
    server_avg = torch.einsum("r,rc->c", scales, my_signs.to(x.dtype)) / n
    comp_server = server_avg + server_error
    s_scale, s_sign = _sign_compress(comp_server)
    new_server_error = comp_server - s_scale * s_sign.to(x.dtype)
    all_signs = dist.all_gather_into_tensor(s_sign.reshape(1, chunk), group=g)
    all_scales = dist.all_gather_into_tensor(s_scale.reshape(1), group=g)
    out = (all_scales[:, None] * all_signs.to(x.dtype)).reshape(N)
    return out, new_worker_error, new_server_error


def quantize_blocks(x, n_ranks: int, block: int = 512):
    """``x [N]`` (N divisible by ``n_ranks``) as ``n_ranks`` chunks padded
    to whole blocks: ``(q int8 [n, nb, block], scale f32 [n, nb, 1])``."""
    N = x.shape[0]
    chunk = N // n_ranks
    nb = -(-chunk // block)
    pad = nb * block - chunk
    v = x.reshape(n_ranks, chunk)
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(n_ranks, nb, block)
    scale = torch.clamp(v.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_reduce_scatter(x, group=None, block: int = 512):
    """This rank's chunk ``[N // n]`` of the sum over the group's ranks of
    their ``x [N]``, moved as int8 blocks and f32 block scales."""
    g = _resolve_group(group)
    n = g.size
    if n <= 1:
        return x
    N = x.shape[0]
    if N % n:
        raise ValueError(f"reduce-scatter length {N} must be divisible by the group size {n} "
                         f"(pad the flat gradient first)")
    q, scale = quantize_blocks(x.float(), n, block)
    q_recv = dist.all_to_all_single(q, group=g)
    s_recv = dist.all_to_all_single(scale, group=g)
    deq = q_recv.to(torch.float32) * s_recv
    return deq.sum(dim=0).reshape(-1)[:N // n]
