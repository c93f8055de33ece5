"""Compression primitives.

Port of ``deepspeed_tpu/compression/basic_layer.py`` (reference
``deepspeed/compression/basic_layer.py``: LinearLayer_Compress with weight
quantization, row/head/sparse pruning). Pure functions over weight tensors in
the JAX package's layout (a linear layer's kernel ``[in, out]``; the engine
passes the transposed view of a ``Linear.weight``). Rounding is
``torch.round``, half to even, as ``jnp.round``; a threshold is the k-th
smallest value (``torch.kthvalue``), which is the reference's
``sort(x)[k - 1]``. A scale is divided by a tensor, never by a Python
number: on CUDA, ATen turns a division by a host scalar into a product with
its reciprocal, which rounds apart from the reference's division.
"""

import numpy as np
import torch


def _reduce_dims(w, per_channel, channel_axis):
    if per_channel and w.ndim > 1:
        return tuple(i for i in range(w.ndim) if i != (channel_axis % w.ndim))
    return None


def _mean(x, dims):
    return x.mean() if dims is None else x.mean(dim=dims, keepdim=True)


def _sum(x, dims):
    return x.sum() if dims is None else x.sum(dim=dims, keepdim=True)


def _div(x, number):
    """``x / number``, rounded as one IEEE division on every device."""
    return x / torch.full_like(x, number)


def fake_quantize(w, bits: int = 8, symmetric: bool = True, per_channel: bool = True, channel_axis: int = -1):
    """Quantize-dequantize (the reference's training-time fake quant,
    ``deepspeed/compression/utils.py`` Quantizer): keeps dtype and shape,
    snaps values to the 2^bits grid so that training sees the quantization
    error."""
    w = torch.as_tensor(w)
    dims = _reduce_dims(w, per_channel, channel_axis)
    if bits == 1:
        # XTC binarization (BinaryQuantizer): sign(w) scaled by the mean
        # magnitude; sign() keeps exact zeros (pruned weights) at zero
        scale = _mean(w.abs(), dims)
        return (torch.sign(w) * scale).to(w.dtype)
    if bits == 2:
        # XTC ternarization (TernaryQuantizer): threshold at 0.7·mean|w|,
        # scale by the mean magnitude of the surviving entries
        mag = w.abs()
        thresh = 0.7 * _mean(mag, dims)
        mask = mag > thresh
        denom = _sum(mask, dims).clamp(min=1)
        scale = _sum(torch.where(mask, mag, torch.zeros_like(mag)), dims) / denom
        return (torch.sign(w) * scale * mask).to(w.dtype)
    qmax = 2.0**(bits - 1) - 1 if symmetric else 2.0**bits - 1
    if symmetric:
        amax = w.abs().amax() if dims is None else w.abs().amax(dim=dims, keepdim=True)
        scale = _div(amax, qmax).clamp(min=1e-12)
        return torch.round(w / scale).clamp(-qmax - 1, qmax) * scale
    lo = w.amin() if dims is None else w.amin(dim=dims, keepdim=True)
    hi = w.amax() if dims is None else w.amax(dim=dims, keepdim=True)
    scale = _div(hi - lo, qmax).clamp(min=1e-12)
    return torch.round((w - lo) / scale).clamp(0, qmax) * scale + lo


def kth_smallest(x, k: int):
    """The k-th smallest entry of ``x`` (1-based), as ``sort(x.flatten())[k - 1]``."""
    return torch.kthvalue(x.reshape(-1), k).values


def row_prune_mask(w, ratio: float, axis: int = 0):
    """L1-structured row pruning mask (reference LinearLayer_Compress
    row-pruning): zero the ``ratio`` fraction of rows with smallest L1 norm."""
    w = torch.as_tensor(w)
    other = tuple(i for i in range(w.ndim) if i != axis)
    norms = w.abs().sum(dim=other)
    k = int(np.floor(ratio * norms.shape[0]))
    if k == 0:
        return torch.ones(norms.shape, dtype=torch.bool, device=w.device)
    return norms > kth_smallest(norms, k)


def head_prune_mask(w, ratio: float, num_heads: int):
    """Attention-head pruning mask over an ``[in, H*D]`` projection
    (reference head-pruning): ``[H]`` bool keep-mask by per-head L1 norm."""
    w = torch.as_tensor(w)
    hd = w.shape[-1] // num_heads
    per_head = w.reshape(-1, num_heads, hd).abs().sum(dim=(0, 2))
    k = int(np.floor(ratio * num_heads))
    if k == 0:
        return torch.ones((num_heads, ), dtype=torch.bool, device=w.device)
    return per_head > kth_smallest(per_head, k)


def apply_head_mask(w, keep_mask, num_heads: int):
    hd = w.shape[-1] // num_heads
    m = torch.as_tensor(keep_mask, device=w.device).repeat_interleave(hd)
    return w * m[None, :].to(w.dtype)
