"""Weight quantization for the ragged engine (int8, or int4 packed in int32).

Port of ``deepspeed_tpu/inference/v2/quantization.py``. A quantized weight
is a ``{QKEY | Q4KEY, SKEY, DKEY}`` dict in place of its tensor: per output
channel symmetric int8 (``[-127, 127]``), or int4 (``[-7, 7]``) with 8
consecutive nibbles of the contraction axis packed into one int32 word; an
f32 scale per output channel; and a 0-d tensor of the weight's dtype.

The reference quantizes its flax tree, whose Dense kernels are ``[in, out]``
and whose contraction axis is -2. The port's weights are ``state_dict``
tensors: a Linear's ``*.weight`` is ``[out, in]`` (its contraction axis is
-1), while embeddings, Mixtral's router ``gate [M, E]`` and expert banks
keep the reference's layout (axis -2). So each tensor here is quantized
along its own contraction axis, and the result is the reference's
transposed where the weight is: the same int8 values, packed words and
scales (``models/convert.py`` carries the keys to and from the reference's
paths).

Arithmetic kept bit for bit: the scale is the largest magnitude over the
contraction axis divided by the levels in the weight's own dtype, clamped
at 1e-12 there, then cast to f32; the weight is divided by it in f32,
rounded half to even, clipped; the nibbles are OR-ed into int32 words (the
high nibble's sign bit wraps as the reference's int32 sum does). A
dequantized weight is ``(q · scale)`` in f32, cast to the weight's dtype.

The engine dequantizes a weight where its layer reads it
(:class:`DequantizingParams`), so the full-precision copy of one weight at
a time lives for one product; the tree at rest stays int8 / packed int4.
"""

from typing import Mapping, Optional

import torch

QKEY = "__wq_int8__"
Q4KEY = "__wq_int4x8__"  # 8 consecutive contraction-axis nibbles an int32 word
SKEY = "__wq_scale__"
DKEY = "__wq_dtype__"
EMBEDDINGS = ("embed_tokens.weight", "embed_positions.weight")


def contracts_last(name: str, t: torch.Tensor) -> bool:
    """Whether ``t`` (the ``state_dict`` entry ``name``) is a Linear weight
    ``[out, in]``, whose contraction axis is the last: a 2-d ``*.weight``
    that is not an embedding's."""
    return t.dim() == 2 and name.endswith(".weight") and not name.endswith(EMBEDDINGS)


def _scale(w, levels, axis):
    # in the weight's own dtype, as the reference computes it, then f32
    s = w.abs().amax(dim=axis, keepdim=True) / levels
    return torch.maximum(s, torch.tensor(1e-12, dtype=w.dtype, device=w.device)).float()


def _quantize_leaf(w, axis):
    scale = _scale(w, 127.0, axis)
    q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return {QKEY: q, SKEY: scale, DKEY: torch.zeros((), dtype=w.dtype, device=w.device)}


def _quantize_leaf_int4(w, axis):
    scale = _scale(w, 7.0, axis)
    q = torch.clamp(torch.round(w.float() / scale), -7, 7).to(torch.int32)
    q = q.movedim(axis, -1)  # [..., K]: 8 consecutive nibbles of K a word
    q = q.reshape(*q.shape[:-1], q.shape[-1] // 8, 8) & 0xF
    packed = torch.zeros(q.shape[:-1], dtype=torch.int32, device=w.device)
    for i in range(8):
        packed |= q[..., i] << (4 * i)
    return {Q4KEY: packed.movedim(-1, axis).contiguous(), SKEY: scale,
            DKEY: torch.zeros((), dtype=w.dtype, device=w.device)}


def dequantize_leaf(node, name: str = "") -> torch.Tensor:
    """One quantized leaf (the ``state_dict`` entry ``name``, whose name
    says its contraction axis: :func:`contracts_last`) back to a tensor of
    its dtype."""
    if Q4KEY in node:
        axis = -1 if contracts_last(name, node[Q4KEY]) else -2
        p = node[Q4KEY].movedim(axis, -1)
        shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=p.device)
        v = (p[..., None] >> shifts) & 0xF  # [..., K/8, 8]
        v = v - 16 * (v >= 8).to(torch.int32)  # sign-extend the 4-bit two's complement
        q = v.reshape(*p.shape[:-1], p.shape[-1] * 8).movedim(-1, axis)
    else:
        q = node[QKEY]
    return (q.float() * node[SKEY]).to(node[DKEY].dtype)


def is_quantized_leaf(node) -> bool:
    return isinstance(node, Mapping) and (QKEY in node or Q4KEY in node)


def quantize_tree(params, min_size: int = 4096, bits: int = 8):
    """Quantize every floating tensor of 2 or more dimensions and at least
    ``min_size`` elements (norms, biases and small tensors stay as they
    are). ``bits`` 8 or 4; at 4 a tensor whose contraction axis is not a
    multiple of 8 is quantized to int8. A leaf already quantized stays as
    it is (C24: the reference quantizes its scale again), so a quantized
    ``serialize`` directory loads back quantized. Nested dicts are walked;
    a name is the dotted path."""
    if bits not in (8, 4):
        raise NotImplementedError(f"weight quantization supports bits=8 (int8) and bits=4 (packed int4), got {bits}")

    def rec(node, name):
        if is_quantized_leaf(node):
            return node
        if isinstance(node, Mapping):
            return {k: rec(v, f"{name}.{k}" if name else k) for k, v in node.items()}
        if (isinstance(node, torch.Tensor) and node.dim() >= 2 and node.is_floating_point()
                and node.numel() >= min_size):
            axis = -1 if contracts_last(name, node) else -2
            if bits == 4 and node.shape[axis] % 8 == 0:
                return _quantize_leaf_int4(node, axis)
            return _quantize_leaf(node, axis)
        return node

    return rec(params, "")


def dequantize_tree(params, name: str = ""):
    """Every quantized leaf back to a tensor of its dtype (names as in
    :func:`quantize_tree`)."""
    if is_quantized_leaf(params):
        return dequantize_leaf(params, name)
    if isinstance(params, Mapping):
        return {k: dequantize_tree(v, f"{name}.{k}" if name else k) for k, v in params.items()}
    return params


def tree_nbytes(params) -> int:
    """Bytes of every tensor in a (possibly quantized) tree: the weights at rest."""
    if isinstance(params, Mapping):
        return sum(tree_nbytes(v) for v in params.values())
    return params.numel() * params.element_size() if isinstance(params, torch.Tensor) else 0


class DequantizingParams(dict):
    """The engine's weights with quantized leaves at rest: reading a name
    (``p[name]``, ``p.get(name)``) returns its tensor, dequantized there
    for the one use; ``items()``/``values()`` see the stored leaves."""

    def __getitem__(self, name):
        node = super().__getitem__(name)
        return dequantize_leaf(node, name) if is_quantized_leaf(node) else node

    def get(self, name, default: Optional[torch.Tensor] = None):
        return self[name] if name in self else default
