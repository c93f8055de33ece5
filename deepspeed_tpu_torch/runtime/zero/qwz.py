"""qwZ: ZeRO++'s quantized weight all-gather at stage 3.

Port of ``deepspeed_tpu/runtime/zero/qwz.py``. Each rank quantizes its own
f32 master chunk along the ZeRO-sharded dimension, with one symmetric scale
a row of that dimension (the scale reduces every other dimension, so no
communication comes before the gather): int8 in [-127, 127], or with
``zero_quantized_weights_bits`` 4, values in [-7, 7] packed two to a byte
along a dimension that is not gathered (:func:`nibble_pack_dim`). Only that
payload and the f32 scales are all-gathered; the dequantization
(``q * scale``, cast to the compute dtype) comes after the gather.

In the port the gather is a ZeRO-3 unit's (``partition_parameters.py``):
per layer, for the forward and again for the backward. qwZ changes what it
moves, not where it happens. The gradient is straight-through: the unit's
backward differentiates through the dequantized weights as if the cast were
exact, and reduce-scatters that gradient exactly (reference ``:163-174``).

Which tensors: floating, at least 2-D, at least ``threshold`` (2048)
elements whole, and ZeRO-sharded; the others are gathered exactly in the
compute dtype, as the reference casts them. The pack dimension is chosen in
the reference's layout and mapped through the converter's transpose, so a
rank's payload is the reference's for the same shard, transposed.
"""

import torch

from deepspeed_tpu_torch.runtime.zero.policy import port_dim, reference_shape

QWZ_THRESHOLD = 2048


def qwz_supported(stage: int) -> bool:
    return stage >= 3


def nibble_pack_dim(shape, gather_dim):
    """The reference's choice of a dimension to pack nibble pairs along (in
    its layout): the last dimension other than ``gather_dim`` whose size is
    even; None where there is none (that tensor moves as int8)."""
    for d in range(len(shape) - 1, -1, -1):
        if d != gather_dim and shape[d] % 2 == 0:
            return d
    return None


def pack_nibbles(q, dim):
    """int8 values in [-7, 7] -> two 4-bit nibbles a byte along ``dim``
    (even size)."""
    q = q.movedim(dim, -1)
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8).movedim(-1, dim).contiguous()


def unpack_nibbles(p, dim):
    """The inverse of :func:`pack_nibbles` (sign-extending each nibble)."""
    p = p.movedim(dim, -1).to(torch.int16)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - 16 * (lo >= 8).to(torch.int16)
    hi = hi - 16 * (hi >= 8).to(torch.int16)
    q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return q.to(torch.int8).movedim(-1, dim).contiguous()


def _f32_reciprocal(x):
    return torch.tensor(1.0, dtype=torch.float32) / torch.tensor(x, dtype=torch.float32)


def quantize_shard(w, dim, bits=8):
    """Symmetric per-row quantization of ``w`` along ``dim``: ``(q int8,
    scale f32)``, the scale of size 1 on every other dimension."""
    levels = 7.0 if bits == 4 else 127.0
    red = tuple(i for i in range(w.ndim) if i != dim)
    # times the f32 reciprocal: XLA compiles the reference's "/ levels" in
    # its jitted cast so (a true division differs in the last bit)
    scale = torch.clamp(w.abs().amax(dim=red, keepdim=True) * _f32_reciprocal(levels), min=1e-12)
    q = torch.clamp(torch.round(w / scale), -levels, levels).to(torch.int8)
    return q, scale


class QuantizedWeightGather:
    """The qwZ gather of one partitioner's stage-3 units (see the module
    doc)."""

    def __init__(self, part, compute_dtype, bits: int = 8, threshold: int = QWZ_THRESHOLD):
        if bits not in (8, 4):
            raise ValueError(f"zero_quantized_weights_bits must be 8 or 4, got {bits}")
        self.part = part
        self.compute_dtype = compute_dtype
        self.bits = bits
        self.threshold = threshold
        self.gathers = 0  # quantized gathers made (forward and backward)

    def applies(self, name, dim) -> bool:
        shape = self.part.shapes[name]
        numel = 1
        for s in shape:
            numel *= s
        return dim is not None and len(shape) >= 2 and numel >= self.threshold and \
            self.part.masters[name].is_floating_point()

    def pack_dim(self, name, dim):
        """The port's pack dimension for ``name`` gathered on ``dim`` (None:
        int8 on the wire)."""
        if self.bits != 4:
            return None
        shape, transposed = self.part.shapes[name], self.part.transposed[name]
        ndim = len(shape)
        ref_gather = port_dim(dim, ndim, transposed)  # the map is its own inverse
        ref = nibble_pack_dim(reference_shape(shape, transposed), ref_gather)
        return port_dim(ref, ndim, transposed)

    def payload(self, name, chunk, dim):
        """What this rank puts on the wire for its master ``chunk``:
        ``(q, scale, pack_dim)``."""
        pack = self.pack_dim(name, dim)
        # int4 levels only where the nibbles pack; else int8, as the reference
        q, scale = quantize_shard(chunk.float(), dim, 4 if pack is not None else 8)
        if pack is not None:
            q = pack_nibbles(q, pack)
        return q, scale, pack

    def gather(self, name, chunk, dim):
        """The whole weight in the compute dtype, from every rank's quantized
        chunk."""
        q, scale, pack = self.payload(name, chunk, dim)
        q_full = self.part.gather(q, dim, param=True)
        s_full = self.part.gather(scale, dim, param=True)
        if pack is not None:
            q_full = unpack_nibbles(q_full, pack)
        self.gathers += 1
        return (q_full.to(torch.float32) * s_full).to(self.compute_dtype)
