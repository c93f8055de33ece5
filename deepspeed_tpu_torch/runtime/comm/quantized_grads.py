"""qgZ: the data-parallel gradients reduced as int8 blocks.

Port of ``deepspeed_tpu/runtime/comm/quantized_grads.py``. With
``zero_quantized_gradients`` at ZeRO <= 2 on a mesh that is data parallel
only, each micro-step's gradients cross the wire as blockwise int8 with f32
scales (``runtime/comm/compressed.quantized_reduce_scatter``) instead of
being reduced exactly. Otherwise the engine logs the reference's warning
and reduces exactly.

The reference ravels the gradient tree (``ravel_pytree``: its leaves in
sorted-key order, each in C order), pads the flat vector to whole blocks of
every rank's chunk, reduce-scatters it as int8, and unravels the reduced
chunks into a replicated tree (XLA all-gathers them; the engine then lays
the tree out as its ZeRO stage places the gradients). The port does the
same in the same layout: it flattens the gradients under their JAX names
and in the JAX layout (a ``Linear`` weight transposed,
``models/convert.reference_names``), so the int8 blocks are the
reference's, then all-gathers the f32 chunks and unflattens them into the
port's names and layout. The result is the sum over the ranks (the
reference's mean times the ranks: the engine divides at the step).
"""

import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.runtime.comm.compressed import quantized_reduce_scatter
from deepspeed_tpu_torch.utils import groups

QGZ_BLOCK = 512


def qgz_supported(mesh, stage: int) -> bool:
    """qgZ needs replicated parameters (stage <= 2) and a data-parallel-only
    mesh of more than one rank."""
    if stage > 2:
        return False
    if mesh.shape.get(groups.DATA_AXIS, 1) <= 1:
        return False
    return all(mesh.shape.get(ax, 1) <= 1 for ax in (groups.PIPE_AXIS, groups.HPZ_AXIS, groups.EXPERT_AXIS,
                                                      groups.SEQ_AXIS, groups.MODEL_AXIS))


class QuantizedGradReducer:
    """The qgZ reduction of one module's gradients over ``group``."""

    def __init__(self, module, group, block: int = QGZ_BLOCK):
        from deepspeed_tpu_torch.models.convert import reference_names

        names = reference_names(module)
        # ravel_pytree's order: the JAX tree's keys sorted at every level
        self.order = sorted(names, key=lambda n: tuple(names[n][0].split(".")))
        self.transposed = {n: names[n][1] for n in names}
        self.group = group
        self.block = block

    def flatten(self, grads):
        """The gradients as the reference's flat f32 vector."""
        return torch.cat([(grads[n].t() if self.transposed[n] else grads[n]).float().reshape(-1)
                          for n in self.order])

    def unflatten(self, flat, like):
        out, off = {}, 0
        for n in self.order:
            shape = like[n].shape
            ref_shape = tuple(reversed(shape)) if self.transposed[n] else tuple(shape)
            k = like[n].numel()
            piece = flat[off:off + k].reshape(ref_shape)
            out[n] = piece.t().contiguous() if self.transposed[n] else piece
            off += k
        return out

    def reduce(self, grads):
        """The gradients summed over the group's ranks, in f32, moved as
        int8 blocks (then the f32 chunks all-gathered)."""
        n = self.group.size
        flat = self.flatten(grads)
        total = flat.numel()
        pad = (-total) % (n * self.block)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        chunk = quantized_reduce_scatter(flat, group=self.group, block=self.block)
        full = dist.all_gather_into_tensor(chunk, group=self.group)[:total]
        return self.unflatten(full, grads)
