"""ZeRO stages as placement rules.

Port of ``deepspeed_tpu/runtime/zero/policy.py``. The reference gives each
stage a ``PartitionSpec`` for the parameters, the gradient-accumulation
buffer and the optimizer state, and XLA inserts the collectives; the port's
engine does the same placement by hand over ``comm``'s collectives
(``runtime/zero/partition_parameters.py``):

  stage 0: everything replicated; gradients all-reduced;
  stage 1: the optimizer state sharded: each rank updates its shard, then
           the updated parameters are all-gathered;
  stage 2: also the gradient-accumulation buffer: gradients are
           reduce-scattered into it;
  stage 3: also the parameters: gathered layer by layer before the layer's
           forward, released after, gathered again for its backward, and
           their gradients reduce-scattered.

The rule (``policy.py:59-112`` there): a tensor is sharded over the ZeRO
axes on its first dimension that the ZeRO degree divides; it stays
replicated when it has at most ``persistence_threshold`` elements (stage 3
only, as the reference's engine passes it) or when nothing divides. A
tensor that another placement already splits (a tensor-parallel shard on
the ``model`` axis, an expert bank on the ``expert`` axis) is partitioned
on top of its shard: the ZeRO axes never take that dimension, and the
threshold reads the whole tensor's size (``_add_zero_axes``). The rule
is stated in the reference's layout (:func:`zero_shard_dim`, a pure
function of shape, degree and threshold); the port holds a ``Linear``
weight transposed (``[out, in]`` for the flax kernel's ``[in, out]``), so
:func:`port_dim` maps the reference's dimension through the converter's
transpose (``models/convert.py::reference_names``).
"""

from typing import Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.utils import groups


def zero_shard_dim(shape: Sequence[int], degree: int, persistence_threshold: int = 0,
                   taken: Optional[Tuple[int, int]] = None) -> Optional[int]:
    """The dimension the ZeRO rule shards a tensor of ``shape`` on over
    ``degree`` ranks (the reference's layout), or None for replicated.
    ``taken``: ``(dim, ranks)`` when ``shape`` is this rank's shard of a
    tensor another placement splits on ``dim`` over ``ranks``."""
    if degree <= 1 or len(shape) == 0:
        return None
    if int(np.prod(shape)) * (taken[1] if taken else 1) <= persistence_threshold:
        return None
    for dim, size in enumerate(shape):
        if taken is not None and dim == taken[0]:
            continue
        if size > 0 and size % degree == 0:
            return dim
    return None


def port_dim(ref_dim: Optional[int], ndim: int, transposed: bool) -> Optional[int]:
    """The port's dimension for the reference's ``ref_dim`` of a tensor the
    port holds transposed or not."""
    if ref_dim is None or not transposed:
        return ref_dim
    return ndim - 1 - ref_dim


def reference_shape(shape: Sequence[int], transposed: bool) -> Tuple[int, ...]:
    return tuple(reversed(tuple(shape))) if transposed else tuple(shape)


class ZeroShardingPolicy:
    """The reference's policy object over the port's rank mesh: ``*_spec``
    return a spec tuple in the reference's layout (one entry a dimension,
    None or the ZeRO axes), as the reference's ``PartitionSpec`` reads;
    ``*_dim`` return the sharded dimension alone."""

    def __init__(self, stage: int, mesh=None, zero_axes=None, tp_axis=groups.MODEL_AXIS,
                 persistence_threshold: int = 0, param_axes=None):
        self.stage = stage
        self.mesh = mesh if mesh is not None else groups.get_mesh()
        self.zero_axes = tuple(zero_axes) if zero_axes is not None else groups.get_zero_partition_axes()
        self.zero_axes = tuple(ax for ax in self.zero_axes if self.mesh.shape.get(ax, 1) > 1)
        self.zero_size = int(np.prod([self.mesh.shape[ax] for ax in self.zero_axes])) if self.zero_axes else 1
        self.param_axes = tuple(ax for ax in param_axes if self.mesh.shape.get(ax, 1) > 1) \
            if param_axes is not None else None
        self.tp_axis = tp_axis
        self.persistence_threshold = persistence_threshold

    def _spec(self, shape, axes=None, taken=None):
        axes = self.zero_axes if axes is None else axes
        degree = int(np.prod([self.mesh.shape[ax] for ax in axes])) if axes else 1
        dim = zero_shard_dim(shape, degree, self.persistence_threshold, taken)
        spec = [None] * len(shape)
        if dim is not None:
            spec[dim] = axes if len(axes) > 1 else axes[0]
        return tuple(spec)

    def param_spec(self, shape, taken=None):
        return self._spec(shape, self.param_axes, taken) if self.stage >= 3 else (None, ) * len(shape)

    def grad_spec(self, shape, taken=None):
        """Placement of the gradient-accumulation buffer."""
        return self._spec(shape, taken=taken) if self.stage >= 2 else self.param_spec(shape, taken)

    def opt_spec(self, shape, taken=None):
        return self._spec(shape, taken=taken) if self.stage >= 1 else (None, ) * len(shape)

    @staticmethod
    def spec_dim(spec) -> Optional[int]:
        dims = [d for d, entry in enumerate(spec) if entry is not None]
        return dims[0] if dims else None

    def param_dim(self, shape, taken=None):
        return self.spec_dim(self.param_spec(shape, taken))

    def grad_dim(self, shape, taken=None):
        return self.spec_dim(self.grad_spec(shape, taken))

    def opt_dim(self, shape, taken=None):
        return self.spec_dim(self.opt_spec(shape, taken))
