"""Pipeline-parallel module description.

Port of ``deepspeed_tpu/runtime/pipe/module.py``: ``LayerSpec`` (a layer
built lazily from its class and arguments: here a ``torch.nn.Module``),
``TiedLayerSpec``, ``partition_uniform`` and ``partition_balanced`` (the
reference's functions, giving the same boundaries), and ``PipelineModule``
with ``partition_layers`` and ``stage_layers``.

The port's ``PipelineEngine`` (``runtime/pipe/engine.py``) runs one process
a stage: each builds only its stage's layers. The reference's engine stacks
the homogeneous middle layers and runs the pre layers on the first stage
and the post layers on the last; the port's stages are the module's
``partition_layers(method="uniform")`` boundaries, which the reference's
engine also sets, and for its ``[pre, stack, post]`` models of a stack that
the stages divide they put the same layers on each stage.
"""

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class LayerSpec:
    """Reference module.py:30 — a lazily-built layer: class + ctor args."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not issubclass(typename, object):
            raise RuntimeError("LayerSpec only supports classes")

    def build(self, log=False):
        if log:
            logger.info(f"Building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        args = [str(a) for a in self.module_args] + [f"{k}={v!r}" for k, v in self.module_kwargs.items()]
        return f"{self.typename.__name__}({', '.join(args)})"


class TiedLayerSpec(LayerSpec):
    """Layers sharing parameters (e.g. embed and unembed) under one ``key``:
    a stage builds the module once and each use calls it (through
    ``forward_fn(module, x)`` where given); stages that each hold a copy
    have their gradients all-reduced at ``ReduceTiedGrads`` (the
    reference's tied-weight all-reduce, ``executor.py:145``)."""

    def __init__(self, key, typename, *module_args, forward_fn=None, tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_uniform(num_items, num_parts):
    """Reference ds_utils.partition_uniform: even split, remainder to the front."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    rem = num_items % num_parts
    offset = 0
    for p in range(num_parts):
        parts[p] = offset
        offset += chunk + (1 if p < rem else 0)
    parts[num_parts] = num_items
    return parts


def partition_balanced(weights, num_parts):
    """Reference ds_utils.partition_balanced — minimize the max part weight
    (binary search over the bottleneck + greedy check)."""
    weights = list(weights)
    n = len(weights)
    prefix = np.concatenate([[0], np.cumsum(weights)])

    def feasible(cap):
        parts = [0]
        cur = 0
        for i, w in enumerate(weights):
            if w > cap:
                return None
            if cur + w > cap:
                parts.append(i)
                cur = 0
            cur += w
        parts.append(n)
        return parts if len(parts) <= num_parts + 1 else None

    lo, hi = max(weights) if weights else 0, float(prefix[-1])
    best = None
    for _ in range(64):
        mid = (lo + hi) / 2
        p = feasible(mid)
        if p is not None:
            best = p
            hi = mid
        else:
            lo = mid
    if best is None:
        best = [0, n]
    # pad to exactly num_parts boundaries
    while len(best) < num_parts + 1:
        best.insert(-1, best[-1])
    return best


class PipelineModule:
    """Reference module.py:86. Holds the layer list, builds stage partitions.

    Args follow the reference: ``layers`` (list of LayerSpec or callables),
    ``num_stages`` or ``topology``, ``partition_method`` in
    {'uniform', 'parameters', 'type:regex'}, ``loss_fn``, ``activation_checkpoint_interval``.
    """

    def __init__(self,
                 layers,
                 num_stages=None,
                 topology=None,
                 loss_fn=None,
                 seed_layers=False,
                 base_seed=1234,
                 partition_method="parameters",
                 activation_checkpoint_interval=0,
                 checkpointable_layers=None):
        self._layer_specs = list(layers)
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.checkpointable_layers = checkpointable_layers

        if num_stages is None and topology is None:
            raise RuntimeError("must provide num_stages or topology")
        if topology is not None:
            self.num_stages = topology.get_dim("pipe")
            self._topo = topology
        else:
            self.num_stages = num_stages
            self._topo = None

        self.parts = None  # stage boundaries, computed by partition_layers

    def __len__(self):
        return len(self._layer_specs)

    def build_layers(self):
        """Materialize every LayerSpec into a module/callable."""
        out = []
        for spec in self._layer_specs:
            out.append(spec.build() if isinstance(spec, LayerSpec) else spec)
        return out

    def _count_layer_params(self, params_per_layer=None):
        """One a layer unless given (the reference's estimate, kept so that
        ``partition_layers`` gives its boundaries)."""
        if params_per_layer is not None:
            return params_per_layer
        return [1] * len(self._layer_specs)

    def partition_layers(self, method=None, params_per_layer=None):
        """Reference _partition_layers:370 — compute self.parts stage boundaries."""
        method = (method or self.partition_method).lower()
        n = len(self._layer_specs)
        if method == "uniform":
            self.parts = partition_uniform(n, self.num_stages)
        elif method == "parameters":
            weights = params_per_layer or self._count_layer_params()
            self.parts = partition_balanced(weights, self.num_stages)
        elif method.startswith("type:"):
            import re
            pat = method.split(":", 1)[1]
            weights = [1 if re.search(pat, type(s).__name__ if not isinstance(s, LayerSpec) else
                                      s.typename.__name__, re.IGNORECASE) else 0 for s in self._layer_specs]
            self.parts = partition_balanced(weights, self.num_stages)
        else:
            raise NotImplementedError(f"Partitioning method {method} not implemented")
        return self.parts

    def stage_layers(self, stage_id):
        if self.parts is None:
            self.partition_layers()
        return self._layer_specs[self.parts[stage_id]:self.parts[stage_id + 1]]

    def topology(self):
        return self._topo
