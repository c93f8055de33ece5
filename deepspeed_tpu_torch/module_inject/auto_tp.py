"""AutoTP: tensor-parallel placements from a module's structure alone.

Port of ``deepspeed_tpu/module_inject/auto_tp.py``. The reference walks
the flax parameter tree, whose dicts keep call order; the port walks the
same tree as the converter names it (``models/convert.py::
reference_names``: the JAX package's dotted names and shapes, a ``Linear``
weight read as its ``[in, out]`` kernel), built from the module's
parameters in registration order, and applies the reference's rules:

- in a block of two or more 2-D kernels, scanned in order, a kernel whose
  output width is the residual width and which follows at least one other
  kernel of its segment is the row-parallel linear that returns to the
  residual stream (sharded on its input dimension); every other kernel is
  column-parallel (sharded on its output dimension). One refinement: the
  row ends the run of kernels that project to the residual width. With
  multi-head attention q, k and v all do, and the reference's scan marks k
  row-parallel, which GSPMD can still run but which is no Megatron layout
  (k's heads would not be split like q's); the port marks o, the last of
  the run. Where the KV width differs from the residual width (GQA, the
  reference's own tests) the two agree;
- a block's only kernel is the unembedding when its output width is the
  vocab size (column-parallel over the vocab), else replicated (a router);
- embeddings are sharded on their feature dimension;
- expert banks (3-D and up) are sharded on their expert dimension, on the
  ``expert`` axis;
- 1-D leaves are replicated.

:func:`auto_tp_specs` returns ``{parameter name: (mesh axis, port dim)}``,
or None for a replicated parameter, in the port's layout (a column-parallel
``Linear`` weight ``[out, in]`` is split on dim 0).
"""

from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.models.convert import reference_names
from deepspeed_tpu_torch.utils import groups

COL, ROW = "col", "row"


def _is_leaf_dict(d):
    return isinstance(d, dict) and all(not isinstance(v, dict) for v in d.values())


def _direct_kernels(node, path):
    """2-D kernels owned by this block, in call order (reference
    ``_direct_kernels``)."""
    out = []
    for name, child in node.items():
        if isinstance(child, dict):
            if _is_leaf_dict(child):
                out.extend((path + (name, leaf), shape) for leaf, shape in child.items()
                           if leaf != "embedding" and len(shape) == 2)
        elif name != "embedding" and len(child) == 2:
            out.append((path + (name, ), child))
    return out


def _leaves(node, path=()):
    for name, child in node.items():
        if isinstance(child, dict):
            yield from _leaves(child, path + (name, ))
        else:
            yield path + (name, ), child


def auto_tp_specs(module: torch.nn.Module, model_axis: str = groups.MODEL_AXIS,
                  expert_axis: str = groups.EXPERT_AXIS, hidden_size: Optional[int] = None,
                  vocab_size: Optional[int] = None) -> Dict[str, Optional[Tuple[str, int]]]:
    """``{name: (axis, dim) or None}`` for every parameter of ``module``
    (see the module doc); ``hidden_size``/``vocab_size`` are read from the
    largest embedding when not given."""
    names = reference_names(module)
    root, port = {}, {}
    for name, p in module.named_parameters():
        ref, transposed = names[name]
        parts = tuple(ref.split("."))
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tuple(reversed(p.shape)) if transposed else tuple(p.shape)
        port[parts] = (name, transposed)

    leaves = list(_leaves(root))
    if hidden_size is None or vocab_size is None:
        embeds = [shape for path, shape in leaves if path[-1] == "embedding" and len(shape) == 2]
        if embeds:
            biggest = max(embeds, key=lambda s: s[0])
            vocab_size = vocab_size or biggest[0]
            hidden_size = hidden_size or biggest[1]
    if hidden_size is None:
        widths = Counter(shape[1] for _, shape in leaves if len(shape) == 2)
        hidden_size = widths.most_common(1)[0][0] if widths else -1

    cls = {}

    def walk(node, path):
        kernels = _direct_kernels(node, path)
        if len(kernels) >= 2:
            seg_has_col = False
            for i, (kpath, shape) in enumerate(kernels):
                # the row ends the run of kernels back to the residual width
                # (multi-head attention: q, k, v all project to it, o ends it)
                run_goes_on = i + 1 < len(kernels) and kernels[i + 1][1][1] == hidden_size
                if shape[1] == hidden_size and seg_has_col and not run_goes_on:
                    cls[kpath] = ROW
                    seg_has_col = False
                else:
                    cls[kpath] = COL
                    seg_has_col = True
        elif len(kernels) == 1:
            kpath, shape = kernels[0]
            if vocab_size is not None and shape[1] == vocab_size:
                cls.setdefault(kpath, COL)
        for name, child in node.items():
            if isinstance(child, dict) and not _is_leaf_dict(child):
                walk(child, path + (name, ))

    walk(root, ())

    out = {}
    for path, shape in leaves:
        name, transposed = port[path]
        ndim = len(shape)
        ref_spec = None
        if path[-1] == "embedding" and ndim == 2:
            ref_spec = (model_axis, 1)
        elif ndim >= 3:
            ref_spec = (expert_axis, 0)
        elif ndim == 2 and path in cls:
            ref_spec = (model_axis, 1 if cls[path] == COL else 0)
        if ref_spec is not None and transposed:
            ref_spec = (ref_spec[0], ndim - 1 - ref_spec[1])
        out[name] = ref_spec
    return out
