"""Weights carried across from the JAX package.

``from_flax_params`` takes the param tree of ``deepspeed_tpu.models.llama``
(nested dicts of numpy arrays) and returns the port's ``state_dict``-keyed
weights (see ``models/llama.py``):

- a flax ``Dense`` ``kernel`` is ``[in, out]``; a torch ``Linear.weight`` is
  ``[out, in]``, so kernels are transposed; biases stay;
- ``embed_tokens/embedding`` ``[V, hidden]`` is ``nn.Embedding.weight`` as is;
- ``LlamaForCausalLM`` nests everything under ``"model"`` (``lm_head``
  included), while other trees put it at the root: both are accepted.
"""

from collections.abc import Mapping

import numpy as np
import torch

from deepspeed_tpu_torch.models.llama import param_shapes


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key), )
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax_params(tree, cfg) -> dict:
    """CPU tensors in ``cfg.dtype``, keyed like ``LlamaModel.state_dict()``."""
    root = tree["model"] if "model" in tree else tree
    flat = dict(_flatten(root))
    if "lm_head" not in root and "lm_head" in tree:
        flat.update(dict(_flatten({"lm_head": tree["lm_head"]})))
    out = {}
    for path, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        head, leaf = path[:-1], path[-1]
        parts = []
        for p in head:
            if p.startswith("layers_"):
                parts += ["layers", p[len("layers_"):]]
            else:
                parts.append(p)
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf not in ("weight", "bias"):
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(parts + [leaf])] = torch.tensor(arr, dtype=cfg.dtype)
    want = param_shapes(cfg)
    if set(out) != set(want):
        raise ValueError(f"flax tree does not fit {type(cfg).__name__}: missing "
                         f"{sorted(set(want) - set(out))}, unexpected {sorted(set(out) - set(want))}")
    for name, shape in want.items():
        if tuple(out[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {tuple(shape)}")
    return out
