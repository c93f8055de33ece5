"""Weights carried across from the JAX package.

``from_flax_params`` takes the param tree of ``deepspeed_tpu.models.llama``
(nested dicts of numpy arrays) and returns the port's ``state_dict``-keyed
weights (see ``models/llama.py``):

- a flax ``Dense`` ``kernel`` is ``[in, out]``; a torch ``Linear.weight`` is
  ``[out, in]``, so kernels are transposed; biases stay;
- ``embed_tokens/embedding`` ``[V, hidden]`` is ``nn.Embedding.weight`` as is;
- ``LlamaForCausalLM`` nests everything under ``"model"`` (``lm_head``
  included), while other trees put it at the root: both are accepted.

``to_flax_params`` is the inverse: a ``state_dict`` back to the
``LlamaForCausalLM`` tree ``{"model": ...}`` of f32 numpy arrays.
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


def to_flax_params(state_dict, cfg) -> dict:
    """``{"model": {...}}`` nested dicts of f32 numpy arrays, as the JAX
    ``LlamaForCausalLM`` holds its params (the inverse of
    :func:`from_flax_params`)."""
    want = param_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(f"state_dict does not fit {type(cfg).__name__}: missing "
                         f"{sorted(set(want) - set(state_dict))}, unexpected {sorted(set(state_dict) - set(want))}")
    root = {}
    for name, value in state_dict.items():
        arr = value.detach().float().cpu().numpy()
        parts = name.split(".")
        *head, leaf = parts
        path = []
        i = 0
        while i < len(head):
            if head[i] == "layers":
                path.append(f"layers_{head[i + 1]}")
                i += 2
            else:
                path.append(head[i])
                i += 1
        if leaf == "weight" and path[-1] == "embed_tokens":
            leaf = "embedding"
        elif leaf == "weight" and not path[-1].endswith("norm"):
            arr, leaf = arr.T, "kernel"
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"model": root}


def reference_names(module) -> dict:
    """``{state_dict name: (the JAX package's dotted name, transposed)}``
    for every parameter of ``module``: the name the JAX tree gives the same
    tensor, and whether the port holds it transposed (a ``Linear.weight``
    ``[out, in]`` is the flax ``kernel`` ``[in, out]``). As in
    :func:`to_flax_params`: ``layers.{i}`` is ``layers_{i}``, an embedding's
    ``weight`` is ``embedding``, and a Llama nests everything under
    ``model``."""
    from deepspeed_tpu_torch.models.llama import LlamaModel

    prefix = ["model"] if isinstance(module, LlamaModel) else []
    out = {}
    for name, _ in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        path = []
        for part in owner.split(".") if owner else []:
            if part.isdigit() and path:
                path[-1] = f"{path[-1]}_{part}"
            else:
                path.append(part)
        transposed = isinstance(sub, torch.nn.Linear) and leaf == "weight"
        if transposed:
            leaf = "kernel"
        elif isinstance(sub, torch.nn.Embedding) and leaf == "weight":
            leaf = "embedding"
        out[name] = (".".join(prefix + path + [leaf]), transposed)
    return out
