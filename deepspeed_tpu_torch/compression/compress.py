"""Config-driven model compression.

Port of ``deepspeed_tpu/compression/compress.py`` (reference
``deepspeed/compression/compress.py``: ``init_compression:100`` walks the
model swapping layers for compressed variants per config patterns;
``redundancy_clean:148`` materializes structured pruning). Compression is a
transform of the parameters keyed by the same config schema
(``weight_quantization`` / ``sparse_pruning`` / ``row_pruning`` /
``head_pruning`` blocks with ``modules`` glob patterns).

The patterns, and the transforms' axes, are the JAX package's: a pattern is
matched against the name the JAX tree gives a tensor
(``model.layers_0.self_attn.q_proj.kernel``), and a transform sees the
tensor in the JAX layout (the transposed view of a ``Linear.weight``).
``layout`` (``models.convert.reference_names(module)``) gives both for a
``state_dict``-keyed dict; without it, dotted paths of the given (nested)
dicts are the names and tensors are taken as they are, as the JAX package
takes its tree.
"""

import fnmatch
from collections.abc import Mapping

import numpy as np
import torch

from deepspeed_tpu_torch.compression.basic_layer import (apply_head_mask, fake_quantize, head_prune_mask,
                                                         kth_smallest, row_prune_mask)
from deepspeed_tpu_torch.utils.logging import logger


def get_compression_config(param_dict: dict) -> dict:
    return param_dict.get("compression_training", {})


def _matches(name: str, patterns) -> bool:
    return any(fnmatch.fnmatch(name, f"*{p}*") if "*" not in p else fnmatch.fnmatch(name, p) for p in patterns)


def _block(cfg: dict, key: str):
    """shared_parameters + each group's modules/params."""
    blk = cfg.get(key, {})
    shared = blk.get("shared_parameters", {})
    if not shared.get("enabled", False):
        return None
    out = []
    for g in blk.get("different_groups", {}).values():
        out.append((g.get("modules", ["*"]), g.get("params", {})))
    return {"shared": shared, "groups": out}


def _map_leaves(fn, tree, layout, prefix=""):
    """``fn(reference_name, tensor in the reference layout)`` over every
    leaf; results go back to the port's layout, in a tree of the same
    structure."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out[key] = _map_leaves(fn, value, layout, path + ".")
            continue
        name, transposed = layout[path] if layout is not None else (path, False)
        ref = value.T if transposed else value
        new = fn(name, ref)
        out[key] = value if new is ref else (new.T.contiguous() if transposed else new)
    return out


def init_compression(params, deepspeed_config: dict, mpu=None, layout=None):
    """Apply the configured compression transforms to a dict of tensors
    (reference init_compression:100: the layer swap becomes a leaf
    transform). Returns a new dict of the same structure; fake-quant keeps
    shapes and dtypes."""
    cfg = get_compression_config(deepspeed_config if isinstance(deepspeed_config, dict) else {})
    wq = _block(cfg, "weight_quantization")
    rp = _block(cfg, "row_pruning")
    hp = _block(cfg, "head_pruning")
    sp = _block(cfg, "sparse_pruning")

    def transform(name, leaf):
        if leaf.ndim < 2:
            return leaf
        out = leaf
        if wq is not None:
            for patterns, p in wq["groups"]:
                if _matches(name, patterns):
                    bits = p.get("start_bits", p.get("target_bits", 8))
                    out = fake_quantize(out, bits=int(bits),
                                        symmetric=p.get("quantization_type", "symmetric") == "symmetric")
                    break
        if sp is not None:
            for patterns, p in sp["groups"]:
                if _matches(name, patterns):
                    ratio = float(p.get("dense_ratio", 0.5))
                    k = int(np.ceil((1 - ratio) * out.numel()))
                    if k > 0:
                        thresh = kth_smallest(out.abs(), k)
                        out = out * (out.abs() > thresh).to(out.dtype)
                    break
        if rp is not None:
            for patterns, p in rp["groups"]:
                if _matches(name, patterns):
                    mask = row_prune_mask(out, float(p.get("row_sparsity", 0.5)), axis=0)
                    out = out * mask[:, None].to(out.dtype)
                    break
        if hp is not None:
            for patterns, p in hp["groups"]:
                if _matches(name, patterns):
                    heads = int(p.get("num_heads", 1))
                    mask = head_prune_mask(out, float(p.get("head_sparsity", 0.5)), heads)
                    out = apply_head_mask(out, mask, heads)
                    break
        return out

    with torch.no_grad():
        new = _map_leaves(transform, params, layout)
    logger.info("init_compression: applied " + ", ".join(k for k, v in (("weight_quantization", wq), (
        "row_pruning", rp), ("head_pruning", hp), ("sparse_pruning", sp)) if v is not None))
    return new


def _nest(flat, layout):
    """A ``state_dict``-keyed dict as the JAX package's nested tree (by the
    reference names); leaves are the port's own tensors."""
    root = {}
    for key, value in flat.items():
        *parents, leaf = (layout[key][0] if layout is not None else key).split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return root


def _unnest(tree, flat_like, layout):
    out = {}
    for key in flat_like:
        node = tree
        for p in (layout[key][0] if layout is not None else key).split("."):
            node = node[p]
        out[key] = node
    return out


def student_initialization(student_params, teacher_params, deepspeed_config: dict, layout=None,
                           teacher_layout=None):
    """Layer-reduction distillation init (reference compress.py:192):
    re-initialize the student's layers from selected TEACHER layers per the
    ``layer_reduction`` block:

        {"layer_reduction": {"enabled": true, "module_name_prefix": "model.layers",
                             "teacher_layer": [1, 3], "other_module_name": [...]}}

    Layer i of the student takes teacher layer ``teacher_layer[i]`` (tree
    keys ``{prefix}_{n}``, the JAX package's naming); ``other_module_name``
    entries copy whole subtrees. The trees are nested dicts, or
    ``state_dict``-keyed dicts with ``layout`` and ``teacher_layout``
    (``models.convert.reference_names`` of each model); shapes must already
    agree."""
    cfg = get_compression_config(deepspeed_config if isinstance(deepspeed_config, dict) else {})
    lr = cfg.get("layer_reduction", {})
    if not lr.get("enabled", False):
        return student_params
    if layout is not None:
        out = student_initialization(_nest(student_params, layout), _nest(teacher_params, teacher_layout),
                                     deepspeed_config)
        return _unnest(out, student_params, layout)
    prefix = lr.get("module_name_prefix", "layers")
    if "teacher_layer" not in lr:
        raise KeyError("layer_reduction: 'teacher_layer' (the teacher layer ids the "
                       "student re-initializes from) is required when enabled")
    teacher_layer = lr["teacher_layer"]
    other = lr.get("other_module_name", [])

    def walk(tree, dotted, who):
        node = tree
        for p in dotted.split("."):
            try:
                node = node[p]
            except KeyError as e:
                raise KeyError(f"layer_reduction: {dotted!r} not found in the {who} tree (missing {p!r})") from e
        return node

    out = _copy_dicts(student_params)
    *layer_parents, layer_base = prefix.split(".")
    layers_parent = ".".join(layer_parents)
    for s_idx, t_idx in enumerate(teacher_layer):
        s_key, t_key = f"{layer_base}_{s_idx}", f"{layer_base}_{t_idx}"
        try:
            s_parent = walk(out, layers_parent, "student") if layers_parent else out
            t_parent = walk(teacher_params, layers_parent, "teacher") if layers_parent else teacher_params
            t_layer = t_parent[t_key]
            s_parent[s_key]  # the student must have the slot
        except KeyError as e:
            raise KeyError(f"layer_reduction: missing {s_key!r} in student or "
                           f"{t_key!r} in teacher (prefix {prefix!r})") from e
        s_parent[s_key] = t_layer
    for name in other:
        *parents, leafname = name.split(".")
        parent = ".".join(parents)
        node_t = walk(teacher_params, parent, "teacher") if parent else teacher_params
        node_s = walk(out, parent, "student") if parent else out
        if leafname not in node_t or leafname not in node_s:
            raise KeyError(f"layer_reduction: other_module_name {name!r} not present in both trees")
        node_s[leafname] = node_t[leafname]
    logger.info(f"layer_reduction: student layers <- teacher {teacher_layer}, copied modules {other}")
    return out


def _copy_dicts(tree):
    return {k: _copy_dicts(v) if isinstance(v, Mapping) else v for k, v in tree.items()}


def redundancy_clean(params, deepspeed_config: dict, mpu=None, layout=None):
    """Materialize structured pruning: drop the zeroed rows of the JAX
    layout (reference redundancy_clean:148 shrinks the swapped layers), which
    are the zeroed columns of a ``Linear.weight``. Only row pruning changes
    shapes; masked-but-kept transforms are already in the weights."""
    cfg = get_compression_config(deepspeed_config if isinstance(deepspeed_config, dict) else {})
    rp = _block(cfg, "row_pruning")
    if rp is None:
        return params

    def transform(name, leaf):
        if leaf.ndim != 2:
            return leaf
        for patterns, _ in rp["groups"]:
            if _matches(name, patterns):
                return leaf[(leaf != 0).any(dim=1)]
        return leaf

    with torch.no_grad():
        return _map_leaves(transform, params, layout)
