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

The pipeline layouts: ``pipeline_params_from_flax`` / ``_to_flax`` carry
the reference ``PipelineEngine``'s ``{"pre", "stack", "post"}`` params
(its homogeneous middle layers stacked on a leading axis) to the port's
``PipelineEngine`` names (``layers.<i>.<name>``, ``tied.<key>.<name>``),
and ``pipeline_state_from_llama`` / ``llama_state_from_pipeline`` move a
``LlamaModel`` state to ``llama_pipeline_module``'s layout and back.
``tiled_linear_from_flax`` / ``_to_flax`` carry ``TiledLinear``'s tile
grid. ``mixtral_from_flax`` / ``_to_flax`` carry a Mixtral tree
(``block_sparse_moe.{gate, ExpertFFN_0.{wi, wo}}``) bit for bit, and
``expert_slice`` keeps an expert-parallel rank's experts.
``decoder_from_flax`` / ``_to_flax`` carry ``models/decoder.py``'s tree (a
LayerNorm's ``scale`` is the port's ``weight``). For any of the three
families, ``reference_path`` / ``port_name`` map one name to the other, and
``reference_leaves`` / ``state_from_reference_leaves`` move a whole
``state_dict`` to the reference's paths and back in its own dtypes, a
quantized weight's keys (``inference/v2/quantization.py``) under its path:
the serialize directory's layout.
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


# ---------------------------------------------------------- pipeline layouts --
def pipeline_state_from_llama(state_dict, cfg) -> dict:
    """A ``LlamaModel`` ``state_dict`` in the layout of
    ``models.llama.llama_pipeline_module(cfg, ...)``: layer 0 the embedding,
    layers 1..L the blocks, layer L + 1 the final norm and the head."""
    L = cfg.num_hidden_layers
    out = {}
    for name, t in state_dict.items():
        if name.startswith("embed_tokens."):
            out[f"layers.0.{name}"] = t
        elif name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            out[f"layers.{int(i) + 1}.block.{rest}"] = t
        else:
            out[f"layers.{L + 1}.{name}"] = t
    return out


def llama_state_from_pipeline(state, cfg) -> dict:
    """The inverse of :func:`pipeline_state_from_llama`."""
    L = cfg.num_hidden_layers
    out = {}
    for name, t in state.items():
        _, i, rest = name.split(".", 2)
        i = int(i)
        if i == 0:
            out[rest] = t
        elif i <= L:
            out[f"layers.{i - 1}.{rest[len('block.'):]}"] = t
        else:
            out[rest] = t
    return out


def _meta_layers(module):
    """Every layer of a ``PipelineModule`` built on the meta device (shapes
    without memory)."""
    from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec
    with torch.device("meta"):
        return [spec.build() if isinstance(spec, LayerSpec) else spec for spec in module._layer_specs]


def pipeline_stack_span(layers):
    """``(lo, hi)``: the reference ``PipelineEngine``'s stack, the longest run
    of layers of one type with the same parameter shapes (its ``pre`` are
    the layers before, its ``post`` those after)."""
    sig = [(type(m), tuple((n, tuple(p.shape)) for n, p in m.named_parameters())) for m in layers]
    best, lo = (0, 1), 0
    for hi in range(1, len(layers) + 1):
        if hi == len(layers) or sig[hi] != sig[lo]:
            if hi - lo > best[1] - best[0]:
                best = (lo, hi)
            lo = hi
    return best


def _port_name(module, index, name):
    from deepspeed_tpu_torch.runtime.pipe.module import TiedLayerSpec
    spec = module._layer_specs[index]
    return f"tied.{spec.key}.{name}" if isinstance(spec, TiedLayerSpec) else f"layers.{index}.{name}"


def pipeline_params_from_flax(tree, module) -> dict:
    """The reference ``PipelineEngine``'s params ``{"pre": {"<i>": ...},
    "stack": <stacked>, "post": {"<i>": ...}}`` (numpy) as the state dict of
    the port's pipeline engine for ``module`` (a ``PipelineModule`` whose
    layers name their submodules as the flax ones are named): a ``Linear``
    weight is the flax kernel transposed."""
    layers = _meta_layers(module)
    lo, hi = pipeline_stack_span(layers)
    out = {}
    for i, layer in enumerate(layers):
        if i < lo:
            sub, pick = tree["pre"][str(i)], None
        elif i < hi:
            sub, pick = tree["stack"], i - lo
        else:
            sub, pick = tree["post"][str(i - hi)], None
        flat = {".".join(path): value for path, value in _flatten(sub)}
        for name, (jname, transposed) in reference_names(layer).items():
            arr = np.asarray(flat[jname], dtype=np.float32)
            if pick is not None:
                arr = arr[pick]
            key = _port_name(module, i, name)
            if key not in out:
                out[key] = torch.tensor(arr.T if transposed else arr)
    return out


def pipeline_params_to_flax(state, module) -> dict:
    """The inverse of :func:`pipeline_params_from_flax`: the reference's
    ``{"pre", "stack", "post"}`` tree of f32 numpy arrays."""
    layers = _meta_layers(module)
    lo, hi = pipeline_stack_span(layers)
    out = {"pre": {}, "stack": {}, "post": {}}
    stack = {}
    for i, layer in enumerate(layers):
        for name, (jname, transposed) in reference_names(layer).items():
            arr = state[_port_name(module, i, name)].detach().float().cpu().numpy()
            arr = np.ascontiguousarray(arr.T if transposed else arr)
            if lo <= i < hi:
                stack.setdefault(jname, []).append(arr)
                continue
            node = out["pre"].setdefault(str(i), {}) if i < lo else out["post"].setdefault(str(i - hi), {})
            *path, leaf = jname.split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    for jname, arrs in stack.items():
        node = out["stack"]
        *path, leaf = jname.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.stack(arrs)
    return out


# ------------------------------------------------------------- TiledLinear --
def tiled_linear_from_flax(tree) -> dict:
    """The reference ``TiledLinear``'s params as the port's state dict: the
    port keeps its tile grid in the reference's layout (``kernel``
    ``[in_splits, out_splits, in/t, out/t]``, ``bias`` ``[out_splits,
    out/t]``), so they are the same arrays."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


def tiled_linear_to_flax(state) -> dict:
    """The inverse of :func:`tiled_linear_from_flax`."""
    return {k: v.detach().float().cpu().numpy() for k, v in state.items()}


# ------------------------------------------------------------------ Mixtral --
_FLAX_EXPERTS = "ExpertFFN_0"


def mixtral_from_flax(tree, cfg) -> dict:
    """The reference ``MixtralForCausalLM``'s param tree (nested dicts of
    numpy arrays, at the root) as ``models/mixtral.py``'s ``state_dict``:
    Dense kernels transposed, the router ``gate [M, E]`` and the banks
    ``ExpertFFN_0.{wi, wo}`` (named ``experts.{wi, wo}`` here) as they are.
    CPU tensors in ``cfg.dtype``."""
    from deepspeed_tpu_torch.models.mixtral import param_shapes as mixtral_shapes

    out = {}
    for path, value in _flatten(tree):
        arr = np.asarray(value, dtype=np.float32)
        head, leaf = path[:-1], path[-1]
        parts = []
        for p in head:
            if p.startswith("layers_"):
                parts += ["layers", p[len("layers_"):]]
            else:
                parts.append("experts" if p == _FLAX_EXPERTS else p)
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf not in ("weight", "gate", "wi", "wo"):
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        out[".".join(parts + [leaf])] = torch.tensor(arr, dtype=cfg.dtype)
    want = mixtral_shapes(cfg)
    if set(out) != set(want):
        raise ValueError(f"flax tree does not fit {type(cfg).__name__}: missing {sorted(set(want) - set(out))}, "
                         f"unexpected {sorted(set(out) - set(want))}")
    for name, shape in want.items():
        if tuple(out[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(out[name].shape)} != {tuple(shape)}")
    return out


def mixtral_to_flax(state_dict, cfg) -> dict:
    """The inverse of :func:`mixtral_from_flax`: the reference's tree of f32
    numpy arrays."""
    from deepspeed_tpu_torch.models.mixtral import param_shapes as mixtral_shapes

    want = mixtral_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(f"state_dict does not fit {type(cfg).__name__}: missing "
                         f"{sorted(set(want) - set(state_dict))}, unexpected {sorted(set(state_dict) - set(want))}")
    root = {}
    for name, value in state_dict.items():
        arr = value.detach().float().cpu().numpy()
        *head, leaf = name.split(".")
        path, i = [], 0
        while i < len(head):
            if head[i] == "layers":
                path.append(f"layers_{head[i + 1]}")
                i += 2
            else:
                path.append(_FLAX_EXPERTS if head[i] == "experts" else head[i])
                i += 1
        if leaf == "weight" and path[-1] == "embed_tokens":
            leaf = "embedding"
        elif leaf == "weight" and not path[-1].endswith("norm"):
            arr, leaf = arr.T, "kernel"
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return root


def expert_slice(state_dict, rank: int, ep: int) -> dict:
    """The weights an expert-parallel rank holds: everything, but only
    experts ``[rank·E/ep, (rank+1)·E/ep)`` of each bank (``experts.wi``,
    ``experts.wo``). Raises when the experts do not divide over the ranks."""
    from deepspeed_tpu_torch.models.mixtral import is_expert_bank

    out = {}
    for name, t in state_dict.items():
        if is_expert_bank(name):
            E = t.shape[0]
            if E % ep:
                raise ValueError(f"{name}: {E} experts do not divide over {ep} expert-parallel ranks")
            per = E // ep
            t = t[rank * per:(rank + 1) * per]
        out[name] = t
    return out


# ------------------------------------------------- any model, any dtype --
def _is_mixtral(cfg) -> bool:
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig
    return isinstance(cfg, MixtralConfig)


def _is_decoder(cfg) -> bool:
    from deepspeed_tpu_torch.models.decoder import DecoderConfig
    return isinstance(cfg, DecoderConfig)


def reference_path(name: str, cfg) -> tuple:
    """``(path, transposed)``: the reference's tree path of the ``state_dict``
    entry ``name`` of a Llama-family model, a Mixtral or a decoder-family
    model, and whether the port holds it transposed. ``layers.{i}`` is
    ``layers_{i}``, ``experts`` is ``ExpertFFN_0``; an embedding's
    ``weight`` is ``embedding``, a LayerNorm's ``scale`` (an RMSNorm keeps
    ``weight``), a Linear's ``kernel`` (transposed). A Llama or a decoder
    nests everything under ``model``, a Mixtral sits at the root."""
    *owner, leaf = name.split(".")
    path, i = [], 0
    while i < len(owner):
        if owner[i] == "layers":
            path.append(f"layers_{owner[i + 1]}")
            i += 2
        else:
            path.append(_FLAX_EXPERTS if owner[i] == "experts" else owner[i])
            i += 1
    transposed = False
    if leaf == "weight":
        if path[-1] in ("embed_tokens", "embed_positions"):
            leaf = "embedding"
        elif path[-1].endswith("norm"):
            leaf = "scale" if _is_decoder(cfg) else "weight"
        else:
            leaf, transposed = "kernel", True
    return (() if _is_mixtral(cfg) else ("model", )) + tuple(path) + (leaf, ), transposed


def port_name(path) -> tuple:
    """The inverse of :func:`reference_path`: ``(name, transposed)`` for a
    reference path, with or without the leading ``model``."""
    path = list(path[1:] if path[0] == "model" else path)
    *owner, leaf = path
    parts = []
    for p in owner:
        if p.startswith("layers_"):
            parts += ["layers", p[len("layers_"):]]
        else:
            parts.append("experts" if p == _FLAX_EXPERTS else p)
    transposed = leaf == "kernel"
    if leaf in ("kernel", "embedding", "scale"):
        leaf = "weight"
    return ".".join(parts + [leaf]), transposed


def _t(x, transposed):
    """A transposed weight's component (int8 values, packed words, scales)
    moves between layouts transposed; a 0-d dtype marker as it is."""
    return x.t().contiguous() if transposed and x.dim() == 2 else x


def reference_leaves(state, cfg) -> dict:
    """``{reference path: tensor}`` of a ``state_dict`` (dtypes kept); a
    quantized leaf (``inference/v2/quantization.py``) gives one path per
    key under its weight's path, each in the reference's layout."""
    out = {}
    for name, value in state.items():
        path, transposed = reference_path(name, cfg)
        if isinstance(value, Mapping):
            for key, t in value.items():
                out[path + (key, )] = _t(t, transposed)
        else:
            out[path] = _t(value, transposed)
    return out


def state_from_reference_leaves(leaves) -> dict:
    """The inverse of :func:`reference_leaves`: a ``state_dict`` with the
    quantized leaves regrouped (dtypes kept)."""
    from deepspeed_tpu_torch.inference.v2.quantization import DKEY, Q4KEY, QKEY, SKEY

    out = {}
    for path, t in leaves.items():
        if path[-1] in (QKEY, Q4KEY, SKEY, DKEY):
            name, transposed = port_name(path[:-1])
            out.setdefault(name, {})[path[-1]] = _t(t, transposed)
        else:
            name, transposed = port_name(path)
            out[name] = _t(t, transposed)
    return out


def _checked(state, cfg, shapes):
    if set(state) != set(shapes):
        raise ValueError(f"tree does not fit {type(cfg).__name__}: missing {sorted(set(shapes) - set(state))}, "
                         f"unexpected {sorted(set(state) - set(shapes))}")
    for name, shape in shapes.items():
        if tuple(state[name].shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)} != {tuple(shape)}")
    return state


def decoder_from_flax(tree, cfg) -> dict:
    """The reference ``DecoderForCausalLM``'s param tree (``{"model": ...}``
    of numpy arrays) as ``models/decoder.py``'s ``state_dict``: Dense
    kernels transposed, LayerNorm ``scale`` as ``weight``. CPU tensors in
    ``cfg.dtype``."""
    from deepspeed_tpu_torch.models.decoder import param_shapes as decoder_shapes

    leaves = {path: torch.tensor(np.asarray(v, np.float32), dtype=cfg.dtype) for path, v in _flatten(tree)}
    return _checked(state_from_reference_leaves(leaves), cfg, decoder_shapes(cfg))


def decoder_to_flax(state_dict, cfg) -> dict:
    """The inverse of :func:`decoder_from_flax`: ``{"model": ...}`` of f32
    numpy arrays."""
    from deepspeed_tpu_torch.models.decoder import param_shapes as decoder_shapes

    _checked(state_dict, cfg, decoder_shapes(cfg))
    root = {}
    for path, t in reference_leaves(state_dict, cfg).items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().float().cpu().numpy()
    return root
