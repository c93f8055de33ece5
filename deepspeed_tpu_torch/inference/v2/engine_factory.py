"""Engine construction + generation driver.

Port of ``deepspeed_tpu/inference/v2/engine_factory.py``: ``build_engine``
from weights and a config, ``build_engine_from_ds_checkpoint`` from an
``InferenceEngineV2.serialize`` directory, ``build_hf_engine`` from an HF
checkpoint directory (``inference/checkpoint.py``; a serialize directory
routes to the DS loader, a legacy pickle one is refused), and ``generate``,
which drives the serving scheduler (``serving/scheduler.py``), as the
reference's does: Dynamic SplitFuse admission, decode-first batching and
KV-pressure shrink/evict exist in that one place.

A serialize directory is the reference's format, so either package loads
what the other wrote: ``ds_model_config.json`` (the config class as the
reference names it, ``deepspeed_tpu.models.<module>.<Config>``, and its
fields, a dtype as ``{"__dtype__": name}``), ``metadata_rank0.json`` (each
array's tree path, shape and logical dtype) and ``params_rank0.npz`` (bf16
stored as a ``u2`` view). Paths are the reference's flax paths
(``models/convert.py::reference_leaves``), quantized leaves included. The
loader maps the class name to the port's class through a fixed table and
never imports the named module.
"""

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2, expert_group, tensor_group
from deepspeed_tpu_torch.inference.v2.model_implementations.registry import model_cls_for
from deepspeed_tpu_torch.inference.v2.quantization import is_quantized_leaf
from deepspeed_tpu_torch.models.convert import expert_slice, reference_leaves, state_from_reference_leaves
from deepspeed_tpu_torch.models.decoder import DecoderConfig
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, is_expert_bank
from deepspeed_tpu_torch.module_inject import auto_tp_specs, tp_slice
from deepspeed_tpu_torch.utils.device import resolve_device


def build_engine(params, model_config, engine_config: Optional[RaggedInferenceEngineConfig] = None,
                 device=None) -> InferenceEngineV2:
    """Build an InferenceEngineV2 for a weight dict + model config, on
    ``device`` (default ``cuda``; raises without a GPU unless ``"cpu"`` is
    passed). The model class resolves through the policy registry. Under
    expert parallelism a rank holds only its experts: whole expert banks
    are sliced to them here (``models/convert.py::expert_slice``); under
    tensor parallelism its heads and MLP columns (:func:`serving_tp_slice`),
    from whole weights; under both, its expert rank's banks, whole, and its
    model rank's heads."""
    device = resolve_device(device)
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig()
    group = expert_group(engine_config, device)
    if group is not None and isinstance(model_config, MixtralConfig):
        banks = [t for name, t in params.items() if is_expert_bank(name)]
        if banks and banks[0].shape[0] == model_config.num_local_experts:
            params = expert_slice(params, group.rank, group.size)
    tp = tensor_group(engine_config, device)
    if tp is not None:
        if any(is_quantized_leaf(v) for v in params.values()):
            raise NotImplementedError("tensor parallelism of quantized weights: slicing cuts whole weights by name "
                                      "(as in the reference, quantize each rank's shard after placement instead)")
        q = params["layers.0.self_attn.q_proj.weight"]
        if q.shape[0] == model_config.num_attention_heads * model_config.head_dim:
            params = serving_tp_slice(params, model_config, tp.rank, tp.size)
    model = model_cls_for(model_config)(params, model_config, engine_config, device)
    return InferenceEngineV2(model, engine_config)


# the reference's config classes, by the name a serialize directory carries:
# the port's class, and the port's fields that the reference's class lacks
# (left out on writing, so that the reference's loader takes the fields)
CONFIG_CLASSES = {
    "deepspeed_tpu.models.llama.LlamaConfig": (LlamaConfig, ()),
    "deepspeed_tpu.models.mixtral.MixtralConfig": (MixtralConfig, ("model_type", "sequence_parallel")),
    "deepspeed_tpu.models.decoder.DecoderConfig": (DecoderConfig, ()),
}
_NPZ, _META, _CONFIG = "params_rank0.npz", "metadata_rank0.json", "ds_model_config.json"


def write_ds_checkpoint(path: str, params, model_config) -> int:
    """Write ``params`` (a ``state_dict``-keyed dict, quantized leaves
    included) and ``model_config`` as a serialize directory (module doc);
    returns the number of arrays. ``InferenceEngineV2.serialize`` calls it."""
    names = {cls: (n, skip) for n, (cls, skip) in CONFIG_CLASSES.items()}
    if type(model_config) not in names:
        raise ValueError(f"serialize writes {sorted(CONFIG_CLASSES)}, not {type(model_config).__name__}")
    name, skip = names[type(model_config)]
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, []
    for i, (tree_path, t) in enumerate(sorted(reference_leaves(params, model_config).items())):
        t = t.detach().cpu().contiguous()
        logical = str(t.dtype).removeprefix("torch.")
        arr = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
        arrays[f"p{i}"] = arr
        meta.append({"path": "/".join(tree_path), "shape": list(t.shape), "dtype": logical})
    np.savez(os.path.join(path, _NPZ), **arrays)
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    fields = {}
    for field in dataclasses.fields(model_config):
        if field.name in skip:
            continue
        v = getattr(model_config, field.name)
        fields[field.name] = {"__dtype__": str(v).removeprefix("torch.")} if isinstance(v, torch.dtype) else v
    with open(os.path.join(path, _CONFIG), "w") as f:
        json.dump({"config_class": name, "fields": fields}, f, indent=2)
    return len(arrays)


def load_ds_checkpoint(path: str):
    """``(params, model_config)`` of a serialize directory (either
    package's): CPU tensors in their stored dtypes, quantized leaves
    regrouped. Raises for a config class outside :data:`CONFIG_CLASSES`."""
    with open(os.path.join(path, _CONFIG)) as f:
        doc = json.load(f)
    if doc["config_class"] not in CONFIG_CLASSES:
        raise ValueError(f"refusing config class {doc['config_class']!r} (loadable: {sorted(CONFIG_CLASSES)})")
    cfg_cls = CONFIG_CLASSES[doc["config_class"]][0]

    def dec(v):
        if isinstance(v, dict) and "__dtype__" in v:
            return getattr(torch, v["__dtype__"])
        return tuple(v) if isinstance(v, list) else v

    model_config = cfg_cls(**{k: dec(v) for k, v in doc["fields"].items()})
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    leaves = {}
    with np.load(os.path.join(path, _NPZ)) as z:
        for i, m in enumerate(meta):
            arr = z[f"p{i}"]
            if m["dtype"] == "bfloat16":  # stored as a u2 view
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves[tuple(m["path"].split("/"))] = t.reshape(m["shape"])
    params = state_from_reference_leaves(leaves)
    if isinstance(model_config, LlamaConfig) and any(".block_sparse_moe." in name for name in params):
        raise ValueError(f"{path} holds a Mixtral's expert banks under a LlamaConfig (C25: the reference's "
                         "serialize writes a Mixtral engine's attention config); its MoE settings are lost")
    return params, model_config


def build_engine_from_ds_checkpoint(path: str, engine_config: Optional[RaggedInferenceEngineConfig] = None,
                                    device=None) -> InferenceEngineV2:
    """Rebuild an engine from a serialize directory (either package's). A
    quantized directory loads back quantized whatever ``engine_config``
    says (C24): at rest as stored, dequantized where each layer reads a
    weight."""
    params, model_config = load_ds_checkpoint(path)
    return build_engine(params, model_config, engine_config, device=device)


def build_hf_engine(path: str, engine_config: Optional[RaggedInferenceEngineConfig] = None,
                    device=None) -> InferenceEngineV2:
    """Load an HF checkpoint directory (``inference/checkpoint.py``) and build
    an engine; a directory with ``ds_model_config.json`` routes to
    :func:`build_engine_from_ds_checkpoint`, and a legacy
    ``ds_model_config.pkl`` is refused (a pickle in a checkpoint can run
    code)."""
    if os.path.exists(os.path.join(path, _CONFIG)):
        return build_engine_from_ds_checkpoint(path, engine_config, device=device)
    if os.path.exists(os.path.join(path, "ds_model_config.pkl")):
        raise ValueError(f"{path} is a legacy pickle-format DS checkpoint; the format was retired (a pickle in a "
                         "checkpoint can run arbitrary code). Re-serialize the engine to get the JSON-config format.")
    from deepspeed_tpu_torch.inference.checkpoint import load_hf_checkpoint

    params, model_config = load_hf_checkpoint(path)
    return build_engine(params, model_config, engine_config, device=device)


def serving_tp_slice(params, model_config, rank: int, size: int) -> dict:
    """The weights tensor-parallel rank ``rank`` of ``size`` serves a
    Llama-family model or a Mixtral with, from whole ones: training's
    placements (``auto_tp_specs`` of the model, built on the meta device)
    cut by ``module_inject.layers.tp_slice``, with the embedding and the
    unembedding whole. A Mixtral's attention is cut as a Llama's; its
    router and its expert banks, which AutoTP places on no model axis (a
    bank of 3 dimensions goes on the ``expert`` axis, reference
    ``auto_tp.py:124-125``), stay whole on every model rank."""
    model_cls = MixtralForCausalLM if isinstance(model_config, MixtralConfig) else LlamaForCausalLM
    with torch.device("meta"):
        specs = auto_tp_specs(model_cls(model_config))
    return tp_slice(params, specs, rank, size, whole=("embed_tokens.weight", "lm_head.weight"))


def generate(engine: InferenceEngineV2,
             prompts: Sequence[Sequence[int]],
             max_new_tokens: int = 16,
             temperature: float = 0.0,
             eos_token_id: Optional[int] = None,
             seed: int = 0,
             decode_chunk: int = 1) -> List[List[int]]:
    """Synchronous continuous-batching decode: a thin wrapper over the serving
    scheduler. Greedy when ``temperature == 0``.

    ``decode_chunk`` > 1 runs decode-only batches in chunks of K steps through
    the engine's ``decode_loop`` (one dispatch per chunk instead of one per
    token); eos is checked between chunks, so a finished sequence
    over-generates up to K-1 discarded tokens before its KV blocks recycle.
    The chunked path is greedy-only: with ``temperature > 0`` each request
    samples from its own host numpy stream (seeded ``seed + index``) through
    the step-by-step path, so concurrent requests stay independently
    reproducible; greedy output is identical either way.
    """
    from deepspeed_tpu_torch.serving.config import ServingConfig
    from deepspeed_tpu_torch.serving.request import RequestState
    from deepspeed_tpu_torch.serving.scheduler import ServingScheduler

    if len(prompts) == 0:
        return []
    # an engine already serving keeps its scheduler (requests just join the
    # live batch mix); otherwise a temporary one owns the engine for this
    # call and is driven INLINE — no background thread, the caller's thread
    # ticks the scheduler until every request finishes
    scheduler = engine.serving_scheduler
    own_scheduler = scheduler is None
    if own_scheduler:
        scheduler = ServingScheduler(
            engine,
            ServingConfig(queue_capacity=len(prompts), decode_chunk=decode_chunk,
                          default_max_new_tokens=max_new_tokens),
            start=False)
    requests = []
    try:
        for i, p in enumerate(prompts):
            requests.append(scheduler.submit(p, max_new_tokens=max_new_tokens,
                                             temperature=temperature,
                                             eos_token_id=eos_token_id, seed=seed + i))
        if own_scheduler:
            while not all(req.finished for req in requests):
                scheduler.step()
        outputs = []
        for req in requests:
            tokens = req.result()  # raises RuntimeError when the request FAILED
            if req.state is not RequestState.DONE:
                # reachable through a shared scheduler: its default deadline,
                # or a concurrent stop()/engine.close(), can cut the request
                raise RuntimeError(f"generate(): request finished {req.state.name} "
                                   f"after {len(tokens)} of {max_new_tokens} tokens")
            outputs.append(tokens)
        return outputs
    except BaseException:
        # a failed submit (queue full on a shared scheduler) or a failed
        # request must not orphan the rest: nobody will consume them
        for req in requests:
            req.cancel()
        raise
    finally:
        if own_scheduler:
            scheduler.stop(drain=False)
