"""Engine construction + generation driver.

Port of ``build_engine`` and ``generate`` from
``deepspeed_tpu/inference/v2/engine_factory.py``. ``generate`` drives the
serving scheduler (``serving/scheduler.py``), as the reference's does: Dynamic
SplitFuse admission, decode-first batching and KV-pressure shrink/evict exist
in that one place.
"""

from typing import List, Optional, Sequence

import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2, expert_group, tensor_group
from deepspeed_tpu_torch.inference.v2.model_implementations.registry import model_cls_for
from deepspeed_tpu_torch.models.convert import expert_slice
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
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
        q = params["layers.0.self_attn.q_proj.weight"]
        if q.shape[0] == model_config.num_attention_heads * model_config.head_dim:
            params = serving_tp_slice(params, model_config, tp.rank, tp.size)
    model = model_cls_for(model_config)(params, model_config, engine_config, device)
    return InferenceEngineV2(model, engine_config)


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
