"""Engine construction + generation driver.

Port of ``build_engine`` and ``generate`` from
``deepspeed_tpu/inference/v2/engine_factory.py``. In the JAX package
``generate`` drives the serving scheduler (``serving/scheduler.py``), which
is ROADMAP A4. Here it drives the engine directly: each prompt is prefilled
by ``put`` in chunks of at most ``max_ragged_batch_size`` tokens, one
request per ``put``, then all requests decode together through the greedy
``decode_loop`` in chunks of ``decode_chunk`` steps. Greedy tokens are those
of the JAX ``generate``: each is the argmax after the same token history.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.model_implementations.registry import model_cls_for
from deepspeed_tpu_torch.utils.device import resolve_device


def build_engine(params, model_config, engine_config: Optional[RaggedInferenceEngineConfig] = None,
                 device=None) -> InferenceEngineV2:
    """Build an InferenceEngineV2 for a weight dict + model config, on
    ``device`` (default ``cuda``; raises without a GPU unless ``"cpu"`` is
    passed). The model class resolves through the policy registry."""
    device = resolve_device(device)
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig()
    model = model_cls_for(model_config)(params, model_config, engine_config, device)
    return InferenceEngineV2(model, engine_config)


def generate(engine: InferenceEngineV2,
             prompts: Sequence[Sequence[int]],
             max_new_tokens: int = 16,
             temperature: float = 0.0,
             eos_token_id: Optional[int] = None,
             decode_chunk: int = 16) -> List[List[int]]:
    """Greedy generation of up to ``max_new_tokens`` tokens per prompt; a
    request stops after emitting ``eos_token_id``. Every request's KV must
    fit the engine's pool at once (there is no eviction without the serving
    scheduler). The requests' sequences are flushed before returning."""
    if temperature > 0:
        raise NotImplementedError("sampled generate needs the serving scheduler (ROADMAP.md A4)")
    if max_new_tokens < 1 or decode_chunk < 1:
        raise ValueError("max_new_tokens and decode_chunk must be >= 1")
    prompts = [np.asarray(p, dtype=np.int64).reshape(-1) for p in prompts]
    if any(p.size == 0 for p in prompts):
        raise ValueError("every prompt needs at least one token")
    sm = engine.config.state_manager
    base = 1 + max(engine._state_manager.tracked_sequences, default=-1)
    uids = [base + i for i in range(len(prompts))]
    outputs = [[] for _ in prompts]

    def push(i, tok) -> bool:
        """Append a token; True while the request wants more."""
        outputs[i].append(int(tok))
        return not (tok == eos_token_id or len(outputs[i]) >= max_new_tokens)

    try:
        live = []
        for i, (uid, prompt) in enumerate(zip(uids, prompts)):
            for start in range(0, prompt.size, sm.max_ragged_batch_size):
                logits = engine.put([uid], [prompt[start:start + sm.max_ragged_batch_size]])
            if push(i, torch.argmax(logits[0]).item()):
                live.append(i)
        group_size = min(sm.max_ragged_sequence_count, sm.max_ragged_batch_size)
        while live:
            steps = min(decode_chunk, min(max_new_tokens - len(outputs[i]) for i in live))
            still = []
            for g in range(0, len(live), group_size):
                group = live[g:g + group_size]
                toks = engine.decode_loop([uids[i] for i in group], [[outputs[i][-1]] for i in group], steps)
                for i, row in zip(group, toks):
                    if all(push(i, t) for t in row):
                        still.append(i)
            live = still
    finally:
        for uid in uids:
            if engine._state_manager.get_sequence(uid) is not None:
                engine.flush(uid)
    return outputs
