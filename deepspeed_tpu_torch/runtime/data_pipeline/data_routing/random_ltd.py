"""Random layerwise token dropping (random-LTD).

Port of ``deepspeed_tpu/runtime/data_pipeline/data_routing/random_ltd.py``.
Reference: ``deepspeed/runtime/data_pipeline/data_routing/scheduler.py``
(RandomLTDScheduler — fixed_linear reserved-sequence schedule
``floor((t / T)^(1/r) · (max-min) + min)`` snapped down to ``increase_step``)
and ``basic_layer.py`` (RandomLayerTokenDrop — per-layer random token subset
gathered before the layer and scattered back after,
``csrc/random_ltd/`` gather/scatter kernels → here one ``index_select`` and
one ``index_copy``; their backward is autograd's own).
"""

import math
from typing import Dict

import torch


class RandomLTDScheduler:
    """fixed_linear schedule of the reserved (kept) token count."""

    def __init__(self, min_value: int, max_value: int, require_steps: int,
                 increase_step: int = 1, root_degree: int = 1,
                 total_layer_num: int = 0, random_ltd_layer_num: int = 0,
                 global_batch_size: int = 1):
        self.min_value = int(min_value)
        self.max_value = int(max_value)
        self.require_steps = int(require_steps)
        self.increase_step = max(1, int(increase_step))
        self.root_degree = root_degree
        self.total_layer_num = total_layer_num
        self.random_ltd_layer_num = random_ltd_layer_num
        self.global_batch_size = global_batch_size
        self.consumed_layer_tokens = 0
        self.current_seq = self.min_value

    def get_value(self, global_steps: int) -> int:
        frac = (float(global_steps) / self.require_steps) ** (1.0 / self.root_degree)
        seq = math.floor(frac * (self.max_value - self.min_value) + self.min_value)
        seq -= seq % self.increase_step
        return min(seq, self.max_value)

    def update_seq(self, global_steps: int) -> int:
        self.current_seq = max(self.min_value, self.get_value(global_steps))
        # layer-token accounting (reference get_total_layer_tokens): dropped
        # layers see current_seq tokens, the rest the full max
        full_layers = self.total_layer_num - self.random_ltd_layer_num
        self.consumed_layer_tokens += self.global_batch_size * (
            self.random_ltd_layer_num * self.current_seq + full_layers * self.max_value)
        return self.current_seq

    def get_current_seq(self) -> int:
        return self.current_seq

    def get_total_layer_tokens(self, train_iters: int) -> int:
        for step in range(train_iters):
            self.update_seq(step)
        return self.consumed_layer_tokens

    def state_dict(self) -> Dict:
        return {"current_seq": self.current_seq,
                "consumed_layer_tokens": self.consumed_layer_tokens}

    def load_state_dict(self, sd: Dict):
        self.current_seq = sd["current_seq"]
        self.consumed_layer_tokens = sd["consumed_layer_tokens"]


def random_token_indices(generator, seq_len: int, reserved: int):
    """Sorted random subset of ``reserved`` positions out of ``seq_len``
    (sorted so causal order survives — the reference sorts its sampled
    indices for decoder models). ``generator`` is a ``torch.Generator``; the
    indices are drawn on its device."""
    perm = torch.randperm(seq_len, generator=generator, device=generator.device)
    return torch.sort(perm[:reserved]).values


def gather_tokens(hidden, indices):
    """[B, S, H] → [B, reserved, H] (reference GatherTokens)."""
    return hidden.index_select(1, indices.to(hidden.device))


def scatter_tokens(full, part, indices):
    """Write the processed subset back into the full sequence at ``indices``
    (reference ScatterTokens); ``full`` itself is left as it was."""
    return full.index_copy(1, indices.to(full.device), part)
