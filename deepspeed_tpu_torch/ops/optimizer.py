"""Optimizer base protocol.

Port of ``deepspeed_tpu/ops/optimizer.py``: an optimizer is a functional
transform over dicts of tensors — ``init(params) -> state`` and
``update(grads, state, params, lr) -> (new_params, new_state)`` — that the
engine applies once per step, plus the reference's imperative ``get_lr`` /
``set_lr`` / ``param_groups`` surface that the LR schedules drive. The JAX
package has no Pallas kernel here (XLA fuses the update), so the port's
updates are plain torch ops.
"""

import torch


class TorchOptimizer:
    """Functional optimizer protocol; subclasses implement init/update."""

    def __init__(self, lr=1e-3, weight_decay=0.0):
        self.lr = lr
        self.weight_decay = weight_decay

    def init(self, params: dict):
        raise NotImplementedError

    def update(self, grads: dict, state, params: dict, lr):
        raise NotImplementedError

    def get_lr(self):
        return self.lr

    def set_lr(self, lr):
        self.lr = lr

    @property
    def param_groups(self):
        return [{"lr": self.lr, "weight_decay": self.weight_decay}]


def zeros_like_tree(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}
