"""Lion, functional.

Port of ``deepspeed_tpu/ops/lion/fused_lion.py`` (``FusedLion``): the sign
of the interpolated momentum, decoupled weight decay.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, step_zero, zeros_like_tree


class LionState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict


class FusedLion(TorchOptimizer):

    elementwise = True  # each element's update reads only that element

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)

    def init(self, params: dict) -> LionState:
        return LionState(step=step_zero(params), exp_avg=zeros_like_tree(params))

    def update(self, grads: dict, state: LionState, params: dict, lr):
        b1, b2 = self.betas
        wd = self.weight_decay
        new_p, new_m = {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m = state.exp_avg[name]
            c = b1 * m + (1.0 - b1) * g
            new_p[name] = p * (1.0 - lr * wd) - lr * torch.sign(c)
            new_m[name] = b2 * m + (1.0 - b2) * g
        return new_p, LionState(step=state.step + 1, exp_avg=new_m)


DeepSpeedCPULion = FusedLion  # the reference's host variant shares the numerics
