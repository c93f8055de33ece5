"""Adagrad, functional.

Port of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py``
(``DeepSpeedCPUAdagrad``). The reference keeps its state in host memory
(ZeRO offload, ROADMAP A8); here it stays on the engine's device.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, step_zero, zeros_like_tree


class AdagradState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    sum_sq: dict


class DeepSpeedCPUAdagrad(TorchOptimizer):

    elementwise = True  # each element's update reads only that element

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.eps = eps

    def init(self, params: dict) -> AdagradState:
        return AdagradState(step=step_zero(params), sum_sq=zeros_like_tree(params))

    def update(self, grads: dict, state: AdagradState, params: dict, lr):
        wd = self.weight_decay
        new_p, new_s = {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if wd != 0.0:
                g = g + wd * p
            s = state.sum_sq[name] + g * g
            new_p[name] = p - lr * g / (torch.sqrt(s) + self.eps)
            new_s[name] = s
        return new_p, AdagradState(step=state.step + 1, sum_sq=new_s)


FusedAdagrad = DeepSpeedCPUAdagrad
