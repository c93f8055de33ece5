"""SGD with momentum (``torch.optim.SGD``'s semantics), functional.

Port of ``deepspeed_tpu/ops/sgd/sgd.py``. Without momentum the state holds
no buffer (``momentum_buf`` is None).
"""

from typing import NamedTuple, Optional

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, step_zero, zeros_like_tree


class SGDState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    momentum_buf: Optional[dict]


class SGD(TorchOptimizer):

    elementwise = True  # each element's update reads only that element

    def __init__(self, lr=1e-2, momentum=0.0, weight_decay=0.0, nesterov=False):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: dict) -> SGDState:
        return SGDState(step=step_zero(params), momentum_buf=zeros_like_tree(params) if self.momentum else None)

    def update(self, grads: dict, state: SGDState, params: dict, lr):
        wd, mom = self.weight_decay, self.momentum
        new_p, new_b = {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if not mom:
                new_p[name] = p - lr * (g + (wd * p if wd else 0.0))
                continue
            if wd != 0.0:
                g = g + wd * p
            b = mom * state.momentum_buf[name] + g
            g = (g + mom * b) if self.nesterov else b
            new_p[name] = p - lr * g
            new_b[name] = b
        return new_p, SGDState(step=state.step + 1, momentum_buf=new_b if mom else None)
