"""Adam / AdamW, functional.

Port of ``deepspeed_tpu/ops/adam/fused_adam.py`` (``FusedAdam``), with its
arithmetic in its order: an int32 step, bias corrections ``1 - beta**step``
in f32, eps added outside the square root, and the decoupled (AdamW) decay
``wd * p`` added to the step before ``lr`` scales it; the L2 (Adam) decay is
added to the gradient before the moments. ``torch.optim.AdamW`` orders its
arithmetic differently, so it is not used.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, zeros_like_tree


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict
    exp_avg_sq: dict


class FusedAdam(TorchOptimizer):

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                 bias_correction=True, amsgrad=False, set_grad_none=True):
        super().__init__(lr=lr, weight_decay=weight_decay)
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant (reference parity)")
        self.betas = tuple(betas)
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def init(self, params: dict) -> AdamState:
        device = next(iter(params.values())).device if params else None
        return AdamState(step=torch.zeros([], dtype=torch.int32, device=device),
                         exp_avg=zeros_like_tree(params), exp_avg_sq=zeros_like_tree(params))

    def update(self, grads: dict, state: AdamState, params: dict, lr):
        b1, b2 = self.betas
        step = state.step + 1
        stepf = step.float()
        if self.bias_correction:
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=stepf.device)**stepf
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=stepf.device)**stepf
        else:
            bc1 = bc2 = 1.0
        wd = self.weight_decay
        new_p, new_m, new_v = {}, {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if wd != 0.0 and not self.adam_w_mode:
                g = g + wd * p
            m = b1 * state.exp_avg[name] + (1.0 - b1) * g
            v = b2 * state.exp_avg_sq[name] + (1.0 - b2) * (g * g)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd != 0.0 and self.adam_w_mode:
                update = update + wd * p
            new_p[name] = p - lr * update
            new_m[name], new_v[name] = m, v
        return new_p, AdamState(step=step, exp_avg=new_m, exp_avg_sq=new_v)
