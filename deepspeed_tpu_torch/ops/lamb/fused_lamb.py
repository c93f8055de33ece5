"""LAMB, functional.

Port of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (``FusedLamb``): the Adam
step, rescaled per tensor by the trust ratio ``||p|| / ||update||`` clipped
to ``[min_coeff, max_coeff]`` (1 where either norm is 0), with the
reference's arithmetic in its order.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, bias_corrections, step_zero, zeros_like_tree


class LambState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict
    exp_avg_sq: dict


class FusedLamb(TorchOptimizer):

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01, amsgrad=False):
        super().__init__(lr=lr, weight_decay=weight_decay)
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad variant")
        self.betas = tuple(betas)
        self.eps = eps
        self.bias_correction = bias_correction
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params: dict) -> LambState:
        return LambState(step=step_zero(params), exp_avg=zeros_like_tree(params), exp_avg_sq=zeros_like_tree(params))

    def update(self, grads: dict, state: LambState, params: dict, lr):
        b1, b2 = self.betas
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, b1, b2) if self.bias_correction else (1.0, 1.0)
        wd = self.weight_decay
        new_p, new_m, new_v = {}, {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m = b1 * state.exp_avg[name] + (1.0 - b1) * g
            v = b2 * state.exp_avg_sq[name] + (1.0 - b2) * (g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd != 0.0:
                u = u + wd * p
            p_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(u.float())
            trust = torch.where((p_norm > 0) & (u_norm > 0),
                                torch.clamp(p_norm / u_norm, self.min_coeff, self.max_coeff), 1.0)
            new_p[name] = p - lr * trust * u
            new_m[name], new_v[name] = m, v
        return new_p, LambState(step=step, exp_avg=new_m, exp_avg_sq=new_v)

