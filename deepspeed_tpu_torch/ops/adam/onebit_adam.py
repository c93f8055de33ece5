"""1-bit Adam, functional.

Port of ``deepspeed_tpu/ops/adam/onebit_adam.py`` (reference
``deepspeed/runtime/fp16/onebit/adam.py``): exact Adam until ``freeze_step``;
after it the variance is frozen and the momentum is sign-compressed (its
mean absolute value times its sign) with error feedback kept in the state
(``worker_error``). With one rank nothing crosses a wire; the numerics are
the reference's, compression error included.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, bias_corrections, step_zero, zeros_like_tree


class OnebitAdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict
    exp_avg_sq: dict
    worker_error: dict  # error feedback


def sign_compress(x):
    """``mean(|x|) * sign(x)``: one scale and a sign per element (sign(0) is
    0, so zero entries get no update)."""
    return torch.mean(torch.abs(x)) * torch.sign(x)


class OnebitAdam(TorchOptimizer):

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, freeze_step=100, cuda_aware=False,
                 comm_backend_name="nccl"):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.freeze_step = int(freeze_step)

    def init(self, params: dict) -> OnebitAdamState:
        return OnebitAdamState(step=step_zero(params), exp_avg=zeros_like_tree(params),
                               exp_avg_sq=zeros_like_tree(params), worker_error=zeros_like_tree(params))

    def update(self, grads: dict, state: OnebitAdamState, params: dict, lr):
        b1, b2 = self.betas
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, b1, b2)
        frozen = step > self.freeze_step
        wd = self.weight_decay
        new_p, new_m, new_v, new_e = {}, {}, {}, {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m, v, err = state.exp_avg[name], state.exp_avg_sq[name], state.worker_error[name]
            m_new = b1 * m + (1.0 - b1) * g
            v_new = torch.where(frozen, v, b2 * v + (1.0 - b2) * (g * g))
            compensated = m_new + err
            compressed = sign_compress(compensated)
            m_used = torch.where(frozen, compressed, m_new)
            new_e[name] = torch.where(frozen, compensated - compressed, err)
            update = (m_used / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if wd != 0.0:
                update = update + wd * p
            new_p[name] = p - lr * update
            new_m[name], new_v[name] = m_used, v_new
        return new_p, OnebitAdamState(step=step, exp_avg=new_m, exp_avg_sq=new_v, worker_error=new_e)
