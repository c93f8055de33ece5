"""1-bit LAMB, functional.

Port of ``deepspeed_tpu/ops/lamb/onebit_lamb.py`` (reference
``deepspeed/runtime/fp16/onebit/lamb.py``, arXiv:2104.06069):

- until ``freeze_step``, exact LAMB, with a running EMA of each tensor's
  trust ratio (``lamb_coeff_freeze``, ``coeff_beta``);
- after it, the variance is frozen, the momentum is sign-compressed with
  error feedback, a fresh variance follows the gradient reconstructed from
  the compressed momentum, and the trust ratio is ``lamb_coeff_freeze``
  times a factor ``max(denom_frozen / denom_fresh)``, clipped to
  ``[factor_min, factor_max]`` and to within ``factor_threshold`` of the
  previous step's.

As in the reference, the compression is per tensor with its own scale (the
reference's one-time ``scaling_coeff`` across layers is not needed then).
With one rank nothing crosses a wire.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.adam.onebit_adam import sign_compress
from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, step_zero, zeros_like_tree


class OnebitLambState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict
    exp_avg_sq: dict  # frozen after freeze_step
    exp_avg_sq_fresh: dict  # variance of the reconstructed gradient
    worker_error: dict  # error feedback
    lamb_coeff_freeze: dict  # per-tensor EMA of the warmup trust ratio (f32 scalars)
    last_factor: dict  # per-tensor factor of the previous step (f32 scalars)


class OnebitLamb(TorchOptimizer):

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, freeze_step=100, max_coeff=10.0,
                 min_coeff=0.01, coeff_beta=0.9, factor_max=4.0, factor_min=0.5, factor_threshold=0.1,
                 cuda_aware=False, comm_backend_name="nccl"):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.freeze_step = int(freeze_step)
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.coeff_beta = coeff_beta
        self.factor_max = factor_max
        self.factor_min = factor_min
        self.factor_threshold = factor_threshold

    def init(self, params: dict) -> OnebitLambState:
        return OnebitLambState(
            step=step_zero(params), exp_avg=zeros_like_tree(params), exp_avg_sq=zeros_like_tree(params),
            exp_avg_sq_fresh=zeros_like_tree(params), worker_error=zeros_like_tree(params),
            lamb_coeff_freeze={k: torch.zeros([], dtype=torch.float32, device=p.device) for k, p in params.items()},
            last_factor={k: torch.ones([], dtype=torch.float32, device=p.device) for k, p in params.items()})

    def update(self, grads: dict, state: OnebitLambState, params: dict, lr):
        b1, b2 = self.betas
        step = state.step + 1
        frozen = step > self.freeze_step
        at_freeze_boundary = step == (self.freeze_step + 1)
        wd, eps = self.weight_decay, self.eps
        out = {f: {} for f in OnebitLambState._fields[1:]}
        new_p = {}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m, v, vf = state.exp_avg[name], state.exp_avg_sq[name], state.exp_avg_sq_fresh[name]
            err, cf, lf = state.worker_error[name], state.lamb_coeff_freeze[name], state.last_factor[name]
            m_new = b1 * m + (1.0 - b1) * g
            v_new = torch.where(frozen, v, b2 * v + (1.0 - b2) * (g * g))

            # compressed-stage momentum: sign, L1 scale, error feedback
            compensated = m_new + err
            compressed = sign_compress(compensated)
            m_used = torch.where(frozen, compressed, m_new)
            err_new = torch.where(frozen, compensated - compressed, err)

            # fresh variance from the reconstructed gradient, seeded from the
            # frozen one at the boundary
            g_rec = (m_used - b1 * m) / (1.0 - b1)
            vf_base = torch.where(at_freeze_boundary, v_new, vf)
            vf_new = torch.where(frozen, b2 * vf_base + (1.0 - b2) * (g_rec * g_rec), vf)

            denom = torch.sqrt(v_new) + eps
            update_prelim = m_used / denom
            update = update_prelim + wd * p if wd > 0.0 else update_prelim

            w_norm = torch.linalg.vector_norm(p.float())
            u_norm = torch.linalg.vector_norm(update.float())
            raw_coeff = torch.where((w_norm > 0) & (u_norm > 0),
                                    torch.clamp(w_norm / torch.clamp(u_norm, min=1e-12), self.min_coeff,
                                                self.max_coeff), 1.0)
            cf_new = torch.where(frozen, cf,
                                 torch.where(raw_coeff != 1.0,
                                             self.coeff_beta * cf + (1 - self.coeff_beta) * raw_coeff, cf))

            # compressed-stage factor
            denom_real = torch.sqrt(torch.where(frozen, vf_new, v_new)) + eps
            factor = torch.max(denom / denom_real)
            if wd > 0.0:
                ratio = torch.clamp(torch.linalg.vector_norm(update_prelim.float()) / torch.clamp(u_norm, min=1e-12),
                                    max=1.0)
                factor = factor * ratio + (1.0 - ratio)
            factor = torch.clamp(factor, self.factor_min, self.factor_max)
            factor = torch.clamp(factor, lf * (1.0 - self.factor_threshold), lf * (1.0 + self.factor_threshold))
            lf_new = torch.where(frozen, factor, lf)

            coeff = torch.where(frozen, cf_new * factor, raw_coeff)
            new_p[name] = p - lr * coeff * update
            for f, val in zip(OnebitLambState._fields[1:], (m_used, v_new, vf_new, err_new, cf_new, lf_new)):
                out[f][name] = val
        return new_p, OnebitLambState(step=step, **out)
