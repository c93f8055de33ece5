"""0/1 Adam, functional.

Port of ``deepspeed_tpu/ops/adam/zero_one_adam.py`` (reference
``deepspeed/runtime/fp16/onebit/zoadam.py``, arXiv:2202.06009):

- variance-update policy: until ``var_freeze_step`` the variance refreshes
  only at steps divisible by ``var_interval``, which doubles every
  ``var_update_scaler`` refreshes; at a refresh the momentum takes the exact
  gradient, between refreshes the sign-compressed one with error feedback;
- local-step policy: after the variance freezes, the parameters move every
  step while the accumulated update (``comm_buffer``) syncs every
  ``local_step_interval`` steps, scaled by the denominator, sign-compressed
  with its own error feedback; the momentum is re-seeded from the synced
  buffer over the lr accumulated since the last sync. The interval doubles
  every ``local_step_scaler`` counts, up to ``local_step_clipper``.

With one rank nothing crosses a wire; the trajectory is the reference's.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.adam.onebit_adam import sign_compress
from deepspeed_tpu_torch.ops.optimizer import TorchOptimizer, step_zero, zeros_like_tree


class ZeroOneAdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    exp_avg: dict
    exp_avg_sq: dict
    worker_error: dict  # gradient-compression error (variance stage)
    sync_error: dict  # buffer-compression error (local-step stage)
    comm_buffer: dict  # accumulated update between syncs
    lrs: torch.Tensor  # f32: lr accumulated between syncs
    var_interval: torch.Tensor  # int32 scalars from here on
    var_counter: torch.Tensor
    local_interval: torch.Tensor
    local_counter: torch.Tensor


class ZeroOneAdam(TorchOptimizer):

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, var_freeze_step=100,
                 var_update_scaler=16, local_step_scaler=100, local_step_clipper=16, cuda_aware=False,
                 comm_backend_name="nccl"):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.var_freeze_step = int(var_freeze_step)
        self.var_update_scaler = int(var_update_scaler)
        self.local_step_scaler = int(local_step_scaler)
        self.local_step_clipper = int(local_step_clipper)

    def init(self, params: dict) -> ZeroOneAdamState:
        step = step_zero(params)
        one = torch.ones_like(step)
        return ZeroOneAdamState(step=step, exp_avg=zeros_like_tree(params), exp_avg_sq=zeros_like_tree(params),
                                worker_error=zeros_like_tree(params), sync_error=zeros_like_tree(params),
                                comm_buffer=zeros_like_tree(params), lrs=torch.zeros_like(step, dtype=torch.float32),
                                var_interval=one, var_counter=step.clone(), local_interval=one.clone(),
                                local_counter=step.clone())

    def update(self, grads: dict, state: ZeroOneAdamState, params: dict, lr):
        b1, b2 = self.betas
        eps, wd = self.eps, self.weight_decay
        step = state.step + 1
        frozen = step > self.var_freeze_step
        var_refresh = (~frozen) & (step % state.var_interval == 0)
        sync_now = frozen & (step % state.local_interval == 0)
        lrs_new = torch.where(sync_now, 0.0, torch.where(frozen, state.lrs + lr, state.lrs))
        lrs_at_sync = state.lrs + lr
        use_exact = var_refresh | frozen

        new_p = {}
        out = {f: {} for f in ("exp_avg", "exp_avg_sq", "worker_error", "sync_error", "comm_buffer")}
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            m, v, err = state.exp_avg[name], state.exp_avg_sq[name], state.worker_error[name]
            serr, buf = state.sync_error[name], state.comm_buffer[name]
            # between variance refreshes the momentum sees the compressed grad
            compensated = g + err
            g_comp = sign_compress(compensated)
            g_used = torch.where(use_exact, g, g_comp)
            err_new = torch.where(use_exact, err, compensated - g_comp)

            m_new = b1 * m + (1.0 - b1) * g_used
            v_new = torch.where(var_refresh, b2 * v + (1.0 - b2) * (g * g), v)

            denom = torch.sqrt(v_new) + eps
            update = m_new / denom
            if wd > 0.0:
                update = update + wd * p
            p_new = p - lr * update
            buf_acc = torch.where(frozen, buf - lr * update, buf)

            # local-step sync: revert the local drift, sync the
            # denominator-scaled buffer (compressed, error-fed), re-seed the
            # momentum, re-apply
            p_revert = p_new - buf_acc
            comp2 = buf_acc * denom + serr
            buf_sync = sign_compress(comp2)
            m_sync = -buf_sync / torch.clamp(lrs_at_sync, min=1e-12)
            p_sync = p_revert + buf_sync / denom

            new_p[name] = torch.where(sync_now, p_sync, p_new)
            out["exp_avg"][name] = torch.where(sync_now, m_sync, m_new)
            out["exp_avg_sq"][name] = v_new
            out["worker_error"][name] = err_new
            out["sync_error"][name] = torch.where(sync_now, comp2 - buf_sync, serr)
            out["comm_buffer"][name] = torch.where(sync_now, torch.zeros_like(buf), buf_acc)

        # interval policies
        vc = torch.where(var_refresh, state.var_counter + 1, state.var_counter)
        double_var = vc == self.var_update_scaler
        var_counter = torch.where(~frozen, torch.where(double_var, 0, vc), state.var_counter)
        var_interval = torch.where((~frozen) & double_var, state.var_interval * 2, state.var_interval)
        lc = torch.where(frozen, state.local_counter + 1, state.local_counter)
        double_local = lc == self.local_step_scaler
        local_counter = torch.where(frozen, torch.where(double_local, 0, lc), state.local_counter)
        local_interval = torch.where(frozen & double_local,
                                     torch.clamp(state.local_interval * 2, max=self.local_step_clipper),
                                     state.local_interval)
        return new_p, ZeroOneAdamState(step=step, lrs=lrs_new, var_interval=var_interval, var_counter=var_counter,
                                       local_interval=local_interval, local_counter=local_counter, **out)
