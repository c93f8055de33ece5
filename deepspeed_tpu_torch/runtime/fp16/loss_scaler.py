"""Loss scaling.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``: the scale state is a
small tuple of 0-d tensors that lives on the device beside the parameters,

    state = (cur_scale f32, good_steps int32, hysteresis int32)

and :func:`update_scale` applies the reference ``DynamicLossScaler``
semantics with tensor ops, so an overflow never costs a host round trip.
bf16 and f32 runs keep a static scale of 1.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: torch.Tensor  # f32 scalar
    good_steps: torch.Tensor  # int32 scalar
    hysteresis: torch.Tensor  # int32 scalar


def static_loss_scale_state(scale: float, device=None) -> LossScaleState:
    return LossScaleState(cur_scale=torch.tensor(scale, dtype=torch.float32, device=device),
                          good_steps=torch.zeros([], dtype=torch.int32, device=device),
                          hysteresis=torch.tensor(1, dtype=torch.int32, device=device))


def dynamic_loss_scale_state(initial_scale_power=16, delayed_shift=2, device=None) -> LossScaleState:
    return LossScaleState(cur_scale=torch.tensor(2.0**initial_scale_power, dtype=torch.float32, device=device),
                          good_steps=torch.zeros([], dtype=torch.int32, device=device),
                          hysteresis=torch.tensor(delayed_shift, dtype=torch.int32, device=device))


def update_scale(state: LossScaleState,
                 overflow,
                 *,
                 scale_window: int = 1000,
                 scale_factor: float = 2.0,
                 min_scale: float = 1.0,
                 delayed_shift: int = 1,
                 consecutive_hysteresis: bool = False,
                 dynamic: bool = True) -> LossScaleState:
    """Pure update — reference DynamicLossScaler.update_scale semantics: an
    overflow either consumes one hysteresis count (``delayed_shift > 1`` and
    counts remain) or shrinks the scale; hysteresis refills at the scale
    window (or every good step with ``consecutive_hysteresis``), and the scale
    grows after ``scale_window`` good steps."""
    if not dynamic:
        return state
    overflow = torch.as_tensor(overflow, device=state.cur_scale.device)
    delayed = torch.tensor(delayed_shift, dtype=torch.int32, device=state.hysteresis.device)
    zero = torch.zeros_like(state.good_steps)

    must_shrink = overflow & ((delayed_shift == 1) | (state.hysteresis <= 1))
    shrunk = torch.clamp(state.cur_scale / scale_factor, min=min_scale)
    h_on_overflow = torch.where(must_shrink, state.hysteresis, state.hysteresis - 1)

    window_full = (state.good_steps + 1) % scale_window == 0
    grown = torch.where(~overflow & window_full, state.cur_scale * scale_factor, state.cur_scale)

    new_scale = torch.where(must_shrink, shrunk, grown)
    new_good = torch.where(overflow, zero, torch.where(window_full, zero, state.good_steps + 1))
    h_on_good = delayed if consecutive_hysteresis else torch.where(window_full, delayed, state.hysteresis)
    new_h = torch.where(overflow, h_on_overflow, h_on_good)
    return LossScaleState(cur_scale=new_scale, good_steps=new_good.to(torch.int32), hysteresis=new_h.to(torch.int32))
