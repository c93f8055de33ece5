"""Learning-rate schedules.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (reference
``deepspeed/runtime/lr_schedules.py``: LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR, WarmupCosineLR). The schedules run on the host: each is a
pure ``step -> lr`` function wrapped in a stateful object with the
reference's ``step()`` / ``get_lr()`` / ``get_last_lr()`` / ``state_dict()``
API; ``step()`` hands the new lr to the optimizer's ``set_lr``.
"""

import math
from typing import List, Union

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


class _LRSchedulerBase:
    """Stateful wrapper exposing the torch-style scheduler API over a pure fn."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def _lr_at(self, step: int) -> List[float]:
        raise NotImplementedError

    def get_lr(self) -> List[float]:
        return self._lr_at(max(0, self.last_batch_iteration))

    def get_last_lr(self) -> List[float]:
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        if self.optimizer is not None and hasattr(self.optimizer, "set_lr"):
            self.optimizer.set_lr(lrs[0])
        self._last_lr = lrs
        return lrs

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_LRSchedulerBase):
    """Reference lr_schedules.py:267 — LR range test (Smith 2017)."""

    def __init__(self,
                 optimizer=None,
                 lr_range_test_min_lr: Union[float, List[float]] = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        if lr_range_test_step_size <= 0:
            raise ValueError(f"Step size must be positive, got {lr_range_test_step_size}")
        self.min_lr = lr_range_test_min_lr if isinstance(lr_range_test_min_lr, list) else [lr_range_test_min_lr]
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def _lr_at(self, step):
        if self.staircase:
            interval = float(step // self.step_size)
        else:
            interval = step / self.step_size
        scale = 1.0 + self.step_rate * interval
        return [lr * scale for lr in self.min_lr]


class OneCycle(_LRSchedulerBase):
    """Reference lr_schedules.py:370 — 1-cycle LR (+ optional momentum cycle)."""

    def __init__(self,
                 optimizer=None,
                 cycle_min_lr: float = 0.001,
                 cycle_max_lr: float = 0.01,
                 decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: int = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: int = None,
                 decay_step_size: int = 0,
                 cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.8,
                 cycle_max_mom: float = 0.9,
                 decay_mom_rate: float = 0.0,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_step_size = cycle_first_step_size
        self.second_step_size = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_cycle_size = self.first_step_size + self.second_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _lr_at(self, step):
        if step < self.total_cycle_size:
            if step < self.first_step_size:
                frac = step / self.first_step_size
                lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
            else:
                frac = (step - self.first_step_size) / self.second_step_size
                lr = self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * frac
            return [lr]
        # decay phase
        decay_steps = step - self.total_cycle_size + 1
        if self.decay_step_size > 0:
            intervals = decay_steps / self.decay_step_size
        else:
            intervals = decay_steps
        lr = self.cycle_min_lr / (1.0 + self.decay_lr_rate * intervals)
        return [lr]

    def get_mom(self):
        step = max(0, self.last_batch_iteration)
        if not self.cycle_momentum:
            return None
        if step < self.total_cycle_size:
            if step < self.first_step_size:
                frac = step / self.first_step_size
                mom = self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * frac
            else:
                frac = (step - self.first_step_size) / self.second_step_size
                mom = self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * frac
            return [mom]
        decay_steps = step - self.total_cycle_size + 1
        if self.decay_step_size > 0:
            intervals = decay_steps / self.decay_step_size
        else:
            intervals = decay_steps
        return [self.cycle_max_mom * (1.0 + self.decay_mom_rate * intervals)]


class WarmupLR(_LRSchedulerBase):
    """Reference lr_schedules.py:634 — warmup to base lr then hold."""

    def __init__(self,
                 optimizer=None,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = [warmup_min_lr] if not isinstance(warmup_min_lr, list) else warmup_min_lr
        self.max_lrs = [warmup_max_lr] if not isinstance(warmup_max_lr, list) else warmup_max_lr
        self.delta_lrs = [big - small for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            raise ValueError(f"warmup_type {warmup_type} not supported")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _get_gamma(self, step):
        if step < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(step + 1)
            return min(1.0, step / self.warmup_num_steps)
        return 1.0

    def _lr_at(self, step):
        gamma = self._get_gamma(step)
        return [min_lr + gamma * delta for min_lr, delta in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Reference lr_schedules.py:723 — warmup then linear decay to 0."""

    def __init__(self,
                 optimizer=None,
                 total_num_steps: int = 10000,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 warmup_type: str = WARMUP_LOG_RATE,
                 last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type,
                         last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            raise ValueError(f"total_num_steps {total_num_steps} is less than warmup_num_steps {warmup_num_steps}")

    def _get_gamma(self, step):
        if step < self.warmup_num_steps:
            return super()._get_gamma(step)
        return max(
            0.0,
            float(self.total_num_steps - step) / float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


class WarmupCosineLR(_LRSchedulerBase):
    """Reference lr_schedules.py:774 — linear warmup then cosine decay."""

    def __init__(self,
                 optimizer=None,
                 total_num_steps: int = 10000,
                 warmup_min_ratio: float = 0.0,
                 warmup_num_steps: int = 1000,
                 cos_min_ratio: float = 0.0001,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.base_lr = 1.0  # ratios multiply the optimizer's base lr
        if optimizer is not None and hasattr(optimizer, "get_lr"):
            self.base_lr = optimizer.get_lr()

    def _get_ratio(self, step):
        if step < self.warmup_num_steps:
            frac = step / self.warmup_num_steps
            return self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * frac
        frac = (step - self.warmup_num_steps) / max(1, self.total_num_steps - self.warmup_num_steps)
        frac = min(1.0, frac)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.cos_min_ratio + (1.0 - self.cos_min_ratio) * cos

    def _lr_at(self, step):
        return [self.base_lr * self._get_ratio(step)]


_SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def get_lr_schedule_class(name: str):
    if name not in _SCHEDULES:
        raise ValueError(f"{name} is not a valid LR schedule; valid: {VALID_LR_SCHEDULES}")
    return _SCHEDULES[name]
