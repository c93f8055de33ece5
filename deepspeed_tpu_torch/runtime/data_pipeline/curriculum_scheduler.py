"""Curriculum learning difficulty scheduler.

Port of ``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``
(reference ``deepspeed/runtime/data_pipeline/curriculum_scheduler.py``): maps
the global step to a difficulty value (typically the sequence length) through
``fixed_linear`` / ``fixed_root`` / ``fixed_discrete`` / ``custom`` schedules.
Host logic only; the engine truncates batches to the current difficulty.
"""

import math

from deepspeed_tpu_torch.utils.logging import logger

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:

    def __init__(self, config: dict):
        for key in ("min_difficulty", "max_difficulty", "schedule_type"):
            assert key in config, f"curriculum learning requires config {key!r}"
        self.state = {
            "min_difficulty": config["min_difficulty"],
            "max_difficulty": config["max_difficulty"],
            "current_difficulty": config["min_difficulty"],
            "schedule_type": config["schedule_type"],
        }
        self.first_step = True
        schedule = config.get("schedule_config", {})
        stype = config["schedule_type"]
        if stype == FIXED_DISCRETE:
            assert len(schedule.get("difficulty", [])) > 0
            assert len(schedule.get("max_step", [])) == len(schedule["difficulty"]) - 1, \
                "fixed_discrete needs len(max_step) == len(difficulty) - 1"
        elif stype in (FIXED_LINEAR, FIXED_ROOT):
            assert schedule.get("total_curriculum_step", 0) > 0
            assert schedule.get("difficulty_step", 0) > 0
            if stype == FIXED_ROOT:
                assert schedule.get("root_degree", 0) > 0
            if schedule["difficulty_step"] % 8 != 0:
                logger.warning("difficulty_step not multiple of 8: sequence lengths may "
                               "be tile-unfriendly on the GPU (reference warns for fp16 too)")
        elif stype == CUSTOM:
            self.custom_get_difficulty = None
        else:
            raise RuntimeError(f"unsupported schedule type {stype}")
        self.state["schedule"] = schedule

    # -- reference API --------------------------------------------------------
    def get_current_difficulty(self):
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty):
        self.state["current_difficulty"] = difficulty

    def set_custom_get_difficulty(self, fn):
        self.custom_get_difficulty = fn

    def get_state(self):
        return self.state

    def set_state(self, state):
        self.state = state

    def __fixed_discrete(self, global_steps):
        sched = self.state["schedule"]
        for limit, diff in zip(sched["max_step"], sched["difficulty"]):
            if global_steps <= limit:
                return diff
        return sched["difficulty"][-1]

    def __fixed_root(self, global_steps, degree):
        sched = self.state["schedule"]
        frac = min(1.0, (global_steps / sched["total_curriculum_step"])**(1.0 / degree))
        diff = self.state["min_difficulty"] + frac * (self.state["max_difficulty"] -
                                                      self.state["min_difficulty"])
        diff -= diff % sched["difficulty_step"]
        return int(min(self.state["max_difficulty"], max(self.state["min_difficulty"], diff)))

    def get_difficulty(self, global_steps: int) -> int:
        stype = self.state["schedule_type"]
        if stype == FIXED_DISCRETE:
            return self.__fixed_discrete(global_steps)
        if stype == FIXED_LINEAR:
            return self.__fixed_root(global_steps, 1)
        if stype == FIXED_ROOT:
            return self.__fixed_root(global_steps, self.state["schedule"]["root_degree"])
        assert self.custom_get_difficulty is not None, "custom schedule needs a callable"
        return self.custom_get_difficulty(global_steps)

    def update_difficulty(self, global_steps: int) -> int:
        if self.state["current_difficulty"] < self.state["max_difficulty"]:
            self.state["current_difficulty"] = self.get_difficulty(global_steps)
        return self.state["current_difficulty"]
