"""Scheduling results.

Port of ``deepspeed_tpu/inference/v2/scheduling_utils.py`` (SchedulingResult /
SchedulingError used by ``engine_v2.can_schedule``/``put``).
"""

from enum import Enum


class SchedulingResult(Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    BatchTokenLimitExceeded = 3
    KVCacheLimitExceeded = 4
    SequenceTokenLimitExceeded = 5


class SchedulingError(RuntimeError):

    def __init__(self, result: SchedulingResult):
        self.status = result
        super().__init__(f"Batch scheduling failed: {result.name}")
