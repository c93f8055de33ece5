"""Curriculum-aware data sampler.

Port of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py`` (numpy, as
there). Reference: ``deepspeed/runtime/data_pipeline/data_sampling/data_sampler.py:338``
(DeepSpeedDataSampler) — difficulty-based curriculum batching: each metric has
per-sample difficulty values; at every step the sampler draws the global batch
from the pool of samples whose difficulty is within the current curriculum
threshold, dp-sharding deterministically.

Formulation: pure host logic producing index arrays; the engine's
dataloader consumes them. Difficulties come in as a numpy array (the
reference's offline ``data_analyzer`` index files reduce to exactly this).
"""

from typing import Optional

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedDataSampler:
    """Deterministic curriculum batch sampler over sample difficulties."""

    def __init__(self, difficulties: np.ndarray, batch_size: int,
                 curriculum_scheduler: Optional[CurriculumScheduler] = None,
                 data_parallel_rank: int = 0, data_parallel_size: int = 1,
                 drop_last: bool = True, seed: int = 0):
        self.difficulties = np.asarray(difficulties)
        self.batch_size = batch_size
        assert batch_size % data_parallel_size == 0, \
            f"batch {batch_size} must divide over dp={data_parallel_size}"
        self.micro = batch_size // data_parallel_size
        self.scheduler = curriculum_scheduler
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.drop_last = drop_last
        self.seed = seed
        self.global_step = 0

    def _eligible(self) -> np.ndarray:
        if self.scheduler is None:
            return np.arange(len(self.difficulties))
        limit = self.scheduler.update_difficulty(self.global_step)
        idx = np.nonzero(self.difficulties <= limit)[0]
        if idx.size < self.batch_size:
            logger.warning(f"curriculum difficulty {limit} admits only {idx.size} samples; "
                           f"falling back to the easiest {self.batch_size}")
            idx = np.argsort(self.difficulties)[:self.batch_size]
        return idx

    def next_batch(self) -> np.ndarray:
        """Global indices of THIS dp rank's micro-batch for the current step."""
        pool = self._eligible()
        rng = np.random.default_rng(self.seed + self.global_step)
        chosen = rng.choice(pool, size=self.batch_size, replace=pool.size < self.batch_size)
        self.global_step += 1
        return chosen[self.dp_rank * self.micro:(self.dp_rank + 1) * self.micro]

    def __iter__(self):
        steps = len(self.difficulties) // self.batch_size
        for _ in range(steps):
            yield self.next_batch()

    def __len__(self):
        return len(self.difficulties) // self.batch_size

    # checkpointable (reference state_dict/load_state_dict)
    def state_dict(self):
        sched = self.scheduler.get_state() if self.scheduler else None
        return {"global_step": self.global_step, "seed": self.seed, "scheduler": sched}

    def load_state_dict(self, sd):
        self.global_step = sd["global_step"]
        self.seed = sd["seed"]
        if self.scheduler is not None and sd.get("scheduler"):
            self.scheduler.set_state(sd["scheduler"])
