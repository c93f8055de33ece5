"""Wall-clock and throughput timers.

Port of ``deepspeed_tpu/utils/timer.py`` (reference ``deepspeed/utils/timer.py``:
``SynchronizedWallClockTimer``, ``NoopTimer``, ``ThroughputTimer``). Before it
reads the host clock a timer waits for the device: ``torch.cuda.synchronize``
on a CUDA device, nothing on the CPU (whose ops have finished when they
return).

The engine builds real timers only under ``wall_clock_breakdown`` or
telemetry, and its ``ThroughputTimer`` synchronizes only then
(``config.synchronized``): the JAX package's barrier
(``jax.effects_barrier``) waits for side effects, not for computations, so its
throughput timer never holds the host back, and neither does the port's by
default.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"

TRAIN_BATCH_TIMER = "train_batch"


def device_synchronize(device=None):
    """Wait for ``device``'s queued work (the current CUDA device when None);
    nothing on the CPU or without a GPU."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timers that wait for ``device`` before reading the clock."""

    class Timer:

        def __init__(self, name, device=None):
            self.name_ = name
            self.device = device
            self.started_ = False
            self.start_time = 0.0
            self.elapsed_ = 0.0
            self.elapsed_records = []

        def start(self):
            assert not self.started_, f"{self.name_} timer has already been started"
            device_synchronize(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False, record=True):
            assert self.started_, f"{self.name_} timer is not started"
            device_synchronize(self.device)
            elapsed = time.time() - self.start_time
            if reset:
                self.elapsed_ = elapsed
            else:
                self.elapsed_ += elapsed
            if record:
                self.elapsed_records.append(elapsed)
            self.started_ = False

        def reset(self):
            self.started_ = False
            self.elapsed_ = 0.0

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop(record=False)
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

        def mean(self):
            if not self.elapsed_records:
                return 0.0
            return sum(self.elapsed_records) / len(self.elapsed_records)

    def __init__(self, device=None):
        self.device = device
        self.timers = {}

    def get_timers(self):
        return self.timers

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    @staticmethod
    def memory_usage():
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return "Mem stats unavailable"
        in_use = torch.cuda.memory_allocated() / (1024**3)
        peak = torch.cuda.max_memory_allocated() / (1024**3)
        return f"Mem in-use {round(in_use, 2)} GB \t peak {round(peak, 2)} GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        logger.info(string)


class NoopTimer:

    class Timer:

        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0

        def mean(self):
            return 0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def get_timers(self):
        return {}

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        ...


class ThroughputTimer:
    """Samples/sec over global steps, counted from ``start_step`` on.
    ``config.enabled`` turns it on; ``config.synchronized`` (default True)
    waits for ``device`` at start and stop."""

    def __init__(self, config, batch_size, start_step=2, steps_per_output=None, monitor_memory=False, logging_fn=None,
                 device=None):
        self.config = config
        self.device = device
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info

    def _sync(self):
        if getattr(self.config, "synchronized", True):
            device_synchronize(self.device)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        if not self.config.enabled:
            return
        self._sync()
        self.start_time = time.time()
        self.started = True

    def stop(self, global_step=False, report_speed=True):
        if not self.config.enabled or not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        self._sync()
        self.end_time = time.time()
        duration = self.end_time - self.start_time
        self.step_elapsed_time += duration
        # steps before start_step (warm-up) stay out of the running average
        if global_step and self.global_step_count >= self.start_step:
            self.total_elapsed_time += self.step_elapsed_time

        if global_step and report_speed and self.global_step_count >= self.start_step:
            if self.steps_per_output and self.global_step_count % self.steps_per_output == 0:
                msg = (f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                       f"global_step={self.global_step_count}, "
                       f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.3f}, "
                       f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.3f}")
                if self.monitor_memory:
                    msg += f", {SynchronizedWallClockTimer.memory_usage()}"
                self.logging(msg)
        if global_step:
            self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        counted = self.global_step_count - self.start_step + 1
        if counted > 0 and self.total_elapsed_time > 0:
            return self.batch_size * counted / self.total_elapsed_time
        return float("-inf")
