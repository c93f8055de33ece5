"""The host's accelerator: where the tests run, and what a gloo gang of
processes on one machine drives. Port of
``deepspeed_tpu/accelerator/cpu_accelerator.py``; the collective backend is
``gloo``."""

import contextlib

import torch

from deepspeed_tpu_torch.accelerator._torch_accelerator import TorchAccelerator


class _HostStream:
    """The host runs each op when it is called: a stream has nothing to wait on."""

    def synchronize(self):
        pass

    def wait_stream(self, other):
        pass


class _HostEvent:

    def __init__(self, enable_timing=False, **kwargs):
        self._t = None

    def record(self, stream=None):
        import time
        self._t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end_event):
        return 1e3 * (end_event._t - self._t)


def _meminfo(key):
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class CPU_Accelerator(TorchAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def is_synchronized_device(self):
        return True

    def device_name(self, device_index=None):
        return "cpu"

    def set_device(self, device_index):
        pass

    def current_device(self):
        return 0

    def current_device_name(self):
        return "cpu"

    def device_count(self):
        return 1

    def synchronize(self, device_index=None):
        pass

    # RNG
    def set_rng_state(self, new_state, device_index=None):
        torch.set_rng_state(new_state)

    def get_rng_state(self, device_index=None):
        return torch.get_rng_state()

    def manual_seed_all(self, seed):
        torch.manual_seed(seed)

    def default_generator(self, device_index):
        return torch.default_generator

    # streams and events
    def Stream(self, device=None, priority=0, **kwargs):
        return _HostStream()

    def stream(self, stream):
        return contextlib.nullcontext()

    def current_stream(self, device_index=None):
        return _HostStream()

    def default_stream(self, device_index=None):
        return _HostStream()

    def Event(self, **kwargs):
        return _HostEvent(**kwargs)

    # memory: the host's, from /proc/meminfo (torch keeps no allocator
    # statistics for the CPU)
    def empty_cache(self):
        pass

    def memory_allocated(self, device_index=None):
        return 0

    def max_memory_allocated(self, device_index=None):
        return 0

    def reset_max_memory_allocated(self, device_index=None):
        pass

    def memory_cached(self, device_index=None):
        return 0

    def max_memory_cached(self, device_index=None):
        return 0

    def reset_max_memory_cached(self, device_index=None):
        pass

    def memory_stats(self, device_index=None):
        return {}

    def reset_peak_memory_stats(self, device_index=None):
        pass

    def memory_reserved(self, device_index=None):
        return 0

    def max_memory_reserved(self, device_index=None):
        return 0

    def total_memory(self, device_index=None):
        return _meminfo("MemTotal")

    def available_memory(self, device_index=None):
        return _meminfo("MemAvailable")

    def is_available(self):
        return True

    def range_push(self, msg):
        pass

    def range_pop(self):
        pass

    def is_triton_supported(self):
        return False

    def pin_memory(self, tensor, align_bytes=1):
        return tensor

    def is_pinned(self, tensor):
        return False

    def export_envs(self):
        return ["OMP_NUM_THREADS"]
