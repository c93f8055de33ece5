"""Accelerator abstraction.

Port of ``deepspeed_tpu/accelerator/abstract_accelerator.py``: the
``DeepSpeedAccelerator`` surface (device identity and count, synchronize,
RNG, streams and events, memory statistics, dtype support, the collective
backend's name, tensor factories), kept method for method so code written
against the reference maps one to one. The port's implementations are
:class:`~deepspeed_tpu_torch.accelerator.cuda_accelerator.CUDA_Accelerator`
(the H100) and :class:`~deepspeed_tpu_torch.accelerator.cpu_accelerator.CPU_Accelerator`
(the host, where the tests run). ``communication_backend_name()`` is what
``comm.init_distributed`` uses when the caller names no backend: ``nccl`` on
the card, ``gloo`` on the host.
"""

import abc
from abc import ABC


class DeepSpeedAccelerator(ABC):

    def __init__(self):
        self._name = None
        self._communication_backend_name = None

    # ---- device APIs -------------------------------------------------------------
    @abc.abstractmethod
    def is_synchronized_device(self):
        ...

    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device(self, device_index=None):
        ...

    @abc.abstractmethod
    def set_device(self, device_index):
        ...

    @abc.abstractmethod
    def current_device(self):
        ...

    @abc.abstractmethod
    def current_device_name(self):
        ...

    @abc.abstractmethod
    def device_count(self):
        ...

    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    # ---- RNG -----------------------------------------------------------------------
    @abc.abstractmethod
    def random(self):
        ...

    @abc.abstractmethod
    def set_rng_state(self, new_state, device_index=None):
        ...

    @abc.abstractmethod
    def get_rng_state(self, device_index=None):
        ...

    @abc.abstractmethod
    def manual_seed(self, seed):
        ...

    @abc.abstractmethod
    def manual_seed_all(self, seed):
        ...

    @abc.abstractmethod
    def initial_seed(self):
        ...

    @abc.abstractmethod
    def default_generator(self, device_index):
        ...

    # ---- streams and events ----------------------------------------------------------
    @abc.abstractmethod
    def Stream(self, device=None, priority=0, **kwargs):
        ...

    @abc.abstractmethod
    def stream(self, stream):
        ...

    @abc.abstractmethod
    def current_stream(self, device_index=None):
        ...

    @abc.abstractmethod
    def default_stream(self, device_index=None):
        ...

    @abc.abstractmethod
    def Event(self, **kwargs):
        ...

    # ---- memory ----------------------------------------------------------------------
    @abc.abstractmethod
    def empty_cache(self):
        ...

    @abc.abstractmethod
    def memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def reset_max_memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def memory_cached(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_cached(self, device_index=None):
        ...

    @abc.abstractmethod
    def reset_max_memory_cached(self, device_index=None):
        ...

    @abc.abstractmethod
    def memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def memory_reserved(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_reserved(self, device_index=None):
        ...

    @abc.abstractmethod
    def total_memory(self, device_index=None):
        ...

    @abc.abstractmethod
    def available_memory(self, device_index=None):
        ...

    # ---- data types -------------------------------------------------------------------
    @abc.abstractmethod
    def is_bf16_supported(self):
        ...

    @abc.abstractmethod
    def is_fp16_supported(self):
        ...

    @abc.abstractmethod
    def supported_dtypes(self):
        ...

    # ---- misc --------------------------------------------------------------------------
    @abc.abstractmethod
    def is_available(self):
        ...

    @abc.abstractmethod
    def range_push(self, msg):
        ...

    @abc.abstractmethod
    def range_pop(self):
        ...

    @abc.abstractmethod
    def lazy_call(self, callback):
        ...

    @abc.abstractmethod
    def communication_backend_name(self):
        ...

    @abc.abstractmethod
    def is_triton_supported(self):
        ...

    # ---- tensor operations -------------------------------------------------------------
    @abc.abstractmethod
    def pin_memory(self, tensor, align_bytes=1):
        ...

    @abc.abstractmethod
    def is_pinned(self, tensor):
        ...

    @abc.abstractmethod
    def on_accelerator(self, tensor):
        ...

    @abc.abstractmethod
    def export_envs(self):
        ...
