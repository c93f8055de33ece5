"""The H100's accelerator.

Port of ``deepspeed_tpu/accelerator/tpu_accelerator.py`` onto
``torch.cuda``: device name and count, synchronize, the CUDA RNG, streams
and events, the caching allocator's memory statistics, and ``nccl`` as the
collective backend (``comm.init_distributed`` runs gloo on CUDA tensors
only when the caller names it).
"""

import torch

from deepspeed_tpu_torch.accelerator._torch_accelerator import TorchAccelerator


class CUDA_Accelerator(TorchAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def is_synchronized_device(self):
        return False

    def device_name(self, device_index=None):
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def set_device(self, device_index):
        torch.cuda.set_device(device_index)

    def current_device(self):
        return torch.cuda.current_device()

    def current_device_name(self):
        return f"cuda:{torch.cuda.current_device()}"

    def device_count(self):
        return torch.cuda.device_count()

    def synchronize(self, device_index=None):
        torch.cuda.synchronize(device_index)

    # RNG
    def set_rng_state(self, new_state, device_index=None):
        torch.cuda.set_rng_state(new_state, device="cuda" if device_index is None else device_index)

    def get_rng_state(self, device_index=None):
        return torch.cuda.get_rng_state(device="cuda" if device_index is None else device_index)

    def manual_seed(self, seed):
        torch.cuda.manual_seed(seed)

    def manual_seed_all(self, seed):
        torch.cuda.manual_seed_all(seed)

    def initial_seed(self):
        return torch.cuda.initial_seed()

    def default_generator(self, device_index):
        return torch.cuda.default_generators[device_index]

    # streams and events
    def Stream(self, device=None, priority=0, **kwargs):
        return torch.cuda.Stream(device=device, priority=priority, **kwargs)

    def stream(self, stream):
        return torch.cuda.stream(stream)

    def current_stream(self, device_index=None):
        return torch.cuda.current_stream(device_index)

    def default_stream(self, device_index=None):
        return torch.cuda.default_stream(device_index)

    def Event(self, **kwargs):
        return torch.cuda.Event(**kwargs)

    # memory
    def empty_cache(self):
        torch.cuda.empty_cache()

    def memory_allocated(self, device_index=None):
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None):
        return torch.cuda.max_memory_allocated(device_index)

    def reset_max_memory_allocated(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def memory_cached(self, device_index=None):
        return torch.cuda.memory_reserved(device_index)

    def max_memory_cached(self, device_index=None):
        return torch.cuda.max_memory_reserved(device_index)

    def reset_max_memory_cached(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def memory_stats(self, device_index=None):
        return torch.cuda.memory_stats(device_index)

    def reset_peak_memory_stats(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def memory_reserved(self, device_index=None):
        return torch.cuda.memory_reserved(device_index)

    def max_memory_reserved(self, device_index=None):
        return torch.cuda.max_memory_reserved(device_index)

    def total_memory(self, device_index=None):
        return torch.cuda.get_device_properties(device_index or 0).total_memory

    def available_memory(self, device_index=None):
        free, _ = torch.cuda.mem_get_info(device_index)
        return free

    def is_available(self):
        return torch.cuda.is_available()

    def range_push(self, msg):
        torch.cuda.nvtx.range_push(msg)

    def range_pop(self):
        torch.cuda.nvtx.range_pop()

    def is_triton_supported(self):
        try:
            import triton  # noqa: F401
        except ImportError:
            return False
        return True

    def pin_memory(self, tensor, align_bytes=1):
        return tensor.pin_memory()

    def is_pinned(self, tensor):
        return tensor.is_pinned()

    def export_envs(self):
        return ["NCCL", "CUDA_VISIBLE_DEVICES"]
