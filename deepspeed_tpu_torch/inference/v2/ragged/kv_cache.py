"""Blocked (paged) KV cache.

Port of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py`` (BlockedKVCache):
one device tensor ``[num_layers, 2, num_blocks, kv_heads, block_size,
head_dim]``, so a (layer, k|v, block, head) tuple is one contiguous
``[block_size, head_dim]`` tile, the unit the CUDA paged-attention kernel
stages in shared memory.

The JAX cache is an immutable array that each forward donates and gets back
(``set_cache``). Here the one tensor is updated in place by the forward, and
``cache`` always names the same storage. Offload, tiering and
``fork_blocks`` are ROADMAP A5.
"""

import torch

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import AllocationMode, KVCacheConfig, MemoryConfig
from deepspeed_tpu_torch.utils.logging import logger

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


class BlockedKVCache:

    def __init__(self, config: KVCacheConfig, memory_config: MemoryConfig, device):
        self._config = config
        num_layers, kv_heads, head_dim = config.cache_shape
        dtype = _DTYPES[config.cache_dtype]
        block_bytes = (config.block_size * 2 * num_layers * kv_heads * head_dim *
                       dtype.itemsize)
        # RESERVE sizes the pool in bytes, ALLOCATE in blocks. (The JAX
        # package's pydantic config stores the mode as its string value, so
        # its RESERVE test never matches and it reads the byte size as a
        # block count; see ROADMAP.md section C.)
        if memory_config.mode == AllocationMode.RESERVE:
            num_blocks = max(1, int(memory_config.size // block_bytes))
        else:
            num_blocks = int(memory_config.size)
        self._num_blocks = num_blocks
        self._allocator = BlockedAllocator(num_blocks)
        self._cache = torch.zeros((num_layers, 2, num_blocks, kv_heads, config.block_size, head_dim),
                                  dtype=dtype, device=device)
        logger.info(f"BlockedKVCache: {num_blocks} blocks x {config.block_size} tokens "
                    f"({num_blocks * block_bytes / 1e9:.2f} GB) on {device}")

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    @property
    def block_size(self) -> int:
        return self._config.block_size

    @property
    def cache(self) -> torch.Tensor:
        return self._cache

    def reserve(self, num_blocks: int):
        return self._allocator.allocate(num_blocks)

    def free(self, blocks):
        self._allocator.free(blocks)
