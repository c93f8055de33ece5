"""Blocked (paged) KV cache.

Port of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py`` (BlockedKVCache):
one device tensor ``[num_layers, 2, num_blocks, kv_heads, block_size,
head_dim]``, so a (layer, k|v, block, head) tuple is one contiguous
``[block_size, head_dim]`` tile, the unit the CUDA paged-attention kernel
stages in shared memory.

The JAX cache is an immutable array that each forward donates and gets back
(``set_cache``). Here the one tensor is updated in place by the forward, and
``cache`` always names the same storage.

Offload moves a sequence's blocks to the tiered store (``ragged/tiering.py``:
host memory, spilling to disk under a budget) and frees them; restore writes
them back into fresh blocks. The device→host and host→device copies are
asynchronous on the current stream, into and out of pinned memory, so they
order with the forwards around them; ``fork_blocks`` (the prefix cache's
copy-on-write) copies on the same stream. Spill files are written through the
native AIO engine (``ops/aio``), built on first spill.
"""

import os
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import AllocationMode, KVCacheConfig, MemoryConfig
from deepspeed_tpu_torch.inference.v2.ragged.tiering import TieredKVStore
from deepspeed_tpu_torch.utils.logging import logger

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


class _LazyAIO:
    """Spill-file I/O for the tiered store that defers to the cache's AIO
    engine — built lazily so a cache that never spills never builds
    ``ops/aio`` or touches the spill directory."""

    def __init__(self, cache: "BlockedKVCache"):
        self._cache = cache

    def sync_pwrite(self, buf, path):
        self._cache._aio_handle().sync_pwrite(buf, path)

    def sync_pread(self, buf, path):
        self._cache._aio_handle().sync_pread(buf, path)


class BlockedKVCache:

    def __init__(self, config: KVCacheConfig, memory_config: MemoryConfig, device, offload: bool = False,
                 offload_path: Optional[str] = None):
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
        # offloaded payloads land in host memory and demote to spill files
        # under offload_path when the host tier runs past its budget
        self._offload_path = offload_path
        self._aio = None
        self._tiers = TieredKVStore(spill_dir=offload_path, io=_LazyAIO(self))
        # offload_path with no host budget: every offload spills to disk,
        # synchronously (configure_tiering replaces this with the budgeted
        # async ladder)
        self._sync_spill = offload_path is not None

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

    def incref(self, blocks) -> None:
        """Add one reference per block (prefix-cache sharing; see
        ``BlockedAllocator.incref``). ``free`` is the matching decref."""
        self._allocator.incref(blocks)

    def ref_count(self, block: int) -> int:
        return self._allocator.ref_count(block)

    def fork_blocks(self, src_blocks) -> np.ndarray:
        """Copy-on-write fork: allocate fresh blocks and copy ``src_blocks``'
        contents (every layer, K and V) into them on the cache's device (the
        current stream, ordered with the forwards around it), returning the
        new ids. The sources are untouched — the caller maps the copies into
        a sequence that is about to write where the sources are shared
        read-only. A failed allocation or copy consumes nothing."""
        src_blocks = np.atleast_1d(np.asarray(src_blocks)).astype(np.int64)
        new_blocks = self._allocator.allocate(src_blocks.size)
        try:
            self._cache[:, :, self._index(new_blocks)] = self._cache[:, :, self._index(src_blocks)]
        except Exception:
            self._allocator.free(new_blocks)
            raise
        return new_blocks

    def _index(self, blocks) -> torch.Tensor:
        blocks = np.atleast_1d(np.asarray(blocks)).astype(np.int64)
        return torch.from_numpy(blocks).to(self._cache.device)

    def gather_blocks(self, blocks, synchronize: bool = False) -> torch.Tensor:
        """Device→host copy of ``blocks``' contents (every layer, K and V)
        WITHOUT freeing them: a CPU tensor ``[layers, 2, n, kv_heads,
        block_size, head_dim]`` in the cache's dtype, pinned when the cache is
        on a CUDA device (the copy is then asynchronous on the current
        stream; synchronize before reading it on the host, or pass
        ``synchronize``)."""
        data = self._cache[:, :, self._index(blocks)]
        if self._cache.device.type == "cpu":
            return data
        host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        host.copy_(data, non_blocking=True)
        if synchronize:
            torch.cuda.current_stream(self._cache.device).synchronize()
        return host

    def scatter_blocks(self, data: torch.Tensor) -> np.ndarray:
        """Allocate fresh device blocks and write ``data`` (a
        :meth:`gather_blocks`-shaped payload) into them; returns the new block
        ids. A failed allocation or write consumes nothing."""
        num_layers, kv_heads, head_dim = self._config.cache_shape
        expect = (num_layers, 2, kv_heads, self._config.block_size, head_dim)
        got = tuple(data.shape[:2]) + tuple(data.shape[3:]) if data.dim() == 6 else None
        if got != expect:
            raise ValueError(
                f"scatter_blocks: payload shape {tuple(data.shape)} does not fit this "
                f"cache's geometry [layers=2x{num_layers}, n, kv_heads={kv_heads}, "
                f"block_size={self._config.block_size}, head_dim={head_dim}]")
        new_blocks = self._allocator.allocate(data.shape[2])
        try:
            self._cache[:, :, self._index(new_blocks)] = data.to(self._cache.device, self._cache.dtype,
                                                                non_blocking=True)
        except Exception:
            self._allocator.free(new_blocks)
            raise
        return new_blocks

    def offload(self, blocks) -> int:
        """Move ``blocks``' contents to the host tier and free the device
        blocks for reuse. Returns a handle for :meth:`restore`. Device block
        ids are not stable across an offload: restore hands back fresh ids,
        and the caller rewrites its block table
        (``DSStateManager.offload_sequence`` does)."""
        data = self.gather_blocks(blocks)
        handle = self._tiers.put(data)
        self._allocator.free(blocks)
        if self._sync_spill:
            self._tiers.demote(handle, wait=True)
        return handle

    def restore(self, handle: int) -> np.ndarray:
        """Allocate fresh device blocks, write the offloaded contents back,
        and return the new block ids. On failure the payload stays in the
        store, so the caller may evict and retry."""
        needed = self._tiers.n_blocks(handle)
        if needed > self._allocator.free_blocks:
            raise ValueError(f"Allocator has {self._allocator.free_blocks} free blocks, "
                             f"but {needed} were requested")
        data, _tier = self._tiers.read(handle)
        new_blocks = self.scatter_blocks(data)
        self._tiers.drop(handle)
        return new_blocks

    def drop_offloaded(self, handle: int) -> None:
        """Discard an offloaded payload without restoring (sequence flushed)."""
        self._tiers.drop(handle)

    def configure_tiering(self, spill_dir: Optional[str] = None, host_bytes: Optional[int] = None) -> None:
        """Enable the budgeted host→disk ladder (the serving ``kv_tiers``
        config arrives after the engine and this cache are built). Replaces
        the spill-everything-synchronously mode of ``offload_path``: offloads
        land in host memory and demote asynchronously past ``host_bytes``."""
        if spill_dir is not None:
            self._offload_path = spill_dir
        self._sync_spill = False
        self._tiers.configure(spill_dir=spill_dir, host_bytes=host_bytes)

    def offload_tier(self, handle: int) -> str:
        """Which tier currently holds an offloaded payload (host | disk)."""
        return self._tiers.tier_of(handle)

    def demote_offloaded(self, handle: int, wait: bool = False) -> bool:
        """Push one offloaded payload host→disk (brownout's demote stage)."""
        return self._tiers.demote(handle, wait=wait)

    def tier_stats(self) -> dict:
        return self._tiers.stats()

    @property
    def tiered_store(self) -> TieredKVStore:
        return self._tiers

    def _aio_handle(self):
        if self._aio is None:
            from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
            os.makedirs(self._offload_path, exist_ok=True)
            self._aio = AsyncIOHandle(thread_count=2)
        return self._aio
