"""Host tier of the KV ladder.

Port of the host tier of ``deepspeed_tpu/inference/v2/ragged/tiering.py``
(``TieredKVStore``): gathered KV payloads (the ``gather_blocks``-shaped
``[layers, 2, n, kv_heads, block_size, head_dim]`` tensors) held off-device
between an offload and its restore. The payloads are torch CPU tensors,
pinned when the cache lies on a CUDA device so the copies run asynchronously
on the cache's stream; bf16 stays bf16 (numpy has no bfloat16), so a round
trip is bit-exact.

The disk tier (spill files, the async writer, demotion under a host budget)
is ROADMAP A5; ``BlockedKVCache.configure_tiering`` refuses it.
"""

import threading
from typing import Dict

import torch

TIERS = ("device", "host", "disk")
"""The tier ladder, hottest first. ``device`` never appears inside the store
(device blocks belong to the allocator); it is the tag the callers use for
not-offloaded state, kept here so every layer spells the tiers identically."""


class _Entry:
    __slots__ = ("data", "nbytes", "n_blocks")

    def __init__(self, data: torch.Tensor):
        self.data = data
        self.nbytes = data.numel() * data.element_size()
        self.n_blocks = int(data.shape[2]) if data.dim() == 6 else 0


class TieredKVStore:
    """Host-memory store for gathered KV payloads; ``put`` returns a handle
    that ``read``/``drop`` take."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._next_handle = 0
        self._host_bytes = 0
        self.reads_host = 0

    def put(self, data: torch.Tensor) -> int:
        """Store one gathered payload in the host tier; returns a handle."""
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            entry = _Entry(data)
            self._entries[handle] = entry
            self._host_bytes += entry.nbytes
        return handle

    def read(self, handle: int):
        """``(payload, tier)`` for ``handle`` — non-destructive: the payload
        survives a failed promotion (``BlockedKVCache.restore``'s
        evict-and-retry contract)."""
        with self._lock:
            self.reads_host += 1
            return self._entries[handle].data, "host"

    def drop(self, handle: int) -> None:
        """Discard an entry (promotion succeeded, or the sequence flushed)."""
        with self._lock:
            entry = self._entries.pop(handle, None)
            if entry is not None:
                self._host_bytes -= entry.nbytes

    def tier_of(self, handle: int) -> str:
        with self._lock:
            self._entries[handle]  # KeyError for an unknown handle, as the reference
            return "host"

    def n_blocks(self, handle: int) -> int:
        with self._lock:
            return self._entries[handle].n_blocks

    def stats(self) -> dict:
        """The reference's stats document; the disk-tier fields stay zero."""
        with self._lock:
            host = list(self._entries.values())
            return {
                "host_entries": len(host),
                "disk_entries": 0,
                "host_blocks": sum(e.n_blocks for e in host),
                "disk_blocks": 0,
                "host_bytes": self._host_bytes,
                "disk_bytes": 0,
                "host_bytes_budget": None,
                "writeback_pending": 0,
                "demotions": 0,
                "demote_races": 0,
                "writeback_joins": 0,
                "reads_host": self.reads_host,
                "reads_disk": 0,
            }
