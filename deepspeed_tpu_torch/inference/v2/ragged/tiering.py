"""Tiered KV block storage: host memory → disk spill, with async writeback.

Port of ``deepspeed_tpu/inference/v2/ragged/tiering.py`` (``TieredKVStore``).
The device KV pool (``kv_cache.BlockedKVCache``) is the scarcest resource in
every overload path; this module is the capacity ladder underneath it. The
store holds gathered KV payloads (the ``gather_blocks``-shaped ``[layers, 2,
n, kv_heads, block_size, head_dim]`` tensors) off-device across two tiers:

- **host**: torch CPU tensors in the cache's dtype, pinned when the cache
  lies on a CUDA device (bf16 stays bf16, so every round trip is bit-exact);
- **disk**: spill files under ``spill_dir`` holding each payload's raw bytes.
  Entries demote host→disk asynchronously on a background writer thread when
  the host tier runs past ``host_bytes``; a read that races a pending
  writeback wins it instead of reading a half-written file.

Tier placement is per entry (one offloaded sequence or one trie node), LRU:
``put`` lands in the host tier, the writer demotes the coldest entries when
over budget, ``read`` serves whichever tier holds the bytes and reports it.

A pinned payload arrives from an asynchronous device→host copy on the
caller's current stream. ``put`` records a CUDA event there, and the writer
waits on it before it reads the bytes, so no spill file is written from a
buffer the copy has not filled. The writer drops its reference only after
the write has ended.

Thread model: all entry state lives under one lock + condition variable. The
writer thread owns the host→disk copy; the commit re-checks entry state under
the lock, so a reader that claimed the entry mid-write wins the race and the
spill file is discarded (counted in ``demote_races``).
"""

import os
import threading
import uuid
from collections import deque
from typing import Dict, Optional

import torch

TIERS = ("device", "host", "disk")
"""The tier ladder, hottest first. ``device`` never appears inside the store
(device blocks belong to the allocator); it is the tag the callers —
``DSSequenceDescriptor`` and the prefix-cache trie — use for not-offloaded
state, kept here so every layer spells the tiers identically."""


class _PlainIO:
    """Default spill-file I/O (buffered writes, single read). The KV cache
    wires its native AIO engine in instead when one is configured — the
    store only needs the ``sync_pwrite``/``sync_pread`` shape over numpy
    buffers."""

    @staticmethod
    def sync_pwrite(buf, path):
        with open(path, "wb") as f:
            f.write(buf)

    @staticmethod
    def sync_pread(buf, path):
        with open(path, "rb") as f:
            f.readinto(buf)


class _Entry:
    __slots__ = ("state", "data", "path", "shape", "dtype", "nbytes", "n_blocks", "last_touch", "pinned",
                 "pinned_memory", "ready")

    def __init__(self, data: torch.Tensor):
        self.state = "host"  # host | writing | disk
        self.data = data
        self.path: Optional[str] = None
        self.shape = tuple(data.shape)
        self.dtype = data.dtype
        self.nbytes = data.numel() * data.element_size()
        self.n_blocks = int(data.shape[2]) if data.dim() == 6 else 0
        self.last_touch = 0
        self.pinned = False  # exempt from disk demotion
        self.pinned_memory = data.is_pinned()
        # the device→host copy that fills a pinned payload runs on the
        # caller's stream: the writer waits on this before reading the bytes
        self.ready = None
        if self.pinned_memory:
            self.ready = torch.cuda.Event()
            self.ready.record()


class TieredKVStore:
    """Host→disk tiered storage for gathered KV payloads.

    ``host_bytes`` is the host-tier budget: when resident host bytes exceed
    it *and* a ``spill_dir`` exists, the coldest unpinned entries demote to
    disk on the writer thread. No ``spill_dir`` = the host tier is the floor
    (nothing ever demotes; the budget is advisory). ``io`` is an object with
    ``sync_pwrite(buf, path)`` / ``sync_pread(buf, path)``; None = plain
    file I/O.
    """

    def __init__(self, spill_dir: Optional[str] = None, host_bytes: Optional[int] = None, io=None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: Dict[int, _Entry] = {}
        self._next_handle = 0
        self._clock = 0
        self._host_bytes = 0
        self._spill_dir = spill_dir
        self._budget = host_bytes
        self._io = io or _PlainIO()
        self._tag = f"{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._queue: deque = deque()  # handles scheduled for demotion
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        # chaos: called (handle) in the demote window between the spill write
        # and the commit, widening the race the commit path must survive
        self.race_hook = None
        # stats (scalar counters; read lock-free from stats threads)
        self.demotions = 0  # host→disk commits
        self.demote_races = 0  # demotions lost to a concurrent read/drop
        self.writeback_joins = 0  # reads that claimed a pending writeback
        self.reads_host = 0
        self.reads_disk = 0

    # ------------------------------------------------------------ configure --
    def configure(self, spill_dir: Optional[str] = None, host_bytes: Optional[int] = None) -> None:
        """Re-point the spill policy (the serving layer's tier config arrives
        after the cache is built). Existing entries keep their tier; the new
        budget applies from the next ``put``."""
        with self._lock:
            if spill_dir is not None:
                self._spill_dir = spill_dir
            self._budget = host_bytes
            self._maybe_demote_locked()

    # ----------------------------------------------------------------- put --
    def put(self, data: torch.Tensor, pin_host: bool = False) -> int:
        """Store one gathered payload in the host tier; returns a handle.
        ``pin_host`` exempts the entry from disk demotion."""
        with self._lock:
            if self._closed:
                raise RuntimeError("TieredKVStore is closed")
            handle = self._next_handle
            self._next_handle += 1
            entry = _Entry(data)
            entry.pinned = pin_host
            self._clock += 1
            entry.last_touch = self._clock
            self._entries[handle] = entry
            self._host_bytes += entry.nbytes
            self._maybe_demote_locked()
        return handle

    # ---------------------------------------------------------------- read --
    def read(self, handle: int):
        """``(payload, tier)`` for ``handle`` — non-destructive (the payload
        survives a failed promotion; see ``BlockedKVCache.restore``'s
        evict-and-retry contract). A read racing a pending writeback wins
        it: the host bytes are still resident, so the entry is reclaimed to
        the host tier and the writer's commit discards the orphaned spill
        file."""
        with self._lock:
            entry = self._entries[handle]
            self._clock += 1
            entry.last_touch = self._clock
            if entry.state == "writing":
                entry.state = "host"  # reclaim; the writer counts the race
                self.writeback_joins += 1
            if entry.state == "host":
                self.reads_host += 1
                return entry.data, "host"
            path, shape, dtype, pinned = entry.path, entry.shape, entry.dtype, entry.pinned_memory
            nbytes = entry.nbytes
        # disk read outside the lock: a multi-MB pread must not stall every
        # other tier operation. A pinned buffer keeps the promotion's
        # host→device copy asynchronous.
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
        self._io.sync_pread(buf.numpy(), path)
        self.reads_disk += 1
        return buf.view(dtype).reshape(shape), "disk"

    # ---------------------------------------------------------------- drop --
    def drop(self, handle: int) -> None:
        """Discard an entry (promotion succeeded, or the sequence flushed).
        Safe against a pending writeback: the writer's commit re-checks and
        cleans up the orphaned spill file."""
        with self._lock:
            entry = self._entries.pop(handle, None)
            if entry is None:
                return
            if entry.state in ("host", "writing"):
                self._host_bytes -= entry.nbytes
            path = entry.path if entry.state == "disk" else None
            self._cv.notify_all()
        if path is not None:
            self._safe_unlink(path)

    # --------------------------------------------------------------- query --
    def __contains__(self, handle: int) -> bool:
        with self._lock:
            return handle in self._entries

    def tier_of(self, handle: int) -> str:
        """``host`` or ``disk`` (an entry mid-writeback is still host: its
        bytes are host-resident until the commit)."""
        with self._lock:
            entry = self._entries[handle]
            return "disk" if entry.state == "disk" else "host"

    def n_blocks(self, handle: int) -> int:
        with self._lock:
            return self._entries[handle].n_blocks

    def pin(self, handle: int, pinned: bool = True) -> None:
        with self._lock:
            entry = self._entries.get(handle)
            if entry is not None:
                entry.pinned = pinned

    # -------------------------------------------------------------- demote --
    def demote(self, handle: int, wait: bool = False) -> bool:
        """Explicitly schedule one entry host→disk (the brownout
        demote-before-shed path); returns whether a demotion was scheduled.
        ``wait`` blocks until the writeback commits."""
        with self._lock:
            entry = self._entries.get(handle)
            if entry is None or entry.state != "host" or entry.pinned or self._spill_dir is None:
                return False
            entry.state = "writing"
            self._queue.append(handle)
            self._ensure_writer_locked()
            self._cv.notify_all()
            if wait:
                while handle in self._entries and self._entries[handle].state == "writing":
                    self._cv.wait()
        return True

    def _maybe_demote_locked(self) -> None:
        if self._budget is None or self._spill_dir is None:
            return
        resident = [(h, e) for h, e in self._entries.items() if e.state == "host" and not e.pinned]
        resident.sort(key=lambda he: he[1].last_touch)
        over = self._host_bytes - self._budget
        for handle, entry in resident:
            if over <= 0:
                break
            entry.state = "writing"
            self._queue.append(handle)
            over -= entry.nbytes
        if self._queue:
            self._ensure_writer_locked()
            self._cv.notify_all()

    def _ensure_writer_locked(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop, name="kv-tier-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                handle = self._queue.popleft()
                entry = self._entries.get(handle)
                if entry is None or entry.state != "writing":
                    continue  # dropped or already settled
                data, ready = entry.data, entry.ready
                path = os.path.join(self._spill_dir, f"kv_offload_{self._tag}_{handle}.bin")
            if ready is not None:
                ready.synchronize()  # the device→host copy has landed
            os.makedirs(self._spill_dir, exist_ok=True)
            self._io.sync_pwrite(data.reshape(-1).view(torch.uint8).numpy(), path)  # raw bytes, no copy
            del data  # the buffer is released only after the write ended
            hook = self.race_hook
            if hook is not None:
                hook(handle)
            with self._lock:
                entry = self._entries.get(handle)
                if entry is None or entry.state != "writing":
                    # a read/drop raced the writeback and won — the host (or
                    # gone) copy is authoritative; discard the spill file
                    self.demote_races += 1
                    self._cv.notify_all()
                    self._safe_unlink(path)
                    continue
                entry.state = "disk"
                entry.path = path
                entry.data = None
                entry.ready = None
                self._host_bytes -= entry.nbytes
                self.demotions += 1
                self._cv.notify_all()

    @staticmethod
    def _safe_unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        with self._lock:
            host = [e for e in self._entries.values() if e.state != "disk"]
            disk = [e for e in self._entries.values() if e.state == "disk"]
            return {
                "host_entries": len(host),
                "disk_entries": len(disk),
                "host_blocks": sum(e.n_blocks for e in host),
                "disk_blocks": sum(e.n_blocks for e in disk),
                "host_bytes": self._host_bytes,
                "disk_bytes": sum(e.nbytes for e in disk),
                "host_bytes_budget": self._budget,
                "writeback_pending": len(self._queue),
                "demotions": self.demotions,
                "demote_races": self.demote_races,
                "writeback_joins": self.writeback_joins,
                "reads_host": self.reads_host,
                "reads_disk": self.reads_disk,
            }

    # --------------------------------------------------------------- close --
    def close(self) -> None:
        """Drain the writer and unlink every spill file."""
        with self._lock:
            self._closed = True
            self._queue.clear()
            # settle in-flight writebacks as host again so the paths below
            # are the complete spill-file set
            for entry in self._entries.values():
                if entry.state == "writing":
                    entry.state = "host"
            paths = [e.path for e in self._entries.values() if e.state == "disk" and e.path]
            self._entries.clear()
            self._host_bytes = 0
            self._cv.notify_all()
        writer = self._writer
        if writer is not None and writer.is_alive():
            writer.join(timeout=5.0)
        for path in paths:
            self._safe_unlink(path)
