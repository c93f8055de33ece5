"""NVMe optimizer-state swapping.

Port of ``deepspeed_tpu/runtime/swap_tensor/partitioned_optimizer_swapper.py``
(``PartitionedOptimizerSwapper``, ``NvmeSwappedLeaf``). Each rank holds its
own part of the optimizer state (its ZeRO chunks), so each rank writes one
file a state tensor, ``state_<i>_rank<r>.bin`` under the swap directory.
Between steps the engine holds only :class:`NvmeSwappedLeaf` stubs (path,
shape, dtype, bytes): no card memory and no host memory. ``swap_in``
streams the files into host tensors (pinned where the engine runs on a
card) with at most ``buffer_count`` reads in flight, the reference's swap
buffer pool; ``swap_out`` streams host tensors to the files the same way,
its last writes completing at the next swap. Every transfer's byte count is
checked, and the native engine fsyncs each write.

The I/O runs on the native async-IO engine (``ops/aio``, which builds
``csrc/aio/dstpu_aio.cpp``). A swapper refuses to start without it: a
failure to build or load the engine raises here, and never turns into a
slower path in its place.
"""

import os
from dataclasses import dataclass
from typing import Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger


@dataclass(frozen=True)
class NvmeSwappedLeaf:
    """Stub standing in for a swapped-out optimizer-state tensor."""
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    nbytes: int


def _byte_view(t: torch.Tensor):
    """A numpy uint8 view of a contiguous host tensor's bytes (any dtype,
    0-d included), for the aio engine."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _is_stub(x) -> bool:
    return isinstance(x, NvmeSwappedLeaf)


class PartitionedOptimizerSwapper:
    """Streams an optimizer state between host tensors and files (see the
    module doc). ``stats`` counts the bytes and the aio requests."""

    def __init__(self, nvme_path: str, aio_config=None, buffer_count: int = 4, rank: int = 0,
                 pin_memory: bool = False):
        from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aio_available

        if not aio_available():
            raise RuntimeError("NVMe offload needs the native async-IO engine (csrc/aio/dstpu_aio.cpp via "
                               "ops/aio), which did not build or load; see the warning above")
        os.makedirs(nvme_path, exist_ok=True)
        self.swap_dir = nvme_path
        self.rank = int(rank)
        self.pin_memory = pin_memory
        self.buffer_count = max(1, int(buffer_count))
        self.aio = AsyncIOHandle(block_size=getattr(aio_config, "block_size", 1 << 20),
                                 queue_depth=getattr(aio_config, "queue_depth", 8),
                                 thread_count=getattr(aio_config, "thread_count", 1))
        self._pending_writes = []  # (request id, host tensor, bytes) of the last swap_out
        self.stats = {"bytes_out": 0, "bytes_in": 0, "writes": 0, "reads": 0}

    def _leaf_path(self, index: int) -> str:
        return os.path.join(self.swap_dir, f"state_{index}_rank{self.rank}.bin")

    # ---------------------------------------------------------------- swap out --
    def swap_out(self, opt_state):
        """Host (or card) tensors -> disk; returns the stub tree. Leaves that
        are already stubs pass through."""
        from deepspeed_tpu_torch.runtime.zero.offload import map_state

        self._drain_writes()  # earlier writes to the same paths land first
        index = iter(range(1 << 62))

        def out(leaf):
            i = next(index)
            if _is_stub(leaf):
                return leaf
            host = leaf.detach().contiguous()
            if host.device.type != "cpu":
                host = host.cpu()
            path = self._leaf_path(i)
            buf = _byte_view(host)
            rid = self.aio.async_pwrite(buf, path, offset=0)
            self._pending_writes.append((rid, host, buf.nbytes))
            self.stats["writes"] += 1
            self.stats["bytes_out"] += buf.nbytes
            if len(self._pending_writes) >= self.buffer_count:
                self._drain_writes()
            return NvmeSwappedLeaf(path=path, shape=tuple(leaf.shape), dtype=leaf.dtype, nbytes=buf.nbytes)

        return map_state(opt_state, out)

    def _drain_writes(self):
        pending, self._pending_writes = self._pending_writes, []
        for rid, _, nbytes in pending:
            got = self.aio.wait(rid)
            if got != nbytes:
                raise IOError(f"short write: {got} of {nbytes} bytes reached {self.swap_dir}")

    # ----------------------------------------------------------------- swap in --
    def _read(self, opt_state, pin):
        from deepspeed_tpu_torch.runtime.zero.offload import map_state

        self._drain_writes()  # read after write
        inflight = []

        def complete_one():
            rid, stub, _ = inflight.pop(0)
            got = self.aio.wait(rid)
            if got != stub.nbytes:
                raise IOError(f"short read from {stub.path}: {got} of {stub.nbytes} bytes (stale or foreign "
                              f"swap file?)")

        def read(leaf):
            if not _is_stub(leaf):
                return leaf
            t = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=pin)
            rid = self.aio.async_pread(_byte_view(t), leaf.path, offset=0)
            inflight.append((rid, leaf, t))
            self.stats["reads"] += 1
            self.stats["bytes_in"] += leaf.nbytes
            if len(inflight) >= self.buffer_count:
                complete_one()
            return t

        out = map_state(opt_state, read)
        while inflight:
            complete_one()
        return out

    def swap_in(self, stub_tree):
        """Disk -> host tensors (pinned where the engine runs on a card)."""
        return self._read(stub_tree, self.pin_memory)

    def materialize_host(self, stub_tree):
        """Disk -> plain host tensors: what a checkpoint save writes."""
        return self._read(stub_tree, False)

    def close(self):
        if self.aio is None:
            return
        self._drain_writes()
        self.aio.close()
        self.aio = None
        logger.info(f"NVMe swapper closed ({self.stats})")
