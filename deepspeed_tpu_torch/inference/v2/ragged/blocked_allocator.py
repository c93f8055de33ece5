"""KV block allocator.

Port of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``: a
reference-counted free list kept as a linked list in a numpy array. Pure host
logic; the order in which blocks are handed out is the reference's, so block
tables match it id for id.
"""

import numpy as np


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"Blocked allocator requires at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # free-list as a linked list in an array: _next[i] = next free after i
        self._next = np.arange(1, num_blocks + 1, dtype=np.int64)
        self._head = 0
        self._free_blocks = num_blocks
        self._refs = np.zeros(num_blocks, dtype=np.int64)

    @property
    def free_blocks(self) -> int:
        return self._free_blocks

    def allocate(self, num_blocks: int) -> np.ndarray:
        if num_blocks > self._free_blocks:
            raise ValueError(f"Allocator has {self._free_blocks} free blocks, but {num_blocks} were requested")
        out = np.empty(num_blocks, dtype=np.int64)
        for i in range(num_blocks):
            out[i] = self._head
            self._refs[self._head] = 1
            self._head = int(self._next[self._head])
        self._free_blocks -= num_blocks
        return out

    def free(self, blocks) -> None:
        """Drop one reference per listed block; a block whose count reaches
        zero returns to the free list. Freeing an already-free block raises."""
        blocks = np.atleast_1d(np.asarray(blocks, dtype=np.int64))
        for b in blocks:
            b = int(b)
            self._check_range(b)
            if self._refs[b] <= 0:
                raise ValueError(f"Block {b} freed more times than it was referenced "
                                 f"(double free)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._next[b] = self._head
                self._head = b
                self._free_blocks += 1

    def incref(self, blocks) -> None:
        """Add one reference per listed block; only live blocks can gain sharers."""
        blocks = np.atleast_1d(np.asarray(blocks, dtype=np.int64))
        for b in blocks:
            b = int(b)
            self._check_range(b)
            if self._refs[b] <= 0:
                raise ValueError(f"Block {b} is not allocated; cannot incref")
        for b in blocks:
            self._refs[int(b)] += 1

    def ref_count(self, block: int) -> int:
        block = int(block)
        self._check_range(block)
        return int(self._refs[block])

    def _check_range(self, b: int) -> None:
        if b < 0 or b >= self._num_blocks:
            raise ValueError(f"Block {b} is out of range [0, {self._num_blocks})")
