"""Sequence tracking.

Port of ``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``
(per-sequence KV block table, seen and in-flight token counts, and the tier
of the KV ladder that holds the cache: ``device``, ``host`` or ``disk``),
and ``rollback``, which truncates the committed count after a speculative
verify rejected drafts.
"""

from typing import List

import numpy as np


class DSSequenceDescriptor:

    def __init__(self, tracking_id: int, max_blocks_per_seq: int = 256):
        self.tracking_id = tracking_id
        self._seen_tokens = 0
        self._in_flight_tokens = 0
        self._max_blocks = max_blocks_per_seq
        self._kv_blocks: List[int] = []
        # which tier of the KV ladder holds this sequence's cache: "device"
        # while the block table is live; the state manager flips it to the
        # store's tier across an offload (ragged_manager.offload_sequence /
        # restore_sequence)
        self.kv_tier: str = "device"

    @property
    def seen_tokens(self) -> int:
        return self._seen_tokens

    @property
    def in_flight_tokens(self) -> int:
        return self._in_flight_tokens

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self._kv_blocks)

    @property
    def max_blocks(self) -> int:
        return self._max_blocks

    @property
    def kv_blocks(self) -> np.ndarray:
        return np.asarray(self._kv_blocks, dtype=np.int64)

    def extend_kv_cache(self, new_blocks) -> None:
        new_blocks = np.atleast_1d(np.asarray(new_blocks)).tolist()
        if len(self._kv_blocks) + len(new_blocks) > self._max_blocks:
            raise ValueError(f"Sequence {self.tracking_id} exceeds max blocks {self._max_blocks}")
        self._kv_blocks.extend(int(b) for b in new_blocks)

    def replace_kv_blocks(self, new_blocks) -> None:
        """Swap the whole block table for fresh ids (KV offload→restore hands
        back different device blocks; token order is preserved)."""
        new_blocks = np.atleast_1d(np.asarray(new_blocks)).tolist()
        if len(new_blocks) != len(self._kv_blocks):
            raise ValueError(f"restore returned {len(new_blocks)} blocks for a "
                             f"{len(self._kv_blocks)}-block sequence")
        self._kv_blocks = [int(b) for b in new_blocks]

    def pre_forward(self, num_tokens: int) -> None:
        """Mark tokens as in-flight before the forward."""
        self._in_flight_tokens = num_tokens

    def post_forward(self) -> None:
        """Commit in-flight tokens to seen after the forward."""
        self._seen_tokens += self._in_flight_tokens
        self._in_flight_tokens = 0

    def rollback(self, n_tokens: int) -> None:
        """Forget the last ``n_tokens`` committed tokens (write-then-truncate):
        their KV stays in place and is overwritten when the correct tokens are
        fed at those positions — the speculative-verify rejection path. The
        blocks stay allocated; only the committed count moves."""
        n_tokens = int(n_tokens)
        if self._in_flight_tokens:
            raise RuntimeError(f"sequence {self.tracking_id}: rollback with "
                               f"{self._in_flight_tokens} in-flight tokens")
        if n_tokens < 0 or n_tokens > self._seen_tokens:
            raise ValueError(f"rollback({n_tokens}) with {self._seen_tokens} "
                             f"committed tokens")
        self._seen_tokens -= n_tokens


class PlaceholderSequenceDescriptor(DSSequenceDescriptor):
    """Ephemeral stand-in used by ``engine.query``/``can_schedule`` for uids the
    engine does not know yet."""

    def __init__(self, tracking_id: int = -1, max_blocks_per_seq: int = 2**30):
        super().__init__(tracking_id, max_blocks_per_seq=max_blocks_per_seq)
