"""Sequence + KV-cache state manager.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py`` (uid →
DSSequenceDescriptor tracking over a BlockedKVCache): the tiered offload and
restore of a sequence that the serving scheduler evicts under KV pressure
(host memory, and spill files under ``offload_path``), host→disk demotion,
sequences created over prefix-cached blocks, and the in-process snapshot
that ``ragged/handoff.py`` frames for another engine.
"""

from typing import Dict, Optional

import numpy as np

from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.utils.logging import logger


class DSStateManager:

    def __init__(self, config: DSStateManagerConfig, kv_config: KVCacheConfig, device):
        self._config = config
        self._kv_config = kv_config
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        self._offloaded: Dict[int, int] = {}  # uid -> tiered-store handle
        self._kv_cache = BlockedKVCache(kv_config, config.memory_config, device, offload=config.offload,
                                        offload_path=config.offload_path)

    # ------------------------------------------------------------- sequences --
    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is not None:
            return seq
        return self._create_sequence(uid)

    def _create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self._seqs:
            raise ValueError(f"sequence {uid} already tracked")
        if self.n_tracked_sequences >= self._config.max_tracked_sequences:
            raise RuntimeError(f"max_tracked_sequences={self._config.max_tracked_sequences} reached")
        max_blocks = (self._config.max_context + self._kv_config.block_size - 1) // self._kv_config.block_size
        seq = DSSequenceDescriptor(uid, max_blocks_per_seq=max_blocks)
        self._seqs[uid] = seq
        return seq

    def create_cached_sequence(self, uid: int, blocks, seen_tokens: int) -> DSSequenceDescriptor:
        """Create a sequence whose block table arrives pre-populated — the
        prefix-cache hit path: ``blocks`` already hold the KV for the first
        ``seen_tokens`` committed tokens (shared, read-only; the caller holds
        one reference per block on this sequence's behalf, which
        ``flush_sequence`` returns). The next forward continues at position
        ``seen_tokens`` exactly like a restored or imported sequence."""
        blocks = np.atleast_1d(np.asarray(blocks)).astype(np.int64)
        seen_tokens = int(seen_tokens)
        if seen_tokens < 0 or seen_tokens > blocks.size * self._kv_config.block_size:
            raise ValueError(f"create_cached_sequence: seen_tokens={seen_tokens} does not fit "
                             f"{blocks.size} blocks of {self._kv_config.block_size} tokens")
        seq = self._create_sequence(uid)
        try:
            if blocks.size:
                seq.extend_kv_cache(blocks)
            seq.pre_forward(seen_tokens)
            seq.post_forward()
        except Exception:
            del self._seqs[uid]  # the caller still owns the block references
            raise
        return seq

    def flush_sequence(self, uid: int) -> None:
        """Release all state for a sequence."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            logger.warning(f"flush_sequence: unknown uid {uid}")
            return
        handle = self._offloaded.pop(uid, None)
        if handle is not None:
            self._kv_cache.drop_offloaded(handle)
        elif seq.cur_allocated_blocks > 0:
            self._kv_cache.free(seq.kv_blocks)

    # ----------------------------------------------------------- kv offload --
    def is_offloaded(self, uid: int) -> bool:
        return uid in self._offloaded

    def sequence_tier(self, uid: int) -> str:
        """``device`` for a resident block table, else the store's tier."""
        handle = self._offloaded.get(uid)
        if handle is None:
            return "device"
        return self._kv_cache.offload_tier(handle)

    def offload_sequence(self, uid: int) -> None:
        """Evict a (cold) sequence's KV blocks to the host tier, freeing its
        device blocks for other sequences. The sequence stays tracked; the
        next forward that touches it restores it (engine put/decode_loop)."""
        seq = self._seqs.get(uid)
        if seq is None:
            raise ValueError(f"offload_sequence: unknown uid {uid}")
        if uid in self._offloaded:
            return
        if seq.in_flight_tokens:
            raise RuntimeError(f"offload_sequence: uid {uid} has in-flight tokens")
        if seq.cur_allocated_blocks == 0:
            return
        self._offloaded[uid] = self._kv_cache.offload(seq.kv_blocks)
        seq.kv_tier = self.sequence_tier(uid)

    def demote_sequence(self, uid: int, wait: bool = False) -> bool:
        """Push an already-offloaded sequence one tier colder (host→disk);
        returns whether a demotion was scheduled (brownout's
        demote-before-shed stage calls this for the coldest offloaded
        sessions before any queued work is shed)."""
        handle = self._offloaded.get(uid)
        if handle is None:
            return False
        demoted = self._kv_cache.demote_offloaded(handle, wait=wait)
        if demoted:
            seq = self._seqs.get(uid)
            if seq is not None:
                seq.kv_tier = "disk" if wait else self.sequence_tier(uid)
        return demoted

    def restore_sequence(self, uid: int) -> None:
        """Bring an offloaded sequence's KV back into fresh device blocks and
        rewrite its block table. Raises if the device pool cannot hold it
        (offload other sequences first)."""
        handle = self._offloaded.pop(uid, None)
        if handle is None:
            return
        try:
            new_blocks = self._kv_cache.restore(handle)
        except Exception:
            self._offloaded[uid] = handle  # payload intact; caller may evict + retry
            raise
        seq = self._seqs[uid]
        seq.replace_kv_blocks(new_blocks)
        seq.kv_tier = "device"

    # ------------------------------------------------------------ kv handoff --
    def export_sequence(self, uid: int) -> dict:
        """Portable snapshot of a tracked sequence — committed-token count plus
        KV-block contents (a host tensor whose copy has landed) — for
        :meth:`import_sequence` on another manager; ``ragged/handoff.py``
        frames it as bytes. An offloaded sequence is restored first. The
        sequence stays tracked and resident here; the caller flushes once the
        recipient has taken over."""
        seq = self._seqs.get(uid)
        if seq is None:
            raise ValueError(f"export_sequence: unknown uid {uid}")
        if seq.in_flight_tokens:
            raise RuntimeError(f"export_sequence: uid {uid} has in-flight tokens")
        if uid in self._offloaded:
            self.restore_sequence(uid)
        kv = (self._kv_cache.gather_blocks(seq.kv_blocks, synchronize=True)
              if seq.cur_allocated_blocks > 0 else None)
        return {"uid": uid, "seen_tokens": seq.seen_tokens, "kv": kv}

    def import_sequence(self, snapshot: dict, uid: Optional[int] = None) -> int:
        """Recreate an exported sequence under ``uid`` (default: the donor's
        uid): fresh device blocks, contents written back, committed-token
        count restored. Raises without consuming anything when the uid is
        already tracked, the payload's geometry doesn't fit this cache, or
        the device pool can't hold it (evict and retry)."""
        uid = int(snapshot["uid"] if uid is None else uid)
        if uid in self._seqs:
            raise ValueError(f"import_sequence: uid {uid} already tracked")
        kv = snapshot["kv"]
        seq = self._create_sequence(uid)
        try:
            if kv is not None:
                if kv.shape[2] > seq.max_blocks:
                    raise ValueError(f"import_sequence: payload holds {kv.shape[2]} blocks; "
                                     f"this manager caps sequences at {seq.max_blocks} "
                                     f"(max_context={self._config.max_context})")
                seq.extend_kv_cache(self._kv_cache.scatter_blocks(kv))
            seq.pre_forward(int(snapshot["seen_tokens"]))
            seq.post_forward()
        except Exception:
            del self._seqs[uid]  # scatter freed its blocks on failure
            raise
        return uid

    @property
    def tracked_sequences(self) -> Dict[int, DSSequenceDescriptor]:
        return self._seqs

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    # --------------------------------------------------------------- kv cache --
    @property
    def kv_cache(self) -> BlockedKVCache:
        return self._kv_cache

    @property
    def kv_block_size(self) -> int:
        return self._kv_config.block_size

    @property
    def free_blocks(self) -> int:
        return self._kv_cache.free_blocks

    def allocate_blocks(self, n_blocks: int):
        return self._kv_cache.reserve(n_blocks)
