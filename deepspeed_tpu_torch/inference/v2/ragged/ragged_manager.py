"""Sequence + KV-cache state manager.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py`` (uid →
DSSequenceDescriptor tracking over a BlockedKVCache), with the host-tier
offload and restore of a sequence that the serving scheduler evicts under KV
pressure. KV offload to disk (``offload``/``offload_path``), handoff
export/import and prefix-cached sequences are ROADMAP A5.
"""

from typing import Dict, Optional

from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.utils.logging import logger


class DSStateManager:

    def __init__(self, config: DSStateManagerConfig, kv_config: KVCacheConfig, device):
        if config.offload or config.offload_path is not None:
            raise NotImplementedError("KV offload to disk (state_manager.offload / offload_path) is not "
                                      "ported yet (ROADMAP.md A5)")
        self._config = config
        self._kv_config = kv_config
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        self._offloaded: Dict[int, int] = {}  # uid -> host-store handle
        self._kv_cache = BlockedKVCache(kv_config, config.memory_config, device)

    # ------------------------------------------------------------- sequences --
    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is not None:
            return seq
        if self.n_tracked_sequences >= self._config.max_tracked_sequences:
            raise RuntimeError(f"max_tracked_sequences={self._config.max_tracked_sequences} reached")
        max_blocks = (self._config.max_context + self._kv_config.block_size - 1) // self._kv_config.block_size
        seq = DSSequenceDescriptor(uid, max_blocks_per_seq=max_blocks)
        self._seqs[uid] = seq
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
