"""Sequence + KV-cache state manager.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_manager.py`` (uid →
DSSequenceDescriptor tracking over a BlockedKVCache). Offload, handoff
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
            raise NotImplementedError("KV offload is not ported yet (ROADMAP.md A5)")
        self._config = config
        self._kv_config = kv_config
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
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
        if seq.cur_allocated_blocks > 0:
            self._kv_cache.free(seq.kv_blocks)

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
