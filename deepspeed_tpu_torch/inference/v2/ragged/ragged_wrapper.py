"""Ragged batch container.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_wrapper.py``. ``finalize``
pads to the same ``(T, S, MB)`` buckets as the JAX package (:func:`to_padded`
tokens, sequences to a multiple of 8, block-table width to a power of two)
and packs the same two int32 arrays, ``tok_meta [4, T]`` (ids, sequence,
position, valid) and ``seq_meta [S, 4 + MB]`` (seen, n_tokens, last token,
valid, block table). PyTorch runs eagerly and needs no static shapes; the
buckets are kept so that the two packages see identical batches and the
paged kernel sees the padding it was written for. Padding tokens point at
sequence ``S - 1`` with ``valid = 0``; unused table slots are ``-1``.
"""

from typing import List

import numpy as np

from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor


def to_padded(original_size: int) -> int:
    """Token-count bucket: powers of two from 8 up to 64, then multiples of 128."""
    if original_size <= 64:
        n = 8
        while n < original_size:
            n *= 2
        return n
    return (original_size + 127) // 128 * 128


def _pad_to(n: int, mult: int) -> int:
    return max(mult, (n + mult - 1) // mult * mult)


def _pow2_pad(n: int, minimum: int = 4) -> int:
    """Power-of-two bucket (the block-table width)."""
    p = minimum
    while p < n:
        p *= 2
    return p


class RaggedBatchWrapper:
    """Host-side composition of one ragged forward batch."""

    def __init__(self, config: DSStateManagerConfig) -> None:
        self._config = config
        self.clear()

    def clear(self) -> None:
        self._token_ids: List[int] = []
        self._token_seq: List[int] = []  # token -> index of its sequence in this batch
        self._token_pos: List[int] = []  # absolute position within the sequence
        self._seq_descs: List[DSSequenceDescriptor] = []
        self._seq_seen: List[int] = []
        self._seq_ntok: List[int] = []
        self._seq_blocks: List[np.ndarray] = []
        self._device_batch = None

    @property
    def current_sequences(self) -> int:
        return len(self._seq_descs)

    @property
    def current_tokens(self) -> int:
        return len(self._token_ids)

    def insert_sequence(self, seq_desc: DSSequenceDescriptor, tokens, do_checks: bool = True) -> None:
        tokens = np.atleast_1d(np.asarray(tokens)).astype(np.int32)
        if do_checks:
            if self.current_tokens + tokens.size > self._config.max_ragged_batch_size:
                raise ValueError("ragged batch token budget exceeded")
            if self.current_sequences + 1 > self._config.max_ragged_sequence_count:
                raise ValueError("ragged batch sequence budget exceeded")
        seq_idx = len(self._seq_descs)
        seen = seq_desc.seen_tokens
        self._seq_descs.append(seq_desc)
        self._seq_seen.append(seen)
        self._seq_ntok.append(int(tokens.size))
        self._seq_blocks.append(seq_desc.kv_blocks)
        self._token_ids.extend(int(t) for t in tokens)
        self._token_seq.extend([seq_idx] * tokens.size)
        self._token_pos.extend(range(seen, seen + tokens.size))

    def finalize(self):
        """Pad to the bucket and build the packed numpy arrays."""
        T = to_padded(max(1, self.current_tokens))
        S = _pad_to(max(1, self.current_sequences), 8)
        mb = max((len(b) for b in self._seq_blocks), default=1)
        MB = _pow2_pad(mb, 4)
        n_tok = self.current_tokens
        n_seq = self.current_sequences

        tok_meta = np.zeros((4, T), np.int32)
        tok_meta[1] = S - 1
        tok_meta[0, :n_tok] = self._token_ids
        tok_meta[1, :n_tok] = self._token_seq
        tok_meta[2, :n_tok] = self._token_pos
        tok_meta[3, :n_tok] = 1

        seq_meta = np.zeros((S, 4 + MB), np.int32)
        seq_meta[:, 4:] = -1
        cursor = 0
        for i in range(n_seq):
            cursor += self._seq_ntok[i]
            seq_meta[i, :4] = (self._seq_seen[i], self._seq_ntok[i], cursor - 1, 1)
            blocks = self._seq_blocks[i]
            seq_meta[i, 4:4 + len(blocks)] = blocks
        self._device_batch = dict(tok_meta=tok_meta, seq_meta=seq_meta, n_tokens=n_tok, n_seqs=n_seq)
        return self._device_batch

    @property
    def device_batch(self):
        if self._device_batch is None:
            raise RuntimeError("finalize() the batch first")
        return self._device_batch
