"""Ragged batch container.

Port of ``deepspeed_tpu/inference/v2/ragged/ragged_wrapper.py``. ``finalize``
pads to the same ``(T, S, MB)`` buckets as the JAX package (:func:`to_padded`
tokens, sequences to a multiple of 8, block-table width to a power of two)
and packs the same two int32 arrays, ``tok_meta [4, T]`` (ids, sequence,
position, valid) and ``seq_meta [S, 4 + MB]`` (seen, n_tokens, last token,
valid, block table). PyTorch runs eagerly and needs no static shapes; the
buckets are kept so that the two packages see identical batches and the
paged kernel sees the padding it was written for. Padding tokens point at
sequence ``S - 1`` with ``valid = 0``; unused table slots are ``-1``. A
speculative token tree (``insert_sequence(..., tree=(parents, depths))``)
adds a third array, ``tree_meta [2, T]`` (each token's parent as a local
node index, -1 for the root, and its depth), packed only when a tree was
inserted.
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
        # tree-verify metadata (inference/v2/spec/tree.py): per token, the
        # parent's local feed index within its sequence (-1 = root) and the
        # root distance. Linear feeds default to the chain (parent = i-1,
        # depth = i), so mixed chain/tree batches pack uniformly.
        self._token_parent: List[int] = []
        self._token_depth: List[int] = []
        self._has_tree = False
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

    def insert_sequence(self, seq_desc: DSSequenceDescriptor, tokens, do_checks: bool = True,
                        tree=None) -> None:
        """``tree`` (optional) is a ``(parents, depths)`` pair of local-index
        arrays aligned with ``tokens`` — a speculative token tree (see
        spec/tree.py). Token i then occupies KV slot ``seen + i`` (sibling
        branches get distinct cache slots) and its ``token_pos`` stays the
        slot position; the tree-verify forward derives the logical (RoPE)
        position ``seen + depths[i]`` from the packed tree metadata."""
        tokens = np.atleast_1d(np.asarray(tokens)).astype(np.int32)
        if do_checks:
            if self.current_tokens + tokens.size > self._config.max_ragged_batch_size:
                raise ValueError("ragged batch token budget exceeded")
            if self.current_sequences + 1 > self._config.max_ragged_sequence_count:
                raise ValueError("ragged batch sequence budget exceeded")
        if tree is not None:
            # validate before mutating: a rejected insert must leave the
            # wrapper consistent so the caller can retry with a clean feed
            parents = np.asarray(tree[0], np.int32).reshape(-1)
            depths = np.asarray(tree[1], np.int32).reshape(-1)
            if do_checks:
                if parents.size != tokens.size or depths.size != tokens.size:
                    raise ValueError("tree metadata must align with the token feed")
                if tokens.size and (parents[0] != -1 or depths[0] != 0):
                    raise ValueError("tree node 0 must be the root (parent -1, depth 0)")
                if any(not (-1 <= int(parents[i]) < i) for i in range(tokens.size)):
                    raise ValueError("tree parents must be topological local indices")
        seq_idx = len(self._seq_descs)
        seen = seq_desc.seen_tokens
        self._seq_descs.append(seq_desc)
        self._seq_seen.append(seen)
        self._seq_ntok.append(int(tokens.size))
        self._seq_blocks.append(seq_desc.kv_blocks)
        self._token_ids.extend(int(t) for t in tokens)
        self._token_seq.extend([seq_idx] * tokens.size)
        self._token_pos.extend(range(seen, seen + tokens.size))
        if tree is None:
            self._token_parent.extend(range(-1, tokens.size - 1))
            self._token_depth.extend(range(tokens.size))
        else:
            self._token_parent.extend(int(p) for p in parents)
            self._token_depth.extend(int(d) for d in depths)
            self._has_tree = True

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
        if self._has_tree:
            # packed only when a tree was inserted: the plain decode/prefill
            # path builds exactly the two arrays it always did
            tree_meta = np.zeros((2, T), np.int32)
            tree_meta[0] = -1
            tree_meta[0, :n_tok] = self._token_parent
            tree_meta[1, :n_tok] = self._token_depth
            self._device_batch["tree_meta"] = tree_meta
        return self._device_batch

    @property
    def device_batch(self):
        if self._device_batch is None:
            raise RuntimeError("finalize() the batch first")
        return self._device_batch
