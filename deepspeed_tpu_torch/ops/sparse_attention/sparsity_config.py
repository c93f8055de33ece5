"""Block-sparse attention layout configurations.

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept as it
is: numpy only, the same arguments, defaults and errors, and the same held
``np.random.default_rng(seed)``, so a config makes the same layout, bit for
bit, as its JAX counterpart with the same seed. Each config emits a
block-level layout ``[num_heads, num_blocks, num_blocks]`` (1 = the
``block×block`` tile is attended), consumed by ``sparse_self_attention``:

- Fixed (Sparse-Transformer, arXiv:1904.10509): local windows of
  ``num_local_blocks`` + the window's last global block(s) attended vertically
  (and horizontally when bidirectional + horizontal_global_attention).
- BigBird (arXiv:2007.14062): random + sliding-window + global first blocks
  (ITC mode).
- BSLongformer (arXiv:2004.05150): sliding window + chosen global indices.
- Variable: per-head random blocks + nested local windows + global first rows.
- LocalSlidingWindow: pure sliding window.
"""

import numpy as np


class SparsityConfig:

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"sequence length {seq_len} must be divisible by block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Everything attends to everything (sanity/testing config)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(f"num_local_blocks {num_local_blocks} must be divisible by "
                             f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns need different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns exceeds windows per local block")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, h, layout):
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            for row in range(start, end):
                layout[h, row, start:(row + 1 if uni else end)] = 1
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        g = self.num_global_blocks
        # each local window's representative: counting back from the window end,
        # rotated per head when multiple patterns are requested
        first = self.num_local_blocks - (1 + h % self.num_different_global_patterns) * g
        full_end = nb - nb % self.num_local_blocks
        cols = list(range(first, full_end, self.num_local_blocks))
        if full_end < nb:  # short trailing window
            cols.append(min(full_end + first, nb - g))
        for c in cols:
            row0 = 0 if self.attention == "bidirectional" else c
            layout[h, row0:, c:c + g] = 1
            if self.horizontal_global_attention:
                layout[h, c:c + g, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


def _sliding_window(h, layout, num_sliding_window_blocks):
    nb = layout.shape[1]
    if nb < num_sliding_window_blocks:
        raise ValueError(f"num_sliding_window_blocks {num_sliding_window_blocks} "
                         f"exceeds {nb} blocks")
    w = num_sliding_window_blocks // 2
    for row in range(nb):
        layout[h, row, max(0, row - w):min(row + w + 1, nb)] = 1
    return layout


class BigBirdSparsityConfig(SparsityConfig):

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        # the reference samples with the process-global `random`; a held seed
        # keeps layouts reproducible across hosts (SPMD requires identical masks)
        self._rng = np.random.default_rng(seed)

    def _random(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(f"num_random_blocks {self.num_random_blocks} exceeds {nb}")
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            k = min(self.num_random_blocks, hi)
            cols = self._rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout

    def _global_itc(self, h, layout):
        g = self.num_global_blocks
        if layout.shape[1] < g:
            raise ValueError(f"num_global_blocks {g} exceeds {layout.shape[1]}")
        layout[h, :g, :] = 1
        layout[h, :, :g] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._random(h, layout)
            layout = _sliding_window(h, layout, self.num_sliding_window_blocks)
            layout = self._global_itc(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0, ),
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_end_indices) != len(self.global_block_indices):
                raise ValueError("global_block_end_indices must pair with global_block_indices")
            global_block_end_indices = list(global_block_end_indices)
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def _global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices, self.global_block_end_indices))
        for start, end in spans:
            if start < nb:
                end = min(end, nb)
                layout[h, start:end, :] = 1
                layout[h, :, start:end] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = _sliding_window(h, layout, self.num_sliding_window_blocks)
            layout = self._global(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=(4, ), global_block_indices=(0, ),
                 global_block_end_indices=None, attention="bidirectional",
                 horizontal_global_attention=False, seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (list(global_block_end_indices)
                                         if global_block_end_indices is not None else None)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.default_rng(seed)

    def _random(self, h, layout):
        if not self.num_random_blocks:
            return layout
        nb = layout.shape[1]
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            k = min(self.num_random_blocks, hi)
            cols = self._rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout

    def _local(self, h, layout):
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        start = 0
        wins = self.local_window_blocks + [self.local_window_blocks[-1]] * nb
        for w in wins:
            if start >= nb:
                break
            end = min(start + w, nb)
            for row in range(start, end):
                layout[h, row, start:(row + 1 if uni else end)] = 1
            start = end
        return layout

    def _global(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices, self.global_block_end_indices))
        for start, end in spans:
            if start < nb:
                end = min(end, nb)
                row0 = 0 if self.attention == "bidirectional" else start
                layout[h, row0:, start:end] = 1
                if self.horizontal_global_attention:
                    layout[h, start:end, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._random(h, layout)
            layout = self._local(h, layout)
            layout = self._global(h, layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = _sliding_window(h, layout, self.num_sliding_window_blocks)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)
