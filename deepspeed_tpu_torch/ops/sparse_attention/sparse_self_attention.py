"""Block-sparse self-attention over a sparsity layout.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``. Two
implementations:

- ``impl="kernel"``: :func:`~deepspeed_tpu_torch.ops.block_sparse_attention.block_sparse_attention`,
  whose forward is the hand-written CUDA kernel on the card (its plain
  version on the CPU): compute and memory follow the layout's density.
- ``impl="masked"``: dense scores and the layout mask in torch ops, the
  semantic reference and the path for per-batch masks (``key_padding_mask``,
  ``attn_mask``), which the kernel does not take.

``impl="auto"`` takes the kernel unless a per-batch mask is given.
"""

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.block_sparse_attention import block_sparse_attention


def layout_to_dense_mask(layout, block: int):
    """[H, nb, nb] block layout → [H, S, S] boolean token mask (on the
    layout's device when it is a tensor, else on the CPU)."""
    lay = torch.as_tensor(layout).bool()
    return lay.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)


def sparse_self_attention(q, k, v, layout, block: int, scale: Optional[float] = None, key_padding_mask=None,
                          attn_mask=None, impl: str = "auto"):
    """q/k/v: [B, H, S, D]; layout: [H, nb, nb]; returns [B, H, S, D].

    ``key_padding_mask`` [B, S] and ``attn_mask`` [S, S] are read as booleans,
    as the JAX package reads them: nonzero keeps a key, zero (False) drops
    it. ``impl``: "kernel" = block-sparse flash (density-scaling compute),
    "masked" = dense scores + mask, "auto" = kernel when no per-batch masks.
    """
    if impl == "auto":
        impl = "masked" if (key_padding_mask is not None or attn_mask is not None) else "kernel"
    if impl == "kernel":
        if key_padding_mask is not None or attn_mask is not None:
            raise ValueError("the block-sparse kernel takes the layout only; "
                             "fold per-batch masks into the layout or use impl='masked'")
        return block_sparse_attention(q, k, v, layout, block, scale=scale)

    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale

    neg = torch.finfo(scores.dtype).min
    mask = layout_to_dense_mask(layout, block).to(scores.device)[None]  # [1, H, S, S]
    scores = scores.masked_fill(~mask, neg)
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=scores.device).bool()[:, None, None, :]
        scores = scores.masked_fill(~kpm, neg)
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=scores.device).bool()[None, None]
        scores = scores.masked_fill(~am, neg)

    row_max = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - row_max)
    denom = probs.sum(dim=-1, keepdim=True)
    probs = probs / denom.clamp(min=1e-20)
    # rows with no attended key (empty layout row, or padding masking a whole
    # row) contribute zeros, not NaN, and not the uniform average that
    # exp(min - min) = 1 would produce
    probs = torch.where(row_max > neg / 2, probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class SparseSelfAttention(torch.nn.Module):
    """Layout-holding module (the reference's SparseSelfAttention surface);
    it has no parameters. The mask modes and ``max_seq_length`` are kept and
    ``rpe`` is taken, as in the JAX package's surface; none of them is used."""

    def __init__(self, sparsity_config, key_padding_mask_mode="add", attn_mask_mode="mul",
                 max_seq_length: int = 2048):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._layouts = {}

    def get_layout(self, seq_len):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None, attn_mask=None):
        layout = self.get_layout(query.shape[-2])
        return sparse_self_attention(query, key, value, layout, self.sparsity_config.block,
                                     key_padding_mask=key_padding_mask, attn_mask=attn_mask)
