"""Base ragged transformer model implementation.

Port of ``deepspeed_tpu/inference/v2/model_implementations/transformer_base.py``
(KV cache sizing, ``get_kv_requirements``/``maybe_allocate_kv``, the ragged
``forward``, the greedy ``decode_loop`` and both attention branches).

Where the JAX package compiles one program per ``(T, S, MB)`` bucket and
threads the donated cache through it, the port runs eagerly and updates the
one cache tensor in place: the JAX ``jit(..., donate_argnums=(1,))`` plus
``set_cache`` becomes an in-place write by the attention of each layer. The
packed ``tok_meta``/``seq_meta`` arrays are copied to the device once per
forward, and ``decode_loop`` keeps them there across steps. Per-layer
compute comes from subclasses (``embed``, ``layer_forward``, ``unembed``);
the speculative verify programs and KV compaction are ROADMAP A5b, tracing
A5c.
"""

import math
from functools import partial
from typing import Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.modules.heuristics import attention_implementation
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_update

_CACHE_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32"}


class DSTransformerModelBase:
    """Subclasses define: num_layers, num_heads, num_kv_heads, head_dim,
    vocab_size, ``embed(ids)``, ``layer_forward(li, x, cache, attn_fn, batch)``
    and ``unembed(x)``. ``params`` is a dict of tensors, moved to ``device``
    and cast to ``config.dtype`` (no copy where they already are)."""

    def __init__(self, params, config, engine_config, device, state_manager=None):
        self._device = torch.device(device)
        self._params = {k: v.to(device=self._device, dtype=config.dtype) for k, v in params.items()}
        self._config = config
        self._engine_config = engine_config
        self._state_manager = None
        if state_manager is not None:
            self.set_state_manager(state_manager)

    # ------------------------------------------------------------ properties --
    @property
    def config(self):
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_layers(self) -> int:
        raise NotImplementedError

    @property
    def num_kv_heads(self) -> int:
        raise NotImplementedError

    @property
    def num_heads(self) -> int:
        raise NotImplementedError

    @property
    def head_dim(self) -> int:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------------------- kv sizing --
    def kv_cache_config(self) -> KVCacheConfig:
        sm = self._engine_config.state_manager
        # the cache follows the model dtype; any other dtype caches in bf16
        cache_dtype = _CACHE_DTYPES.get(getattr(self._config, "dtype", torch.bfloat16), "bfloat16")
        bs = self._engine_config.kv_block_size
        return KVCacheConfig(block_size=bs,
                             cache_shape=(self.num_layers, self.num_kv_heads, self.head_dim),
                             cache_dtype=cache_dtype,
                             max_blocks_per_allocation_group=(sm.max_context + bs - 1) // bs)

    def set_state_manager(self, state_manager):
        self._state_manager = state_manager

    @property
    def state_manager(self):
        return self._state_manager

    def get_kv_requirements(self, seq_desc: DSSequenceDescriptor, max_new_tokens: int,
                            max_new_blocks: int) -> Tuple[int, int]:
        """How many of ``max_new_tokens`` can run given ``max_new_blocks`` free
        blocks, and how many blocks that takes."""
        bs = self._state_manager.kv_block_size
        # the per-sequence table cap (max_context) bounds schedulable tokens too
        seq_cap = seq_desc.max_blocks - seq_desc.cur_allocated_blocks
        max_new_blocks = min(max_new_blocks, seq_cap)
        total = seq_desc.seen_tokens + max_new_tokens
        blocks_needed = (total + bs - 1) // bs - seq_desc.cur_allocated_blocks
        if blocks_needed <= max_new_blocks:
            return max_new_tokens, max(0, blocks_needed)
        capacity = (seq_desc.cur_allocated_blocks + max_new_blocks) * bs - seq_desc.seen_tokens
        return max(0, capacity), max_new_blocks

    def get_remaining_block_capacity(self, seq_desc: DSSequenceDescriptor) -> int:
        bs = self._state_manager.kv_block_size
        return seq_desc.cur_allocated_blocks * bs - seq_desc.seen_tokens

    def maybe_allocate_kv(self, seq_desc: DSSequenceDescriptor, n_new_tokens: int) -> None:
        sched, n_blocks = self.get_kv_requirements(seq_desc, n_new_tokens, self._state_manager.free_blocks)
        if sched < n_new_tokens:
            # an unchecked put must fail loudly: under-allocating would write
            # KV through unallocated table entries
            raise ValueError(f"sequence {seq_desc.tracking_id}: {n_new_tokens} new tokens need more "
                             f"KV blocks than the free pool / per-sequence max_context allows "
                             f"(schedulable: {sched})")
        if n_blocks > 0:
            seq_desc.extend_kv_cache(self._state_manager.allocate_blocks(n_blocks))

    # ---------------------------------------------------------------- forward --
    def _to_device(self, batch):
        return (torch.from_numpy(batch["tok_meta"]).to(self._device),
                torch.from_numpy(batch["seq_meta"]).to(self._device))

    @torch.no_grad()
    def forward(self, ragged_batch) -> torch.Tensor:
        """Run the ragged forward; returns f32 logits ``[n_seqs, vocab]`` on the
        device (one row per sequence, its final token) and writes the batch's
        K/V into the cache in place."""
        batch = ragged_batch.device_batch
        tok_meta, seq_meta = self._to_device(batch)
        return self._forward_impl(tok_meta, seq_meta, batch["n_tokens"])[:batch["n_seqs"]]

    def empty_run(self) -> None:
        """A forward of the smallest bucket with every validity flag false."""
        wrapper = RaggedBatchWrapper(self._engine_config.state_manager)
        wrapper.finalize()  # zero live sequences/tokens
        self.forward(wrapper)

    # ------------------------------------------------------------ decode loop --
    @torch.no_grad()
    def decode_loop(self, ragged_batch, n_steps: int) -> np.ndarray:
        """Greedy-decode ``n_steps`` tokens per sequence; returns ``[n_steps,
        S_bucket]`` host int32 (column i is sequence slot i).

        The JAX package runs this as one ``lax.scan`` program. Here it is a
        Python loop whose state never leaves the device: each step is one
        ragged forward, an argmax, and an update of ``tok_meta`` (next ids,
        positions) and ``seq_meta`` (seen counts) by tensor ops, with no host
        sync; the tokens cross to the host once, at the end. KV blocks for all
        ``n_steps`` tokens must be allocated beforehand. The cache ends up
        holding the ``n_steps`` inserted tokens (the last generated token is
        not yet inserted)."""
        batch = ragged_batch.device_batch
        tok_meta, seq_meta = self._to_device(batch)
        tokens = torch.empty((n_steps, seq_meta.shape[0]), dtype=torch.int32, device=self._device)
        tv = (tok_meta[3] > 0).to(torch.int32)
        sv = (seq_meta[:, 3] > 0).to(torch.int32)
        for i in range(n_steps):
            logits = self._forward_impl(tok_meta, seq_meta, batch["n_tokens"])
            next_ids = torch.argmax(logits, dim=-1).to(torch.int32)  # [S]
            tokens[i] = next_ids
            # decode batches carry one token per sequence: slot i <-> sequence i
            new_ids = torch.where(tv > 0, next_ids[tok_meta[1].long()], tok_meta[0])
            tok_meta = torch.stack([new_ids, tok_meta[1], tok_meta[2] + tv, tok_meta[3]])
            seq_meta = seq_meta.clone()
            seq_meta[:, 0] += sv
        return tokens.cpu().numpy()

    @staticmethod
    def _unpack_batch(tok_meta, seq_meta, n_tokens):
        """Packed ``[4, T]``/``[S, 4 + MB]`` metadata → named views, plus the
        host-side count of valid tokens (the wrapper packs them first)."""
        return dict(input_ids=tok_meta[0], token_seq=tok_meta[1], token_pos=tok_meta[2],
                    token_valid=tok_meta[3] > 0, token_valid_i32=tok_meta[3], n_tokens=n_tokens,
                    seq_seen=seq_meta[:, 0], seq_ntok=seq_meta[:, 1], last_tok=seq_meta[:, 2],
                    block_table=seq_meta[:, 4:])

    def _forward_impl(self, tok_meta, seq_meta, n_tokens):
        batch = self._unpack_batch(tok_meta, seq_meta, n_tokens)
        cache = self._state_manager.kv_cache.cache
        x = self.embed(batch["input_ids"])
        attn = partial(self._paged_attention, batch=batch)
        for li in range(self.num_layers):
            x, cache = self.layer_forward(li, x, cache, attn, batch)
        # unembed only each sequence's last token
        x_last = x[batch["last_tok"].long()]
        return self.unembed(x_last).float()

    # -------------------------------------------------------- paged attention --
    @property
    def attention_window(self) -> int:
        """Sliding attention window in tokens; 0 = full causal."""
        return 0

    def _use_paged_kernel(self, T: int) -> bool:
        return attention_implementation(self, self._engine_config, T) == "paged_kernel"

    def _paged_attention(self, q, k_new, v_new, cache, li, *, batch):
        """Write the new K/V into the paged cache, then attend each query
        token to its sequence's history. Decode buckets on the kernel branch
        go through ``ops/paged_attention.py``; the gather branch densifies
        each sequence's history in torch ops.

        q: [T, H, D]; k_new/v_new: [T, KVH, D]; cache: [L, 2, NB, KVH, bs, D]."""
        T = q.shape[0]
        if self._use_paged_kernel(T):
            return paged_attention_update(q, k_new, v_new, cache, li, batch["block_table"], batch["token_seq"],
                                          batch["token_pos"], batch["token_valid_i32"])

        S, MB = batch["block_table"].shape
        bs = cache.shape[4]
        H, D, KVH = self.num_heads, self.head_dim, self.num_kv_heads
        token_seq = batch["token_seq"].long()
        token_pos = batch["token_pos"].long()
        token_valid = batch["token_valid"]
        table = batch["block_table"].long()

        # --- scatter new kv: the JAX package routes padding tokens and -1
        # table slots to block NB and lets XLA's scatter drop them; torch
        # raises on NB and wraps -1, so the writes are masked instead. The
        # valid tokens are the first n (a host count, so no device sync), and
        # each has its block allocated before the forward (maybe_allocate_kv)
        n = batch["n_tokens"]
        blk_ids = table[token_seq[:n], token_pos[:n] // bs]
        offs = token_pos[:n] % bs
        cache[li, 0][blk_ids, :, offs] = k_new[:n].to(cache.dtype)
        cache[li, 1][blk_ids, :, offs] = v_new[:n].to(cache.dtype)

        # --- gather per-sequence history -------------------------------------
        hist = table.clamp(min=0)  # [S, MB]
        KV = MB * bs
        k_hist = cache[li, 0][hist].permute(0, 2, 1, 3, 4).reshape(S, KVH, KV, D).transpose(1, 2).to(q.dtype)
        v_hist = cache[li, 1][hist].permute(0, 2, 1, 3, 4).reshape(S, KVH, KV, D).transpose(1, 2).to(q.dtype)
        if KVH != H:  # GQA
            k_hist = k_hist.repeat_interleave(H // KVH, dim=2)
            v_hist = v_hist.repeat_interleave(H // KVH, dim=2)

        # --- densify queries per sequence ------------------------------------
        seq_seen = batch["seq_seen"].long()
        Qm = max(1, T)  # dense q rows per sequence, bounded by T
        local_q = (token_pos - seq_seen[token_seq]).clamp(0, Qm - 1)
        q_dense = q.new_zeros((S, Qm, H, D))
        q_dense[token_seq[:n], local_q[:n]] = q[:n]

        logits = torch.einsum("sqhd,skhd->shqk", q_dense, k_hist).float() * (1.0 / math.sqrt(D))
        kv_pos = torch.arange(KV, device=q.device)[None, None, None, :]
        q_pos = (seq_seen[:, None] + torch.arange(Qm, device=q.device)[None, :])[:, None, :, None]
        valid_kv = kv_pos <= q_pos  # causal incl. self
        seq_len = (seq_seen + batch["seq_ntok"].long())[:, None, None, None]
        valid_kv = valid_kv & (kv_pos < seq_len)
        if self.attention_window > 0:  # mistral sliding window
            valid_kv = valid_kv & (kv_pos > q_pos - self.attention_window)
        logits = logits.masked_fill(~valid_kv, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out_dense = torch.einsum("shqk,skhd->sqhd", probs, v_hist)

        # --- back to token-major ---------------------------------------------
        out = out_dense[token_seq, local_q]  # [T, H, D]
        return out.masked_fill(~token_valid[:, None, None], 0.0), cache

    # Subclass hooks -----------------------------------------------------------
    def embed(self, ids):
        raise NotImplementedError

    def layer_forward(self, li, x, cache, attn_fn, batch):
        raise NotImplementedError

    def unembed(self, x):
        raise NotImplementedError
