"""Base ragged transformer model implementation.

Port of ``deepspeed_tpu/inference/v2/model_implementations/transformer_base.py``
(KV cache sizing, ``get_kv_requirements``/``maybe_allocate_kv``, the ragged
``forward``, ``decode_loop`` greedy and sampled, both attention branches, the
speculative verify forwards ``forward_verify``/``forward_verify_tree`` and
the accepted-path KV compaction ``compact_kv``).

Where the JAX package compiles one program per ``(T, S, MB)`` bucket and
threads the donated cache through it, the port runs eagerly and updates the
one cache tensor in place: the JAX ``jit(..., donate_argnums=(1,))`` plus
``set_cache`` becomes an in-place write by the attention of each layer. The
packed ``tok_meta``/``seq_meta`` arrays are copied to the device once per
forward, and ``decode_loop`` keeps them there across steps. Weight quantization
(int8 / packed int4 at rest) happens once, at build time, and each weight is
dequantized where its layer reads it. Per-layer
compute comes from subclasses (``embed``, ``layer_forward``, ``unembed``).
With a tracer set (``trace_enabled``), ``forward`` and ``empty_run`` run the
same eager ops with a ``record`` around each phase (``embed``, per layer
``attn`` and ``ffn`` from ``layer_forward_traced``, ``unembed``) and resolve
the phase times with one wait at the end, where the JAX package splits its
fused program into phases with a barrier each; the kernel choice is the
untraced forward's, so B1 still takes decode feeds of 32 tokens or fewer.

Tree verify computes the reference's function without its per-query virtual
KV view (``[S, Qm, KV, H, D]``, tens of GB at Llama-2-7B width): every query
node scores the sequence's shared history under a visibility mask built on
the host (committed slots, plus the feed slots of its ancestor-or-self path),
with ``Qm`` the largest tree of the batch. The view bought the reference
bitwise equality of a chain tree with the linear verify on XLA; the port
holds the two equal within f32 rounding instead.
"""

import math
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.modules.heuristics import attention_implementation
from deepspeed_tpu_torch.inference.v2.quantization import DequantizingParams, is_quantized_leaf, quantize_tree
from deepspeed_tpu_torch.inference.v2.ragged.manager_configs import KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.inference.v2.tracer import get_tracer, record
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_update

_CACHE_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32"}


class DSTransformerModelBase:
    """Subclasses define: num_layers, num_heads, num_kv_heads, head_dim,
    vocab_size, ``embed(ids)``, ``layer_forward(li, x, cache, attn_fn, batch)``
    and ``unembed(x)``. ``params`` is a dict of tensors, moved to ``device``
    and cast to ``config.dtype`` (no copy where they already are); a
    quantized leaf (``inference/v2/quantization.py``) moves as it is.

    With ``engine_config.quantization`` enabled the weights are quantized
    here, once, and kept int8 / packed int4 at rest; ``self._params`` is a
    :class:`DequantizingParams`, so each weight is dequantized where its
    layer reads it (the reference dequantizes the tree inside each jitted
    forward, where XLA fuses the dequantize into each consumer)."""

    def __init__(self, params, config, engine_config, device, state_manager=None):
        self._device = torch.device(device)
        params = {k: ({n: t.to(self._device) for n, t in v.items()} if is_quantized_leaf(v) else
                      v.to(device=self._device, dtype=config.dtype)) for k, v in params.items()}
        wq = engine_config.quantization
        if wq.enabled:
            if engine_config.tensor_parallel.tp_size > 1:
                raise NotImplementedError("weight_quantization with TP>1: tensor-parallel slicing cuts whole weights "
                                          "by name, which quantized leaves change; quantizing each rank's shard "
                                          "after placement is not wired (as in the reference)")
            params = quantize_tree(params, min_size=wq.min_size, bits=wq.bits)
        self._params = DequantizingParams(params)
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
    def model_config(self):
        """The model's own config, which ``serialize`` writes (a subclass
        may build its base from another: a Mixtral's ``config`` is its
        attention's Llama config)."""
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
        tracer = get_tracer()
        if tracer is not None:
            return self._traced_forward(tracer, tok_meta, seq_meta, batch["n_tokens"])[:batch["n_seqs"]]
        return self._forward_impl(tok_meta, seq_meta, batch["n_tokens"])[:batch["n_seqs"]]

    def empty_run(self) -> None:
        """A forward with zero live tokens: the smallest bucket with every
        validity flag false. It enters exactly the collectives a real forward
        enters (a Mixtral under expert parallelism: the token-count exchange,
        then two all-to-alls a layer), so an idle rank keeps its expert group
        in lock-step, and it writes no KV."""
        wrapper = RaggedBatchWrapper(self._engine_config.state_manager)
        wrapper.finalize()  # zero live sequences/tokens
        self.forward(wrapper)

    # ------------------------------------------------------------ decode loop --
    @torch.no_grad()
    def decode_loop(self, ragged_batch, n_steps: int, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Decode ``n_steps`` tokens per sequence; returns ``[n_steps,
        S_bucket]`` host int32 (column i is sequence slot i). Greedy argmax at
        ``temperature`` 0; otherwise a categorical draw from ``softmax(logits /
        temperature)`` by :func:`sample_categorical`, with ``generator`` (a
        ``torch.Generator`` on the engine's device) required, as the
        reference requires its ``rng`` key: a silent default would make every
        call draw the same "samples".

        The JAX package runs this as one ``lax.scan`` program. Here it is a
        Python loop whose state never leaves the device: each step is one
        ragged forward, an argmax (or a draw), and an update of ``tok_meta``
        (next ids, positions) and ``seq_meta`` (seen counts) by tensor ops,
        with no host sync; the tokens cross to the host once, at the end. KV
        blocks for all ``n_steps`` tokens must be allocated beforehand. The
        cache ends up holding the ``n_steps`` inserted tokens (the last
        generated token is not yet inserted)."""
        sampled = float(temperature) > 0
        if sampled:
            _check_generator(generator, self._device)
        batch = ragged_batch.device_batch
        tok_meta, seq_meta = self._to_device(batch)
        tokens = torch.empty((n_steps, seq_meta.shape[0]), dtype=torch.int32, device=self._device)
        tv = (tok_meta[3] > 0).to(torch.int32)
        sv = (seq_meta[:, 3] > 0).to(torch.int32)
        for i in range(n_steps):
            logits = self._forward_impl(tok_meta, seq_meta, batch["n_tokens"])
            if sampled:
                next_ids = sample_categorical(logits, float(temperature), generator)
            else:
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

    def _hidden(self, batch, attn):
        """Embed and run every layer; the residual stream ``[T, hidden]``
        before the final norm."""
        self._begin_forward(batch)
        cache = self._state_manager.kv_cache.cache
        x = self.embed(batch["input_ids"])
        for li in range(self.num_layers):
            x, cache = self.layer_forward(li, x, cache, attn, batch)
        return x

    def _begin_forward(self, batch) -> None:
        """Each forward's first step, before the embedding (subclasses: a
        Mixtral's gate seed and expert-group exchange); adds to ``batch``."""

    def _forward_impl(self, tok_meta, seq_meta, n_tokens):
        batch = self._unpack_batch(tok_meta, seq_meta, n_tokens)
        x = self._hidden(batch, partial(self._paged_attention, batch=batch))
        # unembed only each sequence's last token
        x_last = x[batch["last_tok"].long()]
        return self.unembed(x_last).float()

    def _traced_forward(self, tracer, tok_meta, seq_meta, n_tokens):
        """:meth:`_forward_impl`'s ops with each phase recorded: ``embed``,
        per layer ``attn`` and ``ffn``, ``unembed``; then one wait resolves
        the phase times (no-op waits on a CPU tracer)."""
        batch = self._unpack_batch(tok_meta, seq_meta, n_tokens)
        attn = partial(self._paged_attention, batch=batch)
        self._begin_forward(batch)
        cache = self._state_manager.kv_cache.cache
        with record("embed"):
            x = self.embed(batch["input_ids"])
        for li in range(self.num_layers):
            x, cache = self.layer_forward_traced(li, x, cache, attn, batch)
        with record("unembed"):
            logits = self.unembed(x[batch["last_tok"].long()]).float()
        tracer.resolve()
        return logits

    def layer_forward_traced(self, li, x, cache, attn_fn, batch):
        raise NotImplementedError("tracing requires a model with phase-split layers")

    # ----------------------------------------------------- speculative verify --
    @torch.no_grad()
    def forward_verify(self, ragged_batch, greedy: bool = False) -> torch.Tensor:
        """The speculative verify forward: the layers of :meth:`forward`, but
        every fed position is unembedded. Returns f32 logits ``[n_tokens,
        vocab]`` on the device (row t scores the token after batch position
        t), or with ``greedy=True`` the device argmax, int32 ``[n_tokens]``, so
        that only ids cross to the host. Every fed position's KV is written,
        drafts that turn out wrong included: the caller rolls those back by
        truncating ``seen_tokens``, and the next feed overwrites them. A feed
        bucket of at most 32 tokens goes through the paged kernel (B1), as a
        decode step does."""
        batch = ragged_batch.device_batch
        tok_meta, seq_meta = self._to_device(batch)
        n = batch["n_tokens"]
        unpacked = self._unpack_batch(tok_meta, seq_meta, n)
        x = self._hidden(unpacked, partial(self._paged_attention, batch=unpacked))
        logits = self.unembed(x[:n]).float()
        return torch.argmax(logits, dim=-1).to(torch.int32) if greedy else logits

    @torch.no_grad()
    def forward_verify_tree(self, ragged_batch, greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token-tree verify (spec/tree.py): one ragged forward scores every
        node of each sequence's draft tree; a node attends to the committed
        prefix plus its own ancestor-or-self path only, so sibling branches
        sharing the feed cannot see each other. The batch must carry
        ``tree_meta`` (the wrapper packs it when a tree is inserted).

        RoPE takes the logical position ``seen + depth``; the cache write
        takes the slot position ``seen + node``. Returns ``(rows_or_ids,
        hidden)`` on the device: f32 logits ``[n_tokens, vocab]`` (or with
        ``greedy=True`` int32 argmax ids ``[n_tokens]``) and the f32 residual
        stream before the final norm ``[n_tokens, hidden]``, the learned
        draft head's input. Always the gather branch: B1 attends a contiguous
        causal feed and cannot express the ancestor mask."""
        batch = ragged_batch.device_batch
        if "tree_meta" not in batch:
            raise ValueError("forward_verify_tree needs a batch with tree_meta "
                             "(insert sequences with tree=(parents, depths))")
        tok_meta_np, seq_meta_np, tree_meta = batch["tok_meta"], batch["seq_meta"], batch["tree_meta"]
        n = batch["n_tokens"]
        # logical (RoPE) position seen + depth; the attention keeps the slots
        logical = tok_meta_np.copy()
        logical[2] = seq_meta_np[tok_meta_np[1], 0] + tree_meta[1]
        visible, Qm = self._tree_visibility(tok_meta_np, seq_meta_np, tree_meta)
        tok_meta, seq_meta = self._to_device(dict(batch, tok_meta=logical))
        unpacked = self._unpack_batch(tok_meta, seq_meta, n)
        attn = partial(self._tree_paged_attention, batch=unpacked,
                       slot_pos=torch.from_numpy(tok_meta_np[2]).to(self._device),
                       visible=torch.from_numpy(visible).to(self._device), Qm=Qm)
        x = self._hidden(unpacked, attn)[:n]
        logits = self.unembed(x).float()
        out = torch.argmax(logits, dim=-1).to(torch.int32) if greedy else logits
        return out, x.float()

    def _tree_visibility(self, tok_meta, seq_meta, tree_meta):
        """Host-built tree mask ``[S, Qm, KV]`` (bool): query node i of
        sequence s sees slot k when ``k < seen`` (committed) or when ``k =
        seen + j`` for a node j on i's ancestor-or-self path; with a sliding
        window, also only when k's logical position (k for a committed slot,
        ``seen + depth[j]`` for a node) lies inside the window of i's
        (``seen + depth[i]``). ``Qm`` is the largest tree in the batch."""
        S, MB = seq_meta.shape[0], seq_meta.shape[1] - 4
        KV = MB * self._state_manager.kv_block_size
        seen, ntok = seq_meta[:, 0], seq_meta[:, 1]
        n_seqs = int((seq_meta[:, 3] > 0).sum())
        Qm = max(1, int(ntok[:n_seqs].max()) if n_seqs else 1)
        visible = np.zeros((S, Qm, KV), bool)
        window = self.attention_window
        cursor = 0
        for s in range(n_seqs):
            nodes, sn = int(ntok[s]), int(seen[s])
            parents = tree_meta[0, cursor:cursor + nodes]
            depths = tree_meta[1, cursor:cursor + nodes]
            cursor += nodes
            anc = np.eye(nodes, dtype=bool)
            for i in range(1, nodes):  # topological: the parent's row is done
                anc[i] |= anc[parents[i]]
            visible[s, :nodes, :sn] = True
            visible[s, :nodes, sn:sn + nodes] = anc
            if window > 0:
                kv_log = np.arange(KV)
                kv_log[sn:sn + nodes] = sn + depths
                q_log = sn + depths
                visible[s, :nodes] &= kv_log[None, :] > q_log[:, None] - window
        return visible, Qm

    # ---------------------------------------------------------- kv compaction --
    @torch.no_grad()
    def compact_kv(self, seq_desc: DSSequenceDescriptor, src_slots, dst_slots) -> None:
        """Copy KV at ``src_slots`` to ``dst_slots`` (absolute token slots of
        ``seq_desc``) across every layer and both K/V in one gather-then-
        scatter: the tree-verify accepted-path re-pack (accepted nodes sit at
        scattered slots ``seen0 + node`` and must land at contiguous ``seen0 +
        1..m`` before the rejected tail is truncated). The gather copies into
        a new tensor before the scatter, so overlapping source and
        destination pairs are safe."""
        src = np.asarray(src_slots, np.int64).reshape(-1)
        dst = np.asarray(dst_slots, np.int64).reshape(-1)
        if src.size != dst.size:
            raise ValueError("compact_kv needs matching src/dst slot lists")
        if src.size == 0:
            return
        bs = self._state_manager.kv_block_size
        blocks = seq_desc.kv_blocks
        cache = self._state_manager.kv_cache.cache
        idx = torch.from_numpy(np.stack([blocks[src // bs], src % bs, blocks[dst // bs], dst % bs])).to(self._device)
        # advanced indices on axes 2 (block) and 4 (offset) put the pair axis
        # first: vals[p, layer, k/v, head, d]
        vals = cache[:, :, idx[0], :, idx[1]]
        cache[:, :, idx[2], :, idx[3]] = vals

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
        token_pos = batch["token_pos"].long()
        self._scatter_kv(k_new, v_new, cache, li, batch, token_pos)
        S, MB = batch["block_table"].shape
        KV = MB * cache.shape[4]
        seq_seen = batch["seq_seen"].long()
        Qm = max(1, T)  # dense q rows per sequence, bounded by T
        kv_pos = torch.arange(KV, device=q.device)[None, None, None, :]
        q_pos = (seq_seen[:, None] + torch.arange(Qm, device=q.device)[None, :])[:, None, :, None]
        valid_kv = kv_pos <= q_pos  # causal incl. self
        seq_len = (seq_seen + batch["seq_ntok"].long())[:, None, None, None]
        valid_kv = valid_kv & (kv_pos < seq_len)
        if self.attention_window > 0:  # mistral sliding window
            valid_kv = valid_kv & (kv_pos > q_pos - self.attention_window)
        local_q = (token_pos - seq_seen[batch["token_seq"].long()]).clamp(0, Qm - 1)
        return self._dense_attention(q, cache, li, batch, local_q, Qm, valid_kv), cache

    def _tree_paged_attention(self, q, k_new, v_new, cache, li, *, batch, slot_pos, visible, Qm):
        """Tree attention over the paged cache: the new K/V land at the slot
        positions (``seen + node``, distinct per node), while
        ``batch["token_pos"]`` carries the logical positions RoPE consumed;
        each query node attends the shared history under ``visible``
        (:meth:`_tree_visibility`)."""
        slot_pos = slot_pos.long()
        self._scatter_kv(k_new, v_new, cache, li, batch, slot_pos)
        local_q = (slot_pos - batch["seq_seen"].long()[batch["token_seq"].long()]).clamp(0, Qm - 1)
        return self._dense_attention(q, cache, li, batch, local_q, Qm, visible[:, None]), cache

    def _scatter_kv(self, k_new, v_new, cache, li, batch, pos):
        """Write the new K/V at each valid token's position ``pos``. The JAX
        package routes padding tokens and -1 table slots to block NB and lets
        XLA's scatter drop them; torch raises on NB and wraps -1, so the
        writes are masked instead. The valid tokens are the first n (a host
        count, so no device sync), and each has its block allocated before
        the forward (maybe_allocate_kv)."""
        bs = cache.shape[4]
        n = batch["n_tokens"]
        table = batch["block_table"].long()
        blk_ids = table[batch["token_seq"][:n].long(), pos[:n] // bs]
        offs = pos[:n] % bs
        cache[li, 0][blk_ids, :, offs] = k_new[:n].to(cache.dtype)
        cache[li, 1][blk_ids, :, offs] = v_new[:n].to(cache.dtype)

    def _dense_attention(self, q, cache, li, batch, local_q, Qm, valid_kv):
        """The gather branch's attention: densify each sequence's history
        ``[S, KV, H, D]`` and its queries ``[S, Qm, H, D]`` (query token t at
        row ``local_q[t]``), score under ``valid_kv`` (broadcast to ``[S, H,
        Qm, KV]``), and return token-major ``[T, H, D]``."""
        S, MB = batch["block_table"].shape
        bs = cache.shape[4]
        H, D, KVH = self.num_heads, self.head_dim, self.num_kv_heads
        token_seq = batch["token_seq"].long()
        token_valid = batch["token_valid"]
        n = batch["n_tokens"]

        # --- gather per-sequence history -------------------------------------
        hist = batch["block_table"].long().clamp(min=0)  # [S, MB]
        KV = MB * bs
        k_hist = cache[li, 0][hist].permute(0, 2, 1, 3, 4).reshape(S, KVH, KV, D).transpose(1, 2).to(q.dtype)
        v_hist = cache[li, 1][hist].permute(0, 2, 1, 3, 4).reshape(S, KVH, KV, D).transpose(1, 2).to(q.dtype)
        if KVH != H:  # GQA
            k_hist = k_hist.repeat_interleave(H // KVH, dim=2)
            v_hist = v_hist.repeat_interleave(H // KVH, dim=2)

        # --- densify queries per sequence ------------------------------------
        q_dense = q.new_zeros((S, Qm, H, D))
        q_dense[token_seq[:n], local_q[:n]] = q[:n]

        logits = torch.einsum("sqhd,skhd->shqk", q_dense, k_hist).float() * (1.0 / math.sqrt(D))
        logits = logits.masked_fill(~valid_kv, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out_dense = torch.einsum("shqk,skhd->sqhd", probs, v_hist)

        # --- back to token-major ---------------------------------------------
        out = out_dense[token_seq, local_q]  # [T, H, D]
        return out.masked_fill(~token_valid[:, None, None], 0.0)

    # Subclass hooks -----------------------------------------------------------
    def embed(self, ids):
        raise NotImplementedError

    def layer_forward(self, li, x, cache, attn_fn, batch):
        raise NotImplementedError

    def unembed(self, x):
        raise NotImplementedError


# uniforms are clamped into the open interval: -log(-log(u)) is finite on it
_U_MIN, _U_MAX = 1e-20, 1.0 - 2.0**-24


def sample_categorical(logits: torch.Tensor, temperature: float, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` ``[R, V]`` from
    ``softmax(logits / max(temperature, 1e-6))``, on the logits' device with
    no host sync: the Gumbel-max trick, ``argmax(logits / T + G)`` with ``G =
    -log(-log(U))`` and ``U`` uniform from ``generator``. Returns int32
    ``[R]``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(_U_MIN, _U_MAX)))
    return torch.argmax(logits.float() / max(float(temperature), 1e-6) + gumbel, dim=-1).to(torch.int32)


def _check_generator(generator, device: torch.device) -> None:
    if generator is None:
        raise ValueError("decode_loop(temperature>0) requires a torch.Generator (generator=...) on the "
                         "engine's device: a fixed default would return identical 'samples' every call")
    gdev = torch.device(generator.device)
    if gdev.type != device.type or (device.index is not None and gdev.index not in (None, device.index)):
        raise ValueError(f"the generator lives on {gdev}; decode_loop samples on {device}")
