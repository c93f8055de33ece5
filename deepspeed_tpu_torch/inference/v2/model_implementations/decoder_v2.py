"""Ragged inference for the decoder family (OPT / Falcon / Phi / GPT-J / GPT-NeoX).

Port of ``deepspeed_tpu/inference/v2/model_implementations/decoder_v2.py``:
one implementation parameterized as ``models/decoder.py`` is (learned
positions with OPT's +2 offset, partial and interleaved rotary, serial and
parallel residuals with NeoX's second norm, GPT-J's biased ``lm_head``,
LayerNorm in f32), over the ragged batch and the paged KV cache: decode
buckets of at most 32 tokens run B1 (``ops/paged_attention.py``) at the
model's head shape (Falcon-7B: 71 query heads over one KV head of 64; Phi-2:
head_dim 80), and prefill the gather branch. Weights are the
``state_dict``-keyed dict of ``models/decoder.py``. The traced layer
records the attention and the MLP phases apart.

Refused before the base class is built (it may quantize the tree first):
ALiBi and Bloom's post-embedding LayerNorm, as the reference refuses them,
and (C23) GPT-Neo's unscaled scores and local attention layers, which the
paged attention paths do not compute: the reference serves them with
wrong logits. Tensor parallelism of this family is not ported.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.transformer_base import DSTransformerModelBase
from deepspeed_tpu_torch.inference.v2.tracer import record
from deepspeed_tpu_torch.models.decoder import DecoderConfig, act
from deepspeed_tpu_torch.models.llama import rotary_embedding


def _ln(x, p, name, eps):
    """LayerNorm in f32, returned in ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu)**2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p[name + ".weight"].float() + p[name + ".bias"].float()).to(x.dtype)


def _linear(h, p, name):
    bias = p.get(name + ".bias")
    return F.linear(h, p[name + ".weight"].to(h.dtype), None if bias is None else bias.to(h.dtype))


def _rotary_at_partial(x, pos, cos_tab, sin_tab, pct, interleaved=False):
    """x ``[T, H, D]`` at per-token absolute positions ``pos [T]``: rotate the
    first ``round(D · pct)`` (even) values of each head, split halves
    (llama/neox) or adjacent pairs (gptj), and pass the rest through."""
    if pct <= 0.0:
        return x
    rot = int(round(x.shape[-1] * pct)) // 2 * 2
    cos = cos_tab[pos][:, None, :]
    sin = sin_tab[pos][:, None, :]
    xr = x[..., :rot]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr.chunk(2, dim=-1)
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


class DecoderV2Model(DSTransformerModelBase):

    def __init__(self, params, config: DecoderConfig, engine_config, device, state_manager=None):
        # before the base class: it may quantize the whole tree first
        if config.pos_embed == "alibi" or config.embed_layernorm:
            raise NotImplementedError(f"inference-v2 DecoderV2Model does not serve {config.model_type!r}: ALiBi "
                                      "biases are not implemented in the paged attention paths")
        if not config.attention_scaled or "local" in (config.attention_layers or ()):
            raise NotImplementedError(
                f"inference-v2 DecoderV2Model does not serve {config.model_type!r} (C23): the paged attention "
                "paths scale every score by 1/sqrt(head_dim) and apply no per-layer local window, so GPT-Neo's "
                "unscaled scores and local layers would give wrong logits (the reference serves them so)")
        if engine_config.tensor_parallel.tp_size > 1:
            raise NotImplementedError("tensor parallelism of the decoder family (OPT/Falcon/Phi/GPT-J/NeoX) is not "
                                      "ported to deepspeed_tpu_torch yet (see ROADMAP.md A9)")
        super().__init__(params, config, engine_config, device, state_manager)
        if config.pos_embed == "rotary":
            self._cos, self._sin = rotary_embedding(engine_config.state_manager.max_context, config.rotary_dim,
                                                    config.rope_theta, torch.float32, self.device)

    @property
    def num_layers(self):
        return self._config.num_hidden_layers

    @property
    def num_heads(self):
        return self._config.num_attention_heads

    @property
    def num_kv_heads(self):
        return self._config.num_key_value_heads

    @property
    def head_dim(self):
        return self._config.head_dim

    @property
    def vocab_size(self):
        return self._config.vocab_size

    # --------------------------------------------------------------- phases --
    def embed(self, ids):
        return F.embedding(ids.long(), self._params["embed_tokens.weight"])

    def _add_positions(self, x, batch):
        cfg = self._config
        if cfg.pos_embed != "learned":
            return x
        pos = batch["token_pos"].long() + cfg.learned_pos_offset
        return x + F.embedding(pos, self._params["embed_positions.weight"]).to(x.dtype)

    def unembed(self, x):
        x = _ln(x, self._params, "final_layer_norm", self._config.layer_norm_eps)
        return _linear(x, self._params, "lm_head")

    def _norms(self, li, x):
        """The attention's input and the MLP's input of a parallel block
        (NeoX norms them apart; Falcon, Phi and GPT-J share one norm)."""
        cfg, pre = self._config, f"layers.{li}."
        h = _ln(x, self._params, pre + "input_layernorm", cfg.layer_norm_eps)
        if cfg.parallel_residual and cfg.parallel_mlp_norm:
            return h, _ln(x, self._params, pre + "post_attention_layernorm", cfg.layer_norm_eps)
        return h, h

    def _attn(self, li, h, cache, attn_fn, batch):
        cfg, p, pre = self._config, self._params, f"layers.{li}.self_attn."
        H, KVH, D = self.num_heads, self.num_kv_heads, self.head_dim
        q = _linear(h, p, pre + "q_proj").reshape(-1, H, D)
        k = _linear(h, p, pre + "k_proj").reshape(-1, KVH, D)
        v = _linear(h, p, pre + "v_proj").reshape(-1, KVH, D)
        if cfg.pos_embed == "rotary":
            pos = batch["token_pos"].long()
            q = _rotary_at_partial(q, pos, self._cos, self._sin, cfg.rotary_pct, cfg.rotary_interleaved)
            k = _rotary_at_partial(k, pos, self._cos, self._sin, cfg.rotary_pct, cfg.rotary_interleaved)
        out, cache = attn_fn(q, k, v, cache, li)
        return _linear(out.reshape(h.shape[0], H * D), p, pre + "out_proj"), cache

    def _mlp(self, li, h):
        p, pre = self._params, f"layers.{li}.mlp."
        return _linear(act(self._config)(_linear(h, p, pre + "fc1")), p, pre + "fc2")

    def _attn_phase(self, li, x, cache, attn_fn, batch):
        """``(x, attention output, the MLP's input, cache)``: a serial block
        adds the attention to the residual here, a parallel one later."""
        if li == 0:
            x = self._add_positions(x, batch)
        h, hm = self._norms(li, x)
        attn_out, cache = self._attn(li, h, cache, attn_fn, batch)
        return x, attn_out, hm, cache

    def _ffn_phase(self, li, x, attn_out, hm):
        cfg = self._config
        if cfg.parallel_residual:
            return x + attn_out + self._mlp(li, hm)
        x = x + attn_out
        return x + self._mlp(li, _ln(x, self._params, f"layers.{li}.post_attention_layernorm", cfg.layer_norm_eps))

    def layer_forward(self, li, x, cache, attn_fn, batch):
        x, attn_out, hm, cache = self._attn_phase(li, x, cache, attn_fn, batch)
        return self._ffn_phase(li, x, attn_out, hm), cache

    def layer_forward_traced(self, li, x, cache, attn_fn, batch):
        with record("attn"):
            x, attn_out, hm, cache = self._attn_phase(li, x, cache, attn_fn, batch)
        with record("ffn"):
            x = self._ffn_phase(li, x, attn_out, hm)
        return x, cache
