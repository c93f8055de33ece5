"""Llama ragged inference model.

Port of ``deepspeed_tpu/inference/v2/model_implementations/llama_v2.py``: per
layer, RMSNorm → q/k/v projections → RoPE at each token's absolute position
→ paged attention → output projection, then RMSNorm → SwiGLU, over the
ragged batch. Weights are the ``state_dict``-keyed dict of
``models/llama.py`` (``models/convert.py`` builds it from a flax tree). The
traced layer records the attention and the SwiGLU phases apart.

Under tensor parallelism (``tensor_parallel.tp_size``) the weights are this
rank's (``engine_factory.serving_tp_slice``): ``H/tp`` query and ``KVH/tp`` KV
heads, so the KV cache and B1 run on the local heads, and a slice of the
MLP's columns; ``o_proj`` and ``down_proj`` are each followed by one
all-reduce over the ``model`` group (``module_inject.layers``'
row-parallel reduction: 16-bit partial sums summed in f32),
and the embedding and the unembedding stay whole.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.transformer_base import DSTransformerModelBase
from deepspeed_tpu_torch.inference.v2.tracer import record
from deepspeed_tpu_torch.models.llama import LlamaConfig, rms_norm, rotary_embedding
from deepspeed_tpu_torch.module_inject.layers import reduce_from_model_parallel


def _rotary_at(x, pos, cos_tab, sin_tab):
    """x: [T, H, D] with per-token absolute positions [T]; rotation on split
    halves, tables in f32."""
    cos = cos_tab[pos][:, None, :]  # [T, 1, D/2]
    sin = sin_tab[pos][:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaV2Model(DSTransformerModelBase):

    def __init__(self, params, config: LlamaConfig, engine_config, device, state_manager=None):
        super().__init__(params, config, engine_config, device, state_manager)
        self._tp = engine_config.tensor_parallel.tp_size
        self._tp_group = None
        if self._tp > 1:
            from deepspeed_tpu_torch.utils import groups
            if config.num_attention_heads % self._tp or config.num_key_value_heads % self._tp:
                raise ValueError(f"tensor parallelism over {self._tp} ranks needs the query heads "
                                 f"({config.num_attention_heads}) and KV heads ({config.num_key_value_heads}) "
                                 "to divide over them")
            self._tp_group = groups.get_group(groups.MODEL_AXIS)
        self._cos, self._sin = rotary_embedding(engine_config.state_manager.max_context, self.head_dim,
                                                config.rope_theta, torch.float32, self.device)

    @property
    def num_layers(self):
        return self._config.num_hidden_layers

    @property
    def num_heads(self):
        """The query heads this rank holds."""
        return self._config.num_attention_heads // self._tp

    @property
    def num_kv_heads(self):
        return self._config.num_key_value_heads // self._tp

    @property
    def head_dim(self):
        return self._config.hidden_size // self._config.num_attention_heads

    def _row(self, h, weight, bias=None):
        """A row-parallel product: the ranks' partial sums all-reduced, then
        the bias once."""
        y = F.linear(h, weight)
        if self._tp_group is not None:
            y = reduce_from_model_parallel(y, self._tp_group)
        return y if bias is None else y + bias

    @property
    def vocab_size(self):
        return self._config.vocab_size

    @property
    def attention_window(self):
        """Sliding attention window (mistral); 0 = full causal."""
        return self._config.sliding_window or 0

    # --------------------------------------------------------------- phases --
    def embed(self, ids):
        return F.embedding(ids.long(), self._params["embed_tokens.weight"])

    def unembed(self, x):
        p = self._params
        x = rms_norm(x, p["norm.weight"], self._config.rms_norm_eps)
        return F.linear(x, p["lm_head.weight"])

    def _attn_phase(self, li, x, cache, attn_fn, batch):
        p, pre = self._params, f"layers.{li}."
        H, KVH, D = self.num_heads, self.num_kv_heads, self.head_dim
        h = rms_norm(x, p[pre + "input_layernorm.weight"], self._config.rms_norm_eps)

        def lin(name, width):  # qwen2-style optional q/k/v biases
            w = pre + f"self_attn.{name}."
            return F.linear(h, p[w + "weight"], p.get(w + "bias")).reshape(-1, width, D)

        pos = batch["token_pos"].long()
        q = _rotary_at(lin("q_proj", H), pos, self._cos, self._sin)
        k = _rotary_at(lin("k_proj", KVH), pos, self._cos, self._sin)
        v = lin("v_proj", KVH)
        out, cache = attn_fn(q, k, v, cache, li)
        o = pre + "self_attn.o_proj."
        return x + self._row(out.reshape(x.shape[0], H * D), p[o + "weight"], p.get(o + "bias")), cache

    def _ffn_phase(self, li, x, batch=None):
        p, pre = self._params, f"layers.{li}."
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], self._config.rms_norm_eps)
        gate = F.linear(h, p[pre + "mlp.gate_proj.weight"])
        up = F.linear(h, p[pre + "mlp.up_proj.weight"])
        return x + self._row(F.silu(gate) * up, p[pre + "mlp.down_proj.weight"])

    def layer_forward(self, li, x, cache, attn_fn, batch):
        x, cache = self._attn_phase(li, x, cache, attn_fn, batch)
        return self._ffn_phase(li, x, batch=batch), cache

    def layer_forward_traced(self, li, x, cache, attn_fn, batch):
        with record("attn"):
            x, cache = self._attn_phase(li, x, cache, attn_fn, batch)
        with record("ffn"):
            x = self._ffn_phase(li, x, batch=batch)
        return x, cache


class MistralV2Model(LlamaV2Model):
    """Llama architecture + sliding-window attention (gather branch)."""


class Qwen2V2Model(LlamaV2Model):
    """Llama architecture + q/k/v projection biases."""
