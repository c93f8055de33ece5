"""Configurable decoder family: OPT / Falcon / Phi / GPT-NeoX / GPT-J / GPT-Neo / Bloom.

Port of ``deepspeed_tpu/models/decoder.py``: one decoder parameterized by

- position encoding: learned embeddings (OPT, with its +2 offset; GPT-Neo),
  rotary (Falcon, Phi, NeoX: split halves, optionally partial,
  ``rotary_pct``; GPT-J: interleaved pairs) or ALiBi (Bloom);
- residual topology: serial (OPT, GPT-Neo, Bloom) or parallel attention +
  MLP off one norm (Falcon, Phi, GPT-J) or two (NeoX);
- LayerNorm with bias; relu, tanh-gelu or exact gelu;
- MHA or MQA/GQA (Falcon-7B: one KV head), biases on or off per linear;
- GPT-Neo's unscaled scores and alternating global/local (sliding window)
  layers, Bloom's post-embedding LayerNorm, GPT-J's biased ``lm_head``.

``DecoderConfig.{opt,falcon,phi,gpt_neox,gptj,gpt_neo,bloom}`` build the
variants and ``tiny`` a small one. Module and parameter names follow the
flax tree (``layers.{i}.self_attn.q_proj.weight`` where flax has
``layers_{i}/self_attn/q_proj/kernel``, a LayerNorm's ``weight`` where flax
has ``scale``); ``models/convert.py`` maps one onto the other
(``decoder_from_flax`` / ``decoder_to_flax``). The ragged serving model is
``inference/v2/model_implementations/decoder_v2.py``.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.llama import INIT_STD, apply_rotary, cross_entropy_loss, rotary_embedding
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 1e4
    rotary_pct: float = 1.0  # fraction of head_dim that rotates (phi, neox, gptj)
    pos_embed: str = "rotary"  # "rotary" | "learned" | "alibi"
    learned_pos_offset: int = 0  # OPT's +2
    parallel_residual: bool = False  # falcon/phi/neox/gptj topology
    activation: str = "gelu"  # "gelu" (tanh) | "gelu_exact" | "relu"
    attention_bias: bool = True
    mlp_bias: bool = True
    embed_layernorm: bool = False  # bloom's word_embeddings_layernorm
    parallel_mlp_norm: bool = False  # neox: a second norm for the parallel MLP
    rotary_interleaved: bool = False  # gptj: adjacent-pair rotation
    lm_head_bias: bool = False  # gptj's biased lm_head
    # gpt-neo: unbiased q/k/v with a biased out_proj (None: follow
    # attention_bias), unscaled scores, alternating global/local layers
    attention_out_bias: Optional[bool] = None
    attention_scaled: bool = True
    attention_layers: Optional[tuple] = None  # "global" | "local" per layer
    window_size: int = 256  # a local layer's window
    model_type: str = "decoder"
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        """The rotated width of a head: ``round(head_dim · rotary_pct)``,
        even (the checkpoint's integer ``rotary_dim`` comes back whole)."""
        return int(round(self.head_dim * self.rotary_pct)) // 2 * 2

    @property
    def out_bias(self) -> bool:
        return self.attention_bias if self.attention_out_bias is None else self.attention_out_bias

    # -- the variants -----------------------------------------------------
    @classmethod
    def opt(cls, **kw):
        base = dict(pos_embed="learned", learned_pos_offset=2, parallel_residual=False, activation="relu",
                    attention_bias=True, mlp_bias=True, model_type="opt")
        base.update(kw)
        return cls(**base)

    @classmethod
    def falcon(cls, **kw):
        base = dict(pos_embed="rotary", parallel_residual=True, activation="gelu", attention_bias=False,
                    mlp_bias=False, num_key_value_heads=1, model_type="falcon")
        base.update(kw)
        return cls(**base)

    @classmethod
    def phi(cls, **kw):
        base = dict(pos_embed="rotary", rotary_pct=0.5, parallel_residual=True, activation="gelu",
                    attention_bias=True, mlp_bias=True, model_type="phi")
        base.update(kw)
        return cls(**base)

    @classmethod
    def gpt_neox(cls, **kw):
        base = dict(pos_embed="rotary", rotary_pct=0.25, parallel_residual=True, parallel_mlp_norm=True,
                    activation="gelu_exact", attention_bias=True, mlp_bias=True, model_type="gpt_neox")
        base.update(kw)
        return cls(**base)

    @classmethod
    def gptj(cls, **kw):
        base = dict(pos_embed="rotary", rotary_interleaved=True, parallel_residual=True, activation="gelu",
                    attention_bias=False, mlp_bias=True, lm_head_bias=True, model_type="gptj")
        base.update(kw)
        return cls(**base)

    @classmethod
    def gpt_neo(cls, **kw):
        base = dict(pos_embed="learned", learned_pos_offset=0, parallel_residual=False, activation="gelu",
                    attention_bias=False, attention_out_bias=True, attention_scaled=False, model_type="gpt_neo")
        base.update(kw)
        return cls(**base)

    @classmethod
    def bloom(cls, **kw):
        base = dict(pos_embed="alibi", parallel_residual=False, activation="gelu", attention_bias=True,
                    mlp_bias=True, embed_layernorm=True, model_type="bloom")
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, variant="opt", **kw):
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128)
        if variant == "falcon":
            base["num_key_value_heads"] = 1
        base.update(kw)
        return getattr(cls, variant)(**base)


def act(cfg: DecoderConfig):
    """The MLP's activation; an unknown name raises."""
    return {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "gelu_exact": F.gelu}[cfg.activation]


def alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi's per-head slopes, as HF Bloom's ``build_alibi_tensor`` makes
    them."""
    closest = 2**int(np.floor(np.log2(num_heads)))
    base = 2.0**(-(2.0**-(np.log2(closest) - 3)))
    slopes = base**np.arange(1, closest + 1)
    if closest != num_heads:
        extra_base = 2.0**(-(2.0**-(np.log2(2 * closest) - 3)))
        extra = extra_base**np.arange(1, 2 * (num_heads - closest), 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def apply_rotary_interleaved(x, cos, sin):
    """GPT-J's rotary: adjacent (even, odd) pairs rotate together (HF
    ``rotate_every_two``); x ``[B, S, H, D]``, tables ``[S, D/2]``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape).to(x.dtype)


def partial_rotary(x, cos, sin, pct, interleaved=False):
    """Rotate the first ``round(D · pct)`` (even) of each head's ``D``
    values; pass the rest through."""
    rot_fn = apply_rotary_interleaved if interleaved else apply_rotary
    if pct >= 1.0:
        return rot_fn(x, cos, sin)
    rot = int(round(x.shape[-1] * pct)) // 2 * 2
    return torch.cat([rot_fn(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


class DecoderAttention(nn.Module):

    def __init__(self, cfg: DecoderConfig, attn_type: str = "global"):
        super().__init__()
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.cfg, self.attn_type = cfg, attn_type
        self.q_proj = nn.Linear(cfg.hidden_size, H * D, bias=cfg.attention_bias)
        self.k_proj = nn.Linear(cfg.hidden_size, KVH * D, bias=cfg.attention_bias)
        self.v_proj = nn.Linear(cfg.hidden_size, KVH * D, bias=cfg.attention_bias)
        self.out_proj = nn.Linear(H * D, cfg.hidden_size, bias=cfg.out_bias)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(x).reshape(*x.shape[:-1], H, D)
        k = self.k_proj(x).reshape(*x.shape[:-1], KVH, D)
        v = self.v_proj(x).reshape(*x.shape[:-1], KVH, D)
        if cfg.pos_embed == "rotary":
            q = partial_rotary(q, cos, sin, cfg.rotary_pct, cfg.rotary_interleaved)
            k = partial_rotary(k, cos, sin, cfg.rotary_pct, cfg.rotary_interleaved)
        if KVH != H:
            k = k.repeat_interleave(H // KVH, dim=2)
            v = v.repeat_interleave(H // KVH, dim=2)
        S = x.shape[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if cfg.attention_scaled:
            logits = logits / np.sqrt(D)
        pos = torch.arange(S, device=x.device)
        if cfg.pos_embed == "alibi":
            slopes = torch.from_numpy(alibi_slopes(H)).to(x.device)
            rel = (pos[None, :] - pos[:, None]).float()  # k - q (<= 0 where causal)
            logits = logits + slopes[None, :, None, None] * rel[None, None]
        mask = pos[None, :] <= pos[:, None]
        if self.attn_type == "local":  # gpt-neo's window: q - window < k <= q
            mask = mask & (pos[:, None] - pos[None, :] < cfg.window_size)
        logits = torch.where(mask[None, None], logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(*x.shape[:-1], H * D)
        return self.out_proj(out)


class DecoderMLP(nn.Module):

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.act = act(cfg)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=cfg.mlp_bias)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=cfg.mlp_bias)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class DecoderBlock(nn.Module):

    def __init__(self, cfg: DecoderConfig, attn_type: str = "global"):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = DecoderAttention(cfg, attn_type)
        if not cfg.parallel_residual or cfg.parallel_mlp_norm:
            self.post_attention_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = DecoderMLP(cfg)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        h = self.input_layernorm(x)
        if cfg.parallel_residual:
            # neox norms the MLP's input apart; falcon/phi/gptj share one norm
            hm = self.post_attention_layernorm(x) if cfg.parallel_mlp_norm else h
            return x + self.self_attn(h, cos, sin) + self.mlp(hm)
        x = x + self.self_attn(h, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DecoderModel(nn.Module):
    """``input_ids [B, S]`` → logits ``[B, S, V]`` in the parameters' dtype."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.embed_layernorm:
            self.embed_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if cfg.pos_embed == "learned":
            self.embed_positions = nn.Embedding(cfg.max_position_embeddings + cfg.learned_pos_offset,
                                                cfg.hidden_size)
        kinds = cfg.attention_layers or ("global", ) * cfg.num_hidden_layers
        self.layers = nn.ModuleList(DecoderBlock(cfg, kinds[i]) for i in range(cfg.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=cfg.lm_head_bias)

    def forward(self, input_ids):
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        if cfg.embed_layernorm:
            x = self.embed_layernorm(x)
        S = input_ids.shape[1]
        cos = sin = None
        if cfg.pos_embed == "learned":
            pos = torch.arange(S, device=input_ids.device) + cfg.learned_pos_offset
            x = x + self.embed_positions(pos)
        elif cfg.pos_embed == "rotary":
            cos, sin = rotary_embedding(S, cfg.rotary_dim, cfg.rope_theta, device=input_ids.device)
        for block in self.layers:
            x = block(x, cos, sin)
        return self.lm_head(self.final_layer_norm(x))


class DecoderForCausalLM(DecoderModel):
    """Loss module: ``batch = (input_ids, labels)``; -100 labels are masked.
    Same parameters as :class:`DecoderModel`; the flax tree nests them
    under ``"model"``."""

    def forward(self, batch):
        input_ids, labels = batch
        return cross_entropy_loss(super().forward(input_ids), labels)


def param_shapes(cfg: DecoderConfig) -> dict:
    """``state_dict`` key → shape of :class:`DecoderModel`, without building it."""
    with torch.device("meta"):
        model = DecoderModel(cfg)
    return {name: tuple(p.shape) for name, p in model.state_dict().items()}


def init_params(cfg: DecoderConfig, generator: torch.Generator = None, device=None, dtype=None) -> dict:
    """Random weights for :class:`DecoderModel` as a ``state_dict``-keyed
    dict, as ``models/llama.py::init_params`` draws them: LayerNorm weights
    ones, biases zeros, every other tensor normal with standard deviation
    ``INIT_STD``, in key order from ``generator`` (seed 0 on ``device`` when
    not given). Generated where they will live."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif len(shape) == 1:  # a LayerNorm's weight
            params[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            params[name] = torch.empty(shape, device=device, dtype=dtype).normal_(0.0, INIT_STD, generator=generator)
    return params
