"""Mixtral-style MoE causal LM.

Port of ``deepspeed_tpu/models/mixtral.py``: the Llama attention and norms
around a top-2 :class:`~deepspeed_tpu_torch.moe.layer.MoE` of SwiGLU experts
(the gate and up projections fused into one ``wi`` bank). The loss is the
cross-entropy plus ``aux_loss_weight`` times the sum of the routers'
auxiliary losses; each block is recomputed in the backward when ``remat``
is on, as ``models/llama.py`` does. Mixtral's attention is
``LlamaAttention(cfg.as_llama())``, which leaves ``use_flash_attention``
off, as the reference does, so training it launches no hand-written kernel.

``state_dict`` keys: ``embed_tokens.weight``,
``layers.{i}.{input_layernorm,post_attention_layernorm}.weight``,
``layers.{i}.self_attn.{q,k,v,o}_proj.weight``,
``layers.{i}.block_sparse_moe.gate`` ``[M, E]``,
``layers.{i}.block_sparse_moe.experts.{wi,wo}``, ``norm.weight`` and
``lm_head.weight``; ``models/convert.py`` maps them onto the flax tree
(``block_sparse_moe.ExpertFFN_0`` holds the banks there). The same keys
feed the ragged serving model (``inference/v2/model_implementations/
mixtral_v2.py``).
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.llama import (INIT_STD, LlamaAttention, LlamaConfig, RMSNorm, cross_entropy_loss,
                                              rotary_embedding)
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import remat
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    gated_experts: bool = True  # Mixtral experts are SwiGLU (HF w1/w3 fused)
    model_type: str = "mixtral"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                    max_position_embeddings=128, remat=False)
        base.update(kw)
        return MixtralConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw):
        """Mixtral-8x7B's published widths (the defaults)."""
        return MixtralConfig(**kw)

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                           intermediate_size=self.intermediate_size, num_hidden_layers=self.num_hidden_layers,
                           num_attention_heads=self.num_attention_heads,
                           num_key_value_heads=self.num_key_value_heads,
                           max_position_embeddings=self.max_position_embeddings, rms_norm_eps=self.rms_norm_eps,
                           rope_theta=self.rope_theta, dtype=self.dtype, remat=False)


class MixtralBlock(nn.Module):

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg.as_llama())
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.block_sparse_moe = MoE(hidden_size=cfg.hidden_size, num_experts=cfg.num_local_experts,
                                    ffn_hidden_size=cfg.intermediate_size, k=cfg.num_experts_per_tok,
                                    capacity_factor=cfg.capacity_factor, activation=F.silu,
                                    gated=cfg.gated_experts)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        # the reference calls its MoE in training mode always (training
        # capacity in evaluation too); its noise follows the gating seed
        moe_out, l_aux, _ = self.block_sparse_moe(self.post_attention_layernorm(x), training=True)
        return x + moe_out, l_aux


class MixtralModel(nn.Module):
    """``input_ids [B, S]`` → ``(logits [B, S, V], sum of the routers' aux
    losses)``."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MixtralBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, input_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        cos, sin = rotary_embedding(input_ids.shape[1], cfg.head_dim, cfg.rope_theta, device=input_ids.device)
        recompute = cfg.remat and torch.is_grad_enabled()
        total_aux = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        for block in self.layers:
            x, l_aux = remat(block, x, cos, sin) if recompute else block(x, cos, sin)
            total_aux = total_aux + l_aux
        return self.lm_head(self.norm(x)), total_aux


class MixtralForCausalLM(MixtralModel):
    """Loss module: ``batch = (input_ids, labels)``; -100 labels are masked.
    Loss = CE + ``aux_loss_weight`` × Σ l_aux."""

    def __init__(self, cfg: MixtralConfig, aux_loss_weight: float = 0.01):
        super().__init__(cfg)
        self.aux_loss_weight = aux_loss_weight

    def forward(self, batch):
        input_ids, labels = batch
        logits, total_aux = super().forward(input_ids)
        return cross_entropy_loss(logits, labels) + self.aux_loss_weight * total_aux


def param_shapes(cfg: MixtralConfig) -> dict:
    """``state_dict`` key → shape of :class:`MixtralModel`, without building it."""
    H, KVH, D, hid, ffn, E = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size,
                              cfg.intermediate_size, cfg.num_local_experts)
    wi = 2 * ffn if cfg.gated_experts else ffn
    shapes = {"embed_tokens.weight": (cfg.vocab_size, hid)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        shapes[p + "input_layernorm.weight"] = (hid, )
        for name, out in (("q_proj", H * D), ("k_proj", KVH * D), ("v_proj", KVH * D)):
            shapes[p + f"self_attn.{name}.weight"] = (out, hid)
        shapes[p + "self_attn.o_proj.weight"] = (hid, H * D)
        shapes[p + "post_attention_layernorm.weight"] = (hid, )
        shapes[p + "block_sparse_moe.gate"] = (hid, E)
        shapes[p + "block_sparse_moe.experts.wi"] = (E, hid, wi)
        shapes[p + "block_sparse_moe.experts.wo"] = (E, ffn, hid)
    shapes["norm.weight"] = (hid, )
    shapes["lm_head.weight"] = (cfg.vocab_size, hid)
    return shapes


def is_expert_bank(name: str) -> bool:
    return name.endswith(".experts.wi") or name.endswith(".experts.wo")


def init_params(cfg: MixtralConfig, generator: torch.Generator = None, device=None, dtype=None,
                experts: Optional[Tuple[int, int]] = None) -> dict:
    """Random weights as a ``state_dict``-keyed dict, as
    ``models/llama.py::init_params`` draws them: norm weights ones, every
    other tensor normal with standard deviation ``INIT_STD``, in key order
    from ``generator`` (seed 0 on ``device`` when not given). ``experts=(lo,
    hi)`` keeps only experts ``lo..hi-1`` of each bank, drawn as the whole
    bank is drawn, so that an expert-parallel rank holds exactly its slice of
    the weights a whole model draws from the same seed."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            params[name] = torch.ones(shape, device=device, dtype=dtype)
            continue
        t = torch.empty(shape, device=device, dtype=dtype).normal_(0.0, INIT_STD, generator=generator)
        if experts is not None and is_expert_bank(name):
            t = t[experts[0]:experts[1]].clone()
        params[name] = t
    return params
