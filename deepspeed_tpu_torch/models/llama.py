"""Llama-family causal LM.

Port of ``deepspeed_tpu/models/llama.py``: RMSNorm, RoPE on split halves,
GQA, SwiGLU, optional q/k/v biases (qwen2), an output-projection bias
(internlm), a sliding attention window (mistral), flash attention
(``use_flash_attention``, the hand-written kernels of
``ops/flash_attention.py``), per-block rematerialization (``remat``,
``remat_policy``) and the training loss module :class:`LlamaForCausalLM`.
Module and parameter names follow the flax tree, so ``state_dict`` keys read
``layers.{i}.self_attn.q_proj.weight`` where flax has
``layers_{i}/self_attn/q_proj/kernel``; ``models/convert.py`` maps one onto
the other. ``sequence_parallel`` runs Ulysses (``sequence/layer.py``): the
batch's dim 1 is this rank's slice of the sequence, each attention runs
over the whole sequence at this rank's share of the heads, and RoPE is
taken at the slice's global positions. Under tensor parallelism
(``module_inject/layers.py``) the projections hold this rank's heads, so the
attention reshapes by the widths it is given.
"""

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import remat
from deepspeed_tpu_torch.sequence.layer import DistributedAttention
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "nothing": recompute the whole block in the backward; "dots": save the
    # projections' outputs and recompute the rest (attention included)
    remat_policy: str = "nothing"
    sequence_parallel: bool = False
    use_flash_attention: bool = False
    # llama-family deltas: qwen2 adds q/k/v biases; internlm biases the output
    # projection too; mistral masks beyond a sliding attention window
    attention_bias: bool = False
    attention_out_bias: bool = False
    sliding_window: int = 0  # 0 = disabled
    model_type: str = "llama"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                    remat=False)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)


def rms_norm(x, weight, eps):
    """Normalise in f32, scale by the f32 weight, return in x's dtype."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def rotary_embedding(seq_len, head_dim, theta=10000.0, dtype=torch.float32, device=None):
    """cos, sin tables ``[seq_len, head_dim // 2]``, computed in f32."""
    inv_freq = 1.0 / (theta**(torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x, cos, sin):
    """x: [B, S, H, D]; rotate split halves (x1, x2), the Llama convention."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def causal_attention(q, k, v, scale, window: int = 0):
    """Plain attention over [B, S, H, D]; ``window`` > 0 masks keys older than
    the sliding window (mistral)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if KVH != H:  # GQA: repeat kv heads
        rep = H // KVH
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_causal_attention(q, k, v, scale):
    return flash_attention(q, k, v, scale=scale, causal=True)


class LlamaAttention(nn.Module):

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.cfg = cfg
        self.q_proj = nn.Linear(cfg.hidden_size, H * D, bias=cfg.attention_bias)
        self.k_proj = nn.Linear(cfg.hidden_size, KVH * D, bias=cfg.attention_bias)
        self.v_proj = nn.Linear(cfg.hidden_size, KVH * D, bias=cfg.attention_bias)
        self.o_proj = nn.Linear(H * D, cfg.hidden_size, bias=cfg.attention_out_bias)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        D = cfg.head_dim
        # the heads this rank holds (all of them unless tensor-parallel)
        q = self.q_proj(x).reshape(*x.shape[:-1], -1, D)
        k = self.k_proj(x).reshape(*x.shape[:-1], -1, D)
        v = self.v_proj(x).reshape(*x.shape[:-1], -1, D)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        if cfg.use_flash_attention:
            assert cfg.sliding_window == 0, "flash path has no sliding-window mask yet"
            attn, kw = flash_causal_attention, {}
        else:
            attn, kw = causal_attention, {"window": cfg.sliding_window}
        if cfg.sequence_parallel:
            # Ulysses: all-to-all sequence -> heads around whole-sequence attention
            attn = DistributedAttention(attn)
        out = attn(q, k, v, scale=1.0 / (D**0.5), **kw)
        return self.o_proj(out.reshape(*x.shape[:-1], -1))


class LlamaMLP(nn.Module):

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """``input_ids [B, S]`` → logits ``[B, S, V]`` in the parameters' dtype."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def rope(self, seq_len, device):
        """cos, sin at this rank's positions: ``0..seq_len``, or under
        sequence parallelism the slice's global positions ``[r·S/sp,
        (r+1)·S/sp)`` of the whole sequence."""
        cfg = self.cfg
        if not cfg.sequence_parallel:
            return rotary_embedding(seq_len, cfg.head_dim, cfg.rope_theta, device=device)
        from deepspeed_tpu_torch.utils import groups
        g = groups.get_group(groups.SEQ_AXIS)
        cos, sin = rotary_embedding(seq_len * g.size, cfg.head_dim, cfg.rope_theta, device=device)
        return cos[g.rank * seq_len:(g.rank + 1) * seq_len], sin[g.rank * seq_len:(g.rank + 1) * seq_len]

    def forward(self, input_ids):
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope(input_ids.shape[1], input_ids.device)
        # activation recomputation keeps only block boundaries (and, under
        # "dots", the projections' outputs); nothing to save without autograd
        recompute = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            x = remat(block, x, cos, sin, policy=cfg.remat_policy) if recompute else block(x, cos, sin)
        return self.lm_head(self.norm(x))


class LlamaForCausalLM(LlamaModel):
    """Loss module: ``batch = (input_ids, labels)``; -100 labels are masked.
    Same parameters (and ``state_dict`` keys) as :class:`LlamaModel`; the
    flax tree nests them under ``"model"``."""

    def forward(self, batch):
        input_ids, labels = batch
        return cross_entropy_loss(super().forward(input_ids), labels)


class LlamaEmbedPipe(nn.Module):
    """The pipeline's first layer: token ids -> hidden states."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)

    def forward(self, input_ids):
        return self.embed_tokens(input_ids)


class LlamaBlockPipe(nn.Module):
    """One decoder block as a pipeline layer (its rotary tables made from
    the sequence length it is given; recomputed as ``LlamaModel`` does)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.block = LlamaBlock(cfg)

    def forward(self, x):
        cfg = self.cfg
        cos, sin = rotary_embedding(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
        if cfg.remat and torch.is_grad_enabled():
            return remat(self.block, x, cos, sin, policy=cfg.remat_policy)
        return self.block(x, cos, sin)


class LlamaHeadPipe(nn.Module):
    """The pipeline's last layer: the final norm and the unembedding."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def forward(self, x):
        return self.lm_head(self.norm(x))


def llama_pipeline_module(cfg: LlamaConfig, num_stages: int):
    """:class:`LlamaForCausalLM` as a ``PipelineModule``: the embedding, the
    blocks and the head as layers, the loss ``cross_entropy_loss`` on the
    last stage (``models/convert.pipeline_state_from_llama`` carries a
    ``LlamaModel`` state across)."""
    from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule

    layers = [LayerSpec(LlamaEmbedPipe, cfg)] + [LayerSpec(LlamaBlockPipe, cfg)
                                                  for _ in range(cfg.num_hidden_layers)] + [LayerSpec(LlamaHeadPipe, cfg)]
    return PipelineModule(layers=layers, num_stages=num_stages, loss_fn=cross_entropy_loss)


IGNORE_INDEX = -100  # a label the loss masks (the engine counts the others, C18)
_TOKEN_MEAN = contextvars.ContextVar("global_token_mean", default=None)


@contextlib.contextmanager
def global_token_mean(count, group_size: int):
    """Within the context :func:`cross_entropy_loss` is this rank's share of
    the mean over ``count`` valid labels of the whole batch (a 0-d tensor,
    the sum over the ``group_size`` ranks that average their losses): the
    local mean times ``local count · group_size / count``, so that the
    ranks' average is the global token mean. The factor is exactly 1 where
    every rank holds as many valid labels."""
    token = _TOKEN_MEAN.set((count, group_size))
    try:
        yield
    finally:
        _TOKEN_MEAN.reset(token)


def cross_entropy_loss(logits, labels, ignore_index=IGNORE_INDEX):
    """Mean negative log-likelihood over the labels that are not
    ``ignore_index``, in f32; 0 when every label is ignored. Inside
    :func:`global_token_mean` the rank's share of the global token mean."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    n_valid = valid.sum()
    loss = -(ll * valid).sum() / n_valid.clamp(min=1)
    norm = _TOKEN_MEAN.get()
    if norm is not None:
        count, group_size = norm
        loss = loss * ((n_valid * group_size).float() / count.clamp(min=1).float())
    return loss


def param_shapes(cfg: LlamaConfig) -> dict:
    """``state_dict`` key → shape of :class:`LlamaModel`, without building it."""
    H, KVH, D, hid, ffn = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                           cfg.hidden_size, cfg.intermediate_size)
    shapes = {"embed_tokens.weight": (cfg.vocab_size, hid)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        shapes[p + "input_layernorm.weight"] = (hid, )
        for name, out in (("q_proj", H * D), ("k_proj", KVH * D), ("v_proj", KVH * D)):
            shapes[p + f"self_attn.{name}.weight"] = (out, hid)
            if cfg.attention_bias:
                shapes[p + f"self_attn.{name}.bias"] = (out, )
        shapes[p + "self_attn.o_proj.weight"] = (hid, H * D)
        if cfg.attention_out_bias:
            shapes[p + "self_attn.o_proj.bias"] = (hid, )
        shapes[p + "post_attention_layernorm.weight"] = (hid, )
        shapes[p + "mlp.gate_proj.weight"] = (ffn, hid)
        shapes[p + "mlp.up_proj.weight"] = (ffn, hid)
        shapes[p + "mlp.down_proj.weight"] = (hid, ffn)
    shapes["norm.weight"] = (hid, )
    shapes["lm_head.weight"] = (cfg.vocab_size, hid)
    return shapes


INIT_STD = 0.02


def init_params(cfg: LlamaConfig, generator: torch.Generator = None, device=None, dtype=None) -> dict:
    """Random weights for :class:`LlamaModel` as a ``state_dict``-keyed dict:
    norm weights are ones, biases zeros, every other tensor normal with
    standard deviation ``INIT_STD``, drawn
    in key order from ``generator`` (made on ``device`` from seed 0 when not
    given). Generated where they will live: a 7B model is drawn on the card."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            params[name] = torch.ones(shape, device=device, dtype=dtype)
        elif name.endswith(".bias"):
            params[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            t = torch.empty(shape, device=device, dtype=dtype)
            params[name] = t.normal_(0.0, INIT_STD, generator=generator)
    return params
