"""The MoE layer.

Port of ``deepspeed_tpu/moe/layer.py``: :class:`ExpertFFN` holds the experts
as stacked banks, ``wi [E, M, F]`` (``[E, M, 2F]`` for gated experts, the
gate and up halves fused, Mixtral's w1/w3) and ``wo [E, F, M]``, and runs
them as one batched product over the leading expert dimension. :class:`MoE`
owns the gate weight ``gate [M, E]``, calls :class:`TopKGate` and
``moe_dispatch_combine``, and returns ``(output, l_aux, exp_counts)`` as the
reference does; ``use_residual`` adds PR-MoE's dense MLP and learned mix.

Expert parameters carry ``allreduce = False`` (upstream DeepSpeed's stamp,
read by ``moe/utils.py::is_moe_param``); :func:`expert_param_specs` names
them, where the reference returns a PartitionSpec tree.

Across ranks (one process a rank) the banks hold this rank's experts,
``[E/ep, ...]`` (the training engine slices them, as the reference places
the banks on the expert axis), and :meth:`MoE.forward` takes its groups
from the rank mesh (``moe/utils.py::moe_groups``): the gate is global over
the data, expert and sequence ranks' tokens (under Ulysses ``x`` is this
rank's ``[B, S/sp, M]`` slice, in the global token order there), and the
dispatched buffer moves to the experts' ranks and back
(``sharded_moe.py``). Model ranks run the layer whole on the same tokens.
"""

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.moe.sharded_moe import TopKGate, moe_dispatch_combine
from deepspeed_tpu_torch.moe.utils import moe_groups


def gelu_tanh(x):
    """flax's ``nn.gelu`` (the tanh approximation), the reference's default."""
    return F.gelu(x, approximate="tanh")


def gated_expert_act(h, activation):
    """SwiGLU-family activation over a fused ``[..., 2H]`` projection laid out
    as (gate | up) halves."""
    gate, up = h.chunk(2, dim=-1)
    return activation(gate) * up


def _lecun_normal_(t, fan_in):
    return nn.init.trunc_normal_(t, std=(1.0 / fan_in)**0.5, a=-2.0 * (1.0 / fan_in)**0.5,
                                 b=2.0 * (1.0 / fan_in)**0.5)


class ExpertFFN(nn.Module):
    """Stacked expert MLPs over ``x [E, C, M]``; ``gated`` fuses a (gate|up)
    ``wi`` of width ``2 * d_hidden``. Computes in ``x``'s dtype."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int, activation: Callable = gelu_tanh,
                 gated: bool = False):
        super().__init__()
        self.activation = activation
        self.gated = gated
        wi_h = 2 * d_hidden if gated else d_hidden
        self.wi = nn.Parameter(torch.empty(num_experts, d_model, wi_h))
        self.wo = nn.Parameter(torch.empty(num_experts, d_hidden, d_model))
        for p in (self.wi, self.wo):
            p.allreduce = False
        _lecun_normal_(self.wi, d_model)
        _lecun_normal_(self.wo, d_hidden)

    def forward(self, x):
        h = torch.bmm(x, self.wi.to(x.dtype))
        h = gated_expert_act(h, self.activation) if self.gated else self.activation(h)
        return torch.bmm(h, self.wo.to(x.dtype))


class MoE(nn.Module):
    """``forward(x [..., M])`` → ``(out [..., M], l_aux, exp_counts)``.
    ``training`` None follows the module's mode. The noisy gates draw from
    ``generator``, else, in training, from a generator seeded with
    ``gating_seed`` (which the training engine sets before each micro-step,
    as the reference engine hands a flax MoE a fresh ``gating`` rng; a
    fresh generator from the seed draws the same again when the block is
    recomputed in the backward). Neither: no noise, as the reference
    without a gating rng."""

    def __init__(self,
                 hidden_size: int,
                 num_experts: int = 1,
                 ffn_hidden_size: Optional[int] = None,
                 k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 use_rts: bool = True,
                 activation: Callable = gelu_tanh,
                 gated: bool = False):
        super().__init__()
        M = hidden_size
        ffn = ffn_hidden_size or 4 * M
        self.hidden_size = M
        self.use_residual = use_residual
        self.activation = activation
        self.gating_seed = None
        # (gate, expert, expert-data, sequence) groups; None: the mesh's
        # (``moe_groups``). A pipeline stage's engine sets four Nones: its
        # gate sees this rank's tokens and its experts are whole on each rank
        self.groups = None
        self.topk = TopKGate(M, num_experts, k, capacity_factor, eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens, use_rts)
        self.gate = nn.Parameter(torch.empty(M, num_experts))
        _lecun_normal_(self.gate, M)
        self.experts = ExpertFFN(num_experts, M, ffn, activation, gated=gated)
        if use_residual:
            # PR-MoE: a dense MLP beside the experts and a learned mix
            self.residual_in = nn.Linear(M, ffn)
            self.residual_out = nn.Linear(ffn, M)
            self.coefficient = nn.Linear(M, 2)

    def forward(self, x, used_token=None, training: Optional[bool] = None, generator=None):
        training = self.training if training is None else training
        if generator is None and training and self.gating_seed is not None:
            generator = torch.Generator(device=x.device).manual_seed(self.gating_seed)
        tokens = x.reshape(-1, self.hidden_size)
        gate_group, ep, edp, sp = self.groups if self.groups is not None else moe_groups()
        seq = (sp.size, x.shape[0] if x.ndim > 2 else 1) if sp is not None and sp.size > 1 else None
        l_aux, combine, dispatch, exp_counts = self.topk(self.gate, tokens, generator=generator,
                                                         used_token=used_token, training=training, group=gate_group,
                                                         seq=seq)
        out = moe_dispatch_combine(tokens, combine, dispatch, self.experts, ep_group=ep, edp_group=edp)
        if self.use_residual:
            mlp_out = self.residual_out(self.activation(self.residual_in(tokens)))
            coef = torch.softmax(self.coefficient(tokens), dim=-1)
            out = out * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return out.reshape(x.shape), l_aux, exp_counts


def expert_param_specs(module: nn.Module) -> dict:
    """``{parameter name: True for an expert bank}`` over ``module``'s
    parameters: the port's structural marker (a parameter of an
    :class:`ExpertFFN`), where the reference places the banks on the mesh's
    expert axis."""
    out = {}
    for name, _ in module.named_parameters():
        owner = name.rpartition(".")[0]
        out[name] = isinstance(module.get_submodule(owner) if owner else module, ExpertFFN)
    return out
