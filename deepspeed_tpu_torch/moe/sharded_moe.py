"""MoE gating and the dispatch/combine around the experts.

Port of ``deepspeed_tpu/moe/sharded_moe.py``: ``top1gating`` (capacity,
random token selection, ``used_token``, ``drop_tokens``), ``top2gating``
(GShard: the second expert by argmax past the first, slot counters shared
across the two choices, gates renormalised over the kept pair), the
functional ``TopKGate`` and ``moe_dispatch_combine``. The masks and weights
are the reference's dense ``[S, E, C]`` tensors and the dispatch and combine
its two einsums, so at one rank every mask equals the reference's.

Noise (``Jitter``, ``RSample``, the second expert's Gumbel sample and random
token selection) is drawn from an explicit ``torch.Generator`` where the
reference draws from ``jax.random``: the two cannot agree bit for bit, so
those paths hold to the distribution and to determinism for a seed, and with
no generator (evaluation, inference) every path is the reference's exactly.

Ties: ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``
does, and the priority order sorts with ``stable=True`` as ``jnp.argsort``
does.

Across ranks (one process a rank): the reference's gate is global over the
batch, which GSPMD shards over the data axes. :class:`TopKGate` given the
data-parallel ``group`` all-gathers the f32 routing logits in rank order
(the order of the batch's dim-0 chunks), runs the gating on the whole
batch's tokens identically on every rank, and keeps this rank's rows of
the masks, so capacity, priority, ``l_aux`` and ``exp_counts`` are the
reference's (the gather's backward sums the ranks' gradients of each
rank's rows: a reduce-scatter). :func:`moe_dispatch_combine` given the
expert and expert-data groups moves the dispatched ``[E, C, M]`` buffer to
the ranks that hold the experts: each global capacity slot holds one token,
so a rank's buffer is zero outside its own tokens' slots and the ranks'
sum is exact in any order; it is summed over the expert-data group (an
all-reduce) and reduce-scattered over the expert group on ``E``. The
experts' outputs are all-gathered back over the expert group, and each
rank combines its own tokens. Each collective's backward is its adjoint.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm

# uniforms are clamped into the open interval: -log(-log(u)) is finite on it
_U_MIN, _U_MAX = 1e-20, 1.0 - 2.0**-24


def multiplicative_jitter(x, generator: Optional[torch.Generator] = None, epsilon: float = 1e-2):
    """Noise in ``[1 - epsilon, 1 + epsilon]`` times ``x``."""
    if epsilon == 0:
        return x
    u = torch.empty_like(x).uniform_(1.0 - epsilon, 1.0 + epsilon, generator=generator)
    return x * u


def gumbel_rsample(shape, generator: Optional[torch.Generator] = None, dtype=torch.float32, device=None):
    """Standard Gumbel samples ``-log(-log(U))``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device).clamp_(_U_MIN, _U_MAX)
    return (-torch.log(-torch.log(u))).to(dtype)


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int) -> int:
    """``ceil(tokens / experts * factor)``, floored at ``min_capacity``."""
    capacity = math.ceil((num_tokens / num_experts) * capacity_factor)
    return max(capacity, min_capacity)


def _one_hot(indices, num_classes):
    return F.one_hot(indices.long(), num_classes).to(torch.float32)


def top1gating(logits: torch.Tensor,
               capacity_factor: float = 1.0,
               min_capacity: int = 4,
               used_token: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               drop_tokens: bool = True,
               use_rts: bool = True):
    """Top-1 gating. ``logits [S, E]`` f32; returns ``(l_aux,
    combine_weights [S, E, C], dispatch_mask [S, E, C], exp_counts [E])``."""
    S, E = logits.shape
    capacity = _capacity(S, E, capacity_factor, min_capacity)
    if not drop_tokens:
        # every token fits (the reference's static worst case)
        capacity = S

    if noisy_gate_policy == "RSample":
        assert generator is not None, "RSample noisy gating needs a generator"
        logits_w_noise = logits + gumbel_rsample(logits.shape, generator, logits.dtype, logits.device)
    else:
        logits_w_noise = logits

    gates = torch.softmax(logits, dim=1)
    indices1_s = torch.argmax(logits_w_noise if noisy_gate_policy == "RSample" else gates, dim=1)
    mask1 = _one_hot(indices1_s, E)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None]

    exp_counts = mask1.sum(0)

    me = gates.mean(0)
    ce = mask1.mean(0)
    l_aux = (me * ce).sum() * E

    # random token selection: a uniform priority within each expert; without
    # a generator, the positional order
    if use_rts and generator is not None:
        mask1_rand = mask1 * torch.rand(mask1.shape, generator=generator, dtype=mask1.dtype, device=mask1.device)
    else:
        mask1_rand = mask1

    # each token's rank in its expert's queue, by priority
    top_idx = torch.argsort(-mask1_rand, dim=0, stable=True)
    rank_in_expert = torch.argsort(top_idx, dim=0, stable=True)
    locations1 = torch.where(mask1 > 0, rank_in_expert.to(torch.float32), 0.0)
    mask1 = mask1 * (rank_in_expert < capacity).to(mask1.dtype)

    locations1_s = (locations1 * mask1).sum(1).long()
    gates1_s = (gates * mask1).sum(1)  # the gate where kept, else 0
    combine_weights = gates1_s[:, None, None] * mask1[:, :, None] * _one_hot(locations1_s, capacity)[:, None, :]
    dispatch_mask = (combine_weights > 0).to(logits.dtype)
    return l_aux, combine_weights, dispatch_mask, exp_counts


def top2gating(logits: torch.Tensor,
               capacity_factor: float = 1.0,
               min_capacity: int = 4,
               generator: Optional[torch.Generator] = None):
    """Top-2 gating (GShard); same returns as :func:`top1gating`."""
    S, E = logits.shape
    capacity = _capacity(S, E, 2 * capacity_factor, min_capacity)

    gates = torch.softmax(logits, dim=1)
    indices1_s = torch.argmax(gates, dim=1)
    mask1 = _one_hot(indices1_s, E)

    logits_w_noise = logits
    if generator is not None:
        logits_w_noise = logits + gumbel_rsample(logits.shape, generator, logits.dtype, logits.device)
    logits_except1 = torch.where(mask1.bool(), -math.inf, logits_w_noise)
    indices2_s = torch.argmax(logits_except1, dim=1)
    mask2 = _one_hot(indices2_s, E)

    locations1 = torch.cumsum(mask1, dim=0) - 1
    locations2 = torch.cumsum(mask2, dim=0) - 1 + mask1.sum(0, keepdim=True)

    exp_counts = (mask1 + mask2).sum(0)

    me = gates.mean(0)
    ce = mask1.mean(0)
    l_aux = (me * ce).mean() * E * E

    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)

    locations1_s = (locations1 * mask1).sum(1).long()
    locations2_s = (locations2 * mask2).sum(1).long()

    # the two kept gates, renormalised
    gates1_s = (gates * mask1).sum(1)
    gates2_s = (gates * mask2).sum(1)
    denom = gates1_s + gates2_s
    denom = torch.where(denom < torch.finfo(denom.dtype).eps, torch.ones_like(denom), denom)
    gates1_s = gates1_s / denom
    gates2_s = gates2_s / denom

    combine1 = gates1_s[:, None, None] * mask1[:, :, None] * _one_hot(locations1_s, capacity)[:, None, :]
    combine2 = gates2_s[:, None, None] * mask2[:, :, None] * _one_hot(locations2_s, capacity)[:, None, :]
    combine_weights = combine1 + combine2
    dispatch_mask = (combine_weights > 0).to(logits.dtype)
    return l_aux, combine_weights, dispatch_mask, exp_counts


class TopKGate:
    """The reference's functional gate: call with ``(wg [M, E], x [S, M])``
    and an optional generator for the noisy policies."""

    def __init__(self,
                 model_dim: int,
                 num_experts: int,
                 k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True,
                 use_rts: bool = True,
                 top2_2nd_expert_sampling: bool = True):
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gatings are supported.")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.top2_2nd_expert_sampling = top2_2nd_expert_sampling

    def __call__(self, wg, x, generator=None, used_token=None, training=True, group=None):
        """``group``: the data-parallel ``RankGroup`` whose ranks hold the
        batch's dim-0 chunks (the gate is then global over them; see the
        module doc). Returns this rank's rows of the masks."""
        n = group.size if group is not None else 1
        x_fp32 = x.float()
        if self.noisy_gate_policy == "Jitter" and generator is not None and training:
            if n > 1:
                # this rank's rows of the whole batch's draw
                noise = multiplicative_jitter(torch.ones((n * x.shape[0], x.shape[1]), device=x.device), generator)
                x_fp32 = x_fp32 * noise[group.rank * x.shape[0]:(group.rank + 1) * x.shape[0]]
            else:
                x_fp32 = multiplicative_jitter(x_fp32, generator)
        logits = x_fp32 @ wg.float()
        if n > 1:
            logits = _GatherRows.apply(logits, group)
            if used_token is not None:
                used_token = comm.all_gather_into_tensor(used_token.float().contiguous(), group=group)
        cf = self.capacity_factor if training else self.eval_capacity_factor
        if self.k == 1:
            out = top1gating(logits, cf, self.min_capacity, used_token,
                             self.noisy_gate_policy if training else None, generator, self.drop_tokens,
                             self.use_rts)
        else:
            out = top2gating(logits, cf, self.min_capacity,
                             generator if (training and self.top2_2nd_expert_sampling) else None)
        if n == 1:
            return out
        l_aux, combine, dispatch, exp_counts = out
        rows = slice(group.rank * x.shape[0], (group.rank + 1) * x.shape[0])
        return l_aux, combine[rows], dispatch[rows], exp_counts


class _GatherRows(torch.autograd.Function):
    """The ranks' ``[S, ...]`` concatenated on dim 0 in rank order; the
    backward reduce-scatters (each rank's rows get every rank's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_gather_into_tensor(x.contiguous(), group=group, log_name="moe_gate_logits")

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter_tensor(grad.contiguous(), group=ctx.group, log_name="moe_gate_logits_bwd"), \
            None


class _DispatchToExperts(torch.autograd.Function):
    """``[E, C, M]`` summed over the expert-data group, then this rank's
    ``E/ep`` experts of its sum over the expert group (a reduce-scatter);
    the backward all-gathers over the expert group, then sums over the
    expert-data group."""

    @staticmethod
    def forward(ctx, x, ep_group, edp_group):
        ctx.groups = ep_group, edp_group
        if edp_group is not None and edp_group.size > 1:
            x = comm.all_reduce(x.contiguous().clone(), group=edp_group, log_name="moe_dispatch_sum")
        if ep_group is not None and ep_group.size > 1:
            x = comm.reduce_scatter_tensor(x.contiguous(), group=ep_group, log_name="moe_dispatch")
        return x

    @staticmethod
    def backward(ctx, grad):
        ep_group, edp_group = ctx.groups
        grad = grad.contiguous()
        if ep_group is not None and ep_group.size > 1:
            grad = comm.all_gather_into_tensor(grad, group=ep_group, log_name="moe_dispatch_bwd")
        if edp_group is not None and edp_group.size > 1:
            grad = comm.all_reduce(grad.clone(), group=edp_group, log_name="moe_dispatch_sum_bwd")
        return grad, None, None


class _GatherExperts(torch.autograd.Function):
    """Every expert's ``[E/ep, C, M]`` output from the expert group's ranks
    (an all-gather on ``E``); the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, ep_group):
        ctx.group = ep_group
        return comm.all_gather_into_tensor(x.contiguous(), group=ep_group, log_name="moe_experts_out")

    @staticmethod
    def backward(ctx, grad):
        return comm.reduce_scatter_tensor(grad.contiguous(), group=ctx.group, log_name="moe_experts_out_bwd"), \
            None


def moe_dispatch_combine(x, combine_weights, dispatch_mask, expert_fn, ep_group=None, edp_group=None):
    """Dispatch, the experts, combine. ``x [S, M]``; the masks ``[S, E, C]``;
    ``expert_fn(inputs [E/ep, C, M]) -> [E/ep, C, M]`` over this rank's
    experts. The dispatched buffer takes the masks' dtype (f32) as the
    reference's einsum promotes it; the combine runs in ``x``'s dtype. With
    ``ep_group``/``edp_group`` (the expert and expert-data ``RankGroup`` objects)
    the buffers move between the ranks as the module doc says."""
    dispatched = torch.einsum("sec,sm->ecm", dispatch_mask, x.to(dispatch_mask.dtype))
    spread = any(g is not None and g.size > 1 for g in (ep_group, edp_group))
    if spread:
        dispatched = _DispatchToExperts.apply(dispatched, ep_group, edp_group)
    expert_out = expert_fn(dispatched)
    if ep_group is not None and ep_group.size > 1:
        expert_out = _GatherExperts.apply(expert_out, ep_group)
    return torch.einsum("sec,ecm->sm", combine_weights.to(x.dtype), expert_out.to(x.dtype))
