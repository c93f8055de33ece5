"""Ragged MoE for inference, with disaggregated expert parallelism.

Port of ``deepspeed_tpu/inference/v2/modules/moe.py``: top-k routing of the
ragged batch's tokens, capacity packing into per-expert slots, the grouped
expert product, the weighted combine, and, under expert parallelism (EP),
the fork's disaggregated data flow between ranks.

One process is one EP rank. A rank holds attention, norms, the embedding
and the head in full, and experts ``[r·E/ep, (r+1)·E/ep)``; it serves its
own ragged batch. Each MoE layer then runs:

1. local routing and packing of the rank's tokens into ``[E, C, M]``;
2. ``all_to_all_single`` over the expert group (a2a #1): every rank's
   tokens for this rank's experts arrive, ``[ep, E/ep, C, M]``;
3. the local grouped product over ``[E/ep, ep·C, M]``;
4. a2a #2: the results go back to the tokens' ranks, ``[E, C, M]``;
5. the local combine with the routing weights.

The all-to-alls need one ``C`` on every rank. The reference pads one global
batch to ``ep`` equal slices and takes ``C`` from a slice; here each
forward's first collective is :meth:`ExpertGroupSync.exchange`, one
``all_reduce(MAX)`` of the ranks' live token counts, and ``C`` comes from
that maximum (with equal slices, the reference's). Every forward on every
rank enters the same collectives: the exchange, then two all-to-alls a
layer. An idle rank enters through ``empty_run`` (a forward of zero live
tokens, which the serving scheduler's heartbeat sends). A rank that is
done asks to leave (:class:`ExpertGroupSync`) and goes on with empty
forwards; the group stops at the first forward in which every rank has
asked.

The dispatch, the expert products and the combine are torch ops here, as
they are ``einsum`` outside any Pallas kernel in the reference; the
dispatch is an index copy and the combine a gather (each slot holds at
most one token, so they compute the reference's 0/1 einsums).

Top-k: the reference's ``jax.lax.top_k`` puts the lower index first on a
tie; ``torch.topk`` promises no order on CUDA, so the experts are taken by
``argmax`` (the first maximal index), masking each choice before the next:
the lower index wins, as in the reference.

Simulated gating (the fork's load-testing mode): router probabilities are
replaced by draws from a per-layer synthetic distribution,
:func:`simulated_expert_probs` (a seeded numpy Dirichlet sharpened by a
temperature, equal to the reference's), through the Gumbel-max trick. The
uniforms come from a torch generator seeded by (layer, the batch's
``gate_seed``, the EP rank) where the reference folds the same three into a
``jax.random`` key: the draws are deterministic for each triple but not the
reference's (ROADMAP C16).
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.moe.layer import gated_expert_act

_SIMULATED_GATING = {"enabled": False, "temperature": 1.0}


def enable_simulated_gating(temperature: float = 1.0) -> None:
    _SIMULATED_GATING["enabled"] = True
    _SIMULATED_GATING["temperature"] = float(temperature)


def disable_simulated_gating() -> None:
    _SIMULATED_GATING["enabled"] = False


def simulated_gating_enabled() -> bool:
    return _SIMULATED_GATING["enabled"]


def simulated_expert_probs(layer_id: int, num_experts: int, temperature: Optional[float] = None) -> torch.Tensor:
    """Per-layer synthetic expert distribution, f32 ``[num_experts]`` on the
    CPU: the reference's seeded Dirichlet and temperature, bit for bit."""
    if temperature is None:
        temperature = _SIMULATED_GATING["temperature"]
    rng = np.random.default_rng(1000 + layer_id)
    p = rng.dirichlet(np.full(num_experts, 2.0))
    logp = np.log(np.maximum(p, 1e-9)) / max(temperature, 1e-6)
    e = np.exp(logp - logp.max())
    return torch.from_numpy((e / e.sum()).astype(np.float32))


def _simulated_seed(layer_id: int, gate_seed: Optional[int], replica: Optional[int]) -> int:
    """A generator seed for (layer, batch seed, EP rank); None folds nothing
    in, as the reference's key."""
    words = [1000 + layer_id, 0 if gate_seed is None else 1 + int(gate_seed), 0 if replica is None else 1 + replica]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


class ExpertGroupSync:
    """An EP rank's lock-step state over its expert ``group`` (a
    ``utils.groups.RankGroup``).

    :meth:`exchange` is every forward's first collective. Its MAX over
    ``[live tokens, staying]`` gives each rank the group's largest live token
    count (capacity comes from it) and tells every rank at once when the
    group stops: at the first forward in which every rank has asked to leave
    (:meth:`request_leave`; a leaving rank runs empty forwards only, so no
    rank then has a live token). After that forward the rank runs no
    collective: ``empty_run`` is a no-op and a forward raises. The two
    counts travel as a host tensor over gloo, as a ``device`` one over
    NCCL."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device("cpu") if comm.get_backend_name() == "gloo" else torch.device(device)
        self.leaving = False
        self.stopped = False

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    def request_leave(self) -> None:
        self.leaving = True

    def exchange(self, n_tokens: int) -> int:
        if self.stopped:
            raise RuntimeError("this rank has left its expert-parallel group: it can run no more forwards")
        t = torch.tensor([int(n_tokens), int(not self.leaving)], dtype=torch.int64, device=self.device)
        comm.all_reduce(t, op=ReduceOp.MAX, group=self.group)
        tokens, staying = (int(v) for v in t.tolist())
        if not staying:
            self.stopped = True  # this forward still runs to its end on every rank
        return tokens


class RaggedMoE:
    """Top-k MoE over flat tokens ``h [T, M]``; the banks are ``wi [E?, M,
    F or 2F]`` and ``wo [E?, F, M]`` (the training ``ExpertFFN`` layout), all
    ``E`` experts at one rank, this rank's ``E/ep`` under EP.

    Per-layer statistics accumulate on the device with no host sync:
    ``expert_counts`` (kept assignments an expert), ``first_choice_counts``
    (each valid token's first choice, kept or not) and ``dropped`` (valid
    assignments past an expert's capacity); :meth:`reset_stats` zeroes them."""

    def __init__(self, num_experts: int, top_k: int = 2, capacity_factor: float = 2.0, layer_id: int = 0):
        assert top_k in (1, 2), "ragged MoE supports top-1/top-2"
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.layer_id = layer_id
        self.expert_counts = self.first_choice_counts = self.dropped = None

    def reset_stats(self) -> None:
        self.expert_counts = self.first_choice_counts = self.dropped = None

    def capacity(self, tokens: int) -> int:
        """Slots an expert: ``max(4, ceil(tokens·k / E · capacity_factor))``."""
        return max(4, int(math.ceil(tokens * self.top_k / self.num_experts * self.capacity_factor)))

    # ------------------------------------------------------------------ gating --
    def _router_probs(self, h, gate_w, gate_seed=None, replica=None):
        if simulated_gating_enabled():
            # every token draws from the layer's synthetic distribution; the
            # batch seed and the rank diversify the draw
            probs = simulated_expert_probs(self.layer_id, self.num_experts).to(h.device)
            g = torch.Generator(device=h.device).manual_seed(_simulated_seed(self.layer_id, gate_seed, replica))
            u = torch.rand((h.shape[0], self.num_experts), generator=g, device=h.device)
            logits = torch.log(probs)[None, :] - torch.log(-torch.log(u.clamp(min=1e-9)))
            return torch.softmax(logits, dim=-1)
        return torch.softmax(h.float() @ gate_w.float(), dim=-1)

    def _top_k(self, probs):
        """``(weights [T, k], experts [T, k])``, the lower index first on a
        tie; top-2 weights renormalised over the pair (Mixtral)."""
        p, picks, vals = probs, [], []
        for _ in range(self.top_k):
            e = torch.argmax(p, dim=-1)
            vals.append(probs.gather(1, e[:, None])[:, 0])
            picks.append(e)
            p = p.scatter(1, e[:, None], -math.inf)
        w, e = torch.stack(vals, dim=1), torch.stack(picks, dim=1)
        if self.top_k == 2:
            w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        return w, e

    # ------------------------------------------------------- capacity packing --
    def _pack(self, probs, token_valid, C):
        """Top-k assignment with capacity packing (the reference's
        ``moe_scatter``): slot counters are shared across the k choices (a
        second choice queues behind every first choice of its expert), and
        invalid tokens take no slot. Returns ``(slot [T, k] flat indices
        into E·C, kept [T, k] bool, weights [T, k] f32)``."""
        T, E = probs.shape
        w, experts = self._top_k(probs)
        valid = torch.ones(T, dtype=torch.bool, device=probs.device) if token_valid is None else token_valid
        base = torch.zeros(E, dtype=torch.int64, device=probs.device)
        slots, kept = [], []
        for j in range(self.top_k):
            e_j = experts[:, j]
            onehot = F.one_hot(e_j, E) * valid[:, None]  # [T, E] int64; invalid rows zero
            within = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_j[:, None])[:, 0]
            slot = within + base[e_j]
            ok = valid & (slot < C)
            slots.append(e_j * C + slot.clamp(max=C - 1))
            kept.append(ok)
            base = base + onehot.sum(0)
        slot, kept = torch.stack(slots, dim=1), torch.stack(kept, dim=1)
        self._accumulate(experts, kept, valid, E)
        return slot, kept, w

    def _accumulate(self, experts, kept, valid, E):
        counts = torch.zeros(E, dtype=torch.int64, device=experts.device).index_add_(
            0, experts.reshape(-1), kept.reshape(-1).long())
        first = torch.zeros(E, dtype=torch.int64, device=experts.device).index_add_(0, experts[:, 0], valid.long())
        dropped = (valid[:, None] & ~kept).sum()
        if self.expert_counts is None:
            self.expert_counts, self.first_choice_counts, self.dropped = counts, first, dropped
        else:
            self.expert_counts += counts
            self.first_choice_counts += first
            self.dropped += dropped

    @staticmethod
    def _dispatch(h, slot, kept, E, C):
        """``[E, C, M]``: each kept (token, choice) copied into its slot; the
        other slots zero."""
        buf = h.new_zeros((E * C, h.shape[1]))
        rows = torch.arange(h.shape[0], device=h.device)[:, None].expand_as(slot)
        buf[slot[kept]] = h[rows[kept]]
        return buf.view(E, C, -1)

    @staticmethod
    def _combine(out, slot, kept, w, dtype):
        """``out [E, C, M]`` back to the tokens: Σ over the kept choices of
        the weight (rounded to ``dtype``, as the reference casts its combine
        weights) times the slot's row, accumulated in f32."""
        flat = out.reshape(-1, out.shape[-1])
        wk = torch.where(kept, w, 0.0).to(dtype).float()
        acc = sum(wk[:, j, None] * flat[slot[:, j]].float() for j in range(slot.shape[1]))
        return acc.to(dtype)

    @staticmethod
    def _expert_ffn(buf, wi, wo, activation):
        """The grouped expert product over an expert-major ``[E?, C?, M]``."""
        hpre = torch.bmm(buf, wi.to(buf.dtype))
        hmid = gated_expert_act(hpre, activation) if wi.shape[-1] == 2 * wo.shape[-2] else activation(hpre)
        return torch.bmm(hmid, wo.to(buf.dtype))

    # ----------------------------------------------------------------- forward --
    def __call__(self, h, gate_w, wi, wo, token_valid=None, activation=None, sync: Optional[ExpertGroupSync] = None,
                 gate_seed=None, ep_tokens: Optional[int] = None):
        """``h [T, M]``; ``gate_w [M, E]``. Under ``sync`` (an EP group of
        more than one rank) the disaggregated path, with ``C`` from
        ``ep_tokens`` (the forward's exchange; exchanged here when None),
        else the dense path over all experts."""
        if activation is None:
            activation = F.silu
        if sync is not None and sync.size > 1:
            if ep_tokens is None:
                n = h.shape[0] if token_valid is None else int(token_valid.sum())
                ep_tokens = sync.exchange(n)
            return self._ep_forward(h, gate_w, wi, wo, token_valid, activation, sync, gate_seed, ep_tokens)
        return self._dense_forward(h, gate_w, wi, wo, token_valid, activation, gate_seed)

    def _dense_forward(self, h, gate_w, wi, wo, token_valid, activation, gate_seed):
        """One rank, all experts local; ``C`` from the bucket's token count,
        as the reference's."""
        E = self.num_experts
        C = self.capacity(h.shape[0])
        probs = self._router_probs(h, gate_w, gate_seed=gate_seed)
        if token_valid is not None:
            probs = probs * token_valid[:, None]
        slot, kept, w = self._pack(probs, token_valid, C)
        out = self._expert_ffn(self._dispatch(h, slot, kept, E, C), wi, wo, activation)
        return self._combine(out, slot, kept, w, h.dtype)

    def _ep_forward(self, h, gate_w, wi, wo, token_valid, activation, sync, gate_seed, ep_tokens):
        """The disaggregated path (module doc): this rank's tokens, its
        ``E/ep`` experts, two all-to-alls over the group."""
        ep, E = sync.size, self.num_experts
        El = E // ep
        if wi.shape[0] != El:
            raise ValueError(f"layer {self.layer_id}: an EP rank of {ep} holds {El} experts, not {wi.shape[0]}")
        M = h.shape[1]
        C = self.capacity(ep_tokens)
        probs = self._router_probs(h, gate_w, gate_seed=gate_seed, replica=sync.rank)
        if token_valid is not None:
            probs = probs * token_valid[:, None]
        slot, kept, w = self._pack(probs, token_valid, C)
        buf = self._dispatch(h, slot, kept, E, C).view(ep, El, C, M)  # destination-rank major
        recv = comm.all_to_all_single(buf, group=sync.group)  # a2a #1: [source rank, El, C, M]
        merged = recv.transpose(0, 1).reshape(El, ep * C, M)
        out = self._expert_ffn(merged, wi, wo, activation)
        out = out.view(El, ep, C, M).transpose(0, 1).contiguous()  # [source rank, El, C, M]
        ret = comm.all_to_all_single(out, group=sync.group)  # a2a #2: [owner rank, El, C, M] = [E, C, M]
        return self._combine(ret.view(E, C, M), slot, kept, w, h.dtype)
