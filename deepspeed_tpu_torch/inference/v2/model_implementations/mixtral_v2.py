"""Mixtral ragged inference model, with expert parallelism.

Port of ``deepspeed_tpu/inference/v2/model_implementations/mixtral_v2.py``:
the Llama attention phase, then a :class:`RaggedMoE` feed-forward per layer.
Weights are ``models/mixtral.py``'s ``state_dict`` keys; under expert
parallelism (``engine_config.expert_parallel`` over a world of more than
one rank, ``engine_v2.expert_group``) the banks hold this rank's experts
only (``engine_factory.build_engine`` slices them).

Each forward first runs :meth:`_begin_forward`: under simulated gating the
batch's ``gate_seed`` (the sum of the live tokens' positions, the
reference's data-dependent seed; one host read a forward), and under EP the
group's token-count exchange, which every rank enters once a forward. The
traced layer records ``attn`` and ``moe_ffn``.
"""

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.llama_v2 import LlamaV2Model
from deepspeed_tpu_torch.inference.v2.modules.moe import ExpertGroupSync, RaggedMoE, simulated_gating_enabled
from deepspeed_tpu_torch.inference.v2.tracer import record
from deepspeed_tpu_torch.models.llama import rms_norm
from deepspeed_tpu_torch.models.mixtral import MixtralConfig


class MixtralV2Model(LlamaV2Model):

    def __init__(self, params, config: MixtralConfig, engine_config, device, state_manager=None):
        from deepspeed_tpu_torch.inference.v2.engine_v2 import expert_group

        super().__init__(params, config.as_llama(), engine_config, device, state_manager)
        self._moe_config = config
        # under TP x EP this rank's expert group holds one model rank of each
        # expert rank. The model ranks of one expert rank route the same
        # tokens and each sends them, once, over its own expert group to the
        # same model rank of the other expert ranks, whose banks are whole:
        # each expert group moves and computes the tokens once, and the
        # model ranks repeat it in parallel, never summing their results
        # (nothing is reduced over the model group after the MoE), so no
        # token counts twice in a capacity, a drop or an expert's output
        group = expert_group(engine_config, self.device)
        self.ep_sync = ExpertGroupSync(group, self.device) if group is not None else None
        E = config.num_local_experts
        if self.ep_sync is not None and E % self.ep_sync.size:
            # the reference shards the dense compute instead (modules/moe.py:166-175),
            # which one process a rank cannot do (ROADMAP C17)
            raise ValueError(f"{E} experts do not divide over {self.ep_sync.size} expert-parallel ranks")
        self._moes = [
            RaggedMoE(num_experts=E, top_k=config.num_experts_per_tok,
                      capacity_factor=engine_config.expert_parallel.capacity_factor, layer_id=li)
            for li in range(config.num_hidden_layers)
        ]

    @property
    def num_layers(self):
        return self._moe_config.num_hidden_layers

    @property
    def moes(self):
        """The per-layer :class:`RaggedMoE` (their routing statistics)."""
        return self._moes

    def _begin_forward(self, batch):
        if simulated_gating_enabled():
            batch["gate_seed"] = int(torch.where(batch["token_valid"], batch["token_pos"], 0).sum())
        if self.ep_sync is not None:
            batch["ep_tokens"] = self.ep_sync.exchange(batch["n_tokens"])

    def _ffn_phase(self, li, x, batch=None):
        p, pre = self._params, f"layers.{li}."
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], self._moe_config.rms_norm_eps)
        batch = batch or {}
        out = self._moes[li](h, p[pre + "block_sparse_moe.gate"], p[pre + "block_sparse_moe.experts.wi"],
                             p[pre + "block_sparse_moe.experts.wo"], token_valid=batch.get("token_valid"),
                             activation=F.silu, sync=self.ep_sync, gate_seed=batch.get("gate_seed"),
                             ep_tokens=batch.get("ep_tokens"))
        return x + out.to(x.dtype)

    def layer_forward_traced(self, li, x, cache, attn_fn, batch):
        with record("attn"):
            x, cache = self._attn_phase(li, x, cache, attn_fn, batch)
        with record("moe_ffn"):
            x = self._ffn_phase(li, x, batch=batch)
        return x, cache

    def empty_run(self) -> None:
        """A forward with zero live tokens: under EP it enters every
        collective a real forward enters; a rank that has left its group
        runs nothing."""
        if self.ep_sync is not None and self.ep_sync.stopped:
            return
        super().empty_run()
