"""FastGen ragged inference engine.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (InferenceEngineV2):
``put`` inserts ragged sequences and runs one forward, ``decode_loop`` runs
greedy single-token decode on the device, ``query``/``can_schedule`` do the
token and KV-block admission, ``flush``/``flush_all`` recycle blocks and
``empty_run`` runs a forward with no live token.

Not ported yet, and refused with ``NotImplementedError``: tensor and expert
parallelism, weight quantization, simulated gating, tracing and telemetry
(ROADMAP.md A4, A8, A9), the speculative ``verify`` feeds, KV offload and
handoff (A5), and sampled ``decode_loop`` (A5).
"""

from typing import Iterable, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import PlaceholderSequenceDescriptor
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError, SchedulingResult


def _refuse_unported(config: RaggedInferenceEngineConfig) -> None:
    unported = {
        "tensor_parallel.tp_size > 1": config.tensor_parallel.tp_size > 1,
        "expert_parallel": config.expert_parallel.enabled,
        "weight quantization": config.quantization.enabled,
        "simulated_gating": config.simulated_gating,
        "trace_enabled": config.trace_enabled,
        "telemetry": config.telemetry.enabled,
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch yet (see ROADMAP.md, queue A)")


class InferenceEngineV2:

    def __init__(self, model, engine_config: RaggedInferenceEngineConfig) -> None:
        """``model`` is a built ``DSTransformerModelBase`` subclass on its device
        (``engine_factory.build_engine`` makes both)."""
        _refuse_unported(engine_config)
        self._config = engine_config
        self._model = model
        self._batch = RaggedBatchWrapper(engine_config.state_manager)
        self._state_manager = DSStateManager(engine_config.state_manager, model.kv_cache_config(), model.device)
        self._model.set_state_manager(self._state_manager)

    # ------------------------------------------------------------ properties --
    @property
    def free_blocks(self) -> int:
        return self._state_manager.free_blocks

    @property
    def model(self):
        return self._model

    @property
    def config(self) -> RaggedInferenceEngineConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._model.device

    # ----------------------------------------------------------------- put() --
    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable, do_checks: bool = True) -> torch.Tensor:
        """Run one ragged forward over ``batch_uids``/``batch_tokens``; returns
        f32 logits ``[len(batch_uids), vocab]`` on the engine's device, each
        sequence's final token only."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if do_checks:
            schedule_check = self.can_schedule(batch_uids, [t.size for t in batch_tokens])
            if schedule_check != SchedulingResult.Success:
                raise SchedulingError(schedule_check)

        self._batch.clear()
        for uid, tokens in zip(batch_uids, batch_tokens):
            seq_desc = self._state_manager.get_or_create_sequence(uid)
            self._model.maybe_allocate_kv(seq_desc, tokens.size)
            seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(seq_desc, tokens, do_checks=do_checks)
        self._batch.finalize()
        logits = self._model.forward(self._batch)
        for uid in batch_uids:
            self._state_manager.get_sequence(uid).post_forward()
        return logits

    # ------------------------------------------------------------ decode_loop --
    def decode_loop(self, batch_uids: Iterable[int], batch_tokens: Iterable, n_steps: int,
                    do_checks: bool = True, temperature: float = 0.0) -> np.ndarray:
        """Greedy-generate ``n_steps`` tokens per sequence with no host round
        trip per token (see ``DSTransformerModelBase.decode_loop``).
        ``batch_tokens`` holds each sequence's one next-input token; returns
        host int32 tokens ``[n_seqs, n_steps]``."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if any(t.size < 1 for t in batch_tokens):
            raise ValueError("decode_loop needs at least one next-input token per sequence")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if any(t.size != 1 for t in batch_tokens):
            raise NotImplementedError("the multi-token (speculative verify) feed runs in one step "
                                      "and is not ported yet (ROADMAP.md A5)")
        if temperature > 0:
            raise NotImplementedError("sampled decode_loop is not ported yet (ROADMAP.md A5); "
                                      "temperature must be 0")
        if do_checks:
            # each step's ragged batch holds one token per sequence, so the
            # token budget is checked against n_seqs; the KV-block budget must
            # cover all n_steps appended tokens per sequence
            if len(batch_uids) > self._config.state_manager.max_ragged_sequence_count:
                raise SchedulingError(SchedulingResult.BatchSequenceLimitExceeded)
            if len(batch_uids) > self._config.state_manager.max_ragged_batch_size:
                raise SchedulingError(SchedulingResult.BatchTokenLimitExceeded)
            free_blocks = self._state_manager.free_blocks
            for uid in batch_uids:
                seq_desc = self._state_manager.get_sequence(uid) or PlaceholderSequenceDescriptor()
                sched_len, sched_blocks = self._model.get_kv_requirements(seq_desc, n_steps, free_blocks)
                if sched_len != n_steps:
                    raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
                free_blocks -= sched_blocks

        self._batch.clear()
        for uid, tokens in zip(batch_uids, batch_tokens):
            seq_desc = self._state_manager.get_or_create_sequence(uid)
            # the loop cannot allocate mid-run: blocks for the whole generation
            self._model.maybe_allocate_kv(seq_desc, n_steps)
            seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(seq_desc, tokens, do_checks=do_checks)
        self._batch.finalize()
        tokens = self._model.decode_loop(self._batch, n_steps)  # [n_steps, S_bucket]
        for uid in batch_uids:
            seq_desc = self._state_manager.get_sequence(uid)
            seq_desc.post_forward()  # the token passed in
            if n_steps > 1:  # the n_steps-1 tokens the loop inserted
                seq_desc.pre_forward(n_steps - 1)
                seq_desc.post_forward()
        return tokens[:, :len(batch_uids)].T

    # ------------------------------------------------------------- scheduling --
    def query(self, uid: int, max_request_tokens: int, max_request_blocks: int) -> Tuple[int, int]:
        """(tokens schedulable, blocks required) for a hypothetical request."""
        seq_desc = self._state_manager.get_sequence(uid)
        if seq_desc is None:
            if self._state_manager.n_tracked_sequences >= self._config.state_manager.max_tracked_sequences:
                return (0, 0)
            seq_desc = PlaceholderSequenceDescriptor()
        return self._model.get_kv_requirements(seq_desc, max_request_tokens, max_request_blocks)

    def can_schedule(self, uids: Iterable[int], lengths: Iterable[int]) -> SchedulingResult:
        uids, lengths = list(uids), list(lengths)
        cur_seqs = self._state_manager.n_tracked_sequences
        free_blocks = self._state_manager.free_blocks
        batch_len = 0

        if len(uids) > self._config.state_manager.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded

        for uid, length in zip(uids, lengths):
            seq_desc = self._state_manager.get_sequence(uid)
            if seq_desc is None:
                cur_seqs += 1
                seq_desc = PlaceholderSequenceDescriptor()
            sched_len, sched_blocks = self._model.get_kv_requirements(seq_desc, length, free_blocks)
            if sched_len != length:
                return SchedulingResult.KVCacheLimitExceeded
            batch_len += length
            free_blocks -= sched_blocks

        if cur_seqs > self._config.state_manager.max_tracked_sequences:
            return SchedulingResult.EngineSequenceLimitExceeded
        if batch_len > self._config.state_manager.max_ragged_batch_size:
            return SchedulingResult.BatchTokenLimitExceeded
        return SchedulingResult.Success

    def get_remaining_block_capacity(self, uid: int) -> int:
        seq_desc = self._state_manager.get_sequence(uid)
        if seq_desc is None:
            return 0
        return self._model.get_remaining_block_capacity(seq_desc)

    def flush(self, uid: int) -> None:
        self._state_manager.flush_sequence(uid)

    def flush_all(self) -> None:
        """Recycle every tracked sequence's KV blocks."""
        for uid in list(self._state_manager.tracked_sequences):
            self._state_manager.flush_sequence(uid)

    # -------------------------------------------------------------- empty_run --
    def empty_run(self) -> None:
        """A forward with zero live tokens (keeps replicas in lock-step once
        expert parallelism is ported)."""
        self._model.empty_run()
