"""FastGen ragged inference engine.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (InferenceEngineV2):
``put`` inserts ragged sequences and runs one forward, ``decode_loop`` runs
greedy single-token decode on the device, ``query``/``can_schedule`` do the
token and KV-block admission, ``flush``/``flush_all`` recycle blocks and
``empty_run`` runs a forward with no live token. ``offload_sequence`` moves a
cold sequence's KV to the host tier, and the next ``put``/``decode_loop``
that touches it restores it. ``close`` stops an attached serving scheduler
(``serving/scheduler.py``). With telemetry on (an engine-owned session from
``telemetry``, or a process-wide one) ``put`` and ``decode_loop`` record the
``inference_*`` metric families and a span each.

Not ported yet, and refused with ``NotImplementedError``: tensor and expert
parallelism, weight quantization and simulated gating (ROADMAP.md A8, A9),
the tracer (``trace_enabled``), the speculative ``verify`` feeds, handoff
export/import and sampled ``decode_loop`` (A5).
"""

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry as _telemetry
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

        # telemetry: batch/token/KV gauges + spans, and the /metrics endpoint
        # when telemetry.http.enabled, startable purely from config
        self._telemetry = None
        self._tel_metrics = None
        if engine_config.telemetry.enabled:
            self._telemetry = _telemetry.configure(engine_config.telemetry)
            self._tel_metrics = self._build_tel_metrics(self._telemetry.registry)

        # a ServingScheduler attaches here (serving/scheduler.py); close()
        # stops it so the engine can always be torn down safely
        self._serving_scheduler = None

        # dispatch hook: a callable ``(kind, n_seqs, n_tokens, wall_seconds)``
        # invoked after every put / decode_loop forward; None (the default)
        # costs one attribute load per dispatch
        self.dispatch_observer = None

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

    @property
    def serving_scheduler(self):
        """The attached :class:`ServingScheduler` (None when not serving)."""
        return self._serving_scheduler

    @property
    def metrics_url(self) -> Optional[str]:
        """The served ``/metrics`` URL (None unless ``telemetry.http.enabled``)."""
        return self._telemetry.metrics_url if self._telemetry is not None else None

    def close(self) -> None:
        """Tear the engine down (idempotent): stop an attached serving
        scheduler and close an engine-owned telemetry session."""
        if self._serving_scheduler is not None:
            self._serving_scheduler.stop(drain=False)
            self._serving_scheduler = None
        if self._telemetry is not None:
            self._telemetry.close()
            self._telemetry = None

    # ------------------------------------------------------------- telemetry --
    @staticmethod
    def _build_tel_metrics(reg) -> dict:
        return {
            "batches": reg.counter("inference_batches_total", "Ragged batches executed"),
            "tokens": reg.counter("inference_tokens_total", "Tokens scheduled into batches"),
            "in_flight": reg.gauge("inference_in_flight_tokens",
                                   "Tokens in the last ragged batch"),
            "free_blocks": reg.gauge("inference_kv_free_blocks", "Free KV-cache blocks"),
            "tracked": reg.gauge("inference_tracked_sequences", "Sequences tracked"),
            "empty_runs": reg.counter("inference_empty_runs_total",
                                      "EP lock-step forwards with zero tokens"),
        }

    def _resolve_tel_metrics(self) -> Optional[dict]:
        """The inference_* families, on the process-wide registry: built at
        init for an engine-owned session, else lazily and only while a
        process-wide session is active. Disabled telemetry costs one boolean
        check here."""
        if self._telemetry is not None:
            return self._tel_metrics
        if not _telemetry.is_active():
            return None
        if self._tel_metrics is None:
            self._tel_metrics = self._build_tel_metrics(_telemetry.get_registry())
        return self._tel_metrics

    def _resolve_spans(self):
        """The engine session's span recorder, or a process-wide session's."""
        return self._telemetry.spans if self._telemetry is not None else _telemetry.get_span_recorder()

    def _write_telemetry(self, metrics: dict, batch_tokens: int) -> None:
        metrics["batches"].inc()
        metrics["tokens"].inc(batch_tokens)
        metrics["in_flight"].set(batch_tokens)
        metrics["free_blocks"].set(self._state_manager.free_blocks)
        metrics["tracked"].set(self._state_manager.n_tracked_sequences)

    # ----------------------------------------------------------------- put() --
    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable, do_checks: bool = True) -> torch.Tensor:
        """Run one ragged forward over ``batch_uids``/``batch_tokens``; returns
        f32 logits ``[len(batch_uids), vocab]`` on the engine's device, each
        sequence's final token only."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if do_checks:
            # BEFORE restoring: can_schedule counts offloaded sequences'
            # restore cost, so admission failure is a SchedulingError here,
            # never a raw allocator error mid-restore
            schedule_check = self.can_schedule(batch_uids, [t.size for t in batch_tokens])
            if schedule_check != SchedulingResult.Success:
                raise SchedulingError(schedule_check)
        self._restore_offloaded(batch_uids)

        self._batch.clear()
        for uid, tokens in zip(batch_uids, batch_tokens):
            seq_desc = self._state_manager.get_or_create_sequence(uid)
            self._model.maybe_allocate_kv(seq_desc, tokens.size)
            seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(seq_desc, tokens, do_checks=do_checks)
        self._batch.finalize()
        spans = self._resolve_spans()
        observer = self.dispatch_observer
        if spans is not None or observer is not None:
            _t0 = _telemetry.now_us()
        logits = self._model.forward(self._batch)
        n_tokens = int(sum(t.size for t in batch_tokens))
        if observer is not None:
            observer("put", len(batch_uids), n_tokens, (_telemetry.now_us() - _t0) / 1e6)
        for uid in batch_uids:
            self._state_manager.get_sequence(uid).post_forward()
        if spans is not None:
            # uids link this batch span to the per-request serving traces
            spans.record("put", cat="inference", ts_us=_t0, dur_us=_telemetry.now_us() - _t0,
                         args={"sequences": len(batch_uids), "tokens": n_tokens,
                               "uids": [int(u) for u in batch_uids]})
        metrics = self._resolve_tel_metrics()
        if metrics is not None:
            self._write_telemetry(metrics, batch_tokens=n_tokens)
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
                restore = self._restore_cost(uid, seq_desc)
                sched_len, sched_blocks = self._model.get_kv_requirements(seq_desc, n_steps,
                                                                          free_blocks - restore)
                if sched_len != n_steps:
                    raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
                free_blocks -= sched_blocks + restore
        self._restore_offloaded(batch_uids)

        self._batch.clear()
        for uid, tokens in zip(batch_uids, batch_tokens):
            seq_desc = self._state_manager.get_or_create_sequence(uid)
            # the loop cannot allocate mid-run: blocks for the whole generation
            self._model.maybe_allocate_kv(seq_desc, n_steps)
            seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(seq_desc, tokens, do_checks=do_checks)
        self._batch.finalize()
        spans = self._resolve_spans()
        observer = self.dispatch_observer
        if spans is not None or observer is not None:
            _t0 = _telemetry.now_us()
        tokens = self._model.decode_loop(self._batch, n_steps)  # [n_steps, S_bucket]
        if observer is not None:
            observer("decode_loop", len(batch_uids), len(batch_uids) * n_steps,
                     (_telemetry.now_us() - _t0) / 1e6)
        if spans is not None:
            spans.record("decode_loop", cat="inference", ts_us=_t0, dur_us=_telemetry.now_us() - _t0,
                         args={"sequences": len(batch_uids), "steps": n_steps,
                               "uids": [int(u) for u in batch_uids]})
        metrics = self._resolve_tel_metrics()
        if metrics is not None:
            self._write_telemetry(metrics, batch_tokens=len(batch_uids) * n_steps)
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
        restore = self._restore_cost(uid, seq_desc)
        toks, blocks = self._model.get_kv_requirements(seq_desc, max_request_tokens, max_request_blocks - restore)
        return toks, blocks + restore

    def _restore_cost(self, uid, seq_desc) -> int:
        """Device blocks a touch of ``uid`` must re-allocate first: an
        offloaded sequence's stale descriptor still reports its (freed)
        blocks as resident."""
        return seq_desc.cur_allocated_blocks if self._state_manager.is_offloaded(uid) else 0

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
            restore = self._restore_cost(uid, seq_desc)
            sched_len, sched_blocks = self._model.get_kv_requirements(seq_desc, length, free_blocks - restore)
            if sched_len != length:
                return SchedulingResult.KVCacheLimitExceeded
            batch_len += length
            free_blocks -= sched_blocks + restore

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

    # ------------------------------------------------------------- kv offload --
    def _restore_offloaded(self, batch_uids) -> None:
        """Touching an offloaded sequence restores it first."""
        for uid in batch_uids:
            if self._state_manager.is_offloaded(uid):
                self._state_manager.restore_sequence(uid)

    def offload_sequence(self, uid: int) -> None:
        """Evict a cold sequence's KV blocks to the host tier, freeing device
        blocks for other sequences. The next put/decode_loop touching ``uid``
        restores it transparently."""
        self._state_manager.offload_sequence(uid)

    def is_offloaded(self, uid: int) -> bool:
        return self._state_manager.is_offloaded(uid)

    def flush_all(self) -> None:
        """Recycle every tracked sequence's KV blocks."""
        for uid in list(self._state_manager.tracked_sequences):
            self._state_manager.flush_sequence(uid)

    # -------------------------------------------------------------- empty_run --
    def empty_run(self) -> None:
        """A forward with zero live tokens (keeps replicas in lock-step once
        expert parallelism is ported)."""
        metrics = self._resolve_tel_metrics()
        if metrics is not None:
            metrics["empty_runs"].inc()
        self._model.empty_run()
