"""FastGen ragged inference engine.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (InferenceEngineV2):
``put`` inserts ragged sequences and runs one forward, ``decode_loop`` runs
greedy single-token decode on the device, ``query``/``can_schedule`` do the
token and KV-block admission, ``flush``/``flush_all`` recycle blocks and
``empty_run`` runs a forward with no live token. ``offload_sequence`` moves a
cold sequence's KV to the tiered store (host memory, or spill files under
``state_manager.offload_path``), and the next ``put``/``decode_loop`` that
touches it restores it. ``export_sequence``/``import_sequence`` move a
sequence to another engine as a handoff frame (``ragged/handoff.py``).
``close`` stops an attached serving scheduler (``serving/scheduler.py``).
Speculative decoding: ``verify`` scores a next-input token plus draft tokens
per sequence in one ragged forward, ``verify_tree`` a draft token tree under
the tree mask, ``rollback`` and ``compact_accepted`` truncate (and re-pack)
what the caller rejected; ``decode_loop`` samples on the device with a
``torch.Generator`` at ``temperature > 0``. With telemetry on (an
engine-owned session from ``telemetry``, or a process-wide one) ``put``,
``decode_loop``, ``verify`` and ``verify_tree`` record the ``inference_*``
metric families and a span each. ``trace_enabled`` builds the per-layer
tracer (``tracer.py``): ``put``, ``verify``, ``verify_tree`` and
``empty_run`` open a batch trace, and the model's traced forward times
``embed``, each layer's ``attn`` and ``ffn``, and ``unembed`` (CUDA events on
the card); ``decode_loop`` stays untraced, as in the JAX package. With a
``dispatch_observer`` installed (the serving scheduler's cost plane) each
dispatch's end time is taken after its device work has finished.

Expert parallelism (``expert_parallel``): one process is one EP rank, on
the expert axis of the rank mesh (:func:`serving_mesh`, :func:`expert_group`;
``replica_num`` times ``tp_size`` must equal the world's size). A Mixtral
under EP holds its rank's experts and
enters its group's collectives once a forward (``modules/moe.py``); an idle
rank keeps the group in lock-step through ``empty_run`` (the serving
scheduler's heartbeat), and :meth:`leave_expert_group` ends a rank's part:
the group stops at the first forward in which every rank has left.
``simulated_gating`` turns the process-wide simulated router on, at
``simulated_gating_temperature``.

Tensor parallelism (``tensor_parallel.tp_size``): one process is one TP
rank, on the ``model`` axis of the rank mesh (:func:`tensor_group`). A
Llama under TP holds its rank's heads and MLP columns (``engine_factory.
build_engine`` slices them) and all-reduces after ``o_proj`` and
``down_proj``; a Mixtral holds its rank's heads and, whole, its expert
rank's banks. Both at once (TP x EP) make a mesh of ``(expert, model)``:
each expert rank is a group of ``tp_size`` model ranks that serve its own
requests, and the MoE's exchange runs over the expert group of each model
rank (``model_implementations/mixtral_v2.py``). Every TP rank must run
the same forwards on the same batches, but the serving scheduler reads the
wall clock, so two schedulers could diverge: the model group's rank 0
alone schedules, and each engine call that changes state (``put``,
``decode_loop``, ``verify``, ``flush``, ``empty_run``,
``leave_expert_group`` and the rest marked ``_lockstep``) is broadcast
from it to the other ranks of its model group, which run
:meth:`InferenceEngineV2.follow` and repeat it until their rank 0's
``close``. Under TP x EP each expert rank's model group has its own rank
0, so every rank of the mesh follows one leader.

Weight quantization (``quantization``, alias ``weight_quantization``) is
the model's: int8 or packed int4 at rest, dequantized where each layer
reads a weight (``model_implementations/transformer_base.py``). ``serialize``
writes the model's config and weights in the reference's directory format
(``engine_factory.build_engine_from_ds_checkpoint`` reads it back, as the
reference's loader does).
"""

import functools
import pickle
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.modules.moe import enable_simulated_gating
from deepspeed_tpu_torch.inference.v2.ragged import handoff
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import PlaceholderSequenceDescriptor
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError, SchedulingResult
from deepspeed_tpu_torch.inference.v2.tracer import Tracer, get_tracer, set_tracer
from deepspeed_tpu_torch.utils.logging import logger


def serving_mesh(config: RaggedInferenceEngineConfig, device):
    """The rank mesh of a served model over the comm world (joined from the
    launcher's environment): ``(expert, model)`` of ``replica_num`` (with
    expert parallelism on) times ``tp_size`` ranks, laid out as the
    reference's ``initialize_mesh(model_parallel_size=tp,
    expert_parallel_size=ep)``: the model ranks of one expert rank are
    neighbours. Raises when the two do not multiply to the world's size;
    None in a world of one rank."""
    tp = config.tensor_parallel.tp_size
    ep = config.expert_parallel.replica_num if config.expert_parallel.enabled else 1
    if tp <= 1 and not config.expert_parallel.enabled:
        return None
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups

    comm.init_distributed(device=device, verbose=False)
    world = comm.get_world_size()
    if tp * ep != world:
        if ep == 1:
            what = f"tensor_parallel.tp_size {tp}", "tensor-parallel rank"
        elif tp == 1:
            what = f"expert_parallel.replica_num {ep}", "expert-parallel rank"
        else:
            what = (f"tensor_parallel.tp_size {tp} x expert_parallel.replica_num {ep}",
                    "rank of the (expert, model) mesh")
        raise ValueError(f"{what[0]} != the comm world's {world} ranks (one process is one {what[1]})")
    if world == 1:
        return None
    mesh = groups.get_mesh() if groups.mesh_is_initialized() else None
    if mesh is None or mesh.size != world or mesh.shape.get(groups.MODEL_AXIS, 1) != tp or \
            mesh.shape.get(groups.EXPERT_AXIS, 1) != ep:
        groups.initialize_mesh(model_parallel_size=tp, expert_parallel_size=ep, force=True)
    return groups.get_mesh()


def tensor_group(config: RaggedInferenceEngineConfig, device):
    """This rank's tensor-parallel group (a ``utils.groups.RankGroup`` over
    the mesh's ``model`` axis: the model ranks of its expert rank), or None
    without tensor parallelism (:func:`serving_mesh`)."""
    mesh = serving_mesh(config, device)
    if config.tensor_parallel.tp_size <= 1 or mesh is None:
        return None
    from deepspeed_tpu_torch.utils import groups
    return groups.get_group(groups.MODEL_AXIS)


def _send_call(group, msg) -> None:
    from deepspeed_tpu_torch import comm
    payload = torch.frombuffer(bytearray(pickle.dumps(msg)), dtype=torch.uint8)
    comm.broadcast(torch.tensor([payload.numel()], dtype=torch.int64), src=0, group=group)
    comm.broadcast(payload, src=0, group=group)


def _recv_call(group):
    from deepspeed_tpu_torch import comm
    size = comm.broadcast(torch.zeros(1, dtype=torch.int64), src=0, group=group)
    payload = comm.broadcast(torch.empty(int(size[0]), dtype=torch.uint8), src=0, group=group)
    return pickle.loads(payload.numpy().tobytes())


def _portable(value):
    """A call argument as it crosses to the other TP ranks (a generator as
    its state)."""
    if isinstance(value, torch.Generator):
        return ("__generator__", str(value.device), value.get_state())
    return value


def _restored(value):
    if isinstance(value, tuple) and len(value) == 3 and value[0] == "__generator__":
        gen = torch.Generator(device=value[1])
        gen.set_state(value[2])
        return gen
    return value


def _lockstep(fn):
    """Under tensor parallelism rank 0's call of ``fn`` is broadcast to the
    other ranks first (their :meth:`InferenceEngineV2.follow` repeats it);
    a call made inside another lock-step call is not sent again."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        group = self._tp_group
        if group is None or self._in_lockstep:
            return fn(self, *args, **kwargs)
        if group.rank == 0:
            _send_call(group, (name, tuple(_portable(a) for a in args),
                               {k: _portable(v) for k, v in kwargs.items()}))
        self._in_lockstep = True
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._in_lockstep = False

    return call


def expert_group(config: RaggedInferenceEngineConfig, device):
    """This rank's expert-parallel group (a ``utils.groups.RankGroup`` over
    the mesh's expert axis: one rank of each expert rank, all of one model
    rank), or None without expert parallelism or in a world of one rank
    (:func:`serving_mesh`; the reference checks its mesh's expert axis
    against ``replica_num``)."""
    mesh = serving_mesh(config, device)
    if not config.expert_parallel.enabled or mesh is None or config.expert_parallel.replica_num <= 1:
        return None
    from deepspeed_tpu_torch.utils import groups
    return groups.get_group(groups.EXPERT_AXIS)


class InferenceEngineV2:

    def __init__(self, model, engine_config: RaggedInferenceEngineConfig) -> None:
        """``model`` is a built ``DSTransformerModelBase`` subclass on its device
        (``engine_factory.build_engine`` makes both)."""
        self._config = engine_config
        if engine_config.simulated_gating:
            enable_simulated_gating(engine_config.simulated_gating_temperature)
        self._model = model
        self._ep_group = expert_group(engine_config, model.device)
        self._tp_group = tensor_group(engine_config, model.device)
        self._in_lockstep = False
        self._followers_released = False
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

        # cost-attribution hook (telemetry/ledger.py + perf/observed.py): a
        # scheduler with an active telemetry session installs a callable
        # ``(kind, n_seqs, n_tokens, seconds)`` invoked after every dispatch
        # (put / decode_loop / verify / verify_tree) has finished on the
        # device. None — the default, and always the case with telemetry off
        # — costs one attribute load per dispatch and adds no wait.
        self.dispatch_observer = None

        if engine_config.trace_enabled:
            self._tracer = Tracer(max_batches=engine_config.max_trace_batches,
                                  span_recorder=self._telemetry.spans if self._telemetry is not None else None,
                                  device=model.device)
            set_tracer(self._tracer)
        else:
            self._tracer = None

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
    def tracer(self) -> Optional[Tracer]:
        return self._tracer

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
        scheduler, deregister this engine's tracer from the module-global slot
        (so tracer state cannot leak into the next engine in this process),
        and close an engine-owned telemetry session. Rank 0 of a
        tensor-parallel group releases the ranks that follow it."""
        if self._serving_scheduler is not None:
            self._serving_scheduler.stop(drain=False)
            self._serving_scheduler = None
        if self._tp_group is not None and self._tp_group.rank == 0 and not self._followers_released:
            self._followers_released = True
            _send_call(self._tp_group, None)
        if self._tracer is not None and get_tracer() is self._tracer:
            set_tracer(None)
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
    @_lockstep
    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable, do_checks: bool = True) -> torch.Tensor:
        """Run one ragged forward over ``batch_uids``/``batch_tokens``; returns
        f32 logits ``[len(batch_uids), vocab]`` on the engine's device, each
        sequence's final token only."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        self._insert_feeds(batch_uids, batch_tokens, do_checks)
        return self._dispatch("put", batch_uids, int(sum(t.size for t in batch_tokens)),
                              lambda: self._model.forward(self._batch))

    def _insert_feeds(self, batch_uids, feeds, do_checks, trees=None) -> None:
        """Admission, restore and batch composition of a forward that feeds
        each sequence its tokens (``put``, ``verify``, ``verify_tree``):
        every fed position gets its KV blocks and is committed by the forward
        (``seen_tokens`` advances by the feed's width)."""
        if do_checks:
            # BEFORE restoring: can_schedule counts offloaded sequences'
            # restore cost, so admission failure is a SchedulingError here,
            # never a raw allocator error mid-restore
            schedule_check = self.can_schedule(batch_uids, [t.size for t in feeds])
            if schedule_check != SchedulingResult.Success:
                raise SchedulingError(schedule_check)
        self._restore_offloaded(batch_uids)
        self._batch.clear()
        if self._tracer:
            self._tracer.init_batch(is_empty_run=False, num_layers=self._model.num_layers)
        for i, (uid, tokens) in enumerate(zip(batch_uids, feeds)):
            seq_desc = self._state_manager.get_or_create_sequence(uid)
            self._model.maybe_allocate_kv(seq_desc, tokens.size)
            seq_desc.pre_forward(tokens.size)
            tree = None if trees is None else (trees[i].parents, trees[i].depths)
            self._batch.insert_sequence(seq_desc, tokens, do_checks=do_checks, tree=tree)
            if self._tracer:
                self._tracer.add_sequence(seq_desc)
        self._batch.finalize()

    def _dispatch(self, kind: str, batch_uids, n_tokens: int, forward):
        """Run ``forward`` over the composed batch with the dispatch
        observer, the span and the telemetry of ``kind``; commits every fed
        position."""
        spans = self._resolve_spans()
        observer = self.dispatch_observer
        if spans is not None or observer is not None:
            _t0 = _telemetry.now_us()
        out = forward()
        if observer is not None:
            self._wait_for_device()
            observer(kind, len(batch_uids), n_tokens, (_telemetry.now_us() - _t0) / 1e6)
        for uid in batch_uids:
            self._state_manager.get_sequence(uid).post_forward()
        if spans is not None:
            # uids link this batch span to the per-request serving traces
            spans.record(kind, cat="inference", ts_us=_t0, dur_us=_telemetry.now_us() - _t0,
                         args={"sequences": len(batch_uids), "tokens": n_tokens,
                               "uids": [int(u) for u in batch_uids]})
        metrics = self._resolve_tel_metrics()
        if metrics is not None:
            self._write_telemetry(metrics, batch_tokens=n_tokens)
        return out

    def _wait_for_device(self) -> None:
        """Block until the work queued on the current stream has finished (an
        event after it): the observer's seconds are then the dispatch's
        device time plus its launches, not its launches alone."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    # ------------------------------------------------------------ decode_loop --
    @_lockstep
    def decode_loop(self, batch_uids: Iterable[int], batch_tokens: Iterable, n_steps: int,
                    do_checks: bool = True, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
        """Generate ``n_steps`` tokens per sequence with no host round trip
        per token (see ``DSTransformerModelBase.decode_loop``).
        ``batch_tokens`` holds each sequence's next-input token; returns host
        int32 tokens ``[n_seqs, n_steps]``. ``temperature`` 0 is greedy; above
        0 each step draws from ``softmax(logits / temperature)`` on the
        device with ``generator`` (a ``torch.Generator`` on the engine's
        device; required).

        **Multi-token verify feed** (speculative decoding): an entry may carry
        its next-input token followed by k draft tokens. Any entry wider than
        one token switches the call into verify mode (``n_steps`` must be 1,
        greedy only): one ragged forward scores every fed position and the
        return value is a list of per-sequence int32 arrays, element i
        holding for each of sequence i's ``1+k_i`` positions the greedy next
        token after the feed up to and including that position. The caller
        accepts the longest prefix where ``out[i][j] == feed_i[j+1]`` and
        rolls back the rejected tail with :meth:`rollback`."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if any(t.size < 1 for t in batch_tokens):
            raise ValueError("decode_loop needs at least one next-input token per sequence")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if any(t.size != 1 for t in batch_tokens):
            if n_steps != 1:
                raise ValueError("a multi-token verify feed runs exactly one step "
                                 "(n_steps=1); the device loop takes single-token "
                                 "entries only")
            if temperature > 0:
                raise ValueError("the multi-token verify feed is greedy; sampled "
                                 "verification consumes engine.verify() logits "
                                 "host-side")
            # device-side argmax: only [1+k] int32 ids per sequence cross the
            # host boundary, not [1+k, vocab] float32 logits
            return self.verify(batch_uids, batch_tokens, do_checks=do_checks, greedy=True)
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
        tokens = self._model.decode_loop(self._batch, n_steps, temperature=temperature,
                                         generator=generator)  # [n_steps, S_bucket]
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

    # ------------------------------------------------------ speculative verify --
    @_lockstep
    def verify(self, batch_uids: Iterable[int], batch_tokens: Iterable, do_checks: bool = True,
               greedy: bool = False) -> List[np.ndarray]:
        """Speculative verify step: feed each sequence its next-input token
        plus draft tokens (``batch_tokens[i]`` holds ``1+k_i`` ids) through one
        ragged forward and return per-position host logits: a list of f32
        arrays, element i shaped ``[1+k_i, vocab]``, where row j scores the
        token after ``batch_tokens[i][:j+1]``. ``greedy=True`` returns the
        device argmax instead (int32 ``[1+k_i]``), so only ids cross to the
        host.

        Every fed position's KV is written and committed (``seen_tokens``
        advances by ``1+k_i``); the caller decides the accepted prefix and
        truncates the rejected tail with :meth:`rollback`
        (write-then-truncate)."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        self._insert_feeds(batch_uids, batch_tokens, do_checks)
        n_tokens = int(sum(t.size for t in batch_tokens))
        rows = self._dispatch("verify", batch_uids, n_tokens,
                                lambda: self._model.forward_verify(self._batch, greedy=greedy).cpu().numpy())
        # insertion order is batch order: each sequence's positions are one
        # contiguous token-major run
        out, offset = [], 0
        for tokens in batch_tokens:
            out.append(rows[offset:offset + tokens.size])
            offset += tokens.size
        return out

    @_lockstep
    def verify_tree(self, batch_uids: Iterable[int], trees: Iterable, greedy: bool = False,
                    do_checks: bool = True) -> List[dict]:
        """Token-tree verify: feed each sequence a draft tree
        (:class:`~deepspeed_tpu_torch.inference.v2.spec.tree.TokenTree`, root
        = next-input token) through one ragged forward under the tree mask.
        Returns one dict per sequence, on the host:

        - ``rows``:   f32 ``[n_nodes, vocab]`` logits (None when greedy); row
          j scores the token after node j's root path;
        - ``ids``:    int32 ``[n_nodes]`` device-argmax ids (greedy only);
        - ``hidden``: f32 ``[n_nodes, hidden]`` residual states before the
          final norm, the learned draft head's input.

        Every node's KV is written at slot ``seen + node`` and committed
        (``seen_tokens`` advances by ``n_nodes``); the caller walks the tree
        and re-packs and truncates with :meth:`compact_accepted`."""
        batch_uids = list(batch_uids)
        trees = list(trees)
        self._insert_feeds(batch_uids, [t.tokens for t in trees], do_checks, trees=trees)
        n_tokens = int(sum(t.size for t in trees))

        def forward():
            rows, hidden = self._model.forward_verify_tree(self._batch, greedy=greedy)
            return rows.cpu().numpy(), hidden.cpu().numpy()

        rows, hidden = self._dispatch("verify_tree", batch_uids, n_tokens, forward)
        out, offset = [], 0
        for tree in trees:
            n = tree.size
            out.append({"rows": None if greedy else rows[offset:offset + n],
                        "ids": rows[offset:offset + n] if greedy else None,
                        "hidden": hidden[offset:offset + n]})
            offset += n
        return out

    @_lockstep
    def compact_accepted(self, uid: int, n_fed: int, path_indices) -> int:
        """Tree-aware KV compaction after a :meth:`verify_tree` step over an
        ``n_fed``-node tree: keep the root plus the accepted path
        ``path_indices`` (ascending local node indices, root excluded),
        re-pack their KV to contiguous slots ``seen0 + 1..m`` in one
        gather-then-scatter, and truncate the rejected remainder with the
        write-then-truncate rollback. A chain-shaped acceptance (``path[j] ==
        j+1``, the prompt-lookup case) moves no KV. Returns the number of
        rejected positions truncated."""
        seq_desc = self._state_manager.get_sequence(uid)
        if seq_desc is None:
            raise ValueError(f"compact_accepted: unknown uid {uid}")
        path = [int(i) for i in path_indices]
        if any(not (0 < i < n_fed) for i in path) or any(b <= a for a, b in zip(path, path[1:])):
            raise ValueError(f"accepted path must be ascending non-root node "
                             f"indices inside the {n_fed}-node tree: {path}")
        copies = [(i, j + 1) for j, i in enumerate(path) if i != j + 1]
        if copies:
            seen0 = seq_desc.seen_tokens - n_fed  # committed count pre-feed
            self._model.compact_kv(seq_desc, [seen0 + s for s, _ in copies], [seen0 + d for _, d in copies])
        rejected = n_fed - 1 - len(path)
        if rejected > 0:
            seq_desc.rollback(rejected)
        return rejected

    @_lockstep
    def rollback(self, uid: int, n_tokens: int) -> None:
        """Truncate ``uid``'s last ``n_tokens`` committed tokens after a verify
        step rejected them: the stale KV stays in its blocks and is
        overwritten when the correct tokens are fed at those positions
        (write-then-truncate). The blocks stay allocated for the sequence."""
        if n_tokens <= 0:
            return
        seq_desc = self._state_manager.get_sequence(uid)
        if seq_desc is None:
            raise ValueError(f"rollback: unknown uid {uid}")
        seq_desc.rollback(n_tokens)

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

    @_lockstep
    def flush(self, uid: int) -> None:
        self._state_manager.flush_sequence(uid)

    # ------------------------------------------------------------- kv offload --
    def _restore_offloaded(self, batch_uids) -> None:
        """Touching an offloaded sequence restores it first."""
        for uid in batch_uids:
            if self._state_manager.is_offloaded(uid):
                self._state_manager.restore_sequence(uid)

    @_lockstep
    def offload_sequence(self, uid: int) -> None:
        """Evict a cold sequence's KV blocks to the host tier, freeing device
        blocks for other sequences. The next put/decode_loop touching ``uid``
        restores it transparently."""
        self._state_manager.offload_sequence(uid)

    def is_offloaded(self, uid: int) -> bool:
        return self._state_manager.is_offloaded(uid)

    # ------------------------------------------------------------- kv handoff --
    def export_sequence(self, uid: int, tokens=(), extra: Optional[dict] = None, seen_tokens: Optional[int] = None,
                        version: Optional[int] = None) -> bytes:
        """Snapshot ``uid`` as a portable bytes payload — token history,
        KV-block contents and caller ``extra`` state — for
        :meth:`import_sequence` on another engine (the prefill→decode
        handoff), built on the same gather/scatter machinery as
        :meth:`offload_sequence`. ``seen_tokens`` caps the committed count the
        recipient adopts (chunked decode feeds ahead of the kept history; the
        recipient recomputes the trimmed tail). The sequence stays tracked
        here; ``flush(uid)`` once the recipient has taken over. ``version``
        selects the frame version (None = the live handoff default;
        ``handoff.PARK_VERSION`` for parked-session frames)."""
        return handoff.pack_sequence(self._state_manager, uid, tokens, extra=extra, seen_tokens=seen_tokens,
                                     version=handoff.VERSION if version is None else version)

    @_lockstep
    def import_sequence(self, payload: bytes, uid: Optional[int] = None) -> Tuple[int, dict]:
        """Recreate an exported sequence from an :meth:`export_sequence`
        payload under ``uid`` (default: the donor's uid); the next
        put/decode_loop continues it exactly where the donor stopped. Returns
        ``(uid, header)`` — the header carries the token history and the
        exporter's ``extra`` generation state."""
        return handoff.import_payload(self._state_manager, payload, uid=uid)

    @_lockstep
    def flush_all(self) -> None:
        """Recycle every tracked sequence's KV blocks."""
        for uid in list(self._state_manager.tracked_sequences):
            self._state_manager.flush_sequence(uid)

    # -------------------------------------------------------------- empty_run --
    @_lockstep
    def empty_run(self) -> None:
        """A forward with zero live tokens: under expert parallelism it
        enters the group's collectives, keeping an idle rank in lock-step
        with busy ones (the serving scheduler's heartbeat calls it)."""
        if self._tracer:
            self._tracer.init_batch(is_empty_run=True, num_layers=self._model.num_layers)
        metrics = self._resolve_tel_metrics()
        if metrics is not None:
            metrics["empty_runs"].inc()
        self._model.empty_run()

    # ------------------------------------------------------- tensor parallel --
    @property
    def tensor_parallel_group(self):
        """This rank's tensor-parallel group (``utils.groups.RankGroup``), or None."""
        return self._tp_group

    def follow(self) -> int:
        """A tensor-parallel rank other than 0: repeat rank 0's lock-step
        engine calls, in its order, until rank 0 closes its engine. Returns
        the number of calls repeated.

        A repeated call that raises is rank 0's call raising the same error
        from the same state (a ``SchedulingError`` when KV blocks run short,
        which rank 0's scheduler catches and answers with other calls), so
        the follower goes on following."""
        if self._tp_group is None or self._tp_group.rank == 0:
            raise RuntimeError("follow() runs on a tensor-parallel rank other than 0")
        calls = 0
        while True:
            msg = _recv_call(self._tp_group)
            if msg is None:
                return calls
            name, args, kwargs = msg
            try:
                getattr(self, name)(*(_restored(a) for a in args), **{k: _restored(v) for k, v in kwargs.items()})
            except Exception as e:  # rank 0 raised it too
                logger.debug(f"follow(): {name} raised {type(e).__name__}: {e}, as on rank 0")
            calls += 1

    @property
    def expert_parallel_group(self):
        """This rank's expert group (``utils.groups.RankGroup``), or None."""
        return self._ep_group

    def serialize(self, save_path: str) -> None:
        """Write the model's config and weights (quantized leaves as they
        rest) in the reference's directory format
        (``engine_factory.write_ds_checkpoint``);
        ``engine_factory.build_engine_from_ds_checkpoint`` is the loader, in
        either package. A tensor- or expert-parallel rank holds a slice of
        the weights, so it refuses."""
        from deepspeed_tpu_torch.inference.v2.engine_factory import write_ds_checkpoint

        if self._tp_group is not None or self._ep_group is not None:
            raise NotImplementedError("serialize writes whole weights; a tensor- or expert-parallel rank holds a "
                                      "slice of them")
        n = write_ds_checkpoint(save_path, dict(self._model._params.items()), self._model.model_config)
        logger.info(f"serialized {n} param tensors to {save_path}")

    @_lockstep
    def leave_expert_group(self) -> int:
        """End this rank's part in its expert group: ask to leave, then run
        empty forwards (in step with the ranks still serving) until the first
        forward in which every rank has asked; every rank stops at that one
        forward. Returns the number of empty forwards run; 0 without expert
        parallelism. Afterwards ``empty_run`` runs nothing and a forward
        raises. A rank whose serving scheduler heartbeats may instead call
        ``model.ep_sync.request_leave()`` and wait for ``ep_sync.stopped``."""
        sync = getattr(self._model, "ep_sync", None)
        if sync is None:
            return 0
        sync.request_leave()
        runs = 0
        while not sync.stopped:
            self.empty_run()
            runs += 1
        return runs
