"""Async continuous-batching request scheduler (Dynamic SplitFuse).

Port of ``deepspeed_tpu/serving/scheduler.py`` (the base path). Reference:
DeepSpeed-FastGen's persistent serving loop (Holmes et al. 2024 — MII
``RaggedBatchBase.schedule_requests``) and Orca-style iteration-level
scheduling (Yu et al., OSDI'22): requests are admitted continuously, every
engine iteration re-composes the ragged batch from in-flight decodes plus
prompt *chunks* under the token budget, and finished sequences leave the batch
the moment they finish.

The scheduler is the only thing that touches the engine once started —
``InferenceEngineV2`` is not thread-safe, so cancellation, deadline expiry and
shutdown are flags honored at tick boundaries on the scheduler thread, where
KV blocks can be freed safely. The engine's ``put`` returns logits on the
engine's device; ``_execute`` copies them to the host once per ``put``.

Batch composition per tick (``step()``):

1. finalize cancelled / past-deadline requests (flush their KV blocks);
2. admit QUEUED requests (permanently-infeasible ones FAIL immediately);
3. decode tokens first (latency-critical, one token each), then prompt chunks
   fill the remaining ``max_ragged_batch_size`` budget — Dynamic SplitFuse;
4. under KV pressure: shrink the prompt chunk (halving), then evict the
   coldest idle sequence via ``engine.offload_sequence`` (restore-on-touch is
   transparent) and retry;
5. decode-only batches with ``decode_chunk > 1`` run through the engine's
   greedy ``decode_loop`` (one dispatch per K tokens);
6. idle ticks heartbeat ``engine.empty_run()`` when heartbeats are on.

Not ported yet, and refused with ``NotImplementedError``: the prefix cache,
speculative decoding, KV tiers, handoff (``submit_resume``, the ``handoff``
flag), parking, peer prefix export and the cost ledger (ROADMAP A5); work
stealing and SLO-driven pressure (A6).
"""

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError, SchedulingResult
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.overload import (BrownoutController, FairSharePolicy,
                                                  RateEstimator, priority_rank,
                                                  validate_priority)
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.telemetry import new_span_id, new_trace_id, now_us
from deepspeed_tpu_torch.telemetry.flight_recorder import SERVING_SCHEDULER_CHANNEL
from deepspeed_tpu_torch.utils.logging import logger

# ticks with active requests but nothing engine-schedulable before the
# scheduler declares them wedged (covers allocator corner cases the
# permanent-infeasibility admission checks cannot see)
_STARVATION_FAIL_TICKS = 5000

# flight-recorder channel disambiguator for multiple schedulers per process
_SCHEDULER_IDS = itertools.count()


# error-string prefix kill() stamps on every request it fails
KILLED_ERROR_PREFIX = "replica killed"


_DRAFTER_PINS = ("prompt_lookup", "learned", "auto")

# scheduler counters, named and ordered as the reference's; the prefix-cache,
# speculative, data-motion, tier and park counters stay 0 until A5/A6
_COUNTERS = ("submitted", "rejected", "completed", "cancelled",
             "timed_out", "failed", "evictions", "batches", "heartbeats",
             "prefix_hits", "prefix_tokens_saved", "prefix_evictions",
             "shed_admission", "shed_queue", "brownout_rejected",
             "brownout_clamped", "spec_drafted", "spec_accepted",
             "spec_steps", "spec_rollback",
             "spec_tree_nodes", "spec_tree_compactions",
             "spec_drafter_switches",
             "spec_drafted_learned", "spec_accepted_learned",
             "spec_drafted_lookup", "spec_accepted_lookup",
             "peer_fetch_hits", "peer_fetch_rejects",
             "peer_fetch_blocks", "steals",
             "tier_demotions", "brownout_demotions",
             "parks", "rehydrates", "fair_share_shed")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch yet (see ROADMAP.md {item})")


def _validate_drafter_pin(drafter) -> Optional[str]:
    if drafter is None:
        return None
    if drafter not in _DRAFTER_PINS:
        raise ValueError(f"unknown drafter {drafter!r}: "
                         f"expected one of {_DRAFTER_PINS}")
    return drafter


class QueueFullError(RuntimeError):
    """reject-mode backpressure: the submission queue is at capacity."""


class SchedulerStopped(RuntimeError):
    """submit() after stop(): the scheduler no longer admits requests."""


class AdmissionRejected(RuntimeError):
    """Overload control refused the request at submission — the deadline is
    provably unmeetable at the measured rate, or the brownout stage rejects
    its priority class. ``retry_after_s`` is the queue-drain-derived backoff
    the HTTP layer surfaces as a ``Retry-After`` header (429)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ServingScheduler:
    """Owns the request lifecycle end-to-end over one :class:`InferenceEngineV2`.

    ``start=False`` skips the background thread; callers (tests, or an outer
    event loop) then drive ``step()`` manually. Exactly one scheduler may be
    attached to an engine at a time; ``engine.close()`` stops it.
    """

    def __init__(self, engine, config: Optional[ServingConfig] = None, start: bool = True):
        if getattr(engine, "_serving_scheduler", None) is not None:
            raise RuntimeError("engine already has an attached ServingScheduler; "
                               "stop it (or engine.close()) first")
        self._config = config or ServingConfig()
        self._refuse_unported(self._config)
        self._engine = engine
        self._metrics = ServingMetrics.maybe_create()
        # per-instance channel: two schedulers under one telemetry session
        # must not clobber each other's provider or heartbeat watch
        self._flight_channel = f"{SERVING_SCHEDULER_CHANNEL}:{next(_SCHEDULER_IDS)}"
        self._flight = None

        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}  # uid -> Request, admission order
        # the request _admit popped but has not yet activated: neither queued
        # nor active, but drain and load accounting must still see it
        self._admitting: Optional[Request] = None
        self._uids = itertools.count()
        self._counters = {k: 0 for k in _COUNTERS}
        self._stopping = False   # no new submits
        self._shutdown = False   # thread exit
        self._stopped = False
        self._killed = False     # kill(): abrupt-death disposition ran
        self._kill_reason: Optional[str] = None
        self._ready = threading.Event()  # the loop has started ticking
        self._starved_ticks = 0
        self._start_s = time.monotonic()
        self._last_heartbeat_s = 0.0
        # pool capacity for permanent-infeasibility checks (a prompt needing
        # more KV blocks than the whole pool can never run)
        self._capacity_blocks = engine._state_manager.kv_cache.num_blocks

        # overload control (serving/overload.py): the measured-rate estimator
        # feeds admission feasibility + Retry-After; the brownout controller
        # maps smoothed pressure to staged degradation. Both exist even when
        # disabled (stage stays 0, estimator unread) so the hot path is one
        # boolean, not a None check per site.
        ocfg = self._config.overload
        self._rate = RateEstimator(alpha=ocfg.rate_alpha,
                                   min_samples=ocfg.min_rate_samples)
        self._brownout = BrownoutController(
            thresholds=ocfg.brownout_stage_thresholds,
            hysteresis=ocfg.brownout_hysteresis,
            alpha=ocfg.pressure_alpha)
        self._brownout_transitions_seen = 0
        # fair-share admission (opt-in): the policy itself is pressure-
        # independent; THIS scheduler gates every consult on brownout stage
        # >= 1, so an uncontended engine never sheds on share arithmetic
        self._fair_share = None
        if ocfg.enabled and ocfg.fair_share_enabled:
            self._fair_share = FairSharePolicy(
                shares=ocfg.fair_share_shares,
                alpha=ocfg.fair_share_alpha,
                over_factor=ocfg.fair_share_over_factor,
                hysteresis=ocfg.fair_share_hysteresis)

        engine._serving_scheduler = self
        # armed last: flight_state() must never observe a half-built
        # scheduler; a manually-step()ped scheduler (start=False) has no loop
        # to watch
        self._attach_flight(telemetry.get_flight_recorder(), watch=start)
        self._thread = None
        if start:
            self._thread = threading.Thread(target=self._run, name="dstpu-serving-scheduler",
                                            daemon=True)
            self._thread.start()

    @staticmethod
    def _refuse_unported(cfg: ServingConfig) -> None:
        for what, on, item in (
                ("serving.prefix_cache", cfg.prefix_cache.enabled, "A5"),
                ("serving.speculative", cfg.speculative.enabled, "A5"),
                ("serving.kv_tiers", cfg.kv_tiers.enabled, "A5"),
                ("serving.cost (the cost ledger, built while a telemetry session is active)",
                 cfg.cost.enabled and telemetry.is_active(), "A5"),
                ("serving.overload.slo_pressure (the SLO engine)", cfg.overload.slo_pressure, "A6")):
            if on:
                raise _unported(what, item)

    @property
    def _spans(self):
        """The live SpanRecorder (None while telemetry is off) — resolved per
        use, so a telemetry reconfigure mid-serve cannot strand the scheduler
        on a displaced recorder."""
        return telemetry.get_span_recorder()

    def _attach_flight(self, flight, watch: bool = True) -> None:
        """Move this scheduler's state provider + watchdog channel to
        ``flight``: a telemetry reconfigure replaces the process-wide
        recorder, and dumps/stall detection must follow it (the loop
        re-attaches whenever the recorder changes)."""
        old = self._flight
        if old is flight:
            return
        if old is not None:
            old.unwatch_heartbeat(self._flight_channel)
            old.unregister_provider(self._flight_channel)
        self._flight = flight
        if flight is not None:
            flight.register_provider(self._flight_channel, self.flight_state)
            if watch:
                flight.watch_heartbeat(self._flight_channel)

    def _charge_members(self, members) -> None:
        """Feed one executed dispatch's plan members (``[(req, phase,
        tokens)]``) to the fair-share policy's per-tenant rate EWMAs."""
        if self._fair_share is not None:
            by_tenant: Dict[str, int] = {}
            for req, _, tokens in members:
                if req.tenant is not None:
                    by_tenant[req.tenant] = by_tenant.get(req.tenant, 0) + tokens
            now = time.monotonic()
            for tenant, tokens in by_tenant.items():
                self._fair_share.observe(tenant, tokens, now=now)

    # ------------------------------------------------------------- submission --
    def submit(self,
               prompt,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               seed: int = 0,
               trace_id: Optional[str] = None,
               parent_span_id: Optional[int] = None,
               handoff: bool = False,
               priority: Optional[str] = None,
               park: bool = False,
               drafter: Optional[str] = None,
               tenant: Optional[str] = None) -> Request:
        """Enqueue a generation request (any thread). Returns the live
        :class:`Request`; stream tokens from ``request.stream`` or block on
        ``request.result()``. Backpressure per ``config.backpressure``:
        ``reject`` raises :class:`QueueFullError`, ``block`` stalls until the
        queue has room. With overload control enabled, a brownout stage-3
        batch-class request or a provably-unmeetable deadline raises
        :class:`AdmissionRejected` (HTTP 429 + ``Retry-After``) instead of
        being admitted to fail later.

        ``trace_id``/``parent_span_id`` adopt an upstream trace instead of
        minting a fresh one. ``handoff`` and ``park`` (KV export at finish)
        are ROADMAP A5 and raise. ``drafter`` is validated and, with
        speculative decoding off (A5), ignored, as the reference ignores a
        pin it cannot honor. ``tenant`` is the request's identity for the
        fair-share stage (None lands on ``config.cost.default_tenant``)."""
        if handoff:
            raise _unported("the KV handoff export (handoff=True)", "A5")
        if park:
            raise _unported("session parking (park=True)", "A5")
        req = Request(prompt,
                      max_new_tokens=max_new_tokens if max_new_tokens is not None
                      else self._config.default_max_new_tokens,
                      temperature=temperature,
                      eos_token_id=eos_token_id,
                      deadline_s=deadline_s if deadline_s is not None
                      else self._config.default_deadline_s,
                      seed=seed,
                      priority=validate_priority(priority),
                      tenant=tenant)
        req._spec_drafter_pin = _validate_drafter_pin(drafter)
        self._admission_gate(req)
        return self._enqueue(req, trace_id, parent_span_id)

    def submit_resume(self, payload, **kwargs) -> Request:
        """Admit a handed-off sequence for decode continuation: ROADMAP A5."""
        raise _unported("submit_resume (KV handoff import)", "A5")

    def export_prefix(self, digests, min_blocks: int = 1, timeout: float = 5.0):
        """Frame cached prefix KV for a fleet peer: ROADMAP A5."""
        raise _unported("export_prefix (the prefix cache)", "A5")

    def request_steal(self, handle: str, timeout: float = 5.0) -> dict:
        """Fleet work stealing: ROADMAP A6."""
        raise _unported("request_steal (fleet work stealing)", "A6")

    def _enqueue(self, req: Request, trace_id: Optional[str],
                 parent_span_id: Optional[int]) -> Request:
        if self._spans is not None:
            # trace identity is assigned at admission so the HTTP layer can
            # hand the id back in response headers before streaming begins
            req.trace_id = trace_id if trace_id else new_trace_id()
            req.root_span_id = new_span_id()
            req.parent_span_id = parent_span_id
        with self._not_full:
            if self._stopping:
                raise SchedulerStopped("scheduler is stopping; not admitting requests")
            if len(self._queue) >= self._config.queue_capacity:
                if self._config.backpressure == "reject":
                    self._counters["rejected"] += 1
                    if self._metrics:
                        self._metrics.rejections.inc()
                    raise QueueFullError(
                        f"queue at capacity ({self._config.queue_capacity})")
                while len(self._queue) >= self._config.queue_capacity and not self._stopping:
                    self._not_full.wait(0.05)
                if self._stopping:
                    raise SchedulerStopped("scheduler stopped while blocked on a full queue")
            self._queue.append(req)
            self._counters["submitted"] += 1
            if self._metrics:
                self._metrics.admissions.inc()
                self._metrics.queue_depth.set(len(self._queue))
        return req

    def cancel(self, request: Request) -> None:
        """Flag a request for cancellation; the scheduler thread frees its KV
        blocks on the next tick (``Request.cancel()`` is equivalent)."""
        request.cancel()

    # ---------------------------------------------------------- overload --
    @staticmethod
    def _request_work(req: Request) -> int:
        """Engine-token work this request still needs: unfed prompt tokens
        plus its remaining generation budget."""
        return (max(0, int(req.prompt.size) - req._fed)
                + max(0, req.max_new_tokens - len(req.tokens)))

    def _active_work_tokens(self) -> int:
        """Outstanding work already admitted into the engine (active plus the
        one mid-admission request)."""
        work = sum(self._request_work(r) for r in list(self._active.values()))
        admitting = self._admitting
        if admitting is not None:
            work += self._request_work(admitting)
        return work

    def _outstanding_work_tokens(self) -> int:
        """Everything committed or queued, in engine tokens — the numerator
        of every queue-wait / Retry-After estimate."""
        with self._not_full:
            queued = list(self._queue)
        return self._active_work_tokens() + sum(self._request_work(r)
                                                for r in queued)

    def retry_after_s(self) -> float:
        """Client backoff derived from the measured drain rate: how long the
        currently-committed-plus-queued work takes at the observed token
        rate, bounded by the configured floor/cap. Cold estimator: the floor
        scaled by queue depth (some signal beats none)."""
        ocfg = self._config.overload
        est = self._rate.seconds_for(self._outstanding_work_tokens())
        if est is None:
            est = ocfg.retry_after_floor_s * (1 + self.queue_depth)
        return min(ocfg.retry_after_cap_s, max(ocfg.retry_after_floor_s, est))

    def _admission_gate(self, req: Request) -> None:
        """submit()-time overload gate (any thread): brownout stage actions
        for the batch class, then the deadline-feasibility estimate. Raises
        :class:`AdmissionRejected` — failing here is cheap; admitting a
        provably-doomed request wastes prefill work and queue capacity."""
        if req.tenant is None:
            # every request bills to a concrete tenant from here on (the
            # fair-share EWMAs and the stats rows key on it)
            req.tenant = self._config.cost.default_tenant
        ocfg = self._config.overload
        if not ocfg.enabled:
            return
        stage = self._brownout.stage
        fs = self._fair_share
        if fs is not None:
            fs.note(req.tenant)
            if stage >= 1 and fs.over_share(req.tenant):
                # the fair-share stage fires only under pressure: a tenant
                # past over_factor x its configured share is 429'd before
                # anyone else degrades
                self._counters["fair_share_shed"] += 1
                fs.sheds += 1
                if self._metrics:
                    self._metrics.fair_share_sheds.inc()
                raise AdmissionRejected(
                    f"fair-share: tenant {req.tenant!r} is over its share "
                    f"under overload (brownout stage {stage})",
                    retry_after_s=self.retry_after_s())
        if stage >= 1 and req.priority == "batch":
            if stage >= self._brownout.max_stage:
                self._counters["brownout_rejected"] += 1
                if self._metrics:
                    self._metrics.brownout_rejections.inc()
                raise AdmissionRejected(
                    f"brownout stage {stage}: batch-class requests are "
                    f"rejected under overload", retry_after_s=self.retry_after_s())
            if req.max_new_tokens > ocfg.brownout_clamp_max_new_tokens:
                req.max_new_tokens = ocfg.brownout_clamp_max_new_tokens
                req.degraded_mode.append("max_new_tokens_clamped")
                self._counters["brownout_clamped"] += 1
                if self._metrics:
                    self._metrics.brownout_clamped.inc()
        if stage >= 2 and self._config.decode_chunk > 1:
            # the decode chunk is globally off at stage >= 2 (the first
            # capacity lever that touches no request's token budget); flagged
            # per affected request so no degradation is silent
            req.degraded_mode.append("speculative_disabled")
        if ocfg.admission_control and req.deadline_s is not None:
            own = self._request_work(req)
            est = self._rate.seconds_for(self._outstanding_work_tokens() + own)
            if est is not None and est > req.deadline_s * ocfg.admission_margin:
                self._counters["shed_admission"] += 1
                if self._metrics:
                    self._metrics.shed_admission.inc()
                raise AdmissionRejected(
                    f"deadline unmeetable at admission: estimated completion "
                    f"{est:.2f}s > deadline {req.deadline_s:.2f}s at the "
                    f"measured rate", retry_after_s=self.retry_after_s())

    def _queue_order_key(self, req: Request):
        return (priority_rank(req.priority),
                req.deadline if req.deadline is not None else float("inf"),
                req.arrival_s)

    def _pop_next_locked(self) -> Request:
        """Next request to admit (caller holds the queue lock): FIFO without
        overload control; (priority, deadline, arrival) order with it."""
        ocfg = self._config.overload
        if not (ocfg.enabled and ocfg.priority_ordering):
            return self._queue.popleft()
        best = min(self._queue, key=self._queue_order_key)
        self._queue.remove(best)
        return best

    def _pop_shed_reason(self, req: Request, now: float) -> Optional[str]:
        """Cheap per-request feasibility re-check at admission pop: the
        estimate may have collapsed since submit(). A reason string fails the
        request *before* it consumes any engine work; None admits."""
        ocfg = self._config.overload
        if (not ocfg.enabled or not ocfg.admission_control
                or req.deadline is None):
            return None
        est = self._rate.seconds_for(self._active_work_tokens()
                                     + self._request_work(req))
        remaining = req.deadline - now
        if est is not None and est > max(0.0, remaining) * ocfg.admission_margin:
            return (f"deadline unmeetable at admission (est {est:.2f}s, "
                    f"{remaining:.2f}s remaining)")
        return None

    def _overload_tick(self, now: float) -> None:
        """Per-tick pressure sampling -> brownout stage -> queue shedding."""
        with self._not_full:
            depth = len(self._queue)
        kv_occupancy = (1.0 - self._engine.free_blocks / self._capacity_blocks
                        if self._capacity_blocks else 0.0)
        pressure = max(depth / self._config.queue_capacity, kv_occupancy)
        stage = self._brownout.update(pressure)
        if self._brownout.transitions != self._brownout_transitions_seen:
            delta = self._brownout.transitions - self._brownout_transitions_seen
            self._brownout_transitions_seen = self._brownout.transitions
            logger.warning(f"serving: brownout stage -> {stage} "
                           f"(pressure {self._brownout.pressure:.2f})")
            if self._metrics:
                self._metrics.brownout_transitions.inc(delta)
                self._metrics.brownout_stage.set(stage)
        if stage >= 1 and self._config.overload.shed_enabled:
            self._shed_queued(now)

    def _shed_queued(self, now: float) -> None:
        """Under sustained pressure, shed queued requests whose deadline is
        provably unmeetable at the measured rate — before they waste a
        prefill. The feasibility walk runs in scheduling order (work ahead of
        a request is work that WILL run first); the doomed are shed lowest
        priority / latest deadline first.

        The fair-share pass runs first and independently of the rate
        estimator (the policy owns its own per-tenant EWMAs)."""
        with self._not_full:
            queued = list(self._queue)
        if not queued:
            return
        self._shed_fair_share(queued)
        rate = self._rate.rate
        if rate is None or rate <= 0:
            return  # cannot prove anything on a cold estimator
        queued = [r for r in queued if not r.finished]
        margin = self._config.overload.admission_margin
        acc = self._active_work_tokens()
        doomed = []
        for req in sorted(queued, key=self._queue_order_key):
            own = self._request_work(req)
            if req.deadline is not None and \
                    (acc + own) / rate > max(0.0, req.deadline - now) * margin:
                doomed.append(req)
                continue  # its work will never run; don't charge the others
            acc += own
        doomed.sort(key=lambda r: (-priority_rank(r.priority),
                                   -(r.deadline - now)))
        # one drain-rate estimate for the whole pass
        retry_after = self.retry_after_s() if doomed else None
        for req in doomed:
            with self._not_full:
                try:
                    self._queue.remove(req)
                except ValueError:
                    continue  # raced into admission
                self._not_full.notify()
            req.shed_reason = ("queue shed under overload: deadline provably "
                               "unmeetable")
            req.retry_after_s = retry_after
            self._counters["shed_queue"] += 1
            if self._metrics:
                self._metrics.shed_queue.inc()
            self._finalize(req, RequestState.FAILED,
                           error=f"shed: {req.shed_reason}")

    def _shed_fair_share(self, queued: List[Request]) -> None:
        """Shed queued work from over-share tenants (this only runs from
        :meth:`_overload_tick`'s stage >= 1 branch — never unpressured).
        Deficit order: the most-over tenant's requests go first, and every
        shed carries the same Retry-After contract as any other 429."""
        fs = self._fair_share
        if fs is None:
            return
        over = [r for r in queued
                if r.tenant is not None and fs.over_share(r.tenant)]
        if not over or len(over) == len(queued):
            # work-conserving guard: shed only while an under-share tenant is
            # actually waiting behind the over-share work
            return
        over.sort(key=lambda r: -fs.deficit(r.tenant))
        retry_after = self.retry_after_s()
        for req in over:
            with self._not_full:
                try:
                    self._queue.remove(req)
                except ValueError:
                    continue  # raced into admission
                self._not_full.notify()
            req.shed_reason = (f"fair-share shed under overload: tenant "
                               f"{req.tenant!r} is over its share")
            req.retry_after_s = retry_after
            self._counters["fair_share_shed"] += 1
            fs.sheds += 1
            if self._metrics:
                self._metrics.fair_share_sheds.inc()
            self._finalize(req, RequestState.FAILED,
                           error=f"shed: {req.shed_reason}")

    # ------------------------------------------------------------------ tick --
    def step(self) -> bool:
        """One scheduling iteration; returns True iff a batch executed.
        Runs on the scheduler thread — or inline when ``start=False``."""
        now = time.monotonic()
        for req in list(self._active.values()):
            # the deadline check doubles as the decode feed-stop: a request
            # past its deadline is finalized HERE, before batch building, so
            # it never receives another decode step
            if req.cancel_requested:
                self._finalize(req, RequestState.CANCELLED)
            elif req.deadline is not None and now > req.deadline:
                self._finalize(req, RequestState.TIMED_OUT)
        if self._config.overload.enabled:
            self._overload_tick(now)
        self._admit(now)
        plan = self._build_batch()
        if not plan:
            if not self._active:
                self._starved_ticks = 0  # idle, not starved
            else:
                self._starved_ticks += 1
                if self._starved_ticks >= _STARVATION_FAIL_TICKS:
                    for req in list(self._active.values()):
                        self._finalize(req, RequestState.FAILED,
                                       error=f"starved: unschedulable for "
                                             f"{self._starved_ticks} ticks "
                                             f"({self._engine.free_blocks} free KV blocks)")
                    self._starved_ticks = 0  # a fresh grace period for later work
            return False
        self._starved_ticks = 0
        self._execute(plan)
        self._counters["batches"] += 1
        return True

    def _admit(self, now: float) -> None:
        max_active = self._engine._config.state_manager.max_tracked_sequences
        while True:
            # the queue condition guards ONLY the pop: engine work below must
            # never run under the lock submit()'s handler threads block on
            with self._not_full:
                if not self._queue or len(self._active) >= max_active:
                    break
                req = self._pop_next_locked()
                self._admitting = req  # visible to _has_work/load while popped
                self._not_full.notify()
            try:
                if req.cancel_requested:
                    self._finalize(req, RequestState.CANCELLED)
                    continue
                if req.deadline is not None and now > req.deadline:
                    if self._config.overload.enabled:
                        # deadline-failed while queued = rejected at
                        # admission: zero engine work was spent, so the
                        # client gets the same Retry-After contract as a shed
                        req.retry_after_s = self.retry_after_s()
                    self._finalize(req, RequestState.TIMED_OUT)
                    continue
                shed = self._pop_shed_reason(req, now)
                if shed is not None:
                    req.shed_reason = shed
                    req.retry_after_s = self.retry_after_s()
                    self._counters["shed_admission"] += 1
                    if self._metrics:
                        self._metrics.shed_admission.inc()
                    self._finalize(req, RequestState.FAILED, error=f"shed: {shed}")
                    continue
                infeasible = self._permanently_infeasible(req)
                if infeasible:
                    self._finalize(req, RequestState.FAILED, error=infeasible)
                    continue
                req.uid = next(self._uids)
                req._set_state(RequestState.PREFILL)
                with self._not_full:
                    self._active[req.uid] = req
            finally:
                self._admitting = None
            spans = self._spans  # bind once: the property re-resolves
            if spans is not None:
                spans.record("queued", cat="serving", ts_us=req.arrival_us,
                             dur_us=now_us() - req.arrival_us,
                             trace_id=req.trace_id,
                             parent_id=req.root_span_id,
                             args={"uid": req.uid})
        if self._metrics:
            with self._not_full:
                queue_depth = len(self._queue)
            self._metrics.queue_depth.set(queue_depth)
            self._metrics.in_flight.set(len(self._active))

    def _permanently_infeasible(self, req: Request) -> Optional[str]:
        """A reason this request can NEVER be scheduled, or None. Failing at
        admission beats starving it forever against budgets that will not
        change."""
        sm = self._engine._config.state_manager
        if req.prompt.size + 1 > sm.max_context:
            return (f"prompt of {req.prompt.size} tokens exceeds max_context="
                    f"{sm.max_context} (room for at least one generated token "
                    f"is required)")
        block_size = self._engine._state_manager.kv_block_size
        min_blocks = -(-(req.prompt.size + 1) // block_size)
        if min_blocks > self._capacity_blocks:
            return (f"prompt needs {min_blocks} KV blocks; the pool holds "
                    f"{self._capacity_blocks}")
        return None

    # -------------------------------------------------------- batch building --
    def _build_batch(self) -> List[Tuple[Request, np.ndarray]]:
        engine = self._engine
        sm_cfg = engine._config.state_manager
        budget = sm_cfg.max_ragged_batch_size
        plan: List[Tuple[Request, np.ndarray]] = []
        uids: List[int] = []
        lens: List[int] = []

        def admission(uid: int, n: int) -> SchedulingResult:
            return engine.can_schedule(uids + [uid], lens + [n])

        def admit(req: Request, toks) -> None:
            toks = np.asarray(toks, np.int32).reshape(-1)
            uids.append(req.uid)
            lens.append(toks.size)
            plan.append((req, toks))

        def admit_under_pressure(req: Request, n: int) -> bool:
            """1-token admission with evict-coldest retries on KV pressure."""
            while True:
                result = admission(req.uid, n)
                if result == SchedulingResult.Success:
                    return True
                if result != SchedulingResult.KVCacheLimitExceeded:
                    return False  # token/sequence budget: eviction cannot help
                if not self._evict_one(set(uids) | {req.uid}):
                    return False

        def by_pressure_priority(reqs):
            # requests deferred under KV pressure go first the next tick —
            # in-batch sequences are never eviction candidates, so without
            # this a permanently-admitted peer could starve a deferred one
            return sorted(reqs, key=lambda r: (-r._deferred, r.uid))

        # --- decode tokens first: one each, latency-critical
        for req in by_pressure_priority(
                [r for r in list(self._active.values()) if r.state is RequestState.DECODE]):
            if len(lens) + 1 > sm_cfg.max_ragged_sequence_count or sum(lens) + 1 > budget:
                break
            seq = engine._state_manager.get_sequence(req.uid)
            if seq is not None and seq.seen_tokens + 1 > sm_cfg.max_context:
                # context window exhausted: a clean length-cut, not an error
                req.finish_reason = "context"
                self._finalize(req, RequestState.DONE)
                continue
            if admit_under_pressure(req, 1):
                req._deferred = 0
                admit(req, [req._next])
            else:
                req._deferred += 1  # KV held by in-flight work; retry next tick

        # --- prompt chunks fill what's left (Dynamic SplitFuse)
        for req in by_pressure_priority(
                [r for r in list(self._active.values()) if r.state is RequestState.PREFILL]):
            room = budget - sum(lens)
            if self._config.max_prefill_chunk is not None:
                room = min(room, self._config.max_prefill_chunk)
            if room < 1 or len(lens) + 1 > sm_cfg.max_ragged_sequence_count:
                break
            remaining = req.prompt[req._fed:]
            while True:
                chunk = remaining[:room]
                while chunk.size and admission(req.uid, chunk.size) != SchedulingResult.Success:
                    chunk = chunk[:chunk.size // 2]  # shrink under KV pressure first
                if chunk.size or not self._evict_one(set(uids) | {req.uid}):
                    break  # admitted something, or nothing left to evict
            if chunk.size:
                req._deferred = 0
                admit(req, chunk)
            else:
                req._deferred += 1
        return plan

    def _evict_one(self, exclude_uids) -> bool:
        """Free device KV blocks under pressure: offload the coldest idle
        engine-resident sequence (not in the batch being built), which
        restores transparently when next touched. Returns False when nothing
        is evictable."""
        engine = self._engine
        candidates = []
        for req in self._active.values():
            if req.uid in exclude_uids or engine.is_offloaded(req.uid):
                continue
            seq = engine._state_manager.get_sequence(req.uid)
            if seq is not None and seq.cur_allocated_blocks > 0:
                candidates.append(req)
        if not candidates:
            return False
        coldest = min(candidates, key=lambda r: r._last_touch_s)
        engine.offload_sequence(coldest.uid)
        self._counters["evictions"] += 1
        if self._metrics:
            self._metrics.evictions.inc()
        return True

    # --------------------------------------------------------------- execute --
    def _execute(self, plan: List[Tuple[Request, np.ndarray]]) -> None:
        engine = self._engine
        uids = [req.uid for req, _ in plan]
        tokens = [t for _, t in plan]
        now = time.monotonic()
        for req, _ in plan:
            req._last_touch_s = now
        spans = self._spans
        if spans is not None:
            # capture each request's phase before the processing loop mutates
            # state (PREFILL flips to DECODE on the final chunk)
            _t0 = now_us()
            _phases = [("prefill" if req.state is RequestState.PREFILL else "decode",
                        int(toks.size)) for req, toks in plan]

        def _record_phase_spans(counts=None):
            if spans is None:
                return
            end = now_us()
            for i, ((phase, ntok), (req, _)) in enumerate(zip(_phases, plan)):
                spans.record(phase, cat="serving", ts_us=_t0, dur_us=end - _t0,
                             trace_id=req.trace_id, parent_id=req.root_span_id,
                             args={"uid": req.uid,
                                   "tokens": ntok if counts is None else counts[i]})

        K = self._config.decode_chunk
        if K > 1 and self._config.overload.enabled and self._brownout.stage >= 2:
            K = 1  # brownout stage >= 2: chunked decode disabled
        max_context = self._engine._config.state_manager.max_context

        def chunk_safe(req):
            # greedy only (a sampled batch must keep each request on its own
            # private seeded stream, which a shared device PRNG cannot honor)
            # and never past max_context: the device loop always runs K steps,
            # and tokens beyond the context window must not reach the client
            seq = engine._state_manager.get_sequence(req.uid)
            return (req.temperature <= 0.0
                    and (seq is None or seq.seen_tokens + K <= max_context))

        decode_only = (K > 1 and all(req.state is RequestState.DECODE
                                     and chunk_safe(req) for req, _ in plan))
        if decode_only:
            try:
                rows = np.asarray(engine.decode_loop(uids, tokens, K))
            except SchedulingError:
                rows = None  # KV too tight for K steps — single-step fallback
            if rows is not None:
                # record before pushing: the final token finalizes the request
                # and closes the root span, which children must nest inside —
                # with the kept-token counts driving BOTH the span args and
                # the push loop, so trace and stream cannot disagree
                counts = [self._kept_tokens(req, row)
                          for (req, _), row in zip(plan, rows)]
                self._rate.observe(sum(counts))
                # billed work is what the device ran: K decode steps per
                # member, kept or not (the discarded over-run still computed)
                self._charge_members([(req, "decode", K) for req, _ in plan])
                _record_phase_spans(counts=counts)
                for (req, _), row, kept in zip(plan, rows, counts):
                    req.decode_steps += 1
                    # eos/cap discard the over-generated tail
                    self._push_burst(req, row[:kept])
                return

        try:
            # the engine's logits live on its device: one copy to the host
            # per put, here, where the scheduler reads them
            logits = engine.put(uids, tokens).float().cpu().numpy()
        except Exception as e:  # pragma: no cover - defensive: the scheduler
            # thread must survive an engine fault; the batch's requests fail
            logger.exception("serving: engine.put failed; failing the batch")
            for req, _ in plan:
                self._finalize(req, RequestState.FAILED, error=f"engine error: {e}")
            return
        self._rate.observe(sum(int(t.size) for t in tokens))
        # attribute BEFORE the processing loop flips any PREFILL to DECODE
        self._charge_members(
            [(req, "prefill" if req.state is RequestState.PREFILL else "decode",
              int(toks.size)) for req, toks in plan])
        _record_phase_spans()
        for i, (req, toks) in enumerate(plan):
            if req.state is RequestState.PREFILL:
                self._advance_prefill(req, toks, logits[i])
            else:
                req.decode_steps += 1
                nxt = self._sample(req, logits[i])
                self._push_token(req, nxt)
                if not req.finished:
                    req._next = nxt

    def _advance_prefill(self, req: Request, toks: np.ndarray, last_row) -> None:
        """Account one executed prefill chunk; on the final chunk: flip to
        DECODE and emit the first token from the chunk's final-position
        logits."""
        req._fed += toks.size
        if req._fed < req.prompt.size:
            return  # mid-prefill logits are meaningless
        req._set_state(RequestState.DECODE)
        nxt = self._sample(req, last_row)
        self._push_token(req, nxt)
        if not req.finished:
            req._next = nxt

    def _push_burst(self, req: Request, toks) -> None:
        """Stream a multi-token burst (a decode chunk's kept tokens): pushes
        honor :meth:`_push_token`'s finish rules, ``req._next`` advances to
        the last pushed token, and the dispatch gap is amortized per token so
        ITL reflects the cadence a client sees rather than the microsecond
        host loop."""
        prev = req._last_token_s
        pushed = 0
        for tok in toks:
            self._push_token(req, int(tok), record_itl=False)
            pushed += 1
            if req.finished:
                break  # _push_token's rules stay the authority
        if not req.finished and pushed:
            req._next = int(toks[pushed - 1])
        if self._metrics and prev is not None and pushed:
            gap = (req._last_token_s - prev) / pushed
            for _ in range(pushed):
                self._metrics.itl.observe(gap)

    @staticmethod
    def _kept_tokens(req: Request, row) -> int:
        """How many of a decode-loop ``row``'s tokens the client will receive
        — the device loop always runs K steps; eos / the max_new_tokens cap
        cut the tail. Mirrors :meth:`_push_token`'s termination rules (the
        per-token authority); keep the two in lock-step."""
        n = 0
        for tok in row:
            n += 1
            if ((req.eos_token_id is not None and int(tok) == req.eos_token_id)
                    or len(req.tokens) + n >= req.max_new_tokens):
                break
        return n

    @staticmethod
    def _sample(req: Request, row: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(row))
        if req._rng is None:
            req._rng = np.random.default_rng(req.seed)
        z = row.astype(np.float64) / req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(req._rng.choice(row.shape[0], p=p))

    def _push_token(self, req: Request, tok: int, record_itl: bool = True) -> None:
        now = time.monotonic()
        req.tokens.append(tok)
        if req.first_token_s is None:
            req.first_token_s = now
            if self._metrics:
                self._metrics.ttft.observe(now - req.arrival_s)
        elif self._metrics and record_itl:
            self._metrics.itl.observe(now - req._last_token_s)
        req._last_token_s = now
        req.stream.put(tok)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            req.finish_reason = "eos"
            self._finalize(req, RequestState.DONE)
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            self._finalize(req, RequestState.DONE)

    # -------------------------------------------------------------- finalize --
    _FINAL_COUNTER = {RequestState.DONE: "completed", RequestState.CANCELLED: "cancelled",
                      RequestState.TIMED_OUT: "timed_out", RequestState.FAILED: "failed"}

    def _finalize(self, req: Request, state: RequestState, error: Optional[str] = None) -> None:
        """Terminal transition on the scheduler thread: free engine state
        (tracked OR offloaded KV), close the stream, account."""
        if req.finished:
            return
        req.error = error
        if req.uid is not None:
            self._active.pop(req.uid, None)
            if self._engine._state_manager.get_sequence(req.uid) is not None:
                self._engine.flush(req.uid)  # returns KV blocks (incl. offloaded)
        req._set_state(state)
        self._counters[self._FINAL_COUNTER[state]] += 1
        spans = self._spans  # bind once: the property re-resolves
        if spans is not None and req.trace_id is not None:
            # the trace's root: arrival → terminal state, with the ids every
            # lifecycle child span parented under
            spans.record("request", cat="serving", ts_us=req.arrival_us,
                         dur_us=now_us() - req.arrival_us,
                         trace_id=req.trace_id, span_id=req.root_span_id,
                         parent_id=req.parent_span_id,
                         args={"uid": req.uid, "state": state.name,
                               "finish_reason": req.finish_reason,
                               "prompt_tokens": int(req.prompt.size),
                               "cached_tokens": req.cached_tokens,
                               "generated": len(req.tokens),
                               "resumed": False})
        if self._metrics:
            {RequestState.DONE: self._metrics.completions,
             RequestState.CANCELLED: self._metrics.cancellations,
             RequestState.TIMED_OUT: self._metrics.timeouts,
             RequestState.FAILED: self._metrics.failures}[state].inc()
            self._metrics.e2e.observe(req.e2e_s)
            self._metrics.in_flight.set(len(self._active))

    # ------------------------------------------------------------------ loop --
    def _run(self) -> None:
        self._ready.set()  # readiness gate: the loop is ticking
        while not self._shutdown:
            if self._kill_reason is not None:
                self._die()  # in-flight disposition on the engine-owning thread
                return
            flight = telemetry.get_flight_recorder()
            if flight is not self._flight:
                self._attach_flight(flight)
            if flight is not None:
                flight.heartbeat(self._flight_channel)
            try:
                progressed = self.step()
            except Exception:  # pragma: no cover - must never kill the thread
                logger.exception("serving scheduler: step() raised")
                progressed = False
            if not progressed:
                self._maybe_heartbeat()
                time.sleep(self._config.scheduler_tick_s)

    def _maybe_heartbeat(self) -> None:
        enabled = self._config.heartbeat_enabled
        if enabled is None:
            enabled = self._engine._config.expert_parallel.enabled
        if not enabled:
            return
        now = time.monotonic()
        if now - self._last_heartbeat_s >= self._config.heartbeat_interval_s:
            self._last_heartbeat_s = now
            self._counters["heartbeats"] += 1
            self._engine.empty_run()

    # ------------------------------------------------------------------ stop --
    @property
    def ready(self) -> bool:
        """Readiness (the ``/healthz`` gate): the background loop has started
        ticking. A manually-driven scheduler (``start=False``) is ready by
        construction; a stopped/killed one is not."""
        if self._stopped:
            return False
        return self._ready.is_set() or self._thread is None

    def kill(self, reason: str = "killed") -> None:
        """Abrupt-death disposition (``stop()`` is the graceful sibling): no
        drain, every queued and in-flight request is finalized FAILED with a
        ``replica killed:`` error so streams observe the death as a terminal
        event, KV blocks return to the pool, and the loop exits. Idempotent."""
        if self._stopped or self._killed:
            return
        with self._not_full:
            self._stopping = True
            self._kill_reason = reason
            self._not_full.notify_all()  # wake blocked submitters
        if self._thread is not None:
            self._thread.join()  # _run sees the flag and runs _die()
            self._thread = None
        else:
            self._die()

    def _die(self) -> None:
        """The kill disposition, on the engine-owning thread: fail everything
        terminal, free KV, detach, mark dead."""
        error = f"{KILLED_ERROR_PREFIX}: {self._kill_reason or 'killed'}"
        for req in list(self._active.values()):
            self._finalize(req, RequestState.FAILED, error=error)
        while self._queue:
            self._finalize(self._queue.popleft(), RequestState.FAILED, error=error)
        self._shutdown = True
        self._killed = True
        if getattr(self._engine, "_serving_scheduler", None) is self:
            self._engine._serving_scheduler = None
        self._attach_flight(None)
        self._stopped = True

    def _has_work(self) -> bool:
        return (bool(self._queue) or bool(self._active)
                or self._admitting is not None)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the scheduler: no further admissions; with ``drain`` in-flight
        and queued requests get up to ``timeout`` (default
        ``config.drain_timeout_s``) to finish, then the remainder is
        CANCELLED. Idempotent."""
        if self._stopped:
            return
        if timeout is None:
            timeout = self._config.drain_timeout_s
        with self._not_full:
            self._stopping = True
            self._not_full.notify_all()  # wake blocked submitters
        deadline = time.monotonic() + (timeout if drain else 0.0)
        if self._thread is not None:
            while drain and self._has_work() and time.monotonic() < deadline:
                time.sleep(min(self._config.scheduler_tick_s, 0.01))
            self._shutdown = True
            self._thread.join()
            self._thread = None
        else:
            while drain and self._has_work() and time.monotonic() < deadline:
                if not self.step():
                    time.sleep(self._config.scheduler_tick_s)
        # cancel whatever drain didn't finish (scheduler thread is dead, so
        # touching the engine from here is safe)
        for req in list(self._active.values()):
            self._finalize(req, RequestState.CANCELLED)
        while self._queue:
            self._finalize(self._queue.popleft(), RequestState.CANCELLED)
        if getattr(self._engine, "_serving_scheduler", None) is self:
            self._engine._serving_scheduler = None
        self._attach_flight(None)
        self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=False)

    # ----------------------------------------------------------------- stats --
    @property
    def queue_depth(self) -> int:
        # an in-admission request (popped) still counts as pending work
        return len(self._queue) + (1 if self._admitting is not None else 0)

    @property
    def n_active(self) -> int:
        return len(self._active)

    def _snapshot_requests(self) -> Tuple[List[Request], List[Request]]:
        """(queued, active) request lists copied for reader threads (stats /
        flight dumps). Prefers a brief lock so the copy is consistent with
        admission; falls back to a lockless copy (GIL-atomic in CPython) when
        the scheduler thread is wedged holding the lock."""
        locked = self._lock.acquire(timeout=0.2)
        try:
            return list(self._queue), list(self._active.values())
        finally:
            if locked:
                self._lock.release()

    @staticmethod
    def _request_row(req: Request, now: float) -> dict:
        return {
            "uid": req.uid,
            "state": req.state.name,
            "priority": req.priority,
            "tenant": req.tenant,
            "prompt_tokens": int(req.prompt.size),
            "cached_tokens": req.cached_tokens,
            "generated": len(req.tokens),
            "age_s": now - req.arrival_s,
            "ttft_s": req.ttft_s,
            "trace_id": req.trace_id,
            # cost-to-date: the cost ledger is A5, so always None here
            "cost": None,
        }

    def _latency_percentiles(self) -> Optional[dict]:
        """p50/p95/p99 TTFT/ITL/e2e from the telemetry histograms' buckets
        (Histogram.quantile) — None when telemetry is disabled."""
        if not self._metrics:
            return None
        out = {}
        for name, hist in (("ttft_s", self._metrics.ttft),
                           ("itl_s", self._metrics.itl),
                           ("e2e_s", self._metrics.e2e)):
            out[name] = {f"p{int(q * 100)}": hist.quantile(q)
                         for q in (0.5, 0.95, 0.99)}
        return out

    def usage(self) -> dict:
        """The ``/v1/usage`` document: ``{"enabled": False}`` (the cost ledger
        is A5), plus the fair-share posture when that stage is on."""
        doc = {"enabled": False}
        if self._fair_share is not None:
            doc["fair_share"] = self._fair_share.doc()
        return doc

    def stats(self) -> dict:
        queued, active = self._snapshot_requests()
        return self._stats_doc(queued, active)

    def _stats_doc(self, queued: List[Request], active: List[Request]) -> dict:
        # the reference's document, key for key; the A5/A6 blocks (prefix
        # cache, speculative, KV tiers, perf, time series, SLO) are None, as
        # the reference reports them with those features off
        now = time.monotonic()
        return {
            "queue_depth": len(queued),
            "active": {
                "total": len(active),
                "prefill": sum(1 for r in active if r.state is RequestState.PREFILL),
                "decode": sum(1 for r in active if r.state is RequestState.DECODE),
            },
            "requests": [self._request_row(r, now) for r in active],
            "latency": self._latency_percentiles(),
            "counters": dict(self._counters),
            "engine": {
                "free_blocks": self._engine.free_blocks,
                "capacity_blocks": self._capacity_blocks,
                "tracked_sequences": self._engine._state_manager.n_tracked_sequences,
            },
            "prefix_cache": None,
            "speculative": None,
            "kv_tiers": None,
            "usage": self.usage(),
            "perf": None,
            "timeseries": None,
            "slo": None,
            "overload": {
                "enabled": self._config.overload.enabled,
                "brownout_stage": self._brownout.stage,
                "pressure": round(self._brownout.pressure, 4),
                "rate_tokens_per_s": self._rate.rate,
                "retry_after_s": round(self.retry_after_s(), 3),
            },
            "draining": self._stopping,
            "uptime_s": time.monotonic() - self._start_s,
        }

    def flight_state(self) -> dict:
        """The flight recorder's view: ``stats()`` plus queued-request rows,
        per-request scheduler internals and KV occupancy — everything a
        post-mortem of a wedged loop needs."""
        now = time.monotonic()
        queued, active = self._snapshot_requests()
        doc = self._stats_doc(queued, active)
        doc["queued_requests"] = [self._request_row(r, now) for r in queued]
        engine = self._engine
        rows = []
        for req in active:
            row = self._request_row(req, now)
            seq = engine._state_manager.get_sequence(req.uid)
            row.update(
                fed_tokens=req._fed,
                cached_tokens=req.cached_tokens,
                deferred_ticks=req._deferred,
                deadline_in_s=(req.deadline - now) if req.deadline is not None else None,
                kv_blocks=seq.cur_allocated_blocks if seq is not None else 0,
                offloaded=engine.is_offloaded(req.uid),
            )
            rows.append(row)
        doc["requests"] = rows
        doc["starved_ticks"] = self._starved_ticks
        return doc
