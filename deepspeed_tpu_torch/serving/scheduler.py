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

With ``speculative.enabled`` a drafter proposes draft tokens per decoding
request at batch-build time (``inference/v2/spec/``): prompt lookup feeds a
linear ``1+k`` verify through ``engine.verify``, the learned (Medusa-style)
heads and ``auto`` arbitration feed token trees through
``engine.verify_tree``. Each request accepts the longest prefix its own
sampling rule would have emitted and rolls back (or compacts) the rest, so
output equals speculation off, greedy or sampled, in fewer dispatches.

With ``prefix_cache.enabled`` admission maps each prompt's longest cached
prefix (``ragged/prefix_cache.py``) into a pre-populated sequence, so only
the suffix prefills; a fully cached prompt re-feeds its last token into a
block forked copy-on-write. Prompts publish their full blocks at prefill
completion and their whole history at finalize. With ``kv_tiers.enabled``
(``serving/kv_tiers.py``) pressure demotes idle cached state down the
device→host→disk ladder before anything is evicted or shed. ``handoff`` and
``park`` export a finished request as a frame (``ragged/handoff.py``) that
``submit_resume`` continues on another engine; ``export_prefix`` frames
cached KV for a peer.

While a telemetry session is active the cost plane (``telemetry/ledger.py``
+ ``perf/observed.py``) bills every dispatch, KV block-second, wire byte and
cache saving to its request and tenant (``usage()``, ``/v1/usage``), and
joins each dispatch's observed seconds against the roofline price (the
stats document's ``perf`` block); ``overload.slo_pressure`` floors the
brownout pressure with the SLO engine's breach signal.

Not ported yet, and refused with ``NotImplementedError``: fleet work
stealing (ROADMAP A6).
"""

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.v2.ragged import handoff as _handoff
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import PrefixCache, digest_chain
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError, SchedulingResult
from deepspeed_tpu_torch.inference.v2.spec import LearnedDrafter, MedusaDraftHead, PromptLookupDrafter, TokenTree
from deepspeed_tpu_torch.perf.observed import PerfObservedLedger
from deepspeed_tpu_torch.serving import kv_tiers as _kv_tiers_mod
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.overload import (BrownoutController, FairSharePolicy,
                                                  RateEstimator, priority_rank,
                                                  validate_priority)
from deepspeed_tpu_torch.serving.request import Request, RequestState
from deepspeed_tpu_torch.telemetry import new_span_id, new_trace_id, now_us
from deepspeed_tpu_torch.telemetry.flight_recorder import SERVING_SCHEDULER_CHANNEL
from deepspeed_tpu_torch.telemetry.ledger import CostLedger, PriceBook
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

# scheduler counters, named and ordered as the reference's; the steal counter
# stays 0 (fleet work stealing is ROADMAP A6)
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
        self._engine = engine
        self._config = config or ServingConfig()
        self._metrics = ServingMetrics.maybe_create()
        # per-instance channel: two schedulers under one telemetry session
        # must not clobber each other's provider or heartbeat watch
        self._flight_channel = f"{SERVING_SCHEDULER_CHANNEL}:{next(_SCHEDULER_IDS)}"
        self._flight = None

        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}  # uid -> Request, admission order
        # the request _admit popped but has not yet activated (a resume KV
        # import runs in this window, off the lock): it is neither queued nor
        # active, but drain and load accounting must still see it
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

        # fleet data motion: cross-thread control calls (prefix export for a
        # peer fetch) run on THIS loop via _call_on_loop — the engine, the
        # trie and the block allocator are all single-threaded state, so a
        # probe/handler thread must never touch them directly
        self._control: deque = deque()
        # fleet-installed hook: fn(digests, have_blocks) -> payload | None.
        # Called on the scheduler thread at admission when the local trie
        # match is shallower than the request's chain; a returned frame is
        # CRC/digest-validated before any block lands.
        self._peer_fetch = None
        # companion hook: fn("hit" | "reject") — lets the fleet layer mirror
        # peer-fetch outcomes into its own metric registry
        self._peer_fetch_notify = None

        # cost-attribution plane (telemetry/ledger.py + perf/observed.py):
        # both exist only while a telemetry session is active, so every
        # charging site below is one `is not None` check and disabled
        # telemetry pays nothing — the same zero-cost contract as _metrics.
        # The engine's dispatch_observer stashes each dispatch's seconds
        # here (same thread, same tick) for the execute path to attribute.
        ccfg = self._config.cost
        self._ledger = None
        self._perf_obs = None
        self._last_dispatch_s = 0.0
        self._last_dispatch_amnesty_s = 0.0
        if ccfg.enabled and telemetry.is_active():
            pricebook = PriceBook.from_model_config(getattr(getattr(engine, "model", None), "config", None))
            registry = telemetry.get_registry()
            self._ledger = CostLedger(registry, pricebook, max_tenants=ccfg.max_tenants,
                                      tenant_metric_top_k=ccfg.tenant_metric_top_k,
                                      default_tenant=ccfg.default_tenant)
            self._perf_obs = PerfObservedLedger(registry, pricebook, chip=ccfg.perf_chip,
                                                drift_factor=ccfg.perf_drift_factor,
                                                drift_consecutive=ccfg.perf_drift_consecutive,
                                                baseline_dispatches=ccfg.perf_baseline_dispatches)
            engine.dispatch_observer = self._on_dispatch

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

        # automatic prefix caching: radix-tree KV reuse with copy-on-write
        # block sharing (inference/v2/ragged/prefix_cache.py). All trie
        # mutation happens on the scheduler thread — the same thread that owns
        # every other engine touch.
        self._prefix_cache = None
        if self._config.prefix_cache.enabled:
            self._prefix_cache = PrefixCache(
                engine._state_manager.kv_cache,
                max_blocks=self._config.prefix_cache.max_blocks,
                min_prefix_blocks=self._config.prefix_cache.min_prefix_blocks)

        # tiered KV memory (serving/kv_tiers.py over ragged/tiering.py):
        # retrofits the engine's host→disk ladder with the operator's budget
        # and drives demote-under-pressure — idle cached state moves down a
        # tier before anything is evicted or shed
        self._kv_tiers = _kv_tiers_mod.maybe_create(engine, self._config.kv_tiers, metrics=self._metrics)

        # speculative decoding (inference/v2/spec/): a model-free drafter
        # proposes k continuation tokens per decode step at batch-build time;
        # the engine verifies 1+k positions in one ragged forward and the
        # execute path accepts the longest matching prefix. Trie-backed when
        # the prefix cache runs, self-lookup otherwise.
        self._drafter = None
        self._spec_accept_ewma: Optional[float] = None
        self._drafter_mode = "prompt_lookup"
        self._learned = None
        self._spec_head_id: Optional[str] = None
        self._spec_drafter_ewmas: Dict[str, float] = {}
        if self._config.speculative.enabled:
            scfg = self._config.speculative
            self._drafter = PromptLookupDrafter(min_ngram=scfg.min_ngram, max_ngram=scfg.max_ngram,
                                                prefix_cache=self._prefix_cache)
            self._drafter_mode = scfg.drafter
            if scfg.drafter != "prompt_lookup":
                # learned / auto: Medusa-style heads read the target's hidden
                # state and propose token trees verified by engine.verify_tree;
                # "auto" races them against prompt lookup per request on
                # measured acceptance EWMAs. Untrained fresh heads are safe:
                # acceptance adapts their k to 0 until spec.distill trains them
                if scfg.draft_head_path:
                    head = MedusaDraftHead.load(scfg.draft_head_path)
                else:
                    mcfg = engine.model.config
                    head = MedusaDraftHead.fresh(mcfg.hidden_size, mcfg.vocab_size,
                                                 num_heads=scfg.num_draft_heads)
                self._learned = LearnedDrafter(head, width=scfg.tree_width, node_budget=scfg.tree_node_budget)
                self._spec_head_id = head.head_id

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

    # ------------------------------------------------------------ cost plane --
    def _on_dispatch(self, kind: str, n_seqs: int, n_tokens: int, seconds: float) -> None:
        """Engine ``dispatch_observer`` hook (scheduler thread, fired once a
        dispatch's device work has finished): feeds the predicted-vs-observed
        perf ledger and stashes the seconds — minus any compile amnesty — for
        the execute path's cost attribution on the same tick."""
        amnesty = 0.0
        if self._perf_obs is not None:
            amnesty = self._perf_obs.observe(kind, n_seqs, n_tokens, seconds)
        self._last_dispatch_s = seconds - amnesty
        self._last_dispatch_amnesty_s = amnesty

    def _charge_members(self, members, seconds: Optional[float] = None, amnesty: Optional[float] = None) -> None:
        """Bill one executed dispatch to its plan members
        (``[(req, phase, tokens)]``): ledger attribution amortized by token
        share, plus the fair-share policy's per-tenant rate EWMAs. Defaults
        to the observer-stashed seconds of the dispatch that just ran."""
        if self._ledger is not None and members:
            self._ledger.charge_dispatch([(req.cost, phase, tokens) for req, phase, tokens in members],
                                         self._last_dispatch_s if seconds is None else seconds,
                                         self._last_dispatch_amnesty_s if amnesty is None else amnesty)
        if self._fair_share is not None:
            by_tenant: Dict[str, int] = {}
            for req, _, tokens in members:
                if req.tenant is not None:
                    by_tenant[req.tenant] = by_tenant.get(req.tenant, 0) + tokens
            now = time.monotonic()
            for tenant, tokens in by_tenant.items():
                self._fair_share.observe(tenant, tokens, now=now)

    def _touch_kv_plan(self, plan) -> None:
        """Re-anchor each scheduled request's KV block-second accrual at its
        current (blocks, tier) — piecewise-constant billing between execute
        ticks; the final segment closes at ledger finalize."""
        if self._ledger is None:
            return
        sm = self._engine._state_manager
        now_s = time.monotonic()
        for req, _ in plan:
            if req.cost is None:
                continue
            seq = sm.get_sequence(req.uid)
            blocks = seq.cur_allocated_blocks if seq is not None else 0
            tier = (sm.sequence_tier(req.uid) or "device") if blocks else "device"
            self._ledger.touch_kv(req.cost, blocks, tier, now_s)

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
        minting a fresh one. ``handoff`` marks a prefill-role request: when
        it finishes DONE its engine state is exported as a portable
        KV-handoff payload (``request.handoff_payload``) for
        :meth:`submit_resume` on a decode-role peer. ``park`` marks a
        continuable multi-turn session: at finish (length OR eos) the engine
        state exports as a v2 park frame (``request.park_payload``) that a
        later :meth:`submit_resume` rehydrates with the next turn's full
        prompt.

        ``drafter`` pins this request's speculative drafter
        (``prompt_lookup`` | ``learned`` | ``auto``), overriding the
        scheduler's ``SpeculativeConfig.drafter`` arbitration. A pin the
        scheduler cannot honor (``learned`` without a draft head, or any pin
        on a linear prompt_lookup scheduler, or speculation off) is ignored,
        never an error: output does not depend on the drafter.

        ``tenant`` is the cost-attribution identity (JSON field or
        ``X-DSTPU-Tenant`` header at the HTTP layer): the ledger bills every
        dispatch/KV/wire charge to it and the opt-in fair-share stage sheds
        a tenant over its measured share first under pressure. None lands on
        ``config.cost.default_tenant``."""
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
        req.park_requested = bool(park)
        req._spec_drafter_pin = _validate_drafter_pin(drafter)
        self._admission_gate(req)
        return self._enqueue(req, trace_id, parent_span_id, handoff)

    def submit_resume(self,
                      payload: bytes,
                      max_new_tokens: Optional[int] = None,
                      temperature: float = 0.0,
                      eos_token_id: Optional[int] = None,
                      deadline_s: Optional[float] = None,
                      seed: int = 0,
                      trace_id: Optional[str] = None,
                      parent_span_id: Optional[int] = None,
                      handoff: bool = False,
                      priority: Optional[str] = None,
                      prompt=None,
                      park: bool = False,
                      drafter: Optional[str] = None,
                      tenant: Optional[str] = None) -> Request:
        """Admit a handed-off sequence for decode continuation: ``payload`` is
        an ``engine.export_sequence`` product from a prefill-role peer (of
        either package: the frames are the same bytes). The scheduler imports
        it into its engine at admission (on the scheduler thread — the engine
        is not thread-safe) and the request enters DECODE directly; its
        ``prompt`` is the full token history so context, deadline and stats
        accounting match a locally-prefilled request. Generation state (next
        input token, sampler RNG state) rides in the payload's ``extra``
        block, so greedy AND sampled continuations are token-identical to
        the single-engine run. ``request.tokens`` holds only the tokens
        generated HERE; the caller merges with the prefill leg's.

        ``prompt`` switches to the *rehydrate* formulation (a parked
        multi-turn session returning with its next turn): it is the new
        turn's FULL token history, of which the payload's parked tokens must
        be a strict prefix. The parked KV imports as-is and the request
        enters PREFILL for the un-parked suffix only. The new turn samples on
        its own ``seed`` (the parked ``rng_state`` is NOT adopted), so the
        result is identical to an uninterrupted request over the same full
        prompt at the same seed. A handoff frame's drafter state
        (``extra["spec"]``: the acceptance EWMA, the drafted and accepted
        counts, the per-drafter EWMAs and the head id) is adopted, so
        adaptive k resumes where the donor stopped; a learned EWMA from
        another head is dropped."""
        if not isinstance(payload, (bytes, bytearray)):
            # materialize views; a bytearray from the streaming body decoder
            # is kept as-is (copying it would double the resume peak memory)
            payload = bytes(payload)
        header, kv = _handoff.unpack(payload)  # validate framing before queueing
        extra = header.get("extra") or {}
        if prompt is None and "next_token" not in extra:
            raise ValueError(
                "handoff payload carries no next_token (the donor request must "
                "finish with finish_reason='length' to be continuable, or the "
                "caller must rehydrate with the next turn's prompt)")
        if prompt is not None:
            new_prompt = np.asarray(prompt, np.int32).reshape(-1)
            parked = [int(t) for t in header["tokens"]]
            if (new_prompt.size <= len(parked)
                    or [int(t) for t in new_prompt[:len(parked)]] != parked):
                raise ValueError(
                    "rehydrate prompt must strictly extend the parked token "
                    "history (the parked turns are a proper prefix of the "
                    "returning turn's prompt)")
        req = Request(new_prompt if prompt is not None else header["tokens"],
                      max_new_tokens=max_new_tokens if max_new_tokens is not None
                      else self._config.default_max_new_tokens,
                      temperature=temperature,
                      eos_token_id=eos_token_id,
                      deadline_s=deadline_s if deadline_s is not None
                      else self._config.default_deadline_s,
                      seed=seed,
                      priority=validate_priority(priority),
                      tenant=tenant)
        req._resume_payload = payload
        req._resume_header = header
        req._rehydrate = prompt is not None
        req.park_requested = bool(park)
        req._spec_drafter_pin = _validate_drafter_pin(drafter)
        self._admission_gate(req)  # after the header lands: resume work is
        # its generation budget (plus a rehydrate's un-parked suffix) only,
        # the donor already paid the parked turns' prefill
        req._resume_kv = kv  # zero-copy view into payload; parsed exactly once
        if req._rehydrate:
            req.kv_tier_source = (extra.get("tier") or {}).get("source")
            return self._enqueue(req, trace_id, parent_span_id, handoff)
        req._next = int(extra["next_token"])
        rng_state = extra.get("rng_state")
        if rng_state is not None:
            # exact sampler continuation: the donor's PCG64 state, not a
            # reseed — sampled handoffs stay token-identical
            req._rng = np.random.default_rng()
            req._rng.bit_generator.state = rng_state
        req.decode_steps = int(extra.get("decode_steps") or 0)
        spec = extra.get("spec")
        if spec:
            # drafter continuation: adopt the donor's acceptance EWMA and
            # counters so adaptive k resumes where it left off
            ewma = spec.get("accept_ewma")
            req._spec_ewma = float(ewma) if ewma is not None else None
            req.spec_drafted = int(spec.get("drafted") or 0)
            req.spec_accepted = int(spec.get("accepted") or 0)
            drafters = spec.get("drafters")
            if drafters:
                donor_head = spec.get("head_id")
                for name, val in drafters.items():
                    if name == "learned" and donor_head is not None \
                            and donor_head != self._spec_head_id:
                        # a different head's acceptance record says nothing
                        # about ours: the learned drafter re-explores cold
                        continue
                    req._spec_ewmas[str(name)] = float(val)
        return self._enqueue(req, trace_id, parent_span_id, handoff)

    def request_steal(self, handle: str, timeout: float = 5.0) -> dict:
        """Fleet work stealing: ROADMAP A6."""
        raise _unported("request_steal (fleet work stealing)", "A6")

    def _enqueue(self, req: Request, trace_id: Optional[str],
                 parent_span_id: Optional[int], handoff: bool) -> Request:
        req.handoff_requested = bool(handoff)
        if self._ledger is not None:
            # every admitted request carries a RequestCost from birth (the
            # charging sites assume it); rejected requests never get one
            self._ledger.begin(req)
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
        plus its remaining generation budget (a resume request's prompt was
        prefilled by the donor; a rehydrate owes only the un-parked suffix)."""
        if req._resume_header is not None and not req._rehydrate:
            return max(0, req.max_new_tokens - len(req.tokens))
        fed = req._fed
        if req._rehydrate and fed == 0:
            # not yet imported: the parked turns count as already-fed
            fed = int(req._resume_header["seen_tokens"])
        return (max(0, int(req.prompt.size) - fed)
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
            # ledger, the fair-share EWMAs and the stats rows all key on it)
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
        if stage >= 2 and (self._config.decode_chunk > 1
                           or self._config.speculative.enabled):
            # speculative extras — the decode chunk and the draft budget —
            # are globally off at stage >= 2 (the first capacity lever that
            # touches no request's token budget); flagged per affected
            # request so no degradation is silent
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
        if self._config.overload.slo_pressure:
            # config-gated: a burning error budget floors the pressure sample
            # even while queue depth and KV occupancy look healthy
            slo = telemetry.get_slo_engine()
            if slo is not None:
                pressure = max(pressure, slo.breach_signal())
        stage = self._brownout.update(pressure)
        if self._brownout.transitions != self._brownout_transitions_seen:
            delta = self._brownout.transitions - self._brownout_transitions_seen
            self._brownout_transitions_seen = self._brownout.transitions
            logger.warning(f"serving: brownout stage -> {stage} "
                           f"(pressure {self._brownout.pressure:.2f})")
            if self._metrics:
                self._metrics.brownout_transitions.inc(delta)
                self._metrics.brownout_stage.set(stage)
        if stage >= 1:
            # demote-before-shed: with the tier ladder on, pressure first
            # pushes idle cached KV down a tier (nothing is lost — it
            # promotes back on the next hit). Shedding only runs on ticks
            # where demotion freed nothing.
            demoted = self._demote_for_pressure()
            if demoted == 0 and self._config.overload.shed_enabled:
                self._shed_queued(now)
        if self._kv_tiers is not None:
            self._kv_tiers.update_gauges(self._prefix_cache)

    def _demote_for_pressure(self) -> int:
        """Brownout's demote stage: one controller pass down the tier ladder
        (trie nodes device→host, then coldest offloaded sessions host→disk).
        Returns demotions performed; 0 when tiering is off or nothing is
        demotable (shedding then proceeds as before)."""
        if self._kv_tiers is None:
            return 0
        demoted = self._kv_tiers.demote_for_pressure(
            self._prefix_cache, list(self._active.values()))
        if demoted:
            self._counters["brownout_demotions"] += demoted
        return demoted

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
        self._drain_control()
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
            # the queue condition guards ONLY the pop: engine work below (a
            # resume import scatters hundreds of MB of KV and may evict) must
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
                if req._resume_payload is None and self._prefix_cache is not None:
                    try:
                        self._apply_prefix_hit(req)
                    except Exception:  # pragma: no cover - defensive: a failed
                        # hit application degrades to a cold prefill, never a
                        # failed request
                        logger.exception(f"serving: prefix-cache hit application "
                                         f"failed for uid {req.uid}; prefilling cold")
                if req._resume_payload is not None:
                    outcome = self._import_resume(req)
                    if outcome is None:
                        # the pool can't hold the handed-off KV right now and
                        # nothing was evictable: put it back, retry next tick
                        req.uid = None
                        with self._not_full:
                            self._queue.appendleft(req)
                        break
                    if outcome != "ok":
                        self._finalize(req, RequestState.FAILED, error=outcome)
                        continue
                # a rehydrate enters PREFILL: its parked KV imported, the
                # un-parked suffix still needs feeding (a handoff enters
                # DECODE — its donor fed everything)
                req._set_state(RequestState.DECODE
                               if (req._resume_header is not None
                                   and not req._rehydrate)
                               else RequestState.PREFILL)
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

    def _import_resume(self, req: Request) -> Optional[str]:
        """Import a handed-off sequence under the request's uid (scheduler
        thread — the engine is not thread-safe), evicting cold idle sequences
        under KV pressure. ``"ok"`` = imported, the engine owns the state;
        ``None`` = the pool is full and nothing was evictable (retry next
        tick); any other string = the import failed with the pool able to
        hold the payload — NOT capacity, the request can never land (FAIL it
        rather than retry the queue head forever). Known-permanent problems
        (geometry, payload > pool or > per-sequence cap) were already
        rejected by :meth:`_permanently_infeasible`."""
        kv_meta = (req._resume_header or {}).get("kv")
        needed = int(kv_meta["shape"][2]) if kv_meta else 0
        # the manager-level import reuses the header/KV parsed once at
        # submit_resume (compatibility was checked by _permanently_infeasible)
        # rather than re-unpacking the full payload on every retry
        snapshot = {"uid": req.uid,
                    "seen_tokens": req._resume_header["seen_tokens"],
                    "kv": req._resume_kv}
        while True:
            try:
                self._engine._state_manager.import_sequence(snapshot, uid=req.uid)
            except Exception as e:
                if self._engine.free_blocks >= needed:
                    return f"handoff import failed: {e}"
                if self._evict_one({req.uid}):
                    continue
                return None
            if self._ledger is not None and req.cost is not None:
                self._ledger.charge_wire(req.cost, "resume", len(req._resume_payload))
            req._resume_payload = None  # imported; the engine owns the KV now
            req._resume_kv = None
            if req._rehydrate:
                # the parked turns are prefilled; the new turn's suffix is
                # not — feed resumes exactly at the import's seen_tokens (the
                # boundary token re-feeds, same KV slot, like a full prefix
                # hit) so the cached turns schedule zero prefill chunks
                seen = int(snapshot["seen_tokens"])
                req._fed = seen
                req.cached_tokens = seen
                self._counters["rehydrates"] += 1
            else:
                req._fed = req.prompt.size  # whole history already prefilled
            return "ok"

    # -------------------------------------------------- fleet data motion --
    def _call_on_loop(self, fn, timeout: float = 5.0):
        """Run ``fn`` on the scheduler (engine-owning) thread and return its
        result — the cross-thread entry for fleet control operations (peer
        prefix export). A manually-stepped scheduler
        (``start=False``) runs inline; otherwise the call is queued and
        drained at the top of the next ``step()``. Raises ``TimeoutError``
        when the loop does not service it in ``timeout`` (a wedged or
        mutually-fetching peer: the caller degrades, never deadlocks) and
        :class:`SchedulerStopped` when the scheduler dies first."""
        if self._stopped or self._killed:
            raise SchedulerStopped("scheduler is stopped")
        if self._thread is None:
            return fn()
        box = {"done": threading.Event(), "result": None, "error": None}
        self._control.append((fn, box))
        if not box["done"].wait(timeout):
            raise TimeoutError(f"scheduler control call not serviced in {timeout}s")
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def _drain_control(self) -> None:
        """Service queued control calls (scheduler thread, top of every tick)."""
        while self._control:
            try:
                fn, box = self._control.popleft()
            except IndexError:  # pragma: no cover - single consumer
                break
            try:
                box["result"] = fn()
            except BaseException as e:
                box["error"] = e
            box["done"].set()

    def _fail_control(self) -> None:
        """Unblock every pending control caller at stop/kill — a waiter must
        observe the death, not its timeout."""
        while self._control:
            try:
                _, box = self._control.popleft()
            except IndexError:  # pragma: no cover - single consumer
                break
            box["error"] = SchedulerStopped("scheduler stopped before the "
                                            "control call was serviced")
            box["done"].set()

    def prefix_digest_catalog(self) -> Optional[List[str]]:
        """Truncated-hex digests of this replica's hottest trie paths — what
        the probe doc publishes for the fleet's cache-aware routing. Safe from
        probe threads (lock-guarded snapshot; staleness is bounded by the
        probe TTL). None = cache off or publication disabled."""
        if self._prefix_cache is None:
            return None
        limit = self._config.prefix_cache.digest_catalog_limit
        if limit <= 0:
            return None
        return self._prefix_cache.digest_catalog(limit)

    def export_prefix(self, digests, min_blocks: int = 1,
                      timeout: float = 5.0) -> Optional[bytes]:
        """Frame this replica's cached KV along ``digests`` (full chained
        block digests) as a portable payload — the peer prefix-fetch donor
        side. Any thread; the trie walk AND the device gather run on the
        scheduler loop so no block can be freed or recycled mid-gather (the
        allocator is not thread-safe, and a CRC computed over a recycled
        block would certify garbage). None = no path at least ``min_blocks``
        deep (or the cache is off)."""
        if self._prefix_cache is None:
            return None
        digests = list(digests)
        floor = max(1, min_blocks)

        def _do():
            blocks, tokens = self._prefix_cache.export_nodes(digests)
            if len(blocks) < floor:
                return None
            return _handoff.pack_blocks(self._engine._state_manager, blocks, tokens,
                                        extra={"kind": "prefix"})
        return self._call_on_loop(_do, timeout=timeout)

    def _import_peer_prefix(self, req: Request, have: int) -> bool:
        """Traced wrapper around :meth:`_import_peer_prefix_inner`: the fetch
        is a leg of the request's trace — it records under the request root
        with the original trace id, so a cross-replica KV import shows up in
        the merged fleet trace instead of as unexplained prefill latency."""
        spans = self._spans
        if spans is None:
            return self._import_peer_prefix_inner(req, have)
        _t0 = now_us()
        ok = self._import_peer_prefix_inner(req, have)
        spans.record("peer_prefix_fetch", cat="serving", ts_us=_t0,
                     dur_us=now_us() - _t0, trace_id=req.trace_id,
                     parent_id=req.root_span_id,
                     args={"uid": req.uid, "have_blocks": have, "imported": ok})
        return ok

    def _import_peer_prefix_inner(self, req: Request, have: int) -> bool:
        """Fetch KV blocks along the request's prefix chain from a fleet peer
        (the router-installed hook) and publish them into the local trie;
        True = the trie now indexes a deeper prefix than ``have`` blocks and
        the caller should re-acquire. Every failure mode — transport error,
        CRC mismatch, geometry drift, a payload whose tokens do not extend
        THIS prompt's chain — rejects loudly and degrades to a cold prefill:
        recompute is always correct."""
        pc = self._prefix_cache
        sm = self._engine._state_manager
        notify = self._peer_fetch_notify or (lambda outcome: None)
        try:
            payload = self._peer_fetch(list(req._prefix_digests), have)
        except Exception as e:
            self._counters["peer_fetch_rejects"] += 1
            notify("reject")
            logger.warning(f"serving: peer prefix fetch failed: {e}")
            return False
        if payload is None:
            return False
        try:
            header, kv = _handoff.unpack(payload)  # CRC verified here: a flipped byte
            # in the KV region is a ValueError, never silently wrong attention
            err = _handoff.compatibility_error(sm, header)
            if err:
                raise ValueError(err)
            tokens = np.asarray(header["tokens"], np.int32)
            if kv is None or tokens.size != kv.shape[2] * sm.kv_block_size:
                raise ValueError("peer prefix payload is not block-aligned")
            got = digest_chain(tokens, sm.kv_block_size)
            if len(got) <= have or got != req._prefix_digests[:len(got)]:
                raise ValueError("peer prefix does not extend this prompt's "
                                 "cached chain")
        except ValueError as e:
            self._counters["peer_fetch_rejects"] += 1
            notify("reject")
            logger.warning(f"serving: rejecting peer prefix payload: {e}")
            return False
        needed = int(kv.shape[2])
        while True:
            try:
                ids = sm.kv_cache.scatter_blocks(kv)
                break
            except Exception:
                if self._engine.free_blocks >= needed:
                    self._counters["peer_fetch_rejects"] += 1
                    notify("reject")
                    return False  # not a capacity problem: give up, recompute
                if not self._evict_one({req.uid}):
                    return False  # pool genuinely can't hold it right now
        # publish takes trie references on the NEW nodes only; dropping the
        # import reference then frees exactly the blocks that duplicated an
        # already-indexed prefix
        pc.publish(tokens, ids, int(tokens.size), digests=got)
        sm.kv_cache.free(ids)
        if self._ledger is not None and req.cost is not None:
            self._ledger.charge_wire(req.cost, "peer_fetch", len(payload))
        self._counters["peer_fetch_hits"] += 1
        self._counters["peer_fetch_blocks"] += needed
        notify("hit")
        if self._metrics:
            self._metrics.prefix_trie_blocks.set(pc.n_blocks)
        return True

    # ---------------------------------------------------------- prefix cache --
    def _apply_prefix_hit(self, req: Request) -> None:
        """Map the longest cached prefix of ``req.prompt`` into a
        pre-populated sequence so only the suffix prefills (scheduler thread).

        A *fully*-cached prompt still re-feeds its final token — the engine
        needs one forward to produce logits — and that token's KV write lands
        in the last matched block, which is shared read-only; that block is
        forked copy-on-write first. When no block is free for the fork (and
        nothing is evictable) the hit degrades by one block instead, keeping
        the write in a fresh suffix block."""
        pc = self._prefix_cache
        sm = self._engine._state_manager
        # hash the prompt exactly once per request: the same chain serves the
        # lookup here and both publish points (prefill completion + finalize)
        req._prefix_digests = pc.chain(req.prompt)
        hit = pc.acquire(req.prompt, digests=req._prefix_digests)
        if (self._peer_fetch is not None
                and len(hit.blocks) < len(req._prefix_digests)
                and self._import_peer_prefix(req, have=len(hit.blocks))):
            # a peer held a deeper prefix and its blocks now live in the
            # local trie: re-acquire over the extended index. One admission
            # stays one lookup in the hit-rate denominator — the retry must
            # not dilute the rate the fleet routing gate reads.
            pc.release(hit.blocks)
            hit = pc.acquire(req.prompt, digests=req._prefix_digests)
            pc.lookups -= 1
        if self._metrics:
            self._metrics.prefix_lookups.inc()
            self._metrics.prefix_lookup_depth.observe(len(hit.blocks))
        if not hit.blocks:
            return
        blocks = list(hit.blocks)
        seen = hit.tokens
        try:
            if seen >= req.prompt.size:
                forked = self._fork_for_cow(blocks[-1], req.uid)
                if forked is None:
                    pc.release([blocks[-1]])
                    blocks.pop()  # degrade: recompute the last cached block
                    if len(blocks) < self._config.prefix_cache.min_prefix_blocks:
                        pc.release(blocks)  # below the configured hit floor
                        return
                    seen = len(blocks) * sm.kv_block_size
                else:
                    pc.release([blocks[-1]])
                    blocks[-1] = int(forked)
                    seen = req.prompt.size - 1  # one last-token step, then DECODE
            sm.create_cached_sequence(req.uid, blocks, seen)
        except Exception:
            # drop every reference this hit still holds (a successful fork
            # swapped the trie ref for a private refcount-1 copy, which the
            # same release frees) — a failed application must leak nothing
            pc.release(blocks)
            raise
        req._fed = seen
        req.cached_tokens = seen
        if self._ledger is not None and req.cost is not None:
            # the savings side of the bill: prompt tokens this request did
            # NOT pay to prefill
            self._ledger.charge_prefix(req.cost, seen)
        pc.record_hit(len(blocks), seen)  # applied for real: now it counts
        self._counters["prefix_hits"] += 1
        self._counters["prefix_tokens_saved"] += seen
        if self._metrics:
            self._metrics.prefix_hits.inc()
            self._metrics.prefix_tokens_saved.inc(seen)
            self._metrics.prefix_trie_blocks.set(pc.n_blocks)

    def _fork_for_cow(self, src_block: int, uid: int) -> Optional[int]:
        """Copy-on-write fork of one shared block, evicting (trie leaves
        first, then cold idle sequences) under KV pressure. None = the pool
        cannot yield a block right now."""
        kv = self._engine._state_manager.kv_cache
        while True:
            if kv.free_blocks >= 1:
                return int(kv.fork_blocks([src_block])[0])
            if not self._evict_one({uid}):
                return None

    def _publish(self, req: Request, seq, tokens, committed: int) -> None:
        """Index ``tokens``' full KV blocks in the prefix trie. Called at two
        points: **prefill completion** (the prompt's blocks — so concurrent
        requests over a shared prefix hit as soon as the first one's prefill
        lands, not only after it finishes generating) and **finalize** on DONE
        (prompt + generated history — multi-turn reuse). Publishing is
        idempotent per content: already-indexed prefixes just refresh LRU.
        The admission-time digest chain is extended, not recomputed."""
        try:
            req._prefix_digests = self._prefix_cache.chain(
                tokens, base=req._prefix_digests)
            self._prefix_cache.publish(tokens, seq.kv_blocks, committed,
                                       digests=req._prefix_digests)
        except Exception:  # pragma: no cover - defensive: publishing is an
            # optimization; a failure must not lose the request's result
            logger.exception(f"serving: prefix-cache publish failed for uid {req.uid}")
        if self._metrics:
            self._metrics.prefix_trie_blocks.set(self._prefix_cache.n_blocks)

    def _publish_finished(self, req: Request, seq) -> None:
        """The finalize-time publish (full history, instead of letting flush
        free the blocks). Valid positions are those whose KV was computed from
        a *kept* token: chunked decode commits discarded over-run tokens past
        the history, so the committed count is capped at the kept length."""
        history = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)]) if req.tokens else req.prompt
        self._publish(req, seq, history, min(seq.seen_tokens, history.size))

    # ---------------------------------------------------- speculative decode --
    def _spec_draft_budget(self) -> int:
        """Draft tokens this batch may spend (0 = drafting off this tick).
        Brownout stage >= 2 zeroes the budget — speculation is the first
        capacity lever pulled under overload, before anything clamps a
        request's own token budget."""
        if self._drafter is None:
            return 0
        if self._config.overload.enabled and self._brownout.stage >= 2:
            return 0
        budget = self._config.speculative.draft_token_budget
        return budget if budget is not None else (1 << 30)

    def _spec_k(self, req: Request) -> int:
        """Per-request adaptive draft depth: the acceptance EWMA scales
        ``max_draft_tokens`` down to 0 on adversarial (pattern-free) text —
        bounded regression — with a periodic single-token probe so acceptance
        can recover when the text turns repetitive again."""
        scfg = self._config.speculative
        ewma = req._spec_ewma
        k = (scfg.max_draft_tokens if ewma is None
             else int(scfg.max_draft_tokens * ewma + 0.5))
        if k == 0 and req.decode_steps % scfg.probe_interval == 0:
            k = 1
        return k

    @staticmethod
    def _history_for(req: Request) -> np.ndarray:
        """The request's token history (prompt + generated) as a read-only
        view over an incrementally-grown buffer: each decode tick copies only
        the newly-pushed tokens, not the whole history — per-token drafting
        cost stays O(new), not O(length)."""
        n = int(req.prompt.size) + len(req.tokens)
        buf = req._spec_history
        if buf is None or n > buf.size:
            grown = np.empty(max(64, 2 * n), np.int32)
            if buf is None:
                grown[:req.prompt.size] = req.prompt
                req._spec_history_len = int(req.prompt.size)
            else:
                grown[:req._spec_history_len] = buf[:req._spec_history_len]
            req._spec_history = buf = grown
        if req._spec_history_len < n:
            tail = req.tokens[req._spec_history_len - int(req.prompt.size):]
            buf[req._spec_history_len:n] = tail
            req._spec_history_len = n
        return buf[:n]

    def _draft_for(self, req: Request, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens for ``req`` (scheduler
        thread). History = prompt + everything generated; the admission-time
        digest chain is extended (never recomputed) so the trie walk hashes
        only newly-completed blocks."""
        history = self._history_for(req)
        digests = None
        if self._prefix_cache is not None:
            req._prefix_digests = self._prefix_cache.chain(
                history, base=req._prefix_digests)
            digests = req._prefix_digests
        return self._drafter.draft(history, k, digests=digests)

    def _pick_drafter(self, req: Request) -> str:
        """Which drafter builds this request's feed this step. ``auto``
        arbitrates on per-request per-drafter acceptance EWMAs: cold drafters
        explore first (learned before lookup — it needs a step to capture its
        hidden state anyway), then the higher EWMA wins, with the loser
        probed every ``probe_interval`` decode steps so arbitration can
        reverse when the text regime changes mid-stream. A per-request pin
        (``submit(drafter=...)``) overrides both, when honorable: a
        ``learned`` pin needs a loaded draft head."""
        pin = req._spec_drafter_pin
        if pin is not None and pin != "auto" and \
                (pin != "learned" or self._learned is not None):
            return pin
        mode = self._drafter_mode
        if mode != "auto":
            return mode
        ew = req._spec_ewmas
        learned, lookup = ew.get("learned"), ew.get("prompt_lookup")
        if learned is None:
            return "learned"
        if lookup is None:
            return "prompt_lookup"
        winner, loser = (("learned", "prompt_lookup") if learned >= lookup
                         else ("prompt_lookup", "learned"))
        if req.decode_steps and \
                req.decode_steps % self._config.speculative.probe_interval == 0:
            return loser  # periodic probe: the loser gets a round to recover
        return winner

    def _arb_update(self, req: Request, name: str, rate: float) -> None:
        """Fold one step's depth-productivity ``rate`` into the arbitration
        EWMAs: the request's (what ``auto`` decides on) and the scheduler's
        (the per-drafter gauge). A picked drafter that proposes NOTHING
        scores 0 here — otherwise "auto" wedges on a drafter that never
        proposes and therefore never gets measured — while ``req._spec_ewma``
        keeps the linear-path rule that an empty draft is not rejection."""
        alpha = self._config.speculative.accept_alpha
        prev = req._spec_ewmas.get(name)
        req._spec_ewmas[name] = (rate if prev is None
                                 else alpha * rate + (1 - alpha) * prev)
        sprev = self._spec_drafter_ewmas.get(name)
        self._spec_drafter_ewmas[name] = (rate if sprev is None
                                          else alpha * rate + (1 - alpha) * sprev)
        if self._metrics:
            gauge = (self._metrics.spec_drafter_learned_ewma if name == "learned"
                     else self._metrics.spec_drafter_lookup_ewma)
            gauge.set(self._spec_drafter_ewmas[name])

    def _draft_tree_for(self, req: Request, k: int, room: int):
        """A :class:`TokenTree` feed for the learned/auto modes (always
        non-None: every decode entry in tree mode feeds a tree, so one
        ``verify_tree`` dispatch carries the whole tick). ``k`` caps draft
        DEPTH, ``room`` caps draft NODES (root excluded) under the ragged
        token budget. A prompt-lookup draft rides as a chain tree — the
        linear verify's function under the tree mask — and a learned draft without a
        valid hidden state bootstraps with a root-only tree whose verify
        returns the hidden state the next step drafts from."""
        scfg = self._config.speculative
        name = self._pick_drafter(req)
        if name != req._spec_last_drafter:
            if req._spec_last_drafter is not None:
                self._counters["spec_drafter_switches"] += 1
                if self._metrics:
                    self._metrics.spec_drafter_switches.inc()
            req._spec_last_drafter = name
        root = np.asarray([req._next], np.int32)
        room = min(room, scfg.tree_node_budget - 1)
        if k <= 0 or room <= 0:
            return TokenTree.chain(root)
        if name == "prompt_lookup":
            draft = self._draft_for(req, min(k, room))
            if draft.size == 0:
                self._arb_update(req, name, 0.0)  # no n-gram match: scored 0
                return TokenTree.chain(root)
            return TokenTree.chain(np.concatenate([root, draft]))
        hist = int(req.prompt.size) + len(req.tokens)
        if req._spec_hidden is None or req._spec_hidden_pos != hist:
            return TokenTree.chain(root)  # bootstrap: capture hidden first
        tree = self._learned.draft_tree(req._spec_hidden, int(req._next), k,
                                        node_budget=room + 1)
        if tree is None:
            self._arb_update(req, name, 0.0)  # nothing fit the node budget
            return TokenTree.chain(root)
        return tree

    def _spec_accept(self, req: Request, feed: np.ndarray, rows: np.ndarray):
        """The acceptance rule over one verify feed. ``rows[j]`` scores the
        token after ``feed[:j+1]``; the emitted sequence is EXACTLY what
        non-speculative decoding would produce: each emitted token is sampled
        (or argmaxed) from the target distribution with the request's own
        stream — one draw per emitted token, same draw order as spec-off — and
        a draft survives only when it equals that token (rejection sampling
        with a point-mass draft distribution). Returns ``(emitted,
        accepted_drafts)``; emission stops at eos / the generation cap,
        mirroring :meth:`_push_token`'s rules."""
        emitted: List[int] = []
        accepted = 0
        k = int(feed.size) - 1
        for j in range(int(feed.size)):
            tok = self._sample(req, rows[j])
            emitted.append(tok)
            if req.eos_token_id is not None and tok == req.eos_token_id:
                break
            if len(req.tokens) + len(emitted) >= req.max_new_tokens:
                break
            if j >= k:
                break  # the bonus token: no more drafts to validate
            if int(feed[j + 1]) != tok:
                break  # rejection: the target model disagrees with the draft
            accepted += 1
        return emitted, accepted

    def _permanently_infeasible(self, req: Request) -> Optional[str]:
        """A reason this request can NEVER be scheduled, or None. Failing at
        admission beats starving it forever against budgets that will not
        change."""
        sm = self._engine._config.state_manager
        if req._resume_header is not None:
            err = _handoff.compatibility_error(self._engine._state_manager, req._resume_header)
            if err:
                return err
            if int(req._resume_header["seen_tokens"]) + 1 > sm.max_context:
                return (f"handed-off sequence has "
                        f"{req._resume_header['seen_tokens']} committed tokens; "
                        f"max_context={sm.max_context} leaves no room to decode")
            if req._rehydrate and req.prompt.size + 1 > sm.max_context:
                return (f"rehydrate prompt of {req.prompt.size} tokens exceeds "
                        f"max_context={sm.max_context} (room for at least one "
                        f"generated token is required)")
            return None
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

        # --- decode tokens first: one each (plus up to k draft tokens when
        # speculation is on), latency-critical
        draft_budget = self._spec_draft_budget()
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
            feed = None
            tree = None
            req._spec_tree = None
            if draft_budget > 0:
                # draft tokens compete with prefill chunks under the same
                # ragged token budget; never draft past the generation cap or
                # the context window (the device commits every fed position)
                room = min(draft_budget, budget - sum(lens) - 1,
                           req.max_new_tokens - len(req.tokens) - 1)
                if seq is not None:
                    room = min(room, sm_cfg.max_context - seq.seen_tokens - 1)
                k = min(self._spec_k(req), room)
                if self._drafter_mode != "prompt_lookup":
                    # learned/auto: every decode entry feeds a TokenTree so
                    # one verify_tree dispatch carries the tick (a root-only
                    # tree when nothing drafts — its verify still returns the
                    # hidden state the learned drafter reads next step)
                    tree = self._draft_tree_for(req, k, room)
                    feed = tree.tokens
                elif k > 0:
                    draft = self._draft_for(req, k)
                    if draft.size:
                        feed = np.concatenate([np.asarray([req._next], np.int32), draft])
            if feed is not None and admission(req.uid, int(feed.size)) == SchedulingResult.Success:
                # drafts are speculative: they never trigger eviction — a feed
                # the pool can't take falls back to the k=0 single token below
                req._deferred = 0
                req._spec_tree = tree
                admit(req, feed)
                draft_budget -= int(feed.size) - 1
            elif admit_under_pressure(req, 1):
                req._deferred = 0
                if tree is not None:
                    # tree mode under pressure: a root-only tree keeps the
                    # tick on one verify_tree dispatch (same 1-token cost)
                    req._spec_tree = TokenTree.chain(np.asarray([req._next], np.int32))
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
        """Free device KV blocks under pressure: evict an unreferenced prefix-
        trie leaf (LRU) first — reclaiming cached-but-idle state costs nothing
        live — then fall back to offloading the coldest idle engine-resident
        sequence (not in the batch being built), which restores transparently
        when next touched. Returns False when nothing is evictable.

        With the tier ladder on, *demotion* runs ahead of the eviction
        ladder: a demoted trie node keeps its KV (host tier, promotes back on
        the next hit) where an evicted leaf recomputes from scratch."""
        if self._kv_tiers is not None and self._prefix_cache is not None:
            freed = self._prefix_cache.demote(1)
            if freed:
                self._counters["tier_demotions"] += freed
                if self._metrics:
                    self._metrics.kv_tier_demotions.inc(freed)
                return True
        if self._prefix_cache is not None:
            freed = self._prefix_cache.evict(1)
            if freed:
                self._counters["prefix_evictions"] += freed
                if self._metrics:
                    self._metrics.prefix_evictions.inc(freed)
                    self._metrics.prefix_trie_blocks.set(self._prefix_cache.n_blocks)
                return True
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
        # close + re-anchor each member's KV block-second segment at its
        # pre-dispatch occupancy (the final segment closes at finalize)
        self._touch_kv_plan(plan)
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

        # tree verify (learned/auto drafters): any decode entry carrying a
        # TokenTree — root-only trees included — routes the tick through one
        # engine.verify_tree dispatch
        if any(req._spec_tree is not None for req, _ in plan):
            self._execute_verify_tree(plan, _record_phase_spans)
            return
        # speculative verify: any decode feed wider than one token (next
        # input + draft tokens) routes the tick through the verify path
        if any(req.state is RequestState.DECODE and toks.size > 1 for req, toks in plan):
            self._execute_verify(plan, _record_phase_spans)
            return

        K = self._config.decode_chunk
        if K > 1 and self._config.overload.enabled and self._brownout.stage >= 2:
            K = 1  # brownout stage >= 2: speculative extras disabled
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
        DECODE, publish the prompt's blocks (peers sharing the prefix are
        likely already queued behind it — the burst shape), and emit the
        first token from the chunk's final-position logits. Shared by the
        put and verify execute paths so prefill behavior cannot depend on
        whether a draft rode the same batch."""
        req._fed += toks.size
        if req._fed < req.prompt.size:
            return  # mid-prefill logits are meaningless
        req._set_state(RequestState.DECODE)
        if self._prefix_cache is not None:
            seq = self._engine._state_manager.get_sequence(req.uid)
            if seq is not None:
                self._publish(req, seq, req.prompt, seq.seen_tokens)
        nxt = self._sample(req, last_row)
        self._push_token(req, nxt)
        if not req.finished:
            req._next = nxt

    def _push_burst(self, req: Request, toks) -> None:
        """Stream a multi-token burst (a decode chunk's kept tokens, a verify
        step's emitted run): pushes
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

    def _execute_verify(self, plan: List[Tuple[Request, np.ndarray]],
                        record_spans) -> None:
        """Execute a tick containing speculative verify feeds. The decode
        entries (each a next-input token plus k drafts) run through ONE
        ``engine.verify`` dispatch; prefill chunks sharing the tick run
        through their normal ``engine.put`` — a prefill bucket must not pay
        the verify program's all-position unembed (and a [T, vocab] logits
        transfer at prefill widths) for a peer's draft. Each decode entry
        accepts its longest matching draft prefix, rolls the rejected tail
        back (write-then-truncate on ``seen_tokens``) and streams the
        emitted tokens."""
        engine = self._engine
        decode_plan = [(req, toks) for req, toks in plan
                       if req.state is not RequestState.PREFILL]
        prefill_plan = [(req, toks) for req, toks in plan
                        if req.state is RequestState.PREFILL]
        try:
            per_seq = engine.verify([req.uid for req, _ in decode_plan],
                                    [toks for _, toks in decode_plan])
            # stash the verify dispatch's observed seconds before the
            # prefill put overwrites the observer slots
            verify_s = self._last_dispatch_s
            verify_amnesty_s = self._last_dispatch_amnesty_s
            prefill_logits = (engine.put([req.uid for req, _ in prefill_plan],
                                         [toks for _, toks in prefill_plan]).float().cpu().numpy()
                              if prefill_plan else None)
        except Exception as e:  # pragma: no cover - defensive: same contract
            # as the put path — the scheduler thread must survive
            logger.exception("serving: engine verify tick failed; failing the batch")
            for req, _ in plan:
                self._finalize(req, RequestState.FAILED, error=f"engine error: {e}")
            return
        # the estimator measures engine-token throughput: verify feeds cost
        # their full width (accepted or not), like any other fed token
        self._rate.observe(sum(int(t.size) for _, t in plan))
        self._charge_members([(req, "verify", int(t.size))
                              for req, t in decode_plan],
                             seconds=verify_s, amnesty=verify_amnesty_s)
        if prefill_plan:
            self._charge_members([(req, "prefill", int(t.size))
                                  for req, t in prefill_plan])
        alpha = self._config.speculative.accept_alpha
        # sample/accept BEFORE any push: span token counts must be final when
        # the root span closes, and each request's private stream makes the
        # per-request draw order independent of processing order
        accepts = {id(req): self._spec_accept(req, toks, rows)
                   for (req, toks), rows in zip(decode_plan, per_seq)}
        record_spans(counts=[len(accepts[id(req)][0]) if id(req) in accepts
                             else int(toks.size) for req, toks in plan])
        for (req, toks), rows in zip(decode_plan, per_seq):
            emitted, accepted = accepts[id(req)]
            k = int(toks.size) - 1
            rejected = int(toks.size) - len(emitted)
            # rollback BEFORE pushing: a push may finalize, and the handoff
            # export / trie publish there must see the truncated seen_tokens
            # (= full history - 1, the same invariant every other path keeps)
            engine.rollback(req.uid, rejected)
            req.decode_steps += 1
            if k:
                # a k=0 feed riding a verify batch proposed nothing — no
                # acceptance evidence, no EWMA movement
                req.spec_drafted += k
                req.spec_accepted += accepted
                if self._ledger is not None and req.cost is not None:
                    self._ledger.charge_spec(req.cost, k, accepted)
                self._counters["spec_steps"] += 1
                self._counters["spec_drafted"] += k
                self._counters["spec_rollback"] += rejected
                self._counters["spec_accepted"] += accepted
                rate = accepted / k
                req._spec_ewma = (rate if req._spec_ewma is None
                                  else alpha * rate + (1 - alpha) * req._spec_ewma)
                self._spec_accept_ewma = (rate if self._spec_accept_ewma is None
                                          else alpha * rate
                                          + (1 - alpha) * self._spec_accept_ewma)
                if self._metrics:
                    self._metrics.spec_verify_steps.inc()
                    self._metrics.spec_drafted.inc(k)
                    self._metrics.spec_accepted.inc(accepted)
                    self._metrics.spec_rollback.inc(rejected)
                    self._metrics.spec_accept_rate.set(self._spec_accept_ewma or 0.0)
                    self._metrics.spec_tokens_per_step.observe(len(emitted))
            self._push_burst(req, emitted)
        for i, (req, toks) in enumerate(prefill_plan):
            self._advance_prefill(req, toks, prefill_logits[i])

    def _spec_accept_tree(self, req: Request, tree, rows, ids):
        """The acceptance rule over one verified token tree. Walk from the
        root: each emitted token is sampled (or argmaxed) from the target
        distribution with the request's own stream — one draw per emitted
        token, same draw order as spec-off — then the walk descends into the
        child CARRYING that token while one exists (rejection sampling with a
        point-mass draft at each branch). The deepest matching path is
        accepted; the first disagreement's sampled token is the bonus
        emission. Returns ``(emitted, path, last_node)``: ``path`` lists the
        accepted draft node indices (root-exclusive, the compaction input)
        and ``last_node`` is the deepest CONSUMED node, whose hidden state
        seeds the next learned draft. Emission stops at eos / the generation
        cap, mirroring :meth:`_push_token`'s rules."""
        emitted: List[int] = []
        path: List[int] = []
        node = 0
        while True:
            tok = (int(ids[node]) if rows is None
                   else self._sample(req, rows[node]))
            emitted.append(tok)
            if req.eos_token_id is not None and tok == req.eos_token_id:
                break
            if len(req.tokens) + len(emitted) >= req.max_new_tokens:
                break
            child = tree.child_with_token(node, tok)
            if child is None:
                break  # rejection: the target disagrees with every branch
            path.append(child)
            node = child
        return emitted, path, node

    def _execute_verify_tree(self, plan: List[Tuple[Request, np.ndarray]],
                             record_spans) -> None:
        """Execute a tick whose decode entries carry TokenTree feeds (the
        learned/auto drafter modes). Every tree — branching, chain, or
        root-only — verifies in ONE ``engine.verify_tree`` dispatch; prefill
        chunks sharing the tick keep their normal ``engine.put`` (same split
        as :meth:`_execute_verify`, same reason). Each entry accepts its
        deepest matching path under the spec-off sampling rule, compacts the
        accepted path's KV left behind the committed history (tree-aware
        write-then-truncate) and streams the emitted run; the deepest
        consumed node's hidden state is captured for the next learned
        draft."""
        engine = self._engine
        decode_plan = [(req, toks) for req, toks in plan
                       if req.state is not RequestState.PREFILL]
        prefill_plan = [(req, toks) for req, toks in plan
                        if req.state is RequestState.PREFILL]
        trees = []
        for req, toks in decode_plan:
            tree = req._spec_tree
            req._spec_tree = None
            if tree is None:  # defensive: a plain feed rides as a chain
                tree = TokenTree.chain(toks)
            trees.append(tree)
        # the device-argmax program only when EVERY decode entry is greedy: a
        # sampled request needs the full rows for its private stream (greedy
        # peers argmax the same f32 rows host-side — the identical result)
        greedy = all(req.temperature <= 0.0 for req, _ in decode_plan)
        try:
            per_seq = engine.verify_tree([req.uid for req, _ in decode_plan],
                                         trees, greedy=greedy)
            # stash the tree-verify dispatch's observed seconds before the
            # prefill put overwrites the observer slots
            verify_s = self._last_dispatch_s
            verify_amnesty_s = self._last_dispatch_amnesty_s
            prefill_logits = (engine.put([req.uid for req, _ in prefill_plan],
                                         [toks for _, toks in prefill_plan]).float().cpu().numpy()
                              if prefill_plan else None)
        except Exception as e:  # pragma: no cover - defensive: same contract
            # as the put path — the scheduler thread must survive
            logger.exception("serving: tree-verify tick failed; failing the batch")
            for req, _ in plan:
                self._finalize(req, RequestState.FAILED, error=f"engine error: {e}")
            return
        # verify feeds cost their full width (accepted or not), like any fed
        # token — tree nodes included
        self._rate.observe(sum(int(t.size) for _, t in plan))
        self._charge_members([(req, "tree_verify", int(t.size))
                              for req, t in decode_plan],
                             seconds=verify_s, amnesty=verify_amnesty_s)
        if prefill_plan:
            self._charge_members([(req, "prefill", int(t.size))
                                  for req, t in prefill_plan])
        alpha = self._config.speculative.accept_alpha
        # sample/accept BEFORE any push: span token counts must be final when
        # the root span closes, and each request's private stream makes the
        # per-request draw order independent of processing order
        accepts = {id(req): self._spec_accept_tree(req, tree,
                                                   res["rows"], res["ids"])
                   for (req, _), tree, res in zip(decode_plan, trees, per_seq)}
        record_spans(counts=[len(accepts[id(req)][0]) if id(req) in accepts
                             else int(toks.size) for req, toks in plan])
        for (req, toks), tree, res in zip(decode_plan, trees, per_seq):
            emitted, path, last_node = accepts[id(req)]
            k = tree.size - 1  # draft nodes proposed (the root is the input)
            accepted = len(path)
            # compact BEFORE pushing (a push may finalize, and the handoff
            # export / trie publish there must see the truncated seen_tokens):
            # accepted-path KV moves contiguously behind the committed
            # history, the rejected remainder truncates off — the same
            # full-history-minus-1 invariant every other path leaves behind
            rejected = engine.compact_accepted(req.uid, tree.size, path)
            req.decode_steps += 1
            # the hidden state behind the next decode input is the deepest
            # CONSUMED node's residual; _spec_hidden_pos stamps the history
            # length it is valid at (stale after any gap: handoff, brownout)
            hidden = res.get("hidden")
            if hidden is not None:
                req._spec_hidden = np.asarray(hidden[last_node], np.float32)
                req._spec_hidden_pos = (int(req.prompt.size) + len(req.tokens)
                                        + len(emitted))
            self._counters["spec_tree_nodes"] += tree.size
            compacted = any(p != j + 1 for j, p in enumerate(path))
            if compacted:
                self._counters["spec_tree_compactions"] += 1
            if self._metrics:
                self._metrics.spec_tree_nodes.inc(tree.size)
                if compacted:
                    self._metrics.spec_tree_compactions.inc()
            if k:
                # a root-only bootstrap proposed nothing — no acceptance
                # evidence, no EWMA movement (linear-path rule, tree-shaped)
                drafter = req._spec_last_drafter or self._drafter_mode
                short = "learned" if drafter == "learned" else "lookup"
                # the arbitration/adaptation signal is DEPTH productivity:
                # accepted serial depth over proposed depth — comparable
                # across a branching tree and a linear chain at the same k
                rate = accepted / max(int(tree.max_depth), 1)
                req.spec_drafted += k
                req.spec_accepted += accepted
                if self._ledger is not None and req.cost is not None:
                    self._ledger.charge_spec(req.cost, k, accepted)
                self._counters["spec_steps"] += 1
                self._counters["spec_drafted"] += k
                self._counters["spec_rollback"] += rejected
                self._counters["spec_accepted"] += accepted
                self._counters[f"spec_drafted_{short}"] += k
                self._counters[f"spec_accepted_{short}"] += accepted
                req._spec_ewma = (rate if req._spec_ewma is None
                                  else alpha * rate + (1 - alpha) * req._spec_ewma)
                self._arb_update(req, drafter, rate)
                self._spec_accept_ewma = (rate if self._spec_accept_ewma is None
                                          else alpha * rate
                                          + (1 - alpha) * self._spec_accept_ewma)
                if self._metrics:
                    self._metrics.spec_verify_steps.inc()
                    self._metrics.spec_drafted.inc(k)
                    self._metrics.spec_accepted.inc(accepted)
                    self._metrics.spec_rollback.inc(rejected)
                    self._metrics.spec_accept_rate.set(self._spec_accept_ewma or 0.0)
                    self._metrics.spec_tokens_per_step.observe(len(emitted))
                    self._metrics.spec_tree_accept_depth.observe(accepted)
            self._push_burst(req, emitted)
        for i, (req, toks) in enumerate(prefill_plan):
            self._advance_prefill(req, toks, prefill_logits[i])

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

    def _export_handoff(self, req: Request) -> bytes:
        """Portable continuation payload for a DONE handoff-requested request:
        full token history, KV blocks, next decode input and the sampler's
        exact RNG state — everything :meth:`submit_resume` on a decode-role
        peer needs to continue token-identically. Runs on the scheduler
        thread, before the sequence's KV is flushed. Drafter state rides in
        ``extra["spec"]``."""
        extra = {"generated": len(req.tokens)}
        if req.finish_reason == "length" and req.tokens:
            # an eos/context finish is not continuable; length means the donor
            # stopped at ITS cap with the last kept token as the next input
            extra["next_token"] = int(req.tokens[-1])
        if req._rng is not None:
            extra["rng_state"] = req._rng.bit_generator.state
        # the dispatch count rides every handoff (tokens-per-step accounting
        # must survive the migration whether or not the donor ever drafted)
        extra["decode_steps"] = req.decode_steps
        if req._spec_ewma is not None or req.spec_drafted:
            # drafter state rides the handoff: the decode-role peer continues
            # the acceptance adaptation exactly where the donor stopped (no
            # cold re-probe tax on a mid-stream migration)
            extra["spec"] = {"accept_ewma": req._spec_ewma,
                             "drafted": req.spec_drafted,
                             "accepted": req.spec_accepted}
            if req._spec_ewmas:
                # per-drafter EWMAs: an "auto" peer resumes the arbitration
                # mid-race instead of re-exploring both drafters cold
                extra["spec"]["drafters"] = {
                    name: val for name, val in req._spec_ewmas.items()
                    if val is not None}
            if self._spec_head_id is not None:
                # which trained heads produced the learned EWMA: a peer with
                # different heads must not inherit their acceptance record
                extra["spec"]["head_id"] = self._spec_head_id
        tokens = [int(t) for t in req.prompt.tolist()] + [int(t) for t in req.tokens]
        # chunked greedy decode feeds the device ahead of the kept history (a
        # mid-chunk cap leaves the last kept token — and discarded over-run —
        # already committed). Export seen = history-1 so the recipient re-feeds
        # the last token: deterministic, same KV values into the same slot,
        # and the continuation stays exactly aligned.
        return self._engine.export_sequence(req.uid, tokens=tokens, extra=extra,
                                            seen_tokens=len(tokens) - 1)

    def _export_park(self, req: Request) -> bytes:
        """Version-2 park frame for a finished park-requested request: the
        handoff export plus a versioned ``tier`` record (which tier the KV
        was resident on at finish — what the rehydrate response reports).
        Unlike a handoff, an eos finish IS parkable: the next turn continues
        from the full history via a rehydrate prompt, not from ``next_token``.
        The parked ``rng_state`` is informational — a rehydrate samples on
        its own seed so the returning turn matches a cold run bitwise."""
        sm = self._engine._state_manager
        source = sm.sequence_tier(req.uid)  # capture BEFORE export restores
        extra = {"generated": len(req.tokens),
                 "decode_steps": req.decode_steps,
                 "tier": {"v": _handoff.TIER_FIELD_VERSION, "source": source}}
        if req.finish_reason == "length" and req.tokens:
            extra["next_token"] = int(req.tokens[-1])
        if req._rng is not None:
            extra["rng_state"] = req._rng.bit_generator.state
        tokens = [int(t) for t in req.prompt.tolist()] + [int(t) for t in req.tokens]
        return self._engine.export_sequence(req.uid, tokens=tokens, extra=extra,
                                            seen_tokens=len(tokens) - 1,
                                            version=_handoff.PARK_VERSION)

    def _finalize(self, req: Request, state: RequestState, error: Optional[str] = None) -> None:
        """Terminal transition on the scheduler thread: free engine state
        (tracked OR offloaded KV), close the stream, account."""
        if req.finished:
            return
        req.error = error
        if req.uid is not None:
            self._active.pop(req.uid, None)
            seq = self._engine._state_manager.get_sequence(req.uid)
            if seq is not None:
                if (state is RequestState.DONE and req.handoff_requested
                        and req.finish_reason == "length" and req.tokens):
                    # export BEFORE flushing: the payload reads the sequence's
                    # live KV blocks (fleet prefill→decode handoff). An eos/
                    # context finish is not continuable — exporting it would
                    # device_get the whole KV only for the router to discard it
                    try:
                        req.handoff_payload = self._export_handoff(req)
                        if self._ledger is not None and req.cost is not None:
                            self._ledger.charge_wire(req.cost, "handoff", len(req.handoff_payload))
                    except Exception:  # pragma: no cover - defensive: a failed
                        # export degrades to a non-continuable response
                        logger.exception(f"serving: handoff export failed for "
                                         f"uid {req.uid}")
                if (state is RequestState.DONE and req.park_requested
                        and req.finish_reason in ("length", "eos")
                        and req.tokens):
                    # park BEFORE flushing, same reason as the handoff export;
                    # eos finishes park too (a multi-turn session's next turn
                    # rehydrates with a longer prompt, no next_token needed)
                    try:
                        req.park_payload = self._export_park(req)
                        if self._ledger is not None and req.cost is not None:
                            self._ledger.charge_wire(req.cost, "park", len(req.park_payload))
                        self._counters["parks"] += 1
                    except Exception:  # pragma: no cover - defensive: a failed
                        # park degrades to a cold next turn
                        logger.exception(f"serving: park export failed for "
                                         f"uid {req.uid}")
                if (self._prefix_cache is not None and state is RequestState.DONE
                        and not self._engine.is_offloaded(req.uid)):
                    # publish BEFORE flushing: the trie takes references on the
                    # full blocks, so flush's decref leaves them cached instead
                    # of freed (an offloaded sequence's table is stale — its
                    # device blocks were already returned — so it cannot
                    # publish)
                    self._publish_finished(req, seq)
                self._engine.flush(req.uid)  # returns KV blocks (incl. offloaded)
        req._set_state(state)
        self._counters[self._FINAL_COUNTER[state]] += 1
        if self._ledger is not None and req.cost is not None:
            # close the open KV segment and fold the bill into the tenant
            # rollup — conservation holds once every request finalizes
            self._ledger.finalize(req, time.monotonic())
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
                               "resumed": req._resume_header is not None})
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
        self._fail_control()  # waiters observe the death, not a timeout
        if self._prefix_cache is not None:
            self._prefix_cache.clear()  # unpin the trie's blocks
            if self._metrics:
                self._metrics.prefix_trie_blocks.set(0)
        if getattr(self._engine, "_serving_scheduler", None) is self:
            self._engine._serving_scheduler = None
        self._detach_observer()
        self._attach_flight(None)
        self._stopped = True

    def _detach_observer(self) -> None:
        """Clear the engine's dispatch observer iff it is still ours — a
        stopped scheduler must not keep feeding (or block a successor from
        installing) the cost plane's timing hook."""
        if getattr(self._engine, "dispatch_observer", None) == self._on_dispatch:
            self._engine.dispatch_observer = None

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
        self._fail_control()
        for req in list(self._active.values()):
            self._finalize(req, RequestState.CANCELLED)
        while self._queue:
            self._finalize(self._queue.popleft(), RequestState.CANCELLED)
        if self._prefix_cache is not None:
            # unpin the trie's blocks: a stopped scheduler leaves the engine's
            # KV pool exactly as it found it (shared blocks survive until any
            # still-tracked sequence flushes)
            self._prefix_cache.clear()
            if self._metrics:
                self._metrics.prefix_trie_blocks.set(0)
        if getattr(self._engine, "_serving_scheduler", None) is self:
            self._engine._serving_scheduler = None
        self._detach_observer()
        self._attach_flight(None)
        self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=False)

    # ----------------------------------------------------------------- stats --
    @property
    def queue_depth(self) -> int:
        # an in-admission request (popped, importing) still counts as pending
        # work: drain budgets and least-loaded dispatch must not miss it
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
            # cost-to-date (None with telemetry off): post-mortems and the
            # stats surface see the bill as it accrues, not only at the end
            "cost": req.cost.compact_row() if req.cost is not None else None,
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

    def _spec_stats(self) -> Optional[dict]:
        if self._drafter is None:
            return None
        drafted = self._counters["spec_drafted"]
        out = {
            "enabled": True,
            "drafter": self._drafter_mode,
            "drafted": drafted,
            "accepted": self._counters["spec_accepted"],
            "accept_rate": (self._counters["spec_accepted"] / drafted
                            if drafted else 0.0),
            "accept_ewma": self._spec_accept_ewma,
            "verify_steps": self._counters["spec_steps"],
            "rollback_tokens": self._counters["spec_rollback"],
            "max_draft_tokens": self._config.speculative.max_draft_tokens,
        }
        if self._drafter_mode != "prompt_lookup":
            scfg = self._config.speculative
            out["head_id"] = self._spec_head_id
            out["tree"] = {
                "nodes": self._counters["spec_tree_nodes"],
                "compactions": self._counters["spec_tree_compactions"],
                "width": scfg.tree_width,
                "node_budget": scfg.tree_node_budget,
            }
            out["drafter_switches"] = self._counters["spec_drafter_switches"]
            out["drafters"] = {
                name: {"drafted": self._counters[f"spec_drafted_{short}"],
                       "accepted": self._counters[f"spec_accepted_{short}"],
                       "ewma": self._spec_drafter_ewmas.get(name)}
                for name, short in (("learned", "learned"),
                                    ("prompt_lookup", "lookup"))}
        return out

    def usage(self) -> dict:
        """The ``/v1/usage`` document: ledger totals, per-tenant rollups,
        pricing, and the fair-share posture. ``{"enabled": False}`` with
        telemetry (or the cost plane) off — the endpoint stays useful as a
        feature probe either way."""
        doc = self._ledger.usage_doc() if self._ledger is not None else {"enabled": False}
        if self._fair_share is not None:
            doc["fair_share"] = self._fair_share.doc()
        return doc

    def stats(self) -> dict:
        queued, active = self._snapshot_requests()
        return self._stats_doc(queued, active)

    def _stats_doc(self, queued: List[Request], active: List[Request]) -> dict:
        # the reference's document, key for key
        now = time.monotonic()
        prefix_stats = None
        if self._prefix_cache is not None:
            prefix_stats = self._prefix_cache.stats()
            # the router hashes a request's chain with the replica's block
            # size — it must ride the same doc as the digest catalog
            prefix_stats["block_size"] = self._engine._state_manager.kv_block_size
            digests = self.prefix_digest_catalog()
            if digests is not None:
                prefix_stats["digests"] = digests
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
            "prefix_cache": prefix_stats,
            "speculative": self._spec_stats(),
            "kv_tiers": (self._kv_tiers.stats(self._prefix_cache)
                         if self._kv_tiers is not None else None),
            "usage": self.usage(),
            "perf": self._perf_obs.doc() if self._perf_obs is not None else None,
            "timeseries": (ts.snapshot(max_points=64)
                           if (ts := telemetry.get_timeseries()) is not None else None),
            "slo": slo.status() if (slo := telemetry.get_slo_engine()) is not None else None,
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
