"""Front-end fleet router: one HTTP endpoint over N serving replicas.

Same wire format as ``serving/server.py`` (``POST /v1/generate`` with
optional SSE streaming, ``POST /v1/resume``, ``GET /v1/stats``,
``GET /healthz``) plus ``GET /v1/fleet/stats`` (per-replica dispatch counts,
roles, breaker states, supervisor slots, probes), ``GET /v1/fleet/usage``
(the per-tenant cost rollup summed across replica probe docs — the fleet
face of each replica's ``/v1/usage`` ledger; tenant identity forwards via
the JSON ``tenant`` field or the ``X-DSTPU-Tenant`` header) and — when fault
injection is armed with ``allow_remote`` — ``POST /v1/fleet/chaos``
(re-seed/disable the chaos harness; what a load generator's chaos run
drives). A client
cannot tell the router from a single replica, which is the point: "millions
of users" is N replicas behind this process.

Dispatch policy per request leg:

- **session affinity**: a session key (the ``X-DSTPU-Session`` header or the
  JSON ``session`` field) rendezvous-hashes over the healthy pool — stable
  under replica loss: keys only move off a replica that left.
- **least-loaded**: without a key, the replica with the fewest
  queued+in-flight requests wins (probes cached ``probe_ttl_s``, driven by
  the ``/healthz`` + ``/v1/stats`` surfaces for HTTP upstreams).
- **circuit breaking**: every replica's breaker (``fleet/breaker.py``) gates
  candidacy — an OPEN replica is skipped without a probe or a socket; a
  HALF_OPEN one admits bounded trial dispatches. Breakers are fed by probe
  failures, dispatch refusals (never 429 backpressure) and mid-leg deaths.
- **failover**: an unavailable replica is excluded and the next candidate
  tried, up to ``max_attempts``, with bounded-jitter backoff between
  attempts (the shared ``backoff_delay`` policy).
- **graceful degradation**: when a disaggregated fleet has one role pool
  entirely dark (drained, quarantined, or breaker-open), requests are served
  monolithically on the surviving pool — counted in
  ``fleet_degraded_requests_total`` and flagged ``degraded`` in the final
  doc, never silent, never a blanket 502.
- **parked sessions** (``FleetConfig.park``): a finished-but-continuable
  session's KV exports as a v2 park frame and banks in the router's
  :class:`~deepspeed_tpu_torch.fleet.park_store.ParkStore` under its session key;
  the session's next turn — a generate whose prompt strictly extends the
  parked history — dispatches as a *rehydrate* resume leg on ANY replica
  (placement is free to move it), importing the parked turns' KV and
  prefilling only the new suffix. A refused frame falls back to a cold run;
  rehydrated legs are excluded from hedging and stealing.

Prefill/decode disaggregation: when both a ``prefill`` and a ``decode`` pool
exist, a generate request runs as two legs — prefill + first token on a
prefill-role replica (``handoff=True``), then the portable KV payload
(``ragged/handoff.py``) continues on a decode-role replica via
``/v1/resume``. A decode replica dying mid-leg is retried **once** on a peer
with the still-buffered payload: the resume is token-identical, so the
already-streamed token prefix is skipped and the client sees one seamless
stream. The router parents both replica request spans under its own span, so
the Perfetto track reads router → prefill replica → decode replica as one
trace.

Port of ``deepspeed_tpu/fleet/router.py`` (host Python, unchanged in behaviour
except where noted).
"""

import base64
import collections
import hashlib
import json
import os
import queue as queue_mod
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterator, List, Optional, Set

import numpy as np

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.fleet.breaker import backoff_delay
from deepspeed_tpu_torch.fleet.config import FleetConfig
from deepspeed_tpu_torch.fleet.faults import (FaultConfig, FaultInjector,
                                              config_from_env)
from deepspeed_tpu_torch.fleet.global_queue import (GlobalQueue, GlobalQueueFull,
                                                    QueueWaitExpired)
from deepspeed_tpu_torch.fleet.manager import ReplicaManager
from deepspeed_tpu_torch.fleet.metrics import FleetMetrics
from deepspeed_tpu_torch.fleet.park_store import ParkStore
from deepspeed_tpu_torch.fleet.replica import (Leg, Replica, ReplicaDied,
                                               ReplicaUnavailable)
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import (DIGEST_HEX,
                                                                  digest_chain)
from deepspeed_tpu_torch.serving.overload import validate_priority
from deepspeed_tpu_torch.serving.server import (PRIORITY_HEADER, TENANT_HEADER,
                                                TRACE_HEADER, parse_request_body,
                                                retry_after_header)
from deepspeed_tpu_torch.telemetry import new_span_id, new_trace_id, now_us
from deepspeed_tpu_torch.utils.logging import logger

# request fields forwarded verbatim to a replica leg (everything else —
# stream, session, handoff — is router-interpreted, never blind-forwarded)
_LEG_FIELDS = ("max_new_tokens", "temperature", "eos_token_id", "deadline_s",
               "seed", "priority", "drafter", "tenant")


def _merge_usage_row(agg: dict, row: dict) -> None:
    """Recursively sum a replica's per-tenant usage row into ``agg`` (numeric
    leaves add; nested dicts like ``tokens``/``wire_bytes`` merge by key)."""
    for k, v in row.items():
        if isinstance(v, dict):
            _merge_usage_row(agg.setdefault(k, {}), v)
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        else:
            agg[k] = agg.get(k, 0) + v


class RoutingError(RuntimeError):
    """No replica could take the request (all candidates excluded or
    unavailable); ``status`` is the HTTP code the client sees (503, or 429
    when the last refusal was backpressure). ``retry_after_s`` rides 429/503
    responses as a ``Retry-After`` header when the router (or a replica's
    overload control) produced a drain-rate estimate."""

    def __init__(self, message: str, status: int = 503,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


def _rendezvous_score(session_key: str, replica_id: str) -> int:
    digest = hashlib.md5(f"{session_key}\x00{replica_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class RoutedRequest:
    """One client request in flight through the router.

    The first leg is dispatched in the constructor, so admission problems
    (everything down, fleet-wide backpressure) raise :class:`RoutingError`
    before any response bytes are written; iterate ``tokens()`` for the live
    cross-leg stream, then ``result()`` for the merged final doc.
    """

    def __init__(self, router: "FleetRouter", doc: dict, resume: bool,
                 session_key: Optional[str], trace_id: Optional[str]):
        self._router = router
        self._doc = doc
        self._resume = resume
        self._session_key = session_key
        self.trace_id = trace_id
        self._root_span_id = new_span_id() if trace_id is not None else None
        self._t0_us = now_us()
        self._t0_s = time.monotonic()
        self._final: Optional[dict] = None
        self._current_leg: Optional[Leg] = None
        self._current_replica: Optional[Replica] = None
        self._legs_meta: List[dict] = []
        self._cancelled = False
        self._degraded = False
        self._hedged = False
        # fleet-parked sessions: did THIS request dispatch as a rehydrate leg
        # (parked KV + new-turn prompt)? Rehydrated legs are excluded from
        # hedging and stealing — their one-shot payload must not race or move
        self._rehydrated = False
        self._park_tier: Optional[str] = None
        self._client_park = bool(doc.get("park"))
        # every leg ever dispatched for this request: cancel() must reach
        # BOTH racers of an undecided hedge, not just _current_leg — an
        # uncancelled loser would stream to completion for a dead client,
        # holding its KV and queue slot exactly when the fleet is saturated
        self._all_legs: List[Leg] = []
        self.priority = validate_priority(doc.get("priority"))
        # global-queue slot ownership per dispatched leg: released exactly
        # once when the leg reaches a terminal outcome (result consumed,
        # death, cancel) so freed capacity pulls the next queued request
        self._leg_slots = {}
        self._slot_lock = threading.Lock()
        # cache-aware routing: the request's block-aligned prefix chain as
        # truncated-hex digests, computed at most once per block size (a
        # mixed fleet may disagree on geometry) and matched against each
        # candidate's probe-published catalog at pick time
        routing = doc.get("routing")
        if routing not in (None, "cache", "hash"):
            raise ValueError(f"unknown routing mode {routing!r} "
                             f"(know 'cache', 'hash')")
        self._chain_cache = {}
        self._cache_route_counted = False
        self._route_hint = None
        if (router._config.cache_route.enabled and routing != "hash"
                and not resume and doc.get("prompt") is not None):
            self._route_hint = self

        mgr = router._manager
        prefill_pool = self._dispatchable("prefill")
        decode_pool = self._dispatchable("decode")
        # disaggregated *topology*: both roles exist in the registry, whatever
        # their current health — the degradation accounting baseline
        registered_roles = {r.role for r in mgr.replicas()}
        disagg_topology = {"prefill", "decode"} <= registered_roles
        mnt = doc.get("max_new_tokens")
        # `is None`, not falsy-or: an explicit 0 must flow through to the
        # replica's own 'max_new_tokens must be >= 1' 400, exactly as it
        # would on a single server — not become a default-budget completion
        self._n = int(router._config.default_max_new_tokens if mnt is None else mnt)
        self._client_handoff = bool(doc.get("handoff"))
        self._disagg = (not resume and bool(prefill_pool) and bool(decode_pool)
                        and self._n > 1)
        if self._disagg:
            self._pool_fn = lambda: self._dispatchable("prefill")
            self._leg1 = self._dispatch(
                self._leg_doc(prompt=doc["prompt"], max_new_tokens=1,
                              handoff=True),
                resume=False, pool_fn=self._pool_fn, what="prefill")
        elif resume:
            if not decode_pool and "decode" in registered_roles:
                # same contract as the generate path: serving a resume off
                # the dark decode pool is degradation — counted, not silent
                self._mark_degraded("decode pool unavailable; resuming on "
                                    "the surviving pool")
            self._pool_fn = (lambda: self._dispatchable("decode")
                             or self._dispatchable())
            extra = {}
            if doc.get("prompt") is not None:
                # client-side rehydrate: a parked frame the CLIENT held, plus
                # the next turn's prompt — forwarded like any resume leg
                extra["prompt"] = doc["prompt"]
            self._leg1 = self._dispatch(
                self._leg_doc(payload=doc["payload"],
                              handoff=self._client_handoff,
                              **extra, **self._park_kw()),
                resume=True, pool_fn=self._pool_fn, what="resume")
        else:
            # whole-request serving: the mixed pool when one exists, else any
            # dispatchable replica. A disaggregated fleet with one side
            # entirely dark lands here — graceful degradation, counted
            if disagg_topology and self._n > 1:
                self._mark_degraded(
                    f"{'decode' if prefill_pool else 'prefill'} pool "
                    f"unavailable; serving monolithically")
            self._pool_fn = (lambda: self._dispatchable("mixed")
                             or self._dispatchable())
            self._maybe_rehydrate()
            if not self._rehydrated:
                self._leg1 = self._dispatch(
                    self._leg_doc(prompt=doc["prompt"],
                                  handoff=self._client_handoff,
                                  **self._park_kw()),
                    resume=False, pool_fn=self._pool_fn, what="generate")
        self._iter = self._run()

    def tokens(self) -> Iterator[int]:
        return self._iter

    def result(self) -> dict:
        for _ in self._iter:  # drain whatever the caller didn't consume
            pass
        assert self._final is not None
        return self._final

    def cancel(self) -> None:
        """Client went away: cancel every dispatched leg so their KV frees
        upstream (and their global-queue slots free for the next queued
        request) — during an undecided hedge race BOTH racers die here."""
        self._cancelled = True
        for leg in list(self._all_legs):
            try:
                leg.cancel()
            except Exception:  # a long-terminal leg must not mask the rest
                pass
            self._finish_leg(leg)

    def _finish_leg(self, leg: Leg) -> None:
        """Release the leg's global-queue slot exactly once (terminal
        outcome: result consumed, death, cancel)."""
        with self._slot_lock:
            replica_id = self._leg_slots.pop(id(leg), None)
        if replica_id is not None and self._router._gq is not None:
            self._router._gq.release(replica_id)

    # ---------------------------------------------------------------- pools --
    def _dispatchable(self, role: Optional[str] = None) -> List[Replica]:
        """The pool the router may dispatch to right now: in-rotation AND not
        behind an open breaker (an OPEN replica costs nothing here — no probe,
        no socket)."""
        return [r for r in self._router._manager.replicas(role=role,
                                                          available_only=True)
                if r.breaker is None or r.breaker.allow()]

    # ------------------------------------------------------- cache routing --
    def _chain_for(self, block_size: int) -> Optional[List[str]]:
        """The prompt's chained block digests at ``block_size``, truncated to
        the catalog's hex width (matching a hint needs no more; the peer
        fetch path re-matches full 20-byte digests donor-side)."""
        if block_size <= 0:
            return None
        chain = self._chain_cache.get(block_size)
        if chain is None:
            tokens = np.asarray(self._doc["prompt"], dtype=np.int32)
            chain = [d.hex()[:DIGEST_HEX]
                     for d in digest_chain(tokens, block_size)]
            self._chain_cache[block_size] = chain
        return chain

    def _note_cache_route(self, hit: bool) -> None:
        """Count the request's cache-routing outcome exactly once (failover
        and hedge legs re-run the pick; only the first verdict is the
        routing decision)."""
        if self._cache_route_counted:
            return
        self._cache_route_counted = True
        router = self._router
        key = "cache_route_hits" if hit else "cache_route_misses"
        with router._counter_lock:
            router._counters[key] += 1
        if router._metrics:
            (router._metrics.cache_route_hits if hit
             else router._metrics.cache_route_misses).inc()

    def _mark_degraded(self, reason: str) -> None:
        if self._degraded:
            return
        self._degraded = True
        router = self._router
        with router._counter_lock:
            router._counters["degraded"] += 1
        if router._metrics:
            router._metrics.degraded.inc()
        logger.warning(f"fleet: degraded serving: {reason}")

    # ------------------------------------------------------ parked sessions --
    def _park_kw(self) -> dict:
        """The ``park`` flag for a leg that may finish this request: set when
        the client asked for the frame itself, or when the router will bank it
        (park store armed and a session key rides the request)."""
        if self._client_park or (self._router._park_store is not None
                                 and self._session_key):
            return {"park": True}
        return {}

    def _maybe_rehydrate(self) -> None:
        """Try to serve this generate request as a *rehydrate* leg: when the
        park store holds this session and the new prompt strictly extends the
        parked token history, dispatch ``/v1/resume`` with the parked frame
        plus the prompt — the parked turns' KV imports on whichever replica
        wins placement (ANY replica: the frame is self-describing) and only
        the new suffix prefills. A replica refusing the frame (ValueError:
        corruption in transit — the ``park_store_corrupt`` chaos point — or
        rot at rest) drops the entry, counts a corrupt reject, and this
        request falls back to the cold full-prompt dispatch; a parked session
        can cost at most one bounced dispatch, never correctness."""
        router = self._router
        store = router._park_store
        if store is None or not self._session_key:
            return
        entry = store.match(self._session_key, self._doc["prompt"])
        if entry is None:
            return
        payload = entry.payload
        faults = router._faults
        if faults is not None:
            n = faults.fire("park_store_corrupt", self._session_key)
            if n is not None:
                # corrupt the SENT copy only; the store's stays pristine (the
                # reject below still drops it — a one-strike policy keeps the
                # chaos arm deterministic and the fallback path honest)
                router._count_fault()
                payload = faults.corrupt(payload, n, self._session_key,
                                         point="park_store_corrupt")
        try:
            self._leg1 = self._dispatch(
                self._leg_doc(payload=payload, prompt=self._doc["prompt"],
                              handoff=self._client_handoff,
                              **self._park_kw()),
                resume=True, pool_fn=self._pool_fn, what="rehydrate")
        except (ValueError, TypeError) as e:
            store.reject(self._session_key)
            logger.warning(
                f"fleet: rehydrate frame for session {self._session_key!r} "
                f"refused ({e}); falling back to a cold run")
            return
        self._rehydrated = True
        self._park_tier = entry.tier_source

    def _maybe_park(self, final: dict) -> None:
        """Park-at-finish: a final doc carrying a ``park`` frame (the leg was
        dispatched with ``park=True``) banks in the router's store under the
        session key. The frame is stripped from the client's doc unless the
        client asked for it; ``parked: true`` tells the client (and loadgen)
        the session can return cheaply."""
        payload = final.get("park")
        if not self._client_park:
            final.pop("park", None)
        if not isinstance(payload, (bytes, bytearray)):
            return
        if self._client_park:
            # the client manages its own copy; the router's base64 encoding
            # happens at the HTTP layer (same as a raw handoff payload)
            final["park"] = bytes(payload)
        store = self._router._park_store
        if store is None or not self._session_key or self._cancelled:
            return
        if store.put(self._session_key, bytes(payload),
                     replica_id=self._last_replica_id):
            final["parked"] = True

    # ---------------------------------------------------------------- legs --
    def _remaining_deadline_s(self) -> Optional[float]:
        """The client deadline minus time already spent routing; None = no
        deadline on the request."""
        if self._doc.get("deadline_s") is None:
            return None
        return max(0.001, float(self._doc["deadline_s"])
                   - (time.monotonic() - self._t0_s))

    def _deadline_remaining_raw_s(self) -> Optional[float]:
        """Like :meth:`_remaining_deadline_s` but unfloored: negative means
        the deadline has already passed (the stream feed-stop predicate)."""
        if self._doc.get("deadline_s") is None:
            return None
        return float(self._doc["deadline_s"]) - (time.monotonic() - self._t0_s)

    def _deadline_cut_final(self, yielded: List[int]) -> dict:
        """The router-side decode feed-stop (the replica's own per-tick
        deadline check cannot see router-observed stalls — chaos delays,
        slow transport): a request past its deadline stops being fed HERE,
        with the same terminal shape the replica scheduler produces."""
        router = self._router
        with router._counter_lock:
            router._counters["deadline_cuts"] += 1
        if router._metrics:
            router._metrics.deadline_stream_cuts.inc()
        return {"state": "TIMED_OUT", "finish_reason": "deadline",
                "error": "deadline exceeded mid-stream at the router",
                "tokens": list(yielded), "n_tokens": len(yielded),
                "retry_after_s": (router._gq.retry_after_s()
                                  if router._gq is not None else None),
                "e2e_s": time.monotonic() - self._t0_s}

    def _acquire_replica(self, pool_fn: Callable[[], List[Replica]],
                         exclude: Set[str], what: str,
                         acquire_timeout_s: Optional[float] = None
                         ) -> Optional[Replica]:
        """One replica with dispatch capacity, or None when the pool is
        empty. With the global queue enabled the request WAITS here, in
        priority/deadline order, until a replica has a free slot (pull
        dispatch); an expired wait is router-level shedding — RoutingError
        with Retry-After, nothing dispatched. Queue-disabled: the legacy
        blind least-loaded push (the control arm)."""
        router = self._router
        gq = router._gq

        def candidates_fn():
            return router._healthy(pool_fn(), exclude)

        if gq is None:
            candidates = candidates_fn()
            if not candidates:
                return None
            return router._pick(candidates, self._session_key,
                                hint=self._route_hint)
        if not candidates_fn():
            # nothing dispatchable at all (everything down / breaker-open /
            # excluded): fail over NOW like the pre-queue router — the queue
            # exists to park work behind BUSY replicas, not dead ones
            return None
        try:
            return gq.acquire(
                candidates_fn, priority=self.priority,
                deadline_s=self._remaining_deadline_s(),
                session_key=self._session_key,
                timeout_s=(acquire_timeout_s if acquire_timeout_s is not None
                           else router._config.global_queue.acquire_timeout_s),
                hint=self._route_hint)
        except GlobalQueueFull as e:
            raise RoutingError(f"{what} leg rejected: {e}", status=429,
                               retry_after_s=e.retry_after_s) from e
        except QueueWaitExpired as e:
            if router._metrics:
                router._metrics.failures.inc()
            raise RoutingError(
                f"{what} leg shed at the router queue: {e}", status=429,
                retry_after_s=e.retry_after_s) from e

    def _release_replica(self, replica: Replica) -> None:
        """Give back an acquired-but-unused slot (dispatch refused)."""
        if self._router._gq is not None:
            self._router._gq.release(replica.id)

    def _dispatch(self, doc: dict, resume: bool,
                  pool_fn: Callable[[], List[Replica]],
                  what: str, exclude: Optional[Set[str]] = None,
                  internal_payload: bool = False,
                  acquire_timeout_s: Optional[float] = None) -> Leg:
        """Failover dispatch over ``pool_fn()``: an unavailable replica (429/
        503/unreachable) is excluded — and its breaker fed — and the next
        candidate tried after a bounded-jitter backoff; the chosen replica's
        request root parents under a per-hop router span. With the global
        queue enabled the replica comes from a priority/deadline-ordered
        grant (see :meth:`_acquire_replica`) and the leg holds its slot until
        terminal. ``internal_payload`` marks a router-packed resume body: a
        replica rejecting it (ValueError) smells like transit corruption, so
        the next attempt re-sends the pristine buffered copy instead of
        failing the request."""
        router = self._router
        cfg = router._config
        faults = router._faults
        exclude = set(exclude or ())
        last: Optional[Exception] = None
        last_status = 503
        last_retry_after: Optional[float] = None
        for attempt in range(min(cfg.max_attempts, max(1, len(pool_fn())))):
            if attempt and cfg.retry_backoff_base_s > 0:
                time.sleep(backoff_delay(attempt - 1, cfg.retry_backoff_base_s,
                                         cfg.retry_backoff_cap_s,
                                         cfg.retry_jitter_frac, random.random()))
            replica = self._acquire_replica(pool_fn, exclude, what,
                                            acquire_timeout_s)
            if replica is None:
                break
            breaker = replica.breaker
            if breaker is not None and not breaker.try_acquire():
                exclude.add(replica.id)  # HALF_OPEN trial slots exhausted
                self._release_replica(replica)
                continue
            hop_span = new_span_id() if self.trace_id is not None else None
            t0 = now_us()
            with router._counter_lock:  # handler threads race on attribution
                replica.dispatches += 1
            body = doc
            try:
                if faults is not None:
                    body = self._inject_dispatch_faults(faults, replica, doc,
                                                        resume and internal_payload)
                leg = replica.dispatch(body, resume=resume,
                                       trace_id=self.trace_id,
                                       parent_span_id=hop_span)
            except ReplicaUnavailable as e:
                self._release_replica(replica)
                with router._counter_lock:
                    replica.failures += 1
                if breaker is not None:
                    if e.status == 429:
                        breaker.release()  # backpressure is load, not breakage
                    else:
                        breaker.record_failure()
                exclude.add(replica.id)
                last, last_status = e, e.status
                if e.retry_after_s is not None:
                    # replica-side overload shedding: keep the LARGEST
                    # backoff seen — the client must outwait the worst pool
                    last_retry_after = max(last_retry_after or 0.0,
                                           e.retry_after_s)
                if router._metrics:
                    router._metrics.retries.inc()
                logger.info(f"fleet: {what} leg failed over from {replica.id}: {e}")
                continue
            except (ValueError, TypeError) as e:
                self._release_replica(replica)
                if breaker is not None:
                    breaker.release()  # the payload was refused, not the replica
                if resume and internal_payload:
                    last, last_status = e, 502
                    if router._metrics:
                        router._metrics.retries.inc()
                    logger.warning(f"fleet: {what} leg payload refused by "
                                   f"{replica.id} (suspected transit corruption; "
                                   f"retrying pristine): {e}")
                    continue
                raise
            if breaker is not None:
                breaker.record_success()
            spans = telemetry.get_span_recorder()
            if spans is not None and self.trace_id is not None:
                # the hop span is recorded up-front (instant event): its id
                # must exist in the trace for the replica's request root —
                # recorded at the replica's own finalize — to parent under
                spans.record(f"dispatch:{what}", cat="fleet", ts_us=t0,
                             trace_id=self.trace_id, span_id=hop_span,
                             parent_id=self._root_span_id,
                             args={"replica": replica.id, "role": replica.role,
                                   "excluded": sorted(exclude)})
            self._current_leg = leg
            self._current_replica = replica
            self._last_replica_id = replica.id
            self._all_legs.append(leg)
            if router._gq is not None:
                with self._slot_lock:
                    self._leg_slots[id(leg)] = replica.id
            return leg
        if router._metrics:
            router._metrics.failures.inc()
        status = last.status if isinstance(last, ReplicaUnavailable) else last_status
        if status < 100:  # transport-class failures carry status=0 as the
            status = 503  # breaker signal; a client must see a real HTTP code
        if last_retry_after is None and status in (429, 503) \
                and router._gq is not None:
            last_retry_after = router._gq.retry_after_s()
        raise RoutingError(
            f"no replica available for {what} leg "
            f"({len(pool_fn())} in pool, {len(exclude)} excluded): {last}",
            status, retry_after_s=last_retry_after)

    def _inject_dispatch_faults(self, faults: FaultInjector, replica: Replica,
                                doc: dict, corruptible: bool) -> dict:
        """Consult every dispatch-time injection point for this attempt;
        returns the (possibly corrupted-copy) body to send. Raising here
        flows through the same except-arms a real transport failure would."""
        router = self._router
        n = faults.fire("dispatch_delay", replica.id)
        if n is not None:
            router._count_fault()
            time.sleep(faults.delay_s(n, replica.id))
        if faults.fire("replica_kill", replica.id) is not None \
                and hasattr(replica, "kill"):
            router._count_fault()
            replica.kill("injected replica_kill")  # dispatch below will refuse
        if faults.fire("connect_reset", replica.id) is not None:
            router._count_fault()
            raise ReplicaUnavailable(
                f"replica {replica.id}: injected connection reset", status=0)
        if faults.fire("http_5xx", replica.id) is not None:
            router._count_fault()
            raise ReplicaUnavailable(
                f"replica {replica.id}: injected HTTP 503", status=503)
        if corruptible:
            n = faults.fire("handoff_corrupt", replica.id)
            if n is not None:
                router._count_fault()
                # corrupt THIS attempt's copy only: the retry re-sends the
                # pristine buffered payload (corruption-in-transit semantics)
                return {**doc, "payload": faults.corrupt(doc["payload"], n,
                                                         replica.id)}
        return doc

    def _stream(self, leg: Leg, replica_id: str) -> Iterator[int]:
        """Leg token iterator with the mid-stream truncation and decode-stall
        injection points armed, and the first token's latency fed into the
        replica's TTFT EWMA (the slow-replica demotion signal) and the
        router's hedge-budget sample window."""
        router = self._router
        faults = router._faults
        cut = None
        stall = False
        if faults is not None:
            n = faults.fire("stream_truncate", replica_id)
            if n is not None:
                router._count_fault()
                cut = faults.truncate_after(n, replica_id)
            stall = faults.stalls_replica(replica_id)
        t0 = time.monotonic()
        t_last = t0
        for i, tok in enumerate(leg):
            if stall:
                # the slow-but-alive replica: every token may eat a seeded
                # delay BEFORE it reaches the client (or the hedge arbiter)
                n = faults.fire("decode_stall", replica_id)
                if n is not None:
                    router._count_fault()
                    time.sleep(faults.stall_s(n, replica_id))
            now = time.monotonic()
            if i == 0:
                router._record_ttft(replica_id, now - t0)
            else:
                router._record_itl(replica_id, now - t_last)
            t_last = now
            if cut is not None and i >= cut:
                leg.cancel()
                raise ReplicaDied(f"replica {replica_id}: injected mid-stream "
                                  f"truncation after {cut} tokens")
            yield tok

    def _fail_current_replica(self) -> None:
        """A leg died under an admitted request: a breaker-grade failure for
        the replica that held it."""
        replica = self._current_replica
        if replica is not None and replica.breaker is not None:
            replica.breaker.record_failure(trial=False)

    def _leg_doc(self, **overrides) -> dict:
        doc = {k: self._doc[k] for k in _LEG_FIELDS if self._doc.get(k) is not None}
        doc.update(overrides)
        return doc

    def _leg_meta(self, kind: str, final: dict) -> None:
        self._legs_meta.append({"replica": self._last_replica_id, "kind": kind,
                                "uid": final.get("uid"),
                                "n_tokens": final.get("n_tokens")})

    # ------------------------------------------------------------- hedging --
    def _hedge_eligible(self) -> bool:
        """Hedge single-leg generate requests only: a resume leg holds a
        one-shot KV payload (two imports = two KV copies racing), and the
        disaggregated path has its own decode re-dispatch. Sampled requests
        are fine — both legs run the identical seeded sampler."""
        hcfg = self._router._config.hedge
        return (hcfg.enabled and not self._resume and not self._rehydrated
                and not self._cancelled
                and (not hcfg.interactive_only or self.priority == "interactive"))

    def _reader(self, idx: int, leg: Leg, replica_id: str, out) -> None:
        """Pump one leg into the hedge arbiter's event queue; releases the
        leg's queue slot on exit (win, loss, or death)."""
        try:
            for tok in self._stream(leg, replica_id):
                out.put((idx, "tok", tok))
            out.put((idx, "done", dict(leg.result())))
        except Exception as e:  # ReplicaDied, transport errors
            out.put((idx, "err", e))
        finally:
            self._finish_leg(leg)

    def _commit_leg(self, idx: int, legs, live, dead) -> None:
        """``idx`` is now the stream: cancel every other live leg (its reader
        drains to termination and releases the slot; the upstream scheduler
        frees its KV on the next tick) and repoint the request at the winner."""
        router = self._router
        for other in list(live):
            if other == idx:
                continue
            live.discard(other)
            dead.add(other)
            legs[other][0].cancel()
            if router._metrics:
                router._metrics.hedge_cancellations.inc()
        self._current_leg, self._last_replica_id = legs[idx]
        self._current_replica = router._manager_get(legs[idx][1])
        if idx == 1:
            with router._counter_lock:
                router._counters["hedge_wins"] += 1
            if router._metrics:
                router._metrics.hedge_wins.inc()

    def _run_hedged(self) -> Iterator[int]:
        """Hedged streaming, first-past-the-prefix-wins: greedy and seeded
        sampling make both legs token-identical, so a hedge dispatched at ANY
        stream position — no first token within the budget, or a mid-stream
        stall after ``k`` tokens — replays the request from scratch, silently
        catches up through the ``k`` already-yielded tokens, and the stream
        follows whichever leg delivers the next position first; the loser is
        cancelled the moment the race is decided (its KV frees upstream).
        The per-token wait is the TTFT budget capped by ``deadline_frac`` x
        the remaining client deadline (a cold-start default must not eat the
        whole deadline), one hedge per request, and a request whose deadline
        passes mid-stream is cut here — the router-side decode feed-stop."""
        router = self._router
        hcfg = router._config.hedge
        events: queue_mod.Queue = queue_mod.Queue()
        legs = {0: (self._leg1, self._last_replica_id)}
        started_s = {0: time.monotonic()}
        delivered = {0: 0}    # tokens received per leg (its stream position)
        live = {0}
        dead: Set[int] = set()
        committed: Optional[int] = None   # decided at the first contested pos
        yielded: List[int] = []
        final: Optional[dict] = None
        first_err: Optional[Exception] = None
        censored: Set[int] = set()  # legs whose silent wait was sampled once
        suppressed_waits = 0        # storm-brake denials: backoff multiplier
        threading.Thread(target=self._reader,
                         args=(0, self._leg1, self._last_replica_id, events),
                         name="dstpu-hedge-leg0", daemon=True).start()
        while final is None:
            remaining = self._deadline_remaining_raw_s()
            if remaining is not None and remaining <= 0:
                # the deadline passed — but events may already be BUFFERED
                # (e.g. the stream completed while a hedge dispatch held the
                # loop): drain them through the NORMAL processing below —
                # buffered tokens still stream, a buffered done still wins —
                # and only cut when the event queue is truly silent
                try:
                    idx, kind, val = events.get_nowait()
                except queue_mod.Empty:
                    for idx in live:
                        legs[idx][0].cancel()
                    final = self._deadline_cut_final(yielded)
                    break
            else:
                budget: Optional[float] = None
                if len(legs) == 1 and not self._cancelled:
                    budget = router._hedge_budget_s()
                    if budget is not None:
                        # each storm-brake denial doubles the next wait
                        # (capped at 4x): a request that cannot hedge must
                        # not spin on the budget, but must still re-check
                        # soon enough that freshly-formed demotion evidence
                        # rescues it inside a client deadline
                        budget = budget * (1 << min(suppressed_waits, 2))
                        if remaining is not None:
                            budget = min(budget,
                                         max(0.02,
                                             remaining * hcfg.deadline_frac))
                try:
                    idx, kind, val = events.get(
                        timeout=budget if budget is not None else remaining)
                except queue_mod.Empty:
                    if budget is None:
                        continue  # deadline wake-up: the top of the loop cuts
                    # budget expired with no stream progress: hedge once. The
                    # silence is itself a latency observation — feed a censored
                    # (elapsed-so-far) TTFT sample to the slow replica's demotion
                    # EWMA so it stops being everyone's least-loaded first pick
                    (slow_idx,) = live
                    slow_id = legs[slow_idx][1]
                    if delivered[slow_idx] == 0 and slow_idx not in censored:
                        # one censored TTFT sample per silent leg (not one per
                        # wake-up — that would pollute the EWMA with wait time)
                        censored.add(slow_idx)
                        router._record_ttft(
                            slow_id, time.monotonic() - started_s[slow_idx])
                    if not router._hedge_admissible(slow_id):
                        # storm brake: no replica-specific evidence and the
                        # speculative bucket is dry — back off and re-check; the
                        # censored sample above builds the demotion evidence
                        # that exempts a genuinely stalled replica's victims
                        suppressed_waits += 1
                        continue
                    try:
                        # a hedge is only worth dispatching if capacity is free
                        # roughly NOW: a long queue acquire here would freeze
                        # the live stream (this loop is the event consumer) and
                        # add load to an already-saturated fleet — so the hedge
                        # leg's queue wait is clamped to a token gesture
                        leg2 = self._dispatch(
                            self._leg_doc(prompt=self._doc["prompt"],
                                          handoff=self._client_handoff,
                                          **self._park_kw()),
                            resume=False, pool_fn=self._pool_fn, what="hedge",
                            exclude={slow_id}, acquire_timeout_s=0.05)
                    except (RoutingError, ValueError, TypeError) as e:
                        # no second replica right now: not fatal — the primary
                        # is slow, not dead; keep waiting and retry next expiry
                        logger.info(f"fleet: hedge dispatch unavailable: {e}")
                        continue
                    self._hedged = True
                    with router._counter_lock:
                        router._counters["hedged"] += 1
                    if router._metrics:
                        router._metrics.hedge_dispatches.inc()
                    legs[1] = (leg2, self._last_replica_id)
                    started_s[1] = time.monotonic()
                    delivered[1] = 0
                    live.add(1)
                    logger.info(f"fleet: hedged {slow_id} after no token within "
                                f"the budget at position {len(yielded)}")
                    threading.Thread(target=self._reader,
                                     args=(1, leg2, self._last_replica_id, events),
                                     name="dstpu-hedge-leg1", daemon=True).start()
                    continue
            if idx in dead:
                continue  # cancelled-loser remnants
            if kind == "err":
                live.discard(idx)
                dead.add(idx)
                self._fail_replica(legs[idx][1])
                if idx == committed:  # the WINNER died mid-stream: same
                    raise val         # contract as the unhedged path
                if not live:
                    raise first_err or val
                first_err = first_err or val
                continue
            if kind == "done":
                if committed is None:
                    # a completed leg is past every position: it wins the
                    # race outright (both legs fully streamed = first done)
                    committed = idx
                    self._commit_leg(idx, legs, live, dead)
                final = val
                continue
            # kind == "tok"
            pos = delivered[idx]
            delivered[idx] = pos + 1
            if pos < len(yielded):
                continue  # hedge catch-up inside the already-yielded prefix
            if committed is None and len(live) > 1:
                # this leg just produced the next needed position first:
                # the race is decided, first-past-the-prefix-wins
                committed = idx
                self._commit_leg(idx, legs, live, dead)
            yielded.append(val)
            yield val
        self._leg_meta("hedge" if committed == 1 else "serve", final)
        return final

    def _fail_replica(self, replica_id: str) -> None:
        replica = self._router._manager_get(replica_id)
        if replica is not None and replica.breaker is not None:
            replica.breaker.record_failure(trial=False)

    # ------------------------------------------------------- work stealing --
    def _steal_eligible(self) -> bool:
        """Steal single-leg generate requests with deadline headroom only:
        a resume leg's one-shot payload has nothing queued to move, the
        disaggregated path re-dispatches its own decode leg, and a request
        about to miss its deadline is better served by staying put than by
        paying a second dispatch."""
        scfg = self._router._config.steal
        if not (scfg.enabled and not self._resume and not self._rehydrated
                and not self._cancelled):
            return False
        remaining = self._remaining_deadline_s()
        return remaining is None or remaining > scfg.min_deadline_headroom_s

    def _attempt_steal(self, victim_id: str) -> Optional[dict]:
        """One steal probe (at most one per request): verify the victim is
        meaningfully hotter than the coldest healthy peer, then ask the
        victim's scheduler — which executes the move on its own loop, the
        exactly-once authority — to release the work. None = keep the
        original leg (no peer, not hot enough, no handle, or the victim won
        the race by finishing first)."""
        router = self._router
        scfg = router._config.steal
        handle = getattr(self._leg1, "handle", None)
        if handle is None:
            return None
        victim = router._manager_get(victim_id)
        if victim is None:
            return None
        peers = router._healthy(self._pool_fn(), {victim_id})
        if not peers:
            return None
        coldest = min(peers, key=lambda r: (r.load, r.id))
        try:
            # the steal decision must not act on a stale load reading
            victim.probe(max_age_s=0.0)
        except Exception:
            return None
        if victim.load <= scfg.load_ratio * coldest.load:
            return None
        with router._counter_lock:
            router._counters["steal_attempts"] += 1
        if router._metrics:
            router._metrics.steal_attempts.inc()
        faults = router._faults
        if (faults is not None
                and faults.fire("steal_race", victim_id) is not None):
            # injected race: the victim finished while the steal decision
            # was in flight — the answer is "finished" and the router keeps
            # consuming the original leg, exactly-once by construction
            router._count_fault()
            out = {"status": "finished"}
        else:
            out = victim.steal(handle)
        if out.get("status") not in ("queued", "exported"):
            return None
        with router._counter_lock:
            router._counters["steals"] += 1
        if router._metrics:
            router._metrics.steals.inc()
        logger.info(f"fleet: stole request {handle} from {victim_id} "
                    f"({out['status']}, load {victim.load} vs "
                    f"{coldest.load} on {coldest.id})")
        return out

    def _run_stealing(self) -> Iterator[int]:
        """Single-leg streaming with the work-stealing monitor armed: while
        no token has arrived within ``wait_budget_s``, the request — queued
        or barely started on a hot replica — may be moved ONCE to a cold
        peer. A "queued" victim re-dispatches from scratch (token-identical
        trivially: same prompt, same seed); an "exported" victim ships its
        live KV as a handoff frame and the continuation resumes on the peer,
        with every pre-export token delivered from the victim's terminal
        doc first so the client stream stays gapless. A lost race keeps the
        original leg — exactly-once either way."""
        router = self._router
        scfg = router._config.steal
        events: queue_mod.Queue = queue_mod.Queue()
        victim_id = self._last_replica_id
        leg1 = self._leg1
        threading.Thread(target=self._reader,
                         args=(0, leg1, victim_id, events),
                         name="dstpu-steal-leg0", daemon=True).start()
        yielded: List[int] = []
        final: Optional[dict] = None
        outcome: Optional[dict] = None
        attempted = False
        while final is None and outcome is None:
            remaining = self._deadline_remaining_raw_s()
            if remaining is not None and remaining <= 0:
                try:
                    idx, kind, val = events.get_nowait()
                except queue_mod.Empty:
                    leg1.cancel()
                    final = self._deadline_cut_final(yielded)
                    break
            else:
                budget = None
                if not attempted and not yielded and not self._cancelled:
                    budget = scfg.wait_budget_s
                    if remaining is not None:
                        budget = min(budget, remaining)
                try:
                    idx, kind, val = events.get(
                        timeout=budget if budget is not None else remaining)
                except queue_mod.Empty:
                    if budget is None:
                        continue  # deadline wake-up: the top of the loop cuts
                    attempted = True
                    outcome = self._attempt_steal(victim_id)
                    continue
            if kind == "err":
                self._fail_replica(victim_id)
                raise val
            if kind == "done":
                final = val
                continue
            yielded.append(val)
            yield val
        if outcome is not None:
            # drain the victim's reader: a stolen request's CANCELLED leg
            # still terminates through the stream, and its terminal doc is
            # the authority on every token produced before the export
            victim_final: Optional[dict] = None
            while victim_final is None:
                idx, kind, val = events.get()
                if kind == "err":
                    self._fail_replica(victim_id)
                    raise val
                if kind == "done":
                    victim_final = val
            self._leg_meta("steal-victim", victim_final)
            for tok in list(victim_final.get("tokens") or []):
                yielded.append(tok)
                yield tok
            if outcome["status"] == "queued":
                leg2 = self._dispatch(
                    self._leg_doc(prompt=self._doc["prompt"],
                                  handoff=self._client_handoff,
                                  deadline_s=self._remaining_deadline_s(),
                                  **self._park_kw()),
                    resume=False, pool_fn=self._pool_fn, what="steal",
                    exclude={victim_id})
            else:
                sent = int(outcome.get("sent") or 0)
                leg2 = self._dispatch(
                    self._leg_doc(payload=outcome["payload"],
                                  max_new_tokens=self._n - sent,
                                  handoff=self._client_handoff,
                                  deadline_s=self._remaining_deadline_s(),
                                  **self._park_kw()),
                    resume=True, pool_fn=self._pool_fn, what="steal-resume",
                    exclude={victim_id}, internal_payload=True)
            stolen_prefix = list(yielded)
            try:
                for tok in self._stream(leg2, self._last_replica_id):
                    remaining = self._deadline_remaining_raw_s()
                    if remaining is not None and remaining <= 0:
                        leg2.cancel()
                        final = self._deadline_cut_final(yielded)
                        break
                    yielded.append(tok)
                    yield tok
                if final is None:
                    final2 = dict(leg2.result())
                    self._leg_meta("steal", final2)
                    final = final2
                    if stolen_prefix:
                        tokens = stolen_prefix + list(final2.get("tokens") or [])
                        final = dict(final2)
                        final["tokens"] = tokens
                        final["n_tokens"] = len(tokens)
                        final["cached_tokens"] = victim_final.get(
                            "cached_tokens", 0)
                        final["e2e_s"] = time.monotonic() - self._t0_s
                    final["stolen"] = True
            except ReplicaDied:
                self._fail_current_replica()
                raise
            finally:
                self._finish_leg(leg2)
        else:
            self._leg_meta("serve", final)
        return final

    # --------------------------------------------------------------- route --
    def _run(self) -> Iterator[int]:
        router = self._router
        if not self._disagg:
            if self._hedge_eligible():
                final = yield from self._run_hedged()
            elif self._steal_eligible():
                final = yield from self._run_stealing()
            else:
                final = None
                yielded: List[int] = []
                try:
                    for tok in self._stream(self._leg1, self._last_replica_id):
                        remaining = self._deadline_remaining_raw_s()
                        if remaining is not None and remaining <= 0:
                            # past-deadline stream: stop feeding NOW (the
                            # router-side twin of the scheduler's per-tick
                            # deadline feed-stop, for stalls the replica
                            # cannot see)
                            self._leg1.cancel()
                            final = self._deadline_cut_final(yielded)
                            break
                        yielded.append(tok)
                        yield tok
                    if final is None:
                        final = dict(self._leg1.result())
                except ReplicaDied:
                    # single-leg death: nothing buffered to resume from — the
                    # breaker learns, the client gets 502 / a terminal SSE error
                    self._fail_current_replica()
                    raise
                finally:
                    self._finish_leg(self._leg1)
                self._leg_meta("rehydrate" if self._rehydrated
                               else "resume" if self._resume else "serve",
                               final)
            if not self._client_handoff:
                final.pop("handoff", None)
        else:
            # --- leg 1 result: prefill + first token
            try:
                final1 = self._leg1.result()
            except ReplicaDied:
                self._fail_current_replica()
                raise
            finally:
                self._finish_leg(self._leg1)
            for tok in final1["tokens"]:
                yield tok
            self._leg_meta("prefill", final1)
            payload = final1.get("handoff")
            continuable = (final1.get("state") == "DONE"
                           and final1.get("finish_reason") == "length"
                           and payload is not None and not self._cancelled)
            if not continuable:
                if (payload is None and not self._cancelled and self._n > 1
                        and final1.get("state") == "DONE"
                        and final1.get("finish_reason") == "length"):
                    # the donor stopped at the handoff point but exported no
                    # payload (export failed replica-side): returning leg 1
                    # verbatim would silently truncate the request to one
                    # token dressed up as a clean completion
                    raise RoutingError(
                        f"prefill replica produced no handoff payload for "
                        f"uid {final1.get('uid')}", status=502)
                # eos on the first token, cancel, or a failed prefill: the
                # first leg's outcome IS the request's outcome
                final = dict(final1)
                final.pop("handoff", None)  # internal transport, not client data
            else:
                # --- leg 2: decode continuation on the decode pool. The
                # payload stays buffered until the leg completes: a decode
                # replica dying mid-leg gets ONE re-dispatch to a peer —
                # resume is token-identical, so the already-streamed prefix
                # is skipped and the client stream stays seamless.
                if router._metrics:
                    router._metrics.handoffs.inc()
                    router._metrics.handoff_bytes.observe(len(payload))
                exclude: Set[str] = set()
                sent2 = 0
                final2 = None
                for attempt in range(2):
                    leg2 = self._dispatch_decode(payload, exclude)
                    try:
                        to_skip, skipped = sent2, 0
                        for tok in self._stream(leg2, self._last_replica_id):
                            if skipped < to_skip:
                                skipped += 1
                                continue
                            yield tok
                            sent2 += 1
                        final2 = dict(leg2.result())
                        self._finish_leg(leg2)
                        break
                    except ReplicaDied as e:
                        self._finish_leg(leg2)
                        self._fail_current_replica()
                        exclude.add(self._last_replica_id)
                        if attempt == 1 or self._cancelled:
                            raise
                        if router._metrics:
                            router._metrics.retries.inc()
                        logger.warning(
                            f"fleet: decode leg died on {self._last_replica_id} "
                            f"after {sent2} streamed tokens; re-dispatching the "
                            f"buffered handoff once: {e}")
                self._leg_meta("decode", final2)
                tokens = list(final1["tokens"]) + list(final2["tokens"])
                final = {
                    "uid": final2.get("uid"),
                    "tokens": tokens,
                    "n_tokens": len(tokens),
                    # the prefix-cache hit happened on the prefill leg: surface
                    # it like the monolithic path does (loadgen --shared-prefix
                    # splits hit/miss TTFT on this field)
                    "cached_tokens": final1.get("cached_tokens", 0),
                    "state": final2.get("state"),
                    "finish_reason": final2.get("finish_reason"),
                    "error": final2.get("error"),
                    "ttft_s": final1.get("ttft_s"),
                    "e2e_s": time.monotonic() - self._t0_s,
                }
                if "handoff" in final2:  # the CLIENT asked for a payload
                    final["handoff"] = final2["handoff"]
                if "park" in final2:  # the decode leg exported a park frame
                    final["park"] = final2["park"]

        self._maybe_park(final)
        final["trace_id"] = self.trace_id
        final["legs"] = self._legs_meta
        if self._degraded:
            final["degraded"] = True
        spans = telemetry.get_span_recorder()
        if spans is not None and self.trace_id is not None:
            spans.record("route", cat="fleet", ts_us=self._t0_us,
                         dur_us=now_us() - self._t0_us,
                         trace_id=self.trace_id, span_id=self._root_span_id,
                         args={"disaggregated": self._disagg,
                               "degraded": self._degraded,
                               "state": final.get("state"),
                               "legs": [m["replica"] for m in self._legs_meta]})
        self._final = final

    def _dispatch_decode(self, payload: bytes, exclude: Set[str]) -> Leg:
        """Dispatch the decode continuation: the decode pool first; when that
        pool is entirely dark, degrade to resuming on any surviving replica
        (prefill/mixed engines share the KV geometry) rather than 502ing a
        request whose prefill work is already paid for."""
        router = self._router
        remaining = None
        if self._doc.get("deadline_s") is not None:
            remaining = max(0.001, float(self._doc["deadline_s"])
                            - (time.monotonic() - self._t0_s))
        doc = self._leg_doc(payload=payload, max_new_tokens=self._n - 1,
                            handoff=self._client_handoff, deadline_s=remaining,
                            **self._park_kw())
        try:
            return self._dispatch(doc, resume=True,
                                  pool_fn=lambda: self._dispatchable("decode"),
                                  what="decode", exclude=exclude,
                                  internal_payload=True)
        except RoutingError:
            fallback_fn = lambda: [r for r in self._dispatchable()
                                   if r.role != "decode"]
            if not [r for r in fallback_fn() if r.id not in exclude]:
                raise
            self._mark_degraded("decode pool unavailable mid-request; "
                                "resuming on the surviving pool")
            return self._dispatch(doc, resume=True, pool_fn=fallback_fn,
                                  what="decode-degraded", exclude=exclude,
                                  internal_payload=True)


class FleetRouter:
    """The fleet front-end: routing core + stdlib HTTP listener."""

    def __init__(self, manager: ReplicaManager, config: Optional[FleetConfig] = None):
        self._manager = manager
        self._config = config or manager.config
        self._metrics = FleetMetrics.maybe_create()
        self._counters = {"requests": 0, "degraded": 0, "hedged": 0,
                          "hedge_wins": 0, "deadline_cuts": 0,
                          "hedges_suppressed": 0,
                          "cache_route_hits": 0, "cache_route_misses": 0,
                          "steals": 0, "steal_attempts": 0}
        self._counter_lock = threading.Lock()
        self._server = None
        self._thread = None
        self._draining = threading.Event()
        # the global queue: queued work lives HERE in priority/deadline
        # order; replicas pull it as their dispatch slots free (ROADMAP 3c)
        gq_cfg = self._config.global_queue
        self._gq: Optional[GlobalQueue] = None
        if gq_cfg.enabled:
            self._gq = GlobalQueue(
                max_inflight=gq_cfg.max_inflight_per_replica,
                capacity=gq_cfg.capacity, pick=self._queue_pick,
                retry_after_floor_s=gq_cfg.retry_after_floor_s,
                retry_after_cap_s=gq_cfg.retry_after_cap_s,
                metrics=self._metrics)
        # fleet-parked sessions: finished-but-continuable sessions bank their
        # KV frame here and rehydrate on ANY replica next turn
        self._park_store: Optional[ParkStore] = None
        if self._config.park.enabled:
            self._park_store = ParkStore(self._config.park,
                                         metrics=self._metrics)
        # router-observed TTFT samples: the hedge budget's p95 source
        self._ttft_samples = collections.deque(maxlen=128)
        self._ttft_lock = threading.Lock()
        # speculative-hedge token bucket (the storm brake): refilled by
        # admissions at max_hedge_frac per request, spent by hedges that
        # lack replica-specific evidence; starts full so a cold fleet can
        # still rescue its very first victims
        self._hedge_allowance_cap = max(1.0, 32 * self._config.hedge.max_hedge_frac)
        self._hedge_allowance = self._hedge_allowance_cap
        # budget cache: every waiting request re-reads the budget each
        # wake-up; a p95 over 128 samples at that frequency is real CPU on
        # a small host, and 100ms staleness is invisible at hedge scale
        self._budget_cache = (0.0, None)   # (computed_at_s, value)
        # fault injection: config first, the DSTPU_FAULTS env var (JSON
        # FaultConfig body) second — None on the (default, production) path,
        # so every hook is one is-None check
        env_faults = config_from_env(os.environ.get("DSTPU_FAULTS"))
        self._faults: Optional[FaultInjector] = None
        if self._config.faults.enabled:
            self._faults = FaultInjector(self._config.faults)
        elif env_faults is not None and env_faults.enabled:
            self._faults = FaultInjector(env_faults)
        # remote chaos control is decided ONCE at construction — and
        # independently of arming: DSTPU_FAULTS='{"allow_remote": true}'
        # exposes the endpoint with zero faults firing, so a loadgen --chaos
        # run's baseline half really is fault-free
        self._chaos_remote = bool(
            self._config.faults.allow_remote
            or (env_faults is not None and env_faults.allow_remote))
        if self._faults is not None:
            logger.warning(f"fleet: FAULT INJECTION ARMED "
                           f"(seed={self._faults.config.seed})")
        # manager-installed hooks (peer prefix fetch) consult the same
        # chaos schedule as router dispatch
        self._manager.faults = self._faults
        # fleet trace collector: merges every process's span ring into one
        # per-trace store (None without a telemetry session — the disabled
        # path never touches it)
        self._collector: Optional[telemetry.TraceCollector] = None
        if telemetry.get_span_recorder() is not None:
            self._collector = telemetry.TraceCollector(metrics=self._metrics)

    @property
    def manager(self) -> ReplicaManager:
        return self._manager

    # ------------------------------------------------------------- dispatch --
    def _healthy(self, pool: List[Replica], exclude) -> List[Replica]:
        ttl = self._config.probe_ttl_s
        out = []
        for replica in pool:
            if replica.id in exclude or not replica.available:
                continue
            if replica.breaker is not None and not replica.breaker.allow():
                # open breaker: skipped without a probe — no socket, no
                # handler thread pinned on a black-holed upstream
                if self._metrics:
                    self._metrics.breaker_short_circuits.inc()
                continue
            probe = replica.probe(max_age_s=ttl)
            if probe.get("healthy") and not probe.get("draining"):
                out.append(replica)
        return out

    def _pick(self, candidates: List[Replica], session_key: Optional[str],
              hint=None) -> Replica:
        """Cache-aware placement first (``hint`` carries the request's prefix
        chain): the replica advertising the deepest cached prefix of this
        prompt wins — KV reuse beats load balance, a hit skips whole prefill
        blocks. Falling back: affinity (rendezvous hash) when a session key
        rides the request, least-loaded otherwise — with slow replicas
        (router-observed TTFT EWMA above ``slow_demote_factor`` × the
        candidate median) demoted to last resort; candidates are already
        healthy-filtered."""
        if hint is not None:
            choice = self._cache_pick(candidates, hint)
            if choice is not None:
                return choice
        if session_key:
            return max(candidates,
                       key=lambda r: _rendezvous_score(session_key, r.id))
        demoted = self._demoted_ids(candidates)
        if demoted:
            if self._metrics:
                self._metrics.hedge_demotions.inc()
            return min(candidates,
                       key=lambda r: (r.id in demoted, r.load, r.id))
        return min(candidates, key=lambda r: (r.load, r.id))

    def _cache_pick(self, candidates: List[Replica],
                    routed: "RoutedRequest") -> Optional[Replica]:
        """The replica whose probe-published digest catalog matches the
        request's block-aligned prefix chain deepest (least-loaded breaks
        ties); None = no candidate clears ``min_match_blocks``. Catalog
        membership of the chain's i-th digest means that replica holds the
        first i+1 blocks (digests are chained), so the deepest member wins —
        no consecutiveness required, the bounded catalog may omit
        intermediates. Staleness is bounded by the probe TTL; a stale hit
        degrades to a shallower local match or a peer fetch replica-side,
        never a wrong answer."""
        best = None
        best_key = (0, 0, "")
        floor = self._config.cache_route.min_match_blocks
        for r in candidates:
            doc = r._probe_doc or {}
            catalog = doc.get("prefix_digests")
            block_size = doc.get("prefix_block_size")
            if not catalog or not block_size:
                continue
            chain = routed._chain_for(int(block_size))
            if not chain:
                continue
            catset = set(catalog)
            depth = 0
            for i, digest_hex in enumerate(chain):
                if digest_hex in catset:
                    depth = i + 1
            if depth < floor:
                continue
            key = (depth, -r.load, r.id)
            if best is None or key > best_key:
                best, best_key = r, key
        routed._note_cache_route(best is not None)
        return best

    def _queue_pick(self, candidates: List[Replica],
                    session_key: Optional[str], pool=None,
                    deadline=None, hint=None) -> Optional[Replica]:
        """The global queue's grant policy: :meth:`_pick` semantics, except
        demotion is judged against the entry's WHOLE pool (not just the
        replicas with free slots) and a deadline-carrying entry is never
        granted to a demoted replica while a faster peer exists anywhere in
        that pool — a grant onto a stalled replica burns the deadline the
        queue exists to protect, so the entry waits for a healthy slot
        instead (None = "rather wait"). Deadline-free work still flows to a
        demoted replica when nothing faster has capacity, which keeps its
        latency EWMAs fed and lets a recovered replica earn its way back."""
        if hint is not None:
            choice = self._cache_pick(candidates, hint)
            if choice is not None:
                return choice
        if session_key:
            return max(candidates,
                       key=lambda r: _rendezvous_score(session_key, r.id))
        demoted = self._demoted_ids(list(pool) if pool else candidates)
        live = [r for r in candidates if r.id not in demoted]
        if live:
            return min(live, key=lambda r: (r.load, r.id))
        if demoted:
            if self._metrics:
                self._metrics.hedge_demotions.inc()
            if deadline is not None and pool \
                    and any(r.id not in demoted for r in pool):
                return None
        return min(candidates, key=lambda r: (r.load, r.id))

    def _demoted_ids(self, candidates: List[Replica]) -> Set[str]:
        """Candidates whose token-latency EWMAs mark them slow-but-alive:
        above ``slow_demote_factor`` × the median of candidates with data,
        on EITHER signal — TTFT (queue wait + first decode) or inter-token
        latency (ITL, the sharper one: load inflates every replica's TTFT
        together, but a healthy replica's ITL stays small, so a stalled
        replica separates by an order of magnitude). Needs >= 2 informed
        candidates per signal — a lone sample has no peer to be slower
        than; the breaker, not demotion, handles a whole-fleet stall."""
        factor = self._config.hedge.slow_demote_factor
        min_samples = self._config.hedge.min_samples
        out: Set[str] = set()
        for ewma, samples in (("ttft_ewma_s", "ttft_samples"),
                              ("itl_ewma_s", "itl_samples")):
            informed = [(r.id, getattr(r, ewma)) for r in candidates
                        if getattr(r, ewma) is not None
                        and getattr(r, samples) >= min_samples]
            if len(informed) < 2:
                continue
            median = float(np.median([s for _, s in informed]))
            if median <= 0:
                continue
            out |= {rid for rid, s in informed if s > factor * median}
        return out if len(out) < len(candidates) else set()

    def _record_ttft(self, replica_id: str, sample_s: float) -> None:
        replica = self._manager_get(replica_id)
        if replica is not None:
            replica.record_ttft(sample_s)
        with self._ttft_lock:
            self._ttft_samples.append(sample_s)

    def _record_itl(self, replica_id: str, sample_s: float) -> None:
        replica = self._manager_get(replica_id)
        if replica is not None:
            replica.record_itl(sample_s)

    def _manager_get(self, replica_id: str) -> Optional[Replica]:
        try:
            return self._manager.get(replica_id)
        except KeyError:
            return None  # deregistered mid-request (supervisor reaped it)

    def _hedge_budget_s(self) -> Optional[float]:
        """The TTFT budget before a hedge fires: fixed when configured, else
        p95 of the router's observed TTFTs × ``budget_factor`` (the
        cold-start default until enough samples land)."""
        hcfg = self._config.hedge
        if not hcfg.enabled:
            return None
        if hcfg.ttft_budget_s is not None:
            return hcfg.ttft_budget_s
        now = time.monotonic()
        with self._ttft_lock:
            cached_at, cached = self._budget_cache
            if cached is not None and now - cached_at < 0.1:
                return cached
            samples = list(self._ttft_samples)
        if len(samples) < hcfg.min_samples:
            value = hcfg.default_budget_s
        else:
            value = max(hcfg.min_budget_s,
                        float(np.percentile(np.asarray(samples), 95))
                        * hcfg.budget_factor)
        with self._ttft_lock:
            self._budget_cache = (now, value)
        return value

    def _hedge_admissible(self, slow_replica_id: str) -> bool:
        """May a hedge fire against ``slow_replica_id`` right now? Evidence-
        driven hedges — the replica's TTFT EWMA is demotion-grade slow vs
        its current peers — always may (a stalled replica's victims are
        rescued unconditionally); speculative ones spend a token from the
        storm brake bucket, and are suppressed (counted) when it is dry."""
        replica = self._manager_get(slow_replica_id)
        if replica is not None:
            peers = [r for r in self._manager.replicas(available_only=True)]
            if slow_replica_id in self._demoted_ids(peers):
                return True
        with self._counter_lock:
            if self._hedge_allowance >= 1.0:
                self._hedge_allowance -= 1.0
                return True
            self._counters["hedges_suppressed"] += 1
        if self._metrics:
            self._metrics.hedge_suppressed.inc()
        return False

    def _count_fault(self) -> None:
        if self._metrics:
            self._metrics.faults_injected.inc()

    def set_faults(self, config: Optional[FaultConfig]) -> None:
        """Arm/re-seed/disable the fault injector at runtime (the
        ``/v1/fleet/chaos`` handler and the chaos tests)."""
        self._faults = (FaultInjector(config)
                        if config is not None and config.enabled else None)
        self._manager.faults = self._faults
        if self._faults is not None:
            logger.warning(f"fleet: FAULT INJECTION ARMED "
                           f"(seed={config.seed})")
        else:
            logger.info("fleet: fault injection disarmed")

    def route(self, doc: dict, resume: bool = False,
              session_key: Optional[str] = None,
              trace_id: Optional[str] = None) -> RoutedRequest:
        """Admit one client request; the first leg is dispatched before this
        returns (admission failures raise :class:`RoutingError`).
        ``trace_id`` adopts an upstream trace (minted otherwise when
        telemetry is active); the router span parents both replica legs."""
        if self._draining.is_set():
            raise RoutingError("router is draining", status=503)
        validate_priority(doc.get("priority"))  # unknown class = client 400
        with self._counter_lock:
            self._counters["requests"] += 1
            # every admission refills the speculative-hedge storm brake
            self._hedge_allowance = min(
                self._hedge_allowance_cap,
                self._hedge_allowance + self._config.hedge.max_hedge_frac)
        if self._metrics:
            self._metrics.requests.inc()
        if self._faults is not None and self._gq is not None:
            # overload_burst: a seeded synthetic admission burst — phantom
            # entries occupy the global queue, deterministically driving
            # depth pressure, Retry-After growth and queue shedding
            n = self._faults.fire("overload_burst")
            if n is not None:
                self._count_fault()
                self._gq.inject_phantoms(
                    self._faults.config.overload_burst_requests,
                    self._faults.config.overload_burst_hold_s)
        # no fleet-wide probe sweep here: _healthy probes the candidate pool
        # (TTL-cached) during dispatch; a dead upstream elsewhere in the fleet
        # must not add its probe timeout to THIS request's latency. The
        # fleet-wide gauges are pushed by stats()/the autoscaler tick instead.
        if trace_id is None and telemetry.get_span_recorder() is not None:
            trace_id = new_trace_id()
        return RoutedRequest(self, doc, resume, session_key, trace_id)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Fleet-wide graceful drain: stop admitting (503), then drain every
        replica bounded by ``drain_timeout_s`` each."""
        self._draining.set()
        self._manager.drain_all(timeout=timeout)

    # ---------------------------------------------------------------- stats --
    def fleet_stats(self) -> dict:
        doc = self._manager.stats()
        with self._counter_lock:
            doc["router"] = dict(self._counters)
        doc["router"]["draining"] = self._draining.is_set()
        if self._gq is not None:
            doc["router"]["global_queue"] = self._gq.describe()
        hedge_budget = self._hedge_budget_s()
        with self._ttft_lock:
            n_samples = len(self._ttft_samples)
        doc["router"]["hedge"] = {
            "enabled": self._config.hedge.enabled,
            "budget_s": round(hedge_budget, 4) if hedge_budget else None,
            "ttft_samples": n_samples,
        }
        if self._park_store is not None:
            doc["router"]["park"] = self._park_store.stats()
        faults = self._faults
        if faults is not None:
            doc["faults"] = faults.report()
        if self._collector is not None:
            doc["router"]["trace_collector"] = self._collector.describe()
        return doc

    def stats(self) -> dict:
        """Aggregate ``/v1/stats`` (single-replica wire shape, fleet-wide
        numbers) so loadgen-style clients work unchanged through the router."""
        probes = self._manager.sweep_probes()
        live = [p for p in probes if p.get("healthy")]
        with self._counter_lock:
            counters = dict(self._counters)
        slo = telemetry.get_slo_engine()
        return {
            "queue_depth": sum(p["queue_depth"] for p in live),
            "active": {"total": sum(p["active"] for p in live)},
            "replicas": len(probes),
            "draining": self._draining.is_set(),
            "counters": counters,
            "slo": slo.status() if slo is not None else None,
        }

    # -------------------------------------------------------- observability --
    def collect_traces(self) -> Optional[telemetry.TraceCollector]:
        """One collection round over every span source: the router's own
        recorder plus each replica ring (HttpReplica over ``/trace/export``,
        LocalReplica deduped against the shared in-process ring). On-demand —
        the ``/v1/fleet/trace`` handler and tests drive it; probe sweeps stay
        light."""
        if self._collector is None:
            return None
        self._collector.collect(recorder=telemetry.get_span_recorder(),
                                replicas=self._manager.replicas())
        return self._collector

    def fleet_trace(self, trace_id: Optional[str] = None) -> dict:
        """``/v1/fleet/trace`` body: the merged, clock-corrected Chrome-trace
        doc (Perfetto loads it unchanged)."""
        collector = self.collect_traces()
        if collector is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "collector": None}
        return collector.chrome_trace(trace_id)

    def fleet_timeseries(self) -> dict:
        """``/v1/fleet/timeseries`` body: the router process's series plus
        each replica's rollup off its probe doc."""
        ts = telemetry.get_timeseries()
        doc = {"router": ts.snapshot() if ts is not None else None,
               "replicas": {}}
        self._manager.sweep_probes()
        for replica in self._manager.replicas():
            probe = replica._probe_doc or {}
            if isinstance(probe.get("timeseries"), dict):
                doc["replicas"][replica.id] = probe["timeseries"]
        return doc

    def fleet_usage(self) -> dict:
        """``/v1/fleet/usage`` body: the per-tenant cost rollup summed across
        every replica's probe doc, with the per-replica breakdown alongside.
        Each replica meters its own dispatches; the router only folds the
        numeric fields, so fleet tenant totals reconcile exactly against the
        per-replica ledgers (integer token counts sum losslessly)."""
        self._manager.sweep_probes()
        tenants: dict = {}
        replicas: dict = {}
        for replica in self._manager.replicas():
            probe = replica._probe_doc or {}
            usage = probe.get("usage")
            if not isinstance(usage, dict) or not usage.get("enabled"):
                continue
            replicas[replica.id] = usage
            for name, row in (usage.get("tenants") or {}).items():
                _merge_usage_row(tenants.setdefault(name, {}), row)
        return {"enabled": bool(replicas), "tenants": tenants,
                "replicas": replicas}

    def fleet_slo(self) -> dict:
        """``/v1/fleet/slo`` body: the SLO engine's objective status (burn
        rates, open breach episodes), or ``enabled: false`` without one."""
        engine = telemetry.get_slo_engine()
        if engine is None:
            return {"enabled": False, "objectives": [], "in_breach": False}
        return {"enabled": True, **engine.status()}

    # ----------------------------------------------------------------- HTTP --
    @property
    def address(self):
        return self._server.server_address if self._server else None

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "FleetRouter":
        router, config, draining = self, self._config, self._draining

        class Handler(BaseHTTPRequestHandler):

            def _send_json(self, code, doc, trace_id=None, retry_after=None):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if trace_id is not None:
                    self.send_header(TRACE_HEADER, trace_id)
                if retry_after is not None:
                    self.send_header("Retry-After", retry_after_header(retry_after))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/v1/fleet/stats":
                    self._send_json(200, router.fleet_stats())
                elif path == "/v1/stats":
                    self._send_json(200, router.stats())
                elif path == "/v1/fleet/trace":
                    trace_id = None
                    for part in self.path.partition("?")[2].split("&"):
                        if part.startswith("trace_id="):
                            trace_id = part.split("=", 1)[1] or None
                    self._send_json(200, router.fleet_trace(trace_id))
                elif path == "/v1/fleet/timeseries":
                    self._send_json(200, router.fleet_timeseries())
                elif path == "/v1/fleet/slo":
                    self._send_json(200, router.fleet_slo())
                elif path == "/v1/fleet/usage":
                    self._send_json(200, router.fleet_usage())
                elif path == "/healthz":
                    self._send_json(200, {"status": "draining" if draining.is_set()
                                          else "ok"})
                else:
                    self._send_json(404, {"error": f"no route {path}"})

            def _handle_chaos(self):
                """POST /v1/fleet/chaos: arm/re-seed/disable fault injection
                over HTTP — only when a config/env explicitly allowed remote
                chaos control (403 otherwise; production routers never expose
                a kill switch by accident)."""
                if not router._chaos_remote:
                    self._send_json(403, {"error": "remote chaos control is "
                                          "not enabled on this router"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if not 0 < length <= 1 << 16:
                        raise ValueError(f"body length {length} out of bounds")
                    fault_config = FaultConfig(**json.loads(self.rfile.read(length)))
                except Exception as e:
                    self._send_json(400, {"error": str(e)})
                    return
                router.set_faults(fault_config)
                self._send_json(200, {"enabled": fault_config.enabled,
                                      "seed": fault_config.seed})

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/v1/fleet/chaos":
                    self._handle_chaos()
                    return
                if path not in ("/v1/generate", "/v1/resume"):
                    self._send_json(404, {"error": f"no route {path}"})
                    return
                if draining.is_set():
                    self._send_json(503, {"error": "router is draining"})
                    return
                resume = path == "/v1/resume"
                try:
                    # the single wire-format authority, shared with
                    # serving/server.py: a client cannot tell the router
                    # from one replica
                    doc = parse_request_body(
                        self, resume=resume,
                        max_bytes=config.max_resume_body_bytes if resume else None)
                except (KeyError, ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                session_key = (self.headers.get(config.affinity_header)
                               or doc.get("session") or None)
                if not doc.get("priority") and self.headers.get(PRIORITY_HEADER):
                    # header-form priority class, same contract as a replica
                    doc["priority"] = self.headers.get(PRIORITY_HEADER)
                if not doc.get("tenant") and self.headers.get(TENANT_HEADER):
                    # header-form tenant identity: forwarded on the leg doc so
                    # the serving replica bills the right tenant
                    doc["tenant"] = self.headers.get(TENANT_HEADER)
                upstream_trace = self.headers.get(TRACE_HEADER) or None
                try:
                    routed = router.route(doc, resume=resume,
                                          session_key=session_key,
                                          trace_id=upstream_trace)
                except RoutingError as e:
                    self._send_json(e.status, {"error": str(e)},
                                    retry_after=e.retry_after_s)
                    return
                except (ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                try:
                    if doc.get("stream"):
                        self._stream_sse(routed)
                    else:
                        final = dict(routed.result())
                        self._encode_handoff(final)
                        # 429 only when nothing was delivered (an admission-
                        # class rejection) — same contract as
                        # serving/server.py; a mid-decode deadline cut that
                        # streamed partial tokens consumed real capacity and
                        # stays a 200 TIMED_OUT doc
                        status = (429 if final.get("retry_after_s")
                                  and not final.get("tokens") else 200)
                        self._send_json(status, final, trace_id=routed.trace_id,
                                        retry_after=final.get("retry_after_s"))
                except RoutingError as e:
                    # mid-route failure (e.g. the decode pool vanished after
                    # the prefill leg): non-stream mode can still say why
                    routed.cancel()
                    self._send_json(e.status, {"error": str(e)},
                                    retry_after=e.retry_after_s)
                except (ValueError, TypeError) as e:
                    routed.cancel()
                    self._send_json(400, {"error": str(e)})
                except RuntimeError as e:
                    # a replica died mid-leg (ReplicaDied, or an upstream SSE
                    # malformation): answer 502, free the surviving leg's KV
                    routed.cancel()
                    self._send_json(502, {"error": str(e)})

            @staticmethod
            def _encode_handoff(doc):
                # raw payload bytes -> base64 for the JSON/SSE wire: handoff
                # frames and client-requested park frames alike
                for key in ("handoff", "park"):
                    if isinstance(doc.get(key), (bytes, bytearray)):
                        doc[key] = base64.b64encode(doc[key]).decode()

            def _stream_sse(self, routed):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if routed.trace_id is not None:
                    self.send_header(TRACE_HEADER, routed.trace_id)
                self.end_headers()
                try:
                    for i, tok in enumerate(routed.tokens()):
                        self.wfile.write(
                            f"data: {json.dumps({'token': tok, 'index': i})}\n\n".encode())
                        self.wfile.flush()
                    final = dict(routed.result())
                    self._encode_handoff(final)
                    self.wfile.write(
                        f"data: {json.dumps({'done': True, **final})}\n\n".encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    routed.cancel()  # client went away: free KV upstream
                except (RoutingError, RuntimeError, ValueError, TypeError) as e:
                    # mid-stream routing failure, a replica dying mid-leg, or a
                    # malformed upstream event: the SSE headers are already on
                    # the wire, so the ONLY valid reaction is a terminal error
                    # event — never a second HTTP status line.
                    # Free the surviving leg's KV, best-effort error event
                    routed.cancel()
                    event = {"done": True, "state": "FAILED", "error": str(e)}
                    if isinstance(e, RoutingError) and e.retry_after_s is not None:
                        # the backoff rides the SSE error event: streaming
                        # clients see the same Retry-After contract
                        event["retry_after_s"] = e.retry_after_s
                    try:
                        self.wfile.write(
                            f"data: {json.dumps(event)}\n\n".encode())
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass

            def log_message(self, fmt, *args):
                ...  # routing must not spam the serving log

        self._server = ThreadingHTTPServer((self._config.host, self._config.port),
                                           Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dstpu-fleet-router", daemon=True)
        self._thread.start()
        logger.info(f"fleet router: /v1/generate /v1/resume /v1/stats "
                    f"/v1/fleet/stats /v1/fleet/trace /v1/fleet/timeseries "
                    f"/v1/fleet/slo /v1/fleet/usage /healthz on {self.url}")
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Graceful fleet shutdown: 503 new requests, drain every replica,
        close the listener. Idempotent."""
        self.drain(timeout=(timeout if timeout is not None
                            else self._config.drain_timeout_s) if drain else 0.0)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None

    def __enter__(self):
        return self.start() if self._server is None else self

    def __exit__(self, *exc):
        self.stop(drain=False)
