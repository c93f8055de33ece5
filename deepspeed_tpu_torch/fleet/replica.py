"""Replica abstractions for the fleet layer.

A *replica* is one independently-schedulable serving engine. Two kinds behind
one dispatch interface, so the router never cares which it is talking to:

- :class:`LocalReplica` — an ``(InferenceEngineV2 + ServingScheduler)`` pair
  living in this process. The CPU-testable formulation: a 4-replica
  disaggregated fleet is four tiny engines and four scheduler threads, no
  sockets between router and engine.
- :class:`HttpReplica` — an external ``serving/server.py`` process addressed
  by URL; dispatch is ``POST /v1/generate`` / ``POST /v1/resume`` over the
  wire (SSE upstream, so admission errors surface before generation and
  tokens arrive live), probing is ``GET /healthz`` + ``GET /v1/stats``.
  Upstream sockets carry **separate connect and read budgets** — a
  black-holed upstream costs a dispatch thread ``connect_timeout_s``, and a
  stalled stream dies after ``read_timeout_s``, never the whole-leg budget.

Dispatch returns a :class:`Leg` — a uniform handle the router iterates for
live tokens and joins for the final result doc (which carries the KV-handoff
payload as raw bytes when the leg was dispatched with ``handoff=True``).

Failure taxonomy (the breaker's food groups):

- :class:`ReplicaUnavailable` at dispatch — cannot admit right now (429/503/
  unreachable/connect-timeout); the router's failover signal. Status 429 is
  backpressure, not breakage — it never feeds the circuit breaker.
- :class:`ReplicaDied` mid-leg — the replica went away under an admitted
  request (stream ended without a terminal event, read timeout, or the
  request carries the scheduler's ``replica killed`` disposition). The router
  re-dispatches a decode leg once (the handoff payload is still buffered)
  and counts the death against the replica's breaker.
- ``ValueError`` — client errors (bad payload geometry, invalid parameters);
  never retried blindly (the router retries a *router-packed* resume payload
  once, suspecting transit corruption).

Every registered replica carries a :class:`~deepspeed_tpu_torch.fleet.breaker.
CircuitBreaker` (attached by the manager) fed here by probe outcomes and by
the router per dispatch; a ``QUARANTINED`` replica (a supervised crash-looper)
stays visible in ``/v1/fleet/stats`` but counts as absent capacity — never
probed, never dispatched.

Port of ``deepspeed_tpu/fleet/replica.py`` (host Python, unchanged in behaviour
except where noted).
"""

import base64
import dataclasses
import http.client
import itertools
import json
import random
import socket
import threading
import time
import urllib.parse
from enum import Enum
from typing import Iterator, Optional

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.fleet.breaker import CircuitBreaker, backoff_delay
from deepspeed_tpu_torch.inference.v2.ragged.handoff import \
    CONTENT_TYPE as HANDOFF_CONTENT_TYPE
from deepspeed_tpu_torch.serving import (AdmissionRejected, QueueFullError,
                                         SchedulerStopped, ServingConfig,
                                         ServingScheduler)
from deepspeed_tpu_torch.serving.request import Request
from deepspeed_tpu_torch.serving.scheduler import KILLED_ERROR_PREFIX
from deepspeed_tpu_torch.serving.server import (HANDLE_HEADER,
                                                HANDOFF_TRANSPORT_HEADER,
                                                PARAMS_HEADER, PARENT_SPAN_HEADER,
                                                STEAL_SENT_HEADER, TRACE_HEADER)
from deepspeed_tpu_torch.utils.logging import logger

_REPLICA_IDS = itertools.count()


class ReplicaState(Enum):
    UP = 0
    DRAINING = 1
    DOWN = 2
    QUARANTINED = 3
    """A supervised crash-looper: registered (visible in stats) but absent
    capacity — not dispatched, not probed, not counted in pool sizes."""


class ReplicaUnavailable(RuntimeError):
    """This replica cannot admit the request right now (429/503/unreachable);
    the router fails over to the next candidate. ``retry_after_s`` carries
    the replica's drain-rate-derived backoff when its refusal was overload
    shedding (the router forwards the largest one it saw)."""

    def __init__(self, message: str, status: int = 503,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


class ReplicaDied(RuntimeError):
    """The replica went away under an admitted leg (process death, stream
    truncation, read timeout, injected kill): the leg's tokens so far are
    valid, its terminal doc never arrived. A breaker-grade failure; the
    router may re-dispatch a decode leg whose handoff payload it still holds."""


def _raise_if_killed(doc: dict) -> None:
    """A terminal doc carrying the scheduler's kill disposition is a replica
    death, not a semantic request failure — surface it as such."""
    if (doc.get("state") == "FAILED"
            and str(doc.get("error") or "").startswith(KILLED_ERROR_PREFIX)):
        raise ReplicaDied(str(doc["error"]))


class Leg:
    """One dispatched request leg: iterate for live tokens, ``result()`` for
    the terminal doc (``serving/server._request_doc`` shape, with the handoff
    payload — when requested — as raw bytes under ``"handoff"``).

    ``handle`` is the replica-side request handle (``Request.handle``) once
    known — the address the router's work-stealing monitor uses to claim the
    leg back out of the replica; None until the replica surfaced it (an HTTP
    leg learns it from the SSE response headers)."""

    handle: Optional[str] = None

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def result(self, timeout: Optional[float] = None) -> dict:
        raise NotImplementedError

    def cancel(self) -> None:
        raise NotImplementedError


class Replica:
    """Base replica: identity, role, rotation state, probe caching with
    failed-probe backoff, the manager-attached circuit breaker, and the
    router-maintained dispatch counters."""

    def __init__(self, role: str = "mixed", replica_id: Optional[str] = None):
        self.id = replica_id if replica_id else f"{role}-{next(_REPLICA_IDS)}"
        self.role = role
        self.state = ReplicaState.UP
        self.breaker: Optional[CircuitBreaker] = None  # attached at register
        self.dispatches = 0   # legs the router sent here (router thread)
        self.failures = 0     # legs that raised ReplicaUnavailable here
        # router-observed first-token latency EWMA: the slow-replica
        # demotion signal (latency-shaped, where the breaker is
        # failure-shaped) — a slow-but-alive replica never trips a breaker
        # but must stop being everyone's least-loaded first pick
        self.ttft_ewma_s: Optional[float] = None
        self.ttft_samples = 0
        # inter-token latency EWMA: the sharper half of the demotion signal
        # — queue wait contaminates TTFT fleet-wide under load, but a
        # healthy replica's ITL stays small, so a stalled replica separates
        # by an order of magnitude instead of a factor
        self.itl_ewma_s: Optional[float] = None
        self.itl_samples = 0
        self._probe_lock = threading.Lock()
        self._probe_at = 0.0
        self._probe_doc: Optional[dict] = None
        self._probe_fails = 0  # consecutive raising probes (they set the backoff)
        # failed-probe re-probe backoff (manager overrides from FleetConfig);
        # the shared bounded-jitter policy at probe scale
        self.probe_backoff_base_s = 0.25
        self.probe_backoff_cap_s = 10.0
        self.probe_jitter_frac = 0.25
        # per-transport KV payload bytes moved across this replica's dispatch
        # interface (resume bodies in, handoff/steal/prefix frames out):
        # ``binary`` = raw handoff frames, ``base64`` = the encoded wire text,
        # ``local`` = in-process moves. Feeds the fleet_kv_transport_*
        # counters and the zero-copy perf gate's byte accounting.
        self.kv_wire_bytes = {"binary": 0, "base64": 0, "local": 0}
        self._kv_bytes_lock = threading.Lock()
        self.fleet_metrics = None  # ReplicaManager._register attaches it

    def record_kv_bytes(self, transport: str, n: int) -> None:
        """Account ``n`` wire bytes of KV payload over ``transport`` (any
        thread — dispatch handlers and SSE leg readers both feed this)."""
        n = int(n)
        with self._kv_bytes_lock:
            self.kv_wire_bytes[transport] = (
                self.kv_wire_bytes.get(transport, 0) + n)
        m = self.fleet_metrics
        if m is not None:
            m.kv_transport_bytes.inc(n)
            if transport == "binary":
                m.kv_transport_binary_bytes.inc(n)
            elif transport == "base64":
                m.kv_transport_base64_bytes.inc(n)

    @property
    def available(self) -> bool:
        """In rotation: the router only dispatches to available replicas."""
        return self.state is ReplicaState.UP

    # ------------------------------------------------------------------ probe --
    def probe(self, max_age_s: float = 0.0) -> dict:
        """Health + load snapshot, cached up to ``max_age_s`` (the router's
        ``probe_ttl_s``): ``healthy`` / ``draining`` / ``queue_depth`` /
        ``active`` / ``kv_free_frac`` / ``heartbeats``.

        A ``_probe()`` against a blackholed HTTP upstream can block for its
        full socket timeout, so a stale doc is served rather than queueing
        every router handler thread behind the one doing the refresh — only
        the very first probe (no doc yet) waits. A probe that *raised* backs
        off exponentially (shared ``backoff_delay`` policy) before the next
        refresh, and feeds the circuit breaker; a healthy answer closes a
        HALF_OPEN breaker."""
        doc = self._probe_doc
        ttl = max_age_s
        if self._probe_fails:
            ttl = max(ttl, backoff_delay(self._probe_fails - 1,
                                         max(self.probe_backoff_base_s, max_age_s),
                                         self.probe_backoff_cap_s,
                                         self.probe_jitter_frac, random.random()))
        if doc is not None and time.monotonic() - self._probe_at <= ttl:
            return doc
        if not self._probe_lock.acquire(blocking=doc is None):
            return doc  # a peer thread is refreshing; stale beats stalled
        try:
            if self._probe_doc is None or time.monotonic() - self._probe_at > ttl:
                try:
                    self._probe_doc = self._probe()
                    self._probe_fails = 0
                    if self.breaker is not None and self._probe_doc.get("healthy"):
                        self.breaker.record_probe_success()
                except Exception as e:
                    self._probe_fails += 1
                    self._probe_doc = {"healthy": False, "draining": False,
                                       "queue_depth": 0, "active": 0,
                                       "kv_free_frac": 0.0, "heartbeats": 0,
                                       "error": f"{type(e).__name__}: {e}"}
                    if self.breaker is not None:
                        self.breaker.record_failure(trial=False)
                # stamped AFTER the refresh: a slow failing probe (its whole
                # point is bounding those) must not eat its own backoff window
                self._probe_at = time.monotonic()
            return self._probe_doc
        finally:
            self._probe_lock.release()

    def _probe(self) -> dict:
        raise NotImplementedError

    @property
    def load(self) -> int:
        """Least-loaded ordering key from the last probe (queued + in-flight)."""
        doc = self._probe_doc or {}
        return int(doc.get("queue_depth", 0)) + int(doc.get("active", 0))

    def record_ttft(self, sample_s: float, alpha: float = 0.3) -> None:
        """Feed one router-observed first-token latency into the demotion
        EWMA (router handler threads; a torn float read is harmless)."""
        self.ttft_ewma_s = (sample_s if self.ttft_ewma_s is None
                            else (1 - alpha) * self.ttft_ewma_s + alpha * sample_s)
        self.ttft_samples += 1

    def record_itl(self, sample_s: float, alpha: float = 0.3) -> None:
        """Feed one router-observed inter-token gap into the demotion EWMA."""
        self.itl_ewma_s = (sample_s if self.itl_ewma_s is None
                           else (1 - alpha) * self.itl_ewma_s + alpha * sample_s)
        self.itl_samples += 1

    # --------------------------------------------------------------- dispatch --
    def dispatch(self, doc: dict, resume: bool = False,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[int] = None) -> Leg:
        """Admit one request leg. ``doc`` is the client-wire JSON body
        (``prompt`` for generate, ``payload`` bytes for resume, plus the
        optional sampling/deadline fields and the ``handoff`` flag). Raises
        :class:`ReplicaUnavailable` when this replica cannot admit."""
        raise NotImplementedError

    # -------------------------------------------------------- observability --
    # the in-process SpanRecorder this replica's spans land in, when it shares
    # one with the caller (LocalReplica); the trace collector dedupes sources
    # by recorder identity so a shared ring is only drained once
    span_recorder = None

    def collect_spans(self, since_us: int = 0) -> Optional[dict]:
        """Drain this replica's span ring for the fleet trace collector:
        ``{"now_us", "pid", "dropped", "spans": [...]}`` with ``since_us`` in
        the replica's own clock. None = this replica kind exports nothing."""
        return None

    # ----------------------------------------------------------- data motion --
    def fetch_prefix(self, digests, min_blocks: int = 1,
                     timeout: float = 2.0) -> Optional[bytes]:
        """Ask this replica to frame its deepest cached prefix along
        ``digests`` (full 20-byte chained digests) as a handoff payload —
        the peer-KV-fetch donor side. None = nothing deep enough cached (or
        the replica kind doesn't serve fetches); the caller proceeds cold."""
        return None

    def steal(self, handle: str, timeout: float = 5.0) -> dict:
        """Ask this replica to give up the request addressed by ``handle``.
        Returns the scheduler's steal verdict doc: ``{"status": "queued"}``
        (never started — re-dispatch from scratch), ``{"status": "exported",
        "payload": bytes, "sent": n}`` (mid-decode — resume elsewhere), or
        ``{"status": "finished"}`` (too late / unreachable — the caller keeps
        the original leg; the conservative exactly-once default)."""
        return {"status": "finished"}

    # ------------------------------------------------------------- lifecycle --
    def drain(self, timeout: Optional[float] = None) -> None:
        """Leave rotation, let in-flight requests finish (bounded), then stop."""
        raise NotImplementedError

    def close(self) -> None:
        self.drain(timeout=0.0)

    def describe(self) -> dict:
        """/v1/fleet/stats row."""
        return {"id": self.id, "role": self.role, "state": self.state.name,
                "url": getattr(self, "url", None),
                "dispatches": self.dispatches, "failures": self.failures,
                "ttft_ewma_s": (round(self.ttft_ewma_s, 4)
                                if self.ttft_ewma_s is not None else None),
                "breaker": self.breaker.describe() if self.breaker else None,
                "kv_wire_bytes": dict(self.kv_wire_bytes),
                "probe": self._probe_doc}


class QuarantinedReplica(Replica):
    """Placeholder the supervisor registers for a crash-looping slot whose
    launch never produced a live replica: visible in stats, inert otherwise."""

    def __init__(self, role: str = "mixed", replica_id: Optional[str] = None):
        super().__init__(role=role, replica_id=replica_id)
        self.state = ReplicaState.QUARANTINED

    def _probe(self) -> dict:
        return {"healthy": False, "draining": False, "queue_depth": 0,
                "active": 0, "kv_free_frac": 0.0, "heartbeats": 0,
                "error": "quarantined"}

    def dispatch(self, doc, resume=False, trace_id=None, parent_span_id=None):
        raise ReplicaUnavailable(f"replica {self.id} is QUARANTINED")

    def drain(self, timeout: Optional[float] = None) -> None:
        self.state = ReplicaState.DOWN


# ---------------------------------------------------------------------------
# in-process replica
# ---------------------------------------------------------------------------
class _LocalLeg(Leg):

    def __init__(self, req: Request):
        self.request = req
        self.handle = req.handle

    def __iter__(self):
        return iter(self.request.stream)

    def result(self, timeout: Optional[float] = None) -> dict:
        req = self.request
        if not req.wait(timeout):
            raise TimeoutError(f"leg {req.uid} not finished within {timeout}s")
        from deepspeed_tpu_torch.serving.server import _request_doc
        doc = _request_doc(req, raw_handoff=True)
        _raise_if_killed(doc)
        return doc

    def cancel(self) -> None:
        self.request.cancel()


class LocalReplica(Replica):
    """An in-process ``engine + scheduler`` replica. The engine is owned:
    ``drain()``/``close()`` stop the scheduler and close the engine.

    ``serving_config`` defaults to heartbeating while idle (``empty_run``)
    regardless of expert parallelism — a fleet pool member must stay warm (and,
    under EP, in collective lock-step) while its peers take traffic.
    """

    def __init__(self, engine, role: str = "mixed",
                 serving_config: Optional[ServingConfig] = None,
                 replica_id: Optional[str] = None):
        super().__init__(role=role, replica_id=replica_id)
        self.engine = engine
        if serving_config is None:
            serving_config = ServingConfig(heartbeat_enabled=True)
        elif serving_config.heartbeat_enabled is None:
            # the pool-member warmth contract holds for custom configs too:
            # only an explicit False opts a replica out of idle empty_run
            serving_config = dataclasses.replace(serving_config, heartbeat_enabled=True)
        self.scheduler = ServingScheduler(engine, serving_config)
        self._capacity_blocks = engine._state_manager.kv_cache.num_blocks

    def _probe(self) -> dict:
        sched = self.scheduler
        free = self.engine.free_blocks
        doc = {
            "healthy": (self.state is ReplicaState.UP and not sched._stopping
                        and sched.ready),
            "draining": self.state is ReplicaState.DRAINING or sched._stopping,
            "queue_depth": sched.queue_depth,
            "active": sched.n_active,
            "kv_free_frac": free / self._capacity_blocks if self._capacity_blocks else 0.0,
            "heartbeats": sched._counters["heartbeats"],
        }
        digests = sched.prefix_digest_catalog()
        if digests is not None:
            # the trie's fleet-visible shape: what cache-aware routing and
            # peer prefix fetch match the request chain against
            doc["prefix_digests"] = digests
            doc["prefix_block_size"] = self.engine._state_manager.kv_block_size
        pc = sched._prefix_cache
        if pc is not None:
            s = pc.stats()
            # the per-replica hit-rate attribution loadgen reads off
            # /v1/fleet/stats (each stats row carries its last probe doc)
            doc["prefix_stats"] = {k: s.get(k) for k in
                                   ("lookups", "hits", "hit_rate",
                                    "trie_blocks")}
        ts = telemetry.get_timeseries()
        if ts is not None:
            # fleet time-series rollup rides the probe doc (bounded: the
            # windowed summary, not the full retention)
            doc["timeseries"] = ts.snapshot(max_points=64)
        usage = sched.usage()
        if usage.get("enabled"):
            # per-tenant cost rollup rides the probe doc (bounded by the
            # ledger's max_tenants cap) — /v1/fleet/usage aggregates these
            doc["usage"] = usage
        return doc

    @property
    def span_recorder(self):
        # an in-process scheduler records into the process-global ring — the
        # same one the router drains directly; exposing it lets the collector
        # skip this replica instead of double-ingesting
        return telemetry.get_span_recorder()

    def collect_spans(self, since_us: int = 0) -> Optional[dict]:
        recorder = telemetry.get_span_recorder()
        return recorder.export_since(since_us) if recorder is not None else None

    def dispatch(self, doc: dict, resume: bool = False,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[int] = None) -> Leg:
        if not self.available:
            raise ReplicaUnavailable(f"replica {self.id} is {self.state.name}")
        kwargs = dict(max_new_tokens=doc.get("max_new_tokens"),
                      temperature=float(doc.get("temperature") or 0.0),
                      eos_token_id=doc.get("eos_token_id"),
                      deadline_s=doc.get("deadline_s"),
                      seed=int(doc.get("seed") or 0),
                      trace_id=trace_id, parent_span_id=parent_span_id,
                      handoff=bool(doc.get("handoff")),
                      park=bool(doc.get("park")),
                      priority=doc.get("priority"),
                      tenant=doc.get("tenant"))
        try:
            if resume:
                self.record_kv_bytes("local", len(doc["payload"]))
                # a resume doc MAY carry a prompt: the rehydrate form (a
                # parked session returning with its next turn)
                req = self.scheduler.submit_resume(doc["payload"],
                                                   prompt=doc.get("prompt"),
                                                   **kwargs)
            else:
                req = self.scheduler.submit(doc["prompt"], **kwargs)
        except AdmissionRejected as e:
            # overload shedding at the replica: backpressure-class (the
            # breaker never eats a 429), with the replica's own Retry-After
            raise ReplicaUnavailable(str(e), status=429,
                                     retry_after_s=e.retry_after_s) from e
        except QueueFullError as e:
            raise ReplicaUnavailable(str(e), status=429) from e
        except SchedulerStopped as e:
            raise ReplicaUnavailable(str(e), status=503) from e
        return _LocalLeg(req)

    def fetch_prefix(self, digests, min_blocks: int = 1,
                     timeout: float = 2.0) -> Optional[bytes]:
        # the short timeout is load-bearing: two LocalReplicas fetching from
        # each other symmetrically would block both scheduler loops; a timed
        # out fetch degrades to a cold prefill on both sides
        try:
            payload = self.scheduler.export_prefix(digests,
                                                   min_blocks=min_blocks,
                                                   timeout=timeout)
        except (SchedulerStopped, TimeoutError):
            return None
        if payload is not None:
            self.record_kv_bytes("local", len(payload))
        return payload

    def steal(self, handle: str, timeout: float = 5.0) -> dict:
        try:
            out = self.scheduler.request_steal(handle, timeout=timeout)
        except (SchedulerStopped, TimeoutError):
            return {"status": "finished"}
        if out.get("status") == "exported":
            self.record_kv_bytes("local", len(out["payload"]))
        return out

    def kill(self, reason: str = "injected fault") -> None:
        """Abrupt replica death (the chaos harness / supervisor test path):
        the scheduler's kill disposition fails every in-flight request with
        the ``replica killed`` marker, KV returns to the pool, the engine
        closes, and the replica leaves rotation as DOWN — exactly what a
        process SIGKILL looks like from the router's side, minus the leaked
        file descriptors."""
        if self.state is ReplicaState.DOWN:
            return
        logger.warning(f"fleet: replica {self.id} killed ({reason})")
        self.state = ReplicaState.DOWN
        self.scheduler.kill(reason)
        self.engine.close()

    def drain(self, timeout: Optional[float] = None) -> None:
        if self.state is ReplicaState.DOWN:
            return
        self.state = ReplicaState.DRAINING  # out of rotation immediately
        self.scheduler.stop(drain=timeout != 0.0, timeout=timeout)
        self.engine.close()
        self.state = ReplicaState.DOWN


# ---------------------------------------------------------------------------
# HTTP upstream replica
# ---------------------------------------------------------------------------
class _HttpLeg(Leg):
    """SSE leg against a ``serving/server.py`` upstream. The upstream is
    always dispatched streaming, so admission status arrives before any
    generation and tokens can be forwarded live; ``result()`` drains the
    stream and returns the final ``done`` doc. Transport failures mid-leg
    (reset, read timeout, truncation) surface as :class:`ReplicaDied`.

    Liveness vs progress: the upstream emits SSE keepalive comments while it
    has no token (queue wait, long prefill), so the per-read budget measures
    process death, never load — but keepalives do NOT reset the *progress*
    clock: ``progress_timeout_s`` (the whole-leg ``timeout_s``) without a
    single new token means a live-but-wedged upstream, also a
    :class:`ReplicaDied`."""

    def __init__(self, conn, resp, replica_id: str,
                 progress_timeout_s: float = 120.0,
                 fetch_handoff=None, account=None):
        self._conn = conn
        self._resp = resp
        self._replica_id = replica_id
        self._progress_timeout_s = progress_timeout_s
        self._last_progress = time.monotonic()
        self._final: Optional[dict] = None
        self._lock = threading.Lock()
        # claim-once fetch for a `handoff_ref` done event (zero-copy return
        # transport: GET /v1/handoff/<ref> -> raw frame) and the replica's
        # per-transport wire-byte accountant
        self._fetch_handoff = fetch_handoff
        self._account = account or (lambda transport, n: None)
        # the upstream surfaces the request handle before streaming: the
        # work-stealing address for this leg
        self.handle = resp.getheader(HANDLE_HEADER)

    def __iter__(self):
        try:
            for line in self._resp:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    # keepalive/blank: proves the process lives, not that the
                    # request progresses
                    if (time.monotonic() - self._last_progress
                            > self._progress_timeout_s):
                        self.cancel()
                        raise ReplicaDied(
                            f"replica {self._replica_id}: no token progress in "
                            f"{self._progress_timeout_s}s (alive but wedged)")
                    continue
                event = json.loads(line[len("data: "):])
                self._last_progress = time.monotonic()
                if event.get("done"):
                    if "handoff" in event:
                        self._account("base64", len(event["handoff"]))
                        event["handoff"] = base64.b64decode(event["handoff"])
                    if isinstance(event.get("park"), str):
                        # a parked-session frame rides the done event base64;
                        # the router's park store wants the raw bytes
                        self._account("base64", len(event["park"]))
                        event["park"] = base64.b64decode(event["park"])
                    elif event.get("handoff_ref") and self._fetch_handoff:
                        # ref'd return transport: the payload never rode the
                        # SSE stream; claim the raw frame out of band
                        raw = self._fetch_handoff(event.pop("handoff_ref"))
                        if raw is None:
                            raise ReplicaDied(
                                f"replica {self._replica_id}: handoff ref "
                                f"unclaimable (upstream restarted?)")
                        self._account("binary", len(raw))
                        event["handoff"] = raw
                    with self._lock:
                        self._final = event
                    return
                yield int(event["token"])
        except (socket.timeout, http.client.HTTPException, OSError) as e:
            raise ReplicaDied(
                f"replica {self._replica_id} stream died mid-leg: "
                f"{type(e).__name__}: {e}") from e

    def result(self, timeout: Optional[float] = None) -> dict:
        with self._lock:
            final = self._final
        if final is None:
            for _ in self:  # drain to the done event
                pass
            with self._lock:
                final = self._final
        if final is None:
            raise ReplicaDied(f"replica {self._replica_id} stream ended "
                              f"without a terminal event")
        _raise_if_killed(final)
        return final

    def cancel(self) -> None:
        # dropping the connection cancels upstream (serving/server.py contract)
        try:
            self._conn.close()
        except Exception:  # pragma: no cover - best effort
            pass


class HttpReplica(Replica):
    """An external ``serving/server.py`` process addressed by base URL.

    ``connect_timeout_s`` bounds TCP establishment (a black-holed upstream),
    ``read_timeout_s`` bounds every subsequent socket read (headers and the
    gap between SSE events); ``timeout_s`` is kept as the legacy whole-leg
    spelling and caps the read budget."""

    def __init__(self, url: str, role: str = "mixed",
                 replica_id: Optional[str] = None, timeout_s: float = 120.0,
                 connect_timeout_s: float = 5.0, read_timeout_s: float = 30.0):
        super().__init__(role=role, replica_id=replica_id)
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = min(read_timeout_s, timeout_s)
        # resume transport memo: binary (raw handoff frame body) until the
        # upstream answers 400 — an older server that only parses JSON — then
        # base64 for this replica's lifetime
        self.binary_transport = True
        split = urllib.parse.urlsplit(self.url)
        self._https = split.scheme == "https"
        self._host, self._port = split.hostname, split.port
        self._base_path = split.path.rstrip("/")  # proxied base-URL prefix

    # ------------------------------------------------------------- transport --
    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 headers: Optional[dict] = None,
                 read_timeout: Optional[float] = None):
        """Open a connection under the connect budget, issue one request,
        return ``(conn, resp)`` with the read budget armed. Connect/send/
        header-read failures are admission-time → :class:`ReplicaUnavailable`
        (the failover + breaker signal)."""
        conn_cls = (http.client.HTTPSConnection if self._https
                    else http.client.HTTPConnection)
        conn = conn_cls(self._host, self._port,
                        timeout=self.connect_timeout_s)
        path = self._base_path + path
        try:
            conn.connect()
        except socket.timeout as e:
            conn.close()
            raise ReplicaUnavailable(
                f"replica {self.id}: connect timeout after "
                f"{self.connect_timeout_s}s", status=0) from e
        except OSError as e:
            conn.close()
            raise ReplicaUnavailable(f"replica {self.id}: {e}", status=0) from e
        try:
            # connected: the per-read budget takes over (SSE gaps, headers)
            conn.sock.settimeout(read_timeout if read_timeout is not None
                                 else self.read_timeout_s)
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
        except socket.timeout as e:
            conn.close()
            raise ReplicaUnavailable(
                f"replica {self.id}: read timeout before response headers",
                status=0) from e
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            raise ReplicaUnavailable(f"replica {self.id}: {e}", status=0) from e
        return conn, resp

    def _get_json(self, path: str, timeout: float) -> dict:
        conn, resp = self._request("GET", path,
                                   read_timeout=min(self.read_timeout_s, timeout))
        try:
            if resp.status != 200:
                raise RuntimeError(f"GET {path} -> HTTP {resp.status}")
            return json.loads(resp.read())
        finally:
            conn.close()

    def _probe(self) -> dict:
        health = self._get_json("/healthz", timeout=5.0)
        stats = self._get_json("/v1/stats", timeout=5.0)
        engine = stats.get("engine", {})
        capacity = engine.get("capacity_blocks") or 0
        free = engine.get("free_blocks") or 0
        doc = {
            "healthy": health.get("status") == "ok" and self.state is ReplicaState.UP,
            "draining": health.get("status") == "draining"
                        or self.state is ReplicaState.DRAINING
                        or bool(stats.get("draining")),
            "starting": health.get("status") == "starting",
            "queue_depth": int(stats.get("queue_depth", 0)),
            "active": int(stats.get("active", {}).get("total", 0)),
            "kv_free_frac": free / capacity if capacity else 1.0,
            "heartbeats": int(stats.get("counters", {}).get("heartbeats", 0)),
        }
        prefix = stats.get("prefix_cache")
        if isinstance(prefix, dict):
            if prefix.get("digests") is not None:
                doc["prefix_digests"] = [str(d) for d in prefix["digests"]]
                doc["prefix_block_size"] = int(prefix.get("block_size") or 0)
            doc["prefix_stats"] = {k: prefix.get(k) for k in
                                   ("lookups", "hits", "hit_rate",
                                    "trie_blocks")}
        if isinstance(stats.get("timeseries"), dict):
            doc["timeseries"] = stats["timeseries"]
        usage = stats.get("usage")
        if isinstance(usage, dict) and usage.get("enabled"):
            doc["usage"] = usage
        return doc

    def collect_spans(self, since_us: int = 0) -> Optional[dict]:
        """Pull the subprocess's span ring over the wire; the caller samples
        its own clock around this call to estimate the offset."""
        return self._get_json(f"/trace/export?since_us={int(since_us)}",
                              timeout=5.0)

    def dispatch(self, doc: dict, resume: bool = False,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[int] = None) -> Leg:
        if not self.available:
            raise ReplicaUnavailable(f"replica {self.id} is {self.state.name}")
        base_headers = {}
        if trace_id is not None:
            base_headers[TRACE_HEADER] = trace_id
        if parent_span_id is not None:
            base_headers[PARENT_SPAN_HEADER] = str(parent_span_id)
        if doc.get("handoff"):
            # negotiate the ref'd return transport: the handoff payload comes
            # back as a claim-once raw frame, not base64 inside the SSE doc
            base_headers[HANDOFF_TRANSPORT_HEADER] = "ref"
        path = "/v1/resume" if resume else "/v1/generate"
        if resume and self.binary_transport:
            # zero-copy resume: the raw handoff frame IS the body; generation
            # params ride a header so the upstream never re-buffers the KV
            params = {k: v for k, v in doc.items() if k != "payload"}
            params["stream"] = True
            headers = dict(base_headers)
            headers["Content-Type"] = HANDOFF_CONTENT_TYPE
            headers[PARAMS_HEADER] = json.dumps(params)
            conn, resp = self._request("POST", path, body=doc["payload"],
                                       headers=headers)
            if resp.status == 400:
                # an upstream that can't parse the frame as a body is running
                # the JSON-only protocol: remember, fall through to base64
                logger.warning(f"fleet: replica {self.id} rejected binary "
                               f"resume transport; falling back to base64")
                self.binary_transport = False
                try:
                    resp.read()
                except Exception:  # pragma: no cover - best effort
                    pass
                conn.close()
            else:
                self.record_kv_bytes("binary", len(doc["payload"]))
                return self._leg_or_raise(conn, resp)
        body = dict(doc)
        body["stream"] = True  # SSE upstream: early admission status, live tokens
        if resume:
            encoded = base64.b64encode(doc["payload"]).decode()
            self.record_kv_bytes("base64", len(encoded))
            body["payload"] = encoded
        headers = dict(base_headers)
        headers["Content-Type"] = "application/json"
        conn, resp = self._request("POST", path, body=json.dumps(body).encode(),
                                   headers=headers)
        return self._leg_or_raise(conn, resp)

    def _leg_or_raise(self, conn, resp) -> Leg:
        """Map a dispatch response to a live leg or the failure taxonomy."""
        if resp.status != 200:
            detail = ""
            try:
                detail = json.loads(resp.read()).get("error", "")
            except Exception:
                pass
            retry_after = None
            try:
                header = resp.getheader("Retry-After")
                retry_after = float(header) if header else None
            except (TypeError, ValueError):  # pragma: no cover - defensive
                pass
            conn.close()
            if resp.status in (429, 503):
                raise ReplicaUnavailable(
                    f"replica {self.id}: HTTP {resp.status} {detail}",
                    status=resp.status, retry_after_s=retry_after)
            raise ValueError(f"replica {self.id}: HTTP {resp.status} {detail}")
        return _HttpLeg(conn, resp, self.id, progress_timeout_s=self.timeout_s,
                        fetch_handoff=self._claim_handoff,
                        account=self.record_kv_bytes)

    def _claim_handoff(self, ref: str) -> Optional[bytes]:
        """Claim a stashed handoff frame (``GET /v1/handoff/<ref>``): the
        zero-copy return leg of the ref'd transport. Claim-once upstream —
        None means the ref is gone (restart, double claim)."""
        try:
            conn, resp = self._request("GET", f"/v1/handoff/{ref}")
        except ReplicaUnavailable:
            return None
        try:
            if resp.status != 200:
                return None
            return resp.read()
        except (socket.timeout, http.client.HTTPException, OSError):
            return None
        finally:
            conn.close()

    def fetch_prefix(self, digests, min_blocks: int = 1,
                     timeout: float = 2.0) -> Optional[bytes]:
        body = json.dumps({"digests": [d.hex() if isinstance(d, (bytes, bytearray))
                                       else str(d) for d in digests],
                           "min_blocks": int(min_blocks)}).encode()
        try:
            conn, resp = self._request(
                "POST", "/v1/prefix/export", body=body,
                headers={"Content-Type": "application/json"},
                read_timeout=min(self.read_timeout_s, timeout))
        except ReplicaUnavailable:
            return None  # an unreachable donor is just a cold prefill
        try:
            if resp.status != 200:
                return None
            payload = resp.read()
        except (socket.timeout, http.client.HTTPException, OSError):
            return None
        finally:
            conn.close()
        self.record_kv_bytes("binary", len(payload))
        return payload

    def steal(self, handle: str, timeout: float = 5.0) -> dict:
        body = json.dumps({"handle": handle}).encode()
        try:
            conn, resp = self._request(
                "POST", "/v1/steal", body=body,
                headers={"Content-Type": "application/json"},
                read_timeout=min(self.read_timeout_s, timeout))
        except ReplicaUnavailable:
            # can't reach the victim: assume it still owns the leg
            return {"status": "finished"}
        try:
            if resp.status != 200:
                return {"status": "finished"}
            ctype = resp.getheader("Content-Type") or ""
            if ctype.startswith(HANDOFF_CONTENT_TYPE):
                payload = resp.read()
                sent = int(resp.getheader(STEAL_SENT_HEADER) or 0)
                self.record_kv_bytes("binary", len(payload))
                return {"status": "exported", "payload": payload, "sent": sent}
            out = json.loads(resp.read())
            return out if isinstance(out, dict) else {"status": "finished"}
        except (socket.timeout, http.client.HTTPException, OSError,
                ValueError):
            return {"status": "finished"}
        finally:
            conn.close()

    def drain(self, timeout: Optional[float] = None) -> None:
        # the upstream process is not ours to stop: drain = leave rotation
        # for good (its own operator runs server.stop()). DOWN, not DRAINING —
        # a permanently-DRAINING replica would count as live capacity in the
        # fleet_replicas gauge and /v1/fleet/stats forever
        if self.state is not ReplicaState.DOWN:
            logger.info(f"fleet: upstream replica {self.id} out of rotation")
            self.state = ReplicaState.DOWN
