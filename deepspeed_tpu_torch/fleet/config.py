"""Fleet config blocks.

The fleet layer runs N ``(InferenceEngineV2 + ServingScheduler +
ServingServer)`` replicas behind one router; these knobs size the router's
dispatch behavior and the autoscaler's policy loop. Validated pydantic-style
like the other config blocks (``serving/config.py``, ``telemetry/config.py``).

Port of ``deepspeed_tpu/fleet/config.py`` as dataclasses on
``runtime/config_utils.py`` (the reference's blocks are pydantic models), with
the same fields, defaults and bounds; nested blocks may be given as dicts.
"""

import typing
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

from deepspeed_tpu_torch.fleet.breaker import BreakerConfig
from deepspeed_tpu_torch.fleet.faults import FaultConfig
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.serving.config import (DEFAULT_MAX_RESUME_BODY_BYTES,
                                                OverloadConfig, PrefixCacheConfig,
                                                SpeculativeConfig)

ReplicaRole = Literal["mixed", "prefill", "decode"]
"""``mixed`` serves whole requests; ``prefill``/``decode`` replicas form the
disaggregated pools — a request prefills (plus first token) on a prefill-role
replica, then its KV hands off to a decode-role replica for the rest."""


@dataclass
class GlobalQueueConfig(DeepSpeedConfigModel):
    """Router global queue (``fleet/global_queue.py``): queued work lives at
    the router in priority/deadline order and replicas pull it when they have
    a free dispatch slot (ROADMAP 3c, first half)."""

    enabled: bool = True
    """False = the pre-queue blind least-loaded push dispatch (the control
    arm the overload gates compare against)."""

    capacity: int = config_field(256, ge=1)
    """Queue entries beyond which admission answers 429 + ``Retry-After``."""

    max_inflight_per_replica: int = config_field(32, ge=1)
    """Concurrently granted legs per replica (continuous batching happily
    runs several; the cap keeps a burst from piling onto one replica)."""

    acquire_timeout_s: float = config_field(30.0, gt=0)
    """Queue-wait bound for requests without a deadline (deadline'd requests
    expire at their own deadline, whichever is sooner)."""

    retry_after_floor_s: float = config_field(0.5, gt=0)
    retry_after_cap_s: float = config_field(30.0, gt=0)
    """Bounds on the grant-rate-derived ``Retry-After`` estimate."""


@dataclass
class HedgeConfig(DeepSpeedConfigModel):
    """Hedged dispatch (``fleet/router.py``): a request whose next token
    hasn't arrived within the TTFT budget — before the first token OR
    mid-stream (greedy/seeded legs are token-identical, so a hedge can
    replay and skip the already-streamed prefix) — is dispatched again on a
    second replica; the first leg past the prefix wins, the loser is
    cancelled (KV freed). Off by default — hedging doubles worst-case
    dispatch cost by design."""

    enabled: bool = False

    ttft_budget_s: Optional[float] = config_field(None, gt=0)
    """Fixed TTFT budget before hedging; None = derive from the router's
    observed TTFT p95 (``budget_factor`` × p95)."""

    budget_factor: float = config_field(1.5, gt=0)
    """Multiplier on the observed TTFT p95 when deriving the budget."""

    min_samples: int = config_field(8, ge=1)
    """TTFT samples before the p95 derivation is trusted;
    ``default_budget_s`` applies until then."""

    default_budget_s: float = config_field(1.0, gt=0)
    """Cold-start TTFT budget."""

    deadline_frac: float = config_field(0.5, gt=0, le=1)
    """Cap the per-token hedge wait at this fraction of the request's
    remaining deadline (deadline'd requests only): a cold-start default
    budget must not eat the whole deadline before a hedge can still win."""

    min_budget_s: float = config_field(0.25, gt=0)
    """Floor under the p95-derived budget: a lightly-loaded fleet's tiny
    TTFT p95 must not arm a hair-trigger the first burst then trips (and
    the floor bounds how often a waiting request wakes to re-evaluate)."""

    max_hedge_frac: float = config_field(0.1, ge=0, le=1)
    """Storm brake: speculative hedges (budget expired but the slow replica
    is NOT demotion-grade slow vs its peers) are token-bucket limited to
    this fraction of admitted requests. Evidence-driven hedges — the
    current replica's TTFT EWMA is demotion-grade — bypass the brake:
    fleet-wide contention inflates every EWMA together and never looks
    like evidence, so a storm cannot feed itself; a single stalled
    replica does, so its victims are always rescued."""

    interactive_only: bool = True
    """Hedge only interactive-class requests (batch latency is nobody's
    p99); False hedges everything eligible."""

    slow_demote_factor: float = config_field(3.0, gt=1)
    """A replica whose TTFT EWMA exceeds this multiple of the candidate
    median is demoted — picked only when nothing faster has capacity. The
    latency-shaped sibling of the failure-shaped circuit breaker."""


@dataclass
class CacheRouteConfig(DeepSpeedConfigModel):
    """Cache-aware placement (``fleet/router.py``): replicas publish a digest
    catalog of their prefix-cache trie in the probe doc; the router hashes
    the request's block-aligned prefix chain at admission and dispatches to
    the replica holding the longest cached prefix. Staleness is bounded by
    ``FleetConfig.probe_ttl_s`` — a stale hint costs one misrouted dispatch
    that then misses locally, never correctness."""

    enabled: bool = True
    """False = ignore published digests (rendezvous/least-loaded only; the
    hash-routing control arm of the routing A/B gate)."""

    peer_fetch: bool = True
    """On a local trie miss where a peer's catalog matches the request chain
    deeper, fetch those KV blocks from the peer over the handoff frame
    instead of recomputing them (``POST /v1/prefix/export``). CRC-covered:
    a corrupt frame is rejected loudly and the prefill recomputes cold."""

    fetch_timeout_s: float = config_field(2.0, gt=0)
    """Budget for one peer prefix fetch. Deliberately short: two in-process
    replicas fetching from each other symmetrically would block both
    scheduler loops; timing out degrades both sides to a cold prefill."""

    min_match_blocks: int = config_field(1, ge=1)
    """Smallest digest-chain match (in blocks) that steers placement or
    justifies a peer fetch; shorter matches are noise."""


@dataclass
class StealConfig(DeepSpeedConfigModel):
    """Cross-replica work stealing (``fleet/router.py``): a request that has
    produced no token within the wait budget on a hot replica — still queued,
    or early in decode — is claimed back (``POST /v1/steal``), exported
    token-identically when mid-decode, and re-dispatched to a colder replica.
    The hedged-dispatch shape moving work instead of duplicating it.
    Off by default: stealing adds a dispatch round-trip by design."""

    enabled: bool = False

    wait_budget_s: float = config_field(0.5, gt=0)
    """No-first-token budget before the router considers stealing the leg."""

    min_deadline_headroom_s: float = config_field(2.0, ge=0)
    """Only steal a request whose remaining deadline exceeds this (or that
    carries no deadline): a steal costs a round-trip plus a re-dispatch, so
    tight-deadline requests are left to the hedging machinery."""

    load_ratio: float = config_field(2.0, gt=1)
    """The victim's probe load must exceed the target's by this factor for
    the move to count as hot→cold; symmetric load never triggers a steal."""


@dataclass
class ParkConfig(DeepSpeedConfigModel):
    """Fleet-parked sessions (``fleet/park_store.py``): a finished-but-
    continuable session's KV exports as a v2 park frame at the replica and
    banks at the router under its session key; the session's next turn — a
    generate whose prompt strictly extends the parked history — rehydrates on
    ANY replica via an internal resume-with-prompt leg, prefilling only the
    new suffix. The serving-layer end of the same ladder is
    ``ServingConfig.kv_tiers`` (device→host→disk); parking is the fleet-global
    fourth rung. Off by default: parking exports KV at every session finish."""

    enabled: bool = False

    max_sessions: int = config_field(256, ge=1)
    """Parked-session cap; beyond it the coldest (LRU) session drops."""

    max_bytes: int = config_field(256 << 20, ge=1)
    """Byte budget across all parked frames (a park frame is a KV-block dump:
    kilobytes for a test model, hundreds of megabytes for a real one)."""

    ttl_s: float = config_field(600.0, ge=0)
    """Seconds a parked session survives untouched; 0 = no expiry. A dropped
    park costs the returning turn a cold prefill, never correctness."""


@dataclass
class AutoscaleConfig(DeepSpeedConfigModel):
    """Policy knobs for :class:`deepspeed_tpu_torch.fleet.policy.FleetAutoscaler`."""

    enabled: bool = False
    """Run the policy loop (``FleetAutoscaler.start()``); disabled = manual
    ``step()`` only (tests, external control loops)."""

    interval_s: float = config_field(1.0, gt=0)
    """Seconds between policy observations."""

    min_replicas: int = config_field(1, ge=1)
    """Never drain below this many replicas (per managed role)."""

    max_replicas: int = config_field(8, ge=1)
    """Never grow beyond this many replicas (per managed role)."""

    role: ReplicaRole = "mixed"
    """Which pool the autoscaler grows and shrinks (one autoscaler per role;
    run several for disaggregated fleets)."""

    scale_up_queue_depth: float = config_field(4.0, ge=0)
    """Mean queued-requests-per-replica above which the pool is considered
    saturated."""

    scale_up_kv_pressure: float = config_field(0.9, ge=0, le=1)
    """Mean KV-pool occupancy (1 - free/capacity) above which the pool is
    considered saturated."""

    sustain_ticks: int = config_field(3, ge=1)
    """Consecutive saturated observations before a scale-up fires (guards
    against reacting to a transient burst)."""

    scale_down_idle_ticks: int = config_field(10, ge=1)
    """Consecutive fully-idle observations (zero queued, zero in-flight,
    pressure below the threshold) before one replica is drained."""

    slo_scale_up: bool = False
    """Treat an open SLO breach episode (``telemetry.slo`` engine,
    fast+slow burn over threshold) as a saturated observation — and veto
    scale-down while it is open. Requires an active telemetry session with
    SLOs configured; off by default."""


@dataclass
class SupervisorConfig(DeepSpeedConfigModel):
    """Knobs for :class:`deepspeed_tpu_torch.fleet.supervisor.ReplicaSupervisor`."""

    poll_interval_s: float = config_field(0.25, gt=0)
    """Monitor-loop cadence: exit/hang checks and restart scheduling."""

    ready_timeout_s: float = config_field(120.0, gt=0)
    """How long a freshly-spawned replica gets to answer a healthy probe
    before the launch counts as a crash (registration is gated on readiness —
    an unready replica is never dispatched to)."""

    probe_hang_failures: int = config_field(4, ge=1)
    """Consecutive failed liveness probes of a READY replica before it is
    declared hung, killed, and restarted (exits are detected immediately;
    this catches the wedged-but-alive case)."""

    restart_backoff_base_s: float = config_field(0.5, ge=0)
    restart_backoff_multiplier: float = config_field(2.0, ge=1)
    restart_backoff_cap_s: float = config_field(30.0, gt=0)
    restart_jitter_frac: float = config_field(0.1, ge=0, le=1)
    """Exponential restart backoff (shared ``breaker.backoff_delay`` formula):
    crash *k* in the crash window waits ``base * multiplier**(k-1)`` (capped,
    ± jitter) before respawning."""

    max_crashes: int = config_field(3, ge=1)
    """Crash-loop budget: this many crashes within ``crash_window_s``
    quarantines the slot — no further respawns until ``reset()`` — instead of
    silently burning CPU on a persistent crasher forever."""

    crash_window_s: float = config_field(60.0, gt=0)
    """Sliding window for the crash-loop budget (also the backoff exponent's
    memory: crashes aging out of the window reset the schedule)."""

    seed: int = 0
    """Restart-jitter determinism (chaos runs replay the same schedule)."""


@dataclass
class FleetConfig(DeepSpeedConfigModel):
    """Knobs for the replica manager + front-end router."""

    host: str = "127.0.0.1"
    port: int = config_field(0, ge=0, le=65535)
    """Router bind address; port 0 = ephemeral (read ``router.url`` after
    ``start()``)."""

    affinity_header: str = "X-DSTPU-Session"
    """Request header (or JSON ``session`` field) carrying the session key for
    rendezvous-hash affinity; absent = least-loaded dispatch."""

    default_max_new_tokens: int = config_field(64, ge=1)
    """Generation budget when the request doesn't say — the router must know
    the total to split a disaggregated request into prefill-plus-first-token
    and decode-the-rest legs (matches ``ServingConfig.default_max_new_tokens``
    so routed and direct requests behave alike)."""

    probe_ttl_s: float = config_field(0.25, ge=0)
    """How long a replica's health/load probe is trusted before the router
    re-probes; 0 = probe on every dispatch (tests)."""

    request_timeout_s: float = config_field(120.0, gt=0)
    """Whole-leg upstream budget (a replica that blocks longer fails over or
    errors the client request)."""

    connect_timeout_s: float = config_field(5.0, gt=0)
    """Upstream TCP-connect budget, separate from the read budget: a
    black-holed upstream costs a dispatch thread this much, not the full
    ``request_timeout_s``."""

    read_timeout_s: float = config_field(30.0, gt=0)
    """Per-read upstream budget (headers, and the gap between SSE events): a
    replica that stops producing bytes mid-leg dies as a
    :class:`~deepspeed_tpu_torch.fleet.replica.ReplicaDied` — a breaker signal —
    within this bound."""

    max_attempts: int = config_field(3, ge=1)
    """Dispatch attempts per request leg: a 503/429/connection error excludes
    the replica and retries on the next candidate, up to this bound (and never
    more than the pool size)."""

    retry_backoff_base_s: float = config_field(0.02, ge=0)
    retry_backoff_cap_s: float = config_field(0.5, gt=0)
    retry_jitter_frac: float = config_field(0.25, ge=0, le=1)
    """Bounded-jitter backoff between failover attempts of one leg (the
    shared ``breaker.backoff_delay`` policy; 0 base = retry immediately —
    the deterministic test formulation). Failed *probes* reuse the same
    formula at probe scale: a replica whose probe raised is not re-probed
    before an exponentially-growing fraction of ``probe_backoff_cap_s``."""

    probe_backoff_cap_s: float = config_field(10.0, gt=0)
    """Cap on the failed-probe re-probe backoff."""

    drain_timeout_s: float = config_field(30.0, ge=0)
    """Per-replica graceful-drain budget (in-flight requests get this long to
    finish before being cancelled)."""

    max_resume_body_bytes: int = config_field(DEFAULT_MAX_RESUME_BODY_BYTES, gt=0)
    """Upper bound on a client ``POST /v1/resume`` body at the router (the
    base64 KV-handoff payload; fully buffered per handler thread — see
    ``ServingConfig.max_resume_body_bytes``)."""

    prefix_cache: PrefixCacheConfig = config_field(default_factory=PrefixCacheConfig)
    """Automatic prefix caching applied to fleet-built local replicas
    (``serving/config.PrefixCacheConfig``). When ``enabled``, this block is
    authoritative for the roles in ``prefix_cache_roles`` and the cache is
    forced OFF for the others — the disaggregated shape: the prefill pool
    reuses shared prompts, the decode pool (which only ever imports handed-off
    KV) carries no trie. Disabled (default) = replicas keep whatever their own
    ``ServingConfig.prefix_cache`` says."""

    prefix_cache_roles: Tuple[ReplicaRole, ...] = ("mixed", "prefill")
    """Replica roles that receive ``prefix_cache`` when it is enabled."""

    speculative: Optional[SpeculativeConfig] = None
    """Speculative decoding applied to fleet-built local replicas
    (``serving/config.SpeculativeConfig``). When set, this block is
    authoritative for the roles in ``speculative_roles`` and drafting is
    forced OFF for the others; None = replicas keep whatever their own
    ``ServingConfig.speculative`` says. Trie-backed drafting is a
    prefill/mixed-role concern (those pools carry the prefix-cache trie);
    decode-role replicas self-draft from the request's own history, with the
    acceptance EWMA riding the prefill→decode handoff payload so adaptation
    survives the migration. With ``drafter`` set to ``learned``/``auto`` the
    block's tree budgets and ``draft_head_path`` flow to the listed roles
    verbatim; the handoff additionally carries the per-drafter EWMAs and the
    draft-head id, and a recipient whose heads differ drops only the learned
    EWMA (re-explored cold) while keeping the rest of the drafter state."""

    speculative_roles: Tuple[ReplicaRole, ...] = ("mixed", "decode")
    """Replica roles that receive ``speculative`` when it is set. Prefill
    replicas are excluded by default — they generate exactly one token per
    request, so there is no decode loop to speed up."""

    global_queue: GlobalQueueConfig = config_field(default_factory=GlobalQueueConfig)
    """Router global queue + pull dispatch (``fleet/global_queue.py``)."""

    hedge: HedgeConfig = config_field(default_factory=HedgeConfig)
    """Hedged dispatch against slow-but-alive replicas."""

    cache_route: CacheRouteConfig = config_field(default_factory=CacheRouteConfig)
    """Cache-aware placement over the replicas' published digest catalogs,
    plus cross-replica prefix-KV fetch; see :class:`CacheRouteConfig`."""

    steal: StealConfig = config_field(default_factory=StealConfig)
    """Cross-replica work stealing; see :class:`StealConfig`."""

    park: ParkConfig = config_field(default_factory=ParkConfig)
    """Fleet-parked sessions that rehydrate on any replica; see
    :class:`ParkConfig`."""

    kv_transport: Literal["binary", "base64"] = "binary"
    """Preferred resume/handoff wire transport toward HTTP replicas:
    ``binary`` streams the raw handoff frame (O(memcpy), auto-falls back per
    replica when an upstream only speaks JSON); ``base64`` forces the legacy
    JSON envelope everywhere (the zero-copy gate's control arm)."""

    overload: Optional[OverloadConfig] = None
    """Serving-layer overload control (``serving/config.OverloadConfig``)
    applied to every fleet-built local replica when set; None = each
    replica keeps whatever its own ``ServingConfig.overload`` says."""

    autoscale: AutoscaleConfig = config_field(default_factory=AutoscaleConfig)
    """Elastic scaling policy (``fleet/policy.py``)."""

    breaker: BreakerConfig = config_field(default_factory=BreakerConfig)
    """Per-replica circuit breaker (``fleet/breaker.py``); every registered
    replica gets one, fed by probe failures and dispatch refusals."""

    supervisor: SupervisorConfig = config_field(default_factory=SupervisorConfig)
    """Replica process supervision (``fleet/supervisor.py``)."""

    faults: FaultConfig = config_field(default_factory=FaultConfig)
    """Deterministic fault injection (``fleet/faults.py``); disabled by
    default — the ``DSTPU_FAULTS`` env var (JSON ``FaultConfig`` body) can
    arm it without touching code."""

    def __post_init__(self):
        super().__post_init__()
        roles = typing.get_args(ReplicaRole)
        for name in ("prefix_cache_roles", "speculative_roles"):
            bad = [r for r in getattr(self, name) if r not in roles]
            if bad:
                raise ValueError(f"FleetConfig.{name}: {bad} not in {roles}")
