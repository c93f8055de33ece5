"""Serving config block.

Port of ``deepspeed_tpu/serving/config.py`` as dataclasses on
``runtime/config_utils.py`` (the reference's blocks are pydantic models), with
the same fields, defaults, bounds and validator messages.

The prefix cache, speculative decoding and KV tiers are ROADMAP A5, so the
port's scheduler refuses ``prefix_cache.enabled``, ``speculative.enabled``
and ``kv_tiers.enabled`` (``serving/scheduler.py``). ``CostConfig`` is on by
default, as in the reference, but its ledger exists only while a telemetry
session is active, and that combination is refused too (A5 ports
``telemetry/ledger.py``).
"""

import dataclasses
from dataclasses import dataclass
from typing import Dict, Literal, Optional, Tuple

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field

DEFAULT_MAX_RESUME_BODY_BYTES = 2 << 30
"""One authority for the ``/v1/resume`` body bound — shared by
``ServingConfig`` and ``serving/server.py``."""


@dataclass
class PrefixCacheConfig(DeepSpeedConfigModel):
    """Automatic prefix caching (radix-tree KV reuse). ROADMAP A5: the port's
    scheduler refuses ``enabled``."""

    enabled: bool = False
    max_blocks: Optional[int] = config_field(None, ge=1)
    min_prefix_blocks: int = config_field(1, ge=1)
    digest_catalog_limit: int = config_field(64, ge=0)


@dataclass
class SpeculativeConfig(DeepSpeedConfigModel):
    """Speculative decoding (``inference/v2/spec/``). ROADMAP A5: the port's
    scheduler refuses ``enabled``."""

    enabled: bool = False
    drafter: Literal["prompt_lookup", "learned", "auto"] = "prompt_lookup"
    max_draft_tokens: int = config_field(4, ge=1)
    num_draft_heads: int = config_field(3, ge=1, le=8)
    tree_width: int = config_field(2, ge=1)
    tree_node_budget: int = config_field(8, ge=2)
    draft_head_path: Optional[str] = None
    min_ngram: int = config_field(1, ge=1)
    max_ngram: int = config_field(3, ge=1)
    accept_alpha: float = config_field(0.5, gt=0, le=1)
    probe_interval: int = config_field(16, ge=1)
    draft_token_budget: Optional[int] = config_field(None, ge=1)

    def __post_init__(self):
        super().__post_init__()
        if self.max_ngram < self.min_ngram:
            raise ValueError("max_ngram must be >= min_ngram")

    @classmethod
    def from_dict(cls, data: dict):
        # the base drops "auto"-valued keys so defaults apply, but "auto" is a
        # real drafter mode here: route it around the filter
        data = dict(data)
        drafter = data.pop("drafter", None)
        cfg = super().from_dict(data)
        if drafter is not None:
            cfg = dataclasses.replace(cfg, drafter=drafter)
        return cfg


@dataclass
class KVTierConfig(DeepSpeedConfigModel):
    """Tiered KV memory (device → host → disk demotion under pressure).
    ROADMAP A5: the port's scheduler refuses ``enabled``."""

    enabled: bool = False
    host_bytes: Optional[int] = config_field(None, ge=0)
    spill_dir: Optional[str] = None
    demote_batch: int = config_field(4, ge=1)


@dataclass
class OverloadConfig(DeepSpeedConfigModel):
    """Overload control (``serving/overload.py``): priority admission,
    deadline-aware shedding and staged brownout degradation. Enabled by
    default but quiescent under normal load — admission control only acts on
    requests that carry a deadline, and the brownout stages only engage when
    the smoothed pressure signal clears the thresholds."""

    enabled: bool = True
    """Master switch. False = FIFO queue order, no admission estimate, no
    shedding, no brownout."""

    priority_ordering: bool = True
    """Admit queued requests in (priority, deadline, arrival) order instead
    of FIFO; within a class, earliest deadline first."""

    admission_control: bool = True
    """Estimate queue wait from the measured token rate at ``submit()`` and
    reject a request whose deadline is provably unmeetable (HTTP 429 +
    ``Retry-After``)."""

    admission_margin: float = config_field(1.0, gt=0)
    """A request is rejected when the estimated completion time exceeds
    ``deadline * margin``."""

    min_rate_samples: int = config_field(4, ge=1)
    """Executed batches the rate estimator needs before admission control or
    shedding trusts it; a cold estimator admits everything."""

    rate_alpha: float = config_field(0.25, gt=0, le=1)
    """EWMA smoothing factor for the measured token rate."""

    shed_enabled: bool = True
    """Under sustained pressure (brownout stage >= 1), shed queued requests
    whose deadline is provably unmeetable — lowest priority / latest deadline
    first."""

    brownout_stage_thresholds: Tuple[float, float, float] = (0.65, 0.85, 0.95)
    """Smoothed-pressure entry thresholds for brownout stages 1..3 (stage 1:
    clamp batch ``max_new_tokens``; stage 2: + disable chunked decode;
    stage 3: + reject batch class at submission)."""

    brownout_hysteresis: float = config_field(0.1, ge=0)
    """A stage entered at threshold ``t`` is only left when the smoothed
    pressure falls below ``t - hysteresis``."""

    pressure_alpha: float = config_field(0.3, gt=0, le=1)
    """EWMA smoothing factor for the pressure signal
    (``max(queue_fraction, kv_occupancy)``, sampled every scheduler tick)."""

    brownout_clamp_max_new_tokens: int = config_field(16, ge=1)
    """Stage >= 1 generation cap for batch-class requests (flagged
    ``degraded_mode`` in the response)."""

    retry_after_floor_s: float = config_field(0.5, gt=0)
    retry_after_cap_s: float = config_field(30.0, gt=0)
    """Bounds on the ``Retry-After`` estimate derived from the measured queue
    drain rate (429/503 responses)."""

    slo_pressure: bool = False
    """Feed the SLO engine's breach signal into the pressure sample. The SLO
    engine is ROADMAP A6: the port's scheduler refuses it."""

    fair_share_enabled: bool = False
    """Tenant fair-share stage in the admission path (opt-in): under
    pressure, a tenant over ``fair_share_over_factor`` x its configured share
    is shed first."""

    fair_share_shares: Optional[Dict[str, float]] = None
    """Per-tenant share weights; None = equal split across every tenant that
    has submitted."""

    fair_share_alpha: float = config_field(0.2, gt=0, le=1)
    """EWMA smoothing for per-tenant measured token rates."""

    fair_share_over_factor: float = config_field(1.25, gt=1)
    """A tenant is over-share when measured share > factor x configured
    share."""

    fair_share_hysteresis: float = config_field(0.25, ge=0)
    """The over-share verdict clears only below
    ``(over_factor - hysteresis) x configured share``."""

    def __post_init__(self):
        super().__post_init__()
        if list(self.brownout_stage_thresholds) != sorted(self.brownout_stage_thresholds):
            raise ValueError("brownout_stage_thresholds must be ascending")


@dataclass
class CostConfig(DeepSpeedConfigModel):
    """Cost-attribution plane (``telemetry/ledger.py``). ROADMAP A5: the ledger
    materializes only while a telemetry session is active, and the port's
    scheduler refuses ``enabled`` with a session active."""

    enabled: bool = True
    default_tenant: str = "default"
    """Tenant billed for requests that carry no identity (no ``tenant`` JSON
    field, no ``X-DSTPU-Tenant`` header)."""
    max_tenants: int = config_field(64, ge=1)
    tenant_metric_top_k: int = config_field(8, ge=1)
    perf_chip: str = "v5e"
    perf_drift_factor: float = config_field(4.0, gt=1)
    perf_drift_consecutive: int = config_field(3, ge=1)
    perf_baseline_dispatches: int = config_field(8, ge=1)


@dataclass
class ServingConfig(DeepSpeedConfigModel):
    """Knobs for the request scheduler + HTTP front-end."""

    queue_capacity: int = config_field(128, ge=1)
    """Maximum QUEUED (admitted-but-unscheduled) requests; beyond it the
    backpressure policy applies."""

    backpressure: Literal["reject", "block"] = "reject"
    """Queue-full behavior: ``reject`` fails ``submit()`` immediately (HTTP
    429); ``block`` stalls the submitting thread until space frees."""

    default_max_new_tokens: int = config_field(64, ge=1)
    """Per-request cap when the request doesn't specify one."""

    default_deadline_s: Optional[float] = config_field(None, gt=0)
    """Deadline applied to requests that don't carry their own; None = no
    deadline."""

    drain_timeout_s: float = config_field(30.0, ge=0)
    """Graceful-shutdown budget: how long ``stop(drain=True)`` lets in-flight
    requests finish before cancelling the remainder."""

    scheduler_tick_s: float = config_field(0.001, gt=0)
    """Idle sleep between scheduler iterations when there is no work; busy
    iterations run back-to-back."""

    decode_chunk: int = config_field(1, ge=1)
    """Decode steps per device dispatch on the decode-only fast path
    (``engine.decode_loop``); >1 trades up-to-(K-1)-token over-generation for
    one host round-trip per K tokens."""

    max_prefill_chunk: Optional[int] = config_field(None, ge=1)
    """Cap on prompt tokens admitted per batch per request (Dynamic SplitFuse
    chunk size); None = bounded only by the engine's ragged token budget."""

    heartbeat_interval_s: float = config_field(0.05, ge=0)
    """How often an *idle* scheduler runs ``engine.empty_run()``. 0 = every
    idle tick."""

    heartbeat_enabled: Optional[bool] = None
    """None = auto (heartbeat only when the engine has expert parallelism
    enabled); True/False force it."""

    sse_keepalive_s: float = config_field(10.0, gt=0)
    """SSE comment-line cadence while a stream has no token to send."""

    host: str = "127.0.0.1"
    port: int = config_field(0, ge=0, le=65535)
    """Bind address for ``ServingServer``; port 0 = ephemeral."""

    prefix_cache: PrefixCacheConfig = config_field(default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = config_field(default_factory=SpeculativeConfig)
    overload: OverloadConfig = config_field(default_factory=OverloadConfig)
    kv_tiers: KVTierConfig = config_field(default_factory=KVTierConfig)
    cost: CostConfig = config_field(default_factory=CostConfig)

    max_resume_body_bytes: int = config_field(DEFAULT_MAX_RESUME_BODY_BYTES, gt=0)
    """Upper bound on a ``POST /v1/resume`` body (the route is ROADMAP A5)."""

    def __post_init__(self):
        v = self.default_deadline_s
        if v is not None and not (v > 0 and v == v):  # rejects NaN too
            raise ValueError("default_deadline_s must be a positive number")
        super().__post_init__()
