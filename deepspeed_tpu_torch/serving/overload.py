"""Overload-control primitives for the serving layer.

Port of ``deepspeed_tpu/serving/overload.py`` (host Python, copied as is).

Three small, engine-free pieces the scheduler composes (``serving/scheduler.py``)
— kept separate so the policy math is unit-testable without an engine:

- **priority classes**: every request carries one of :data:`PRIORITIES`
  (``interactive`` beats ``batch`` at every decision point: queue order,
  brownout clamping, stage-3 rejection, router hedging);
- :class:`RateEstimator` — an EWMA of the engine's *measured* token
  commit rate (prefill + decode lumped), the denominator for every
  queue-wait / deadline-feasibility estimate. Warmup-gated: admission
  control never rejects on a cold estimator;
- :class:`BrownoutController` — hysteresis-smoothed pressure (queue depth
  fraction vs KV occupancy, whichever is worse) mapped to staged
  degradation levels. Stages only move one way per update and re-arm below
  ``threshold - hysteresis``, so a noisy pressure signal cannot flap the
  fleet between degraded and normal service.

The stages (enforced by the scheduler, each counted and flagged in the
response ``degraded_mode`` — never silent):

- **0** normal service;
- **1** clamp ``max_new_tokens`` for batch-class requests;
- **2** additionally disable speculative extras (chunked ``decode_loop``
  dispatch falls back to one token per step);
- **3** additionally reject batch-class requests outright at submission
  (HTTP 429 + ``Retry-After``).
"""

import time
from typing import Optional, Sequence

PRIORITIES = ("interactive", "batch")
"""Priority classes, best first. ``interactive`` is the default: existing
clients that never heard of priorities keep first-class service."""

DEFAULT_PRIORITY = "interactive"


def priority_rank(priority: str) -> int:
    """Queue-ordering rank (lower schedules first)."""
    return PRIORITIES.index(priority)


def validate_priority(priority: Optional[str]) -> str:
    """Normalize/validate a wire-level priority field (None = default)."""
    if priority is None:
        return DEFAULT_PRIORITY
    if priority not in PRIORITIES:
        raise ValueError(f"unknown priority {priority!r} (know {PRIORITIES})")
    return priority


class RateEstimator:
    """EWMA of observed token throughput (tokens/s).

    ``observe(n)`` is called once per executed batch with the tokens it
    committed; the instantaneous rate is ``n / dt`` against the previous
    observation. ``rate`` is None until ``min_samples`` observations have
    landed — callers treat a cold estimator as "cannot prove anything"
    (admission control admits, shedding stands down).
    """

    def __init__(self, alpha: float = 0.25, min_samples: int = 4):
        self._alpha = alpha
        self._min_samples = min_samples
        self._ewma: Optional[float] = None
        self._samples = 0
        self._last_s: Optional[float] = None

    def observe(self, n_tokens: int, now: Optional[float] = None) -> None:
        if n_tokens <= 0:
            return
        now = time.monotonic() if now is None else now
        if self._last_s is None:
            self._last_s = now
            return  # first batch: no interval yet
        dt = now - self._last_s
        self._last_s = now
        if dt <= 0:
            return
        inst = n_tokens / dt
        self._ewma = (inst if self._ewma is None
                      else (1 - self._alpha) * self._ewma + self._alpha * inst)
        self._samples += 1

    @property
    def warm(self) -> bool:
        return self._ewma is not None and self._samples >= self._min_samples

    @property
    def rate(self) -> Optional[float]:
        """Tokens/s, or None while cold."""
        return self._ewma if self.warm else None

    def seconds_for(self, n_tokens: int) -> Optional[float]:
        """Estimated wall seconds to commit ``n_tokens``; None while cold."""
        rate = self.rate
        if rate is None or rate <= 0:
            return None
        return n_tokens / rate


DEFAULT_TENANT = "default"
_TENANT_MAX_LEN = 64


def validate_tenant(tenant: Optional[str]) -> Optional[str]:
    """Normalize/validate a wire-level tenant field. None stays None (the
    scheduler substitutes its configured default tenant at submission);
    anything else must be a short printable identifier."""
    if tenant is None:
        return None
    tenant = str(tenant).strip()
    if not tenant:
        return None
    if len(tenant) > _TENANT_MAX_LEN:
        raise ValueError(f"tenant identifier longer than {_TENANT_MAX_LEN} chars")
    if any(c in tenant for c in "\r\n\x00"):
        raise ValueError("tenant identifier contains control characters")
    return tenant


class FairSharePolicy:
    """Deficit-weighted fair-share over measured per-tenant token rates.

    Engine-free (scheduler-composed, like the other pieces here): the
    scheduler feeds ``observe(tenant, tokens)`` from its execute path — the
    same committed-token signal the :class:`RateEstimator` sees, split by
    tenant — and consults ``over_share(tenant)`` at admission and queue-shed
    time *while the brownout controller reports pressure*.  A tenant is over
    its share when its measured fraction of the total token rate exceeds
    ``over_factor`` x its configured share; the verdict is hysteresis-smoothed
    (it clears only below ``(over_factor - hysteresis) x share``), so a tenant
    flapping at the boundary is not alternately admitted and shed.

    Shares: an explicit ``shares`` map (weights, normalized over tenants seen
    so far) or, by default, an equal split across every tenant that has
    submitted — a lone tenant owns share 1.0 and can never be over it, so the
    policy is inert until there is someone to be unfair *to*.
    """

    def __init__(self, shares: Optional[dict] = None, alpha: float = 0.2,
                 over_factor: float = 1.25, hysteresis: float = 0.25):
        if over_factor <= 1.0:
            raise ValueError(f"over_factor must be > 1, got {over_factor}")
        # the clear threshold (over_factor - hysteresis) must stay positive
        hysteresis = max(0.0, min(float(hysteresis), over_factor - 1e-3))
        self._shares = dict(shares) if shares else None
        self._alpha = alpha
        self._over_factor = float(over_factor)
        self._hysteresis = float(hysteresis)
        self._rates = {}   # tenant -> EWMA tokens/s
        self._last_s = {}  # tenant -> last observation timestamp
        self._seen = set()
        self._over = set()  # tenants currently flagged (hysteresis state)
        self.sheds = 0      # bumped by the scheduler per fair-share shed

    def note(self, tenant: str) -> None:
        """Register a tenant sighting (submission) — what the default
        equal-split share is computed over."""
        self._seen.add(tenant)

    def observe(self, tenant: str, n_tokens: int,
                now: Optional[float] = None) -> None:
        """Fold one executed batch member's committed tokens into the
        tenant's rate EWMA (same instantaneous-rate construction as
        :class:`RateEstimator`)."""
        if n_tokens <= 0:
            return
        now = time.monotonic() if now is None else now
        self._seen.add(tenant)
        last = self._last_s.get(tenant)
        self._last_s[tenant] = now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        inst = n_tokens / dt
        prev = self._rates.get(tenant)
        self._rates[tenant] = (inst if prev is None
                               else (1 - self._alpha) * prev + self._alpha * inst)

    def configured_share(self, tenant: str) -> float:
        """The tenant's entitled fraction of the measured token rate:
        its weight over the weights of every tenant seen so far (weight 1.0
        for tenants the share map does not list — never entitled to zero)."""
        tenants = self._seen | {tenant}
        shares = self._shares or {}
        weights = {t: max(0.0, float(shares.get(t, 1.0))) for t in tenants}
        total = sum(weights.values())
        return weights[tenant] / total if total > 0 else 1.0

    def measured_share(self, tenant: str) -> float:
        total = sum(self._rates.values())
        if total <= 0:
            return 0.0
        return self._rates.get(tenant, 0.0) / total

    def deficit(self, tenant: str) -> float:
        """measured - configured share: positive = consuming past its
        entitlement (the queue-shed ordering key, largest first)."""
        return self.measured_share(tenant) - self.configured_share(tenant)

    def over_share(self, tenant: str) -> bool:
        """Hysteresis-smoothed over-share verdict (pressure-independent —
        the *scheduler* gates calls on brownout pressure)."""
        share = self.configured_share(tenant)
        measured = self.measured_share(tenant)
        if tenant in self._over:
            if measured < (self._over_factor - self._hysteresis) * share:
                self._over.discard(tenant)
        elif measured > self._over_factor * share:
            self._over.add(tenant)
        return tenant in self._over

    def doc(self) -> dict:
        """The /v1/stats usage-block fair-share view."""
        tenants = sorted(self._seen)
        return {"over_factor": self._over_factor,
                "hysteresis": self._hysteresis,
                "sheds": self.sheds,
                "tenants": {t: {"rate_tokens_per_s": self._rates.get(t),
                                "measured_share": round(self.measured_share(t), 4),
                                "configured_share": round(self.configured_share(t), 4),
                                "over_share": t in self._over}
                            for t in tenants}}


class BrownoutController:
    """Staged degradation driven by a smoothed pressure signal.

    ``update(pressure)`` feeds one raw pressure sample in [0, 1] (the
    scheduler uses ``max(queue_fraction, kv_occupancy)``), smooths it with an
    EWMA, and maps it to a stage: the highest ``thresholds`` index the
    smoothed signal clears, +1. Hysteresis: a stage entered at ``t`` is only
    left when the signal falls below ``t - hysteresis``, so boundary noise
    cannot flap service modes.
    """

    def __init__(self, thresholds: Sequence[float] = (0.65, 0.85, 0.95),
                 hysteresis: float = 0.1, alpha: float = 0.3):
        if list(thresholds) != sorted(thresholds):
            raise ValueError(f"brownout thresholds must be ascending: {thresholds}")
        self._thresholds = tuple(thresholds)
        self._hysteresis = hysteresis
        self._alpha = alpha
        self._smoothed = 0.0
        self._stage = 0
        self.transitions = 0

    @property
    def stage(self) -> int:
        return self._stage

    @property
    def pressure(self) -> float:
        """The smoothed pressure signal (the stage driver)."""
        return self._smoothed

    @property
    def max_stage(self) -> int:
        return len(self._thresholds)

    def update(self, pressure: float) -> int:
        """Feed one raw pressure sample; returns the (possibly new) stage."""
        pressure = min(1.0, max(0.0, float(pressure)))
        self._smoothed = ((1 - self._alpha) * self._smoothed
                          + self._alpha * pressure)
        # escalate to the highest threshold cleared...
        stage = 0
        for i, t in enumerate(self._thresholds):
            if self._smoothed >= t:
                stage = i + 1
        # ...but de-escalate only past the hysteresis band of the CURRENT
        # stage's entry threshold (one band per stage: a signal hovering at a
        # boundary holds the stage instead of flapping)
        if stage < self._stage:
            hold = self._thresholds[self._stage - 1] - self._hysteresis
            if self._smoothed >= hold:
                stage = self._stage
        if stage != self._stage:
            self._stage = stage
            self.transitions += 1
        return self._stage
