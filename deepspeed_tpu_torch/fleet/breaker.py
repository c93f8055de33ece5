"""Per-replica circuit breaker + the shared bounded-jitter backoff policy.

The router's original failover was raw per-request exclusion: a dead replica
was re-tried by every request until the probe TTL noticed, and nothing
remembered failures across requests. The breaker is that memory — the
standard three-state machine:

- **CLOSED** — dispatch normally; ``failure_threshold`` *consecutive*
  failures (transport errors, 5xx admission refusals, probe exceptions —
  never 429 backpressure, which is load, not breakage) trip it OPEN.
- **OPEN** — the replica is skipped outright (no dispatch, no probe, no
  handler thread pinned on a black-holed socket) for a cooldown that doubles
  per consecutive OPEN episode up to a cap, then the breaker half-opens.
- **HALF_OPEN** — up to ``half_open_max_probes`` concurrent trial dispatches
  are let through (:meth:`CircuitBreaker.try_acquire`); one success closes
  the breaker and resets the episode scaling, one failure re-opens it.

``backoff_delay`` is the one backoff formula the fleet shares: router
failover retries, failed-probe re-probe spacing, and supervisor restart
scheduling all use it — exponential growth, a hard cap, and *bounded* jitter
(``d * (1 ± jitter_frac)``) so synchronized clients de-correlate without the
unbounded tail of full-jitter schemes.

Port of ``deepspeed_tpu/fleet/breaker.py``; ``BreakerConfig`` is a dataclass
on ``runtime/config_utils.py`` with the reference's defaults and bounds.
"""

import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.utils.logging import logger


def backoff_delay(attempt: int, base_s: float, cap_s: float,
                  jitter_frac: float = 0.0, u: Optional[float] = None,
                  multiplier: float = 2.0) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * multiplier**attempt``
    capped at ``cap_s``, jittered into ``[d*(1-j), d*(1+j)]``. ``u`` is the
    jitter draw in [0, 1) — deterministic callers (the supervisor, the fault
    harness) pass their own; None means no jitter."""
    d = min(cap_s, base_s * (multiplier ** max(0, attempt)))
    if jitter_frac > 0.0 and u is not None:
        d *= 1.0 - jitter_frac + 2.0 * jitter_frac * u
    return max(0.0, d)


class BreakerState(Enum):
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


@dataclass
class BreakerConfig(DeepSpeedConfigModel):
    """Per-replica circuit-breaker knobs (``FleetConfig.breaker``)."""

    enabled: bool = True
    """False = ``allow()`` always True (the pre-breaker raw-exclusion
    behavior); the object still exists so call sites stay branch-free."""

    failure_threshold: int = config_field(3, ge=1)
    """Consecutive breaker-grade failures (transport/5xx/probe-error — not
    429) that trip CLOSED → OPEN."""

    open_cooldown_s: float = config_field(2.0, gt=0)
    """OPEN dwell before the first HALF_OPEN trial window."""

    cooldown_multiplier: float = config_field(2.0, ge=1)
    """Cooldown growth per consecutive OPEN episode (a replica that keeps
    failing its trial waits longer each time)."""

    max_cooldown_s: float = config_field(60.0, gt=0)
    """Cooldown growth cap."""

    half_open_max_probes: int = config_field(1, ge=1)
    """Concurrent trial dispatches allowed while HALF_OPEN."""


class CircuitBreaker:
    """One replica's failure memory. Thread-safe; the OPEN→HALF_OPEN
    transition is lazy (evaluated on the next ``allow``/``try_acquire``), so
    there is no timer thread per replica. ``on_transition(breaker, old, new)``
    observers fire outside the breaker lock."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 on_transition: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._config = config or BreakerConfig()
        self._on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._failures = 0        # consecutive, CLOSED only
        self._episodes = 0        # consecutive OPEN episodes (cooldown scaling)
        self._opened_at = 0.0
        self._trials = 0          # in-flight HALF_OPEN trial dispatches
        self._opens = 0           # lifetime transitions into OPEN
        self._closes = 0          # lifetime HALF_OPEN -> CLOSED recoveries

    # ------------------------------------------------------------------ state --
    @property
    def state(self) -> BreakerState:
        with self._lock:
            transitions = self._maybe_half_open()
            state = self._state
        self._notify(transitions)
        return state

    def _cooldown_s(self) -> float:
        cfg = self._config
        return backoff_delay(self._episodes - 1, cfg.open_cooldown_s,
                             cfg.max_cooldown_s,
                             multiplier=cfg.cooldown_multiplier)

    def _maybe_half_open(self) -> list:
        # caller holds the lock; returns transitions for _notify
        if (self._state is BreakerState.OPEN
                and self._clock() - self._opened_at >= self._cooldown_s()):
            self._trials = 0
            return [self._transition(BreakerState.HALF_OPEN)]
        return []

    def _transition(self, new: BreakerState):
        # caller holds the lock; returns the (old, new) pair for _notify
        old, self._state = self._state, new
        return (old, new)

    def _notify(self, transitions) -> None:
        if not self._on_transition:
            return
        for old, new in transitions:
            if old is new:
                continue
            try:
                self._on_transition(self, old, new)
            except Exception:  # pragma: no cover - an observer must never
                # take down the dispatch path it observes
                logger.exception("circuit breaker: on_transition raised")

    # ---------------------------------------------------------- dispatch gate --
    def allow(self) -> bool:
        """Non-consuming candidacy check: may this replica be dispatched to
        right now? (OPEN lazily half-opens when its cooldown has passed.)"""
        if not self._config.enabled:
            return True
        with self._lock:
            transitions = self._maybe_half_open()
            if self._state is BreakerState.CLOSED:
                out = True
            elif self._state is BreakerState.HALF_OPEN:
                out = self._trials < self._config.half_open_max_probes
            else:
                out = False
        self._notify(transitions)
        return out

    def try_acquire(self) -> bool:
        """Consume a dispatch slot: always True when CLOSED (or disabled);
        while HALF_OPEN, claims one of the bounded trial slots (the caller
        MUST then report ``record_success``/``record_failure`` — or
        ``release`` when no verdict was reached — so slots cannot leak)."""
        if not self._config.enabled:
            return True
        with self._lock:
            transitions = self._maybe_half_open()
            if self._state is BreakerState.CLOSED:
                out = True
            elif (self._state is BreakerState.HALF_OPEN
                  and self._trials < self._config.half_open_max_probes):
                self._trials += 1
                out = True
            else:
                out = False
        self._notify(transitions)
        return out

    def release(self) -> None:
        """A trial ended without a breaker-grade verdict (e.g. 429
        backpressure): free the slot, change nothing else."""
        with self._lock:
            self._trials = max(0, self._trials - 1)

    # --------------------------------------------------------------- outcomes --
    def record_success(self, trial: bool = True) -> None:
        """A dispatch was admitted (or a HALF_OPEN probe came back healthy).
        ``trial=False`` marks a probe-path signal that never held a slot."""
        transitions = []
        with self._lock:
            self._failures = 0
            if self._state is BreakerState.HALF_OPEN:
                if trial:
                    self._trials = max(0, self._trials - 1)
                self._episodes = 0
                self._closes += 1
                transitions.append(self._transition(BreakerState.CLOSED))
        self._notify(transitions)

    def record_probe_success(self) -> None:
        """A health probe answered healthy. Closes a HALF_OPEN breaker (the
        replica demonstrably recovered) but does NOT reset CLOSED-state
        failure counting — an upstream can answer probes while refusing every
        dispatch, and interleaved probe successes must not keep such a
        replica's breaker from ever tripping."""
        transitions = []
        with self._lock:
            transitions.extend(self._maybe_half_open())
            if self._state is BreakerState.HALF_OPEN:
                self._episodes = 0
                self._closes += 1
                transitions.append(self._transition(BreakerState.CLOSED))
        self._notify(transitions)

    def record_failure(self, trial: bool = True) -> None:
        """A breaker-grade failure (transport error, 5xx refusal, leg death,
        probe exception). NOT for 429 backpressure — use ``release``."""
        with self._lock:
            transitions = self._maybe_half_open()
            if self._state is BreakerState.HALF_OPEN:
                if trial:
                    self._trials = max(0, self._trials - 1)
                transitions.append(self._open())
            elif self._state is BreakerState.CLOSED:
                self._failures += 1
                if self._failures >= self._config.failure_threshold:
                    transitions.append(self._open())
            # already OPEN: nothing to count — the episode is one failure
        self._notify(transitions)

    def _open(self):
        # caller holds the lock
        self._failures = 0
        self._episodes += 1
        self._opened_at = self._clock()
        self._opens += 1
        return self._transition(BreakerState.OPEN)

    # ------------------------------------------------------------------ admin --
    def describe(self) -> dict:
        with self._lock:
            doc = {"state": self._state.name,
                   "consecutive_failures": self._failures,
                   "open_episodes": self._episodes,
                   "opens": self._opens, "closes": self._closes}
            if self._state is BreakerState.OPEN:
                doc["half_open_in_s"] = round(
                    max(0.0, self._cooldown_s() - (self._clock() - self._opened_at)), 3)
            return doc
