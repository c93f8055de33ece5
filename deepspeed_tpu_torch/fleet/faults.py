"""Deterministic fault injection for the fleet layer (the chaos harness).

Every recovery path the fault-tolerance subsystem claims — failover, circuit
breaking, decode-leg re-dispatch, supervisor restarts — must be *testable* on
the CPU, reproducibly, not by anecdotal kill-a-process demos. The
:class:`FaultInjector` makes failures a pure function of ``(seed, point, n)``:
the *n*-th event at an injection point fires iff a hash of the seed, the point
key and *n* falls under that point's probability. No wall clock, no shared RNG
stream — thread interleaving changes which *request* hits a scheduled fault,
never the schedule itself, so the identical seed reproduces the identical
fault schedule (:meth:`would_fire` recomputes it from scratch).

Injection points (all consulted by ``fleet/router.py``; each scoped
*per-replica* where a replica identity exists, so e.g. consecutive 5xx bursts
land on one replica and exercise its circuit breaker):

- ``dispatch_delay`` — sleep before dispatching a leg (slow network / GC pause);
- ``connect_reset`` — the dispatch connection dies before admission;
- ``http_5xx`` — the replica answers 503 at admission;
- ``stream_truncate`` — the SSE leg dies mid-stream after K tokens;
- ``handoff_corrupt`` — the prefill→decode payload is corrupted/truncated in
  transit (for ONE dispatch attempt; the router's buffered copy stays pristine);
- ``replica_kill`` — the chosen replica is killed outright (the supervisor's
  restart path);
- ``decode_stall`` — a seeded per-token delay on one replica's token stream
  (``decode_stall_replica`` scopes it): the slow-but-alive replica the
  circuit breaker never sees, what hedged dispatch exists to beat;
- ``overload_burst`` — a synthetic admission burst: the router's global queue
  gains ``overload_burst_requests`` phantom entries held for
  ``overload_burst_hold_s``, deterministically exercising queue-depth
  pressure, Retry-After growth and shedding.

Disabled is the default and costs one ``None`` check at every hook; the
injector only exists when ``FleetConfig.faults.enabled`` (or the
``DSTPU_FAULTS`` env var, a JSON ``FaultConfig`` body) says so.

Port of ``deepspeed_tpu/fleet/faults.py``; ``FaultConfig`` is a dataclass on
``runtime/config_utils.py`` with the reference's defaults and bounds. The
port's handoff frame is byte-for-byte the reference's, so a corruption lands
at the same offset.
"""

import hashlib
import json
import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from deepspeed_tpu_torch.inference.v2.ragged.handoff import MAGIC
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field

# every injection point the router consults; would_fire rejects unknown ones
# so a typo'd hook cannot silently never fire
POINTS = ("dispatch_delay", "connect_reset", "http_5xx", "stream_truncate",
          "handoff_corrupt", "replica_kill", "decode_stall", "overload_burst",
          "peer_fetch_corrupt", "steal_race", "park_store_corrupt",
          "demote_race")

_EVENT_LOG_CAP = 512  # per injector, for the recovery report


@dataclass
class FaultConfig(DeepSpeedConfigModel):
    """Chaos-harness knobs. All probabilities are per *event* at the point
    (per dispatch attempt, per stream, per payload hop, ...)."""

    enabled: bool = False
    """Master switch; False = no injector is constructed at all."""

    allow_remote: bool = False
    """Expose ``POST /v1/fleet/chaos`` on the router so a loadgen run can arm
    / re-seed the injector over HTTP (a load generator's chaos run). Keep
    False anywhere untrusted clients can reach the router."""

    seed: int = 0
    """The schedule seed: identical seed = identical fault schedule."""

    dispatch_delay_p: float = config_field(0.0, ge=0, le=1)
    dispatch_delay_max_s: float = config_field(0.05, ge=0)
    """Injected dispatch latency is uniform in (0, max], hash-derived."""

    connect_reset_p: float = config_field(0.0, ge=0, le=1)
    http_5xx_p: float = config_field(0.0, ge=0, le=1)
    http_5xx_burst: int = config_field(1, ge=1)
    """When a 5xx fires, the next ``burst-1`` events at the same (point,
    replica) fire too — consecutive failures are what trips a breaker."""

    stream_truncate_p: float = config_field(0.0, ge=0, le=1)
    stream_truncate_max_tokens: int = config_field(4, ge=0)
    """A truncated stream dies after a hash-derived 0..max token prefix."""

    handoff_corrupt_p: float = config_field(0.0, ge=0, le=1)
    replica_kill_p: float = config_field(0.0, ge=0, le=1)

    peer_fetch_corrupt_p: float = config_field(0.0, ge=0, le=1)
    """Per-peer-prefix-fetch probability of corrupting the fetched KV frame
    in transit (byte flip in the CRC-covered region / truncation): the
    importer must reject loudly and recompute cold, never publish a
    corrupted block into its trie."""

    steal_race_p: float = config_field(0.0, ge=0, le=1)
    """Per-steal probability that the victim finishes the request while the
    steal decision is in flight: the router must keep the original leg and
    complete exactly once (no duplicate tokens, no lost request)."""

    park_store_corrupt_p: float = config_field(0.0, ge=0, le=1)
    """Per-rehydrate-dispatch probability of corrupting the parked frame
    sent to the target replica (the store's copy stays pristine): the replica
    must reject loudly on CRC/framing and the router must fall back to a cold
    full-prompt run, never continue from half-corrupt KV."""

    demote_race_p: float = config_field(0.0, ge=0, le=1)
    """Per-demotion probability of injecting a concurrent read into the
    tier writer's spill-to-commit window (``TieredKVStore.race_hook``): the
    reader must reclaim the entry to host, the writer must discard its
    orphan file, and the race must be counted — never a read of a
    half-written spill."""

    decode_stall_p: float = config_field(0.0, ge=0, le=1)
    """Per-token probability of an injected stall on the leg's token stream
    (the slow-but-alive replica: latency stretches, the breaker — which keys
    on failures — never trips)."""

    decode_stall_s: float = config_field(0.05, ge=0)
    """Stall ceiling: each firing sleeps a hash-derived uniform
    (0, decode_stall_s]."""

    decode_stall_replica: Optional[str] = None
    """Scope the stall to ONE replica id (the hedging scenario: exactly one
    slow member stretches fleet p99); None = every replica is subject."""

    overload_burst_p: float = config_field(0.0, ge=0, le=1)
    """Per-admitted-request probability of injecting a synthetic burst into
    the router's global queue."""

    overload_burst_requests: int = config_field(8, ge=1)
    """Phantom queue entries per burst (batch priority, never granted)."""

    overload_burst_hold_s: float = config_field(0.25, ge=0)
    """How long the phantom entries occupy the queue before expiring."""


def _u64(seed: int, key: str, n: int, salt: str = "") -> int:
    digest = hashlib.sha256(f"{seed}:{key}:{n}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _uniform(seed: int, key: str, n: int, salt: str = "") -> float:
    """Deterministic uniform [0, 1) for the n-th event at ``key``."""
    return _u64(seed, key, n, salt) / 2.0 ** 64


class FaultInjector:
    """Seed-driven fault schedule over named injection points.

    One counter per ``(point, scope)`` key (scope = replica id where one
    exists); :meth:`fire` consumes the next index for the key and answers
    whether that event faults. All mutation is under one lock — the counters
    are the only state, so the hot disabled path in the router is just the
    ``injector is None`` check at each hook.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}          # point -> total fired
        self._events: deque = deque(maxlen=_EVENT_LOG_CAP)

    # ---------------------------------------------------------------- schedule --
    def _p(self, point: str) -> float:
        return getattr(self.config, f"{point}_p")

    def _burst(self, point: str) -> int:
        return self.config.http_5xx_burst if point == "http_5xx" else 1

    @staticmethod
    def _key(point: str, scope: Optional[str]) -> str:
        return f"{point}@{scope}" if scope else point

    def would_fire(self, point: str, n: int, scope: Optional[str] = None) -> bool:
        """Pure schedule query: does the n-th event at ``(point, scope)``
        fault? Recomputed from the seed alone — the reproducibility oracle the
        chaos tests diff a live run against."""
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} (know {POINTS})")
        p, burst = self._p(point), self._burst(point)
        if p <= 0.0:
            return False
        if _uniform(self.config.seed, self._key(point, scope), n) < p:
            return True
        # inside a burst started by an earlier firing index?
        for back in range(1, burst):
            if n - back >= 0 and _uniform(self.config.seed,
                                          self._key(point, scope), n - back) < p:
                return True
        return False

    def schedule(self, point: str, count: int,
                 scope: Optional[str] = None) -> List[int]:
        """The firing indices among the first ``count`` events — the whole
        deterministic schedule for a key, for reports and tests."""
        return [n for n in range(count) if self.would_fire(point, n, scope)]

    # -------------------------------------------------------------------- fire --
    def fire(self, point: str, scope: Optional[str] = None) -> Optional[int]:
        """Consume the next event index at ``(point, scope)``; returns the
        index when that event faults, None otherwise."""
        key = self._key(point, scope)
        with self._lock:
            n = self._counters.get(key, 0)
            self._counters[key] = n + 1
            # the live decision IS the pure oracle — fire() adds only the
            # per-key event counter, so a replayed schedule cannot diverge
            # from a recorded run
            if self.would_fire(point, n, scope):
                self._fired[point] = self._fired.get(point, 0) + 1
                self._events.append({"point": point, "scope": scope, "n": n})
                return n
        return None

    # ----------------------------------------------------- fault-shape helpers --
    def delay_s(self, n: int, scope: Optional[str] = None) -> float:
        """Injected dispatch delay for firing index ``n``: uniform
        (0, dispatch_delay_max_s], hash-derived so the same index always
        delays the same amount."""
        u = _uniform(self.config.seed, self._key("dispatch_delay", scope), n, "len")
        return self.config.dispatch_delay_max_s * max(u, 1e-3)

    def stalls_replica(self, replica_id: Optional[str]) -> bool:
        """Is this replica's stream subject to ``decode_stall`` at all? One
        cheap check before the per-token ``fire`` consult — a scoped stall
        must not consume schedule indices on unscoped replicas (the oracle
        and the live run count the same events)."""
        return (self.config.decode_stall_p > 0
                and self.config.decode_stall_replica in (None, replica_id))

    def stall_s(self, n: int, scope: Optional[str] = None) -> float:
        """Injected per-token stall for firing index ``n``: uniform
        (0, decode_stall_s], hash-derived like :meth:`delay_s`."""
        u = _uniform(self.config.seed, self._key("decode_stall", scope), n, "len")
        return self.config.decode_stall_s * max(u, 1e-3)

    def truncate_after(self, n: int, scope: Optional[str] = None) -> int:
        """How many tokens a truncated stream yields before dying."""
        u = _uniform(self.config.seed, self._key("stream_truncate", scope), n, "len")
        return int(u * (self.config.stream_truncate_max_tokens + 1))

    def corrupt(self, payload: bytes, n: int, scope: Optional[str] = None,
                point: str = "handoff_corrupt") -> bytes:
        """A corrupted copy of ``payload`` for firing index ``n``: either a
        short (truncated) payload — the framing/length validation path — or
        one with a byte flipped inside the raw-KV region, which only the
        payload's ``kv_crc32`` can catch. Both shapes must be a loud
        ``ValueError`` at unpack, never silently wrong attention. The same
        shape serves ``handoff_corrupt`` (prefill→decode hop) and
        ``peer_fetch_corrupt`` (cross-replica prefix fetch) via ``point``."""
        u = _uniform(self.config.seed, self._key(point, scope), n, "mode")
        if not payload:
            return payload
        if u < 0.5:  # short payload: framing/length validation path
            return payload[:max(1, int(len(payload) * u))]
        bad = bytearray(payload)
        # flip past the JSON header (MAGIC + u32 length prefix + header):
        # a flip inside the header could keep the JSON valid and mutate a
        # token id silently — the KV region is checksummed, so a flip there
        # is guaranteed loud
        kv_off = 0
        frame = len(MAGIC) + 4
        if len(bad) > frame and bad[:len(MAGIC)] == MAGIC:
            kv_off = min(len(bad) - 1,
                         frame + struct.unpack_from("<I", bad, len(MAGIC))[0])
        pos = kv_off + _u64(self.config.seed, self._key(point, scope),
                            n, "pos") % max(1, len(bad) - kv_off)
        bad[min(pos, len(bad) - 1)] ^= 0xFF
        return bytes(bad)

    # ------------------------------------------------------------------ report --
    def report(self) -> dict:
        """Recovery-report body: per-point fired totals, per-key event counts
        and the recent firing log (bounded)."""
        with self._lock:
            return {
                "seed": self.config.seed,
                "fired": dict(self._fired),
                "events_seen": dict(self._counters),
                "recent": list(self._events),
            }


def config_from_env(env_value: Optional[str]) -> Optional[FaultConfig]:
    """Parse the ``DSTPU_FAULTS`` env var (a JSON ``FaultConfig`` body, e.g.
    ``{"enabled": true, "seed": 7, "replica_kill_p": 0.02}`` — or just
    ``{"allow_remote": true}`` to expose the chaos endpoint without arming
    anything at start, a load generator's chaos flow). None when unset.
    Malformed JSON raises — a chaos run with a typo'd config must not
    silently run clean."""
    if not env_value:
        return None
    return FaultConfig.from_dict(json.loads(env_value))


def injector_from_env(env_value: Optional[str]) -> Optional[FaultInjector]:
    """An armed injector from ``DSTPU_FAULTS``; None when unset/disabled."""
    config = config_from_env(env_value)
    return FaultInjector(config) if config is not None and config.enabled else None
