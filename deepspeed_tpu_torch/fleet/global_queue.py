"""Router global queue: priority/deadline-ordered queued dispatch with
replica-pull semantics (ROADMAP 3c, first half).

Queued work lives HERE, at the router, instead of in per-replica submission
queues: a request is only handed to a replica when that replica has a free
dispatch slot, so the router — which sees the whole fleet — decides *which*
queued request runs next (interactive before batch, earliest deadline first)
instead of whichever replica queue it happened to be pushed into. That
ordering is the substrate every overload behavior builds on: deadline expiry
while queued is detected centrally (429 + ``Retry-After``, before any
replica work), and a burst parks at the router rather than fanning out into
N replica queues that each drain blindly.

No background thread: grants happen inline — ``acquire`` tries to place the
entry immediately, and every ``release`` (a leg finished, freeing its slot)
pumps the queue on the releasing thread. The CPU-testable formulation: fully
event-driven, nothing to wake up, deterministic under test.

Capacity model: each replica may hold at most ``max_inflight`` concurrently
granted legs (continuous batching makes a replica happily run several; the
cap keeps one replica from absorbing a burst the rest of the fleet could
share). Candidate health/breaker filtering stays the router's job — every
entry carries a ``pool_fn`` re-evaluated at each pump, so replicas joining,
leaving, or tripping breakers are seen immediately.

``inject_phantoms`` is the chaos harness's ``overload_burst`` hook: phantom
entries occupy queue capacity for a bounded hold, are never granted, and
expire loudly through the same accounting as real entries.

Port of ``deepspeed_tpu/fleet/global_queue.py`` (host Python, unchanged in behaviour
except where noted).
"""

import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence

from deepspeed_tpu_torch.serving.overload import priority_rank

_ENTRY_SEQ = itertools.count()


class GlobalQueueFull(RuntimeError):
    """The router global queue is at capacity; ``retry_after_s`` is the
    grant-rate-derived backoff (HTTP 429)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class QueueWaitExpired(RuntimeError):
    """The entry's deadline (or the acquire timeout) passed while it waited
    for a replica — router-level shedding, before any replica work."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class _Entry:
    __slots__ = ("seq", "priority", "deadline", "enq_s", "pool_fn",
                 "session_key", "event", "replica", "phantom", "hint")

    def __init__(self, pool_fn, priority: str, deadline: Optional[float],
                 session_key: Optional[str], phantom: bool = False,
                 hint=None):
        self.seq = next(_ENTRY_SEQ)
        self.priority = priority
        self.deadline = deadline          # absolute monotonic, None = none
        self.enq_s = time.monotonic()
        self.pool_fn = pool_fn
        self.session_key = session_key
        self.event = threading.Event()
        self.replica = None               # set under the queue lock at grant
        self.phantom = phantom
        self.hint = hint                  # opaque placement hint for pick

    @property
    def order_key(self):
        return (priority_rank(self.priority),
                self.deadline if self.deadline is not None else float("inf"),
                self.seq)


class GlobalQueue:
    """Priority/deadline-ordered dispatch queue with per-replica slot caps.

    ``pick`` is the router's replica-selection policy (affinity /
    least-loaded / slow-demotion) applied to the free-slot candidates of the
    entry being granted.
    """

    def __init__(self, max_inflight: int, capacity: int, pick: Callable,
                 retry_after_floor_s: float = 0.5,
                 retry_after_cap_s: float = 30.0,
                 metrics=None):
        self._max_inflight = max_inflight
        self._capacity = capacity
        self._pick = pick
        self._retry_floor = retry_after_floor_s
        self._retry_cap = retry_after_cap_s
        self._metrics = metrics
        self._lock = threading.Lock()
        # poll-path pumps are pure backstops (grants are event-driven on
        # release): at most one waiter runs one at a time, the rest skip —
        # otherwise N waiters x M entries re-evaluate every pool each tick
        self._pump_gate = threading.Lock()
        self._entries: List[_Entry] = []
        self._slots = {}                  # replica id -> granted legs
        self._grants = 0
        self._expired = 0
        self._admission_sheds = 0
        self._phantoms_injected = 0
        # EWMA of the inter-grant interval: the queue's drain clock, the
        # Retry-After denominator (None until the second grant)
        self._last_grant_s: Optional[float] = None
        self._grant_interval_ewma: Optional[float] = None

    # ----------------------------------------------------------------- stats --
    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def slots_in_use(self, replica_id: str) -> int:
        with self._lock:
            return self._slots.get(replica_id, 0)

    def retry_after_s(self) -> float:
        """Backoff estimate from the measured grant rate: depth × the EWMA
        inter-grant interval, bounded. No grants yet = the floor scaled by
        depth (some signal beats none)."""
        with self._lock:
            depth = len(self._entries)
            interval = self._grant_interval_ewma
        est = (depth * interval if interval is not None
               else self._retry_floor * (1 + depth))
        return min(self._retry_cap, max(self._retry_floor, est))

    def describe(self) -> dict:
        with self._lock:
            return {"depth": len(self._entries),
                    "slots": {k: v for k, v in sorted(self._slots.items()) if v},
                    "grants": self._grants,
                    "expired": self._expired,
                    "admission_sheds": self._admission_sheds,
                    "phantoms_injected": self._phantoms_injected,
                    "retry_after_s": None if self._grant_interval_ewma is None
                    else round(len(self._entries) * self._grant_interval_ewma, 3)}

    # --------------------------------------------------------------- acquire --
    def acquire(self, pool_fn: Callable[[], Sequence], *,
                priority: str = "interactive",
                deadline_s: Optional[float] = None,
                session_key: Optional[str] = None,
                timeout_s: float = 30.0,
                hint=None):
        """Wait for a replica with a free slot (priority/deadline order);
        returns the granted replica, whose slot the caller MUST release via
        :meth:`release` when the leg finishes. ``deadline_s`` is the
        remaining client deadline: expiring while queued raises
        :class:`QueueWaitExpired` (router-level shedding, nothing dispatched).
        ``hint`` is an opaque placement hint forwarded to ``pick`` at grant
        time (cache-aware routing threads the request's prefix chain here).
        """
        now = time.monotonic()
        entry = _Entry(pool_fn, priority,
                       now + deadline_s if deadline_s is not None else None,
                       session_key, hint=hint)
        with self._lock:
            # admission estimate: with a warm grant clock, an entry whose
            # expected grant wait (depth x the EWMA inter-grant interval)
            # already exceeds its deadline is shed HERE — a rejection at
            # enqueue costs nothing, an expiry at the deadline costs a
            # parked slot in every client's latency budget
            if (deadline_s is not None and self._grant_interval_ewma is not None
                    and len(self._entries) * self._grant_interval_ewma
                    > deadline_s):
                est = len(self._entries) * self._grant_interval_ewma
                depth = len(self._entries)
                # an admission shed IS an expiry (counted in both the
                # fleet_global_queue_expired metric and describe()["expired"]
                # — the two surfaces must agree); admission_sheds is the
                # subset that never waited
                self._admission_sheds += 1
                self._expired += 1
            else:
                est = None
                full = len(self._entries) >= self._capacity
                if not full:
                    self._entries.append(entry)
        if est is not None:
            self._note_expired()
            raise QueueWaitExpired(
                f"queue admission: estimated grant wait {est:.2f}s exceeds "
                f"the {deadline_s:.2f}s deadline at depth {depth}",
                retry_after_s=self.retry_after_s())
        if full:
            # retry_after_s() takes the (non-reentrant) lock: raise outside it
            raise GlobalQueueFull(
                f"router global queue at capacity ({self._capacity})",
                retry_after_s=self.retry_after_s())
        if self._metrics:
            self._metrics.global_queue_depth.set(self.depth)
        self._pump()
        wait_deadline = now + (min(timeout_s, deadline_s)
                               if deadline_s is not None else timeout_s)
        while not entry.event.wait(timeout=min(0.25, max(0.0, wait_deadline
                                                         - time.monotonic()) or 0.001)):
            self._maybe_pump()  # replicas may have become healthy without
            # a release; one concurrent backstop pump is plenty
            if time.monotonic() >= wait_deadline:
                with self._lock:
                    # entry.replica is assigned under the lock at grant,
                    # strictly before event.set() runs outside it — checking
                    # the event here would miss a just-granted entry, raise
                    # on the remove, and leak the granted slot forever
                    if entry.replica is not None:
                        break  # granted in the race window: keep the slot
                    self._entries.remove(entry)
                    self._expired += 1
                self._note_expired()
                raise QueueWaitExpired(
                    f"queue wait exceeded "
                    f"{'deadline' if entry.deadline is not None else 'timeout'} "
                    f"after {time.monotonic() - entry.enq_s:.2f}s at depth "
                    f"{self.depth}", retry_after_s=self.retry_after_s())
        wait = time.monotonic() - entry.enq_s
        if self._metrics:
            self._metrics.global_queue_wait.observe(wait)
            self._metrics.global_queue_depth.set(self.depth)
        return entry.replica

    def release(self, replica_id: str) -> None:
        """A granted leg finished (or failed to dispatch): free its slot and
        pump — the freed capacity goes to the best queued entry NOW, on this
        thread (pull dispatch)."""
        with self._lock:
            n = self._slots.get(replica_id, 0)
            if n <= 1:
                self._slots.pop(replica_id, None)
            else:
                self._slots[replica_id] = n - 1
        self._pump()

    # ------------------------------------------------------------------ pump --
    def _maybe_pump(self) -> None:
        """Run a pump only if no other thread is mid-pump (the poll-path
        backstop); release() keeps calling :meth:`_pump` directly — freed
        capacity must be granted NOW, not next tick."""
        if self._pump_gate.acquire(blocking=False):
            try:
                self._pump()
            finally:
                self._pump_gate.release()

    def _pump(self) -> None:
        """Grant every placeable entry, best first. Candidates are computed
        OUTSIDE the lock (``pool_fn`` may probe replicas over sockets); the
        grant itself re-validates under the lock."""
        now = time.monotonic()
        granted_this_pass = 0
        with self._lock:
            snapshot = sorted(self._entries, key=lambda e: e.order_key)
        for entry in snapshot:
            if entry.phantom:
                if entry.deadline is not None and now >= entry.deadline:
                    with self._lock:
                        if entry in self._entries:
                            self._entries.remove(entry)
                            self._expired += 1
                    self._note_expired()
                continue  # phantoms are never granted
            try:
                pool = list(entry.pool_fn())
            except Exception:  # pragma: no cover - a dying pool_fn must not
                continue       # wedge the pump for the other entries
            with self._lock:
                if entry not in self._entries:
                    continue  # granted/expired by a racing pump
                candidates = [r for r in pool
                              if self._slots.get(r.id, 0) < self._max_inflight]
                if not candidates:
                    continue
                # pick sees the full pool and the entry's deadline too: a
                # None verdict means "rather wait" (e.g. every free slot is
                # on a demotion-grade slow replica and the entry carries a
                # deadline a doomed grant would burn)
                if entry.hint is not None:
                    # only pass the kwarg when a hint exists: custom pick
                    # callables predating cache-aware routing keep working
                    replica = self._pick(candidates, entry.session_key,
                                         pool=pool, deadline=entry.deadline,
                                         hint=entry.hint)
                else:
                    replica = self._pick(candidates, entry.session_key,
                                         pool=pool, deadline=entry.deadline)
                if replica is None:
                    continue
                self._slots[replica.id] = self._slots.get(replica.id, 0) + 1
                self._entries.remove(entry)
                entry.replica = replica
                self._grants += 1
                granted_this_pass += 1
            entry.event.set()
            if self._metrics:
                self._metrics.global_queue_grants.inc()
        if granted_this_pass:
            # ONE amortized EWMA update per pass — (elapsed since the last
            # grant activity) / (grants this pass). Per-grant updates would
            # feed k near-zero intervals for a k-grant pass, shrinking the
            # EWMA by 0.7^k and collapsing the Retry-After / admission
            # estimate exactly when the queue is bursty.
            end_s = time.monotonic()
            with self._lock:
                if self._last_grant_s is not None:
                    interval = max(0.0, end_s - self._last_grant_s) \
                        / granted_this_pass
                    self._grant_interval_ewma = (
                        interval if self._grant_interval_ewma is None
                        else 0.7 * self._grant_interval_ewma + 0.3 * interval)
                self._last_grant_s = end_s

    def _note_expired(self) -> None:
        if self._metrics:
            self._metrics.global_queue_expired.inc()
            self._metrics.global_queue_depth.set(self.depth)

    # -------------------------------------------------------------- phantoms --
    def inject_phantoms(self, n: int, hold_s: float) -> int:
        """The ``overload_burst`` chaos hook: ``n`` phantom batch-priority
        entries that occupy queue capacity for ``hold_s`` then expire (never
        granted). Returns how many fit under the capacity cap."""
        injected = 0
        deadline = time.monotonic() + hold_s
        with self._lock:
            for _ in range(n):
                if len(self._entries) >= self._capacity:
                    break
                entry = _Entry(None, "batch", None, None, phantom=True)
                entry.deadline = deadline
                self._entries.append(entry)
                injected += 1
            self._phantoms_injected += injected
        if self._metrics:
            self._metrics.global_queue_depth.set(self.depth)
        return injected
