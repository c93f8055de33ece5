"""Router-side parked-session store (the fleet half of tiered KV memory).

A session that finishes a turn but will plausibly return — chat, agent loops —
does not have to recompute its history next turn: the replica exports the
sequence as a *park frame* (``ragged/handoff.py`` ``PARK_VERSION``, carrying a
versioned ``extra["tier"]`` record) and the router banks it here, keyed by the
client's session key (the ``X-DSTPU-Session`` header / JSON ``session``
field). When the session's next turn arrives — a ``/v1/generate`` whose prompt
*strictly extends* the parked token history — the router dispatches a
*rehydrate* leg instead (``/v1/resume`` with both the payload and the new
prompt) on whichever replica wins placement: the parked turns' KV imports, only
the new suffix prefills, and the continuation is bitwise-identical to a cold
run at the same seed. Because the frame is self-describing and CRC-covered,
the session rehydrates on ANY replica with matching KV geometry, not just the
one that parked it.

The store is a bounded LRU: a session-count cap, a byte budget, and a TTL.
Eviction drops the coldest session — a dropped park costs the next turn a cold
prefill, never correctness. Every ``put`` re-validates the frame (framing,
header schema, CRC), so a corrupt payload is refused at park time; a frame
that a *replica* refuses at rehydrate time (``park_store_corrupt`` in transit,
or rot at rest) is dropped via :meth:`reject` and the turn falls back cold.

Port of ``deepspeed_tpu/fleet/park_store.py`` (host Python, unchanged in behaviour
except where noted).
"""

import threading
import time
from collections import OrderedDict
from typing import List, Optional

from deepspeed_tpu_torch.inference.v2.ragged.handoff import PARK_VERSION, unpack
from deepspeed_tpu_torch.utils.logging import logger


class ParkedSession:
    """One banked session: the pristine frame plus its parsed-once header
    facts (the match predicate never re-parses the payload)."""

    __slots__ = ("payload", "tokens", "seen_tokens", "tier_source",
                 "replica_id", "parked_at_s", "last_touch_s")

    def __init__(self, payload: bytes, tokens: List[int], seen_tokens: int,
                 tier_source: Optional[str], replica_id: Optional[str]):
        self.payload = payload
        self.tokens = tokens
        self.seen_tokens = seen_tokens
        self.tier_source = tier_source
        self.replica_id = replica_id
        self.parked_at_s = time.monotonic()
        self.last_touch_s = self.parked_at_s

    @property
    def nbytes(self) -> int:
        return len(self.payload)


class ParkStore:
    """LRU/TTL/byte-budgeted map: session key → :class:`ParkedSession`.

    Thread-safe (router handler threads park and rehydrate concurrently).
    Counter semantics: ``parks`` = frames banked; ``rehydrate_hits`` = matches
    handed to a rehydrate dispatch; ``rehydrate_misses`` = a *known* session
    key that could not be used (expired, or the new prompt diverged from the
    parked history — the entry is dropped, histories never un-diverge);
    ``corrupt_rejects`` = entries dropped because a frame was refused (at park
    validation or by the rehydrating replica); ``evictions`` = budget/TTL
    drops. A session key the store never saw counts nothing — a first turn is
    not a miss.
    """

    def __init__(self, config=None, metrics=None):
        from deepspeed_tpu_torch.fleet.config import ParkConfig
        self._config = config or ParkConfig()
        self._metrics = metrics
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, ParkedSession]" = OrderedDict()
        self._bytes = 0
        self._counters = {"parks": 0, "rehydrate_hits": 0,
                          "rehydrate_misses": 0, "corrupt_rejects": 0,
                          "evictions": 0}

    # ------------------------------------------------------------------ park --
    def put(self, session_key: str, payload: bytes,
            replica_id: Optional[str] = None) -> bool:
        """Bank one park frame under ``session_key`` (replacing any previous
        turn's frame — the newest turn's history subsumes the old). The frame
        is fully validated here (framing, schema, KV CRC); an invalid one is
        counted as a corrupt reject and refused. Returns True when banked."""
        try:
            header, _ = unpack(payload)
            if header["version"] < PARK_VERSION:
                raise ValueError(
                    f"park frame must be version >= {PARK_VERSION}, "
                    f"got {header['version']}")
        except (ValueError, TypeError, KeyError) as e:
            with self._lock:
                self._counters["corrupt_rejects"] += 1
            if self._metrics is not None:
                self._metrics.park_corrupt_rejects.inc()
            logger.warning(f"fleet: park frame for session {session_key!r} "
                           f"refused at validation: {e}")
            return False
        tier = (header.get("extra") or {}).get("tier") or {}
        entry = ParkedSession(bytes(payload), list(header["tokens"]),
                              int(header["seen_tokens"]),
                              tier.get("source"), replica_id)
        with self._lock:
            old = self._sessions.pop(session_key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._sessions[session_key] = entry
            self._bytes += entry.nbytes
            self._counters["parks"] += 1
            self._evict_locked()
        if self._metrics is not None:
            self._metrics.parks.inc()
        self._update_gauges()
        return True

    def _evict_locked(self) -> None:
        """Enforce TTL, the session cap and the byte budget (caller holds the
        lock). Oldest-touch first — the OrderedDict IS the LRU order."""
        now = time.monotonic()
        ttl = self._config.ttl_s
        evicted = 0
        if ttl > 0:
            for key in [k for k, e in self._sessions.items()
                        if now - e.last_touch_s > ttl]:
                self._bytes -= self._sessions.pop(key).nbytes
                evicted += 1
        while self._sessions and (
                len(self._sessions) > self._config.max_sessions
                or self._bytes > self._config.max_bytes):
            _, entry = self._sessions.popitem(last=False)
            self._bytes -= entry.nbytes
            evicted += 1
        if evicted:
            self._counters["evictions"] += evicted
            if self._metrics is not None:
                self._metrics.park_evictions.inc(evicted)

    # ------------------------------------------------------------- rehydrate --
    def match(self, session_key: str, prompt) -> Optional[ParkedSession]:
        """The parked session for ``session_key`` iff the new turn's
        ``prompt`` strictly extends its token history (same predicate the
        rehydrating scheduler enforces — a non-matching dispatch would only
        bounce). A diverged prompt drops the entry: histories never
        re-converge, so keeping it would miss every future turn too."""
        prompt = [int(t) for t in prompt]
        with self._lock:
            entry = self._sessions.get(session_key)
            if entry is None:
                return None
            now = time.monotonic()
            ttl = self._config.ttl_s
            if ttl > 0 and now - entry.last_touch_s > ttl:
                self._bytes -= self._sessions.pop(session_key).nbytes
                self._counters["evictions"] += 1
                self._counters["rehydrate_misses"] += 1
                miss_reason = "expired"
            elif not (len(prompt) > len(entry.tokens)
                      and prompt[:len(entry.tokens)] == entry.tokens):
                # diverged (or not longer): unusable now and forever
                self._bytes -= self._sessions.pop(session_key).nbytes
                self._counters["rehydrate_misses"] += 1
                miss_reason = "diverged"
            else:
                entry.last_touch_s = now
                self._sessions.move_to_end(session_key)
                self._counters["rehydrate_hits"] += 1
                miss_reason = None
        if miss_reason is not None:
            if self._metrics is not None:
                self._metrics.park_rehydrate_misses.inc()
            logger.info(f"fleet: parked session {session_key!r} miss "
                        f"({miss_reason})")
            self._update_gauges()
            return None
        if self._metrics is not None:
            self._metrics.park_rehydrates.inc()
        return entry

    def reject(self, session_key: str) -> None:
        """A rehydrating replica refused this session's frame (CRC/framing —
        corruption in transit or at rest): drop it and count the reject; the
        caller falls back to a cold full-prompt run."""
        with self._lock:
            entry = self._sessions.pop(session_key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
            self._counters["corrupt_rejects"] += 1
        if self._metrics is not None:
            self._metrics.park_corrupt_rejects.inc()
        self._update_gauges()

    def drop(self, session_key: str) -> None:
        with self._lock:
            entry = self._sessions.pop(session_key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
        self._update_gauges()

    # ----------------------------------------------------------------- stats --
    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _update_gauges(self) -> None:
        if self._metrics is None:
            return
        with self._lock:
            n, b = len(self._sessions), self._bytes
        self._metrics.park_sessions.set(n)
        self._metrics.park_bytes.set(b)

    def stats(self) -> dict:
        """``/v1/fleet/stats`` park block: occupancy plus the counter set and
        a bounded per-session inventory."""
        with self._lock:
            sessions = [{"session": key, "tokens": len(e.tokens),
                         "bytes": e.nbytes, "tier_source": e.tier_source,
                         "parked_by": e.replica_id,
                         "age_s": round(time.monotonic() - e.parked_at_s, 3)}
                        for key, e in list(self._sessions.items())[-32:]]
            return {"sessions": len(self._sessions), "bytes": self._bytes,
                    "max_sessions": self._config.max_sessions,
                    "max_bytes": self._config.max_bytes,
                    "ttl_s": self._config.ttl_s,
                    **dict(self._counters),
                    "inventory": sessions}
