"""Replica manager: the fleet's registry and lifecycle authority.

Owns the set of replicas the router dispatches over — in-process
:class:`LocalReplica` pairs built from an ``engine_factory`` (the
CPU-testable mode) and/or :class:`HttpReplica` upstreams pointing at external
``serving/server.py`` processes. The autoscaler (``fleet/policy.py``) grows
and shrinks pools through the same ``add_local``/``drain`` calls an operator
would use.

Per-role pools implement the prefill/decode disaggregation topology: a
replica's role (``mixed`` | ``prefill`` | ``decode``) is fixed at
registration; the router picks the pool per request leg.

Port of ``deepspeed_tpu/fleet/manager.py`` (host Python, unchanged in behaviour
except where noted).
"""

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.fleet.breaker import BreakerState, CircuitBreaker
from deepspeed_tpu_torch.fleet.config import FleetConfig
from deepspeed_tpu_torch.fleet.metrics import FleetMetrics
from deepspeed_tpu_torch.fleet.replica import (HttpReplica, LocalReplica, Replica,
                                               ReplicaState)
from deepspeed_tpu_torch.serving import ServingConfig
from deepspeed_tpu_torch.utils.logging import logger

# states that count as absent capacity: never probed, never pooled, never in
# the fleet_replicas gauge — only visible as stats rows
_ABSENT_STATES = (ReplicaState.DOWN, ReplicaState.QUARANTINED)


class ReplicaManager:
    """Registry + lifecycle for a fleet of replicas.

    ``engine_factory`` is a zero-arg callable returning a fresh
    ``InferenceEngineV2`` (identical KV geometry across calls — the handoff
    transport validates it); required only when ``add_local`` is used.
    """

    def __init__(self, engine_factory: Optional[Callable] = None,
                 config: Optional[FleetConfig] = None,
                 serving_config: Optional[ServingConfig] = None):
        self._engine_factory = engine_factory
        self._config = config or FleetConfig()
        self._serving_config = serving_config
        self._metrics = FleetMetrics.maybe_create()
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._supervisor = None  # ReplicaSupervisor attaches itself (stats)
        # the router shares its FaultInjector here so manager-installed hooks
        # (peer prefix fetch) consult the same chaos schedule as dispatch
        self.faults = None

    @property
    def config(self) -> FleetConfig:
        return self._config

    # ---------------------------------------------------------------- add --
    def add_local(self, role: str = "mixed",
                  replica_id: Optional[str] = None) -> LocalReplica:
        """Build one in-process replica (engine + scheduler) and register it."""
        if self._engine_factory is None:
            raise ValueError("ReplicaManager needs an engine_factory for add_local")
        engine = self._engine_factory()
        replica = LocalReplica(engine, role=role,
                               serving_config=self._role_serving_config(role),
                               replica_id=replica_id)
        return self._register(replica)

    def _role_serving_config(self, role: str) -> Optional[ServingConfig]:
        """The serving config a fleet-built replica of ``role`` runs with.
        ``FleetConfig.prefix_cache`` (when enabled) is authoritative per role:
        roles in ``prefix_cache_roles`` get the fleet's cache block, every
        other role runs with the cache off — prefill-pool replicas reuse
        shared prompts while decode-pool replicas, which only import
        handed-off KV, skip the trie entirely."""
        base = self._serving_config
        if self._config.overload is not None:
            # the fleet's overload block is authoritative for every
            # fleet-built replica: brownout stages and admission estimates
            # must agree across the pool, or the router's global queue sees
            # replicas disagreeing on what "overloaded" means
            base = dataclasses.replace(base or ServingConfig(), overload=self._config.overload)
        fleet_spec = self._config.speculative
        if fleet_spec is not None:
            # same authority rule as the prefix cache: listed roles get the
            # fleet's speculative block, the others run with drafting off
            if role in self._config.speculative_roles:
                base = dataclasses.replace(base or ServingConfig(), speculative=fleet_spec)
            elif base is not None and base.speculative.enabled:
                from deepspeed_tpu_torch.serving.config import SpeculativeConfig
                base = dataclasses.replace(base, speculative=SpeculativeConfig())
        fleet_pc = self._config.prefix_cache
        if not fleet_pc.enabled:
            return base
        if role in self._config.prefix_cache_roles:
            return dataclasses.replace(base or ServingConfig(), prefix_cache=fleet_pc)
        if base is not None and base.prefix_cache.enabled:
            from deepspeed_tpu_torch.serving.config import PrefixCacheConfig
            return dataclasses.replace(base, prefix_cache=PrefixCacheConfig())
        return base

    def add_upstream(self, url: str, role: str = "mixed",
                     replica_id: Optional[str] = None) -> HttpReplica:
        """Register an external ``serving/server.py`` process by URL."""
        replica = HttpReplica(url, role=role, replica_id=replica_id,
                              timeout_s=self._config.request_timeout_s,
                              connect_timeout_s=self._config.connect_timeout_s,
                              read_timeout_s=self._config.read_timeout_s)
        return self._register(replica)

    def add(self, replica: Replica) -> Replica:
        """Register an externally-constructed replica (custom
        :class:`~deepspeed_tpu_torch.fleet.replica.Replica` subclasses)."""
        return self._register(replica)

    def _register(self, replica: Replica) -> Replica:
        if replica.breaker is None:
            replica.breaker = CircuitBreaker(
                self._config.breaker,
                on_transition=self._make_breaker_observer(replica))
        replica.probe_backoff_cap_s = self._config.probe_backoff_cap_s
        replica.probe_jitter_frac = self._config.retry_jitter_frac
        replica.probe_backoff_base_s = max(self._config.probe_ttl_s, 0.25)
        replica.fleet_metrics = self._metrics
        if isinstance(replica, HttpReplica):
            # the fleet-wide transport policy; "base64" is the zero-copy
            # gate's control arm (per-replica 400 fallback still applies)
            replica.binary_transport = self._config.kv_transport == "binary"
        if (isinstance(replica, LocalReplica)
                and self._config.cache_route.enabled
                and self._config.cache_route.peer_fetch):
            self._install_peer_fetch(replica)
        if isinstance(replica, LocalReplica):
            self._install_demote_race(replica)
        with self._lock:
            if replica.id in self._replicas:
                replica.drain(timeout=0.0)
                raise ValueError(f"replica id {replica.id} already registered")
            self._replicas[replica.id] = replica
        logger.info(f"fleet: replica {replica.id} (role={replica.role}) registered")
        self._update_gauges()
        return replica

    def _install_peer_fetch(self, replica: LocalReplica) -> None:
        """Give one local replica's scheduler the fleet view it needs to pull
        a deeper cached prefix from a peer instead of recomputing it.

        The installed hook runs on *that replica's scheduler thread* at
        admission: it matches the request's digest chain against every
        available peer's probe-published catalog (truncated hex — a routing
        hint; the donor re-matches full digests), picks the deepest holder,
        and fetches the frame over the replica's own transport. Donor-side
        export and importer-side validation both carry short timeouts, so two
        replicas fetching from each other degrade to cold prefills rather
        than deadlocking their loops."""
        from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import DIGEST_HEX
        cfg = self._config.cache_route

        def peer_fetch(digests, have):
            chain = [d.hex()[:DIGEST_HEX] for d in digests]
            best, best_depth = None, max(have, cfg.min_match_blocks - 1)
            for peer in self.replicas(available_only=True):
                if peer.id == replica.id:
                    continue
                doc = peer._probe_doc
                if doc is None:
                    doc = peer.probe(max_age_s=self._config.probe_ttl_s)
                catalog = doc.get("prefix_digests")
                if not catalog:
                    continue
                catset = set(catalog)
                depth = 0
                for i, h in enumerate(chain):
                    # membership of the i-th chain digest means the peer
                    # holds the first i+1 blocks (chained digests); the
                    # catalog may omit intermediates under its size limit,
                    # so the deepest member wins, no consecutiveness needed
                    if h in catset:
                        depth = i + 1
                if depth > best_depth:
                    best, best_depth = peer, depth
            if best is None:
                return None
            payload = best.fetch_prefix(digests, min_blocks=have + 1,
                                        timeout=cfg.fetch_timeout_s)
            if payload is None:
                return None
            faults = self.faults
            if faults is not None:
                idx = faults.fire("peer_fetch_corrupt", best.id)
                if idx is not None:
                    payload = faults.corrupt(payload, idx, best.id,
                                             point="peer_fetch_corrupt")
            return payload

        def notify(outcome):
            if self._metrics is None:
                return
            if outcome == "hit":
                self._metrics.peer_fetches.inc()
            else:
                self._metrics.peer_fetch_rejects.inc()

        replica.scheduler._peer_fetch = peer_fetch
        replica.scheduler._peer_fetch_notify = notify

    def _install_demote_race(self, replica: LocalReplica) -> None:
        """Arm the ``demote_race`` chaos point on this replica's tiered KV
        store: when the schedule fires, a read is injected into the tier
        writer's spill-to-commit window — the deterministic version of a
        request touching a sequence mid-demotion. The store must reclaim the
        entry to host and the writer must discard its orphan spill file
        (``TieredKVStore`` counts it as a ``demote_race``). The hook closes
        over ``self.faults`` so it consults whatever injector the router
        armed, and is a no-op (one None check) when chaos is off."""
        try:
            store = replica.engine._state_manager.kv_cache.tiered_store
        except AttributeError:
            return  # an engine without the tiered store has nothing to race

        def race_hook(handle):
            faults = self.faults
            if faults is None:
                return
            if faults.fire("demote_race", replica.id) is None:
                return
            if self._metrics is not None:
                self._metrics.faults_injected.inc()
            try:
                # reading inside the window wins the race: the entry reclaims
                # to host and the writer's commit re-check unlinks its orphan
                store.read(handle)
            except KeyError:  # dropped between fire and read: nothing to race
                pass

        store.race_hook = race_hook

    def _make_breaker_observer(self, replica: Replica):
        """Breaker transitions land in the ``fleet_breaker_*`` metrics and the
        serving log — an operator must see open/close cycles without a
        debugger attached."""

        def observe(breaker, old, new):
            logger.warning(f"fleet: breaker[{replica.id}] {old.name} -> {new.name}")
            if self._metrics:
                if new is BreakerState.OPEN:
                    self._metrics.breaker_opens.inc()
                elif old is BreakerState.HALF_OPEN and new is BreakerState.CLOSED:
                    self._metrics.breaker_closes.inc()
                self._metrics.breaker_open_replicas.set(sum(
                    1 for r in self.replicas()
                    if r.breaker is not None
                    and r.breaker.state is BreakerState.OPEN))

        return observe

    # --------------------------------------------------------------- query --
    def get(self, replica_id: str) -> Replica:
        with self._lock:
            return self._replicas[replica_id]

    def replicas(self, role: Optional[str] = None,
                 available_only: bool = False) -> List[Replica]:
        """Snapshot of registered replicas, optionally one role's pool.
        ``available_only`` drops DRAINING/DOWN members (the router's view)."""
        with self._lock:
            out = list(self._replicas.values())
        if role is not None:
            out = [r for r in out if r.role == role]
        if available_only:
            out = [r for r in out if r.available]
        return out

    def pool_size(self, role: Optional[str] = None) -> int:
        return len(self.replicas(role=role, available_only=True))

    def pending_replicas(self, role: Optional[str] = None) -> int:
        """Replicas a supervisor is actively bringing (back) up — STARTING or
        in restart BACKOFF. Capacity in flight: the autoscaler must not
        double-fill a hole whose restart is already scheduled (only a
        QUARANTINED slot is a durable hole)."""
        if self._supervisor is None:
            return 0
        from deepspeed_tpu_torch.fleet.supervisor import SlotState
        return sum(1 for slot in self._supervisor.slots()
                   if (role is None or slot.role == role)
                   and slot.state in (SlotState.STARTING, SlotState.BACKOFF))

    # --------------------------------------------------------------- drain --
    def drain(self, replica_id: str, timeout: Optional[float] = None,
              remove: bool = True) -> None:
        """Gracefully drain one replica: out of rotation immediately,
        in-flight requests get up to ``timeout`` (default
        ``config.drain_timeout_s``) to finish. ``remove`` deregisters it."""
        replica = self.get(replica_id)
        replica.drain(timeout=timeout if timeout is not None
                      else self._config.drain_timeout_s)
        if remove:
            with self._lock:
                self._replicas.pop(replica_id, None)
        logger.info(f"fleet: replica {replica_id} drained")
        self._update_gauges()

    def remove(self, replica_id: str) -> Optional[Replica]:
        """Deregister without drain — the supervisor's dead-replica path (the
        process is already gone; there is nothing to drain)."""
        with self._lock:
            replica = self._replicas.pop(replica_id, None)
        if replica is not None:
            self._update_gauges()
        return replica

    def drain_all(self, timeout: Optional[float] = None) -> None:
        """Fleet-wide graceful drain (reverse registration order), used by
        ``FleetRouter.stop()``."""
        for replica in reversed(self.replicas()):
            self.drain(replica.id, timeout=timeout, remove=False)

    def close(self) -> None:
        """Hard stop: drain with a zero budget and deregister everything."""
        for replica in reversed(self.replicas()):
            replica.drain(timeout=0.0)
        with self._lock:
            self._replicas.clear()
        self._update_gauges()

    # --------------------------------------------------------------- stats --
    def _update_gauges(self) -> None:
        if self._metrics:
            # a QUARANTINED (crash-looping) replica is absent capacity — the
            # autoscaler must see a hole to fill, not an unhealthy-but-live
            # member to oscillate around
            self._metrics.replicas.set(
                sum(1 for r in self.replicas() if r.state not in _ABSENT_STATES))

    def sweep_probes(self, max_age_s: Optional[float] = None) -> List[dict]:
        """Refresh every live replica's probe (bounded staleness) and push the
        fleet-wide queue-depth / KV-pressure gauges; returns the probe docs.
        DOWN/QUARANTINED replicas are skipped — absent capacity is not probed
        (a quarantined process's socket would eat a connect timeout per sweep
        for a replica that is by definition not coming back on its own).
        The router calls this per dispatch pick; the autoscaler per tick."""
        ttl = self._config.probe_ttl_s if max_age_s is None else max_age_s
        probes = [r.probe(max_age_s=ttl) for r in self.replicas()
                  if r.state not in _ABSENT_STATES]
        live = [p for p in probes if p.get("healthy")]
        if self._metrics:
            self._metrics.queue_depth.set(sum(p["queue_depth"] for p in live))
            # no live replicas means no occupancy — resetting (not freezing at
            # the last live value) keeps the gauge honest after the final
            # member is drained, quarantined or removed
            self._metrics.kv_pressure.set(
                sum(1.0 - p.get("kv_free_frac", 1.0) for p in live) / len(live)
                if live else 0.0)
        return probes

    def stats(self) -> dict:
        """/v1/fleet/stats body: per-replica rows (quarantined ones included —
        surfacing persistent crashers is the point), per-role pool sizes, and
        the supervisor's slot table when one is attached."""
        replicas = self.replicas()
        roles: Dict[str, int] = {}
        for r in replicas:
            if r.available:
                roles[r.role] = roles.get(r.role, 0) + 1
        kv_wire: Dict[str, int] = {}
        for r in replicas:
            for transport, n in r.kv_wire_bytes.items():
                kv_wire[transport] = kv_wire.get(transport, 0) + n
        doc = {"replicas": [r.describe() for r in replicas], "roles": roles,
               "quarantined": sum(1 for r in replicas
                                  if r.state is ReplicaState.QUARANTINED),
               "kv_wire_bytes": kv_wire}
        if self._supervisor is not None:
            doc["supervisor"] = self._supervisor.describe()
        return doc
