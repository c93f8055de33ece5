"""Fleet telemetry on the unified registry (``deepspeed_tpu_torch/telemetry``).

Same zero-cost-when-disabled contract as ``serving/metrics.py``:
``FleetMetrics.maybe_create()`` returns None unless a telemetry session is
active, and every router/manager/policy call site is guarded by that None
check — the disabled hot path performs no registry work.

Port of ``deepspeed_tpu/fleet/metrics.py`` (host Python, unchanged in behaviour
except where noted).
"""

from typing import Optional

# handoff payloads are KV-block dumps: kilobytes for a tiny test model,
# hundreds of megabytes for a real one — spread the decades accordingly
_HANDOFF_BUCKETS = (1 << 10, 16 << 10, 256 << 10, 1 << 20, 16 << 20,
                    256 << 20, 1 << 30)


class FleetMetrics:
    """The fleet-layer metric family; one instance per router/manager pair."""

    def __init__(self, registry):
        self.replicas = registry.gauge(
            "fleet_replicas", "Live (non-DOWN) replicas registered with the manager")
        self.queue_depth = registry.gauge(
            "fleet_queue_depth", "Fleet-wide queued requests at the last probe sweep")
        self.kv_pressure = registry.gauge(
            "fleet_kv_pressure", "Mean replica KV-pool occupancy (1 - free/capacity)")
        self.requests = registry.counter(
            "fleet_requests_total", "Client requests accepted by the router")
        self.retries = registry.counter(
            "fleet_dispatch_retries_total",
            "Dispatch attempts that failed over to another replica")
        self.failures = registry.counter(
            "fleet_routing_failures_total",
            "Requests that exhausted every candidate replica")
        self.handoffs = registry.counter(
            "fleet_handoffs_total", "Prefill→decode KV-block handoffs completed")
        self.handoff_bytes = registry.histogram(
            "fleet_handoff_bytes", "KV-handoff payload size",
            buckets=_HANDOFF_BUCKETS)
        self.scale_ups = registry.counter(
            "fleet_scale_ups_total", "Autoscaler replica additions")
        self.scale_downs = registry.counter(
            "fleet_scale_downs_total", "Autoscaler replica drains")
        self.breaker_opens = registry.counter(
            "fleet_breaker_opens_total",
            "Circuit-breaker transitions into OPEN (replica taken out of dispatch)")
        self.breaker_closes = registry.counter(
            "fleet_breaker_closes_total",
            "Circuit-breaker recoveries (HALF_OPEN trial succeeded, CLOSED again)")
        self.breaker_open_replicas = registry.gauge(
            "fleet_breaker_open_replicas",
            "Replicas currently behind an OPEN breaker")
        self.breaker_short_circuits = registry.counter(
            "fleet_breaker_short_circuits_total",
            "Dispatch candidates skipped because their breaker was open")
        self.restarts = registry.counter(
            "fleet_restarts_total", "Supervised replica restarts after a crash/hang")
        self.quarantines = registry.counter(
            "fleet_restart_quarantines_total",
            "Supervised replicas quarantined after exhausting the crash-loop budget")
        self.degraded = registry.counter(
            "fleet_degraded_requests_total",
            "Requests served monolithically because a disaggregated pool was "
            "entirely unavailable")
        self.faults_injected = registry.counter(
            "fleet_faults_injected_total",
            "Faults injected by the chaos harness (all points)")
        # router global queue (fleet/global_queue.py)
        self.global_queue_depth = registry.gauge(
            "fleet_global_queue_depth",
            "Requests (and chaos phantoms) waiting in the router global queue")
        self.global_queue_wait = registry.histogram(
            "fleet_global_queue_wait_seconds",
            "Queue wait from router admission to replica grant")
        self.global_queue_grants = registry.counter(
            "fleet_global_queue_grants_total",
            "Pull-dispatch grants issued (a replica slot freed and took work)")
        self.global_queue_expired = registry.counter(
            "fleet_global_queue_expired_total",
            "Entries shed at the router queue: admission estimate or "
            "deadline/wait expiry")
        # hedged dispatch (fleet/router.py)
        self.hedge_dispatches = registry.counter(
            "fleet_hedge_dispatches_total",
            "Hedge legs dispatched after a first-token budget expiry")
        self.hedge_wins = registry.counter(
            "fleet_hedge_wins_total",
            "Hedged requests where the hedge leg produced the stream")
        self.hedge_cancellations = registry.counter(
            "fleet_hedge_cancellations_total",
            "Hedge losers cancelled first-writer-wins (KV freed upstream)")
        self.hedge_demotions = registry.counter(
            "fleet_hedge_slow_demotions_total",
            "Dispatch picks where a slow replica (TTFT EWMA) was demoted")
        self.deadline_stream_cuts = registry.counter(
            "fleet_deadline_stream_cuts_total",
            "Streams cut at the router because the deadline passed mid-decode")
        self.hedge_suppressed = registry.counter(
            "fleet_hedge_suppressed_total",
            "Hedges suppressed by the storm brake (no replica-specific "
            "evidence and the speculative bucket was dry)")
        # fleet data motion (cache-aware routing / zero-copy transport /
        # work stealing)
        self.cache_route_hits = registry.counter(
            "fleet_cache_route_hits_total",
            "Dispatches placed by digest match (the replica advertised the "
            "request's prefix chain)")
        self.cache_route_misses = registry.counter(
            "fleet_cache_route_misses_total",
            "Cache-aware placements that fell back to rendezvous/least-loaded "
            "(no replica advertised a matching prefix)")
        self.peer_fetches = registry.counter(
            "fleet_peer_prefix_fetches_total",
            "Cross-replica prefix-KV fetches that imported blocks (donor "
            "trie → wire frame → local trie)")
        self.peer_fetch_rejects = registry.counter(
            "fleet_peer_prefix_fetch_rejects_total",
            "Peer prefix fetches rejected at import (CRC/geometry/digest "
            "mismatch) and recomputed cold")
        self.kv_transport_bytes = registry.counter(
            "fleet_kv_transport_bytes_total",
            "KV payload bytes moved across replica dispatch interfaces, all "
            "transports (resume bodies, handoff returns, peer/steal frames)")
        self.kv_transport_binary_bytes = registry.counter(
            "fleet_kv_transport_binary_bytes_total",
            "KV payload bytes moved as raw handoff frames (zero-copy wire "
            "transport)")
        self.kv_transport_base64_bytes = registry.counter(
            "fleet_kv_transport_base64_bytes_total",
            "KV payload bytes moved as base64 text (compatibility transport; "
            "encoded size, ~4/3× the raw payload)")
        self.steals = registry.counter(
            "fleet_steals_total",
            "Requests moved off a hot replica by work stealing (re-granted "
            "queued entries and exported mid-decode legs)")
        self.steal_attempts = registry.counter(
            "fleet_steal_attempts_total",
            "Steal probes sent to victim replicas (includes races the victim "
            "won by finishing first)")
        # fleet-parked sessions (fleet/park_store.py): the router-side rung
        # of the tiered KV ladder
        self.park_sessions = registry.gauge(
            "fleet_park_sessions",
            "Sessions currently parked in the router's park store")
        self.park_bytes = registry.gauge(
            "fleet_park_bytes",
            "Bytes of parked KV frames held by the router's park store")
        self.parks = registry.counter(
            "fleet_parks_total",
            "Finished-session KV frames banked in the router's park store")
        self.park_rehydrates = registry.counter(
            "fleet_park_rehydrates_total",
            "Returning turns dispatched as rehydrate legs (parked KV "
            "imported, only the new suffix prefilled)")
        self.park_rehydrate_misses = registry.counter(
            "fleet_park_rehydrate_misses_total",
            "Known parked sessions that could not rehydrate (expired, or "
            "the returning prompt diverged from the parked history)")
        self.park_corrupt_rejects = registry.counter(
            "fleet_park_corrupt_rejects_total",
            "Park frames dropped after a loud CRC/framing reject (at park "
            "validation or by the rehydrating replica; the turn ran cold)")
        self.park_evictions = registry.counter(
            "fleet_park_evictions_total",
            "Parked sessions dropped by the LRU byte/count budget or TTL")
        # fleet observability plane (telemetry/collector.py)
        self.trace_collections = registry.counter(
            "fleet_trace_collections_total",
            "Trace-collector pull rounds across the fleet's span rings")
        self.trace_spans_collected = registry.counter(
            "fleet_trace_spans_collected_total",
            "Spans merged into the fleet trace store (deduped, clock-corrected)")

    @classmethod
    def maybe_create(cls) -> Optional["FleetMetrics"]:
        from deepspeed_tpu_torch import telemetry
        if not telemetry.is_active():
            return None
        return cls(telemetry.get_registry())
