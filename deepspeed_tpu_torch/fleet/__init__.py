"""Fleet serving: N load-balanced replicas behind one router.

The serving layer (``deepspeed_tpu_torch/serving``) operates ONE engine; this
package is the horizontal layer above it — the PAPER §2.9 disaggregation idea
promoted from MoE experts to whole engine roles:

- :class:`ReplicaManager` — registry + lifecycle for the replica set:
  in-process ``(InferenceEngineV2 + ServingScheduler)`` pairs (CPU-testable) and/or external ``serving/server.py`` processes by URL.
- :class:`FleetRouter` — stdlib-HTTP front-end speaking the single-replica
  wire format: session-affinity rendezvous hashing, health/backpressure-aware
  least-loaded dispatch, retry-on-503 failover, fleet-wide graceful drain.
- Prefill/decode disaggregation: replicas are role-tagged; when both pools
  exist a request prefills (plus first token) on a ``prefill`` replica and its
  KV hands off — a portable bytes payload (``inference/v2/ragged/handoff.py``)
  — to a ``decode`` replica, so TTFT and ITL capacity scale independently.
  ``empty_run`` heartbeats keep idle pool members warm.
- :class:`FleetAutoscaler` — sustained queue-depth / KV-pressure policy loop
  that grows and drains pools through the manager, reusing the elasticity
  subsystem's valid-size / capacity signals.
- Fault tolerance: :class:`ReplicaSupervisor` (``fleet/supervisor.py``) owns
  replica lifecycle — spawn (``python -m deepspeed_tpu_torch.bin.dstpu_replica`` processes or in-process
  replicas), ``/healthz``-gated registration, exit/hang detection, backoff
  restarts, crash-loop quarantine; every replica carries a
  :class:`CircuitBreaker` (``fleet/breaker.py``) fed by probes and dispatch
  outcomes; :class:`FaultInjector` (``fleet/faults.py``) drives every
  recovery path deterministically from a seed.

Usage::

    from deepspeed_tpu_torch.fleet import FleetConfig, FleetRouter, ReplicaManager

    manager = ReplicaManager(engine_factory=make_engine, config=FleetConfig())
    for _ in range(2):
        manager.add_local(role="prefill")
        manager.add_local(role="decode")
    router = FleetRouter(manager).start()   # same wire format as ServingServer
    ...                                     # POST router.url + "/v1/generate"
    router.stop()                           # graceful fleet-wide drain

Port of ``deepspeed_tpu/fleet``: host Python over the port's engine, scheduler
and handoff frames.
"""

from deepspeed_tpu_torch.fleet.breaker import (BreakerConfig, BreakerState,
                                               CircuitBreaker, backoff_delay)
from deepspeed_tpu_torch.fleet.config import (AutoscaleConfig, FleetConfig,
                                              GlobalQueueConfig, HedgeConfig,
                                              ParkConfig, ReplicaRole,
                                              SupervisorConfig)
from deepspeed_tpu_torch.fleet.faults import FaultConfig, FaultInjector
from deepspeed_tpu_torch.fleet.global_queue import (GlobalQueue, GlobalQueueFull,
                                                    QueueWaitExpired)
from deepspeed_tpu_torch.fleet.manager import ReplicaManager
from deepspeed_tpu_torch.fleet.park_store import ParkedSession, ParkStore
from deepspeed_tpu_torch.fleet.metrics import FleetMetrics
from deepspeed_tpu_torch.fleet.policy import FleetAutoscaler
from deepspeed_tpu_torch.fleet.replica import (HttpReplica, Leg, LocalReplica, Replica,
                                               ReplicaDied, ReplicaState,
                                               ReplicaUnavailable)
from deepspeed_tpu_torch.fleet.router import FleetRouter, RoutedRequest, RoutingError
from deepspeed_tpu_torch.fleet.supervisor import ReplicaSlot, ReplicaSupervisor, SlotState

__all__ = [
    "AutoscaleConfig", "BreakerConfig", "BreakerState", "CircuitBreaker",
    "FaultConfig", "FaultInjector", "FleetConfig", "GlobalQueue",
    "GlobalQueueConfig", "GlobalQueueFull", "HedgeConfig", "ParkConfig",
    "ParkStore", "ParkedSession", "QueueWaitExpired", "ReplicaRole",
    "SupervisorConfig", "ReplicaManager", "FleetMetrics", "FleetAutoscaler",
    "HttpReplica", "Leg", "LocalReplica", "Replica", "ReplicaDied",
    "ReplicaState", "ReplicaUnavailable", "FleetRouter", "RoutedRequest",
    "RoutingError", "ReplicaSlot", "ReplicaSupervisor", "SlotState",
    "backoff_delay",
]
