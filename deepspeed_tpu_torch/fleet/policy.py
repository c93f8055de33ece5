"""Elastic scaling policy for a fleet pool.

The elasticity subsystem's contract is restart-shaped: recovery and resizing
go through ``compute_elastic_config`` — the set of *valid* world sizes — and a
capacity probe (``DSElasticAgent.capacity_fn``). The fleet autoscaler reuses
both signals at the replica granularity: a pool grows one step on sustained
saturation (mean queued-requests-per-replica or KV-pool pressure over
threshold for ``sustain_ticks`` consecutive observations) and shrinks one step
after ``scale_down_idle_ticks`` fully-idle observations, with targets clamped
to ``[min_replicas, max_replicas]``, snapped to the elasticity-valid sizes
when a ``ds_config`` with an elasticity block is supplied, and bounded by
``capacity_fn`` (how many replicas the substrate can actually host).

One autoscaler manages one role's pool — run one per role for a disaggregated
fleet (the prefill pool saturates on queue depth / TTFT demand, the decode
pool on KV pressure / ITL demand; scaling them independently is the point of
disaggregation). Every scale event increments ``fleet_scale_ups_total`` /
``fleet_scale_downs_total`` and records a ``fleet``-category span, so scale
history is visible in the same Perfetto timeline as the requests that caused
it.

``step()`` is the whole policy (observe → decide → act), callable from tests
or an external control loop; ``start()`` runs it every ``interval_s`` on a
daemon thread when ``config.enabled``.

Port of ``deepspeed_tpu/fleet/policy.py`` (host Python, unchanged in behaviour
except where noted).
"""

import threading
from typing import Callable, List, Optional

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.fleet.config import AutoscaleConfig
from deepspeed_tpu_torch.fleet.metrics import FleetMetrics
from deepspeed_tpu_torch.telemetry import new_span_id, new_trace_id, now_us
from deepspeed_tpu_torch.utils.logging import logger


class FleetAutoscaler:
    """Grow/shrink one role's replica pool on sustained load signals."""

    def __init__(self, manager, config: Optional[AutoscaleConfig] = None,
                 role: Optional[str] = None,
                 ds_config: Optional[dict] = None,
                 capacity_fn: Optional[Callable[[], int]] = None):
        """``manager`` is the :class:`~deepspeed_tpu_torch.fleet.manager.ReplicaManager`
        whose ``add_local``/``drain`` this policy drives. ``ds_config`` with an
        ``elasticity`` block snaps pool sizes to the elasticity-valid set
        (``compute_elastic_config``), mirroring the elastic agent's world-size
        policy; ``capacity_fn`` reports how many replicas the substrate can
        host right now (the agent's probe contract — defaults to unlimited)."""
        self._manager = manager
        self._config = config or manager.config.autoscale
        self._role = role if role is not None else self._config.role
        self._ds_config = ds_config
        self._capacity_fn = capacity_fn
        self._metrics = FleetMetrics.maybe_create()
        self._saturated_ticks = 0
        self._idle_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- signals --
    def observe(self) -> dict:
        """One observation of the managed pool: size, mean queued-per-replica,
        mean KV pressure (1 - free/capacity), and whether the pool is fully
        idle. Probes are refreshed through the manager (bounded staleness),
        which also pushes the fleet-wide gauges."""
        self._manager.sweep_probes(max_age_s=min(self._config.interval_s,
                                                 self._manager.config.probe_ttl_s))
        pool = self._manager.replicas(role=self._role, available_only=True)
        probes = [r.probe(max_age_s=self._config.interval_s) for r in pool]
        live = [p for p in probes if p.get("healthy")]
        n = len(live)
        queued = sum(int(p.get("queue_depth", 0)) for p in live)
        active = sum(int(p.get("active", 0)) for p in live)
        pressure = (sum(1.0 - float(p.get("kv_free_frac", 1.0)) for p in live) / n
                    if n else 0.0)
        return {
            "replicas": len(pool),
            "healthy": n,
            "queued": queued,
            "active": active,
            # replicas registered but none answering probes = saturated (scale
            # UP), not idle — queued is summed over healthy probes only, so
            # it cannot distinguish the two
            "queue_per_replica": queued / n if n else float("inf") if pool else 0.0,
            "kv_pressure": pressure,
        }

    def _valid_sizes(self) -> Optional[List[int]]:
        """The elasticity-valid pool sizes, or None when unconstrained
        (no ds_config / elasticity disabled) — the elastic agent's
        ``next_world_size`` signal at replica granularity."""
        if not (self._ds_config or {}).get("elasticity", {}).get("enabled", False):
            return None
        from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
        _, valid = compute_elastic_config(self._ds_config)[:2]
        return sorted(valid)

    def _next_size(self, current: int, direction: int) -> Optional[int]:
        """The pool size one step up (+1) or down (-1) from ``current``,
        honoring [min, max] bounds, the elasticity-valid set, and (for
        scale-up) the substrate capacity. None = no legal move."""
        cfg = self._config
        valid = self._valid_sizes()
        if valid is None:
            target = current + direction
        elif direction > 0:
            bigger = [v for v in valid if v > current]
            target = min(bigger) if bigger else None
        else:
            smaller = [v for v in valid if v < current]
            target = max(smaller) if smaller else None
        if target is None:
            return None
        # scale-up is bounded by max only (a step from below min TOWARD min —
        # replacing a quarantined member — is legal); scale-down by min only
        if direction > 0 and target > cfg.max_replicas:
            return None
        if direction < 0 and target < cfg.min_replicas:
            return None
        if direction > 0 and self._capacity_fn is not None \
                and target > self._capacity_fn():
            return None
        return target

    # ----------------------------------------------------------------- policy --
    def step(self) -> Optional[str]:
        """One observe→decide→act tick. Returns ``"up"``/``"down"`` when a
        scale event fired, None otherwise."""
        cfg = self._config
        obs = self.observe()
        # below the floor — a drained/quarantined member left a hole
        # (QUARANTINED counts as *absent*, not unhealthy-but-live, so a
        # crash-looper is replaced instead of oscillated around): replace
        # immediately, no sustain window. A supervised slot mid-restart
        # (STARTING/BACKOFF) is capacity already in flight, not a hole —
        # filling it too would overshoot the pool on every crash.
        pending = self._manager.pending_replicas(role=self._role)
        if obs["replicas"] + pending < cfg.min_replicas:
            target = self._next_size(obs["replicas"], +1)
            if target is not None:
                self._scale_up(obs, target)
                self._saturated_ticks = 0
                return "up"
        saturated = (obs["queue_per_replica"] >= cfg.scale_up_queue_depth
                     or obs["kv_pressure"] >= cfg.scale_up_kv_pressure)
        slo_breach = False
        if cfg.slo_scale_up:
            # config-gated: an open SLO breach episode counts as saturation —
            # the budget is burning even if queue/KV look fine this tick
            engine = telemetry.get_slo_engine()
            slo_breach = engine is not None and engine.in_breach()
            saturated = saturated or slo_breach
        idle = (obs["healthy"] > 0 and obs["queued"] == 0 and obs["active"] == 0
                and obs["kv_pressure"] < cfg.scale_up_kv_pressure
                and not slo_breach)
        self._saturated_ticks = self._saturated_ticks + 1 if saturated else 0
        self._idle_ticks = self._idle_ticks + 1 if idle else 0

        if self._saturated_ticks >= cfg.sustain_ticks:
            target = self._next_size(obs["replicas"], +1)
            if target is not None:
                self._scale_up(obs, target)
                self._saturated_ticks = 0
                return "up"
        elif self._idle_ticks >= cfg.scale_down_idle_ticks:
            target = self._next_size(obs["replicas"], -1)
            if target is not None:
                self._scale_down(obs, target)
                self._idle_ticks = 0
                return "down"
        return None

    def _scale_up(self, obs: dict, target: int) -> None:
        added = []
        for _ in range(target - obs["replicas"]):
            added.append(self._manager.add_local(role=self._role).id)
            if self._metrics:
                self._metrics.scale_ups.inc()
        logger.info(f"fleet autoscaler[{self._role}]: {obs['replicas']} -> "
                    f"{target} replicas (queue/replica="
                    f"{obs['queue_per_replica']:.1f}, kv={obs['kv_pressure']:.2f})")
        self._record_span("fleet_scale_up", obs, target, added)

    def _scale_down(self, obs: dict, target: int) -> None:
        # drain the least-loaded members: minimal in-flight disruption, and
        # the drain itself is graceful (bounded by config.drain_timeout_s)
        pool = sorted(self._manager.replicas(role=self._role, available_only=True),
                      key=lambda r: (r.load, r.id))
        drained = []
        for replica in pool[:obs["replicas"] - target]:
            self._manager.drain(replica.id)
            drained.append(replica.id)
            if self._metrics:
                self._metrics.scale_downs.inc()
        logger.info(f"fleet autoscaler[{self._role}]: {obs['replicas']} -> "
                    f"{target} replicas (idle {self._idle_ticks} ticks)")
        self._record_span("fleet_scale_down", obs, target, drained)

    def _record_span(self, name: str, obs: dict, target: int, ids: List[str]) -> None:
        spans = telemetry.get_span_recorder()
        if spans is None:
            return
        spans.record(name, cat="fleet", ts_us=now_us(),
                     trace_id=new_trace_id(), span_id=new_span_id(),
                     args={"role": self._role, "from": obs["replicas"],
                           "to": target, "replicas": ids,
                           "queue_per_replica": round(obs["queue_per_replica"], 3),
                           "kv_pressure": round(obs["kv_pressure"], 3)})

    # ------------------------------------------------------------------- loop --
    def start(self) -> "FleetAutoscaler":
        """Run :meth:`step` every ``interval_s`` on a daemon thread — a no-op
        unless ``config.enabled`` (the operator's off-switch; manual
        :meth:`step` keeps working either way)."""
        if not self._config.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"dstpu-fleet-autoscaler-{self._role}",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._config.interval_s):
            try:
                self.step()
            except Exception:  # pragma: no cover - the loop must survive a
                # probe/scale hiccup; the next tick re-observes from scratch
                logger.exception(f"fleet autoscaler[{self._role}]: step failed")

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
