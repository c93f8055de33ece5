"""Replica process supervision: the fleet owns its replicas' lifecycle.

Before this module, upstream replicas were operator-managed: nothing ever
restarted a crashed process, and a dead upstream was only discovered by the
probe TTL. The :class:`ReplicaSupervisor` closes that loop — the serving-side
sibling of the elasticity subsystem's elastic agent (which owns *training*
worker lifecycle): it spawns replicas itself, gates their registration on
``/healthz`` readiness, detects exits and hangs, restarts with exponential
backoff, and quarantines persistent crashers instead of respawning them
forever.

A supervised replica lives in a :class:`ReplicaSlot` — a stable identity
(replica id, role) that survives restarts — backed by one of two launch
strategies behind the same lifecycle:

- **process-backed** (:meth:`ReplicaSupervisor.add_process`): a real replica
  server subprocess (``python -m deepspeed_tpu_torch.bin.dstpu_replica``, or any command
  speaking the ``serving/server.py`` wire format + a ``--port-file``
  announcement); exit detection is ``proc.poll()``, hang detection is
  consecutive failed probes, restart is respawn.
- **local-backed** (:meth:`ReplicaSupervisor.add_local`): an in-process
  ``LocalReplica`` built from the manager's engine factory — the
  CPU-testable formulation the chaos harness drives (a "kill" is the
  scheduler's abrupt-death disposition; a "restart" is a fresh engine).

Slot lifecycle::

    STARTING --spawn+ready--> READY --exit/hang--> BACKOFF --delay--> STARTING
                                 \\                    \\
                                  \\            (crash budget exhausted)
                                   \\-------------> QUARANTINED --reset()--> STARTING

Readiness gate: a spawned replica is registered with the manager (and thus
dispatchable) only after a healthy ``/healthz`` probe; a replica that never
becomes ready within ``ready_timeout_s`` counts as a crash. Crash-looping —
``max_crashes`` crashes inside ``crash_window_s`` — quarantines the slot: the
dead replica stays visible in ``/v1/fleet/stats`` as ``QUARANTINED`` (absent
capacity: never probed, never dispatched, a hole the autoscaler fills) until
an operator ``reset()``.

Watchdog reuse: the monitor loop heartbeats the telemetry flight recorder
(``fleet_supervisor`` channel) and registers a state provider, so a wedged
supervisor is itself detected and every crash dump carries the slot table.

Port of ``deepspeed_tpu/fleet/supervisor.py`` (host Python, unchanged in behaviour
except where noted).
"""

import itertools
import os
import subprocess
import tempfile
import threading
import time
from collections import deque
from enum import Enum
from typing import Dict, List, Optional

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.fleet.breaker import backoff_delay
from deepspeed_tpu_torch.fleet.config import SupervisorConfig
from deepspeed_tpu_torch.fleet.metrics import FleetMetrics
from deepspeed_tpu_torch.fleet.replica import (HttpReplica, LocalReplica,
                                               QuarantinedReplica, Replica,
                                               ReplicaState)
from deepspeed_tpu_torch.telemetry import new_span_id, new_trace_id, now_us
from deepspeed_tpu_torch.utils.logging import logger

_SUPERVISOR_IDS = itertools.count()
_SLOT_IDS = itertools.count()

# flight-recorder heartbeat channel prefix (one per supervisor instance)
FLEET_SUPERVISOR_CHANNEL = "fleet_supervisor"


class SlotState(Enum):
    STARTING = 0
    READY = 1
    BACKOFF = 2
    QUARANTINED = 3
    STOPPED = 4


class _LocalBackend:
    """In-process replica slot: spawn = build a fresh engine + scheduler."""

    kind = "local"

    def __init__(self, engine_factory, serving_config):
        self._engine_factory = engine_factory
        self._serving_config = serving_config

    def spawn(self, slot: "ReplicaSlot") -> Replica:
        return LocalReplica(self._engine_factory(), role=slot.role,
                            serving_config=self._serving_config,
                            replica_id=slot.id)

    def alive(self, replica: Replica) -> bool:
        return replica.state is not ReplicaState.DOWN

    def kill(self, replica: Optional[Replica]) -> None:
        if replica is not None and hasattr(replica, "kill"):
            replica.kill("supervisor kill")

    def describe(self) -> dict:
        return {"kind": self.kind}


class _ProcessReplica(HttpReplica):
    """An HttpReplica whose process the supervisor owns (kill() is real)."""

    def __init__(self, url: str, proc: subprocess.Popen, **kwargs):
        super().__init__(url, **kwargs)
        self.proc = proc

    def kill(self, reason: str = "supervisor kill") -> None:
        if self.proc.poll() is None:
            logger.warning(f"fleet: killing replica process {self.id} "
                           f"(pid {self.proc.pid}): {reason}")
            self.proc.kill()
        self.state = ReplicaState.DOWN

    def describe(self) -> dict:
        doc = super().describe()
        doc["pid"] = self.proc.pid
        doc["exit_code"] = self.proc.poll()
        return doc


class _ProcessBackend:
    """Subprocess replica slot speaking the serving wire format.

    ``command`` is an argv list; a ``{port_file}`` token is substituted with
    a fresh path the child must write ``"<host> <port>\\n"`` to once its
    listener is bound (``deepspeed_tpu_torch.bin.dstpu_replica --port-file`` does). Without the
    token, ``url`` must be given (fixed-port commands)."""

    kind = "process"

    def __init__(self, command: List[str], config: SupervisorConfig,
                 url: Optional[str] = None, cwd: Optional[str] = None,
                 env: Optional[dict] = None,
                 connect_timeout_s: float = 5.0, read_timeout_s: float = 30.0,
                 request_timeout_s: float = 120.0):
        self.command = list(command)
        self._config = config
        self._url = url
        self._cwd = cwd
        self._env = env
        self._timeouts = dict(connect_timeout_s=connect_timeout_s,
                              read_timeout_s=read_timeout_s,
                              timeout_s=request_timeout_s)
        if url is None and not any("{port_file}" in tok for tok in command):
            raise ValueError("process command needs a {port_file} token "
                             "(ephemeral port) or an explicit url")

    def spawn(self, slot: "ReplicaSlot") -> Replica:
        port_file = None
        argv = self.command
        if self._url is None:
            fd, port_file = tempfile.mkstemp(prefix=f"dstpu_{slot.id}_",
                                             suffix=".port")
            os.close(fd)
            os.unlink(port_file)  # the child writes it atomically
            argv = [tok.format(port_file=port_file) for tok in self.command]
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        proc = subprocess.Popen(argv, cwd=self._cwd, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        url = self._url
        if url is None:
            deadline = time.monotonic() + self._config.ready_timeout_s
            try:
                while True:
                    if proc.poll() is not None:
                        raise RuntimeError(f"replica process exited rc="
                                           f"{proc.returncode} before announcing "
                                           f"its port")
                    if os.path.exists(port_file):
                        with open(port_file) as f:
                            content = f.read().split()
                        if len(content) == 2:
                            url = f"http://{content[0]}:{content[1]}"
                            break
                    if time.monotonic() > deadline:
                        proc.kill()
                        raise RuntimeError(
                            f"replica process never announced its port within "
                            f"{self._config.ready_timeout_s}s")
                    time.sleep(0.05)
            finally:
                if os.path.exists(port_file):
                    os.unlink(port_file)
        return _ProcessReplica(url, proc, role=slot.role, replica_id=slot.id,
                               **self._timeouts)

    def alive(self, replica: Replica) -> bool:
        return replica.proc.poll() is None

    def kill(self, replica: Optional[Replica]) -> None:
        if replica is not None:
            replica.kill()

    def describe(self) -> dict:
        return {"kind": self.kind, "command": self.command}


class ReplicaSlot:
    """One supervised replica identity: spawn history, crash budget, backoff
    schedule. All mutation happens on the supervisor's monitor thread."""

    def __init__(self, slot_id: str, role: str, backend, rng_seed: int):
        self.id = slot_id
        self.role = role
        self.backend = backend
        self.state = SlotState.STARTING
        self.replica: Optional[Replica] = None
        self.restarts = 0            # successful respawns after a crash
        self.spawned_once = False
        self.crashes: deque = deque()  # monotonic timestamps, window-pruned
        self.next_restart_s = 0.0
        self.last_error: Optional[str] = None
        self.probe_fails = 0         # consecutive FRESH failed probes (READY)
        self._last_probe_at = -1.0   # freshness watermark (replica._probe_at)
        self._ready_evt = threading.Event()
        # deterministic per-slot jitter stream (chaos-run reproducibility)
        import random as _random
        self._rng = _random.Random(f"{rng_seed}:{slot_id}")

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until this slot's replica is registered and dispatchable
        (False on timeout or quarantine)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.state is SlotState.READY:
                return True
            if self.state in (SlotState.QUARANTINED, SlotState.STOPPED):
                return False
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            self._ready_evt.wait(0.05 if remaining is None
                                 else min(remaining, 0.05))

    def describe(self) -> dict:
        doc = {"id": self.id, "role": self.role, "state": self.state.name,
               "restarts": self.restarts,
               "crashes_in_window": len(self.crashes),
               "last_error": self.last_error}
        doc.update(self.backend.describe())
        if self.state is SlotState.BACKOFF:
            doc["restart_in_s"] = round(
                max(0.0, self.next_restart_s - time.monotonic()), 3)
        return doc


class ReplicaSupervisor:
    """Spawns, readiness-gates, watches, restarts and quarantines the
    replicas of a :class:`~deepspeed_tpu_torch.fleet.manager.ReplicaManager`."""

    def __init__(self, manager, config: Optional[SupervisorConfig] = None):
        self._manager = manager
        self._config = config or manager.config.supervisor
        self._metrics = FleetMetrics.maybe_create()
        self._slots: Dict[str, ReplicaSlot] = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flight = None
        self._flight_channel = (f"{FLEET_SUPERVISOR_CHANNEL}:"
                                f"{next(_SUPERVISOR_IDS)}")
        manager._supervisor = self  # /v1/fleet/stats surfacing

    # ------------------------------------------------------------------ slots --
    def add_local(self, role: str = "mixed",
                  slot_id: Optional[str] = None) -> ReplicaSlot:
        """Supervise an in-process replica built from the manager's engine
        factory (the CPU-testable formulation)."""
        if self._manager._engine_factory is None:
            raise ValueError("ReplicaSupervisor.add_local needs the manager's "
                             "engine_factory")
        backend = _LocalBackend(self._manager._engine_factory,
                                self._manager._serving_config)
        return self._add_slot(role, slot_id, backend)

    def add_process(self, command: List[str], role: str = "mixed",
                    slot_id: Optional[str] = None, url: Optional[str] = None,
                    cwd: Optional[str] = None,
                    env: Optional[dict] = None) -> ReplicaSlot:
        """Supervise a replica server subprocess (``deepspeed_tpu_torch.bin.dstpu_replica`` or any
        command speaking the serving wire format; see
        :class:`_ProcessBackend` for the ``{port_file}`` protocol)."""
        fleet_cfg = self._manager.config
        backend = _ProcessBackend(
            command, self._config, url=url, cwd=cwd, env=env,
            connect_timeout_s=fleet_cfg.connect_timeout_s,
            read_timeout_s=fleet_cfg.read_timeout_s,
            request_timeout_s=fleet_cfg.request_timeout_s)
        return self._add_slot(role, slot_id, backend)

    def _add_slot(self, role: str, slot_id: Optional[str], backend) -> ReplicaSlot:
        slot = ReplicaSlot(slot_id or f"sup-{role}-{next(_SLOT_IDS)}", role,
                           backend, self._config.seed)
        with self._lock:
            if slot.id in self._slots:
                raise ValueError(f"slot id {slot.id} already supervised")
            self._slots[slot.id] = slot
        logger.info(f"fleet supervisor: slot {slot.id} (role={role}, "
                    f"{backend.kind}) added")
        return slot

    def slots(self) -> List[ReplicaSlot]:
        with self._lock:
            return list(self._slots.values())

    def reset(self, slot_id: str) -> None:
        """Operator un-quarantine: clear the crash history and relaunch."""
        slot = self._slots[slot_id]
        slot.crashes.clear()
        slot.last_error = None
        if slot.state is SlotState.QUARANTINED:
            self._manager.remove(slot.id)  # drop the quarantined placeholder
            slot.state = SlotState.STARTING
            logger.info(f"fleet supervisor: slot {slot.id} reset from quarantine")

    # ------------------------------------------------------------------- loop --
    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="dstpu-fleet-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def _attach_flight(self, flight) -> None:
        """Reuse the flight recorder's heartbeat watchdog + provider registry
        (same contract as the serving scheduler): a wedged supervisor loop is
        detected, and every crash dump carries the slot table."""
        old = self._flight
        if old is flight:
            return
        if old is not None:
            old.unwatch_heartbeat(self._flight_channel)
            old.unregister_provider(self._flight_channel)
        self._flight = flight
        if flight is not None:
            flight.register_provider(self._flight_channel, self.describe)
            flight.watch_heartbeat(self._flight_channel)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self._config.poll_interval_s):
            flight = telemetry.get_flight_recorder()
            if flight is not self._flight:
                self._attach_flight(flight)
            if flight is not None:
                flight.heartbeat(self._flight_channel)
            for slot in self.slots():
                try:
                    self._tend(slot)
                except Exception:  # pragma: no cover - one slot's trouble
                    # must not starve the others of supervision
                    logger.exception(f"fleet supervisor: tending {slot.id} failed")

    def _tend(self, slot: ReplicaSlot) -> None:
        now = time.monotonic()
        if slot.state is SlotState.STARTING:
            self._launch(slot)
        elif slot.state is SlotState.BACKOFF:
            if now >= slot.next_restart_s:
                self._launch(slot)
        elif slot.state is SlotState.READY:
            replica = slot.replica
            if not slot.backend.alive(replica):
                self._on_crash(slot, "process exited" if slot.backend.kind ==
                               "process" else "replica died")
                return
            # hang detection: a READY replica that stops answering probes
            # (but whose process is alive) is killed and restarted. Only a
            # FRESH probe counts — the failed-probe backoff in Replica.probe
            # serves the cached failure doc between real attempts, and
            # counting the same stale observation N times would declare a
            # hang after one real failure
            probe = replica.probe(max_age_s=self._config.poll_interval_s)
            fresh = replica._probe_at != slot._last_probe_at
            slot._last_probe_at = replica._probe_at
            if probe.get("draining"):
                slot.probe_fails = 0  # an operator drain is not a hang
            elif probe.get("healthy"):
                slot.probe_fails = 0
                if slot.crashes and now - slot.crashes[-1] > self._config.crash_window_s:
                    slot.crashes.clear()  # stable again: forgive old crashes
            elif fresh:
                slot.probe_fails += 1
                if slot.probe_fails >= self._config.probe_hang_failures:
                    slot.backend.kill(replica)
                    self._on_crash(slot, f"hung: {slot.probe_fails} consecutive "
                                   f"failed probes")

    # ----------------------------------------------------------------- launch --
    def _launch(self, slot: ReplicaSlot) -> None:
        """Spawn + readiness gate + register. Blocking on the monitor thread
        (replica launches are serialized — the readiness poll sleeps in small
        slices so stop() stays responsive)."""
        cfg = self._config
        restarting = slot.spawned_once
        slot.state = SlotState.STARTING
        replica = None
        try:
            replica = slot.backend.spawn(slot)
            slot.spawned_once = True
            deadline = time.monotonic() + cfg.ready_timeout_s
            while True:
                if self._stop_evt.is_set():
                    slot.backend.kill(replica)
                    slot.state = SlotState.STOPPED
                    return
                if not slot.backend.alive(replica):
                    raise RuntimeError("replica died during readiness gate")
                # the gate is actively waiting on a booting replica: keep the
                # poll tight rather than letting connection-refused probes
                # back the re-probe interval off to seconds
                replica._probe_fails = 0
                probe = replica.probe(max_age_s=0.0)
                if probe.get("healthy"):
                    break
                if time.monotonic() > deadline:
                    slot.backend.kill(replica)
                    raise RuntimeError(f"replica not ready within "
                                       f"{cfg.ready_timeout_s}s "
                                       f"({probe.get('error') or 'unhealthy'})")
                time.sleep(min(cfg.poll_interval_s, 0.1))
        except Exception as e:
            slot.backend.kill(replica)
            self._on_crash(slot, f"launch failed: {e}")
            return
        # readiness gate passed: NOW the replica becomes dispatchable
        self._manager.add(replica)
        slot.replica = replica
        slot.probe_fails = 0
        slot.state = SlotState.READY
        slot._ready_evt.set()
        if restarting:
            slot.restarts += 1
            if self._metrics:
                self._metrics.restarts.inc()
            self._record_span("fleet_restart", slot)
        logger.info(f"fleet supervisor: slot {slot.id} "
                    f"{'restarted' if restarting else 'ready'} "
                    f"(replica {replica.id})")

    # ------------------------------------------------------------------ crash --
    def _on_crash(self, slot: ReplicaSlot, reason: str) -> None:
        cfg = self._config
        now = time.monotonic()
        slot.last_error = reason
        slot._ready_evt.clear()
        replica, slot.replica = slot.replica, None
        if replica is not None:
            slot.backend.kill(replica)     # best-effort; usually already dead
            self._manager.remove(slot.id)  # out of dispatch immediately
            replica.drain(timeout=0.0)     # local: free engine; http: mark DOWN
        slot.crashes.append(now)
        while slot.crashes and now - slot.crashes[0] > cfg.crash_window_s:
            slot.crashes.popleft()
        if len(slot.crashes) >= cfg.max_crashes:
            # crash loop: quarantine — visible in stats, absent as capacity,
            # never silently respawned forever
            slot.state = SlotState.QUARANTINED
            placeholder = replica if replica is not None else QuarantinedReplica(
                role=slot.role, replica_id=slot.id)
            placeholder.state = ReplicaState.QUARANTINED
            try:
                self._manager.add(placeholder)
            except ValueError:  # pragma: no cover - already registered
                pass
            if self._metrics:
                self._metrics.quarantines.inc()
            self._record_span("fleet_quarantine", slot)
            logger.error(f"fleet supervisor: slot {slot.id} QUARANTINED after "
                         f"{len(slot.crashes)} crashes in "
                         f"{cfg.crash_window_s}s ({reason})")
            return
        delay = backoff_delay(len(slot.crashes) - 1, cfg.restart_backoff_base_s,
                              cfg.restart_backoff_cap_s,
                              cfg.restart_jitter_frac, slot._rng.random(),
                              multiplier=cfg.restart_backoff_multiplier)
        slot.next_restart_s = now + delay
        slot.state = SlotState.BACKOFF
        logger.warning(f"fleet supervisor: slot {slot.id} crashed ({reason}); "
                       f"restart #{len(slot.crashes)} in {delay:.2f}s")

    def _record_span(self, name: str, slot: ReplicaSlot) -> None:
        spans = telemetry.get_span_recorder()
        if spans is None:
            return
        spans.record(name, cat="fleet", ts_us=now_us(),
                     trace_id=new_trace_id(), span_id=new_span_id(),
                     args={"slot": slot.id, "role": slot.role,
                           "restarts": slot.restarts,
                           "crashes_in_window": len(slot.crashes),
                           "reason": slot.last_error})

    # ------------------------------------------------------------------- admin --
    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until every slot is READY (False if any timed out or
        quarantined) — the bring-up barrier before opening the router."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        for slot in self.slots():
            remaining = None if deadline is None else max(0.0, deadline
                                                          - time.monotonic())
            ok &= slot.wait_ready(remaining)
        return ok

    def describe(self) -> dict:
        slots = self.slots()
        return {"slots": [s.describe() for s in slots],
                "restarts": sum(s.restarts for s in slots),
                "quarantined": sum(1 for s in slots
                                   if s.state is SlotState.QUARANTINED)}

    def stop(self) -> None:
        """Stop supervising and terminate owned processes. Registered
        replicas stay in the manager (the router's drain handles them);
        a stopped supervisor never respawns."""
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        for slot in self.slots():
            if slot.state is not SlotState.QUARANTINED:
                slot.state = SlotState.STOPPED
            if slot.replica is not None and slot.backend.kind == "process":
                proc = slot.replica.proc
                if proc.poll() is None:
                    proc.terminate()
        # bounded reap so no zombie outlives the supervisor
        deadline = time.monotonic() + 5.0
        for slot in self.slots():
            if slot.replica is not None and slot.backend.kind == "process":
                proc = slot.replica.proc
                while proc.poll() is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                if proc.poll() is None:
                    proc.kill()
        self._attach_flight(None)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
