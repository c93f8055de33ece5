"""Elastic agent: supervise a launched gang, detect dead and wedged ranks,
shrink to fit and restart.

Port of ``deepspeed_tpu/elasticity/elastic_agent.py`` (``DSElasticAgent``).
A ``torch.distributed`` process group fixes its membership at
``init_process_group``, so recovery is a restart: the agent spawns one
process a rank, watches their exits and their train-loop heartbeats, and on
a failure tears the whole gang down (SIGTERM, a bounded grace, SIGKILL,
reap), picks a valid world size from the elasticity config (the sizes that
keep the global batch), and relaunches with ``DSTPU_NUM_PROCESSES`` set to
it.

- **Rank watchdog.** A crashed rank is caught by ``poll``; a wedged one
  (alive but stuck, the hung-collective shape) by its stale heartbeat
  (``elasticity/gang.py``, armed by ``gang_dir`` and ``hang_timeout_s``).
  Either way the other ranks are torn down instead of blocking forever in a
  collective.
- **Preemption.** A rank exiting 143 (``TrainingPreempted``: its final
  checkpoint committed) drains the gang: its peers get SIGTERM so their
  preemption handlers run, and the agent exits 143 without counting a crash
  or restarting.
- **Shrink to fit.** ``max_crashes`` crashes inside ``crash_window_s`` at
  one world size mean that world is not viable: the next launch takes the
  largest valid smaller world. Resume is the checkpoint's load at another
  world size (the manifest records the world that wrote it; the engine
  re-partitions on load), and a global ``train_batch_size`` keeps the
  effective batch. When ``capacity_fn`` reports recovered capacity the world
  grows back the same way.
- **Inspectability.** ``gang_state.json`` in the gang dir: per-rank liveness,
  crash history, current and valid worlds, the last shrink.

Restarts are spaced by the fleet's one backoff formula
(``fleet/breaker.backoff_delay``).
"""

import os
import signal
import subprocess
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.elasticity import gang as gang_mod
from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
from deepspeed_tpu_torch.utils.logging import logger

PREEMPT_EXIT_CODE = 143  # TrainingPreempted.EXIT_CODE, without importing the engine


class ElasticAgentError(RuntimeError):
    pass


def _metrics():
    """Gang counter/gauge families; None when telemetry is disabled."""
    from deepspeed_tpu_torch import telemetry
    if not telemetry.is_active():
        return None
    reg = telemetry.get_registry()
    return {
        "crashes": reg.counter("train_gang_crashes_total",
                               "Rank crashes observed by the gang watchdog"),
        "hangs": reg.counter("train_gang_hangs_total",
                             "Wedged ranks detected via stale heartbeat"),
        "teardowns": reg.counter("train_gang_teardowns_total",
                                 "Whole-gang teardowns (SIGTERM-grace-SIGKILL)"),
        "relaunches": reg.counter("train_gang_relaunches_total",
                                  "Gang relaunches by the elastic agent"),
        "shrinks": reg.counter("train_gang_shrinks_total",
                               "Crash-budget shrinks to a smaller world size"),
        "world": reg.gauge("train_gang_world_size",
                           "Current gang world size (processes)"),
    }


def _count(name, value=None):
    m = _metrics()
    if m is None:
        return
    if value is not None:
        m[name].set(value)
    else:
        m[name].inc()


class DSElasticAgent:

    def __init__(self, cmd: List[str], num_processes: int, ds_config: Optional[dict] = None,
                 env: Optional[Dict[str, str]] = None, max_restarts: int = 3,
                 monitor_interval: float = 0.5,
                 capacity_fn: Optional[Callable[[], int]] = None,
                 restart_backoff_base_s: float = 0.0,
                 restart_backoff_cap_s: float = 30.0,
                 restart_jitter_frac: float = 0.1, seed: int = 0,
                 gang_dir: Optional[str] = None,
                 hang_timeout_s: Optional[float] = None,
                 boot_timeout_s: Optional[float] = None,
                 term_grace_s: float = 5.0,
                 max_crashes: int = 0, crash_window_s: float = 300.0):
        """``cmd`` is launched once per process with DSTPU_NUM_PROCESSES /
        DSTPU_PROCESS_ID exported (the contract ``comm.init_distributed``
        reads). ``capacity_fn`` reports how many processes can be spawned for
        the next attempt (defaults to the last world size — a failed process is
        assumed recoverable; pass a probe for real node-loss handling).
        ``restart_backoff_base_s`` > 0 spaces restarts with the fleet's shared
        bounded-jitter ``backoff_delay`` policy (0 = immediate, the legacy
        behavior).

        ``gang_dir`` arms the rank watchdog: it is exported as
        ``DSTPU_GANG_DIR`` (ranks heartbeat from the train loop) and holds
        ``gang_state.json``. ``hang_timeout_s`` is the staleness deadline — a
        rank that has beaten at least once this life and then goes quiet for
        longer, while its process is alive, is *wedged* and the gang is torn
        down (set it above the worst-case step+save+compile time).
        ``boot_timeout_s`` bounds the pre-first-heartbeat window: a launched
        rank that never beats within it (e.g. the whole gang wedged inside
        ``init_process_group``) counts as hung — arming the watchdog
        asserts the children DO heartbeat (the engine does automatically when
        ``DSTPU_GANG_DIR`` is exported). Defaults to
        ``max(10 × hang_timeout_s, 120)`` when the watchdog is armed.
        ``max_crashes`` > 0 arms the shrink budget: that many crashes inside
        ``crash_window_s`` at one world size shrink the next launch to the
        largest valid world strictly below it."""
        self.cmd = list(cmd)
        self.num_processes = int(num_processes)
        self.ds_config = ds_config or {}
        self.env = dict(env if env is not None else os.environ)
        self.max_restarts = int(max_restarts)
        self.monitor_interval = monitor_interval
        self.capacity_fn = capacity_fn
        self.restart_count = 0
        self.restart_backoff_base_s = float(restart_backoff_base_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.restart_jitter_frac = float(restart_jitter_frac)
        self.gang_dir = gang_dir
        self.hang_timeout_s = None if hang_timeout_s is None else float(hang_timeout_s)
        if boot_timeout_s is not None:
            self.boot_timeout_s = float(boot_timeout_s)
        else:
            self.boot_timeout_s = None if self.hang_timeout_s is None \
                else max(10.0 * self.hang_timeout_s, 120.0)
        self._spawned_at = 0.0
        self.term_grace_s = float(term_grace_s)
        self.max_crashes = int(max_crashes)
        self.crash_window_s = float(crash_window_s)
        self.world = self.num_processes
        self.crashes: deque = deque()  # (monotonic, world) window-pruned
        self.events: List[dict] = []   # crash/hang/preempt/shrink history
        self.last_shrink: Optional[dict] = None
        import random as _random
        self._backoff_rng = _random.Random(f"{seed}:elastic_agent")
        self._owns_gang_dir = False
        if self.gang_dir is None and (self.hang_timeout_s is not None
                                      or self.boot_timeout_s is not None):
            import tempfile
            self.gang_dir = tempfile.mkdtemp(prefix="dstpu_gang_")
            self._owns_gang_dir = True  # reaped on clean exit (run())
        # per-agent job nonce: scopes monitored_barrier's file rendezvous so
        # a later gang on the same coordinator never matches our leftovers
        self._job_id = f"agent.{os.getpid()}.{time.time():.0f}"

    # -- world-size policy -------------------------------------------------------
    def next_world_size(self, capacity: int) -> int:
        """Largest elasticity-valid world size ≤ capacity (or capacity itself
        when elasticity is off)."""
        if not self.ds_config.get("elasticity", {}).get("enabled", False):
            if capacity < 1:
                raise ElasticAgentError("no capacity left to restart into")
            return capacity
        _, valid = compute_elastic_config(self.ds_config)
        fitting = [n for n in valid if n <= capacity]
        if not fitting:
            raise ElasticAgentError(
                f"no elasticity-valid world size fits the surviving capacity {capacity} "
                f"(valid: {sorted(valid)[:10]}...)")
        return max(fitting)

    def valid_world_sizes(self) -> List[int]:
        """Every world size a relaunch may land on, for the gang state
        document: the elastic set when elasticity is on (grow-back via
        ``capacity_fn`` may exceed the initial world), [1..initial] when
        off (shrink-only: ``next_world_size`` returns the capacity itself)."""
        if not self.ds_config.get("elasticity", {}).get("enabled", False):
            return list(range(1, self.num_processes + 1))
        _, valid = compute_elastic_config(self.ds_config)
        return sorted(valid)

    # -- process control ---------------------------------------------------------
    def _spawn(self, world_size: int) -> List[subprocess.Popen]:
        if self.gang_dir is not None:
            # one life's staleness must never indict the next life's ranks,
            # and one life's barrier rendezvous files must never satisfy the
            # next life's barriers
            gang_mod.clear_heartbeats(self.gang_dir)
            import shutil
            shutil.rmtree(os.path.join(self.gang_dir, "barriers"),
                          ignore_errors=True)
        procs = []
        for rank in range(world_size):
            env = dict(self.env)
            env["DSTPU_NUM_PROCESSES"] = str(world_size)
            env["DSTPU_PROCESS_ID"] = str(rank)
            env["DSTPU_JOB_ID"] = self._job_id
            env["DSTPU_ELASTIC_RESTART"] = str(self.restart_count)
            # the training chaos injector keys its one-shot kill/sigterm
            # points on this (runtime/faults.first_life) — without it a
            # deterministic kill replays on every relaunch and crash-loops
            env["DSTPU_RESTART_COUNT"] = str(self.restart_count)
            if self.gang_dir is not None:
                env["DSTPU_GANG_DIR"] = self.gang_dir
            procs.append(subprocess.Popen(self.cmd, env=env))
        self._spawned_at = time.monotonic()
        _count("world", world_size)
        return procs

    def _kill(self, procs: List[subprocess.Popen]):
        """Whole-gang teardown with escalation: SIGTERM every survivor (their
        preemption handlers may commit a final checkpoint), give the gang a
        bounded grace, SIGKILL the stragglers, then REAP everything — no
        zombie outlives the teardown."""
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + self.term_grace_s
        for p in procs:
            try:
                p.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        for p in procs:  # reap the SIGKILLed stragglers too
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:  # pragma: no cover - kernel-stuck
                logger.error(f"elastic agent: pid {p.pid} unreapable after SIGKILL")
        _count("teardowns")

    def _stale_ranks(self, procs: List[subprocess.Popen]):
        """Wedged-rank detection, two windows: (a) a rank that has beaten
        this life (``_spawn`` cleared the previous life's files) and then
        went quiet past ``hang_timeout_s``; (b) a rank that NEVER beat within
        ``boot_timeout_s`` of launch — the gang wedged at boot (e.g. inside
        the process-group rendezvous), which exit polling and
        staleness can't see. Returns ``(ranks, detail)`` or ``([], None)``."""
        if self.gang_dir is None or (self.hang_timeout_s is None
                                     and self.boot_timeout_s is None):
            return [], None
        beats = gang_mod.read_heartbeats(self.gang_dir)
        if self.hang_timeout_s is not None:
            stale = [rank for rank, doc in sorted(beats.items())
                     if rank < len(procs) and procs[rank].poll() is None
                     and doc["age_s"] > self.hang_timeout_s]
            if stale:
                return stale, (f"rank(s) {stale} wedged: heartbeat stale "
                               f"> {self.hang_timeout_s:.1f}s with process alive")
        if self.boot_timeout_s is not None and \
                time.monotonic() - self._spawned_at > self.boot_timeout_s:
            unborn = [rank for rank in range(len(procs))
                      if rank not in beats and procs[rank].poll() is None]
            if unborn:
                return unborn, (f"rank(s) {unborn} wedged at boot: no "
                                f"heartbeat within {self.boot_timeout_s:.1f}s "
                                f"of launch")
        return [], None

    def _monitor(self, procs: List[subprocess.Popen]):
        """Watch one gang life. Returns ``("done", None)``, ``("preempt",
        rc)``, ``("crash", detail)`` or ``("hang", detail)``; every non-done
        outcome has already torn the whole gang down."""
        while True:
            codes = [p.poll() for p in procs]
            preempted = [r for r, c in enumerate(codes) if c == PREEMPT_EXIT_CODE]
            if preempted:
                # the preemption contract at gang scope: the rank committed
                # its final checkpoint and exited 143 — drain the peers
                # (SIGTERM runs their preemption handlers) without counting
                # a crash, and surface 143 to the caller
                logger.warning(f"elastic agent: rank(s) {preempted} exited "
                               f"preempted (143); draining the gang")
                self._kill(procs)
                return "preempt", PREEMPT_EXIT_CODE
            crashed = [(r, c) for r, c in enumerate(codes)
                       if c not in (None, 0, PREEMPT_EXIT_CODE)]
            if crashed:
                self._kill(procs)
                _count("crashes")
                return "crash", (f"rank(s) {[r for r, _ in crashed]} exited "
                                 f"{[c for _, c in crashed]}")
            if all(c == 0 for c in codes):
                return "done", None
            stale, detail = self._stale_ranks(procs)
            if stale:
                # the collective-hang signature: a rank (or the peers a dead/
                # stuck one wedged inside a collective) is alive but has made
                # no train-loop progress past the deadline
                self._kill(procs)
                _count("hangs")
                return "hang", detail
            time.sleep(self.monitor_interval)

    # -- state document ----------------------------------------------------------
    def _write_state(self, phase: str, procs: Optional[List[subprocess.Popen]] = None):
        if self.gang_dir is None:
            return
        ranks = {}
        beats = gang_mod.read_heartbeats(self.gang_dir)
        for rank in range(self.world):
            doc = {"alive": None, "exit_code": None}
            if procs is not None and rank < len(procs):
                rc = procs[rank].poll()
                doc = {"alive": rc is None, "exit_code": rc,
                       "pid": procs[rank].pid}
            doc["heartbeat"] = beats.get(rank)
            ranks[str(rank)] = doc
        try:
            gang_mod.write_gang_state(self.gang_dir, {
                "phase": phase,
                "world": self.world,
                "initial_world": self.num_processes,
                "valid_worlds": self.valid_world_sizes(),
                "restart_count": self.restart_count,
                "max_restarts": self.max_restarts,
                "crashes_in_window": len(self.crashes),
                "max_crashes": self.max_crashes,
                "crash_window_s": self.crash_window_s,
                "hang_timeout_s": self.hang_timeout_s,
                "last_shrink": self.last_shrink,
                "events": self.events[-50:],
                "ranks": ranks,
            })
        except OSError:  # state reporting must never kill supervision
            pass

    def _record_event(self, kind: str, detail) -> None:
        self.events.append({"kind": kind, "world": self.world,
                            "life": self.restart_count,
                            "detail": detail, "unix": time.time()})

    # -- main loop ---------------------------------------------------------------
    def _next_world_after_failure(self) -> int:
        """Crash-budget shrink-to-fit: inside the budget, relaunch at the
        capacity the probe reports (same world by default — and a recovered
        capacity GROWS the world back); budget exhausted at this world means
        it is not viable — shrink to the largest valid world strictly below
        it and start a fresh window there."""
        now = time.monotonic()
        while self.crashes and now - self.crashes[0][0] > self.crash_window_s:
            self.crashes.popleft()
        capacity = self.capacity_fn() if self.capacity_fn is not None else self.world
        budget_spent = self.max_crashes > 0 and len(
            [1 for _, w in self.crashes if w == self.world]) >= self.max_crashes
        if budget_spent:
            if self.world <= 1:
                raise ElasticAgentError(
                    f"crash budget exhausted at world_size=1 "
                    f"({self.max_crashes} crashes in {self.crash_window_s:.0f}s) "
                    f"— no smaller world to shrink to")
            capacity = min(capacity, self.world - 1)
            new_world = self.next_world_size(capacity)
            self.last_shrink = {"from": self.world, "to": new_world,
                                "crashes": len(self.crashes),
                                "life": self.restart_count, "unix": time.time()}
            self._record_event("shrink", self.last_shrink)
            self.crashes.clear()  # fresh budget at the new world
            _count("shrinks")
            logger.warning(f"elastic agent: crash budget exhausted at "
                           f"world_size={self.world} ({self.max_crashes} in "
                           f"{self.crash_window_s:.0f}s); shrinking to "
                           f"{new_world} (resume = checkpoint reshard-on-load)")
            return new_world
        return self.next_world_size(capacity)

    def run(self) -> int:
        self.world = self.num_processes
        while True:
            logger.info(f"elastic agent: launching world_size={self.world} "
                        f"(attempt {self.restart_count + 1})")
            procs = self._spawn(self.world)
            self._write_state("running", procs)
            outcome, detail = self._monitor(procs)
            if outcome == "done":
                self._record_event("done", None)
                self._write_state("done", procs)
                logger.info("elastic agent: job finished cleanly")
                if self._owns_gang_dir:
                    # auto-created tempdir: nothing left to inspect after a
                    # clean finish (failures keep it for dstpu_report --gang)
                    import shutil
                    shutil.rmtree(self.gang_dir, ignore_errors=True)
                return 0
            if outcome == "preempt":
                self._record_event("preempt", detail)
                self._write_state("preempted", procs)
                logger.warning("elastic agent: gang preempted (final "
                               "checkpoint committed); exiting 143 without "
                               "counting a crash")
                return PREEMPT_EXIT_CODE
            # crash or hang: both consume the restart + crash budgets
            self._record_event(outcome, detail)
            self.crashes.append((time.monotonic(), self.world))
            logger.warning(f"elastic agent: gang failure ({outcome}): {detail}")
            self.restart_count += 1
            if self.restart_count > self.max_restarts:
                self._write_state("failed", procs)
                raise ElasticAgentError(f"job failed after {self.max_restarts} restarts")
            try:
                self.world = self._next_world_after_failure()
            except ElasticAgentError:
                # no world to restart into (budget spent at world=1, or no
                # valid size fits the capacity): terminal — the state doc
                # must say so, not read as a live gang forever
                self._write_state("failed", procs)
                raise
            _count("relaunches")
            delay = 0.0
            if self.restart_backoff_base_s > 0.0:
                # the fleet's one backoff formula (fleet/breaker.backoff_delay):
                # exponential, capped, bounded jitter, deterministic in seed
                from deepspeed_tpu_torch.fleet.breaker import backoff_delay
                delay = backoff_delay(self.restart_count - 1,
                                      self.restart_backoff_base_s,
                                      self.restart_backoff_cap_s,
                                      self.restart_jitter_frac,
                                      self._backoff_rng.random())
            logger.warning(f"elastic agent: restarting with "
                           f"world_size={self.world}"
                           f"{f', backoff {delay:.2f}s' if delay else ''}")
            self._write_state("backoff", procs)
            if delay:
                time.sleep(delay)
