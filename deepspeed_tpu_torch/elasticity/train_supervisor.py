"""Training-job supervision: restart a crashed training process with bounded
backoff, resume it from the latest good checkpoint, quarantine crash loops.

Port of ``deepspeed_tpu/elasticity/train_supervisor.py``.

The training-side sibling of the serving fleet's ``ReplicaSupervisor``
(``fleet/supervisor.py``), sharing the same vocabulary deliberately: the one
``fleet/breaker.backoff_delay`` formula spaces restarts (exponential, capped,
bounded jitter — deterministic in ``seed`` so chaos runs replay the same
schedule), and the same crash-window budget (``max_crashes`` crashes inside
``crash_window_s``) turns a persistent crasher into a QUARANTINE (the
supervisor gives up loudly with the child's exit code) instead of burning the
cluster on respawns forever.

Contract with the child (what ``bin/dstpu_train`` wraps):

- the child is the resume authority: on start it calls
  ``engine.load_checkpoint(ckpt_dir)`` — empty dir = fresh start, newest
  verified-good tag otherwise (torn/corrupt tags are skipped loudly by the
  checkpoint engine), so "restart" IS "resume";
- ``DSTPU_RESTART_COUNT`` is exported (0 on the first life) — the training
  chaos injector keys its one-shot kill/sigterm points on it, and training
  scripts can use it to vary logging;
- ``DSTPU_CKPT_DIR`` is exported when the supervisor was given one;
- exit code 0 = done; exit code 143 (``TrainingPreempted.EXIT_CODE``) = the
  child's preemption handler wrote its final checkpoint — the supervisor
  exits with 143 rather than restarting (``restart_on_preempt`` overrides,
  for environments where capacity returns under the same process);
- any other exit = crash → backoff → restart.

SIGTERM/SIGINT to the supervisor forwards SIGTERM to the child (triggering
its preemption handler), waits ``grace_s`` for the final checkpoint to
commit, then SIGKILLs and exits with the child's code — the supervisor never
restarts after an operator/preemptor stop.
"""

import os
import random
import signal
import subprocess
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deepspeed_tpu_torch.fleet.breaker import backoff_delay
from deepspeed_tpu_torch.utils.logging import logger

PREEMPT_EXIT_CODE = 143  # TrainingPreempted.EXIT_CODE, without importing the engine


def _metrics():
    from deepspeed_tpu_torch import telemetry
    if not telemetry.is_active():
        return None
    return telemetry.get_registry().counter(
        "train_restarts_total",
        "Training process restarts by the supervisor after a crash")


class TrainSupervisor:
    """Supervise ONE training command with restart-on-crash + resume."""

    def __init__(self, cmd: List[str], env: Optional[Dict[str, str]] = None,
                 ckpt_dir: Optional[str] = None,
                 max_crashes: int = 3, crash_window_s: float = 300.0,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 backoff_multiplier: float = 2.0, jitter_frac: float = 0.1,
                 seed: int = 0, grace_s: float = 30.0,
                 restart_on_preempt: bool = False,
                 preempt_exit_code: int = PREEMPT_EXIT_CODE,
                 monitor_interval_s: float = 0.05):
        self.cmd = list(cmd)
        self.env = dict(env if env is not None else os.environ)
        self.ckpt_dir = ckpt_dir
        self.max_crashes = int(max_crashes)
        self.crash_window_s = float(crash_window_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self.jitter_frac = float(jitter_frac)
        self.grace_s = float(grace_s)
        self.restart_on_preempt = bool(restart_on_preempt)
        self.preempt_exit_code = int(preempt_exit_code)
        self.monitor_interval_s = float(monitor_interval_s)
        self.restarts = 0
        self.crashes: deque = deque()  # monotonic timestamps, window-pruned
        self.quarantined = False
        self._rng = random.Random(f"{seed}:train_supervisor")
        self._term_evt = threading.Event()
        self._term_sig: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None

    # ------------------------------------------------------------- signals --
    def request_stop(self, signum: int = signal.SIGTERM) -> None:
        """Operator/preemptor stop (also the signal handler's body): forward
        SIGTERM to the child so its preemption handler runs; ``run`` then
        waits ``grace_s`` and exits without restarting."""
        self._term_sig = signum
        self._term_evt.set()

    def _install_handlers(self) -> None:
        def on_sig(signum, frame):
            self.request_stop(signum)
        try:
            signal.signal(signal.SIGTERM, on_sig)
            signal.signal(signal.SIGINT, on_sig)
        except ValueError:
            # not the main thread (tests drive request_stop directly)
            pass

    # ----------------------------------------------------------------- run --
    def _spawn(self) -> subprocess.Popen:
        env = dict(self.env)
        env["DSTPU_RESTART_COUNT"] = str(self.restarts)
        env["DSTPU_SUPERVISED"] = "1"
        if self.ckpt_dir:
            env.setdefault("DSTPU_CKPT_DIR", self.ckpt_dir)
        return subprocess.Popen(self.cmd, env=env)

    def _wait_child(self, proc: subprocess.Popen) -> int:
        """Poll the child; on a stop request forward SIGTERM, give the
        preemption handler ``grace_s`` to commit its final checkpoint, then
        SIGKILL. Returns the child's exit code."""
        forwarded_at = None
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            if self._term_evt.is_set():
                now = time.monotonic()
                if forwarded_at is None:
                    forwarded_at = now
                    logger.warning(f"train supervisor: stop requested "
                                   f"(signal {self._term_sig}); forwarding "
                                   f"SIGTERM, grace {self.grace_s:.0f}s")
                    proc.send_signal(signal.SIGTERM)
                elif now - forwarded_at > self.grace_s:
                    logger.error("train supervisor: grace budget exhausted; "
                                 "killing the child")
                    proc.kill()
                    return proc.wait()
            time.sleep(self.monitor_interval_s)

    @staticmethod
    def _exit_code(rc: int) -> int:
        """Popen reports signal deaths as negative; map to the shell's
        128+signum convention so run()'s return value is a real exit code
        (sys.exit(-9) would otherwise read as status 247)."""
        return 128 - rc if rc < 0 else rc

    def run(self) -> int:
        self._install_handlers()
        while True:
            life = self.restarts
            logger.info(f"train supervisor: launching (life {life}, "
                        f"cmd={self.cmd[0]}...)")
            self._proc = proc = self._spawn()
            rc = self._exit_code(self._wait_child(proc))
            if self._term_evt.is_set():
                logger.warning(f"train supervisor: stopped after operator/"
                               f"preemption signal (child rc={rc})")
                return rc
            if rc == 0:
                logger.info("train supervisor: training finished cleanly")
                return 0
            if rc == self.preempt_exit_code and not self.restart_on_preempt:
                logger.warning(f"train supervisor: child exited preempted "
                               f"(rc={rc}, final checkpoint committed); not "
                               f"restarting (restart_on_preempt=False)")
                return rc
            now = time.monotonic()
            self.crashes.append(now)
            while self.crashes and now - self.crashes[0] > self.crash_window_s:
                self.crashes.popleft()
            if len(self.crashes) >= self.max_crashes:
                # crash loop: quarantine — give up loudly with the child's rc
                self.quarantined = True
                logger.error(f"train supervisor: QUARANTINED after "
                             f"{len(self.crashes)} crashes in "
                             f"{self.crash_window_s:.0f}s (last rc={rc}); "
                             f"not restarting")
                return rc
            self.restarts += 1
            m = _metrics()
            if m is not None:
                m.inc()
            delay = backoff_delay(len(self.crashes) - 1, self.backoff_base_s,
                                  self.backoff_cap_s, self.jitter_frac,
                                  self._rng.random(),
                                  multiplier=self.backoff_multiplier)
            logger.warning(f"train supervisor: child crashed (rc={rc}); "
                           f"restart #{self.restarts} in {delay:.2f}s "
                           f"(resume from latest good checkpoint)")
            # interruptible sleep: a stop request during backoff exits
            if self._term_evt.wait(delay):
                logger.warning("train supervisor: stopped during backoff")
                return rc

    def describe(self) -> dict:
        return {"restarts": self.restarts,
                "crashes_in_window": len(self.crashes),
                "quarantined": self.quarantined,
                "ckpt_dir": self.ckpt_dir}
