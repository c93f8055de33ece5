"""Deterministic fault injection for the training path.

Port of ``deepspeed_tpu/runtime/faults.py``. A fault is a pure function of
``(seed, point, index)``: the same seed gives the same schedule
(:meth:`TrainFaultInjector.would_fire` is the replayable oracle), and the
step points key on the global step, so a resumed run sees the schedule an
uninterrupted one would.

Injection points:

- ``kill_at_step``: SIGKILL the process after a global step;
- ``sigterm_at_step``: SIGTERM after a global step (the engine's preemption
  handler: drain, final checkpoint, resume marker, exit);
- ``nan_inject``: poison the step's batch with a NaN (the anomaly sentinel's
  skip-step and rollback);
- ``checkpoint_corrupt``: flip a byte of a just-committed checkpoint's
  largest sealed file (CRC mismatch, loud fallback);
- ``checkpoint_truncate``: delete a just-committed checkpoint's manifest
  (torn commit, loud fallback).

Kill and SIGTERM fire on the first life only (``only_first_life``): the
supervisor exports ``DSTPU_RESTART_COUNT``, and a deterministic kill replayed
after a resume would loop forever.

Armed only by the ``DSTPU_TRAIN_FAULTS`` variable (a JSON
:class:`TrainFaultConfig`); disarmed costs one ``is None`` check a hook.

The step points consult ``would_fire(point, global_step)``; the checkpoint
points consume one event a save. The rank-scoped points (the gang
vocabulary: ``kill_rank_at_step``, ``hang_rank_at_step``,
``die_during_save``) keep the same seed-derived schedule on every rank; the
rank is a scope, so only the targeted rank fires, and a schedule aimed at a
rank that a shrunk world no longer has goes quiet.
"""

import hashlib
import json
import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.utils.logging import logger

POINTS = ("kill_at_step", "sigterm_at_step", "nan_inject", "checkpoint_corrupt", "checkpoint_truncate",
          "kill_rank_at_step", "hang_rank_at_step", "die_during_save")

RANK_POINTS = ("kill_rank_at_step", "hang_rank_at_step", "die_during_save")

# suppressed on restarted lives under only_first_life
ONE_SHOT_POINTS = ("kill_at_step", "sigterm_at_step", "kill_rank_at_step", "hang_rank_at_step", "die_during_save")

_EVENT_LOG_CAP = 512


def _u64(seed: int, key: str, n: int, salt: str = "") -> int:
    """The seeded hash both chaos harnesses derive their schedules from
    (reference ``fleet/faults.py:137``)."""
    digest = hashlib.sha256(f"{seed}:{key}:{n}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _uniform(seed: int, key: str, n: int, salt: str = "") -> float:
    """Deterministic uniform [0, 1) for the n-th event at ``key``."""
    return _u64(seed, key, n, salt) / 2.0**64


@dataclass
class TrainFaultConfig(DeepSpeedConfigModel):
    """Training chaos knobs. Step lists fire at exactly those global steps;
    probabilities fire per event (a step for the step points, a save for the
    checkpoint points)."""

    enabled: bool = False
    seed: int = 0
    only_first_life: bool = True

    kill_at_steps: Tuple[int, ...] = ()
    sigterm_at_steps: Tuple[int, ...] = ()
    nan_at_steps: Tuple[int, ...] = ()

    kill_at_step_p: float = config_field(0.0, ge=0, le=1)
    sigterm_at_step_p: float = config_field(0.0, ge=0, le=1)
    nan_inject_p: float = config_field(0.0, ge=0, le=1)
    checkpoint_corrupt_p: float = config_field(0.0, ge=0, le=1)
    checkpoint_truncate_p: float = config_field(0.0, ge=0, le=1)

    kill_rank: int = config_field(0, ge=0)
    kill_rank_at_steps: Tuple[int, ...] = ()
    kill_rank_at_step_p: float = config_field(0.0, ge=0, le=1)
    hang_rank: int = config_field(0, ge=0)
    hang_rank_at_steps: Tuple[int, ...] = ()
    hang_rank_at_step_p: float = config_field(0.0, ge=0, le=1)
    hang_seconds: float = config_field(3600.0, gt=0)
    die_during_save_rank: int = config_field(0, ge=0)
    die_during_save_at: Tuple[int, ...] = ()
    die_during_save_p: float = config_field(0.0, ge=0, le=1)


def first_life() -> bool:
    """True when this process is the supervisor's first spawn (or runs
    unsupervised)."""
    return int(os.environ.get("DSTPU_RESTART_COUNT", "0") or 0) == 0


class TrainFaultInjector:
    """Seed-driven fault schedule over the training injection points."""

    def __init__(self, config: TrainFaultConfig):
        self.config = config
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}  # checkpoint points
        self._step_fired: Dict[str, set] = {}  # step points: once a step
        self._fired: Dict[str, int] = {}
        self._events: deque = deque(maxlen=_EVENT_LOG_CAP)

    # ---------------------------------------------------------------- schedule --
    def _steps(self, point: str) -> Tuple[int, ...]:
        return {"kill_at_step": self.config.kill_at_steps, "sigterm_at_step": self.config.sigterm_at_steps,
                "nan_inject": self.config.nan_at_steps, "kill_rank_at_step": self.config.kill_rank_at_steps,
                "hang_rank_at_step": self.config.hang_rank_at_steps,
                "die_during_save": self.config.die_during_save_at}.get(point, ())

    def _p(self, point: str) -> float:
        return getattr(self.config, "nan_inject_p" if point == "nan_inject" else f"{point}_p")

    def would_fire(self, point: str, n: int) -> bool:
        """Does event ``n`` (a global step for the step points, a save index
        for the checkpoint points) fault?"""
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} (know {POINTS})")
        if n in self._steps(point):
            return True
        p = self._p(point)
        return p > 0.0 and _uniform(self.config.seed, point, n) < p

    def schedule(self, point: str, count: int) -> List[int]:
        """Firing indices among the first ``count`` events."""
        return [n for n in range(count) if self.would_fire(point, n)]

    # -------------------------------------------------------------------- fire --
    def fire(self, point: str) -> Optional[int]:
        """Consume the next event at a checkpoint point; its index when it
        faults, else None."""
        with self._lock:
            n = self._counters.get(point, 0)
            self._counters[point] = n + 1
            if self.would_fire(point, n):
                self._record(point, n)
                return n
        return None

    def fire_step(self, point: str, step: int) -> Optional[int]:
        """Fires at most once per (point, step) a process life, and the lethal
        points only on the first life."""
        if point in ONE_SHOT_POINTS and self.config.only_first_life and not first_life():
            return None
        with self._lock:
            seen = self._step_fired.setdefault(point, set())
            if step in seen or not self.would_fire(point, step):
                return None
            seen.add(step)
            self._record(point, step)
            return step

    def target_rank(self, point: str) -> int:
        return {"kill_rank_at_step": self.config.kill_rank, "hang_rank_at_step": self.config.hang_rank,
                "die_during_save": self.config.die_during_save_rank}[point]

    def fire_step_rank(self, point: str, step: int, rank: int = 0) -> Optional[int]:
        """:meth:`fire_step` for the targeted rank only: every other rank
        (and a rank a shrunk world no longer has) sees None."""
        if point not in RANK_POINTS:
            raise ValueError(f"{point!r} is not rank-scoped (know {RANK_POINTS})")
        if int(rank) != self.target_rank(point):
            return None
        return self.fire_step(point, step)

    def fire_rank(self, point: str, rank: int) -> Optional[int]:
        """Rank-scoped sequential firing (``die_during_save``: one event a
        save). Every rank consumes the event index, since the schedule is the
        gang's, but only the targeted rank fires; lethal points only on the
        first life."""
        if point not in RANK_POINTS:
            raise ValueError(f"{point!r} is not rank-scoped (know {RANK_POINTS})")
        if point in ONE_SHOT_POINTS and self.config.only_first_life and not first_life():
            return None
        with self._lock:
            n = self._counters.get(point, 0)
            self._counters[point] = n + 1
            if int(rank) != self.target_rank(point):
                return None
            if self.would_fire(point, n):
                self._record(point, n)
                return n
        return None

    def _record(self, point, n):
        # the caller holds the lock
        self._fired[point] = self._fired.get(point, 0) + 1
        self._events.append({"point": point, "n": n})
        tm = _train_metrics()
        if tm is not None:
            tm.inc()

    # ---------------------------------------------------- fault-shape helpers --
    def poison_batch(self, batch):
        """A copy of the batch whose first floating tensor has NaN as its
        first element (the grads go non-finite: the sentinel's skip-step);
        the batch itself when it holds no floating tensor, as a batch of
        token ids does (the engine then poisons the step's losses)."""
        done = [False]

        def poison(x):
            if not done[0] and isinstance(x, torch.Tensor) and torch.is_floating_point(x) and x.numel():
                x = x.clone()
                x.view(-1)[0] = float("nan")
                done[0] = True
            return x

        def walk(tree):
            if isinstance(tree, (tuple, list)):
                return type(tree)(walk(x) for x in tree)
            if isinstance(tree, dict):
                return {k: walk(x) for k, x in tree.items()}
            return poison(tree)

        out = walk(batch)
        return out if done[0] else batch

    def corrupt_checkpoint(self, tag_path: str, n: int) -> Optional[str]:
        """Flip one byte of the largest sealed file of a committed checkpoint,
        at a position drawn from the seed: the manifest's CRC32 must catch it."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import MANIFEST_FILE, read_manifest
        try:
            manifest = read_manifest(tag_path)
        except ValueError:
            manifest = None
        files = (manifest or {}).get("files", {})
        candidates = sorted(((info["size"], rel) for rel, info in files.items()
                             if info["size"] > 0 and rel != MANIFEST_FILE), reverse=True)
        if not candidates:
            return None
        size, rel = candidates[0]
        pos = _u64(self.config.seed, "checkpoint_corrupt", n, "pos") % size
        fp = os.path.join(tag_path, rel)
        with open(fp, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
        logger.error(f"chaos: corrupted checkpoint {tag_path} ({rel} @ byte {pos})")
        return rel

    def truncate_checkpoint(self, tag_path: str) -> bool:
        """Delete a committed checkpoint's manifest: the torn-commit shape."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import MANIFEST_FILE
        mf = os.path.join(tag_path, MANIFEST_FILE)
        if not os.path.isfile(mf):
            return False
        os.unlink(mf)
        logger.error(f"chaos: truncated checkpoint {tag_path} (manifest removed: torn commit)")
        return True

    def report(self) -> dict:
        with self._lock:
            return {"seed": self.config.seed, "fired": dict(self._fired), "events_seen": dict(self._counters),
                    "recent": list(self._events)}


def _train_metrics():
    """``train_faults_injected_total``; None when telemetry is off."""
    from deepspeed_tpu_torch import telemetry
    if not telemetry.is_active():
        return None
    return telemetry.get_registry().counter("train_faults_injected_total",
                                            "Faults injected by the training chaos harness (all points)")


def config_from_env(env_value: Optional[str]) -> Optional[TrainFaultConfig]:
    """Parse ``DSTPU_TRAIN_FAULTS`` (a JSON ``TrainFaultConfig`` body). None
    when unset; malformed JSON raises, so a chaos run with a typo never runs
    clean."""
    if not env_value:
        return None
    return TrainFaultConfig.from_dict(json.loads(env_value))


def injector_from_env(env_value: Optional[str]) -> Optional[TrainFaultInjector]:
    """An armed injector from ``DSTPU_TRAIN_FAULTS``; None when unset or
    disabled."""
    config = config_from_env(env_value)
    return TrainFaultInjector(config) if config is not None and config.enabled else None
