"""Loss-anomaly sentinel: NaN/inf/spike -> skip-step, then rollback to the
last good checkpoint after M consecutive anomalies.

Port of ``deepspeed_tpu/runtime/sentinel.py``. The device side of skip-step
is the engine's finite gate: with the sentinel enabled, ``_apply`` checks
``tree_all_finite(grads)`` in every precision (not only fp16), so a
non-finite step changes neither the weights nor the optimizer state. The host
side (this module) watches the loss of each optimizer step: a non-finite
loss, or one above ``spike_factor`` times the running EMA of healthy losses,
is an anomaly (``train_anomalies_total``); ``max_consecutive`` anomalies in a
row escalate to a ROLLBACK, and the engine reloads the newest verified-good
checkpoint taken at or before the last healthy step
(``train_rollbacks_total``).

Reading the loss is a device sync per step, so the sentinel is opt-in
(``anomaly_sentinel.enabled``).
"""

import math
from dataclasses import dataclass
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel, config_field
from deepspeed_tpu_torch.utils.logging import logger

OK = "ok"
ANOMALY = "anomaly"
ROLLBACK = "rollback"


@dataclass
class AnomalySentinelConfig(DeepSpeedConfigModel):
    """``anomaly_sentinel`` config block."""

    enabled: bool = False
    """Master switch; also arms the engine's all-precision finite gate."""

    spike_factor: float = config_field(10.0, gt=1.0)
    """A finite loss above ``spike_factor * ema`` counts as an anomaly."""

    ema_beta: float = config_field(0.9, ge=0.0, lt=1.0)
    """EMA smoothing over healthy losses (anomalous losses never update it)."""

    warmup_steps: int = config_field(5, ge=0)
    """Healthy observations before spike detection arms (NaN/inf detection
    is active from the first step)."""

    max_consecutive: int = config_field(3, ge=1)
    """Consecutive anomalies that escalate to a rollback."""

    rollback: bool = True
    """False: escalation only logs and counts, for loops that recover
    themselves."""


class LossAnomalySentinel:
    """Per-engine anomaly state machine, driven by the engine at every
    optimizer step."""

    def __init__(self, config: AnomalySentinelConfig):
        self.config = config
        self.ema: Optional[float] = None
        self.healthy_seen = 0
        self.consecutive = 0
        self.anomalies = 0
        self.rollbacks = 0
        self._metrics = None

    def _counters(self):
        from deepspeed_tpu_torch import telemetry
        if not telemetry.is_active():
            return None
        if self._metrics is None:
            reg = telemetry.get_registry()
            self._metrics = {
                "anomalies": reg.counter("train_anomalies_total", "Loss anomalies (NaN/inf/spike) seen by the sentinel"),
                "rollbacks": reg.counter("train_rollbacks_total", "Sentinel rollbacks to the last good checkpoint"),
            }
        return self._metrics

    def observe(self, loss: float) -> str:
        """Classify one step's loss: ``ok``, ``anomaly`` or ``rollback`` (the
        last also counts as an anomaly; the caller reloads the checkpoint)."""
        cfg = self.config
        finite = math.isfinite(loss)
        spike = (finite and self.ema is not None and self.healthy_seen >= cfg.warmup_steps
                 and loss > cfg.spike_factor * max(abs(self.ema), 1e-12))
        if finite and not spike:
            self.healthy_seen += 1
            self.consecutive = 0
            self.ema = loss if self.ema is None else cfg.ema_beta * self.ema + (1.0 - cfg.ema_beta) * loss
            return OK
        self.anomalies += 1
        self.consecutive += 1
        m = self._counters()
        if m is not None:
            m["anomalies"].inc()
        kind = "non-finite" if not finite else "spike"
        logger.warning(f"anomaly sentinel: {kind} loss {loss!r} "
                       f"(ema={self.ema}, consecutive={self.consecutive}/{cfg.max_consecutive})")
        if self.consecutive >= cfg.max_consecutive:
            self.consecutive = 0
            self.rollbacks += 1
            if m is not None:
                m["rollbacks"].inc()
            return ROLLBACK
        return ANOMALY

    def describe(self) -> dict:
        return {"ema": self.ema, "healthy_seen": self.healthy_seen, "consecutive": self.consecutive,
                "anomalies": self.anomalies, "rollbacks": self.rollbacks}
