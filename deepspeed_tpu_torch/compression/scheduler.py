"""Progressive compression scheduling.

Port of ``deepspeed_tpu/compression/scheduler.py`` (host logic, unchanged).
Reference: ``deepspeed/compression/scheduler.py`` (CompressionScheduler — the
engine calls ``step()`` every global step; each technique turns on once
``training_steps`` reaches its ``schedule_offset``, flipping the compressed
layers' enabled flags).

Formulation: compression is a parameter transform
(``compress.init_compression``), so "enabling a technique" = applying its
transform to the live engine parameters the first time its offset is reached,
and re-applying on a configured ``frequency`` (pruning masks track weights as
they train; fake-quant re-snaps). The engine hook lives beside the other
per-step schedulers (PLD, curriculum, LR).

Eigenvalue gate (reference ``runtime/eigenvalue.py`` feeding quantize-period
adaptation): with ``eigenvalue_gated: true`` a technique additionally waits
until the loss curvature (power-iteration top Hessian eigenvalue) falls below
``eigenvalue_threshold`` — compressing while the loss surface is still sharp
destroys accuracy the schedule cannot recover.
"""

from typing import Dict, Optional, Set

from deepspeed_tpu_torch.compression.compress import get_compression_config, init_compression
from deepspeed_tpu_torch.utils.logging import logger

TECHNIQUES = ("weight_quantization", "sparse_pruning", "row_pruning", "head_pruning")


class CompressionScheduler:

    def __init__(self, deepspeed_config: dict):
        cfg = get_compression_config(deepspeed_config)
        self._config = deepspeed_config
        self.techniques: Dict[str, dict] = {}
        for t in TECHNIQUES:
            shared = cfg.get(t, {}).get("shared_parameters", {})
            if not shared.get("enabled", False):
                continue
            self.techniques[t] = {
                "offset": int(shared.get("schedule_offset", 0)),
                "frequency": int(shared.get("frequency", 0)),  # 0 = apply once
                "eigenvalue_gated": bool(shared.get("eigenvalue_gated", False)),
                "eigenvalue_threshold": float(shared.get("eigenvalue_threshold", 1.0)),
                "eigenvalue_frequency": int(shared.get("eigenvalue_frequency", 100)),
                "active": False,
                "last_applied": -1,
            }
        self.training_steps = 0
        # curvature probes are expensive (a power iteration of HVPs costs a
        # large multiple of a train step) — probe on the gated techniques'
        # interval and reuse the cached value between probes
        self._last_probe_step = -1
        self._last_curvature: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return bool(self.techniques)

    def weight_quantization_enabled(self) -> bool:
        t = self.techniques.get("weight_quantization")
        return bool(t and t["active"])

    # ------------------------------------------------------------------ step --
    def techniques_due(self, step: int, curvature: Optional[float] = None) -> Set[str]:
        """Techniques whose transform must be (re)applied at ``step``."""
        due = set()
        for name, t in self.techniques.items():
            if step < t["offset"]:
                continue
            if t["eigenvalue_gated"] and not t["active"]:
                if curvature is None or curvature > t["eigenvalue_threshold"]:
                    continue  # still too sharp — defer activation
            if not t["active"]:
                due.add(name)
            elif t["frequency"] > 0 and step - t["last_applied"] >= t["frequency"]:
                due.add(name)
        return due

    def needs_curvature(self, step: int) -> bool:
        return any(t["eigenvalue_gated"] and not t["active"] and step >= t["offset"]
                   for t in self.techniques.values())

    def step(self, engine) -> None:
        """Engine hook (reference engine.py:1797/2072): advance, and apply any
        newly-due technique's transform to the live parameters."""
        self.training_steps = engine.global_steps
        curvature = None
        if self.needs_curvature(self.training_steps):
            interval = min(t["eigenvalue_frequency"] for t in self.techniques.values()
                           if t["eigenvalue_gated"] and not t["active"]
                           and self.training_steps >= t["offset"])
            if (self._last_probe_step < 0
                    or self.training_steps - self._last_probe_step >= max(interval, 1)):
                self._last_curvature = engine.loss_curvature()
                self._last_probe_step = self.training_steps
            curvature = self._last_curvature
        due = self.techniques_due(self.training_steps, curvature)
        if not due:
            return
        sub_cfg = {"compression_training":
                   {k: v for k, v in get_compression_config(self._config).items()
                    if k in due}}
        engine.apply_compression_transform(sub_cfg)
        for name in due:
            t = self.techniques[name]
            if not t["active"]:
                logger.info(f"compression: {name} enabled at step {self.training_steps}"
                            + (f" (curvature {curvature:.3g})" if curvature is not None else ""))
            t["active"] = True
            t["last_applied"] = self.training_steps

    # ---------------------------------------------------------- checkpointing --
    def state_dict(self):
        return {"training_steps": self.training_steps,
                "last_probe_step": self._last_probe_step,
                "last_curvature": self._last_curvature,
                "techniques": {k: {kk: v[kk] for kk in ("active", "last_applied")}
                               for k, v in self.techniques.items()}}

    def load_state_dict(self, sd):
        self.training_steps = sd["training_steps"]
        self._last_probe_step = sd.get("last_probe_step", -1)
        self._last_curvature = sd.get("last_curvature")
        for k, st in sd.get("techniques", {}).items():
            if k in self.techniques:
                self.techniques[k].update(st)
