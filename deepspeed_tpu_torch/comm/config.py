"""Comms logger config (port of ``deepspeed_tpu/comm/config.py``, a
dataclass in place of the pydantic model)."""

from dataclasses import dataclass, field
from typing import List

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


@dataclass
class CommsConfig(DeepSpeedConfigModel):
    enabled: bool = False
    prof_all: bool = True
    prof_ops: List[str] = field(default_factory=list)
    verbose: bool = False
    debug: bool = False


class DeepSpeedCommsConfig:

    def __init__(self, ds_config: dict):
        self.comms_logger_enabled = "comms_logger" in ds_config
        if self.comms_logger_enabled:
            self.comms_logger = CommsConfig.from_dict(ds_config["comms_logger"])
