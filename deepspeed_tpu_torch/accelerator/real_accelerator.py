"""The process's accelerator.

Port of ``deepspeed_tpu/accelerator/real_accelerator.py``:
``DS_ACCELERATOR`` (``cuda`` or ``cpu``) names it; otherwise the probe
picks ``cuda`` when a GPU is visible, else ``cpu``. The probe only names
the hardware: what runs where stays the caller's choice (the entry points
run on ``cuda`` unless asked for the CPU, ``utils/device.py``).
"""

import os

from deepspeed_tpu_torch.utils.logging import logger

SUPPORTED_ACCELERATOR_LIST = ["cuda", "cpu"]

ds_accelerator = None


def _validate_accelerator(accel_name):
    if accel_name not in SUPPORTED_ACCELERATOR_LIST:
        raise ValueError(f"accelerator must be one of {SUPPORTED_ACCELERATOR_LIST}, got {accel_name!r}")


def is_current_accelerator_supported():
    return get_accelerator().device_name() in SUPPORTED_ACCELERATOR_LIST


def get_accelerator():
    global ds_accelerator
    if ds_accelerator is not None:
        return ds_accelerator
    accelerator_name = os.environ.get("DS_ACCELERATOR")
    if accelerator_name is not None:
        _validate_accelerator(accelerator_name)
    else:
        import torch
        accelerator_name = "cuda" if torch.cuda.is_available() else "cpu"
    return set_accelerator_by_name(accelerator_name)


def accelerator_for(device_type):
    """A new accelerator object for ``cuda`` or ``cpu``."""
    _validate_accelerator(device_type)
    if device_type == "cuda":
        from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator
        return CUDA_Accelerator()
    from deepspeed_tpu_torch.accelerator.cpu_accelerator import CPU_Accelerator
    return CPU_Accelerator()


def set_accelerator_by_name(accelerator_name):
    global ds_accelerator
    ds_accelerator = accelerator_for(accelerator_name)
    logger.info(f"Setting ds_accelerator to {accelerator_name}")
    return ds_accelerator


def set_accelerator(accel_obj):
    """Install an accelerator object (reference ``real_accelerator.py:195``)."""
    global ds_accelerator
    ds_accelerator = accel_obj
    return ds_accelerator
