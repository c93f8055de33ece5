"""Activation checkpointing (recompute in the backward instead of storing).

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``:
the same ``configure`` / ``checkpoint`` / ``is_configured`` / ``reset``
surface, on ``torch.utils.checkpoint`` (non-reentrant). The JAX module maps
its config onto ``jax.checkpoint`` policies; the port keeps the two it uses:

- ``"nothing"`` (``nothing_saveable``): the whole function is recomputed;
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of plain
  matrix products (``aten.mm`` / ``aten.addmm``, what a ``Linear`` runs) are
  saved and everything else (norms, RoPE, attention, SwiGLU) is recomputed,
  through ``torch.utils.checkpoint.create_selective_checkpoint_contexts``.

``partition_activations`` or ``cpu_checkpointing`` select ``"dots"`` as in the
JAX module (which saves dot products on the device where its backend cannot
offload them); the other flags are kept for config parity.

``torch.utils.checkpoint`` does not compose with a second derivative as
``jax.checkpoint`` composes with ``jax.jvp``: under ``"dots"`` a derivative
of the backward raises, and the recomputation runs when the backward does,
outside any ``torch.func.functional_call`` that swapped the parameters in
(so it sees the module's own). Code that differentiates twice (the engine's
``loss_curvature``) runs inside :func:`recompute_disabled`, where
:func:`remat` calls the function as it is.
"""

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint as _torch_checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

POLICIES = ("nothing", "dots")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

_CONFIG = None
_LOCAL = threading.local()


@contextlib.contextmanager
def recompute_disabled():
    """Within this context (on this thread) :func:`remat` stores the
    activations instead of recomputing them."""
    prev = getattr(_LOCAL, "disabled", False)
    _LOCAL.disabled = True
    try:
        yield
    finally:
        _LOCAL.disabled = prev


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(function, *args, policy: str = "nothing"):
    """``function(*args)``, with its activations recomputed in the backward
    under ``policy`` (see the module doc)."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {POLICIES}")
    if getattr(_LOCAL, "disabled", False):
        return function(*args)
    kwargs = {}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return _torch_checkpoint(function, *args, use_reentrant=False, **kwargs)


def _policy() -> str:
    if _CONFIG is not None and (_CONFIG.cpu_checkpointing or _CONFIG.partition_activations):
        return "dots"
    return "nothing"


def configure(mpu_=None, deepspeed_config=None, partition_activations=None, contiguous_checkpointing=None,
              num_checkpoints=None, checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Reference checkpointing.py:871 — flags override the config block."""
    global _CONFIG
    from deepspeed_tpu_torch.runtime.config import ActivationCheckpointingConfig, DeepSpeedConfig

    if deepspeed_config is not None:
        if not isinstance(deepspeed_config, DeepSpeedConfig):
            deepspeed_config = DeepSpeedConfig(deepspeed_config)
        _CONFIG = deepspeed_config.activation_checkpointing_config
    elif _CONFIG is None:
        _CONFIG = ActivationCheckpointingConfig()
    if partition_activations is not None:
        _CONFIG.partition_activations = partition_activations
    if checkpoint_in_cpu is not None:
        _CONFIG.cpu_checkpointing = checkpoint_in_cpu
    if num_checkpoints is not None:
        _CONFIG.number_checkpoints = num_checkpoints
    if contiguous_checkpointing is not None:
        _CONFIG.contiguous_memory_optimization = contiguous_checkpointing
    if synchronize is not None:
        _CONFIG.synchronize_checkpoint_boundary = synchronize
    if profile is not None:
        _CONFIG.profile = profile


def is_configured() -> bool:
    return _CONFIG is not None


def reset():
    global _CONFIG
    _CONFIG = None


def checkpoint(function, *args):
    """Rematerialized call of ``function(*args)`` (reference checkpoint:748);
    the saved-activation policy follows :func:`configure`."""
    return remat(function, *args, policy=_policy())
