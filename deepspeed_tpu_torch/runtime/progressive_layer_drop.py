"""Progressive Layer Drop (PLD).

Port of ``deepspeed_tpu/runtime/progressive_layer_drop.py`` (reference
``deepspeed/runtime/progressive_layer_drop.py``): the keep ratio
``θ(t) = (1 - θ̄)·exp(-γ·t) + θ̄``, updated at each global step, and the PLD
paper's per-layer keep probability ``p_i = 1 - (i / L)·(1 - θ)``, so early
layers are almost never dropped.

The engine builds :class:`ProgressiveLayerDrop` when
``progressive_layer_drop.enabled`` and advances it at every gradient
accumulation boundary; a model opts in with :func:`layer_drop`, a
stochastic-depth residual skip. Its keep draw comes from a host
``torch.Generator``, so branching on it never waits for the card.
"""

import numpy as np
import torch


class ProgressiveLayerDrop:

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int):

        def _prob(x, g, t):
            return (1.0 - t) * np.exp(-g * x) + t

        self.current_theta = float(_prob(global_step, self.gamma, self.theta))


def keep_prob(layer_index: int, num_layers: int, theta):
    """Per-layer keep probability: 1 - (i/L)(1-θ)."""
    return 1.0 - (float(layer_index) / float(num_layers)) * (1.0 - theta)


def layer_drop(fn, x, generator, p_keep, *args, **kwargs):
    """Stochastic-depth residual skip: with probability ``p_keep`` return
    ``fn(x, ...)``, else ``x``. ``generator`` is a CPU ``torch.Generator``
    (the draw stays on the host); with ``generator=None`` (eval) the block
    always runs, as the reference's inference path disables PLD."""
    if generator is None:
        return fn(x, *args, **kwargs)
    keep = bool(torch.rand((), generator=generator) < float(p_keep))
    return fn(x, *args, **kwargs) if keep else x
