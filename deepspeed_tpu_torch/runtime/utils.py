"""Runtime math helpers over dicts of tensors.

Port of ``deepspeed_tpu/runtime/utils.py``: the global L2 norm in f32, the
reference's clip-by-global-norm rule, the finiteness probe of fp16 loss
scaling and a floating-point cast. Results stay on the device (0-d tensors):
nothing here synchronizes with the host.
"""

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every tensor, accumulated in f32."""
    sums = [t.float().square().sum() for t in tree.values() if t is not None]
    if not sums:
        return torch.zeros([], dtype=torch.float32)
    return torch.stack(sums).sum().sqrt()


def clip_grads_by_global_norm(grads: dict, max_norm: float, norm=None, eps=1e-6):
    """Scale every gradient by ``min(1, max_norm / (norm + eps))``; returns
    ``(clipped, norm)`` with the norm taken before clipping."""
    if norm is None:
        norm = global_norm(grads)
    coef = torch.clamp(max_norm / (norm + eps), max=1.0)
    return {k: g * coef.to(g.dtype) for k, g in grads.items()}, norm


def tree_all_finite(tree: dict) -> torch.Tensor:
    """0-d bool tensor: every element of every tensor is finite."""
    flags = [torch.isfinite(t.float()).all() for t in tree.values() if t is not None]
    if not flags:
        return torch.ones([], dtype=torch.bool)
    return torch.stack(flags).all()


def cast_tree(tree: dict, dtype) -> dict:
    """Floating-point tensors cast to ``dtype``; others unchanged."""
    return {k: t.to(dtype) if torch.is_floating_point(t) else t for k, t in tree.items()}
