"""Hessian max-eigenvalue estimation by power iteration.

Port of ``deepspeed_tpu/runtime/eigenvalue.py`` (reference
``deepspeed/runtime/eigenvalue.py``, Eigenvalue:14: ``compute_eigenvalue``
runs power iteration per block using Hessian-vector products; the
compression scheduler's eigenvalue gate reads the result).

The HVP is reverse over reverse: the gradient of the block with
``create_graph=True``, then the gradient of its dot product with ``v``. It
equals the JAX package's ``jax.jvp(jax.grad(...))`` to rounding. Blocks are
the top-level entries of ``params`` (each a tensor or a dict of tensors), as
the JAX package takes the top-level entries of its tree. A function whose
backward is marked ``once_differentiable`` (the flash-attention kernels)
raises here, as the JAX package's ``custom_vjp`` kernels do under ``jvp``.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger


def _leaves(block):
    if isinstance(block, torch.Tensor):
        return [block]
    return [t for k in sorted(block) for t in _leaves(block[k])]


def _rebuild(block, leaves):
    """``block``'s structure with ``leaves`` (in :func:`_leaves` order)."""
    if isinstance(block, torch.Tensor):
        return leaves.pop(0)
    return {k: _rebuild(block[k], leaves) for k in sorted(block)}


def block_hvp(loss_fn: Callable, name: str) -> Callable:
    """``hvp(params, batch, v)``: the product of the Hessian of
    ``loss_fn(params, batch)`` with respect to block ``name`` with ``v``
    (a list of tensors in the block's leaf order)."""

    def hvp(params, batch, v):
        leaves = [t.detach().requires_grad_() for t in _leaves(params[name])]
        p2 = dict(params)
        p2[name] = _rebuild(params[name], list(leaves))
        with torch.enable_grad():
            loss = loss_fn(p2, batch)
            grads = torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True)
            terms = [(g.float() * vi).sum() for g, vi in zip(grads, v) if g is not None and g.requires_grad]
            if not terms:  # the loss is at most linear in the block
                return [torch.zeros_like(t) for t in leaves]
            # backward() runs every node of the graph: a once_differentiable
            # function's error node raises here, where autograd.grad would
            # prune it and drop its terms without a word
            sum(terms).backward()
        return [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]

    return hvp


class Eigenvalue:

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1, layer_name: str = "", layer_num: int = 0):
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num
        # the last call's raw eigenvalues, iterations and convergence per block
        self.last_raw: Dict[str, float] = {}
        self.last_iters: Dict[str, int] = {}
        self.last_converged: Dict[str, bool] = {}

    @staticmethod
    def _dot(a, b):
        return sum((x.float() * y.float()).sum() for x, y in zip(a, b))

    @staticmethod
    def _norm(a):
        return torch.sqrt(Eigenvalue._dot(a, a))

    @staticmethod
    def _scale(a, s):
        return [x * s for x in a]

    def compute_eigenvalue(self, loss_fn: Callable, params, batch, generator: Optional[torch.Generator] = None,
                           hvp_cache: Optional[dict] = None) -> Dict[str, float]:
        """Power-iterate ``H_block v = λ v`` for each top-level block of
        ``params``; ``loss_fn(params, batch)`` must be twice differentiable.

        ``generator`` draws the start vectors (a CPU generator seeded 0 when
        None). ``hvp_cache``: a caller-owned dict, block name → HVP closure,
        kept across probes.

        Returns ``{block: λ}`` with the reference's post-processing: a
        non-finite block gets 1.0, then every value is divided by the largest
        magnitude, so the largest is 1.0. The raw values stay in
        ``last_raw``."""
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        results = {}
        self.last_raw, self.last_iters, self.last_converged = {}, {}, {}
        for name in params.keys():
            if hvp_cache is not None and name in hvp_cache:
                hvp = hvp_cache[name]
            else:
                hvp = block_hvp(loss_fn, name)
                if hvp_cache is not None:
                    hvp_cache[name] = hvp
            leaves = _leaves(params[name])
            v = [torch.randn(t.shape, generator=generator, device=generator.device).to(t.device) for t in leaves]
            v = self._scale(v, 1.0 / (self._norm(v) + self.stability))
            eig, prev, converged = 0.0, 0.0, False
            for it in range(self.max_iter):
                hv = hvp(params, batch, v)
                eig = float(self._dot(v, hv))
                nrm = float(self._norm(hv))
                if nrm < self.stability:
                    eig, converged = 0.0, True
                    break
                v = self._scale(hv, 1.0 / nrm)
                if it > 0 and abs(eig - prev) <= self.tol * max(abs(eig), 1.0):
                    converged = True
                    break
                prev = eig
            results[name] = eig
            self.last_iters[name] = it + 1
            self.last_converged[name] = converged
            if self.verbose:
                logger.info(f"eigenvalue[{name}] = {eig:.4e} ({it + 1} iters)")
        self.last_raw = dict(results)

        # reference post-processing: invalid values become 1.0, the max 1.0
        vals = np.array([results[k] for k in results], np.float64)
        vals[~np.isfinite(vals)] = 1.0
        vmax = float(np.abs(vals).max()) if len(vals) else 1.0
        if vmax > 0:
            vals = np.abs(vals) / vmax
        return {k: float(v) for k, v in zip(results, vals)}
