"""ZeRO-Offload: the optimizer state at rest in host memory, the update on
the host.

Port of ``deepspeed_tpu/runtime/zero/offload.py`` (``OptimizerOffloadPlan``
and ``NvmeOffloadPlan``). Between steps the state lives off the card: in
pinned host memory (``OptimizerOffloadPlan``) or in files on a local disk
(``NvmeOffloadPlan``, through ``runtime/swap_tensor``). At the step the
reference's host-compute path runs (``run_update``): the gradients and the
f32 masters go device -> host, the optimizer's update runs on the host in
f32 (FusedAdam's arithmetic, which the port's ``DeepSpeedCPUAdam`` shares),
with fp16 the ``finite`` select runs there too, and the new masters go host
-> device. The card never holds the state.

An optimizer that reads whole tensors (LAMB, the 1-bit family) over a
partitioned state gathers it over the ranks; that path takes the
reference's other one, "choreography": ``stage_in`` brings the state to
the card before the update and ``stage_out`` takes it back after.

The engine calls ``stage_in`` before and ``stage_out`` after every update,
and reads ``bytes_to_host`` / ``bytes_to_device`` (the last update's
traffic). ``checkpoint_view``, ``restore_template`` and ``accept_restored``
are the checkpoint engine's: what a save writes, the template a load fills,
and where the restored state goes to rest.
"""

import torch

from deepspeed_tpu_torch.utils.logging import logger


def map_state(tree, fn):
    """``fn`` over every leaf (tensor or swapped-out stub) of an optimizer
    state: tensors, dicts and (named) tuples; None stays None."""
    from deepspeed_tpu_torch.runtime.swap_tensor import NvmeSwappedLeaf

    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, NvmeSwappedLeaf)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_state(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [map_state(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def state_leaves(tree):
    """Every leaf of an optimizer state, in ``map_state`` order."""
    out = []
    map_state(tree, lambda leaf: out.append(leaf) or leaf)
    return out


def tree_select(pred, new, old):
    """Per-leaf ``where(pred, new, old)``."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: tree_select(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        items = [tree_select(pred, a, b) for a, b in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    return torch.where(pred, new, old)


def _nbytes(t):
    return t.numel() * t.element_size()


class OptimizerOffloadPlan:
    """Where the optimizer state rests and where its update runs (see the
    module doc). Disabled, every method passes the state through."""

    def __init__(self, enabled: bool, device, host_compute: bool = True):
        self.enabled = bool(enabled)
        self.device = torch.device(device)
        # pinned pages only where there is a card to copy to
        self.pin = self.enabled and self.device.type == "cuda"
        self.host_compute = self.enabled and host_compute
        self.bytes_to_host = 0
        self.bytes_to_device = 0
        self._rest = []  # pinned buffers the state rests in, leaf by leaf
        self._staging = {}  # pinned buffers the gradients and masters go through
        if self.enabled:
            logger.info(f"ZeRO-Offload: optimizer state in {'pinned ' if self.pin else ''}host memory, update "
                        f"{'on the host' if self.host_compute else 'on the device (staged in and out)'}")

    # -- where the state rests ------------------------------------------------
    def _host(self, t, key=None):
        """A host copy of ``t`` (pinned where there is a card; a buffer kept
        under ``key`` is reused); ``t`` itself when it is on the host and
        nothing needs pinning."""
        if t.device.type == "cpu" and (not self.pin or t.is_pinned()):
            return t
        if not self.pin:
            return t.cpu()
        buf = self._staging.get(key) if key is not None else None
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if key is not None:
                self._staging[key] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def stage_out(self, opt_state):
        """The state to its resting place: each leaf into its pinned host
        buffer (on the choreography path, back from the card)."""
        if not self.enabled:
            return opt_state
        leaves = state_leaves(opt_state)
        if len(self._rest) != len(leaves):
            self._rest = [None] * len(leaves)
        it = iter(range(len(leaves)))

        def rest(t):
            i = next(it)
            if t.device.type == "cpu" and not self.pin:
                return t
            buf = self._rest[i]
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._rest[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
            if buf is not t:
                buf.copy_(t)
            return buf

        out = map_state(opt_state, rest)
        if self.pin:
            torch.cuda.synchronize(self.device)
        return out

    def stage_in(self, opt_state):
        """The state where the update reads it: where it rests on the
        host-compute path, on the card on the choreography path."""
        if not self.enabled or self.host_compute:
            return opt_state
        return map_state(opt_state, lambda t: t.to(self.device, non_blocking=True))

    def resting_bytes(self, opt_state):
        """``{"device": ..., "host": ..., "pinned": ...}``: the bytes of the
        state's tensors on the card, on the host, and pinned."""
        out = {"device": 0, "host": 0, "pinned": 0}
        for t in state_leaves(opt_state):
            if not isinstance(t, torch.Tensor):
                continue
            where = "host" if t.device.type == "cpu" else "device"
            out[where] += _nbytes(t)
            if where == "host" and t.is_pinned():
                out["pinned"] += _nbytes(t)
        return out

    # -- the update --------------------------------------------------------------
    def run_update(self, update_fn, grads, opt_state, params, finite=None):
        """``update_fn(grads, opt_state, params) -> (new_params, new_state)``
        where the plan says, with the ``finite`` gate (a 0-d bool tensor, or
        None) selecting the old parameters and state on a step that is not
        finite. On the host-compute path the gradients and masters go to the
        host, the update and the select run there, and the new masters come
        back to the card."""
        if not self.host_compute:
            new_p, new_state = update_fn(grads, opt_state, params)
            if finite is not None:
                new_p = {k: torch.where(finite, new_p[k], p) for k, p in params.items()}
                new_state = tree_select(finite, new_state, opt_state)
            return new_p, new_state
        g_h = {n: self._host(g, ("g", n)) for n, g in grads.items()}
        p_h = {n: self._host(p, ("p", n)) for n, p in params.items()}
        f_h = finite.to("cpu") if finite is not None else None
        if self.pin:
            torch.cuda.synchronize(self.device)
        moved = [g for g in grads.values()] + [p for p in params.values()]
        self.bytes_to_host = sum(_nbytes(t) for t in moved if t.device.type != "cpu")
        new_p, new_state = update_fn(g_h, opt_state, p_h)
        if f_h is not None:
            new_p = {k: torch.where(f_h, new_p[k], p) for k, p in p_h.items()}
            new_state = tree_select(f_h, new_state, opt_state)
        out = {k: t.to(params[k].device) for k, t in new_p.items()}
        self.bytes_to_device = sum(_nbytes(t) for t in out.values() if t.device.type != "cpu")
        return out, new_state

    # -- checkpoints (the NVMe plan overrides these) ------------------------------
    def checkpoint_view(self, opt_state):
        """The state tree a checkpoint writes."""
        return opt_state

    def restore_template(self, opt_state):
        """The template a checkpoint load fills."""
        return opt_state

    def accept_restored(self, opt_state):
        """A restored state tree to its resting place."""
        if not self.enabled:
            return opt_state
        if self.host_compute or not self.pin:
            return self.stage_out(map_state(opt_state, lambda t: t.cpu()))
        return self.stage_out(opt_state)

    def close(self):
        pass


class NvmeOffloadPlan(OptimizerOffloadPlan):
    """ZeRO-Infinity: the optimizer state at rest in files under
    ``nvme_path`` (each rank its own), swapped in to pinned host memory for
    the update and out again after it, through the native async-IO engine
    (``runtime/swap_tensor``). The update runs on the host, as
    :class:`OptimizerOffloadPlan`'s does, so the masters equal CPU
    offload's bit for bit. The reference updates on the device; the port's
    path never brings the state to the card."""

    def __init__(self, device, nvme_path: str, aio_config=None, buffer_count: int = 4, rank: int = 0):
        from deepspeed_tpu_torch.runtime.swap_tensor import PartitionedOptimizerSwapper

        if not nvme_path:
            raise ValueError("offload_optimizer.device=nvme requires nvme_path")
        super().__init__(True, device, host_compute=True)
        self.swapper = PartitionedOptimizerSwapper(nvme_path, aio_config, buffer_count, rank=rank,
                                                   pin_memory=self.pin)
        logger.info(f"ZeRO-Infinity: optimizer state on disk at {nvme_path} (native aio, {buffer_count} swap "
                    f"buffers)")

    def stage_in(self, opt_state):
        return self.swapper.swap_in(opt_state)

    def stage_out(self, opt_state):
        return self.swapper.swap_out(opt_state)

    def resting_bytes(self, opt_state):
        out = super().resting_bytes(opt_state)
        out["disk"] = sum(leaf.nbytes for leaf in state_leaves(opt_state) if not isinstance(leaf, torch.Tensor))
        return out

    def checkpoint_view(self, opt_state):
        return self.swapper.materialize_host(opt_state)

    def restore_template(self, opt_state):
        from deepspeed_tpu_torch.runtime.swap_tensor import NvmeSwappedLeaf
        return map_state(opt_state, lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
                         if isinstance(leaf, NvmeSwappedLeaf) else leaf)

    def accept_restored(self, opt_state):
        return self.swapper.swap_out(map_state(opt_state, lambda t: t.cpu()))

    def close(self):
        self.swapper.close()
