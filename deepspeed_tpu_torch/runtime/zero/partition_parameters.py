"""Parameter partitioning over the data-parallel ranks, and the
``zero.Init`` / ``GatheredParameters`` surface.

Port of ``deepspeed_tpu/runtime/zero/partition_parameters.py``. The
reference's engine states placements and lets XLA move the data; the port
moves it by hand, over ``comm``'s collectives (qwZ changes what they move,
hpZ and MiCS over which ranks: :class:`ZeroPartitioner`), never through
``torch.distributed.fsdp`` or ``DistributedDataParallel``.

:class:`ZeroPartitioner` holds, for each parameter of a module, the
dimension the ZeRO rule (``runtime/zero/policy.py``) shards its parameter,
its gradient-accumulation buffer and its optimizer state on, in the port's
layout, and this rank's index in the ZeRO group. A sharded tensor is cut
into ``degree`` contiguous chunks along that dimension; rank ``i`` holds
chunk ``i``, as device ``i`` holds it in the reference. ``shard``,
``gather`` and ``reduce_scatter`` move a tensor between its whole and its
chunk along any dimension.

At stage 3 the partitioner also owns the forward. The modules that hold the
parameters are grouped into *units*: each member of a ``ModuleList`` (a
transformer block) and each other module that owns parameters itself (the
embedding, the final norm, the unembedding). A unit's forward becomes
:class:`_GatheredUnit`: it gathers the unit's parameters from their shards,
runs the unit without autograd, and releases them; its backward gathers
them again, reruns the unit's forward with autograd (the recomputation that
activation checkpointing would do; ``remat`` is off inside), takes the
gradients, and reduce-scatters those of the sharded parameters, so each
rank receives only its chunk's gradient summed over the ranks. The tensors
the engine differentiates are then the chunks (``leaves``), and a unit's
parameters hold no storage outside its forward and backward.

``register_external_parameter(module, p)`` adds ``p`` to the parameters
``module``'s unit gathers (a parameter used outside its owner): register
before the engine is built.
"""

import contextlib
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy, port_dim, reference_shape
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.logging import logger

_INIT_CONTEXT = {"active": False, "config": None, "demanded": False}


# --------------------------------------------------------------- partitioner --
class ZeroPartitioner:
    """Placement and data movement of one engine's parameters over its
    ZeRO group (see the module doc).

    ZeRO++'s secondary partitions (reference ``engine.py:166-216``) give the
    parameters a group of their own: hpZ (``param_axes``) shards the stage-3
    parameters over the secondary (``hpz``) group only, while the gradients
    and the optimizer state keep the whole ZeRO group; MiCS (``zero_axes``)
    shards all three within the secondary group and replicates them across
    the groups. ``shard``/``gather``/``reduce_scatter`` take ``param=True``
    for the parameters' group; ``replica_all_reduce`` sums a chunk over the
    data-parallel ranks that hold the same chunk (the cross-group gradient
    sync of MiCS and hpZ; nothing without a secondary partition). With qwZ
    the engine sets ``qwz`` (``runtime/zero/qwz.py``), which changes what a
    unit's gather moves: int8 (or packed int4) payloads and their scales,
    taken from the f32 masters, instead of the compute-dtype chunks.

    Expert parameters (``expert_names``: the banks a rank holds its experts
    of) are data-parallel over the expert-data group only (reference
    ``utils/groups.py``), so their gradient buffer and optimizer state are
    partitioned over that group: ``shard``/``gather``/``reduce_scatter``
    given such a ``name`` move it there; at stage 3 a bank's unit gathers
    it over that group only.

    ``taken``: ``{name: (port dim, ranks)}`` for the parameters another
    placement splits (a tensor-parallel shard, an expert bank over the
    expert ranks): each is partitioned on top of its shard, never on that
    dimension (``policy.zero_shard_dim``)."""

    def __init__(self, module: torch.nn.Module, stage: int, persistence_threshold: int = 0, zero_axes=None,
                 param_axes=None, expert_names=(), taken=None):
        from deepspeed_tpu_torch.models.convert import reference_names

        self.stage = stage
        mesh = groups.get_mesh()
        self.policy = ZeroShardingPolicy(stage, mesh=mesh, persistence_threshold=persistence_threshold,
                                         zero_axes=zero_axes, param_axes=param_axes)
        self.group = groups.get_group(self.policy.zero_axes) if self.policy.zero_axes else groups.world_group()
        self.degree = self.policy.zero_size
        self.rank = self.group.rank if self.degree > 1 else 0
        pax = self.policy.param_axes if self.policy.param_axes is not None else self.policy.zero_axes
        self.pgroup = groups.get_group(pax) if pax else self.group
        self.pdegree = self.pgroup.size if pax else 1
        self.prank = self.pgroup.rank if self.pdegree > 1 else 0
        dp_axes = [ax for ax in groups.get_data_parallel_axes() if mesh.shape.get(ax, 1) > 1]
        rep = tuple(ax for ax in dp_axes if ax not in self.policy.zero_axes)
        prep = tuple(ax for ax in dp_axes if ax not in pax)
        self.zrep = groups.get_group(rep) if rep else None
        self.prep = groups.get_group(prep) if prep else None
        self.qwz = None
        self.masters: Dict[str, torch.Tensor] = {}
        self.expert_names = frozenset(expert_names)
        epolicy = None
        if self.expert_names:
            epolicy = ZeroShardingPolicy(stage, mesh=mesh, persistence_threshold=persistence_threshold,
                                         zero_axes=groups.EXPERT_ZERO_AXES)
            egroup = groups.get_group(epolicy.zero_axes) if epolicy.zero_axes else None
            self._expert_of = (egroup, epolicy.zero_size, egroup.rank if epolicy.zero_size > 1 else 0)
        names = reference_names(module)
        # without a secondary partition the three placements agree at stage
        # 3 (one rule, one threshold), which the engine relies on: the
        # optimizer covers the masters' chunks (hpZ relays them: ``relayout``)
        self.param_dim, self.grad_dim, self.opt_dim, self.shapes, self.transposed = {}, {}, {}, {}, {}
        taken = taken or {}
        for name, p in module.named_parameters():
            transposed = names[name][1]
            ref = reference_shape(p.shape, transposed)
            self.shapes[name] = tuple(p.shape)
            self.transposed[name] = transposed
            pol = epolicy if name in self.expert_names else self.policy
            held = taken.get(name)
            if held is not None:  # the reference's layout of the dimension
                held = (port_dim(held[0], p.ndim, transposed), held[1])
            self.param_dim[name] = port_dim(pol.param_dim(ref, held), p.ndim, transposed)
            self.grad_dim[name] = port_dim(pol.grad_dim(ref, held), p.ndim, transposed)
            self.opt_dim[name] = port_dim(pol.opt_dim(ref, held), p.ndim, transposed)
        self.units = []
        self.unowned = set()
        self.leaves: Dict[str, torch.Tensor] = {}
        self.bypass = False
        if stage >= 3 and self.pdegree > 1:
            self._build_units(module)

    @property
    def partitioned(self) -> bool:
        return self.degree > 1

    @property
    def params_partitioned(self) -> bool:
        """Whether stage 3 partitions the parameters (over ``pgroup``)."""
        return self.stage >= 3 and self.pdegree > 1

    @property
    def relayout(self) -> bool:
        """Whether the optimizer's chunks differ from the parameters' (hpZ
        at stage 3: the masters move between the two layouts each step)."""
        return self.params_partitioned and (self.pgroup.ranks != self.group.ranks or self.param_dim != self.opt_dim)

    def _of(self, param, name=None):
        if name in self.expert_names:
            return self._expert_of
        return (self.pgroup, self.pdegree, self.prank) if param else (self.group, self.degree, self.rank)

    # -- moving tensors ------------------------------------------------------
    def shard(self, t: torch.Tensor, dim: Optional[int], param: bool = False, name=None) -> torch.Tensor:
        """This rank's chunk of ``t`` along ``dim`` (``t`` itself when None)."""
        _, degree, rank = self._of(param, name)
        if dim is None or degree == 1:
            return t
        n = t.shape[dim] // degree
        return t.narrow(dim, rank * n, n).clone()

    def gather(self, t: torch.Tensor, dim: Optional[int], param: bool = False, name=None) -> torch.Tensor:
        """The whole tensor from every rank's chunk along ``dim``."""
        group, degree, _ = self._of(param, name)
        if dim is None or degree == 1:
            return t
        moved = t.movedim(dim, 0).contiguous()
        full = dist.all_gather_into_tensor(moved, group=group)
        return full.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: Optional[int], param: bool = False, name=None) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of every rank's ``t``."""
        group, _, _ = self._of(param, name)
        moved = t.movedim(dim, 0).contiguous()
        part = dist.reduce_scatter_tensor(moved, op=ReduceOp.SUM, group=group)
        return part.movedim(0, dim).contiguous()

    def all_reduce(self, t: torch.Tensor, op=ReduceOp.SUM) -> torch.Tensor:
        return dist.all_reduce(t, op=op, group=self.group) if self.degree > 1 else t

    def replica_all_reduce(self, t: torch.Tensor, param: bool = False) -> torch.Tensor:
        """``t`` (a chunk reduced within its group) summed over the ranks
        that hold the same chunk."""
        rep = self.prep if param else self.zrep
        return dist.all_reduce(t, group=rep) if rep is not None else t

    def shard_param(self, t, name):
        return self.shard(t, self.param_dim[name], param=True, name=name) if self.params_partitioned else t

    def gather_param(self, t, name):
        return self.gather(t, self.param_dim[name], param=True, name=name) if self.params_partitioned else t

    def param_to_opt(self, t, name):
        """A parameter-layout chunk as this rank's optimizer chunk."""
        return self.shard(self.gather_param(t, name), self.opt_dim[name])

    def opt_to_param(self, t, name):
        """An optimizer-layout chunk as this rank's parameter chunk."""
        return self.shard_param(self.gather(t, self.opt_dim[name]), name)

    # -- what each rank holds --------------------------------------------------
    def local_numel(self, name: str, dim_of) -> int:
        """Elements this rank holds of ``name`` under a placement
        (``self.param_dim``, ``self.grad_dim`` or ``self.opt_dim``)."""
        n = 1
        for s in self.shapes[name]:
            n *= s
        degree = self._of(dim_of is self.param_dim, name)[1]
        return n // degree if dim_of[name] is not None else n

    # -- stage 3: the units ----------------------------------------------------
    def _build_units(self, module):
        owner = {id(p): n for n, p in module.named_parameters()}
        taken = set()
        chosen = []
        for mod_name, mod in module.named_modules():
            if any(mod_name == t or mod_name.startswith(t + ".") for t in taken):
                continue
            if isinstance(mod, torch.nn.ModuleList):
                for i, child in enumerate(mod):
                    chosen.append(child)
                    taken.add(f"{mod_name}.{i}" if mod_name else str(i))
            elif mod_name and any(True for _ in mod.parameters(recurse=False)):
                chosen.append(mod)
                taken.add(mod_name)
        self.unowned = set(owner.values())
        for mod in chosen:
            params = list(mod.parameters())
            params += [p for p in getattr(mod, "_dstpu_external_params", []) if id(p) in owner
                       and all(p is not q for q in params)]
            if not params:
                continue
            unit = _Unit(self, mod, [owner[id(p)] for p in params], params)
            self.units.append(unit)
            self.unowned -= set(unit.names)
        # a parameter the root module owns directly runs in no unit: it stays whole
        for name in self.unowned:
            self.param_dim[name] = self.grad_dim[name] = self.opt_dim[name] = None
        logger.info(f"ZeRO-3 over {self.pdegree} ranks: {len(self.units)} units gather their parameters "
                    f"layer by layer; {len(self.unowned)} parameter(s) outside any unit stay whole")

    def set_leaves(self, masters: Dict[str, torch.Tensor], dtype):
        """The tensors the engine differentiates at stage 3: each unit
        parameter's chunk (or whole, if replicated) in the compute dtype,
        from the f32 masters this rank holds."""
        self.masters = masters
        for unit in self.units:
            for name in unit.names:
                self.leaves[name] = masters[name].detach().to(dtype).requires_grad_(True)
            unit.release()

    @contextlib.contextmanager
    def gathered_module(self, full_params: Dict[str, torch.Tensor]):
        """Within the context the units' parameters hold ``full_params``
        (whole tensors, e.g. in the compute dtype) and the units run their
        modules' own forward: for code that needs the whole model, such as
        ``torch.func.functional_call``."""
        if not self.units:
            yield
            return
        for unit in self.units:
            unit.install([full_params[n] for n in unit.names])
        self.bypass = True
        try:
            yield
        finally:
            self.bypass = False
            for unit in self.units:
                unit.release()

    def detach(self):
        """Give every unit's module its own forward back."""
        for unit in self.units:
            unit.restore()
        self.units = []


class _Unit:
    """One module whose parameters are gathered for its forward and
    backward (see the module doc)."""

    def __init__(self, part: ZeroPartitioner, module, names, params):
        self.part = part
        self.module = module
        self.names = names
        self.params = params
        self.dims = [part.param_dim[n] for n in names]
        self.inner = module.forward
        module.forward = self.forward

    def restore(self):
        self.module.forward = self.inner

    def forward(self, *args, **kwargs):
        if self.part.bypass:
            return self.inner(*args, **kwargs)
        if kwargs:
            raise TypeError("a ZeRO-3 unit's forward takes positional arguments only")
        leaves = [self.part.leaves[n] for n in self.names]
        return _GatheredUnit.apply(self, len(args), *args, *leaves)

    def gather(self, leaves):
        part = self.part
        out = []
        for name, leaf, d in zip(self.names, leaves, self.dims):
            if part.qwz is not None and part.qwz.applies(name, d):
                out.append(part.qwz.gather(name, part.masters[name], d))
            else:
                out.append(part.gather(leaf.detach(), d, param=True, name=name))
        return out

    def install(self, fulls):
        for p, full in zip(self.params, fulls):
            p.data = full

    def release(self):
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)


class _GatheredUnit(torch.autograd.Function):
    """A unit's forward over its gathered parameters (see the module doc)."""

    @staticmethod
    def forward(ctx, unit, n_args, *inputs):
        args, leaves = inputs[:n_args], inputs[n_args:]
        ctx.unit = unit
        ctx.n_args = n_args
        ctx.arg_is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.plain_args = [None if t else a for a, t in zip(args, ctx.arg_is_tensor)]
        ctx.save_for_backward(*[a for a in args if isinstance(a, torch.Tensor)], *leaves)
        unit.install(unit.gather(leaves))
        try:
            out = unit.inner(*args)
        finally:
            unit.release()
        outs = out if isinstance(out, tuple) else (out, )
        if not all(isinstance(o, torch.Tensor) for o in outs):
            raise TypeError(f"a ZeRO-3 unit must return a tensor or a tuple of tensors, got {type(out).__name__}")
        return out

    @staticmethod
    def backward(ctx, *grad_outs):
        from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import recompute_disabled

        unit = ctx.unit
        saved = ctx.saved_tensors
        n_tensor_args = sum(ctx.arg_is_tensor)
        tensor_args, leaves = saved[:n_tensor_args], saved[n_tensor_args:]
        it = iter(tensor_args)
        args = []
        for is_tensor, plain in zip(ctx.arg_is_tensor, ctx.plain_args):
            if not is_tensor:
                args.append(plain)
                continue
            a = next(it).detach()
            args.append(a.requires_grad_(True) if a.is_floating_point() else a)
        unit.install(unit.gather(leaves))
        try:
            with torch.enable_grad(), recompute_disabled():
                out = unit.inner(*args)
            outs = out if isinstance(out, tuple) else (out, )
            grad_outs = [torch.zeros_like(o) if g is None else g for o, g in zip(outs, grad_outs)]
            wrt = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad] + list(unit.params)
            grads = torch.autograd.grad(outs, wrt, grad_outs, allow_unused=True)
        finally:
            unit.release()
        n_wrt_args = len(wrt) - len(unit.params)
        arg_grads = iter(grads[:n_wrt_args])
        out_args = []
        for a in args:
            out_args.append(next(arg_grads) if isinstance(a, torch.Tensor) and a.requires_grad else None)
        out_leaves = []
        for g, leaf, dim, name in zip(grads[n_wrt_args:], leaves, unit.dims, unit.names):
            if g is None:
                out_leaves.append(torch.zeros_like(leaf))
            elif dim is None:
                out_leaves.append(g)  # a replicated parameter: reduced at the boundary
            else:
                out_leaves.append(unit.part.reduce_scatter(g, dim, param=True, name=name))
        return (None, None, *out_args, *out_leaves)


# ------------------------------------------------------------- zero.Init ------
class Init:
    """``with zero.Init(config_dict_or_path=...):`` around model
    construction. As in the reference it is a declaration: it records that
    the user asked for construction-time partitioning, and the next engine
    consumes the demand. The port's modules are built whole on the host and
    partitioned by the engine (``ZeroPartitioner``), which says so."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config_dict_or_path=None, config=None, enabled=True, dtype=None, mpu=None,
                 zero_param_parallel_group=None, zero_quantized_weights=False,
                 zero_quantized_nontrainable_weights=False, sequence_data_parallel_group=None, param_swapper=None):
        self.enabled = enabled
        self.config = config_dict_or_path if config_dict_or_path is not None else config

    def __enter__(self):
        if self.enabled:
            _INIT_CONTEXT["active"] = True
            _INIT_CONTEXT["demanded"] = True
            _INIT_CONTEXT["config"] = self.config
            logger.info("zero.Init: the engine partitions the parameters when it is built")
        return self

    def __exit__(self, *exc):
        _INIT_CONTEXT["active"] = False
        _INIT_CONTEXT["config"] = None
        return False


def init_context_active() -> bool:
    return _INIT_CONTEXT["active"]


def init_context_demanded() -> bool:
    return _INIT_CONTEXT["active"] or _INIT_CONTEXT["demanded"]


def consume_init_context():
    _INIT_CONTEXT["demanded"] = False


def snapshot_and_clear_init_demand() -> bool:
    """Consume the demand at engine-init entry: it applies to exactly the
    next engine built in this process."""
    demanded = init_context_demanded()
    consume_init_context()
    return demanded


_SAVED = {"state": None}


def shutdown_init_context():
    _SAVED["state"] = dict(_INIT_CONTEXT)
    _INIT_CONTEXT["active"] = False


def restore_init_context():
    if _SAVED["state"] is not None:
        saved = _SAVED["state"]
        _SAVED["state"] = None
        saved["demanded"] = _INIT_CONTEXT["demanded"]
        _INIT_CONTEXT.update(saved)


class GatheredParameters:
    """``with GatheredParameters(engine) as g:``: whole host copies of the
    (possibly partitioned) f32 masters in ``g.params``, gathered from every
    rank (a collective: every rank enters it). Edit them and call
    ``g.update(engine)`` to write them back through the partitioning;
    leaving without ``update`` discards the edits (the reference's
    ``modifier_rank=None``). A plain dict of tensors is copied as it is."""

    def __init__(self, params, modifier_rank: Optional[int] = None, fwd_module=None, enabled: bool = True):
        self._src = params
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self.params: Any = None

    def __enter__(self):
        if self.enabled:
            src = self._src.full_params() if hasattr(self._src, "full_params") else self._src
            self.params = {k: v.detach().cpu().clone() for k, v in src.items()}
        return self

    def __exit__(self, *exc):
        return False

    def update(self, engine):
        engine.load_module_state_dict(self.params)


def register_external_parameter(module, parameter):
    """``parameter`` is used in ``module``'s forward though another module
    owns it: at stage 3 ``module``'s unit gathers it too."""
    ext = module.__dict__.setdefault("_dstpu_external_params", [])
    if all(parameter is not p for p in ext):
        ext.append(parameter)


def unregister_external_parameter(module, parameter):
    ext = module.__dict__.get("_dstpu_external_params", [])
    module.__dict__["_dstpu_external_params"] = [p for p in ext if p is not parameter]
