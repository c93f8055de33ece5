"""Public collectives API over ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py``, whose surface mirrors
``torch.distributed``. Where the reference acts on one array ``x:[G, ...]``
whose shard ``i`` plays rank ``i``'s tensor, the port runs one process a
rank and each call takes that rank's local tensor: rank ``i`` passes what is
``x[i]`` there, and gets back what row ``i`` of the reference's result is.

- ``all_reduce(t, op, group)``: every rank's ``t`` becomes the reduction
  over the group (written in place, as torch does, and returned);
- ``all_gather_into_tensor(t, group)``: ``t:[s, ...]`` -> ``[G*s, ...]``,
  the ranks' tensors concatenated in group order;
- ``reduce_scatter_tensor(t, op, group)``: ``t:[G*s, ...]`` -> ``[s, ...]``,
  group rank ``i`` keeps the sum over ranks of chunk ``i``;
- ``all_to_all_single(t, group)``: ``t:[G, ...]`` -> ``[G, ...]``, chunk
  ``j`` of rank ``i`` lands as chunk ``i`` of rank ``j``;
- ``broadcast(t, src, group)``: every rank's ``t`` becomes group rank
  ``src``'s (in place, and returned);
- ``scatter(t, src, group)``: ``t:[G*c, ...]`` -> ``[c, ...]``, chunk ``i``
  of group rank ``src``'s tensor.

The reference's calling convention is kept (the tensor first, the result
returned), so code written against it runs unchanged. ``group`` is a mesh
axis name or a tuple of them (``utils/groups.py``: the group of this rank's
slice along those axes), or a group from :func:`new_group`; None is the
dense data-parallel group, as there.

Backends: ``init_distributed`` picks ``nccl`` for a CUDA device and
``gloo`` for the CPU, and never switches by itself: gloo runs on CUDA
tensors only when the caller names it. Gloo has CUDA implementations of
``all_reduce`` and ``broadcast`` only; the other collectives' CUDA tensors
are copied to the host, reduced there and copied back, explicitly, and the
comms logger counts each such copy (``comms_logger.host_staged``). Without
a process group (one process, none asked for) every collective is that of
a group of one (a process group of one rank, such as NCCL at world 1, is
still called).

Point-to-point ``send``/``recv``/``isend``/``irecv`` (the pipeline engine's
neighbour exchange) take global ranks, as ``torch.distributed``'s do. The
reference raises there (one SPMD program has no point-to-point; its
pipeline moves activations with ``ppermute``): this is a deliberate
departure, since the port runs one process a pipeline stage. Gloo has no
CUDA point-to-point, so a CUDA tensor goes through the host and is counted
in ``comms_logger.host_staged`` like the staged collectives.

The process group is destroyed at interpreter exit, as the reference's
``jax.distributed`` client is shut down at exit: a gloo group left to the
interpreter's teardown can abort the process ("terminate called without an
active exception") after its work finished.
"""

import atexit
import datetime
import functools
import os
import socket
import time

import torch
import torch.distributed as tdist

from deepspeed_tpu_torch.comm.backend import Backend
from deepspeed_tpu_torch.comm.constants import GLOO_BACKEND, NCCL_BACKEND
from deepspeed_tpu_torch.comm.reduce_op import ReduceOp
from deepspeed_tpu_torch.utils import groups as groups_mod
from deepspeed_tpu_torch.utils.comms_logging import CommsLogger
from deepspeed_tpu_torch.utils.logging import logger

cdb = None  # current distributed backend (reference: comm.py:41)
comms_logger = CommsLogger()
timers = {}

# the collectives gloo implements for CUDA tensors; the others are staged
# through the host when the caller runs gloo on the card
_GLOO_CUDA_OPS = ("all_reduce", "broadcast")


class TorchBackend(Backend):
    """The one backend: ``torch.distributed`` over NCCL or gloo (or no
    process group at all, for one process that asked for none)."""

    def __init__(self, name, rank, size, process_group_initialized):
        super().__init__(name=name, rank=rank, size=size)
        self.process_group_initialized = process_group_initialized
        self.init_process_group()


def is_initialized():
    return cdb is not None


def _env_contract(auto_mpi_discovery, distributed_port):
    """(coordinator, world size, rank) from the reference's environment
    contract (``comm.py:60-108``): ``DSTPU_COORDINATOR`` or
    ``COORDINATOR_ADDRESS``, ``DSTPU_NUM_PROCESSES`` or ``WORLD_SIZE``,
    ``DSTPU_PROCESS_ID`` or ``RANK``, and OpenMPI's variables."""
    env = os.environ
    coord = env.get("DSTPU_COORDINATOR") or env.get("COORDINATOR_ADDRESS")
    nproc = int(env.get("DSTPU_NUM_PROCESSES", env.get("WORLD_SIZE", "0")) or 0)
    proc_id = env.get("DSTPU_PROCESS_ID", env.get("RANK"))
    if coord is None and auto_mpi_discovery and "OMPI_COMM_WORLD_SIZE" in env:
        nproc = int(env["OMPI_COMM_WORLD_SIZE"])
        proc_id = env["OMPI_COMM_WORLD_RANK"]
        coord = f"{env.get('MASTER_ADDR', 'localhost')}:{distributed_port}"
    return coord, nproc, int(proc_id or 0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(dist_backend=None,
                     auto_mpi_discovery=True,
                     distributed_port=29500,
                     verbose=True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank=-1,
                     world_size=-1,
                     device=None):
    """Join the gang: a ``torch.distributed`` process group over the
    reference's environment contract (explicit ``rank``/``world_size``/
    ``init_method`` win over it).

    ``dist_backend`` None takes the accelerator's: ``nccl`` for ``device``
    cuda (the default, which needs a GPU), ``gloo`` for ``device="cpu"``.
    A process group is made when there are several processes, or one with a
    coordinator, or when the caller names a backend (a gang of one over
    NCCL); otherwise the process is a world of one without one. Idempotent."""
    global cdb, _init_done_unix
    if cdb is not None:
        return cdb
    coord, nproc, proc_id = _env_contract(auto_mpi_discovery, distributed_port)
    if world_size is not None and world_size > 0:
        nproc = world_size
    if rank is not None and rank >= 0:
        proc_id = rank
    nproc = max(nproc, 1)
    named = dist_backend is not None
    if dist_backend is None:
        from deepspeed_tpu_torch.accelerator.real_accelerator import accelerator_for
        from deepspeed_tpu_torch.utils.device import resolve_device
        dist_backend = accelerator_for(resolve_device(device).type).communication_backend_name()
    want_group = tdist.is_initialized() or nproc > 1 or coord is not None or init_method is not None \
        or bool(dist_init_required) or named
    if want_group and not tdist.is_initialized():
        if init_method is None:
            init_method = f"tcp://{coord}" if coord is not None else f"tcp://127.0.0.1:{_free_port()}"
        kwargs = {}
        if timeout is not None:
            kwargs["timeout"] = timeout if isinstance(timeout, datetime.timedelta) \
                else datetime.timedelta(seconds=float(timeout))
        if dist_backend == NCCL_BACKEND and torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", proc_id)) % torch.cuda.device_count())
        tdist.init_process_group(backend=dist_backend, init_method=init_method, world_size=nproc, rank=proc_id,
                                 **kwargs)
        atexit.register(_destroy_at_exit)
        if verbose:
            logger.info(f"torch.distributed initialized: rank {proc_id}/{nproc} over {dist_backend} "
                        f"({init_method})")
    if tdist.is_initialized():
        cdb = TorchBackend(tdist.get_backend(), tdist.get_rank(), tdist.get_world_size(), True)
    else:
        cdb = TorchBackend(dist_backend, 0, 1, False)
    # every rank leaves init_process_group together (it rendezvouses), so
    # this instant is the gang's to within the release skew:
    # monitored_barrier uses it to reject a previous job's leftover files
    _init_done_unix = time.time()
    return cdb


_init_done_unix = None  # set by init_distributed


def _destroy_at_exit():
    """The group's teardown before the interpreter's (registered by
    ``init_distributed`` for the group it makes)."""
    if tdist.is_available() and tdist.is_initialized():
        try:
            tdist.destroy_process_group()
        except Exception as e:  # exiting anyway: say why the teardown failed
            logger.warning(f"process group teardown at exit failed: {e}")


def destroy_process_group(group=None):
    global cdb
    groups_mod.destroy_mesh()
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    cdb = None


def _has_pg():
    return tdist.is_available() and tdist.is_initialized()


def _live(g):
    """Whether a collective over ``g`` runs the backend: a group of several
    ranks, or the world's group of one (a gang of one over NCCL still
    calls NCCL); a one-rank slice of a larger world has nothing to call."""
    return g.size > 1 or (_has_pg() and tdist.get_world_size() == 1)


def get_rank(group=None):
    """This process's rank in the world."""
    return tdist.get_rank() if _has_pg() else 0


def get_world_size(group=None):
    """The number of ranks in ``group`` (mesh axes), or in the world if None."""
    if group is None:
        return tdist.get_world_size() if _has_pg() else 1
    return _resolve_group(group).size


def get_local_rank():
    return int(os.environ.get("LOCAL_RANK", 0))


def get_backend_name():
    return cdb.name if cdb is not None else None


# ---- groups -------------------------------------------------------------------------
def _resolve_group(group):
    """A :class:`groups.RankGroup` for ``group``: None is the dense
    data-parallel group (the whole world before a mesh exists), a name or a
    tuple of names is this rank's group along those axes."""
    if isinstance(group, groups_mod.RankGroup):
        return group
    if group is None:
        if not groups_mod.mesh_is_initialized():
            return groups_mod.world_group()
        group = groups_mod.get_data_parallel_axes()
    if isinstance(group, str):
        group = (group, )
    return groups_mod.get_group(tuple(group))


# ---- timing and staging ----------------------------------------------------------------
def timed_op(func):
    """Profile collectives through the comms logger and the telemetry
    layer (reference ``comm.py:101-134``). Disabled (the default) the
    wrapper costs two boolean checks."""
    from deepspeed_tpu_torch import telemetry

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not (comms_logger.enabled or telemetry.state.active):
            return func(*args, **kwargs)
        name = func.__name__
        tensor = args[0] if args else kwargs.get("tensor")
        t0 = time.time()
        result = func(*args, **kwargs)
        if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        elapsed = time.time() - t0
        size = tensor.numel() * tensor.element_size() if isinstance(tensor, torch.Tensor) else 0
        if comms_logger.enabled:
            n = _resolve_group(kwargs.get("group")).size
            comms_logger.append(name, kwargs.get("log_name") or name, elapsed, size, n=n)
        if telemetry.state.active:
            telemetry.record_comm_op(name, elapsed, size)
        return result

    return wrapper


def _staged(op, fn, inputs, outputs):
    """Run ``fn(*inputs, *outputs)``; where gloo has no CUDA implementation
    of ``op`` and the tensors are on the card, on host copies, copying the
    outputs back (counted in ``comms_logger.host_staged``)."""
    needs = cdb is not None and cdb.name == GLOO_BACKEND and op not in _GLOO_CUDA_OPS and \
        any(t.is_cuda for t in inputs + outputs)
    if not needs:
        fn(*inputs, *outputs)
        return outputs
    host_in = [t.cpu() for t in inputs]
    host_out = [torch.empty(t.shape, dtype=t.dtype) for t in outputs]
    fn(*host_in, *host_out)
    for dst, src in zip(outputs, host_out):
        dst.copy_(src)
    comms_logger.record_host_staging(op, sum(t.numel() * t.element_size() for t in inputs),
                                     sum(t.numel() * t.element_size() for t in outputs))
    return outputs


# torch's current names for the single-tensor collectives, else the older ones
_reduce_scatter_single = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor
_all_gather_single = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor

_TORCH_OPS = None


def _torch_op(op):
    global _TORCH_OPS
    if _TORCH_OPS is None:
        _TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM, ReduceOp.MAX: tdist.ReduceOp.MAX,
                      ReduceOp.MIN: tdist.ReduceOp.MIN, ReduceOp.PRODUCT: tdist.ReduceOp.PRODUCT,
                      ReduceOp.AVG: tdist.ReduceOp.SUM}
    if op not in _TORCH_OPS:
        raise NotImplementedError(f"ReduceOp {op} not supported")
    return _TORCH_OPS[op]


def _average(tensor, size):
    """AVG as SUM then a division (gloo has no AVG); integers floor-divide."""
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(size)
    else:
        tensor.floor_divide_(size)
    return tensor


# ---- collectives ------------------------------------------------------------------------
@timed_op
def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False, log_name=None):
    g = _resolve_group(group)
    if _live(g):
        _staged("all_reduce", lambda t: tdist.all_reduce(t, op=_torch_op(op), group=g.pg), [], [tensor])
        if op == ReduceOp.AVG:
            _average(tensor, g.size)
    return tensor


@timed_op
def inference_all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False, log_name=None):
    return all_reduce(tensor, op=op, group=group)


def _words(tensor):
    """``tensor`` as a collective that only moves it sends it: 16-bit floats
    whose last dimension (not dim 0) is even as int32 pairs, the same bytes
    (gloo has no 16-bit all-to-all); anything else as it is."""
    if tensor.dtype in (torch.bfloat16, torch.float16) and tensor.ndim > 1 and tensor.shape[-1] % 2 == 0:
        return tensor.view(torch.int32)
    return tensor


@timed_op
def all_gather_into_tensor(tensor, group=None, async_op=False, log_name=None):
    g = _resolve_group(group)
    tensor = tensor.contiguous()
    if not _live(g):
        return tensor.clone()
    moved = _words(tensor)
    out = torch.empty((g.size * moved.shape[0], ) + tuple(moved.shape[1:]), dtype=moved.dtype, device=moved.device)
    _staged("all_gather_into_tensor", lambda t, o: _all_gather_single(o, t, group=g.pg), [moved], [out])
    return out.view(tensor.dtype)


allgather_fn = all_gather_into_tensor


@timed_op
def reduce_scatter_tensor(tensor, op=ReduceOp.SUM, group=None, async_op=False, log_name=None):
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError("reduce_scatter supports SUM/AVG")
    g = _resolve_group(group)
    tensor = tensor.contiguous()
    if tensor.shape[0] % g.size:
        raise ValueError(f"reduce_scatter_tensor: dim 0 ({tensor.shape[0]}) must divide into {g.size} chunks")
    if not _live(g):
        return tensor.clone()
    out = torch.empty((tensor.shape[0] // g.size, ) + tuple(tensor.shape[1:]), dtype=tensor.dtype,
                      device=tensor.device)
    _staged("reduce_scatter_tensor", lambda t, o: _reduce_scatter_single(o, t, op=tdist.ReduceOp.SUM, group=g.pg),
            [tensor], [out])
    if op == ReduceOp.AVG:
        _average(out, g.size)
    return out


reduce_scatter_fn = reduce_scatter_tensor


@timed_op
def all_to_all_single(tensor, group=None, async_op=False, log_name=None):
    g = _resolve_group(group)
    tensor = tensor.contiguous()
    if tensor.shape[0] % g.size:
        raise ValueError(f"all_to_all_single: dim 0 ({tensor.shape[0]}) must divide into {g.size} chunks")
    if not _live(g):
        return tensor.clone()
    moved = _words(tensor)
    out = torch.empty_like(moved)
    _staged("all_to_all_single", lambda t, o: tdist.all_to_all_single(o, t, group=g.pg), [moved], [out])
    return out.view(tensor.dtype)


@timed_op
def broadcast(tensor, src=0, group=None, async_op=False, log_name=None):
    """``src`` is the rank's index within the group, as the reference's
    ``axis_index`` is."""
    g = _resolve_group(group)
    if _live(g):
        _staged("broadcast", lambda t: tdist.broadcast(t, src=g.ranks[src], group=g.pg), [], [tensor])
    return tensor


@timed_op
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, async_op=False, log_name=None):
    # as the reference: every rank gets the reduction
    return all_reduce(tensor, op=op, group=group)


def all_gather(tensor, group=None, async_op=False, log_name=None):
    """The reference's list-form all_gather: the ranks' tensors
    concatenated, as :func:`all_gather_into_tensor` gives them."""
    return all_gather_into_tensor(tensor, group=group)


def all_gather_coalesced(tensors, group=None, async_op=False):
    return [all_gather_into_tensor(t, group=group) for t in tensors]


def all_reduce_coalesced(tensors, op=ReduceOp.SUM, group=None, async_op=False):
    return [all_reduce(t, op=op, group=group) for t in tensors]


def all_to_all(tensor, group=None, async_op=False, log_name=None):
    return all_to_all_single(tensor, group=group)


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, async_op=False, log_name=None):
    return reduce_scatter_tensor(tensor, op=op, group=group)


def gather(tensor, dst=0, group=None, async_op=False, log_name=None):
    """As the reference: the gathered tensor on every rank."""
    return all_gather_into_tensor(tensor, group=group)


def scatter(tensor, src=0, group=None, async_op=False, log_name=None):
    """Group rank ``i`` receives chunk ``i`` of group rank ``src``'s tensor
    (dim 0 cut into one chunk a rank): the inverse of :func:`all_gather`."""
    g = _resolve_group(group)
    if tensor.ndim < 1:
        raise ValueError("scatter expects a tensor whose dim 0 is the flattened scatter list")
    if tensor.shape[0] % g.size != 0:
        raise ValueError(f"scatter: dim-0 size {tensor.shape[0]} must divide evenly into {g.size} chunks "
                         f"(the reference rejects unequal chunks too)")
    full = broadcast(tensor.clone(), src=src, group=g)
    chunk = tensor.shape[0] // g.size
    return full[g.rank * chunk:(g.rank + 1) * chunk].clone()


# -- point-to-point (a departure from the reference, which has none) ------------
def _p2p_via_host(tensor):
    """Whether a point-to-point transfer of ``tensor`` goes through the host
    (gloo has no CUDA send/recv)."""
    return cdb is not None and cdb.name == GLOO_BACKEND and tensor.is_cuda


def _p2p_ready():
    if not _has_pg():
        raise RuntimeError("point-to-point send/recv needs a process group of several ranks (init_distributed)")


class _StagedWork:
    """An ``isend``/``irecv`` whose CUDA tensor goes through a host copy:
    ``wait`` completes the transfer (and, for a receive, copies the host
    buffer into the tensor)."""

    def __init__(self, work, host, into=None):
        self._work = work
        self._host = host
        self._into = into

    def wait(self):
        self._work.wait()
        if self._into is not None:
            self._into.copy_(self._host)
            self._into = None
        return True

    def is_completed(self):
        return self._work.is_completed()


def _host_copy(tensor, op):
    host = tensor.detach().contiguous().cpu()
    comms_logger.record_host_staging(op, host.numel() * host.element_size(), 0)
    return host


def _host_buffer(tensor, op):
    comms_logger.record_host_staging(op, 0, tensor.numel() * tensor.element_size())
    return torch.empty(tensor.shape, dtype=tensor.dtype)


@timed_op
def send(tensor, dst, group=None, tag=0):
    """Send ``tensor`` to global rank ``dst`` (blocking)."""
    _p2p_ready()
    if _p2p_via_host(tensor):
        tdist.send(_host_copy(tensor, "send"), int(dst), tag=tag)
    else:
        tdist.send(tensor.contiguous(), int(dst), tag=tag)


@timed_op
def recv(tensor, src, group=None, tag=0):
    """Receive into ``tensor`` from global rank ``src`` (blocking);
    returns ``tensor``."""
    _p2p_ready()
    if _p2p_via_host(tensor):
        host = _host_buffer(tensor, "recv")
        tdist.recv(host, int(src), tag=tag)
        tensor.copy_(host)
    else:
        tdist.recv(tensor, int(src), tag=tag)
    return tensor


def isend(tensor, dst, group=None, tag=0):
    """Start sending ``tensor`` to global rank ``dst``; the returned work's
    ``wait()`` completes it. The tensor must not change before then."""
    _p2p_ready()
    if _p2p_via_host(tensor):
        host = _host_copy(tensor, "send")
        return _StagedWork(tdist.isend(host, int(dst), tag=tag), host)
    return tdist.isend(tensor.contiguous(), int(dst), tag=tag)


def irecv(tensor, src, group=None, tag=0):
    """Start receiving into ``tensor`` from global rank ``src``; it holds
    the data once the returned work's ``wait()`` returns."""
    _p2p_ready()
    if _p2p_via_host(tensor):
        host = _host_buffer(tensor, "recv")
        return _StagedWork(tdist.irecv(host, int(src), tag=tag), host, into=tensor)
    return tdist.irecv(tensor, int(src), tag=tag)


# -- groups / ranks -------------------------------------------------------------------
def get_world_group():
    """The whole world (None, as the reference's)."""
    return None


def new_group(ranks=None):
    """The world group (None) for no ranks or all of them. As in the
    reference, other rank sets are not groups of this API: the mesh axes
    are (``groups.initialize_mesh``)."""
    if ranks is None or sorted(ranks) == list(range(get_world_size())):
        return None
    raise NotImplementedError("arbitrary-rank groups: use mesh axis names "
                              "(groups.initialize_mesh) as the group structure")


def get_global_rank(group=None, group_rank=0):
    if group is None:
        return int(group_rank)
    raise NotImplementedError(
        "an axis-name group has one replica per remaining-mesh coordinate, so "
        "group_rank alone does not determine a global rank; take the group's ranks "
        "from groups.get_group(axes).ranks instead")


def get_all_ranks_from_group(group=None):
    """The group's ranks by their index in it, as the reference lists them."""
    return list(range(_resolve_group(group).size))


# -- capability probes ------------------------------------------------------------------
def is_available() -> bool:
    return tdist.is_available()


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def has_all_reduce_coalesced() -> bool:
    return True


def has_coalescing_manager() -> bool:
    return False


def set_backend(backend_name=None):
    ...  # init_distributed picks the backend; kept for API parity


def init_deepspeed_backend(ds_backend=None, timeout=None, init_method=None):
    ...  # init_distributed covers this


def mpi_discovery(distributed_port=29500, verbose=True):
    """The reference's OpenMPI discovery: the ``DSTPU_*`` contract from
    OpenMPI's variables. The coordinator comes from ``MASTER_ADDR`` (rank 0's
    host, which an OpenMPI launch exports) and ``distributed_port``."""
    env = os.environ
    if "OMPI_COMM_WORLD_RANK" not in env:
        return
    env.setdefault("DSTPU_PROCESS_ID", env["OMPI_COMM_WORLD_RANK"])
    env.setdefault("DSTPU_NUM_PROCESSES", env["OMPI_COMM_WORLD_SIZE"])
    if "DSTPU_COORDINATOR" not in env and "MASTER_ADDR" in env:
        env["DSTPU_COORDINATOR"] = f"{env['MASTER_ADDR']}:{distributed_port}"
    if "DSTPU_COORDINATOR" not in env:
        logger.warning("mpi_discovery: set DSTPU_COORDINATOR (or MASTER_ADDR) to rank 0's host:port yourself "
                       "or use the dstpu launcher (it exports the full contract)")
    if verbose:
        logger.info(f"mpi_discovery: rank={env['DSTPU_PROCESS_ID']} world={env['DSTPU_NUM_PROCESSES']} "
                    f"coordinator={env.get('DSTPU_COORDINATOR', 'UNSET')}")


# -- cloud-environment detectors -----------------------------------------------------
def in_aml() -> bool:
    return "AZUREML_EXPERIMENT_ID" in os.environ


def in_aws_sm() -> bool:
    return "SM_TRAINING_ENV" in os.environ


def in_dlts() -> bool:
    return "DLTS_JOB_ID" in os.environ


def patch_aml_env_for_torch_nccl_backend(*a, **k):
    ...


def patch_aws_sm_env_for_torch_nccl_backend(*a, **k):
    ...


def barrier(group=None):
    """Every rank of ``group`` arrives (the world's when None)."""
    if not _has_pg():
        return
    g = groups_mod.world_group() if group is None else _resolve_group(group)
    if _live(g):
        tdist.barrier(group=g.pg)


class BarrierTimeoutError(RuntimeError):
    """``monitored_barrier`` expired its deadline; the message names the
    absent ranks."""


DEFAULT_BARRIER_TIMEOUT_S = 300.0

# per-name generation counters: every rank reaches every barrier, so the
# counters of the gang's processes agree
_barrier_generations = {}


def _barrier_timeouts_metric():
    from deepspeed_tpu_torch import telemetry
    if not telemetry.is_active():
        return None
    return telemetry.get_registry().counter("barrier_timeouts_total",
                                            "monitored_barrier deadline expiries (absent ranks named in the error)")


def _barrier_rendezvous_dir():
    """Where ranks rendezvous: the gang dir when the elastic agent armed
    one, else a directory keyed by the coordinator and the job nonce under
    the temp dir (ranks of one host share it)."""
    from deepspeed_tpu_torch.elasticity.gang import GANG_DIR_ENV
    gang_dir = os.environ.get(GANG_DIR_ENV)
    if gang_dir:
        return os.path.join(gang_dir, "barriers")
    coord = os.environ.get("DSTPU_COORDINATOR") or os.environ.get("COORDINATOR_ADDRESS")
    if not coord:
        return None
    import hashlib
    import tempfile
    job = os.environ.get("DSTPU_JOB_ID", "")
    key = hashlib.sha1(f"{coord}|{job}".encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"dstpu_barrier_{key}")


def _file_barrier(bdir, name, generation, rank, world, timeout_s, poll_s=0.02, min_unix=None, on_wait=None):
    """Rendezvous: every rank drops ``<name>.g<gen>.rank<k>`` and polls until
    all ``world`` files of this generation exist. Expiry raises
    :class:`BarrierTimeoutError` naming the absent ranks. Files live one
    generation more (a peer may still be reading them), then each rank reaps
    its own older ones.

    ``min_unix``: accept only peer files stamped at or after it (a previous
    job's leftovers in a shared directory are older). ``on_wait`` is called
    once a poll while waiting."""
    import json
    os.makedirs(bdir, exist_ok=True)

    def fname(g, r):
        return os.path.join(bdir, f"{name}.g{g}.rank{r}")

    accepted = set()

    def present(g, r):
        if r in accepted:
            return True
        fp = fname(g, r)
        if not os.path.exists(fp):
            return False
        if min_unix is not None:
            try:
                with open(fp) as f:
                    if json.load(f).get("unix", 0) < min_unix:
                        return False
            except (OSError, ValueError):
                return False  # torn or stale: its owner rewrites it atomically
        accepted.add(r)
        return True

    from deepspeed_tpu_torch.elasticity.gang import atomic_write_json
    atomic_write_json(fname(generation, rank), {"rank": rank, "unix": time.time()})
    deadline = time.monotonic() + timeout_s
    while True:
        absent = [r for r in range(world) if not present(generation, r)]
        if not absent:
            break
        if time.monotonic() > deadline:
            m = _barrier_timeouts_metric()
            if m is not None:
                m.inc()
            raise BarrierTimeoutError(f"monitored_barrier {name!r} (generation {generation}) timed out after "
                                      f"{timeout_s:.1f}s: rank {rank} waited on absent ranks {absent} of world "
                                      f"{world}")
        if on_wait is not None:
            on_wait()
        time.sleep(poll_s)
    if generation >= 2:
        try:
            os.unlink(fname(generation - 2, rank))
        except OSError:
            pass


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False, name="monitored"):
    """A barrier that enforces its ``timeout`` (seconds or a
    ``timedelta``): expiry raises :class:`BarrierTimeoutError` naming the
    absent ranks and counts ``barrier_timeouts_total``. Ranks rendezvous
    through files (the gang dir when the elastic agent armed one, else a
    coordinator-keyed temp dir), so a dead rank times the barrier out
    instead of wedging its peers in a collective. One process passes at
    once; without a rendezvous dir the deadline cannot be enforced, which is
    logged, and the plain barrier runs."""
    world = get_world_size()
    if world <= 1:
        barrier(group)
        return
    if isinstance(timeout, datetime.timedelta):
        timeout_s = timeout.total_seconds()
    else:
        timeout_s = DEFAULT_BARRIER_TIMEOUT_S if timeout is None else float(timeout)
    bdir = _barrier_rendezvous_dir()
    if bdir is None:
        logger.warning("monitored_barrier: no rendezvous dir (set DSTPU_GANG_DIR or DSTPU_COORDINATOR); the timeout "
                       "cannot be enforced, falling back to a plain barrier")
        barrier(group)
        return
    rank = get_rank()
    # scoped by supervision life: a relaunched gang starts at generation 0
    name = f"{name}.l{os.environ.get('DSTPU_RESTART_COUNT', '0') or '0'}"
    generation = _barrier_generations.get(name, 0)
    _barrier_generations[name] = generation + 1
    # a rank waiting here behind a slow peer is making supervised progress:
    # it keeps beating (throttled) so the hang watchdog spares a healthy gang
    from deepspeed_tpu_torch.elasticity.gang import GANG_DIR_ENV, GangHeartbeat
    hb = GangHeartbeat.from_env(rank=rank)
    on_wait = None
    if hb is not None:
        hb.beat(phase=f"barrier:{name}")
        last_beat = [time.monotonic()]

        def on_wait():
            now = time.monotonic()
            if now - last_beat[0] >= 1.0:
                last_beat[0] = now
                hb.beat(phase=f"barrier:{name}")
    min_unix = None
    if not os.environ.get("DSTPU_JOB_ID") and not os.environ.get(GANG_DIR_ENV) and _init_done_unix is not None:
        min_unix = _init_done_unix - 5.0
    _file_barrier(bdir, name, generation, rank, world, timeout_s, min_unix=min_unix, on_wait=on_wait)
    barrier(group)


def log_summary(show_straggler=False):
    """Per-op communication statistics (reference ``comm.py:422``). With
    ``show_straggler`` over several processes it is a collective: call it on
    every rank."""
    return comms_logger.log_all(print_log=True, show_straggler=show_straggler)


def configure(deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None, debug=None):
    comms_logger.configure(deepspeed_config=deepspeed_config, enabled=enabled, prof_all=prof_all, prof_ops=prof_ops,
                           verbose=verbose, debug=debug)
