"""Parallel-group registry: a grid of ranks whose named axes are the groups.

Port of ``deepspeed_tpu/utils/groups.py``. The reference lays the devices
of one ``jax.sharding.Mesh`` out along the named axes

    ('pipe', 'data', 'hpz', 'expert', 'seq', 'model')

and passes axis names to its collectives. The port runs one process a rank
(``launcher/launch.py``), so its mesh is a grid of ranks in the same order:
rank ``r`` takes the place of device ``r`` of the reference's
``np.asarray(devices).reshape(topo.shape)``. A group is this rank's slice
of the grid along some axes; :func:`get_group` gives it with its
``torch.distributed`` process group (made the first time the axes are
asked for, by every rank at once: the collectives that ask are called by
every rank in the same order). Groups of one rank need no process group,
and a group of the whole world is torch's world group.

The axis meanings, the getters and the ``TopologyError`` cases are the
reference's: ``model`` (tensor parallel), ``seq`` (Ulysses), ``expert``
(carved from the data-parallel ranks), ``hpz`` (ZeRO++ secondary
partition), ``data`` and ``pipe``; ZeRO partitions over
``('data', 'hpz', 'expert', 'seq')``, and an expert bank over the same
less ``expert`` (``EXPERT_ZERO_AXES``). Any of the axes may be larger
than 1 at once: rank ``r``'s coordinates are those of ``r`` in the grid, so
the ``model`` ranks of one (expert, seq, data) slot are neighbours, as the
reference's ``initialize_mesh`` lays its devices out.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
HPZ_AXIS = "hpz"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, HPZ_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

DATA_PARALLEL_AXES = (DATA_AXIS, HPZ_AXIS, EXPERT_AXIS)  # dense-param DP group
EXPERT_DATA_PARALLEL_AXES = (DATA_AXIS, HPZ_AXIS)  # expert-param DP group
SEQ_DATA_PARALLEL_AXES = (DATA_AXIS, HPZ_AXIS, EXPERT_AXIS, SEQ_AXIS)  # ZeRO partition group
SECONDARY_PARTITION_AXES = (HPZ_AXIS, EXPERT_AXIS, SEQ_AXIS)  # hpZ/MiCS shard group
# an expert bank's ZeRO and gradient group: the ZeRO axes its expert
# placement leaves free (reference zero/policy.py::_add_zero_axes), the
# ranks that hold the same experts for other tokens
EXPERT_ZERO_AXES = (DATA_AXIS, HPZ_AXIS, SEQ_AXIS)

_MESH = None  # the process-global RankMesh


class TopologyError(ValueError):
    pass


@dataclass
class MeshTopology:
    """Degrees of each parallel dimension; multiplies to the world size."""

    pipe: int = 1
    data: int = 1
    hpz: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pipe, self.data, self.hpz, self.expert, self.seq, self.model)

    def world_size(self) -> int:
        return int(np.prod(self.shape))


@dataclass
class RankGroup:
    """This rank's group along ``axes``: the member ranks in group order,
    this rank's index among them, and the process group (None: torch's
    world group, or no group at all for one rank)."""

    axes: Tuple[str, ...]
    ranks: List[int]
    rank: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def _world():
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


class RankMesh:
    """The ranks laid out in ``MESH_AXES`` order (the reference's ``Mesh``
    with ranks for devices): ``shape`` maps each axis to its size,
    ``devices`` is the rank grid, ``size`` the world."""

    axis_names = MESH_AXES

    def __init__(self, ranks: np.ndarray, rank: int):
        self.devices = np.asarray(ranks).reshape(tuple(ranks.shape))
        self.shape = dict(zip(MESH_AXES, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = int(rank)
        self._groups = {}

    def _slices(self, axes):
        """Every group along ``axes``: for each coordinate of the other axes,
        the ranks that vary along ``axes`` (in ``axes`` order, row-major)."""
        others = [a for a in MESH_AXES if a not in axes]
        moved = np.transpose(self.devices, [MESH_AXES.index(a) for a in others + list(axes)])
        return [list(map(int, row)) for row in moved.reshape(-1, int(np.prod([self.shape[a] for a in axes])))]

    def group(self, axes: Tuple[str, ...]) -> RankGroup:
        axes = tuple(axes)
        for ax in axes:
            if ax not in MESH_AXES:
                raise TopologyError(f"mesh axis {ax!r} not in {MESH_AXES}")
        if axes in self._groups:
            return self._groups[axes]
        slices = self._slices(axes)
        mine = next(s for s in slices if self.rank in s)
        pg = None
        if 1 < len(mine) < self.size:
            import torch.distributed as tdist
            # every rank makes every group of this axis set, in one order
            for s in slices:
                made = tdist.new_group(s)
                if s is mine:
                    pg = made
        g = RankGroup(axes=axes, ranks=mine, rank=mine.index(self.rank), pg=pg)
        self._groups[axes] = g
        return g

    def subgroup(self, axes: Tuple[str, ...], positions) -> Optional[RankGroup]:
        """This rank's group of the members at ``positions`` of each slice
        along ``axes`` (the stages that hold one tied layer, say), made by
        every rank at once like :meth:`group`; None when this rank is not
        among them."""
        axes, positions = tuple(axes), tuple(positions)
        slices = self._slices(axes)
        if positions == tuple(range(len(slices[0]))):
            return self.group(axes)
        key = (axes, positions)
        if key not in self._groups:
            import torch.distributed as tdist
            mine = None
            for s in slices:
                ranks = [s[i] for i in positions]
                made = tdist.new_group(ranks)
                if self.rank in ranks:
                    mine = RankGroup(axes=axes, ranks=ranks, rank=ranks.index(self.rank), pg=made)
            self._groups[key] = mine
        return self._groups[key]


def initialize_mesh(
    *,
    data_parallel_size: Optional[int] = None,
    model_parallel_size: int = 1,
    pipe_parallel_size: int = 1,
    expert_parallel_size: int = 1,
    sequence_parallel_size: int = 1,
    secondary_partition_size: int = 1,
    devices=None,
    force: bool = False,
):
    """Build (or rebuild) the rank grid. ``devices`` are the ranks in grid
    order (every rank of the world by default); ``data_parallel_size=None``
    infers it from their count, as the reference's dp = world // (mp*pp).
    ``secondary_partition_size`` splits the data dimension into
    (data // k, hpz=k)."""
    global _MESH
    if _MESH is not None and not force:
        return _MESH
    world, rank = _world()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    fixed = model_parallel_size * pipe_parallel_size * expert_parallel_size * sequence_parallel_size
    if n % fixed != 0:
        raise TopologyError(f"device count {n} not divisible by mp*pp*ep*sp = {fixed}")
    if data_parallel_size is None:
        data_parallel_size = n // fixed
    k = max(1, secondary_partition_size)
    if data_parallel_size % k != 0:
        raise TopologyError(f"data degree {data_parallel_size} not divisible by secondary partition size {k}")
    topo = MeshTopology(pipe=pipe_parallel_size, data=data_parallel_size // k, hpz=k, expert=expert_parallel_size,
                        seq=sequence_parallel_size, model=model_parallel_size)
    if topo.world_size() != n:
        raise TopologyError(f"mesh shape {topo.shape} (= {topo.world_size()}) != device count {n}")
    if sorted(ranks) != list(range(world)):
        raise TopologyError(f"the mesh's ranks {ranks} are not the world's {list(range(world))}")
    _MESH = RankMesh(np.asarray(ranks).reshape(topo.shape), rank)
    logger.info(f"initialized mesh pipe={topo.pipe} data={topo.data} hpz={topo.hpz} expert={topo.expert} "
                f"seq={topo.seq} model={topo.model} over {n} ranks")
    return _MESH


def mesh_is_initialized() -> bool:
    return _MESH is not None


def get_mesh():
    if _MESH is None:
        initialize_mesh()
    return _MESH


def set_mesh(mesh):
    """Install a mesh built elsewhere (its axes must be ``MESH_AXES``)."""
    global _MESH
    for ax in mesh.axis_names:
        if ax not in MESH_AXES:
            raise TopologyError(f"external mesh axis {ax!r} not in {MESH_AXES}")
    _MESH = mesh
    return _MESH


def destroy_mesh():
    """Reset the global state (tests; a new process group needs a new mesh)."""
    global _MESH
    _MESH = None


def _axis_size(axes) -> int:
    mesh = get_mesh()
    if isinstance(axes, str):
        axes = (axes, )
    size = 1
    for ax in axes:
        size *= mesh.shape.get(ax, 1)
    return size


def get_group(axes) -> RankGroup:
    """This rank's group along ``axes`` (a name or a tuple of names)."""
    if isinstance(axes, str):
        axes = (axes, )
    return get_mesh().group(tuple(axes))


def world_group() -> RankGroup:
    """Every rank, in rank order (the world's process group)."""
    world, rank = _world()
    return RankGroup(axes=MESH_AXES, ranks=list(range(world)), rank=rank, pg=None)


# ---- world-size accessors (reference: groups.py getters) -------------------------
def get_model_parallel_world_size() -> int:
    return _axis_size(MODEL_AXIS)


def get_sequence_parallel_world_size() -> int:
    return _axis_size(SEQ_AXIS)


def get_pipe_parallel_world_size() -> int:
    return _axis_size(PIPE_AXIS)


def get_expert_parallel_world_size() -> int:
    return _axis_size(EXPERT_AXIS)


def get_data_parallel_world_size() -> int:
    """Dense-parameter DP degree (reference dp = world // (mp*pp))."""
    return _axis_size(DATA_PARALLEL_AXES)


def get_expert_data_parallel_world_size() -> int:
    return _axis_size(EXPERT_DATA_PARALLEL_AXES)


def get_sequence_data_parallel_world_size() -> int:
    """The ZeRO partition degree (sp * dp)."""
    return _axis_size(SEQ_DATA_PARALLEL_AXES)


def get_world_size() -> int:
    return get_mesh().size


def get_data_parallel_rank() -> int:
    """This rank's index in its data-parallel group."""
    return get_group(DATA_PARALLEL_AXES).rank


# ---- axis-name accessors: pass these to the collectives ---------------------------
def get_data_parallel_axes() -> Tuple[str, ...]:
    return DATA_PARALLEL_AXES


def get_expert_parallel_axis() -> str:
    return EXPERT_AXIS


def get_sequence_parallel_axis() -> str:
    return SEQ_AXIS


def get_model_parallel_axis() -> str:
    return MODEL_AXIS


def get_pipe_parallel_axis() -> str:
    return PIPE_AXIS


def get_zero_partition_axes() -> Tuple[str, ...]:
    return SEQ_DATA_PARALLEL_AXES


def get_secondary_partition_axes() -> Tuple[str, ...]:
    """hpZ/MiCS shard-group axes (the intra-node slice of the ZeRO group)."""
    return SECONDARY_PARTITION_AXES

