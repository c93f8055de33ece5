"""Cartesian process topology (pure rank math).

Port of ``deepspeed_tpu/runtime/pipe/topology.py`` (``ProcessTopology``,
``PipeDataParallelTopology``, ``PipelineParallelGrid``): the mapping between
(pipe, data, model) coordinates and ranks, which in the port are processes
(``utils/groups.py`` lays them out the same way).
"""

from collections import namedtuple
from itertools import product


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates <-> linear ranks; axes ordered
    outermost-first (reference topology.py:12)."""

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() requires all axes: {self.axes}")
        key = self.ProcessCoord(**coord_kwargs)
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_", outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology")

    def get_axis_comm_lists(self, axis):
        """Lists of ranks that vary only along ``axis`` (the reference's group
        construction primitive)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for combo in product(*ranges):
            fixed = dict(zip(other_axes, combo))
            ranks = [self.get_rank(**{axis: i, **fixed}) for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        """Ranks whose coordinates match all filters."""

        def matches(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return [self.mapping[c] for c in sorted(self.mapping.keys(), key=lambda c: self.mapping[c]) if matches(c)]

    def get_slice(self, **filter_kwargs):
        return self.filter_match(**filter_kwargs)

    def world_size(self):
        size = 1
        for d in self.dims:
            size *= d
        return size

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """Reference: axes=['pipe','data'] — adjacent pipe stages map to adjacent
    ranks (intra-node P2P), data-parallel groups span nodes."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """Reference: axes=['pipe','data','model'] for 3D parallelism."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Axis world sizes and ranks of this process over a topology (reference
    ``topology.py:251``)."""

    def __init__(self, topology=None, process_group=None):
        import torch.distributed as tdist
        initialized = tdist.is_available() and tdist.is_initialized()
        self.global_rank = tdist.get_rank() if initialized else 0
        if topology is None:
            world = tdist.get_world_size() if initialized else 1
            topology = PipeDataParallelTopology(1, world)
        self._topo = topology
        self.data_parallel_size = max(topology.get_dim("data"), 1)
        self.pipe_parallel_size = max(topology.get_dim("pipe"), 1)
        self.model_parallel_size = max(topology.get_dim("model"), 1)
        self.slice_parallel_size = self.model_parallel_size
        self.world_size = topology.world_size()

    def get_stage_id(self, rank=None):
        rank = self.global_rank if rank is None else rank
        return getattr(self._topo.get_coord(rank), "pipe", 0)

    def get_data_parallel_id(self, rank=None):
        rank = self.global_rank if rank is None else rank
        return getattr(self._topo.get_coord(rank), "data", 0)

    def get_pipe_parallel_rank(self):
        return self.get_stage_id()

    def get_data_parallel_rank(self):
        return self.get_data_parallel_id()

    def get_model_parallel_rank(self):
        return getattr(self._topo.get_coord(self.global_rank), "model", 0)

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_global_rank(self):
        return self.global_rank

    def stage_to_global(self, stage_id, **kwargs):
        me = self._topo.get_coord(self.global_rank)
        transform = me._replace(pipe=stage_id, **kwargs)._asdict()
        return self._topo.get_rank(**transform)

    def topology(self):
        return self._topo

    # first/last stage queries (reference engine uses these constantly)
    @property
    def is_first_stage(self):
        return self.get_stage_id() == 0

    @property
    def is_last_stage(self):
        return self.get_stage_id() == self.pipe_parallel_size - 1
