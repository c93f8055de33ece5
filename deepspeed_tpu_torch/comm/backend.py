"""Communication backend interface.

Port of ``deepspeed_tpu/comm/backend.py``. The port's one backend is
``torch.distributed`` (:class:`~deepspeed_tpu_torch.comm.comm.TorchBackend`),
over NCCL on the card or gloo on the host; its capability probes are the
ones torch answers.
"""


class Backend:

    def __init__(self, name="backend", rank=0, size=1):
        self.name = name
        self.world_group = None
        self.world_size = size
        self.world_rank = rank
        self.initialized = False

    def is_initialized(self):
        return self.initialized

    def new_group(self, ranks):
        raise NotImplementedError

    def init_process_group(self):
        self.initialized = True

    def destroy_process_group(self):
        self.initialized = False

    def has_all_gather_into_tensor(self):
        return True

    def has_reduce_scatter_tensor(self):
        return True

    def has_coalescing_manager(self):
        return False

    def has_all_reduce_coalesced(self):
        return True
