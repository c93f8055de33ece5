"""Pipeline parallelism: the module description, the instruction streams,
the stage executor and ``PipelineEngine``."""

from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.runtime.pipe.topology import (PipeDataParallelTopology, PipelineParallelGrid,
                                                       PipeModelDataParallelTopology, ProcessTopology)
