from deepspeed_tpu_torch.module_inject.auto_tp import auto_tp_specs
from deepspeed_tpu_torch.module_inject.layers import (EmbeddingLayer, LinearAllreduce, LinearLayer, Normalize,
                                                      apply_tensor_parallel, tp_slice)
