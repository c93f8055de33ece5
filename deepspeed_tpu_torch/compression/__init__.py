from deepspeed_tpu_torch.compression.compress import (get_compression_config, init_compression, redundancy_clean,
                                                      student_initialization)
from deepspeed_tpu_torch.compression.basic_layer import fake_quantize, head_prune_mask, row_prune_mask
from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler
