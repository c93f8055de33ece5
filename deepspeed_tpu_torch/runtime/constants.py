"""Config key names and defaults that the port's config reads (from
deepspeed_tpu/runtime/constants.py)."""

# batch triangle
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# optimizer / scheduler
OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

# precision
FP16 = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"

# grads
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

# parallelism
ZERO_OPTIMIZATION = "zero_optimization"
PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
TENSOR_PARALLEL_SIZE = "tensor_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

# data types
DATA_TYPES = "data_types"
