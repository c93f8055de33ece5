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

# logging and timers
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

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

# checkpoints and training fault tolerance
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
NEBULA = "nebula"
ANOMALY_SENTINEL = "anomaly_sentinel"

# the data-efficiency, compression, curvature and layer-drop blocks, and telemetry
TELEMETRY = "telemetry"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING = "curriculum_learning"
EIGENVALUE = "eigenvalue"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
