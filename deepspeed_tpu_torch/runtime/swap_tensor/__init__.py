"""NVMe swapping of the optimizer state (ZeRO-Infinity's disk tier)."""

from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper import (NvmeSwappedLeaf,
                                                                                   PartitionedOptimizerSwapper)

__all__ = ["NvmeSwappedLeaf", "PartitionedOptimizerSwapper"]
