from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (BigBirdSparsityConfig,
                                                                      BSLongformerSparsityConfig,
                                                                      DenseSparsityConfig,
                                                                      FixedSparsityConfig,
                                                                      LocalSlidingWindowSparsityConfig,
                                                                      SparsityConfig,
                                                                      VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (SparseSelfAttention,
                                                                            layout_to_dense_mask,
                                                                            sparse_self_attention)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig", "VariableSparsityConfig",
    "BigBirdSparsityConfig", "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
    "SparseSelfAttention", "sparse_self_attention", "layout_to_dense_mask",
]
