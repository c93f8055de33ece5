from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.random_ltd import (RandomLTDScheduler, gather_tokens,
                                                                         random_token_indices, scatter_tokens)

__all__ = ["RandomLTDScheduler", "random_token_indices", "gather_tokens", "scatter_tokens"]
