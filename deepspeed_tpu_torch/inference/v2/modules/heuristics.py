"""Module-implementation heuristics.

Port of ``deepspeed_tpu/inference/v2/modules/heuristics.py``: the choice
between the paged-attention kernel and the dense gather path, with the same
policy. Where the JAX package tests for a TPU backend, the port tests whether
the KV cache lies on a CUDA device; where it checks the kernel's VMEM
scratch, the port checks the CUDA kernel's shared memory.
"""

from deepspeed_tpu_torch.ops.paged_attention import SMEM_LIMIT, paged_attention_smem_bytes
from deepspeed_tpu_torch.utils.logging import warning_once


def attention_implementation(model, engine_config, bucket_tokens: int) -> str:
    """Pick the attention implementation for a (model, bucket) pair.

    Returns "paged_kernel" (``ops/paged_attention.py``) or "gather" (dense
    per-sequence gather in torch ops). Policy:

    - a sliding-window model always takes the gather path (the kernel has no
      window mask);
    - an explicit ``use_paged_kernel`` config wins otherwise;
    - automatically, the kernel needs a cache on a CUDA device, a
      decode-sized bucket (at most 32 tokens; longer prefills go through one
      dense gather), and a block size whose K/V tiles fit in shared memory.
    """
    flag = getattr(engine_config, "use_paged_kernel", None)
    if getattr(model, "attention_window", 0):
        if flag:
            warning_once("use_paged_kernel=True ignored: the paged kernel has no "
                         "sliding-window mask; using the gather path")
        return "gather"
    if flag is not None:
        return "paged_kernel" if flag else "gather"
    cache = model.state_manager.kv_cache.cache
    if cache.device.type != "cuda":
        return "gather"
    if bucket_tokens > 32:
        return "gather"  # prefill-heavy bucket
    bs = engine_config.kv_block_size
    smem = paged_attention_smem_bytes(bs, model.head_dim, model.num_heads // model.num_kv_heads,
                                      cache.element_size())
    if smem > SMEM_LIMIT:
        warning_once(f"paged kernel needs {smem} bytes of shared memory (kv_block_size={bs}); "
                     "using the gather path")
        return "gather"
    return "paged_kernel"
